"""gather_windows_roofline (layer ops.kernels): the least time of one P
frame's window gathers (gather_windows and gather_windows_ref, one CUDA
kernel), counted from the cell's shapes (frozen.kernel_work), over the
device time that kernel took per frame in the traced part, in %.
Nothing to read where the traced part ran none of it."""
import harness


def read(run):
    return harness.kernel_share(run, "gather_windows",
                                ("gather_windows", "gather_windows_ref"))
