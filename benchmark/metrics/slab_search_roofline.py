"""slab_search_roofline (layer ops.kernels): the least time of one P
frame's slab searches, counted from the cell's shapes
(frozen.kernel_work), over the device time the slab-search kernel took
per frame in the traced part, in %.  Nothing to read where the traced
part ran none of it."""
import harness


def read(run):
    return harness.kernel_share(run, "slab_search", ("slab_search",))
