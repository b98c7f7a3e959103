"""device_ops_per_frame (layer ops): device operations (kernels,
copies, sets) in the traced part, per frame."""


def read(run):
    t = run.traced
    if t is None or not t["device"]:
        return None
    return len(t["device"]) / t["frames"]
