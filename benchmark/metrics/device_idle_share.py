"""device_idle_share (layer device): the share of the traced part's
wall time in which no device operation ran, in %."""
from frozen import trace_math


def read(run):
    t = run.traced
    if t is None or not t["device"]:
        return None
    busy_s = trace_math.busy_us([(a, b) for _, a, b in t["device"]]) / 1e6
    return 100.0 * (1.0 - busy_s / t["wall_s"])
