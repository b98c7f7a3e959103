"""The least time the card could take for one P frame's kernel calls.

`main_path_calls` is a frozen copy of `main_path_calls` from
chip_smoke.py at commit daefa91 (one device, no serial pass): the
shapes of the window-gather and slab-search calls that one P frame
makes, derived from the configuration alone.  Each call here also says
how its windows lie, so that the bytes it must read can be counted
from the shapes and never from the launches a program makes: a later
program that fuses or replaces a kernel is held to the same work.

Counts, per call:

* every output element written once (int32);
* every index input read once (int32; a plane-stack gather also reads
  a plane index per window);
* the planes' bytes the windows cover when every block sits at zero
  motion on its grid, for the calls whose windows follow the block
  grid over the whole frame (ME, MC, merge, quadtree majority); the
  calls at content-chosen positions (intra fallback, 8x8 split) count
  no plane bytes, since which windows they read depends on the video;
* the slab search's sub, abs and add per candidate position and pixel.

Peaks, NVIDIA H100 SXM data sheet at 700 W: device memory 3.35 TB/s;
67 TFLOP/s float32 outside the tensor cores.  The slab search's 32-bit
integer operations are divided by that float32 rate: the data sheet
gives no int32 rate, and the card issues integer adds on at most as
many lanes as float32 ones, so the time stays a lower bound.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
ME_REF_PAD = 144          # the reference planes' padding for ME and MC


def main_path_calls(cfg: dict) -> dict:
    """name -> list of calls.  A gather call is (n, size, planes, grid):
    n windows of size x size from a stack of planes of shape planes,
    grid = (rows, cols, step, stack_planes_read) of the block grid the
    windows follow at zero motion, or None.  A slab search call is
    (h, w, bs, ry, rx).  `cfg` holds padded_height, padded_width,
    num_ref_frames, rd_mode ("RD_FAST", ...) and intra_in_p."""
    h, w = cfg["padded_height"], cfg["padded_width"]
    n = (h // 16) * (w // 16)
    pad = ME_REF_PAD
    half = (1, h // 2 + 2 * 78, w // 2 + 2 * 78)   # coarse refine pad 6+72
    full = (1, h + 2 * pad, w + 2 * pad)
    chroma = (h // 2 + pad, w // 2 + pad)
    r = cfg["num_ref_frames"]
    g16 = (h // 16, w // 16, 16, 1)
    mc_name, mc_full = (("gather_windows", full) if r == 1 else
                        ("gather_windows_ref", (2,) + full[1:]))
    mc_g16 = g16 if r == 1 else (h // 16, w // 16, 16, 2)
    calls = dict(
        gather_windows=[(n, 20, half, (h // 16, w // 16, 8, 1)),
                        (2 * n, 22, full, g16), (n, 25, full, g16)] * r,
        gather_windows_ref=[(2 * n, 11, (2 * r,) + chroma,
                             (h // 16, w // 16, 8, 2 * r))],
        slab_search=[(h // 8, w // 8, 2, 8, 16),
                     (h // 2, w // 2, 8, 3, 3)] * r)
    ultra = cfg["rd_mode"] == "RD_ULTRAFAST"
    rounds = 1 if ultra else 2
    calls[mc_name] += [(2 * n, 23, mc_full, mc_g16)] * rounds  # merge
    if not ultra:
        k = min(512, n)                         # fallback and split caps
        kf = min(512, (h // 16) * (w // 16))
        if cfg["intra_in_p"]:
            calls["gather_windows"] += (
                [(kf, 33, (1, 1 + h + 16, 1 + w + 16), None)] * 2
                + [(kf, 17, (1, 1 + h // 2 + 8, 1 + w // 2 + 8), None)] * 4)
        calls[mc_name] += [
            (4 * k, 14, mc_full, None), (4 * k, 15, mc_full, None),
            ((h // 32) * (w // 32), 39, mc_full,
             (h // 32, w // 32, 32, mc_g16[3])),
            ((h // 64) * (w // 64), 71, mc_full,
             (h // 64, w // 64, 64, mc_g16[3]))]
        calls["gather_windows_ref"].append((8 * k, 7, (2 * r,) + chroma,
                                            None))
    return calls


def gather_bytes(name: str, call) -> int:
    n, size, planes, grid = call
    out = 4 * n * size * size
    index = 4 * n * (3 if name == "gather_windows_ref" else 2)
    read = 0
    if grid is not None:
        rows, cols, step, stack = grid
        ph, pw = planes[-2:]
        read = 4 * stack * min(ph, (rows - 1) * step + size) \
            * min(pw, (cols - 1) * step + size)
    return out + index + read


def slab_bytes_ops(call) -> tuple:
    h, w, bs, ry, rx = call
    nbytes = 4 * (h * w + (h + 2 * ry) * (w + 2 * rx) + (h // bs) * (w // bs))
    ops = 3.0 * (2 * ry + 1) * (2 * rx + 1) * h * w
    return nbytes, ops


def least_ms(cfg: dict) -> dict:
    """Per kernel name, the least milliseconds one P frame's calls take:
    the sum over its calls of max(bytes / HBM rate, ops / OPS rate)."""
    out = {}
    for name, calls in main_path_calls(cfg).items():
        ms = 0.0
        for call in calls:
            if name == "slab_search":
                nbytes, ops = slab_bytes_ops(call)
            else:
                nbytes, ops = gather_bytes(name, call), 0.0
            ms += max(nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S) * 1e3
        out[name] = ms
    return out
