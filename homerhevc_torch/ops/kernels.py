"""Hand-written CUDA kernels of the encoder, their wrappers and plain
PyTorch versions.

Two kernels in `homerhevc_torch/csrc/` take the place of the three
Pallas TPU kernels of `homerhevc_tpu/ops/pallas_kernels.py`:

* `gather_windows.cu` serves `gather_windows` (one plane, the R = 1
  case) and `gather_windows_ref` (a stack of R planes);
* `slab_search.cu` serves `slab_search`.

Each source is compiled with nvcc for sm_90a into its own shared library
with a plain C interface, on first use, into the package's build
directory (`homerhevc_torch/_build/`, git-ignored), and loaded with
ctypes.  A wrapper takes the plain version for a tensor on the CPU; for a
CUDA tensor it launches its kernel on the current stream or raises.  Each
launch adds one to the wrapper's count (`launch_counts`).
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_SOURCES = {"gather_windows": "gather_windows.cu",
            "slab_search": "slab_search.cu"}
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
               "-std=c++17", "-shared", "-Xcompiler", "-fPIC"]

_libs: dict = {}
_lock = threading.Lock()
_counts = {"gather_windows": 0, "gather_windows_ref": 0,
           "slab_search": 0}


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return dict(_counts)


def reset_launch_counts():
    for k in _counts:
        _counts[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME, "
                           "/usr/local/cuda/bin)")
    return path


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def build(verbose: bool = False) -> dict:
    """Compile every kernel source that has no up-to-date library, one
    nvcc process per source, all started together; then load them.
    Returns {name: seconds spent compiling it} (0.0 when cached)."""
    with _lock:
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = {}
        for name, src in _SOURCES.items():
            out = _lib_path(name)
            srcp = os.path.join(_CSRC, src)
            if os.path.exists(out) and \
                    os.path.getmtime(out) >= os.path.getmtime(srcp):
                continue
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *_NVCC_FLAGS,
                   *(["-Xptxas", "-v"] if verbose else []),
                   "-o", tmp, srcp]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out, time.perf_counter())
        secs = {name: 0.0 for name in _SOURCES}
        for name, (p, tmp, out, t0) in procs.items():
            log, _ = p.communicate()
            secs[name] = time.perf_counter() - t0
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{log}")
            if verbose and log:
                print(log, end="")
            os.replace(tmp, out)
        for name in _SOURCES:
            if name not in _libs:
                _libs[name] = _load(name)
        return secs


def _load(name: str):
    lib = ctypes.CDLL(_lib_path(name))
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == "gather_windows":
        fn = lib.gather_windows_launch
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    else:
        fn = lib.slab_search_launch
        fn.argtypes = [p, p, p, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return lib


def _lib(name: str):
    if name not in _libs:
        build()
    return _libs[name]


def _check(t: torch.Tensor, what: str, ndim: int):
    if t.dtype != torch.int32:
        raise TypeError(f"{what}: expected int32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what}: expected {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def _on_cuda(*ts) -> bool:
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {devs}")
    dev = devs.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"unsupported device {dev}")


def _raise_on(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


# ---------------------------------------------------------------------------
# gather_windows / gather_windows_ref
# ---------------------------------------------------------------------------

def gather_windows_plain(planes: torch.Tensor, ri, by: torch.Tensor,
                         bx: torch.Tensor, size: int) -> torch.Tensor:
    """Plain version of both gathers: planes [R, Hp, Wp]; ri [n] or None
    (plane 0); origins clamped into the planes as the kernel does."""
    r, hp, wp = planes.shape
    byc = by.clamp(0, hp - size)
    bxc = bx.clamp(0, wp - size)
    ar = torch.arange(size, device=planes.device)
    rows = byc[:, None, None] + ar[None, :, None]
    cols = bxc[:, None, None] + ar[None, None, :]
    if ri is None:
        return planes[0][rows, cols]
    ric = ri.clamp(0, r - 1)[:, None, None]
    return planes[ric, rows, cols]


def _gather_launch(planes, ri, by, bx, size, key):
    r, hp, wp = planes.shape
    n = by.shape[0]
    if not 0 < size <= min(hp, wp):
        raise ValueError(f"window size {size} vs plane {hp}x{wp}")
    out = torch.empty((n, size, size), dtype=torch.int32,
                      device=planes.device)
    if n == 0:
        return out
    lib = _lib("gather_windows")
    # the launch goes to the tensors' device, whichever is current
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        rc = lib.gather_windows_launch(
            planes.data_ptr(), ri.data_ptr() if ri is not None else None,
            by.data_ptr(), bx.data_ptr(), out.data_ptr(), n, r, hp, wp,
            size, stream)
    _raise_on(rc, key)
    _counts[key] += 1
    return out


def gather_windows(plane: torch.Tensor, by: torch.Tensor,
                   bx: torch.Tensor, size: int) -> torch.Tensor:
    """[n, size, size] windows of an int32 plane [Hp, Wp] at per-window
    origins (by, bx) [n], clamped to the plane.

    Replaces gather_windows_pallas (homerhevc_tpu/ops/pallas_kernels.py).
    Bound by device memory (one read and one write per element), but at
    the encoder's shapes a call moves only a few MB, so scheduling and
    index arithmetic weigh as much as the bytes.  The kernel treats the
    output as one flat stream: each thread writes 4 consecutive words
    with one 16-byte store, finds window, row and column by division by
    compile-time constants (window sizes 11, 20, 22, 23, 25; any other
    size through a run-time-size instantiation of the same kernel), and
    a few CTAs per SM stride over the stream."""
    _check(plane, "plane", 2)
    _check(by, "by", 1)
    _check(bx, "bx", 1)
    if by.shape != bx.shape:
        raise ValueError("by/bx shapes differ")
    if not _on_cuda(plane, by, bx):
        return gather_windows_plain(plane[None], None, by, bx, size)
    return _gather_launch(plane[None], None, by, bx, size,
                          "gather_windows")


def gather_windows_ref(planes: torch.Tensor, ri: torch.Tensor,
                       by: torch.Tensor, bx: torch.Tensor,
                       size: int) -> torch.Tensor:
    """The same gather with a per-window plane index ri [n] into
    planes [R, Hp, Wp] (clamped to [0, R-1]).

    Replaces gather_windows_ref_pallas with the same CUDA kernel as
    gather_windows (flat output stream, 16-byte stores, the plane index
    read beside the origins), and the same memory bound."""
    _check(planes, "planes", 3)
    for t, w in ((ri, "ri"), (by, "by"), (bx, "bx")):
        _check(t, w, 1)
    if not (ri.shape == by.shape == bx.shape):
        raise ValueError("ri/by/bx shapes differ")
    if not _on_cuda(planes, ri, by, bx):
        return gather_windows_plain(planes, ri, by, bx, size)
    return _gather_launch(planes, ri, by, bx, size, "gather_windows_ref")


# ---------------------------------------------------------------------------
# slab_search
# ---------------------------------------------------------------------------

def slab_search_plain(cur: torch.Tensor, slab: torch.Tensor, bs: int,
                      ry: int, rx: int) -> torch.Tensor:
    """Plain version: per-offset block SADs + |dy-ry|+|dx-rx|, argmin
    (first minimum) over offsets in flat order dy*(2rx+1)+dx."""
    h, w = cur.shape
    ny, nx = 2 * ry + 1, 2 * rx + 1
    bh, bw = h // bs, w // bs
    dev = cur.device
    pen_x = (torch.arange(nx, device=dev) - rx).abs().to(torch.int32)
    costs = []
    for dy in range(ny):
        rows = slab[dy:dy + h]                          # [h, w + 2rx]
        wins = rows.unfold(1, w, 1).permute(1, 0, 2)    # [nx, h, w]
        d = (wins - cur[None]).abs()
        sad = d.reshape(nx, bh, bs, bw, bs).sum((2, 4), dtype=torch.int32)
        costs.append(sad + (pen_x + abs(dy - ry))[:, None, None])
    cost = torch.cat(costs, 0)                          # [ny*nx, bh, bw]
    return torch.argmin(cost, 0).to(torch.int32)


def slab_search(cur: torch.Tensor, slab: torch.Tensor, bs: int, ry: int,
                rx: int) -> torch.Tensor:
    """Full-search best-offset indices [h/bs, w/bs] int32 of cur
    (int32 [h, w]) against slab (int32 [h+2ry, w+2rx]).

    Replaces slab_search_pallas, whose work the reference runs as
    me.slab_search_jnp.  At the encoder's shapes a call is a few million
    absolute differences, about a microsecond of the card's integer
    rate, so what bounds it is how many differences run side by side and
    the fixed cost of a launch.  The kernel spreads (output block,
    offset) pairs over the card: a CTA stages a tile of 2 x 4 output
    blocks with its slab halo in shared memory once, one warp per block,
    and the warp's lanes split the block's offsets, reading
    conflict-free (the slab tile's row pitch is padded to 2rx+1 mod 32)
    against the block's pixels held in registers (block sizes 2, 4 and
    8; any other size reads them from shared memory).  The warp reduces
    the 64-bit keys (cost << 32) | flat index with min, so equal costs
    resolve to the lower flat index, as argmin's first-minimum rule
    does."""
    _check(cur, "cur", 2)
    _check(slab, "slab", 2)
    h, w = cur.shape
    if h % bs or w % bs:
        raise ValueError(f"cur {h}x{w} is not a multiple of bs={bs}")
    if tuple(slab.shape) != (h + 2 * ry, w + 2 * rx):
        raise ValueError(f"slab {tuple(slab.shape)} != "
                         f"{(h + 2 * ry, w + 2 * rx)}")
    if not _on_cuda(cur, slab):
        return slab_search_plain(cur, slab, bs, ry, rx)
    out = torch.empty((h // bs, w // bs), dtype=torch.int32,
                      device=cur.device)
    lib = _lib("slab_search")
    with torch.cuda.device(cur.device):
        stream = torch.cuda.current_stream(cur.device).cuda_stream
        rc = lib.slab_search_launch(cur.data_ptr(), slab.data_ptr(),
                                    out.data_ptr(), h, w, bs, ry, rx, stream)
    _raise_on(rc, "slab_search")
    _counts["slab_search"] += 1
    return out
