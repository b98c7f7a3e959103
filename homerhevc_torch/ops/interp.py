"""HEVC fractional-sample interpolation (spec 8.5.4.2.2), batched.

Port of homerhevc_tpu/ops/interp.py.  The reference evaluates each
separable stage as a matmul against a band matrix; here each stage is the
same sum of taps written out in int32 (every intermediate of the 8-bit
filters is far inside int32), so the result is exact on every device.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

LUMA_FILTERS = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1],
], dtype=np.int32)
CHROMA_FILTERS = np.array([
    [0, 64, 0, 0],
    [-2, 58, 10, -2],
    [-4, 54, 16, -2],
    [-6, 46, 28, -4],
    [-4, 36, 36, -4],
    [-4, 28, 46, -6],
    [-2, 16, 54, -4],
    [-2, 10, 58, -2],
], dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _filters(luma: bool, device) -> torch.Tensor:
    return torch.as_tensor(LUMA_FILTERS if luma else CHROMA_FILTERS,
                           dtype=torch.int32, device=device)


def _band_np(phase: int, luma: bool, size: int, rows: int, off: int):
    """[rows, size] band matrix of the reference (column o carries the
    phase's taps at rows off+o ..); kept for the tests' cross-checks."""
    coefs = LUMA_FILTERS[phase] if luma else CHROMA_FILTERS[phase]
    taps = len(coefs)
    assert off + size - 1 + taps <= rows, (off, size, taps, rows)
    m = np.zeros((rows, size), np.float32)
    for o in range(size):
        m[off + o:off + o + taps, o] = coefs
    return m


def fir_h(win: torch.Tensor, coef: torch.Tensor, size: int,
          ox: int = 0) -> torch.Tensor:
    """Horizontal stage: out[..., y, o] = sum_j coef[..., j] *
    win[..., y, ox + o + j]; coef [..., taps] broadcasts over (y, o)."""
    taps = coef.shape[-1]
    acc = None
    for j in range(taps):
        term = coef[..., j, None, None] * win[..., :, ox + j:ox + j + size]
        acc = term if acc is None else acc + term
    return acc


def fir_v(t: torch.Tensor, coef: torch.Tensor, size: int,
          oy: int = 0) -> torch.Tensor:
    """Vertical stage on the horizontal output."""
    taps = coef.shape[-1]
    acc = None
    for j in range(taps):
        term = coef[..., j, None, None] * t[..., oy + j:oy + j + size, :]
        acc = term if acc is None else acc + term
    return acc


def finish_uni(pred64: torch.Tensor) -> torch.Tensor:
    """(>>6) then spec 8.5.4.2.3 uni-prediction rounding."""
    p = pred64.to(torch.int32) >> 6
    return ((p + 32) >> 6).clamp(0, 255)


def mc_separable_phases(win: torch.Tensor, fy_idx: torch.Tensor,
                        fx_idx: torch.Tensor, size: int,
                        luma: bool) -> torch.Tensor:
    """MC with per-block dynamic phases.  win: [n, size+taps-1,
    size+taps-1] int32 with the phase-0 support at (0, 0); fy/fx [n]."""
    f = _filters(luma, win.device)
    ch = f[fx_idx.long()]                              # [n, taps]
    cv = f[fy_idx.long()]
    t = fir_h(win.to(torch.int32), ch, size)
    return finish_uni(fir_v(t, cv, size))


def mc_chroma_phases(win3: torch.Tensor, fy8: torch.Tensor,
                     fx8: torch.Tensor, size: int) -> torch.Tensor:
    """Chroma MC, eighth-pel phases; win3 [n, size+3, size+3] whose
    (1, 1) sample is the integer position."""
    return mc_separable_phases(win3, fy8, fx8, size, False)


def mc_plane_luma(win: torch.Tensor, fy, fx, out_h: int,
                  out_w: int) -> torch.Tensor:
    """Whole-plane luma MC at one phase pair (ints or 0-d tensors); win
    [out_h+7, out_w+7]."""
    f = _filters(True, win.device)
    t = fir_h(win, f[fx], out_w)
    return finish_uni(fir_v(t, f[fy], out_h))
