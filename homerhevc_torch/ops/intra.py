"""HEVC intra prediction: reference substitution, smoothing, 35 modes.

Port of homerhevc_tpu/ops/intra.py.  Reference sample ("adi") layout,
[4S+1] per block:
    adi[0 .. 2S-1]  = left column bottom -> top   (adi[k] = p(2S-1-k, -1))
    adi[2S]         = corner p(-1, -1)
    adi[2S+1+j]     = top row left -> right        (p(-1, j))
The angular tap selection is a static index gather (the reference's 0/1
selection matmul picks the same samples).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from homerhevc_torch import tables

PLANAR, DC = 0, 1


def substitute_refs(adi: torch.Tensor, avail: torch.Tensor,
                    bit_depth: int = 8) -> torch.Tensor:
    """Reference sample substitution (spec 8.4.4.2.2).  adi int32
    [..., 4S+1]; avail bool of the same shape."""
    n = adi.shape[-1]
    avail = avail.expand(adi.shape)
    pos = torch.arange(n, dtype=torch.int64, device=adi.device)
    ff = torch.cummax(torch.where(avail, pos, -1), -1).values
    first_avail = torch.argmax(avail.to(torch.int32), -1)
    any_avail = avail.any(-1)
    idx = torch.where(ff >= 0, ff, first_avail[..., None])
    filled = torch.gather(adi, -1, idx)
    return torch.where(any_avail[..., None], filled,
                       torch.full_like(filled, 1 << (bit_depth - 1)))


def filter_refs(adi: torch.Tensor, size: int,
                strong: bool = False) -> torch.Tensor:
    """[1,2,1] reference smoothing (spec 8.4.4.2.3), with the strong
    bilinear filter for 32x32 luma when `strong` and the edges are
    near-linear; the end samples are kept."""
    left = torch.cat([adi[..., :1], adi[..., :-1]], -1)
    right = torch.cat([adi[..., 1:], adi[..., -1:]], -1)
    f = (left + 2 * adi + right + 2) >> 2
    n = adi.shape[-1]
    f = torch.cat([adi[..., :1], f[..., 1:n - 1], adi[..., n - 1:]], -1)
    if not strong or size != 32:
        return f
    s = size
    corner = adi[..., 2 * s]
    top_end = adi[..., 4 * s]
    bl_end = adi[..., 0]
    thr = 1 << (8 - 5)
    bi = (((corner + top_end - 2 * adi[..., 3 * s]).abs() < thr)
          & ((corner + bl_end - 2 * adi[..., s]).abs() < thr))
    k = torch.arange(n, device=adi.device)
    x = k - (2 * s + 1)
    top_lin = ((2 * s - 1 - x) * corner[..., None]
               + (x + 1) * top_end[..., None] + s) >> 6
    y = 2 * s - 1 - k
    left_lin = ((2 * s - 1 - y) * corner[..., None]
                + (y + 1) * bl_end[..., None] + s) >> 6
    lin = torch.where(k > 2 * s, top_lin,
                      torch.where(k < 2 * s, left_lin, adi))
    lin = torch.cat([adi[..., :1], lin[..., 1:n - 1], adi[..., n - 1:]], -1)
    return torch.where(bi[..., None], lin, f).to(adi.dtype)


@functools.lru_cache(maxsize=None)
def _angular_tables(size: int):
    """(src_idx [33, S, S, 2] adi indices of the two blended taps,
    fact [33, S]); horizontal modes generated transposed."""
    s = size
    corner = 2 * s

    def main_adi_index(k: int, is_ver: bool) -> int:
        if k == 0:
            return corner
        return corner + k if is_ver else corner - k

    def side_adi_index(i: int, is_ver: bool) -> int:
        if i == 0:
            return corner
        return corner - i if is_ver else corner + i

    src = np.zeros((33, s, s, 2), dtype=np.int64)
    fact = np.zeros((33, s), dtype=np.int32)
    for mode in range(2, 35):
        m = mode - 2
        is_ver = mode >= 18
        ang = tables.intra_pred_angle(mode)
        inv_ang = tables.intra_inv_angle(mode)
        ref_main = np.zeros(3 * s + 1, dtype=np.int64)
        for k in range(0, 2 * s + 1):
            ref_main[s + k] = main_adi_index(k, is_ver)
        if ang < 0:
            inv_sum = 128
            for j in range(1, -((s * ang) >> 5)):
                inv_sum += inv_ang
                ref_main[s - j] = side_adi_index(inv_sum >> 8, is_ver)
        for r in range(s):
            pos = (r + 1) * ang
            i_idx = pos >> 5
            fact[m, r] = pos & 31
            for c in range(s):
                src[m, r, c, 0] = ref_main[s + c + i_idx + 1]
                src[m, r, c, 1] = ref_main[min(s + c + i_idx + 2, 3 * s)]
    return src, fact


@functools.lru_cache(maxsize=None)
def _filter_flags(size: int, is_luma: bool) -> np.ndarray:
    """Per-mode reference smoothing selection (spec 8.4.4.2.3)."""
    flags = np.zeros(35, dtype=bool)
    if not is_luma or size == 4:
        return flags
    log2 = int(np.log2(size))
    thresh = int(tables.INTRA_FILTER_THRESH[log2 - 2])
    for mode in range(35):
        if mode == DC:
            continue
        min_dist = 10 if mode == PLANAR else \
            min(abs(mode - 26), abs(mode - 10))
        flags[mode] = min_dist > thresh
    return flags


@functools.lru_cache(maxsize=None)
def _tables_dev(size: int, is_luma: bool, device):
    src, fact = _angular_tables(size)
    flags = _filter_flags(size, is_luma)
    return (torch.as_tensor(src, device=device),
            torch.as_tensor(fact, device=device),
            torch.as_tensor(flags[2:].astype(np.int64), device=device))


def _planar_dc(adi, adi_f, s: int, is_luma: bool):
    log2 = s.bit_length() - 1
    corner = 2 * s
    top = adi[..., corner + 1:corner + 1 + s]
    left = torch.flip(adi[..., s:2 * s], (-1,))
    use_f = bool(_filter_flags(s, is_luma)[PLANAR])
    src = adi_f if use_f else adi
    t = src[..., corner + 1:corner + 1 + s]
    l = torch.flip(src[..., s:2 * s], (-1,))
    tr = src[..., corner + 1 + s]
    bl = src[..., s - 1]
    col = torch.arange(s, dtype=torch.int32, device=adi.device)
    row = col[:, None]
    planar = ((s - 1 - col)[None, :] * l[..., :, None]
              + (col + 1)[None, :] * tr[..., None, None]
              + (s - 1 - col)[:, None] * t[..., None, :]
              + (row + 1) * bl[..., None, None]
              + s) >> (log2 + 1)
    dc_val = (top.sum(-1) + left.sum(-1) + s) >> (log2 + 1)
    dc = dc_val[..., None, None].expand(*dc_val.shape, s, s).clone()
    if is_luma and s < 32:
        dc[..., 0, :] = (top + 3 * dc_val[..., None] + 2) >> 2
        dc[..., :, 0] = (left + 3 * dc_val[..., None] + 2) >> 2
        dc[..., 0, 0] = (left[..., 0] + 2 * dc_val + top[..., 0] + 2) >> 2
    return planar.to(torch.int32), dc.to(torch.int32), top, left


def predict_single_mode(adi: torch.Tensor, mode: torch.Tensor, size: int,
                        is_luma: bool, bit_depth: int = 8,
                        strong: bool = False) -> torch.Tensor:
    """Prediction for one mode per block.  adi int32 [n, 4S+1]; mode
    [n].  Returns int32 [n, S, S]."""
    s = size
    corner = 2 * s
    n = adi.shape[0]
    adi_f = filter_refs(adi, s, strong and is_luma)
    planar, dc, top, left = _planar_dc(adi, adi_f, s, is_luma)
    src_idx, fact_t, flags = _tables_dev(s, is_luma, adi.device)
    m = (mode.long() - 2).clamp(0, 32)
    fact = fact_t[m][:, :, None]                         # [n, S, 1]
    adi_m = torch.where(flags[m][:, None] > 0, adi_f, adi)
    taps = torch.gather(adi_m, -1, src_idx[m].reshape(n, -1)) \
        .reshape(n, s, s, 2)
    ang = ((32 - fact) * taps[..., 0] + fact * taps[..., 1] + 16) >> 5
    if is_luma and s < 32:
        maxv = (1 << bit_depth) - 1
        cor = adi[..., corner]
        v26 = (top[..., 0][..., None]
               + ((left - cor[..., None]) >> 1)).clamp(0, maxv)
        v10 = (left[..., 0][..., None]
               + ((top - cor[..., None]) >> 1)).clamp(0, maxv)
        edge = torch.where((mode == 26)[:, None], v26,
                           torch.where((mode == 10)[:, None], v10,
                                       ang[..., :, 0]))
        ang = torch.cat([edge[..., None], ang[..., 1:]], -1)
    ang = torch.where((mode < 18)[:, None, None], ang.transpose(-1, -2), ang)
    return torch.where((mode == PLANAR)[:, None, None], planar,
                       torch.where((mode == DC)[:, None, None], dc,
                                   ang)).to(torch.int32)


def predict_all_modes(adi: torch.Tensor, size: int, is_luma: bool,
                      bit_depth: int = 8,
                      strong: bool = False) -> torch.Tensor:
    """All 35 intra predictions: adi int32 [..., 4S+1] -> int32
    [..., 35, S, S]."""
    s = size
    corner = 2 * s
    adi_f = filter_refs(adi, s, strong and is_luma)
    planar, dc, top, left = _planar_dc(adi, adi_f, s, is_luma)
    batch = adi.shape[:-1]
    src_idx, fact_t, flags = _tables_dev(s, is_luma, adi.device)
    stack = torch.stack([adi, adi_f], -2)                # [..., 2, 4S+1]
    per_mode = stack[..., flags, :]                      # [..., 33, 4S+1]
    taps = torch.gather(per_mode, -1,
                        src_idx.reshape(33, -1).expand(
                            *batch, 33, s * s * 2)) \
        .reshape(*batch, 33, s, s, 2)
    fact = fact_t[:, :, None]
    ang = ((32 - fact) * taps[..., 0] + fact * taps[..., 1] + 16) >> 5
    if is_luma and s < 32:
        maxv = (1 << bit_depth) - 1
        cor = adi[..., corner]
        v26 = (top[..., 0][..., None]
               + ((left - cor[..., None]) >> 1)).clamp(0, maxv)
        v10 = (left[..., 0][..., None]
               + ((top - cor[..., None]) >> 1)).clamp(0, maxv)
        ang = ang.clone()
        ang[..., 26 - 2, :, 0] = v26
        ang[..., 10 - 2, :, 0] = v10
    hor = ang[..., :16, :, :].transpose(-1, -2)
    ver = ang[..., 16:, :, :]
    return torch.cat([planar[..., None, :, :], dc[..., None, :, :], hor,
                      ver], -3).to(torch.int32)
