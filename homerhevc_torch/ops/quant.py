"""Bit-exact HEVC quantization / dequantization and sign-bit hiding.

Port of homerhevc_tpu/ops/quant.py: flat quantization, or the default
scaling lists (spec 7.4.5, `scaling=True`; the SPS signals them).
qp may be a Python int, a 0-d tensor or a per-block tensor [...] that
broadcasts against [..., N, N] blocks.  Scan reorders are index gathers
(the reference's permutation matmuls compute the same permutation).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from homerhevc_torch import tables

_CLIP_MIN = -32768
_CLIP_MAX = 32767


def _qp_tensor(qp, device) -> torch.Tensor:
    if not isinstance(qp, torch.Tensor) and np.ndim(qp) == 0:
        return _qp_const(int(qp), device)
    qp = torch.as_tensor(qp, dtype=torch.int32, device=device)
    if qp.dim() > 0:
        qp = qp.reshape(qp.shape + (1, 1))
    return qp


@functools.lru_cache(maxsize=None)
def _qp_const(qp: int, device) -> torch.Tensor:
    """A Python-int QP as a 0-d tensor on `device`, uploaded once (an
    upload from host memory waits for the device's queue to drain)."""
    return torch.tensor(qp, dtype=torch.int32, device=device)


def quant_params(qp, size: int, device, bit_depth: int = 8):
    """(per, rem, qbits, transform_shift) for a size x size TB."""
    log2 = size.bit_length() - 1
    qp = _qp_tensor(qp, device)
    per, rem = qp // 6, qp % 6
    transform_shift = tables.MAX_TR_DYNAMIC_RANGE - bit_depth - log2
    qbits = tables.QUANT_SHIFT + per + transform_shift
    return per, rem, qbits, transform_shift


@functools.lru_cache(maxsize=None)
def _table(name: str, device) -> torch.Tensor:
    """tables.<name> as an int32 tensor on `device`, uploaded once."""
    return torch.as_tensor(np.asarray(getattr(tables, name)),
                           dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=None)
def _q_matrices(size: int, is_intra: bool, device):
    """Per-rem factor stacks [6, N, N] of the default scaling lists,
    uploaded once per device: Q = (quant_scale[rem] << 4) // m and
    DQ = inv_quant_scale[rem] * m (flat m = 16 gives the flat factors)."""
    m = tables.scaling_matrix(size, is_intra)
    q = (np.asarray(tables.QUANT_SCALES)[:, None, None] << 4) // m[None]
    dq = np.asarray(tables.INV_QUANT_SCALES)[:, None, None] * m[None]
    return (torch.as_tensor(q.astype(np.int32), device=device),
            torch.as_tensor(dq.astype(np.int32), device=device))


def _scaled(qmat: torch.Tensor, rem: torch.Tensor) -> torch.Tensor:
    """The [N, N] factors of each block's rem: [..., N, N] for a
    per-block QP (rem [..., 1, 1]), [N, N] for one QP."""
    return qmat[rem[..., 0, 0].long()] if rem.dim() > 0 \
        else qmat[rem.long()]


def quantize(coeff: torch.Tensor, qp, size: int, is_intra: bool = True,
             bit_depth: int = 8, scaling: bool = False):
    """Returns (levels int32 [..., N, N], delta_u) — rounding offset
    171/512 intra, 85/512 inter; scaling: the default scaling lists."""
    dev = coeff.device
    per, rem, qbits, _ = quant_params(qp, size, dev, bit_depth)
    if scaling:
        q = _scaled(_q_matrices(size, is_intra, dev)[0], rem)
    else:
        q = _table("QUANT_SCALES", dev)[rem.long()]
    add = torch.full_like(qbits, 171 if is_intra else 85) << (qbits - 9)
    c = coeff.to(torch.int32)
    absc = c.abs()
    scaled = absc * q
    level = (scaled + add) >> qbits
    delta_u = (scaled - (level << qbits)) >> (qbits - 8)
    level = (torch.sign(c) * level).clamp(_CLIP_MIN, _CLIP_MAX)
    return level, delta_u


def dequantize(level: torch.Tensor, qp, size: int, bit_depth: int = 8,
               is_intra: bool = True, scaling: bool = False):
    """Inverse quantization (spec 8.6.3), flat or default-list scaled."""
    dev = level.device
    per, rem, _, transform_shift = quant_params(qp, size, dev, bit_depth)
    iq_shift = (tables.QUANT_IQUANT_SHIFT - tables.QUANT_SHIFT
                - transform_shift + 4)
    if scaling:
        dq = _scaled(_q_matrices(size, is_intra, dev)[1], rem)
    else:
        dq = _table("INV_QUANT_SCALES", dev)[rem.long()] * 16
    lv = level.to(torch.int32)
    sh = torch.clamp(iq_shift - per, min=1)
    down = (lv * dq + (torch.ones_like(sh) << (sh - 1))) >> sh
    up = (lv * dq) << torch.clamp(per - iq_shift, min=0)
    out = torch.where(per < iq_shift, down, up)
    return out.clamp(_CLIP_MIN, _CLIP_MAX)


@functools.lru_cache(maxsize=None)
def _scan_index(scan: tuple, device) -> torch.Tensor:
    return torch.as_tensor(scan, dtype=torch.long, device=device)


@functools.lru_cache(maxsize=None)
def _inverse_index(scan: tuple, device) -> torch.Tensor:
    return torch.as_tensor(np.argsort(np.asarray(scan)), dtype=torch.long,
                           device=device)


def sign_bit_hide(level: torch.Tensor, delta_u: torch.Tensor, scan,
                  size: int) -> torch.Tensor:
    """Sign-bit hiding over 4x4 coefficient groups in scan order (spec
    8.6.3 encoder side).  scan: raster index per scan position; the
    identity means the caller pre-permuted."""
    n = size * size
    flat = level.reshape(level.shape[:-2] + (n,))
    du = delta_u.reshape(flat.shape)
    scan = tuple(int(s) for s in scan)
    identity = scan == tuple(range(n))
    if identity:
        sl, sdu = flat, du
    else:
        idx = _scan_index(scan, level.device)
        sl, sdu = flat[..., idx], du[..., idx]
    ncg = n // 16
    slg = sl.reshape(sl.shape[:-1] + (ncg, 16))
    sdug = sdu.reshape(slg.shape)

    nz = slg != 0
    pos = torch.arange(16, dtype=torch.int32, device=level.device)
    big = 100
    first = torch.where(nz, pos, big).amin(-1)
    last = torch.where(nz, pos, -1).amax(-1)
    any_nz = last >= 0
    hide_ok = any_nz & ((last - first) >= 4)

    abs_sum = slg.abs().sum(-1, dtype=torch.int32)
    at_first = pos == torch.clamp(first, max=15)[..., None]
    first_level = (slg * at_first).sum(-1, dtype=torch.int32)
    sign_first = (first_level < 0).to(torch.int32)
    parity = abs_sum & 1
    need_fix = hide_ok & (parity != sign_first)

    in_range = (pos >= first[..., None]) & (pos <= last[..., None])
    is_edge = (pos == first[..., None]) | (pos == last[..., None])
    abs_lv = slg.abs()
    would_decrement = sdug <= 0
    illegal = is_edge & (abs_lv == 1) & would_decrement
    cost = torch.where(in_range & ~illegal, sdug.abs(),
                       torch.full_like(sdug, -big * 1000))
    best_pos = torch.argmax(cost, -1)

    at_best = pos == best_pos[..., None]
    best_du = (sdug * at_best).sum(-1, dtype=torch.int32)
    best_lv = (slg * at_best).sum(-1, dtype=torch.int32)
    mag_change = torch.where(best_du > 0, 1, -1)
    signed_dir = torch.where(best_lv >= 0, mag_change, -mag_change)
    delta = torch.where(need_fix, signed_dir, 0)
    slg = slg + torch.where(at_best, delta[..., None], 0)

    out_scan = slg.reshape(sl.shape).to(torch.int32)
    if identity:
        return out_scan.reshape(level.shape)
    inv = _inverse_index(scan, level.device)
    return out_scan[..., inv].reshape(level.shape)

