"""Device-side RD bit estimation (static-probability CABAC bin costs).

Port of homerhevc_tpu/ops/rdbits.py.  Costs are float32 bits and feed
argmins, so they are evaluated in the reference's float32 order
(ops/f32.py): row sums in XLA-CPU chunk order, the qp correction as the
reference's interpolation with its fused multiply-add, and floor(log2)
on integer-valued inputs as XLA-CPU's log2 rounds it.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from homerhevc_torch import tables
from homerhevc_torch.ops import f32

SIG_BITS = (0.80, 1.25)
CG_BITS = (1.60, 0.55)
GT1_BITS = (0.70, 1.55)
GT2_BITS = (0.80, 1.30)
LAST_CTX_BIT = 0.90


@functools.lru_cache(maxsize=None)
def _last_bits_lut(size: int) -> np.ndarray:
    """bits of last_sig_coeff_{x,y}_prefix+suffix per coordinate value
    (spec 9.3.3.2 Table 9-41)."""
    def group_idx(c):
        if c < 4:
            return c
        lg = int(np.floor(np.log2(c)))
        return 2 * lg + ((c >> (lg - 1)) & 1)

    lut = np.zeros(size, np.float32)
    max_g = group_idx(size - 1)
    for c in range(size):
        gi = group_idx(c)
        prefix = gi + (1 if gi < max_g else 0)
        suffix = (gi >> 1) - 1 if gi > 3 else 0
        lut[c] = prefix * LAST_CTX_BIT + max(suffix, 0) * 1.0
    return lut


@functools.lru_cache(maxsize=None)
def _scan_perm(size: int) -> np.ndarray:
    return np.asarray(tables.scan_order(size, tables.SCAN_DIAG), np.int64)


@functools.lru_cache(maxsize=None)
def _dev(name: str, size: int, device) -> torch.Tensor:
    if name == "perm":
        return torch.as_tensor(_scan_perm(size), device=device)
    return torch.as_tensor(_last_bits_lut(size), device=device)


def floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) of an integer-valued float32 tensor x >= 1, as the
    reference computes it: exact, except that XLA-CPU's float32 log2
    lands just below 13 and 15 at 2^13 and 2^15."""
    xi = x.to(torch.int64)
    k = torch.zeros_like(xi)
    for b in (16, 8, 4, 2, 1):
        big = (xi >> b) > 0
        xi = torch.where(big, xi >> b, xi)
        k = k + torch.where(big, b, 0)
    quirk = (x == 8192.0) | (x == 32768.0)
    return (k - quirk.to(k.dtype)).to(torch.float32)


def _level_bits_arith(lv: torch.Tensor) -> torch.Tensor:
    """Closed-form per-coefficient level bits (gt1/gt2/rice-0 + EG1)."""
    l = lv.to(torch.float32)
    rem = l - 3.0
    k = floor_log2(torch.clamp(rem - 3.0, min=0.0) + 2.0)
    rice = torch.where(rem < 3.0, rem + 1.0, 4.0 + 2.0 * k)
    return torch.where(
        l <= 1.0, _f32_const(GT1_BITS[0], l.device),
        torch.where(l <= 2.0,
                    _f32_const(GT1_BITS[1] + GT2_BITS[0], l.device),
                    (GT1_BITS[1] + GT2_BITS[1]) + rice))


_QP_SCALE_QPS = np.asarray([22.0, 27.0, 32.0, 37.0, 42.0], np.float32)
_QP_SCALE_VALS = np.asarray([0.794, 0.816, 0.731, 0.664, 0.611],
                            np.float32)


def _qp_scale_f32(q: float) -> np.float32:
    """The reference's jnp.interp at one float32 qp, fused multiply-add
    included."""
    xp, fp = _QP_SCALE_QPS, _QP_SCALE_VALS
    x = np.float32(q)
    if x < xp[0]:
        return fp[0]
    if x > xp[-1]:
        return fp[-1]
    i = int(np.clip(np.searchsorted(xp, x, side="right"), 1, len(xp) - 1))
    df = np.float32(fp[i] - fp[i - 1])
    dx = np.float32(xp[i] - xp[i - 1])
    delta = np.float32(x - xp[i - 1])
    a = np.float32(delta / dx)
    return np.float32(float(a) * float(df) + float(fp[i - 1]))


@functools.lru_cache(maxsize=None)
def _qp_scale_table(device) -> torch.Tensor:
    return torch.as_tensor(
        np.asarray([_qp_scale_f32(q) for q in range(64)], np.float32),
        device=device)


def qp_scale(qp) -> torch.Tensor:
    """QP-conditioned correction of the residual estimate (integer qp)."""
    if not isinstance(qp, torch.Tensor):
        return torch.tensor(_qp_scale_f32(qp))
    return _qp_scale_table(qp.device)[qp.long().clamp(0, 63)]


def residual_bits(level: torch.Tensor, size: int, qp=None) -> torch.Tensor:
    """Estimated CABAC bits of residual_coding() per TB (float32 [...];
    0 for all-zero TBs; the cbf flag is not included)."""
    n = size * size
    dev = level.device
    perm = _dev("perm", size, dev)
    lv = level.abs().reshape(*level.shape[:-2], n)[..., perm]
    nz = lv > 0
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    any_nz = nz.any(-1)
    last = torch.where(nz, idx, -1).amax(-1)
    lastc = torch.clamp(last, min=0)

    raster = perm[lastc]
    lx = raster % size
    ly = raster // size
    lb = _dev("lut", size, dev)
    bits_last = lb[lx] + lb[ly]

    ncg = max(n // 16, 1)
    cg_nz = nz.reshape(*nz.shape[:-1], ncg, 16).any(-1)
    cg_idx = torch.arange(ncg, dtype=torch.int64, device=dev)
    last_cg = lastc // 16
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    if ncg > 1:
        cg_coded = (cg_idx >= 1) & (cg_idx < last_cg[..., None])
        cgb = torch.where(cg_nz, _f32_const(CG_BITS[1], dev),
                          _f32_const(CG_BITS[0], dev))
        bits_cg = f32.row_sum(torch.where(cg_coded, cgb, zero))
    else:
        bits_cg = torch.zeros(lastc.shape, dtype=torch.float32, device=dev)

    cg_on = cg_nz | (cg_idx == 0) | (cg_idx == last_cg[..., None])
    pos_on = torch.repeat_interleave(cg_on, 16, dim=-1) \
        & (idx < last[..., None])
    sigb = torch.where(nz, _f32_const(SIG_BITS[1], dev),
                       _f32_const(SIG_BITS[0], dev))
    bits_sig = f32.row_sum(torch.where(pos_on, sigb, zero))

    # XLA-CPU vectorizes this reduction of a 4x4 TB (a halving tree)
    bits_lvl = f32.row_sum(
        torch.where(nz, _level_bits_arith(lv) + 1.0, zero), tree=True)

    total = bits_last + bits_cg + bits_sig + bits_lvl
    if qp is not None:
        scale = qp_scale(qp) if isinstance(qp, torch.Tensor) else \
            _qp_scale_table(dev)[min(max(int(qp), 0), 63)]
        total = total * scale
    return torch.where(any_nz, total, zero)


def mvd_bits(mvd: torch.Tensor) -> torch.Tensor:
    """Exact bin count of mvd_coding() (spec 9.3.3.5); mvd int [..., 2]
    quarter-pel.  Returns float32 [...]."""
    a = mvd.abs().to(torch.float32)
    gt0 = a > 0
    gt1 = a > 1
    v = torch.clamp(a - 2.0, min=0.0)
    egk = floor_log2(v / 2.0 + 1.0)
    eg1 = 2.0 * egk + 2.0
    zero = torch.zeros((), dtype=torch.float32, device=a.device)
    comp = (1.0 + torch.where(gt0, _f32_const(2.0, a.device), zero)
            + torch.where(gt1, eg1, zero))
    return comp[..., 0] + comp[..., 1]


def intra_mode_bits(in_mpm: torch.Tensor) -> torch.Tensor:
    """Luma intra mode bits: MPM hit = flag + 1-2 bypass bins (2.4 on
    average), miss = flag + 5 bypass bins."""
    return torch.where(in_mpm, _f32_const(2.4, in_mpm.device),
                       _f32_const(6.0, in_mpm.device))


def rd_lambda_f32(qp: torch.Tensor, slice_type_i: bool) -> torch.Tensor:
    """tables.rd_lambda evaluated in float32 on an integer qp tensor, as
    the reference computes it on the device (XLA divides by the constant
    3.0 as a multiply by its float32 reciprocal)."""
    qp_factor = 0.57 if slice_type_i else 0.4624 * 0.95
    y = (qp.to(torch.int32) - 12).to(torch.float32) \
        * _f32_const(1.0 / 3.0, qp.device)
    return _f32_const(qp_factor, qp.device) * f32.exp2(y)


@functools.lru_cache(maxsize=None)
def _f32_const(value: float, device) -> torch.Tensor:
    """A float32 constant on `device`, uploaded once."""
    return torch.tensor(value, dtype=torch.float32, device=device)
