"""Vectorized HEVC deblocking filter (spec 8.7.2).

Port of homerhevc_tpu/ops/deblock.py: edges of one direction are 8 px
apart and touch at most 4 px per side, so each pass is one dense tensor
program over the frame (vertical edges; the horizontal pass runs the
same code on the transpose).
"""
from __future__ import annotations

import functools

import torch

from homerhevc_torch import tables


@functools.lru_cache(maxsize=None)
def _lut(name: str, device) -> torch.Tensor:
    t = tables.DEBLOCK_TC_TABLE if name == "tc" else \
        tables.DEBLOCK_BETA_TABLE
    return torch.as_tensor(t, dtype=torch.int32, device=device)


def _per_seg(qp, shape, device) -> torch.Tensor:
    return torch.as_tensor(qp, dtype=torch.int32,
                           device=device).expand(shape)


def _luma_pass(y: torch.Tensor, bs: torch.Tensor, qp) -> torch.Tensor:
    """One direction of luma deblocking over vertical edges.  y [H, W]
    int32; bs [H//4, W//8] (column 0 = picture edge); qp scalar or
    per-segment [H//4, W//8]."""
    h, w = y.shape
    dev = y.device
    ne = w // 8 - 1
    g = h // 4
    bs = bs[:, 1:]
    qp = _per_seg(qp, (g, w // 8), dev)[:, 1:]
    win = y[:, 4:w - 4].reshape(g, 4, ne, 8)
    p = torch.flip(win[..., :4], (-1,))               # p0..p3
    q = win[..., 4:]
    beta = _lut("beta", dev)[qp.clamp(0, 51).long()]
    tc = _lut("tc", dev)[(qp + 2 * (bs - 1)).clamp(0, 53).long()]

    def d2(v, line):
        return (v[:, line, :, 2] - 2 * v[:, line, :, 1]
                + v[:, line, :, 0]).abs()

    dp0, dp3 = d2(p, 0), d2(p, 3)
    dq0, dq3 = d2(q, 0), d2(q, 3)
    dpq0 = dp0 + dq0
    dpq3 = dp3 + dq3
    d = dpq0 + dpq3
    filt = (d < beta) & (bs > 0)

    def dsam(line, dpq):
        return ((2 * dpq < (beta >> 2))
                & ((p[:, line, :, 3] - p[:, line, :, 0]).abs()
                   + (q[:, line, :, 0] - q[:, line, :, 3]).abs()
                   < (beta >> 3))
                & ((p[:, line, :, 0] - q[:, line, :, 0]).abs()
                   < ((5 * tc + 1) >> 1)))

    strong = dsam(0, dpq0) & dsam(3, dpq3)
    side = (beta + (beta >> 1)) >> 3
    dep1 = (dp0 + dp3) < side
    deq1 = (dq0 + dq3) < side

    tc_l = tc[:, None, :]
    p0, p1, p2, p3 = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    q0, q1, q2, q3 = q[..., 0], q[..., 1], q[..., 2], q[..., 3]

    def clip3(v, lo, hi):
        return torch.minimum(torch.maximum(v, lo), hi)

    sp0 = clip3((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                p0 - 2 * tc_l, p0 + 2 * tc_l)
    sp1 = clip3((p2 + p1 + p0 + q0 + 2) >> 2, p1 - 2 * tc_l, p1 + 2 * tc_l)
    sp2 = clip3((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3,
                p2 - 2 * tc_l, p2 + 2 * tc_l)
    sq0 = clip3((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3,
                q0 - 2 * tc_l, q0 + 2 * tc_l)
    sq1 = clip3((p0 + q0 + q1 + q2 + 2) >> 2, q1 - 2 * tc_l, q1 + 2 * tc_l)
    sq2 = clip3((p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3,
                q2 - 2 * tc_l, q2 + 2 * tc_l)

    delta0 = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    wk_on = delta0.abs() < 10 * tc_l
    delta = clip3(delta0, -tc_l, tc_l)
    wp0 = (p0 + delta).clamp(0, 255)
    wq0 = (q0 - delta).clamp(0, 255)
    tch = tc_l >> 1
    dp1v = clip3((((p2 + p0 + 1) >> 1) - p1 + delta) >> 1, -tch, tch)
    wp1 = (p1 + dp1v).clamp(0, 255)
    dq1v = clip3((((q2 + q0 + 1) >> 1) - q1 - delta) >> 1, -tch, tch)
    wq1 = (q1 + dq1v).clamp(0, 255)

    st = strong[:, None, :]
    fl = filt[:, None, :]
    w_on = fl & ~st & wk_on
    np0 = torch.where(fl & st, sp0, torch.where(w_on, wp0, p0))
    nq0 = torch.where(fl & st, sq0, torch.where(w_on, wq0, q0))
    np1 = torch.where(fl & st, sp1,
                      torch.where(w_on & dep1[:, None, :], wp1, p1))
    nq1 = torch.where(fl & st, sq1,
                      torch.where(w_on & deq1[:, None, :], wq1, q1))
    np2 = torch.where(fl & st, sp2, p2)
    nq2 = torch.where(fl & st, sq2, q2)

    new_win = torch.stack([p3, np2, np1, np0, nq0, nq1, nq2, q3], -1)
    out = y.clone()
    out[:, 4:w - 4] = new_win.reshape(h, ne * 8)
    return out


def _chroma_pass(c: torch.Tensor, bs: torch.Tensor, qp_c) -> torch.Tensor:
    """One direction of chroma deblocking (spec 8.7.2.5.5); only bs == 2
    filters.  bs [H//2, W//8]."""
    h, w = c.shape
    dev = c.device
    ne = w // 8 - 1
    bs = bs[:, 1:]
    qp_c = _per_seg(qp_c, (h // 2, w // 8), dev)[:, 1:]
    tc = _lut("tc", dev)[(qp_c + 2).clamp(0, 53).long()]
    tc_l = torch.repeat_interleave(tc, 2, 0)
    on = torch.repeat_interleave(bs >= 2, 2, 0)
    win = c[:, 4:w - 4].reshape(h, ne, 8)
    p1, p0, q0, q1 = win[..., 2], win[..., 3], win[..., 4], win[..., 5]
    delta = torch.minimum(torch.maximum(
        (((q0 - p0) << 2) + p1 - q1 + 4) >> 3, -tc_l), tc_l)
    np0 = torch.where(on, (p0 + delta).clamp(0, 255), p0)
    nq0 = torch.where(on, (q0 - delta).clamp(0, 255), q0)
    new_win = win.clone()
    new_win[..., 3] = np0
    new_win[..., 4] = nq0
    out = c.clone()
    out[:, 4:w - 4] = new_win.reshape(h, ne * 8)
    return out


def deblock_luma(y, bs_v, bs_h, qp):
    """Full luma deblock: all vertical edges, then all horizontal."""
    y = _luma_pass(y, bs_v, qp)
    qt = qp.T if isinstance(qp, torch.Tensor) and qp.dim() == 2 else qp
    return _luma_pass(y.T.contiguous(), bs_h.T, qt).T.contiguous()


def deblock_chroma(c, bs_v, bs_h, qp_c):
    c = _chroma_pass(c, bs_v, qp_c)
    qt = qp_c.T if isinstance(qp_c, torch.Tensor) and qp_c.dim() == 2 \
        else qp_c
    return _chroma_pass(c.T.contiguous(), bs_h.T, qt).T.contiguous()
