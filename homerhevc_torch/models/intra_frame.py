"""Batched intra-frame encoder: dense mode decision + wavefront recon.

Port of homerhevc_tpu/models/intra_frame.py (`encode_frame`,
`encode_i_chunk`), with tiles (a (cols, rows) grid cuts intra
availability and the wavefront's dependencies at tile boundaries) and
the default scaling lists (`scaling_lists`, in every TQ call).

`encode_i_chunk` codes K independent frames (an all-intra chunk) in one
pass: each wavefront step reconstructs the step's slots of all K frames
as one batch (a per-slot frame index next to the slot's position), so a
step costs one frame's launches whatever K is; `encode_frame` is its
K = 1 case.  `encode_i_chunk_sharded` splits a chunk's frames over the
ranks of a process group.

1. Dense decision (frame by frame): luma modes at 32, 16 and
   (search_8x8 / search_nxn) 8 and 4, and the 5-candidate chroma modes,
   from source-pixel reference samples (or those of a decision plane,
   dec_y), for every block at once; under
   rd_refine (rd=FULL) the SATD cost's three best modes at 32 and 16
   with their mode bits.
2. Wavefront reconstruction over 32x32 slots (models/schedule.py plans):
   each step reconstructs all slots of one anti-diagonal as one batch —
   a 32x32 CU against its four 16x16 children (under rd_refine each at
   the best of its three candidate modes by SSD + lambda * (residual +
   mode bits), chroma DM following the refined mode), each 16x16
   against four 8x8 CUs (search_8x8), each 8x8 against the TU split at
   its parent's mode (tu_split) and against four 4x4 NxN PUs with DST
   (search_nxn), all with SSD + lambda*bits RD; chroma (DM) 16x16, 8x8
   or 4x4 TBs, Cb and Cr as one batch.
3. Deblocking, SAO and the packed device->host record (frame by
   frame).
"""
from __future__ import annotations

import functools
import types

import numpy as np
import torch

from homerhevc_torch import parallel, tables
from homerhevc_torch.models import schedule
from homerhevc_torch.ops import (deblock, f32, intra, quant, rdbits, sao,
                                 transform)
from homerhevc_torch.ops.me import blocks as _blocks
from homerhevc_torch.utils.profiler import count, stage

_CU_HDR_BITS = 6.0
_SPLIT_BITS = 1.5
_K_REFINE = 3               # rd=FULL: candidate modes per 32 and 16 CU
_SUB_OFF = ((0, 0), (0, 1), (1, 0), (1, 1))     # z-order (qy, qx)


def _segment_avail_layout(s: int) -> np.ndarray:
    """Map 5 segment-availability bools to the [4S+1] adi mask layout."""
    seg = np.zeros((5, 4 * s + 1), dtype=bool)
    seg[0, 0:s] = True
    seg[1, s:2 * s] = True
    seg[2, 2 * s] = True
    seg[3, 2 * s + 1:3 * s + 1] = True
    seg[4, 3 * s + 1:] = True
    return seg


def _pix_masks_np(av5, px, py, s: int, cw: int, ch: int,
                  chroma: bool = False) -> np.ndarray:
    """Per-pixel ADI availability [..., 4S+1]: segment availability
    clipped at the coded picture bounds (cw, ch)."""
    seg = _segment_avail_layout(s)
    base = (av5.astype(np.int32) @ seg.astype(np.int32)) > 0
    if chroma:
        px, py, cw, ch = px // 2, py // 2, cw // 2, ch // 2
    px = np.asarray(px)[..., None]
    py = np.asarray(py)[..., None]
    j = np.arange(4 * s + 1)
    row = np.where(j < 2 * s, py + 2 * s - 1 - j, py - 1)
    col = np.where(j <= 2 * s, px - 1, px + (j - 2 * s - 1))
    return base & (row < ch) & (col < cw)


@functools.lru_cache(maxsize=None)
def _avail_np(w: int, h: int, s: int, ctu: int, tiles=None) -> np.ndarray:
    """[h//s, w//s, 5] neighbour-segment availability (coding order,
    tile boundaries cut)."""
    av = schedule.availability(w // s, h // s, ctu // s, tiles)
    return np.stack([av["bottomleft"], av["left"], av["corner"],
                     av["top"], av["topright"]], axis=-1)


@functools.lru_cache(maxsize=None)
def _avail_dev(w: int, h: int, s: int, ctu: int, tiles, device):
    """(per-pixel ADI mask [nb, 4s+1], segment availability [nb, 5]) of
    every s x s block, on `device`, uploaded once."""
    seg = _avail_np(w, h, s, ctu, tiles).reshape(-1, 5)
    return (torch.as_tensor(_avail_mask(seg, s), device=device),
            torch.as_tensor(seg, device=device))


def _mpm_candidates(left_m, top_m):
    """Vectorized 3-MPM derivation (spec 8.4.2)."""
    a, b = left_m, top_m
    eq = a == b
    a_ang = a >= 2
    zero = torch.zeros_like(a)
    c0_eq = torch.where(a_ang, a, zero)
    c1_eq = torch.where(a_ang, 2 + ((a + 29) % 32), zero + 1)
    c2_eq = torch.where(a_ang, 2 + ((a - 1) % 32), zero + 26)
    c2_ne = torch.where((a != 0) & (b != 0), zero,
                        torch.where(a + b < 2, zero + 26, zero + 1))
    c0 = torch.where(eq, c0_eq, a)
    c1 = torch.where(eq, c1_eq, b)
    c2 = torch.where(eq, c2_eq, c2_ne)
    return torch.stack([c0, c1, c2], -1)


@functools.lru_cache(maxsize=None)
def _hadamard(n: int, device) -> torch.Tensor:
    h = np.array([[1]], np.float64)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return torch.as_tensor(h, device=device)


def satd(resid: torch.Tensor, size: int) -> torch.Tensor:
    """Sum of absolute Hadamard-transformed differences / size, float32
    [...].  The float64 products are exact, and the sum stays below 2^24
    (Parseval), so it is the reference's float32 value."""
    h = _hadamard(size, resid.device)
    t = h @ resid.to(torch.float64) @ h
    return (t.abs().sum((-1, -2)) / size).to(torch.float32)


def _adi_at(bufs: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor,
            s: int, ff: torch.Tensor) -> torch.Tensor:
    """adi [n, 4S+1] from a stack of zero-bordered buffers [F, H, W]:
    block i reads buffer ff[i], whose (yy, xx) is its corner sample
    p(-1, -1)."""
    k = torch.arange(2 * s + 1, device=bufs.device)
    top = bufs[ff[:, None], yy[:, None], xx[:, None] + k[None]]
    left = bufs[ff[:, None], yy[:, None] + 1 + k[None, :2 * s], xx[:, None]]
    return torch.cat([torch.flip(left, (-1,)), top], -1)


def _window(planes: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor,
            size: int, ff: torch.Tensor) -> torch.Tensor:
    """[n, size, size] windows at (yy, xx) [n] of planes [F, H, W],
    window i from plane ff[i]."""
    k = torch.arange(size, device=planes.device)
    return planes[ff[:, None, None], (yy[:, None] + k)[:, :, None],
                  (xx[:, None] + k)[:, None, :]]


def _avail_mask(seg_av: np.ndarray, s: int) -> np.ndarray:
    return (seg_av.astype(np.int32)
            @ _segment_avail_layout(s).astype(np.int32)) > 0


def _dense_best(y32: torch.Tensor, s: int, ctu: int, sqrt_lam,
                topk: int = 1, tiles=None, adi_plane=None):
    """Best intra mode per s x s block (SATD + MPM-aware mode bits,
    source-pixel references, or those of the decision plane `adi_plane`
    where given, availability cut at tile boundaries).
    Returns (mode [bh, bw] int64, its cost [bh, bw] float32); with
    topk > 1, the topk best modes and their mode bits, best first
    ([topk, bh, bw] each; equal costs lowest mode first, as
    lax.top_k)."""
    h, w = y32.shape
    bh, bw = h // s, w // s
    dev = y32.device
    buf = torch.zeros((1 + h + s, 1 + w + s), dtype=torch.int32,
                      device=dev)
    buf[1:1 + h, 1:1 + w] = y32 if adi_plane is None else adi_plane
    py = torch.arange(bh, device=dev).repeat_interleave(bw) * s
    px = (torch.arange(bw, device=dev) * s).repeat(bh)
    amask, segt = _avail_dev(w, h, s, ctu, tiles, dev)
    adi = intra.substitute_refs(
        _adi_at(buf[None], py, px, s, torch.zeros_like(py)), amask)
    preds = intra.predict_all_modes(adi, s, True, strong=True)
    all_s = satd(preds - _blocks(y32, s)[:, None], s)     # [nb, 35]
    best0 = torch.argmin(all_s, -1).reshape(bh, bw)
    ones_c = torch.ones((bh, 1), dtype=best0.dtype, device=dev)
    left_m = torch.cat([ones_c, best0[:, :-1]], 1)
    top_m = torch.cat([torch.ones((1, bw), dtype=best0.dtype, device=dev),
                       best0[:-1]], 0)
    left_m = torch.where(segt[:, 1].reshape(bh, bw), left_m, 1)
    top_m = torch.where(segt[:, 3].reshape(bh, bw), top_m, 1)
    cands = _mpm_candidates(left_m.reshape(-1), top_m.reshape(-1))
    all_m = torch.arange(35, device=dev)
    in_mpm = (all_m[None, :, None] == cands[:, None, :]).any(-1)
    mbits = rdbits.intra_mode_bits(in_mpm)
    cost = f32.fma(sqrt_lam, mbits, all_s)
    if topk > 1:
        idx = torch.sort(cost, dim=-1, stable=True)[1][:, :topk]
        return (idx.T.reshape(topk, bh, bw),
                torch.gather(mbits, 1, idx).T.reshape(topk, bh, bw))
    return (torch.argmin(cost, -1).reshape(bh, bw),
            cost.amin(-1).reshape(bh, bw))


def _dense_best_chroma(u32, v32, lm_grid, s_l: int, ctu: int, sqrt_lam_c,
                       tiles=None):
    """Best chroma mode per luma-s_l CU among {planar, ver, hor, DC (34
    for the luma mode's duplicate), DM}: SATD(Cb) + SATD(Cr) +
    sqrt_lambda_c * mode bits."""
    s = s_l // 2
    hc, wc = u32.shape
    bh, bw = hc // s, wc // s
    nb = bh * bw
    dev = u32.device
    lmf = lm_grid.reshape(nb)
    py = torch.arange(bh, device=dev).repeat_interleave(bw) * s
    px = (torch.arange(bw, device=dev) * s).repeat(bh)
    amask = _avail_dev(wc, hc, s, ctu // 2, tiles, dev)[0]

    def adi_of(plane):
        buf = torch.zeros((1 + hc + s, 1 + wc + s), dtype=torch.int32,
                          device=dev)
        buf[1:1 + hc, 1:1 + wc] = plane
        return intra.substitute_refs(
            _adi_at(buf[None], py, px, s, torch.zeros_like(py)), amask)

    adi2 = (adi_of(u32), adi_of(v32))
    orig2 = (_blocks(u32, s), _blocks(v32, s))
    base = torch.tensor([0, 26, 10, 1], device=dev)
    cand = torch.where(base[None, :] == lmf[:, None], 34, base[None, :])
    cand = torch.cat([cand, lmf[:, None]], 1)             # [nb, 5]
    costs = []
    for k in range(5):
        m = cand[:, k]
        sd = (satd(intra.predict_single_mode(adi2[0], m, s, False)
                   - orig2[0], s)
              + satd(intra.predict_single_mode(adi2[1], m, s, False)
                     - orig2[1], s))
        costs.append(f32.fma(sqrt_lam_c, 1.0 if k == 4 else 3.0, sd))
    k = torch.argmin(torch.stack(costs, -1), -1)
    best = torch.gather(cand, 1, k[:, None])[:, 0]
    return best.reshape(bh, bw)


@functools.lru_cache(maxsize=None)
def build_plan(width: int, height: int, ctu: int = 64, coded=None,
               tiles=None):
    """Static wavefront plan over 32x32 slots: per step, the valid slots
    and their per-pixel availability masks (numpy), z-ordered sub-blocks
    first: av16 [4, nb, 65], av8 [4, 4, nb, 33], av4 [4, 4, 4, nb, 17]
    and the chroma masks av16c / av8c.  A (cols, rows) tile grid cuts
    the dependencies at tile boundaries: fewer, wider steps."""
    s = 32
    bw, bh = width // s, height // s
    steps, n_steps, batches = schedule.wavefront_schedule(bw, bh, ctu // s,
                                                          tiles)
    cw, ch = coded if coded is not None else (width, height)
    av_g = {k: _avail_np(width, height, k, ctu, tiles)
            for k in (32, 16, 8, 4)}
    plan = []
    for st in range(n_steps):
        by = batches[st, :, 0]
        bx = batches[st, :, 1]
        keep = by >= 0
        by, bx = by[keep], bx[keep]
        nb = len(by)
        px32, py32 = 32 * bx, 32 * by
        a32 = av_g[32][by, bx]
        av16 = np.zeros((4, nb, 65), bool)
        av16c = np.zeros((4, nb, 33), bool)
        av8 = np.zeros((4, 4, nb, 33), bool)
        av8c = np.zeros((4, 4, nb, 17), bool)
        av4 = np.zeros((4, 4, 4, nb, 17), bool)
        for k16, (qy, qx) in enumerate(_SUB_OFF):
            p16x, p16y = px32 + 16 * qx, py32 + 16 * qy
            a = av_g[16][2 * by + qy, 2 * bx + qx]
            av16[k16] = _pix_masks_np(a, p16x, p16y, 16, cw, ch)
            av16c[k16] = _pix_masks_np(a, p16x, p16y, 8, cw, ch,
                                       chroma=True)
            for k8, (ry, rx) in enumerate(_SUB_OFF):
                p8x, p8y = p16x + 8 * rx, p16y + 8 * ry
                a = av_g[8][4 * by + 2 * qy + ry, 4 * bx + 2 * qx + rx]
                av8[k16, k8] = _pix_masks_np(a, p8x, p8y, 8, cw, ch)
                av8c[k16, k8] = _pix_masks_np(a, p8x, p8y, 4, cw, ch,
                                              chroma=True)
                for k4, (ty, tx) in enumerate(_SUB_OFF):
                    a = av_g[4][8 * by + 4 * qy + 2 * ry + ty,
                                8 * bx + 4 * qx + 2 * rx + tx]
                    av4[k16, k8, k4] = _pix_masks_np(
                        a, p8x + 4 * tx, p8y + 4 * ty, 4, cw, ch)
        plan.append(dict(
            by=by.astype(np.int64), bx=bx.astype(np.int64),
            av32=_pix_masks_np(a32, px32, py32, 32, cw, ch),
            av32c=_pix_masks_np(a32, px32, py32, 16, cw, ch, chroma=True),
            av16=av16, av16c=av16c, av8=av8, av8c=av8c, av4=av4,
            force32=(px32 + 32 > cw) | (py32 + 32 > ch)))
    return plan


# the slot axis of each plan array
_SLOT_AXIS = dict(by=0, bx=0, av32=0, av32c=0, force32=0, av16=1, av16c=1,
                  av8=2, av8c=2, av4=3)


@functools.lru_cache(maxsize=None)
def _device_plan(width: int, height: int, ctu: int, coded, tiles, nf: int,
                 device):
    """build_plan for nf frames at once, on `device`, uploaded once: each
    step's slots repeated per frame (frame-major), with their frame
    index `ff`; the chroma masks cover the Cb slots, then the Cr ones
    (`pf`: plane index p * nf + ff in a [2 nf, ...] stack)."""
    plan = []
    for st in build_plan(width, height, ctu, coded, tiles):
        nb = len(st["by"])
        ff = np.repeat(np.arange(nf), nb)
        d = dict(ff=ff, pf=np.concatenate([ff, ff + nf]))
        for key, ax in _SLOT_AXIS.items():
            reps = 2 * nf if key in ("av32c", "av16c", "av8c") else nf
            d[key] = np.concatenate([st[key]] * reps, axis=ax)
        plan.append({k: torch.as_tensor(v, device=device)
                     for k, v in d.items()})
    return plan


def _rd_zero_intra(level, recon, pred, orig, lam, qp):
    """Zero-residual RD with CABAC-LUT bit pricing."""
    ssd_coded = ((recon - orig) ** 2).sum((-1, -2)).to(torch.float32)
    ssd_zero = ((pred - orig) ** 2).sum((-1, -2)).to(torch.float32)
    bits = rdbits.residual_bits(level, level.shape[-1], qp=qp) + 2.0
    zero = ssd_zero <= f32.fma(lam, bits, ssd_coded)
    level = torch.where(zero[..., None, None], 0, level)
    recon = torch.where(zero[..., None, None], pred.clamp(0, 255), recon)
    return level, recon


@functools.lru_cache(maxsize=None)
def _mode_scans(size: int, device):
    """(scan [3, n], inverse [3, n]) raster indices of the diagonal,
    horizontal and vertical scans."""
    scans = np.stack([np.asarray(tables.scan_order(size, i), np.int64)
                      for i in (tables.SCAN_DIAG, tables.SCAN_HOR,
                                tables.SCAN_VER)])
    return (torch.as_tensor(scans, device=device),
            torch.as_tensor(np.argsort(scans, -1), device=device))


def _sbh_by_mode(level, du, mode, size: int, sign_hiding: bool):
    """Sign-bit hiding in each block's own coefficient scan (spec
    7.4.9.11: intra 4x4/8x8 luma and 4x4 chroma scan vertically for
    modes 6-14 and horizontally for modes 22-30): one SBH pass on levels
    gathered into per-block scan order, gathered back after."""
    if not sign_hiding:
        return level
    n = size * size
    scans, inv = _mode_scans(size, level.device)
    sel = torch.where((mode >= 6) & (mode <= 14), 2,
                      torch.where((mode >= 22) & (mode <= 30), 1, 0))
    shp = level.shape
    idx = scans[sel.long()]                                # [nb, n]
    sl = torch.gather(level.reshape(-1, n), 1, idx)
    sdu = torch.gather(du.reshape(-1, n), 1, idx)
    fixed = quant.sign_bit_hide(sl.reshape(shp), sdu.reshape(shp),
                                tuple(range(n)), size)
    return torch.gather(fixed.reshape(-1, n), 1,
                        inv[sel.long()]).reshape(shp)


def _tq_recon(orig, pred, size, qp, lam, sign_hiding=False, mode=None,
              is_dst=False, scaling=False):
    """residual -> T -> Q(-SBH) -> IQ -> IT -> recon + zero-RD.  With
    `mode` [n], SBH of 4x4 and 8x8 TBs runs in the mode's scan, else in
    the diagonal one; is_dst: DST-VII (luma 4x4); scaling: the default
    scaling lists.  Returns (level, recon, cbf)."""
    resid = orig - pred
    coeff = transform.forward_transform(resid, size, is_dst=is_dst)
    level, du = quant.quantize(coeff, qp, size, is_intra=True,
                               scaling=scaling)
    if sign_hiding and mode is not None and size in (4, 8):
        level = _sbh_by_mode(level, du, mode, size, True)
    elif sign_hiding:
        level = quant.sign_bit_hide(
            level, du, tables.scan_order(size, tables.SCAN_DIAG), size)
    deq = quant.dequantize(level, qp, size, is_intra=True, scaling=scaling)
    r = transform.inverse_transform(deq, size, is_dst=is_dst)
    recon = (pred + r).clamp(0, 255)
    level, recon = _rd_zero_intra(level, recon, pred, orig, lam, qp)
    cbf = (level != 0).any(-1).any(-1)
    return level.to(torch.int32), recon.to(torch.int32), cbf


def _refine(orig, adi, mk, mbk, size: int, qp, lamf, sign_hiding,
            scaling=False):
    """Full-RD pick among K candidate modes mk [K, nb] (mode bits mbk
    [K, nb]) of one block per slot: each reconstructed from the true
    ADI, the pick by SSD + lambda * (residual + mode bits), equal costs
    the earlier candidate.  Returns ((level, recon, cbf) of the pick,
    its mode [nb], its SSD + lambda * residual bits [nb])."""
    k, nb = mk.shape
    o_k = orig.repeat(k, 1, 1)
    pred = intra.predict_single_mode(adi.repeat(k, 1), mk.reshape(-1), size,
                                     True, strong=size == 32)
    lvl, rec, cbf = _tq_recon(o_k, pred, size, qp, lamf, sign_hiding,
                              scaling=scaling)
    ssd = ((rec - o_k) ** 2).sum((-1, -2)).to(torch.float32)
    base = f32.fma(lamf, rdbits.residual_bits(lvl, size, qp=qp),
                   ssd).reshape(k, nb)
    kb = torch.argmin(f32.fma(lamf, mbk, base), 0)
    ar = torch.arange(nb, device=orig.device)

    def pick(t):
        return t.reshape(k, nb, *t.shape[1:])[kb, ar]
    return (pick(lvl), pick(rec), pick(cbf)), mk[kb, ar], base[kb, ar]


def _ssd_cost(rec, orig, lvl, size, qp, lamf):
    ssd = ((rec - orig) ** 2).sum((-1, -2)).to(torch.float32)
    return f32.fma(lamf, rdbits.residual_bits(lvl, size, qp=qp)
                   + _CU_HDR_BITS, ssd)


def _luma8(patch8, orig32, o8y, o8x, adi8, m8, m16, cm8, m4s, av4, o):
    """One 8x8 sub-CU of a 16x16 (the reference's sub8 scan body): the
    8x8 CU at its own mode, or the TU-split candidate at the parent's
    mode (o.tu_split), against four 4x4 NxN PUs (o.search_nxn).  Returns
    (level, recon, RD cost, effective luma mode, NxN taken, PU modes
    [4, nb], PU cbfs [4, nb])."""
    nb = orig32.shape[0]
    qp, lamf = o.qp, o.lamf
    tq = dict(sign_hiding=o.sign_hiding, scaling=o.scaling)
    o8 = orig32[:, o8y:o8y + 8, o8x:o8x + 8]
    if o.tu_split:
        # also the sub-8 at the parent 16's mode: when all four take it,
        # the record stage folds the quartet into one 16 CU with a split
        # transform tree (1-bit discount); vetoed where the sub's chroma
        # mode 34 would leave the new DM list
        m2 = torch.cat([m8, m16])
        o2 = o8.repeat(2, 1, 1)
        pr2 = intra.predict_single_mode(adi8.repeat(2, 1), m2, 8, True)
        l2, r2, c2 = _tq_recon(o2, pr2, 8, qp, lamf, mode=m2, **tq)
        cost2 = _ssd_cost(r2, o2, l2, 8, qp, lamf)
        m16_in_def = (m16 == 0) | (m16 == 26) | (m16 == 10) | (m16 == 1)
        chroma_ok = (cm8 != 34) | m16_in_def
        take_p = ((cost2[nb:] - lamf < cost2[:nb]) & (m16 != m8)
                  & chroma_ok)
        tp = take_p[:, None, None]
        l8 = torch.where(tp, l2[nb:], l2[:nb])
        r8 = torch.where(tp, r2[nb:], r2[:nb])
        c8 = torch.where(take_p, c2[nb:], c2[:nb])
        m8 = torch.where(take_p, m16, m8)
        cost_2n = torch.where(take_p, cost2[nb:], cost2[:nb])
    else:
        pr8 = intra.predict_single_mode(adi8, m8, 8, True)
        l8, r8, c8 = _tq_recon(o8, pr8, 8, qp, lamf, mode=m8, **tq)
        cost_2n = _ssd_cost(r8, o8, l8, 8, qp, lamf)
    if not o.search_nxn:
        return (l8, r8, cost_2n, m8, torch.zeros_like(c8),
                m8[None].expand(4, nb), c8[None].expand(4, nb))
    # NxN: four 4x4 PUs in z-order with their own modes, DST TBs and
    # recon feedback inside the CU
    p4 = patch8.clone()
    l4s = torch.zeros((nb, 8, 8), dtype=torch.int32, device=o8.device)
    cost_n = (lamf * (_CU_HDR_BITS + 10.0)).expand(nb)
    pu_c = []
    for k4, (ty, tx) in enumerate(_SUB_OFF):
        o4y, o4x = o8y + 4 * ty, o8x + 4 * tx
        adi4 = intra.substitute_refs(_patch_adi(p4, o4y, o4x, 4), av4[k4])
        pr4 = intra.predict_single_mode(adi4, m4s[k4], 4, True)
        o4 = orig32[:, o4y:o4y + 4, o4x:o4x + 4]
        l4, r4, c4 = _tq_recon(o4, pr4, 4, qp, lamf, mode=m4s[k4],
                               is_dst=True, **tq)
        ssd4 = ((r4 - o4) ** 2).sum((-1, -2)).to(torch.float32)
        cost_n = f32.fma(lamf, rdbits.residual_bits(l4, 4, qp=qp),
                         cost_n + ssd4)
        p4[:, o4y + 1:o4y + 5, o4x + 1:o4x + 5] = r4
        l4s[:, 4 * ty:4 * ty + 4, 4 * tx:4 * tx + 4] = l4
        pu_c.append(c4)
    rec_n = p4[:, o8y + 1:o8y + 9, o8x + 1:o8x + 9]
    take_n = cost_n < cost_2n
    tn = take_n[:, None, None]
    return (torch.where(tn, l4s, l8), torch.where(tn, rec_n, r8),
            torch.minimum(cost_n, cost_2n),
            torch.where(take_n, m4s[0], m8), take_n, m4s,
            torch.stack(pu_c))


def _chroma_slot(rec_c, uv, pf, cy0, cx0, cm32, cm16_all, cm8_eff, sp16,
                 st, o):
    """Chroma (DM) of a step's slots in both planes as one batch (slot i
    of plane stack pf[i]: the Cb slots, then the Cr ones): a 16x16 TB
    (CU32), 8x8 TBs (CU16) and, under split 16s, 4x4 TBs (CU8).
    Returns the CU32 variant (levels, recon, cbf) and the children's
    (levels, recon, cbf [n, 4, 4])."""
    n = cy0.shape[0]
    tq = dict(sign_hiding=o.sign_hiding, scaling=o.scaling)
    orig_c = _window(uv, cy0, cx0, 16, pf)
    adi_c = intra.substitute_refs(_adi_at(rec_c, cy0, cx0, 16, pf),
                                  st["av32c"])
    pr_c16 = intra.predict_single_mode(adi_c, cm32, 16, False)
    lc16, rc16, cc16 = _tq_recon(orig_c, pr_c16, 16, o.qp_c, o.lamcf, **tq)
    cpatch = _window(rec_c, cy0, cx0, 25, pf).clone()
    lv_ch = torch.zeros((n, 16, 16), dtype=torch.int32, device=cy0.device)
    cbfs = []
    for k16, (qq_y, qq_x) in enumerate(_SUB_OFF):
        oy, ox = 8 * qq_y, 8 * qq_x
        adi8 = intra.substitute_refs(_patch_adi(cpatch, oy, ox, 8),
                                     st["av16c"][k16])
        pr8 = intra.predict_single_mode(adi8, cm16_all[k16], 8, False)
        o8 = orig_c[:, oy:oy + 8, ox:ox + 8]
        l8, r8, c8 = _tq_recon(o8, pr8, 8, o.qp_c, o.lamcf, **tq)
        if o.search_8x8:
            cpatch4 = cpatch.clone()
            l4s = torch.zeros((n, 8, 8), dtype=torch.int32,
                              device=cy0.device)
            c4s = []
            for k8, (ry, rx) in enumerate(_SUB_OFF):
                o4y, o4x = oy + 4 * ry, ox + 4 * rx
                adi4 = intra.substitute_refs(
                    _patch_adi(cpatch4, o4y, o4x, 4), st["av8c"][k16, k8])
                m8 = cm8_eff[k16, k8]
                pr4 = intra.predict_single_mode(adi4, m8, 4, False)
                o4 = orig_c[:, o4y:o4y + 4, o4x:o4x + 4]
                l4, r4, c4 = _tq_recon(o4, pr4, 4, o.qp_c, o.lamcf, mode=m8,
                                       **tq)
                cpatch4[:, o4y + 1:o4y + 5, o4x + 1:o4x + 5] = r4
                l4s[:, 4 * ry:4 * ry + 4, 4 * rx:4 * rx + 4] = l4
                c4s.append(c4)
            spm = sp16[k16][:, None, None]
            r8 = torch.where(spm, cpatch4[:, oy + 1:oy + 9, ox + 1:ox + 9],
                             r8)
            l8 = torch.where(spm, l4s, l8)
            cbfs.append(torch.where(sp16[k16][None], torch.stack(c4s),
                                    c8[None]))
        else:
            cbfs.append(c8[None].expand(4, n))
        cpatch[:, oy + 1:oy + 9, ox + 1:ox + 9] = r8
        lv_ch[:, oy:oy + 8, ox:ox + 8] = l8
    return (lc16, rc16, cc16), (lv_ch, cpatch[:, 1:17, 1:17],
                                torch.stack(cbfs).permute(2, 0, 1))


_TOPK_KEYS = ("mode32k", "mbits32k", "mode16k", "mbits16k")


def _dense_decision(y32, u32, v32, ctu: int, sqrt_lam, sqrt_lam_c, tiles,
                    o) -> dict:
    """Pass 1 for one frame: the dense mode maps (under rd_refine also
    the SATD cost's top K at 32 and 16, and their mode bits).  The luma
    references come from o.adi_y where given (SATD stays against the
    source)."""
    d = {}
    ady = o.adi_y
    if o.rd_refine:
        d["mode32k"], d["mbits32k"] = _dense_best(y32, 32, ctu, sqrt_lam,
                                                  _K_REFINE, tiles, ady)
        d["mode16k"], d["mbits16k"] = _dense_best(y32, 16, ctu, sqrt_lam,
                                                  _K_REFINE, tiles, ady)
        d["mode32"], d["mode16"] = d["mode32k"][0], d["mode16k"][0]
    else:
        d["mode32"] = _dense_best(y32, 32, ctu, sqrt_lam, tiles=tiles,
                                  adi_plane=ady)[0]
        d["mode16"] = _dense_best(y32, 16, ctu, sqrt_lam, tiles=tiles,
                                  adi_plane=ady)[0]
    d["cmode32"] = _dense_best_chroma(u32, v32, d["mode32"], 32, ctu,
                                      sqrt_lam_c, tiles)
    d["cmode16"] = _dense_best_chroma(u32, v32, d["mode16"], 16, ctu,
                                      sqrt_lam_c, tiles)
    if o.search_8x8:
        d["mode8"] = _dense_best(y32, 8, ctu, sqrt_lam, tiles=tiles,
                                 adi_plane=ady)[0]
        d["cmode8"] = _dense_best_chroma(u32, v32, d["mode8"], 8, ctu,
                                         sqrt_lam_c, tiles)
    if o.search_nxn:
        d["mode4"] = _dense_best(y32, 4, ctu, sqrt_lam, tiles=tiles,
                                 adi_plane=ady)[0]
    return d


def _wavefront_step(st, dec, y32, uv32, bufs, o):
    """One wavefront step: the step's 32x32 slots of every frame (slot i
    in frame st["ff"][i]) reconstructed as one batch, the results
    scattered into `bufs`.  dec: the dense maps [F, ...] ([K, F, ...]
    for the top K); y32 [F, H, W] and uv32 [2F, H/2, W/2] (Cb frames,
    then Cr) the source; o: the chunk's QPs, lambdas and tools."""
    ff, by, bx = st["ff"], st["by"], st["bx"]
    nb = by.shape[0]
    i32 = dict(dtype=torch.int32, device=by.device)
    qp, lamf = o.qp, o.lamf
    tq = dict(sign_hiding=o.sign_hiding, scaling=o.scaling)
    rec_y = bufs["rec_y"]
    mode32, mode16 = dec["mode32"], dec["mode16"]
    y0, x0 = by * 32, bx * 32
    m32 = mode32[ff, by, bx]
    orig32 = _window(y32, y0, x0, 32, ff)

    adi32 = intra.substitute_refs(_adi_at(rec_y, y0, x0, 32, ff),
                                  st["av32"])
    if o.rd_refine:
        (lvl32, rec32, cbf32), m32, _ = _refine(
            orig32, adi32, dec["mode32k"][:, ff, by, bx],
            dec["mbits32k"][:, ff, by, bx], 32, qp, lamf, **tq)
    else:
        pred32 = intra.predict_single_mode(adi32, m32, 32, True,
                                           strong=True)
        lvl32, rec32, cbf32 = _tq_recon(orig32, pred32, 32, qp, lamf, **tq)

    # luma 16 children in z-order, each against its four 8x8 CUs
    # (search_8x8); each predicts from its predecessors' recon
    patch = _window(rec_y, y0, x0, 49, ff).clone()
    lvl_ch = torch.zeros((nb, 32, 32), **i32)
    cost_children = (lamf * _SPLIT_BITS).expand(nb)
    m16_all = [mode16[ff, 2 * by + a, 2 * bx + b] for a, b in _SUB_OFF]
    m16_sel = []
    cm8_all = [[dec["cmode8"][ff, 4 * by + 2 * a + c, 4 * bx + 2 * b + d]
                for c, d in _SUB_OFF] for a, b in _SUB_OFF] \
        if o.search_8x8 else None
    sp16_l, m8_l, cbf8_l, nxn_l, pu4_l, cbf4_l = [], [], [], [], [], []
    for k16, (qq_y, qq_x) in enumerate(_SUB_OFF):
        oy, ox = 16 * qq_y, 16 * qq_x
        m16 = m16_all[k16]
        adi16 = intra.substitute_refs(
            _patch_adi(patch, oy, ox, 16), st["av16"][k16])
        o16 = orig32[:, oy:oy + 16, ox:ox + 16]
        if o.rd_refine:
            a, b = 2 * by + qq_y, 2 * bx + qq_x
            (l16, r16, c16), m16, base = _refine(
                o16, adi16, dec["mode16k"][:, ff, a, b],
                dec["mbits16k"][:, ff, a, b], 16, qp, lamf, **tq)
            # the mode bits price the selection only: the CU's cost
            # carries the header bits, as the children's do (the
            # scalar product is rounded before the add, as XLA-CPU
            # hoists it out of the loop)
            cost16 = base + lamf * _CU_HDR_BITS
        else:
            pr16 = intra.predict_single_mode(adi16, m16, 16, True)
            l16, r16, c16 = _tq_recon(o16, pr16, 16, qp, lamf, **tq)
            cost16 = _ssd_cost(r16, o16, l16, 16, qp, lamf)
        m16_sel.append(m16)
        if not o.search_8x8:
            cost_children = cost_children + cost16
            patch[:, oy + 1:oy + 17, ox + 1:ox + 17] = r16
            lvl_ch[:, oy:oy + 16, ox:ox + 16] = l16
            sp16_l.append(torch.zeros_like(c16))
            m8_l.append(m16[None].expand(4, nb))
            cbf8_l.append(c16[None].expand(4, nb))
            # no 8x8 CU: no NxN, every 4x4 PU granule at the 16's mode
            nxn_l.append(torch.zeros((4, nb), dtype=torch.bool,
                                     device=c16.device))
            pu4_l.append(m16[None, None].expand(4, 4, nb))
            cbf4_l.append(c16[None, None].expand(4, 4, nb))
            continue
        patch8 = patch.clone()
        l8s = torch.zeros((nb, 16, 16), **i32)
        cost8 = (lamf * _SPLIT_BITS).expand(nb)
        sub = []
        for k8, (ry, rx) in enumerate(_SUB_OFF):
            o8y, o8x = oy + 8 * ry, ox + 8 * rx
            a, b = 2 * qq_y + ry, 2 * qq_x + rx
            m8 = dec["mode8"][ff, 4 * by + a, 4 * bx + b]
            m4s = torch.stack([dec["mode4"][ff, 8 * by + 2 * a + c,
                                            8 * bx + 2 * b + d]
                               for c, d in _SUB_OFF]) \
                if o.search_nxn else None
            adi8 = intra.substitute_refs(
                _patch_adi(patch8, o8y, o8x, 8), st["av8"][k16, k8])
            l8, r8, leaf, eff_m, nxn_o, pu4_o, cbf4_o = _luma8(
                patch8, orig32, o8y, o8x, adi8, m8, m16, cm8_all[k16][k8],
                m4s, st["av4"][k16, k8] if o.search_nxn else None, o)
            cost8 = cost8 + leaf
            patch8[:, o8y + 1:o8y + 9, o8x + 1:o8x + 9] = r8
            l8s[:, 8 * ry:8 * ry + 8, 8 * rx:8 * rx + 8] = l8
            sub.append((eff_m, (l8 != 0).any(-1).any(-1), nxn_o, pu4_o,
                        cbf4_o))
        sp16 = cost8 < cost16
        cost_children = cost_children + torch.minimum(cost8, cost16)
        spm = sp16[:, None, None]
        patch[:, oy + 1:oy + 17, ox + 1:ox + 17] = torch.where(
            spm, patch8[:, oy + 1:oy + 17, ox + 1:ox + 17], r16)
        lvl_ch[:, oy:oy + 16, ox:ox + 16] = torch.where(spm, l8s, l16)
        m8_y, cbf8_y, nxn_y, pu4_y, cbf4_y = (torch.stack(t)
                                               for t in zip(*sub))
        sp16_l.append(sp16)
        m8_l.append(torch.where(sp16[None], m8_y, m16[None]))
        cbf8_l.append(torch.where(sp16[None], cbf8_y, c16[None]))
        nxn_l.append(nxn_y & sp16[None])
        pu4_l.append(torch.where(sp16[None, None], pu4_y,
                                 m16[None, None]))
        cbf4_l.append(torch.where(sp16[None, None], cbf4_y,
                                  c16[None, None]))
    sp16_a = torch.stack(sp16_l)                        # [4, nb]
    m8_y2 = torch.stack(m8_l)                           # [4, 4, nb]

    cost32 = _ssd_cost(rec32, orig32, lvl32, 32, qp, lamf)
    sp32 = (cost_children < cost32) | st["force32"]
    sp = sp32[:, None, None]
    recon = torch.where(sp, patch[:, 1:33, 1:33], rec32)
    level = torch.where(sp, lvl_ch, lvl32)
    modes_q = torch.where(sp, m8_y2.permute(2, 0, 1), m32[:, None, None])
    cbf_q = torch.where(sp, torch.stack(cbf8_l).permute(2, 0, 1),
                        cbf32[:, None, None])
    sp16_q = sp16_a.T & sp32[:, None]                   # [nb, 4]
    depth_q = torch.where(sp32[:, None], torch.where(sp16_q, 3, 2), 1)

    # chroma (DM): 16 TB for CU32, 8 TB for CU16, 4x4 for CU8; an
    # NxN CU's chroma takes PU0's luma mode (m8_y2 carries it), and
    # DM picks follow the TU-split's parent-mode winners
    cm32 = dec["cmode32"][ff, by, bx]
    cm16_a = torch.stack([dec["cmode16"][ff, 2 * by + a, 2 * bx + b]
                          for a, b in _SUB_OFF])        # [4, nb]
    if o.rd_refine:
        # chroma DM follows the refined luma modes
        cm32 = torch.where(cm32 == mode32[ff, by, bx], m32, cm32)
        cm16_a = torch.where(cm16_a == torch.stack(m16_all),
                             torch.stack(m16_sel), cm16_a)
    if o.search_8x8:
        cm8_a = torch.stack([torch.stack(r) for r in cm8_all])
        if o.tu_split:
            m8_dec = torch.stack([torch.stack(
                [dec["mode8"][ff, 4 * by + 2 * a + c, 4 * bx + 2 * b + d]
                 for c, d in _SUB_OFF]) for a, b in _SUB_OFF])
            cm8_a = torch.where((cm8_a == m8_dec) & (m8_y2 != m8_dec),
                                m8_y2, cm8_a)
        cm8_eff = torch.where(torch.stack(nxn_l), m8_y2, cm8_a) \
            if o.search_nxn else cm8_a
        cm8_q = cm8_eff.permute(2, 0, 1)
    else:
        cm8_eff = None
        cm8_q = cm16_a.T[:, :, None].expand(nb, 4, 4)
    cmodes_q = torch.where(
        sp, torch.where(sp16_q[:, :, None], cm8_q,
                        cm16_a.T[:, :, None].expand(nb, 4, 4)),
        cm32[:, None, None])

    def both(t):            # the same per-slot values for Cb and Cr
        return None if t is None else torch.cat([t, t], -1)
    cy0, cx0 = both(y0 // 2), both(x0 // 2)
    (lc16, rc16, cc16), (lch, rch, cbch) = _chroma_slot(
        bufs["rec_c"], uv32, st["pf"], cy0, cx0, both(cm32), both(cm16_a),
        both(cm8_eff), both(sp16_a), st, o)
    sp2 = torch.cat([sp, sp])
    rc_c = torch.where(sp2, rch, rc16)
    lv_c = torch.where(sp2, lch, lc16)
    cbf_c = torch.where(sp2, cbch, cc16[:, None, None]).to(torch.int32)

    # scatter the slots' results
    _put(rec_y, recon, y0 + 1, x0 + 1, ff)
    _put(bufs["cf_y"], level, y0, x0, ff)
    _put(bufs["rec_c"], rc_c, cy0 + 1, cx0 + 1, st["pf"])
    _put(bufs["cf_c"], lv_c, cy0, cx0, st["pf"])
    qy, qx = o.qy, o.qx
    bufs["depth"][ff[:, None], 2 * by[:, None] + qy[None],
                  2 * bx[:, None] + qx[None]] = depth_q.to(torch.int32)
    r8y = 4 * by[:, None, None] + 2 * qy[None, :, None] + qy[None, None, :]
    r8x = 4 * bx[:, None, None] + 2 * qx[None, :, None] + qx[None, None, :]
    f3 = ff[:, None, None]
    bufs["modes8"][f3, r8y, r8x] = modes_q.to(torch.int32)
    bufs["cmodes8"][f3, r8y, r8x] = cmodes_q.to(torch.int32)
    cbf8 = bufs["cbf8"]
    cbf8[0][f3, r8y, r8x] = cbf_q.to(torch.int32)
    cbf8[1][f3, r8y, r8x] = cbf_c[:nb]
    cbf8[2][f3, r8y, r8x] = cbf_c[nb:]
    if o.search_nxn:
        bufs["nxn8"][f3, r8y, r8x] = (torch.stack(nxn_l).permute(2, 0, 1)
                                      & sp).to(torch.int32)
        r4y = 2 * r8y[..., None] + qy
        r4x = 2 * r8x[..., None] + qx
        bufs["pu4"][ff[:, None, None, None], r4y, r4x] = (
            torch.stack(pu4_l).permute(3, 0, 1, 2)
            + (torch.stack(cbf4_l).permute(3, 0, 1, 2)
               .to(torch.int32) << 8)).to(torch.int32)


def encode_i_chunk(ys, us, vs, qp: int, ctu: int = 64,
                   sign_hiding: bool = False, rd_lambda_scale: float = 1.0,
                   deblocking: bool = False, sao_enabled: bool = False,
                   search_8x8: bool = True, chroma_qp_offset: int = 0,
                   scaling_lists: bool = False, cu: int = None,
                   split_8x8: bool = None, dec_y=None, dec_u=None,
                   dec_v=None, search_nxn: bool = False, tiles=None,
                   rd_refine: bool = False, tu_split: bool = False,
                   vis_h: int = None, vis_w: int = None,
                   true_size: bool = False) -> dict:
    """Encode K independent intra frames at one QP.  ys [K, H, W], us/vs
    [K, H/2, W/2]: uint8/int32 CTU-padded planes on the device the chunk
    is computed on; tiles: a (cols, rows) grid or None.  Every
    wavefront step reconstructs the K frames' slots as one batch.
    split_8x8, where not None, stands for search_8x8; `cu` is accepted
    and not read.  dec_y [H, W], shared by the K frames, replaces the
    source as the dense pass's luma reference samples (dec_u and dec_v
    are accepted and not read); rd_lambda_scale scales the dense pass's
    luma sqrt(lambda).  Returns a dict of [K, ...] tensors (recon
    planes, coefficient planes, decision maps, `packed`)."""
    if split_8x8 is not None:
        search_8x8 = split_8x8
    nf, h, w = ys.shape
    dev = ys.device
    if true_size and vis_w is not None:
        cw8 = (vis_w + 15) // 16 * 16
        ch8 = (vis_h + 15) // 16 * 16
    else:
        cw8, ch8 = w, h
    plan = _device_plan(w, h, ctu, (cw8, ch8), tiles, nf, dev)
    qp = int(qp)
    qp_c = int(tables.CHROMA_QP_TABLE[min(max(qp + chroma_qp_offset, 0),
                                          57)])
    lamf = rdbits.rd_lambda_f32(torch.tensor(qp, device=dev), True)
    lamcf = rdbits.rd_lambda_f32(torch.tensor(qp_c, device=dev), True)
    y32 = ys.to(torch.int32)
    uv32 = torch.cat([us, vs]).to(torch.int32)       # Cb frames, then Cr
    o = types.SimpleNamespace(
        qp=qp, qp_c=qp_c, lamf=lamf, lamcf=lamcf, sign_hiding=sign_hiding,
        scaling=scaling_lists, search_8x8=search_8x8, search_nxn=search_nxn,
        tu_split=tu_split, rd_refine=rd_refine,
        adi_y=None if dec_y is None else dec_y.to(torch.int32),
        qy=torch.tensor([q[0] for q in _SUB_OFF], device=dev),
        qx=torch.tensor([q[1] for q in _SUB_OFF], device=dev))

    # ---- pass 1: dense decision, frame by frame
    sqrt_lam = torch.sqrt(lamf) * rd_lambda_scale
    sqrt_lam_c = torch.sqrt(lamcf)
    per = []
    for f in range(nf):
        with stage("i.dense"):
            per.append(_dense_decision(y32[f], uv32[f], uv32[nf + f], ctu,
                                       sqrt_lam, sqrt_lam_c, tiles, o))
    dec = {key: torch.stack([d[key] for d in per],
                            1 if key in _TOPK_KEYS else 0)
           for key in per[0]}

    # ---- pass 2: wavefront reconstruction over 32x32 slots
    bh, bw = h // 16, w // 16
    i32 = dict(dtype=torch.int32, device=dev)
    bufs = dict(
        rec_y=torch.zeros((nf, 1 + h + 32, 1 + w + 32), **i32),
        rec_c=torch.zeros((2 * nf, 1 + h // 2 + 16, 1 + w // 2 + 16),
                          **i32),
        cf_y=torch.zeros((nf, h, w), **i32),
        cf_c=torch.zeros((2 * nf, h // 2, w // 2), **i32),
        modes8=torch.ones((nf, 2 * bh, 2 * bw), **i32),
        cmodes8=torch.ones((nf, 2 * bh, 2 * bw), **i32),
        cbf8=torch.zeros((3, nf, 2 * bh, 2 * bw), **i32),
        depth=torch.full((nf, bh, bw), 2, **i32),
        nxn8=torch.zeros((nf, 2 * bh, 2 * bw), **i32),
        pu4=torch.zeros((nf, 4 * bh, 4 * bw), **i32))   # mode | cbf << 8
    for st in plan:
        with stage("i.step"):
            _wavefront_step(st, dec, y32, uv32, bufs, o)
        count("i.steps")

    # ---- pass 3, frame by frame: deblocking, SAO, the packed record
    outs = []
    for f in range(nf):
        out_y = bufs["rec_y"][f, 1:1 + h, 1:1 + w]
        out_u = bufs["rec_c"][f, 1:1 + h // 2, 1:1 + w // 2]
        out_v = bufs["rec_c"][nf + f, 1:1 + h // 2, 1:1 + w // 2]
        depth_map = bufs["depth"][f]
        dist16 = (out_y - y32[f]).abs().sum() // (bh * bw)
        if deblocking:
            with stage("i.deblock"):
                bs_v, bs_h = _intra_bs_from_tree(depth_map, h, w)
                if cw8 < w or ch8 < h:
                    bs_v[:, cw8 // 8:] = 0
                    bs_h[ch8 // 8:, :] = 0
                out_y = deblock.deblock_luma(out_y, bs_v, bs_h, qp)
                bs_vc, bs_hc = _intra_bs_chroma_from_tree(depth_map, h // 2,
                                                          w // 2)
                if cw8 < w or ch8 < h:
                    bs_vc[:, cw8 // 16:] = 0
                    bs_hc[ch8 // 16:, :] = 0
                out_u = deblock.deblock_chroma(out_u, bs_vc, bs_hc, qp_c)
                out_v = deblock.deblock_chroma(out_v, bs_vc, bs_hc, qp_c)
        sao_fields = None
        if sao_enabled:
            with stage("i.sao"):
                out_y, out_u, out_v, sao_fields = sao.sao_frame(
                    y32[f], uv32[f], uv32[nf + f], out_y, out_u, out_v,
                    lamf, lamcf, ctu, tiles=tiles,
                    coded=(ch8, cw8) if (cw8 < w or ch8 < h) else None)
        modes8_map, cmodes8_map = bufs["modes8"][f], bufs["cmodes8"][f]
        cbf8_map = bufs["cbf8"][:, f]
        with stage("i.pack"):
            out = dict(recon_y=out_y, recon_u=out_u, recon_v=out_v,
                       coeff_y=bufs["cf_y"][f].to(torch.int16),
                       coeff_cb=bufs["cf_c"][f].to(torch.int16),
                       coeff_cr=bufs["cf_c"][nf + f].to(torch.int16),
                       modes=modes8_map, cmodes=cmodes8_map, cbf=cbf8_map,
                       depth=depth_map)
            parts = [out["coeff_y"].reshape(-1),
                     out["coeff_cb"].reshape(-1),
                     out["coeff_cr"].reshape(-1),
                     modes8_map.to(torch.int16).reshape(-1),
                     cmodes8_map.to(torch.int16).reshape(-1),
                     cbf8_map.to(torch.int16).reshape(-1),
                     depth_map.to(torch.int16).reshape(-1),
                     dist16.clamp(0, 32767).to(torch.int16)[None]]
            if search_nxn:
                out["nxn"] = bufs["nxn8"][f]
                out["pu4"] = bufs["pu4"][f]
                parts += [out["nxn"].to(torch.int16).reshape(-1),
                          out["pu4"].to(torch.int16).reshape(-1)]
            if sao_fields is not None:
                parts.append(sao.pack_sao_fields(sao_fields))
            out["packed"] = torch.cat(parts)
        outs.append(out)
    return {key: torch.stack([t[key] for t in outs]) for key in outs[0]}


def encode_i_chunk_sharded(ys, us, vs, qp: int, *, group, **flags) -> dict:
    """encode_i_chunk with the chunk's frame axis split over the ranks of
    `group` (a process group of n ranks, every one passing the whole
    chunk; K a multiple of n): rank r codes frames [r K/n, (r+1) K/n),
    and the records are gathered in frame order, so every rank returns
    the whole chunk's dict, bit-identical to one device (all-intra
    frames are independent)."""
    m = ys.shape[0] // torch.distributed.get_world_size(group)
    assert m * torch.distributed.get_world_size(group) == ys.shape[0]
    r = torch.distributed.get_rank(group)
    part = slice(r * m, (r + 1) * m)
    out = encode_i_chunk(ys[part], us[part], vs[part], qp, **flags)
    return dict(zip(out, parallel.gather_rows(group, *out.values())))


def encode_frame(y, u, v, qp: int, ctu: int = 64,
                 sign_hiding: bool = False, rd_lambda_scale: float = 1.0,
                 deblocking: bool = False, sao_enabled: bool = False,
                 search_8x8: bool = True, chroma_qp_offset: int = 0,
                 scaling_lists: bool = False, cu: int = None,
                 split_8x8: bool = None, dec_y=None, dec_u=None, dec_v=None,
                 search_nxn: bool = False, tiles=None,
                 rd_refine: bool = False, tu_split: bool = False,
                 vis_h: int = None, vis_w: int = None,
                 true_size: bool = False) -> dict:
    """Encode one intra frame: encode_i_chunk of one frame (planes
    [H, W], chroma [H/2, W/2]; the same flags).  Returns a dict of
    tensors (recon planes, coefficient planes, decision maps,
    `packed`)."""
    flags = dict(locals())
    for key in ("y", "u", "v", "qp"):
        del flags[key]
    out = encode_i_chunk(y[None], u[None], v[None], qp, **flags)
    return {key: t[0] for key, t in out.items()}


def _patch_adi(patch: torch.Tensor, oy: int, ox: int,
               size: int) -> torch.Tensor:
    """adi [nb, 4*size+1] of the sub-block at patch-relative origin
    (1+oy, 1+ox); patch row/col 0 hold the slot's neighbours."""
    top = patch[:, oy, ox:ox + 2 * size + 1]
    left = patch[:, oy + 1:oy + 1 + 2 * size, ox]
    return torch.cat([torch.flip(left, (-1,)), top], -1)


def _put(planes: torch.Tensor, blks: torch.Tensor, yy: torch.Tensor,
         xx: torch.Tensor, ff: torch.Tensor):
    """Scatter [n, s, s] blocks into planes [F, H, W] at per-block
    origins, block i into plane ff[i]."""
    s = blks.shape[-1]
    k = torch.arange(s, device=planes.device)
    planes[ff[:, None, None], (yy[:, None] + k)[:, :, None],
           (xx[:, None] + k)[:, None, :]] = blks.to(planes.dtype)


def _intra_bs_from_tree(depth_map, h: int, w: int):
    """Luma BS maps from the CU-depth granule map (1=32, 2=16, 3=8x8):
    vertical-edge map [h/4, w/8], horizontal [h/8, w/4]."""
    bh, bw = depth_map.shape
    dev = depth_map.device
    e16 = depth_map >= 2
    e8 = depth_map >= 3
    x = torch.arange(w // 8, device=dev) * 8
    g16 = (x // 16 - (x % 16 == 0).long()).clamp(0, bw - 1)
    on_32 = (x % 32) == 0
    on_16 = (x % 32) == 16
    on_8 = (x % 16) == 8
    rows16 = torch.repeat_interleave(e16, 4, 0)
    rows8 = torch.repeat_interleave(e8, 4, 0)
    col_on = (on_32[None, :] | (on_16[None, :] & rows16[:, g16])
              | (on_8[None, :] & rows8[:, g16]))
    bs_v = col_on.to(torch.int32) * 2
    bs_v[:, 0] = 0
    yy = torch.arange(h // 8, device=dev) * 8
    gy16 = (yy // 16 - (yy % 16 == 0).long()).clamp(0, bh - 1)
    on_32h = (yy % 32) == 0
    on_16h = (yy % 32) == 16
    on_8h = (yy % 16) == 8
    cols16 = torch.repeat_interleave(e16, 4, 1)
    cols8 = torch.repeat_interleave(e8, 4, 1)
    row_on = (on_32h[:, None] | (on_16h[:, None] & cols16[gy16, :])
              | (on_8h[:, None] & cols8[gy16, :]))
    bs_h = row_on.to(torch.int32) * 2
    bs_h[0, :] = 0
    return bs_v, bs_h


def _intra_bs_chroma_from_tree(depth_map, hc: int, wc: int):
    """Chroma BS (edges on the 8-chroma-px grid = 16-luma grid)."""
    bh, bw = depth_map.shape
    dev = depth_map.device
    e16 = depth_map >= 2
    x = torch.arange(wc // 8, device=dev) * 16
    g16 = (x // 16 - 1).clamp(0, bw - 1)
    col_on = ((x % 32) == 0)[None, :] | (
        ((x % 32) == 16)[None, :] & torch.repeat_interleave(e16, 4, 0)[:, g16])
    bs_v = col_on.to(torch.int32) * 2
    bs_v[:, 0] = 0
    yy = torch.arange(hc // 8, device=dev) * 16
    gy16 = (yy // 16 - 1).clamp(0, bh - 1)
    row_on = ((yy % 32) == 0)[:, None] | (
        ((yy % 32) == 16)[:, None]
        & torch.repeat_interleave(e16, 4, 1)[gy16, :])
    bs_h = row_on.to(torch.int32) * 2
    bs_h[0, :] = 0
    return bs_v, bs_h
