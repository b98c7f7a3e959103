"""Batched intra-frame encoder: dense mode decision + wavefront recon.

Port of homerhevc_tpu/models/intra_frame.py (`encode_frame`) at the
rd=ULTRAFAST knobs: no 8x8 split, NxN, TU-split or full-RD refinement
(search_8x8 = search_nxn = tu_split = rd_refine = False), no tiles.

1. Dense decision: luma modes at 32 and 16 and the 5-candidate chroma
   modes, from source-pixel reference samples, for every block at once.
2. Wavefront reconstruction over 32x32 slots (models/schedule.py plans):
   each step reconstructs all slots of one anti-diagonal as one batch —
   a 32x32 CU against its four 16x16 children with SSD + lambda*bits RD,
   chroma (DM) 16x16 or four 8x8 TBs.
3. Deblocking, SAO and the packed device->host record.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from homerhevc_torch import tables
from homerhevc_torch.models import schedule
from homerhevc_torch.ops import (deblock, f32, intra, quant, rdbits, sao,
                                 transform)
from homerhevc_torch.ops.me import blocks as _blocks

_CU_HDR_BITS = 6.0
_SPLIT_BITS = 1.5
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
def _avail_np(w: int, h: int, s: int, ctu: int) -> np.ndarray:
    """[h//s, w//s, 5] neighbour-segment availability (z-scan order)."""
    av = schedule.availability(w // s, h // s, ctu // s)
    return np.stack([av["bottomleft"], av["left"], av["corner"],
                     av["top"], av["topright"]], axis=-1)


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


def _adi_at(buf: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor,
            s: int) -> torch.Tensor:
    """adi [n, 4S+1] from a zero-bordered buffer whose (yy, xx) is the
    corner sample p(-1, -1) of each block."""
    k = torch.arange(2 * s + 1, device=buf.device)
    top = buf[yy[:, None], xx[:, None] + k[None]]
    left = buf[yy[:, None] + 1 + k[None, :2 * s], xx[:, None]]
    return torch.cat([torch.flip(left, (-1,)), top], -1)


def _window(plane: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor,
            size: int) -> torch.Tensor:
    """[n, size, size] windows of plane [..., H, W] at (yy, xx) [n]."""
    k = torch.arange(size, device=plane.device)
    return plane[..., (yy[:, None] + k)[:, :, None],
                 (xx[:, None] + k)[:, None, :]]


def _avail_mask(seg_av: np.ndarray, s: int) -> np.ndarray:
    return (seg_av.astype(np.int32)
            @ _segment_avail_layout(s).astype(np.int32)) > 0


def _dense_best(y32: torch.Tensor, s: int, ctu: int, sqrt_lam):
    """Best intra mode per s x s block (SATD + MPM-aware mode bits,
    source-pixel references).  Returns [bh, bw] int64."""
    h, w = y32.shape
    bh, bw = h // s, w // s
    nb = bh * bw
    dev = y32.device
    buf = torch.zeros((1 + h + s, 1 + w + s), dtype=torch.int32,
                      device=dev)
    buf[1:1 + h, 1:1 + w] = y32
    py = torch.arange(bh, device=dev).repeat_interleave(bw) * s
    px = (torch.arange(bw, device=dev) * s).repeat(bh)
    seg = _avail_np(w, h, s, ctu).reshape(nb, 5)
    amask = torch.as_tensor(_avail_mask(seg, s), device=dev)
    adi = intra.substitute_refs(_adi_at(buf, py, px, s), amask)
    preds = intra.predict_all_modes(adi, s, True, strong=True)
    all_s = satd(preds - _blocks(y32, s)[:, None], s)     # [nb, 35]
    best0 = torch.argmin(all_s, -1).reshape(bh, bw)
    ones_c = torch.ones((bh, 1), dtype=best0.dtype, device=dev)
    left_m = torch.cat([ones_c, best0[:, :-1]], 1)
    top_m = torch.cat([torch.ones((1, bw), dtype=best0.dtype, device=dev),
                       best0[:-1]], 0)
    segt = torch.as_tensor(seg, device=dev)
    left_m = torch.where(segt[:, 1].reshape(bh, bw), left_m, 1)
    top_m = torch.where(segt[:, 3].reshape(bh, bw), top_m, 1)
    cands = _mpm_candidates(left_m.reshape(-1), top_m.reshape(-1))
    all_m = torch.arange(35, device=dev)
    in_mpm = (all_m[None, :, None] == cands[:, None, :]).any(-1)
    cost = f32.fma(sqrt_lam, rdbits.intra_mode_bits(in_mpm), all_s)
    return torch.argmin(cost, -1).reshape(bh, bw)


def _dense_best_chroma(u32, v32, lm_grid, s_l: int, ctu: int, sqrt_lam_c):
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
    seg = _avail_np(wc, hc, s, ctu // 2).reshape(nb, 5)
    amask = torch.as_tensor(_avail_mask(seg, s), device=dev)

    def adi_of(plane):
        buf = torch.zeros((1 + hc + s, 1 + wc + s), dtype=torch.int32,
                          device=dev)
        buf[1:1 + hc, 1:1 + wc] = plane
        return intra.substitute_refs(_adi_at(buf, py, px, s), amask)

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
def build_plan(width: int, height: int, ctu: int = 64, coded=None):
    """Static wavefront plan over 32x32 slots: per step, the valid slots
    and their per-pixel availability masks (numpy)."""
    s = 32
    bw, bh = width // s, height // s
    steps, n_steps, batches = schedule.wavefront_schedule(bw, bh, ctu // s)
    cw, ch = coded if coded is not None else (width, height)
    av16_g = _avail_np(width, height, 16, ctu)
    av32_g = _avail_np(width, height, 32, ctu)
    plan = []
    for st in range(n_steps):
        by = batches[st, :, 0]
        bx = batches[st, :, 1]
        keep = by >= 0
        by, bx = by[keep], bx[keep]
        px32, py32 = 32 * bx, 32 * by
        a32 = av32_g[by, bx]
        av16 = np.zeros((4, len(by), 65), bool)
        av16c = np.zeros((4, len(by), 33), bool)
        for k16, (qy, qx) in enumerate(_SUB_OFF):
            p16x, p16y = px32 + 16 * qx, py32 + 16 * qy
            a = av16_g[2 * by + qy, 2 * bx + qx]
            av16[k16] = _pix_masks_np(a, p16x, p16y, 16, cw, ch)
            av16c[k16] = _pix_masks_np(a, p16x, p16y, 8, cw, ch,
                                       chroma=True)
        plan.append(dict(
            by=by.astype(np.int64), bx=bx.astype(np.int64),
            av32=_pix_masks_np(a32, px32, py32, 32, cw, ch),
            av32c=_pix_masks_np(a32, px32, py32, 16, cw, ch, chroma=True),
            av16=av16, av16c=av16c,
            force32=(px32 + 32 > cw) | (py32 + 32 > ch)))
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


def _tq_recon(orig, pred, size, qp, lam, sign_hiding=False):
    """residual -> T -> Q(-SBH, diagonal scan) -> IQ -> IT -> recon +
    zero-RD.  Returns (level, recon, cbf)."""
    resid = orig - pred
    coeff = transform.forward_transform(resid, size)
    level, du = quant.quantize(coeff, qp, size, is_intra=True)
    if sign_hiding:
        level = quant.sign_bit_hide(
            level, du, tables.scan_order(size, tables.SCAN_DIAG), size)
    deq = quant.dequantize(level, qp, size, is_intra=True)
    r = transform.inverse_transform(deq, size)
    recon = (pred + r).clamp(0, 255)
    level, recon = _rd_zero_intra(level, recon, pred, orig, lam, qp)
    cbf = (level != 0).any(-1).any(-1)
    return level.to(torch.int32), recon.to(torch.int32), cbf


def _ssd_cost(rec, orig, lvl, size, qp, lamf):
    ssd = ((rec - orig) ** 2).sum((-1, -2)).to(torch.float32)
    return f32.fma(lamf, rdbits.residual_bits(lvl, size, qp=qp)
                   + _CU_HDR_BITS, ssd)


def encode_frame(y, u, v, qp: int, ctu: int = 64, sign_hiding: bool = False,
                 deblocking: bool = False, sao_enabled: bool = False,
                 search_8x8: bool = False, chroma_qp_offset: int = 0,
                 scaling_lists: bool = False, search_nxn: bool = False,
                 tiles=None, rd_refine: bool = False, tu_split: bool = False,
                 vis_h: int = None, vis_w: int = None,
                 true_size: bool = False) -> dict:
    """Encode one intra frame; planes uint8/int32 tensors, CTU-padded,
    on the device the frame is computed on.  Returns a dict of tensors
    (recon planes, coefficient planes, decision maps, `packed`)."""
    if search_8x8 or search_nxn or tu_split or rd_refine:
        raise NotImplementedError(
            "intra 8x8/NxN/TU-split/RD refinement (rd=FAST/FULL)")
    if tiles is not None or scaling_lists:
        raise NotImplementedError("tiles / scaling lists")
    h, w = y.shape
    dev = y.device
    if true_size and vis_w is not None:
        cw8 = (vis_w + 15) // 16 * 16
        ch8 = (vis_h + 15) // 16 * 16
    else:
        cw8, ch8 = w, h
    plan = build_plan(w, h, ctu, coded=(cw8, ch8))
    qp = int(qp)
    qp_c = int(tables.CHROMA_QP_TABLE[min(max(qp + chroma_qp_offset, 0),
                                          57)])
    lamf = rdbits.rd_lambda_f32(torch.tensor(qp, device=dev), True)
    lamcf = rdbits.rd_lambda_f32(torch.tensor(qp_c, device=dev), True)
    y32 = y.to(torch.int32)
    u32 = u.to(torch.int32)
    v32 = v.to(torch.int32)

    # ---- pass 1: dense decision
    sqrt_lam = torch.sqrt(lamf)
    mode32 = _dense_best(y32, 32, ctu, sqrt_lam)
    mode16 = _dense_best(y32, 16, ctu, sqrt_lam)
    sqrt_lam_c = torch.sqrt(lamcf)
    cmode32 = _dense_best_chroma(u32, v32, mode32, 32, ctu, sqrt_lam_c)
    cmode16 = _dense_best_chroma(u32, v32, mode16, 16, ctu, sqrt_lam_c)

    bh, bw = h // 16, w // 16
    i32 = dict(dtype=torch.int32, device=dev)
    rec_y = torch.zeros((1 + h + 32, 1 + w + 32), **i32)
    rec_c = torch.zeros((2, 1 + h // 2 + 16, 1 + w // 2 + 16), **i32)
    cf_y = torch.zeros((h, w), **i32)
    cf_c = torch.zeros((2, h // 2, w // 2), **i32)
    modes8_map = torch.ones((2 * bh, 2 * bw), **i32)
    cmodes8_map = torch.ones((2 * bh, 2 * bw), **i32)
    cbf8_map = torch.zeros((3, 2 * bh, 2 * bw), **i32)
    depth_map = torch.full((bh, bw), 2, **i32)
    uv32 = torch.stack([u32, v32])
    qy = torch.tensor([o[0] for o in _SUB_OFF], device=dev)
    qx = torch.tensor([o[1] for o in _SUB_OFF], device=dev)

    # ---- pass 2: wavefront reconstruction over 32x32 slots
    for st in plan:
        by = torch.as_tensor(st["by"], device=dev)
        bx = torch.as_tensor(st["bx"], device=dev)
        nb = by.shape[0]
        y0, x0 = by * 32, bx * 32
        m32 = mode32[by, bx]
        orig32 = _window(y32, y0, x0, 32)

        adi32 = intra.substitute_refs(
            _adi_at(rec_y, y0, x0, 32),
            torch.as_tensor(st["av32"], device=dev))
        pred32 = intra.predict_single_mode(adi32, m32, 32, True,
                                           strong=True)
        lvl32, rec32, cbf32 = _tq_recon(orig32, pred32, 32, qp, lamf,
                                        sign_hiding)

        # luma 16 children (z-order; each predicts from its
        # predecessors' reconstruction)
        patch = _window(rec_y, y0, x0, 49).clone()
        lvl_ch = torch.zeros((nb, 32, 32), **i32)
        cost_children = (lamf * _SPLIT_BITS).expand(nb)
        m16_all, c16_all = [], []
        av16 = torch.as_tensor(st["av16"], device=dev)
        for k16, (qq_y, qq_x) in enumerate(_SUB_OFF):
            oy, ox = 16 * qq_y, 16 * qq_x
            m16 = mode16[2 * by + qq_y, 2 * bx + qq_x]
            adi16 = intra.substitute_refs(
                _patch_adi(patch, oy, ox, 16), av16[k16])
            o16 = orig32[:, oy:oy + 16, ox:ox + 16]
            pr16 = intra.predict_single_mode(adi16, m16, 16, True)
            l16, r16, c16 = _tq_recon(o16, pr16, 16, qp, lamf,
                                      sign_hiding)
            cost_children = cost_children + _ssd_cost(r16, o16, l16, 16,
                                                      qp, lamf)
            patch[:, oy + 1:oy + 17, ox + 1:ox + 17] = r16
            lvl_ch[:, oy:oy + 16, ox:ox + 16] = l16
            m16_all.append(m16)
            c16_all.append(c16)
        m16_q = torch.stack(m16_all, 1)                   # [nb, 4]
        c16_q = torch.stack(c16_all, 1)

        cost32 = _ssd_cost(rec32, orig32, lvl32, 32, qp, lamf)
        sp32 = (cost_children < cost32) | torch.as_tensor(st["force32"],
                                                          device=dev)
        sp = sp32[:, None, None]
        recon = torch.where(sp, patch[:, 1:33, 1:33], rec32)
        level = torch.where(sp, lvl_ch, lvl32)
        modes_q = torch.where(sp, m16_q[:, :, None].expand(nb, 4, 4),
                              m32[:, None, None])
        cbf_q = torch.where(sp, c16_q[:, :, None].expand(nb, 4, 4),
                            cbf32[:, None, None])
        depth_q = torch.where(sp32[:, None], 2, 1).expand(nb, 4)

        # chroma (DM): 16 TB for a CU32, four 8 TBs for CU16s
        cm32 = cmode32[by, bx]
        cm16_q = torch.stack([cmode16[2 * by + a, 2 * bx + b]
                              for a, b in _SUB_OFF], 1)   # [nb, 4]
        cmodes_q = torch.where(sp, cm16_q[:, :, None].expand(nb, 4, 4),
                               cm32[:, None, None])
        cy0, cx0 = y0 // 2, x0 // 2
        av32c = torch.as_tensor(st["av32c"], device=dev)
        av16c = torch.as_tensor(st["av16c"], device=dev)
        lv_c, rc_c, cbf_c = [], [], []
        for p in range(2):
            orig_c = _window(uv32[p], cy0, cx0, 16)
            adi_c = intra.substitute_refs(
                _adi_at(rec_c[p], cy0, cx0, 16), av32c)
            pr_c16 = intra.predict_single_mode(adi_c, cm32, 16, False)
            lc16, rc16, cc16 = _tq_recon(orig_c, pr_c16, 16, qp_c, lamcf,
                                         sign_hiding)
            cpatch = _window(rec_c[p], cy0, cx0, 25).clone()
            lv_ch = torch.zeros((nb, 16, 16), **i32)
            c8s = []
            for k16, (qq_y, qq_x) in enumerate(_SUB_OFF):
                oy, ox = 8 * qq_y, 8 * qq_x
                adi8 = intra.substitute_refs(
                    _patch_adi(cpatch, oy, ox, 8), av16c[k16])
                pr8 = intra.predict_single_mode(adi8, cm16_q[:, k16], 8,
                                                False)
                o8 = orig_c[:, oy:oy + 8, ox:ox + 8]
                l8, r8, c8 = _tq_recon(o8, pr8, 8, qp_c, lamcf,
                                       sign_hiding)
                cpatch[:, oy + 1:oy + 9, ox + 1:ox + 9] = r8
                lv_ch[:, oy:oy + 8, ox:ox + 8] = l8
                c8s.append(c8)
            rc_c.append(torch.where(sp, cpatch[:, 1:17, 1:17], rc16))
            lv_c.append(torch.where(sp, lv_ch, lc16))
            cbf_c.append(torch.where(
                sp, torch.stack(c8s, 1)[:, :, None].expand(nb, 4, 4),
                cc16[:, None, None]))

        # scatter the slots' results
        _put(rec_y, recon, y0 + 1, x0 + 1)
        _put(cf_y, level, y0, x0)
        for p in range(2):
            _put(rec_c[p], rc_c[p], cy0 + 1, cx0 + 1)
            _put(cf_c[p], lv_c[p], cy0, cx0)
        depth_map[2 * by[:, None] + qy[None],
                  2 * bx[:, None] + qx[None]] = depth_q.to(torch.int32)
        r8y = 4 * by[:, None, None] + 2 * qy[None, :, None] \
            + qy[None, None, :]
        r8x = 4 * bx[:, None, None] + 2 * qx[None, :, None] \
            + qx[None, None, :]
        modes8_map[r8y, r8x] = modes_q.to(torch.int32)
        cmodes8_map[r8y, r8x] = cmodes_q.to(torch.int32)
        cbf8_map[0, r8y, r8x] = cbf_q.to(torch.int32)
        cbf8_map[1, r8y, r8x] = cbf_c[0].to(torch.int32)
        cbf8_map[2, r8y, r8x] = cbf_c[1].to(torch.int32)

    out_y = rec_y[1:1 + h, 1:1 + w]
    out_u = rec_c[0, 1:1 + h // 2, 1:1 + w // 2]
    out_v = rec_c[1, 1:1 + h // 2, 1:1 + w // 2]
    dist16 = (out_y - y32).abs().sum() // (bh * bw)

    if deblocking:
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
        out_y, out_u, out_v, sao_fields = sao.sao_frame(
            y32, u32, v32, out_y, out_u, out_v, lamf, lamcf, ctu,
            coded=(ch8, cw8) if (cw8 < w or ch8 < h) else None)

    out = dict(recon_y=out_y.contiguous(), recon_u=out_u.contiguous(),
               recon_v=out_v.contiguous(),
               coeff_y=cf_y.to(torch.int16), coeff_cb=cf_c[0].to(torch.int16),
               coeff_cr=cf_c[1].to(torch.int16), modes=modes8_map,
               cmodes=cmodes8_map, cbf=cbf8_map, depth=depth_map)
    parts = [out["coeff_y"].reshape(-1), out["coeff_cb"].reshape(-1),
             out["coeff_cr"].reshape(-1),
             modes8_map.to(torch.int16).reshape(-1),
             cmodes8_map.to(torch.int16).reshape(-1),
             cbf8_map.to(torch.int16).reshape(-1),
             depth_map.to(torch.int16).reshape(-1),
             dist16.clamp(0, 32767).to(torch.int16)[None]]
    if sao_fields is not None:
        parts.append(sao.pack_sao_fields(sao_fields))
    out["packed"] = torch.cat(parts)
    return out


def _patch_adi(patch: torch.Tensor, oy: int, ox: int,
               size: int) -> torch.Tensor:
    """adi [nb, 4*size+1] of the sub-block at patch-relative origin
    (1+oy, 1+ox); patch row/col 0 hold the slot's neighbours."""
    top = patch[:, oy, ox:ox + 2 * size + 1]
    left = patch[:, oy + 1:oy + 1 + 2 * size, ox]
    return torch.cat([torch.flip(left, (-1,)), top], -1)


def _put(plane: torch.Tensor, blks: torch.Tensor, yy: torch.Tensor,
         xx: torch.Tensor):
    """Scatter [n, s, s] blocks into plane at per-block origins."""
    s = blks.shape[-1]
    k = torch.arange(s, device=plane.device)
    plane[(yy[:, None] + k)[:, :, None], (xx[:, None] + k)[:, None, :]] = \
        blks.to(plane.dtype)


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
