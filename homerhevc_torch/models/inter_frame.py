"""Batched P-frame (inter) encoder.

Port of homerhevc_tpu/models/inter_frame.py (`encode_p_frame`,
`encode_p_chunk`, `encode_p_chunk_packed`) at the rd=ULTRAFAST knobs of
the reference's speed ladder: one merge/skip round, no intra fallback, no
8x8 inter split, quadtree consolidation of MV-uniform groups only; one
reference, fixed per-frame QP, single device.

Stage order: motion estimation -> merge/skip RD over {left, top, global,
zero, own} candidates -> 16/32/64 quadtree consolidation with TU-size RD
-> chroma coding with chroma MC -> luma deblocking with the effective-QP
chain -> SAO -> packed device->host record.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from homerhevc_torch import tables
from homerhevc_torch.ops import (deblock, f32, interp, me, packing, quant,
                                 rdbits, sao, transform)
from homerhevc_torch.ops.me import blocks as _blocks

_PAD_DIST_W = 0.0625


def _unblocks(blk: torch.Tensor, h: int, w: int) -> torch.Tensor:
    b = blk.shape[-1]
    return blk.reshape(h // b, w // b, b, b).permute(0, 2, 1, 3) \
        .reshape(h, w)


def _tq(resid, size, qp, is_intra, sbh_scan):
    coeff = transform.forward_transform(resid, size)
    level, du = quant.quantize(coeff, qp, size, is_intra=is_intra)
    if sbh_scan is not None:
        level = quant.sign_bit_hide(level, du, sbh_scan, size)
    deq = quant.dequantize(level, qp, size, is_intra=is_intra)
    return level.to(torch.int32), transform.inverse_transform(deq, size)


def _ssd(a, b) -> torch.Tensor:
    return ((a - b) ** 2).sum((-1, -2)).to(torch.float32)


def _rd_zero(level, recon, pred, cur, lam, inv=None, qp=None):
    """Zero-residual RD decision: drop a block's coefficients when the
    rate saved outweighs the distortion added."""
    ssd_coded = _ssd(recon, cur)
    ssd_zero = _ssd(pred, cur)
    if inv is not None:
        ssd_coded = torch.where(inv, ssd_coded * _PAD_DIST_W, ssd_coded)
        ssd_zero = torch.where(inv, ssd_zero * _PAD_DIST_W, ssd_zero)
    bits = rdbits.residual_bits(level, level.shape[-1], qp=qp) + 2.0
    zero = ssd_zero <= f32.fma(lam, bits, ssd_coded)
    level = torch.where(zero[:, None, None], 0, level)
    recon = torch.where(zero[:, None, None], pred, recon)
    return level, recon


def _mc_plane_luma(ref_pad, mv, y0: int, out_h: int, out_w: int):
    """Whole-plane luma MC at one quarter-pel MV (a dynamic slice of the
    pad, start clamped, + separable 8-tap filtering)."""
    dev = ref_pad.device
    sy = (me.REF_PAD + y0 + (mv[0] >> 2) - 3).clamp(
        0, ref_pad.shape[0] - (out_h + 7))
    sx = (me.REF_PAD + (mv[1] >> 2) - 3).clamp(
        0, ref_pad.shape[1] - (out_w + 7))
    win = ref_pad.index_select(0, sy + torch.arange(out_h + 7, device=dev)) \
        .index_select(1, sx + torch.arange(out_w + 7, device=dev))
    return interp.mc_plane_luma(win, mv[0] & 3, mv[1] & 3, out_h, out_w)


def merge_candidate_fields(mv_grid, med=None):
    """[(field [bh, bw, 2], is_merge)]: left / top neighbours, global
    median, zero."""
    left = torch.cat([mv_grid[:, :1], mv_grid[:, :-1]], 1)
    top = torch.cat([mv_grid[:1], mv_grid[:-1]], 0)
    if med is None:
        med = me.field_median(mv_grid)
    glob = med.expand(mv_grid.shape)
    zero = torch.zeros_like(mv_grid)
    return [(left, True), (top, True), (glob, True), (zero, False)]


def _cand_rd(cur_c, preds, qp, lam, s, sbh_scan, bits_mv, nc, n, inv=None):
    """TQ + zero-residual fold + cost of nc candidate predictions.
    Returns (level, recon [nc*n, S, S], cost [nc, n])."""
    level, rr = _tq(cur_c - preds, s, qp, False, sbh_scan)
    recon = (preds + rr).clamp(0, 255)
    ssd_coded = _ssd(recon, cur_c).reshape(nc, n)
    ssd_zero = _ssd(preds, cur_c).reshape(nc, n)
    if inv is not None:
        ssd_coded = torch.where(inv[None], ssd_coded * _PAD_DIST_W,
                                ssd_coded)
        ssd_zero = torch.where(inv[None], ssd_zero * _PAD_DIST_W, ssd_zero)
    bits_resid = (rdbits.residual_bits(level, s, qp=qp) + 2.0).reshape(nc, n)
    cost_coded = f32.fma(lam, bits_mv + bits_resid, ssd_coded)
    cost_zero = f32.fma(lam, bits_mv + 1.0, ssd_zero)
    use_zero = cost_zero <= cost_coded
    cost = torch.where(use_zero, cost_zero, cost_coded)
    uz = use_zero.reshape(-1)[:, None, None]
    level = torch.where(uz, 0, level)
    recon = torch.where(uz, preds, recon)
    return level, recon, cost


def _merge_skip_rd(cur_b, ref_pad, pos_y, pos_x, mv_own, pred_own, qp,
                   lam, s, sbh_scan, cand_fields, inv=None):
    """Merge/skip RD arbitration (one round): every candidate MV (left,
    top, own, global, zero) gets an exact prediction, a full
    T/Q/IQ/IT reconstruction and a forced-zero-residual variant; the
    per-block winner's (mv, level, recon, pred, cost) are returned."""
    n = cur_b.shape[0]
    bh, bw = mv_own.shape[:2]
    h, w = bh * s, bw * s
    dev = cur_b.device
    left_f = cand_fields[0][0].reshape(-1, 2)
    lt_mv = torch.cat([left_f, cand_fields[1][0].reshape(-1, 2)], 0)
    lt_pred = me.mc_luma_at(ref_pad, pos_y.repeat(2), pos_x.repeat(2),
                            lt_mv, s)
    bits_lt = torch.full((2, n), 3.0, device=dev)
    lvl_lt, rec_lt, cost_lt = _cand_rd(cur_b.repeat(2, 1, 1), lt_pred, qp,
                                       lam, s, sbh_scan, bits_lt, 2, n,
                                       inv=inv)
    med = cand_fields[2][0][0, 0]
    glob_pred = _blocks(_mc_plane_luma(ref_pad, med, 0, h, w), s)
    zero_pred = _blocks(ref_pad[me.REF_PAD:me.REF_PAD + h,
                                me.REF_PAD:me.REF_PAD + w], s)
    own = mv_own.reshape(-1, 2)
    ogz_mv = torch.cat([own, cand_fields[2][0].reshape(-1, 2),
                        torch.zeros_like(own)], 0)
    ogz_pred = torch.cat([pred_own, glob_pred, zero_pred], 0)
    bits_ogz = torch.stack([rdbits.mvd_bits(own - left_f) + 5.0 + 0.0,
                            torch.full((n,), 3.0, device=dev),
                            rdbits.mvd_bits(-left_f) + 5.0], 0)
    lvl_ogz, rec_ogz, cost_ogz = _cand_rd(cur_b.repeat(3, 1, 1), ogz_pred,
                                          qp, lam, s, sbh_scan, bits_ogz, 3,
                                          n, inv=inv)
    all_mv = torch.cat([lt_mv, ogz_mv], 0)
    preds = torch.cat([lt_pred, ogz_pred], 0)
    level = torch.cat([lvl_lt, lvl_ogz], 0)
    recon = torch.cat([rec_lt, rec_ogz], 0)
    cost = torch.cat([cost_lt, cost_ogz], 0)              # [5, n]
    best = torch.argmin(cost, 0)
    pick = best * n + torch.arange(n, device=dev)
    return (all_mv[pick], level[pick], recon[pick], preds[pick],
            cost.amin(0))


def _asm_tiles(t, n: int):
    """[g, n*n, 16, 16] z-row-major tiles -> [g, 16n, 16n]."""
    g = t.shape[0]
    return t.reshape(g, n, n, 16, 16).permute(0, 1, 3, 2, 4) \
        .reshape(g, 16 * n, 16 * n)


def _split_tiles(p, n: int):
    """[g, 16n, 16n] -> [g, n*n, 16, 16]."""
    g = p.shape[0]
    return p.reshape(g, n, 16, n, 16).permute(0, 1, 3, 2, 4) \
        .reshape(g, n * n, 16, 16)


def _split_quads64(p):
    g = p.shape[0]
    return p.reshape(g, 2, 32, 2, 32).permute(0, 1, 3, 2, 4) \
        .reshape(-1, 32, 32)


def _join_quads64(q):
    g = q.shape[0] // 4
    return q.reshape(g, 2, 2, 32, 32).permute(0, 1, 3, 2, 4) \
        .reshape(g, 64, 64)


def _quadtree_level(cur_b, pred_sel, mv_flat, level_y, recon_y, cost_child,
                    elig_tile, qp, lam, bh, bw, n: int, sbh16, sbh32,
                    inv=None, coded=None):
    """Fold n x n groups of MV-uniform 16x16 tiles into one (16n)^2 CU
    when the parent RD (32 TB / four 16 TBs / zero residual; four 32 TBs
    at n=4) beats the children."""
    dev = cur_b.device
    gh, gw = bh // n, bw // n
    gy = torch.arange(gh, device=dev)
    gx = torch.arange(gw, device=dev)
    d = torch.arange(n, device=dev)
    tidx = ((n * gy[:, None, None, None] + d[None, None, :, None]) * bw
            + (n * gx[None, :, None, None] + d[None, None, None, :]))
    tidx = tidx.reshape(-1, n * n)
    g = tidx.shape[0]
    flat = tidx.reshape(-1)

    o_tiles = cur_b[flat].reshape(g, n * n, 16, 16)
    mv_tiles = mv_flat[flat].reshape(g, n * n, 2)
    uniform = (mv_tiles == mv_tiles[:, :1]).all(-1).all(-1)
    pmv = mv_tiles[:, 0]
    pred_t = pred_sel[flat].reshape(g, n * n, 16, 16)

    visw = None
    if inv is not None:
        visw = torch.where(inv[flat].reshape(g, n * n),
                           torch.tensor(_PAD_DIST_W, device=dev),
                           torch.tensor(1.0, device=dev))

    def tile_ssd(a, b):
        t = _ssd(a, b)
        if visw is not None:
            t = t * visw
        return f32.row_sum(t)

    ssd_zero = tile_ssd(pred_t, o_tiles)
    bits_mv = torch.where(uniform, torch.tensor(3.0, device=dev),
                          torch.tensor(6.0, device=dev))
    cost_zero = f32.fma(lam, bits_mv + 1.0, ssd_zero)

    if n == 2:
        l16, rr16 = _tq((o_tiles - pred_t).reshape(-1, 16, 16), 16, qp,
                        False, sbh16)
        rec16 = (pred_t.reshape(-1, 16, 16) + rr16).clamp(0, 255)
        l16 = l16.reshape(g, n * n, 16, 16)
        rec16 = rec16.reshape(g, n * n, 16, 16)
        ssd16 = tile_ssd(rec16, o_tiles)
        rb16 = f32.row_sum(rdbits.residual_bits(
            l16.reshape(-1, 16, 16), 16, qp=qp).reshape(g, n * n))
        cost_tr1 = f32.fma(lam, bits_mv + rb16 + 5.0, ssd16)
    else:
        cost_tr1 = torch.full((g,), float("inf"), device=dev)
        l16 = rec16 = None

    orig_big = _asm_tiles(o_tiles, n)
    pred_big = _asm_tiles(pred_t, n)
    if n == 4:
        q = _split_quads64(orig_big - pred_big)
        lB, rrB = _tq(q, 32, qp, False, sbh32)
        recB = (_split_quads64(pred_big) + rrB).clamp(0, 255)
        rbB = f32.row_sum(rdbits.residual_bits(lB, 32, qp=qp)
                          .reshape(g, 4))
        lvl_big = _join_quads64(lB)
        rec_big = _join_quads64(recB)
        cbf_big_q = (lB != 0).any(-1).any(-1).reshape(g, 4)
    else:
        lvl_big, rrB = _tq(orig_big - pred_big, 32, qp, False, sbh32)
        rec_big = (pred_big + rrB).clamp(0, 255)
        rbB = rdbits.residual_bits(lvl_big, 32, qp=qp)
        cbf_big_q = (lvl_big != 0).any(-1).any(-1)[:, None]
    ssd_big = tile_ssd(_split_tiles(rec_big, n), o_tiles)
    cost_big = f32.fma(lam, bits_mv + rbB + 4.0, ssd_big)

    parent_cost = torch.minimum(torch.minimum(cost_big, cost_tr1),
                                cost_zero)
    elig = uniform & ~(elig_tile[flat].reshape(g, n * n).any(-1))
    if coded is not None:
        s_big = 16 * n
        gpy = (gy * s_big)[:, None]
        gpx = (gx * s_big)[None, :]
        inside = (gpx + s_big <= coded[0]) & (gpy + s_big <= coded[1])
        elig = elig & inside.reshape(-1)
    children = f32.fma(lam, 1.0, f32.row_sum(
        cost_child[flat].reshape(g, n * n)))
    take = elig & (parent_cost < children)

    use_zero = cost_zero <= torch.minimum(cost_big, cost_tr1)
    use_big = ~use_zero & (cost_big <= cost_tr1)
    zz = use_zero[:, None, None, None]
    bb = use_big[:, None, None, None]
    lvl_big_t = _split_tiles(lvl_big, n)
    rec_big_t = _split_tiles(rec_big, n)
    if n == 2:
        lvl_par = torch.where(zz, 0, torch.where(bb, lvl_big_t, l16))
        rec_par = torch.where(zz, pred_t,
                              torch.where(bb, rec_big_t, rec16))
        cbf16_t = (l16 != 0).any(-1).any(-1)
        cbf_par = torch.where(
            use_zero[:, None], False,
            torch.where(use_big[:, None], cbf_big_q.expand(g, n * n),
                        cbf16_t))
        trd = torch.where(use_zero | use_big, 0, 1)
    else:
        lvl_par = torch.where(zz, 0, lvl_big_t)
        rec_par = torch.where(zz, pred_t, rec_big_t)
        qmap = torch.tensor([0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3],
                            device=dev)
        cbf_par = torch.where(use_zero[:, None], False, cbf_big_q[:, qmap])
        trd = torch.ones((g,), dtype=torch.int64, device=dev)

    tk = take[:, None, None, None]
    level_y = level_y.clone()
    recon_y = recon_y.clone()
    pred_sel = pred_sel.clone()
    mv_flat = mv_flat.clone()
    level_y[flat] = torch.where(
        tk, lvl_par, level_y[flat].reshape(g, n * n, 16, 16)) \
        .reshape(-1, 16, 16).to(level_y.dtype)
    recon_y[flat] = torch.where(
        tk, rec_par, recon_y[flat].reshape(g, n * n, 16, 16)) \
        .reshape(-1, 16, 16).to(recon_y.dtype)
    pred_sel[flat] = torch.where(
        tk, pred_t, pred_sel[flat].reshape(g, n * n, 16, 16)) \
        .reshape(-1, 16, 16)
    mv_flat[flat] = torch.where(take[:, None, None],
                                pmv[:, None].expand(g, n * n, 2),
                                mv_tiles).reshape(-1, 2)
    cost_out = torch.where(take, parent_cost, children)
    return (mv_flat, level_y, recon_y, pred_sel, cost_out, take, cbf_par,
            trd, tidx)


def quadtree_consolidate(cur_b, pred_sel, mv, level_y, recon_y, cost16,
                         excl, qp, lam, bh: int, bw: int, sign_hiding: bool,
                         inv=None, coded=None):
    """Bottom-up CU consolidation 16 -> 32 -> 64 with TU RDO.  Returns
    (mv [bh,bw,2], level_y, recon_y, cbf_y [bh,bw], cu_depth, tr_depth,
    chroma16 [bh//2, bw//2])."""
    dev = cur_b.device
    sbh16 = tuple(tables.scan_order(16, tables.SCAN_DIAG)) \
        if sign_hiding else None
    sbh32 = tuple(tables.scan_order(32, tables.SCAN_DIAG)) \
        if sign_hiding else None
    mv_flat = mv.reshape(-1, 2)
    (mv_flat, level_y, recon_y, pred_sel, cost32, take32, cbf32_t, trd32,
     tidx32) = _quadtree_level(cur_b, pred_sel, mv_flat, level_y, recon_y,
                               cost16, excl, qp, lam, bh, bw, 2, sbh16,
                               sbh32, inv, coded)
    cost32_tile = torch.zeros((bh * bw,), dtype=torch.float32, device=dev)
    cost32_tile[tidx32.reshape(-1)] = torch.repeat_interleave(
        cost32 / 4.0, 4)
    (mv_flat, level_y, recon_y, pred_sel, cost64, take64, cbf64_t, trd64,
     tidx64) = _quadtree_level(cur_b, pred_sel, mv_flat, level_y, recon_y,
                               cost32_tile, excl, qp, lam, bh, bw, 4,
                               sbh16, sbh32, inv, coded)
    cu_depth = torch.full((bh * bw,), 2, dtype=torch.int32, device=dev)
    tr_depth = torch.zeros((bh * bw,), dtype=torch.int32, device=dev)
    cbf_y = (level_y != 0).any(-1).any(-1)
    g32 = tidx32.reshape(-1)
    t32 = torch.repeat_interleave(take32, 4)
    cu_depth[g32] = torch.where(t32, 1, cu_depth[g32]).to(torch.int32)
    tr_depth[g32] = torch.where(t32, torch.repeat_interleave(trd32, 4),
                                tr_depth[g32]).to(torch.int32)
    cbf_y[g32] = torch.where(t32, cbf32_t.reshape(-1), cbf_y[g32])
    g64 = tidx64.reshape(-1)
    t64 = torch.repeat_interleave(take64, 16)
    cu_depth[g64] = torch.where(t64, 0, cu_depth[g64]).to(torch.int32)
    tr_depth[g64] = torch.where(t64, 1, tr_depth[g64]).to(torch.int32)
    cbf_y[g64] = torch.where(t64, cbf64_t.reshape(-1), cbf_y[g64])
    ch32 = take32 & (trd32 == 0)
    chroma16 = ch32.reshape(bh // 2, bw // 2)
    in64 = torch.zeros((bh * bw,), dtype=torch.bool, device=dev)
    in64[g64] = t64
    chroma16 = chroma16 | in64.reshape(bh, bw)[::2, ::2]
    return (mv_flat.reshape(bh, bw, 2), level_y, recon_y,
            cbf_y.reshape(bh, bw), cu_depth.reshape(bh, bw),
            tr_depth.reshape(bh, bw), chroma16)


def _even(x: int, nb: int) -> int:
    return min(x + (x & 1), nb - (nb & 1))


def p_caps(nb: int):
    """Full-tier compaction capacities (luma blocks, chroma blocks, luma
    escape blocks, chroma escape blocks)."""
    cap_y = _even(nb, nb)
    cap_c = _even(nb, nb)
    return cap_y, cap_c, min(cap_y, max(64, nb // 4)), \
        min(cap_c, max(32, nb // 8))


def p_caps_small(nb: int):
    """Small-tier capacities of the always-pulled transfer."""
    cap_y = _even(min(nb, max(64, nb * 12 // 100)), nb)
    cap_c = _even(min(nb, max(32, nb * 10 // 100)), nb)
    return cap_y, cap_c, min(cap_y, max(4, nb // 256)), \
        min(cap_c, max(4, nb // 512))


def inter_boundary_strength(cbf, mv, block: int, h: int, w: int, tb2=None):
    """BS maps for a P frame without intra CUs (spec 8.7.2.4): 1 at a
    PU/TU boundary where either side has luma cbf or the MVs differ by
    >= 4 quarter-pel; interior edges of 32-wide TBs (tb2) are off."""
    bh, bw = cbf.shape
    dev = cbf.device
    c = cbf.to(torch.bool)
    cond_v = (c[:, :-1] | c[:, 1:]) \
        | ((mv[:, :-1] - mv[:, 1:]).abs() >= 4).any(-1)
    cond_h = (c[:-1] | c[1:]) | ((mv[:-1] - mv[1:]).abs() >= 4).any(-1)
    if tb2 is not None:
        j = torch.arange(bw - 1, device=dev)
        cond_v = cond_v & ~(((j % 2) == 0)[None, :] & tb2[:, 1:])
        i = torch.arange(bh - 1, device=dev)
        cond_h = cond_h & ~(((i % 2) == 0)[:, None] & tb2[1:, :])
    step = block // 8
    bs_v = torch.zeros((h // 4, w // 8), dtype=torch.int32, device=dev)
    bs_v[:, step::step] = torch.repeat_interleave(
        cond_v.to(torch.int32), block // 4, 0)
    bs_h = torch.zeros((h // 8, w // 4), dtype=torch.int32, device=dev)
    bs_h[step::step, :] = torch.repeat_interleave(
        cond_h.to(torch.int32), block // 4, 1)
    return bs_v, bs_h


def _edge_qp_maps(eff_map, h: int, w: int, cell: int):
    """Per-edge average QP maps for the luma deblock passes (spec
    8.7.2.5.3: qp = (QpP + QpQ + 1) >> 1): [h/4, w/8] and [h/8, w/4]."""
    ncy, ncx = eff_map.shape
    dev = eff_map.device
    rows = torch.repeat_interleave(eff_map, cell // 4, 0)
    x = torch.arange(w // 8, device=dev) * 8
    cl = torch.div(x - 1, cell, rounding_mode="floor").clamp(0, ncx - 1)
    cr = torch.div(x, cell, rounding_mode="floor").clamp(0, ncx - 1)
    qp_v = (rows[:, cl] + rows[:, cr] + 1) >> 1
    cols = torch.repeat_interleave(eff_map, cell // 4, 1)
    yy = torch.arange(h // 8, device=dev) * 8
    rt = torch.div(yy - 1, cell, rounding_mode="floor").clamp(0, ncy - 1)
    rb = torch.div(yy, cell, rounding_mode="floor").clamp(0, ncy - 1)
    qp_h = (cols[rt, :] + cols[rb, :] + 1) >> 1
    return qp_v, qp_h


def _effective_qp16(qp: int, qp_map, cbf_any_g, cu_depth, ctu: int,
                    s: int):
    """Per-16 granule QP the decoder's deblocking uses (spec 8.6.1, QG =
    CTB): a CTU without coded cbf keeps the previous QP in decoding
    order, and CUs before the first cbf-carrying CU of a CTU still use
    the predicted QP."""
    ncy, ncx = qp_map.shape
    r16 = ctu // s
    dev = qp_map.device
    has_cbf_ctu = cbf_any_g.reshape(ncy, r16, ncx, r16).any(3).any(1) \
        .reshape(-1)
    posc = torch.arange(ncy * ncx, device=dev)
    ff = torch.cummax(torch.where(has_cbf_ctu, posc, -1), 0).values
    eff = torch.where(ff >= 0, qp_map.reshape(-1)[ff.clamp(min=0)],
                      torch.full_like(ff, qp).to(qp_map.dtype))
    prev_eff = torch.cat([torch.full((1,), qp, dtype=eff.dtype,
                                     device=dev), eff[:-1]])
    z_g = torch.as_tensor(np.tile(tables.zscan_of_raster(r16), (ncy, ncx)),
                          device=dev)
    cstart = torch.where(cu_depth == 2, z_g,
                         torch.where(cu_depth == 1, z_g // 4 * 4, 0))
    first = torch.where(cbf_any_g, cstart, r16 * r16).reshape(
        ncy, r16, ncx, r16).permute(0, 2, 1, 3).reshape(ncy, ncx, -1) \
        .amin(-1)

    def rep(m):
        return torch.repeat_interleave(
            torch.repeat_interleave(m, r16, 0), r16, 1)
    return torch.where(cstart < rep(first), rep(prev_eff.reshape(ncy, ncx)),
                       rep(qp_map))


def _deblock_luma_p(out_y, qp: int, cbf_any, cbf_y, mv, cu_depth, tr_depth,
                    ctu: int, s: int, coded=None):
    """Luma deblocking of a P frame with the decoder's effective-QP chain;
    edges beyond the coded picture (cw, ch) stay off."""
    h, w = out_y.shape
    ncy, ncx = h // ctu, w // ctu
    qp_map = torch.full((ncy, ncx), qp, dtype=torch.int64,
                        device=out_y.device)
    qp_g16 = _effective_qp16(qp, qp_map, cbf_any, cu_depth, ctu, s)
    tb2 = (tr_depth == 0) & (cu_depth == 1) | (cu_depth == 0)
    bs_v, bs_h = inter_boundary_strength(cbf_y, mv, s, h, w, tb2=tb2)
    if coded is not None:
        bs_v[:, coded[0] // 8:] = 0
        bs_h[coded[1] // 8:, :] = 0
    qp_v, qp_h = _edge_qp_maps(qp_g16, h, w, 16)
    out_y = deblock._luma_pass(out_y, bs_v, qp_v)
    return deblock._luma_pass(out_y.T.contiguous(), bs_h.T,
                              qp_h.T).T.contiguous()


def _code_chroma(u32, v32, ref_u, ref_v, mv_f, pos_y, pos_x, chroma16,
                 qp_c: int, lam_cs, cs: int, bh: int, bw: int, sbh_scan_c,
                 sign_hiding: bool, inv16):
    """Chroma coding at the final MVs: one 16x16 chroma TB where the luma
    TB is 32-wide, else four 8x8 TBs; both planes' MC windows come from
    ONE plane-indexed gather.  Returns per-plane (levels, recon, cbf)."""
    dev = u32.device
    nb = bh * bw
    cpad = me.REF_PAD // 2
    cby = cpad + pos_y // 2 + (mv_f[:, 0] >> 3) - 1
    cbx = cpad + pos_x // 2 + (mv_f[:, 1] >> 3) - 1
    cplanes = torch.stack([me.pad_edge(ref_u.to(torch.int32), cpad),
                           me.pad_edge(ref_v.to(torch.int32), cpad)])
    ri2 = torch.repeat_interleave(torch.arange(2, device=dev), nb)
    cw2 = me._gather_windows_ref(cplanes.contiguous(), ri2, cby.repeat(2),
                                 cbx.repeat(2), cs + 3) \
        .reshape(2, nb, cs + 3, cs + 3)
    g2h, g2w = bh // 2, bw // 2
    scan16 = tuple(tables.scan_order(2 * cs, tables.SCAN_DIAG)) \
        if sign_hiding else None
    inv16g = None
    if inv16 is not None:
        ig = inv16.reshape(bh, bw)
        inv16g = (ig[::2, ::2] & ig[1::2, 1::2]).reshape(-1)
    ch16 = torch.repeat_interleave(torch.repeat_interleave(chroma16, 2, 0),
                                   2, 1)

    def asm(t):
        return t.reshape(g2h, 2, g2w, 2, cs, cs).permute(0, 2, 1, 4, 3, 5) \
            .reshape(-1, 2 * cs, 2 * cs)

    def tiles(p16):
        return p16.reshape(g2h, g2w, 2, cs, 2, cs) \
            .permute(0, 2, 1, 4, 3, 5).reshape(-1, cs, cs)

    lvl_c, rec_c, cbf_c = [], [], []
    for p, plane in enumerate((u32, v32)):
        cpred = interp.mc_chroma_phases(cw2[p], mv_f[:, 0] & 7,
                                        mv_f[:, 1] & 7, cs)
        cb = _blocks(plane, cs)
        lvl8, rr8 = _tq(cb - cpred, cs, qp_c, False, sbh_scan_c)
        rec8 = (cpred + rr8).clamp(0, 255)
        lvl8, rec8 = _rd_zero(lvl8, rec8, cpred, cb, lam_cs, inv=inv16,
                              qp=qp_c)
        pred16 = asm(cpred)
        orig16 = asm(cb)
        lvl16c, rr16c = _tq(orig16 - pred16, 2 * cs, qp_c, False, scan16)
        rec16c = (pred16 + rr16c).clamp(0, 255)
        lvl16c, rec16c = _rd_zero(lvl16c, rec16c, pred16, orig16, lam_cs,
                                  inv=inv16g, qp=qp_c)
        cbf16c = (lvl16c != 0).any(-1).any(-1)
        sel16 = ch16.reshape(-1)[:, None, None]
        new_lvl = torch.where(sel16, tiles(lvl16c), lvl8)
        lvl_c.append(new_lvl)
        rec_c.append(torch.where(sel16, tiles(rec16c), rec8))
        cbf_c.append(torch.where(
            ch16, torch.repeat_interleave(torch.repeat_interleave(
                cbf16c.reshape(g2h, g2w), 2, 0), 2, 1),
            (new_lvl != 0).any(-1).any(-1).reshape(bh, bw)))

    return lvl_c, rec_c, cbf_c


def encode_p_frame(y, u, v, ref_y, ref_u, ref_v, qp: int, block: int = 16,
                   sign_hiding: bool = False, deblocking: bool = False,
                   sao_enabled: bool = False, ctu: int = 64,
                   intra_fallback: bool = False,
                   chroma_rd_scale: float = 1.0, chroma_qp_offset: int = 0,
                   me_precision: int = 2, me_subpel_r: int = 2, qp_map=None, vis_h: int = None,
                   vis_w: int = None, merge_rounds: int = 1,
                   fallback_rounds: int = 1, fallback_serial: int = 0,
                   quadtree_majority: bool = False, inter_nxn: bool = False,
                   true_size: bool = False, wpp_substreams: bool = False,
                   scaling_lists: bool = False, **unsupported) -> dict:
    """Encode one P frame against one reference.  y/u/v: uint8/int32
    CTU-padded planes; ref_*: int32 reconstructed (deblocked, SAO'd)
    reference planes of the same shapes.  Returns a dict of tensors
    (recon planes, coefficient planes, mv, cbf, `packed`,
    `packed_full`)."""
    if intra_fallback or inter_nxn or quadtree_majority \
            or merge_rounds != 1 or fallback_serial:
        raise NotImplementedError(
            "rd=FAST/FULL P-frame tools (intra fallback, inter split8, "
            "quadtree majority, second merge round)")
    if qp_map is not None or wpp_substreams or scaling_lists:
        raise NotImplementedError("per-CTU QP / WPP substreams / scaling "
                                  "lists")
    if unsupported:
        raise NotImplementedError(f"options {sorted(unsupported)}")
    h, w = y.shape
    dev = y.device
    s = block
    cs = block // 2
    bh, bw = h // s, w // s
    nb = bh * bw
    qp = int(qp)
    qp_c = int(tables.CHROMA_QP_TABLE[min(max(qp + chroma_qp_offset, 0),
                                          57)])
    qpt = torch.tensor(qp, device=dev)
    lam = rdbits.rd_lambda_f32(qpt, False)
    lam_c = rdbits.rd_lambda_f32(torch.tensor(qp_c, device=dev), False)
    sbh_scan = tuple(tables.scan_order(s, tables.SCAN_DIAG)) \
        if sign_hiding else None
    sbh_scan_c = tuple(tables.scan_order(cs, tables.SCAN_DIAG)) \
        if sign_hiding else None

    cw8 = ch8 = None
    if true_size and vis_w is not None:
        cw8 = (vis_w + 15) // 16 * 16
        ch8 = (vis_h + 15) // 16 * 16
        if cw8 == w and ch8 == h:
            cw8 = ch8 = None
    if cw8 is not None:
        # the decoder clamps MC reads at the coded picture: rebuild the
        # references edge-replicated from the coded bounds
        def repad(p, bh_, bw_):
            rows = torch.arange(p.shape[0], device=dev).clamp(max=bh_ - 1)
            cols = torch.arange(p.shape[1], device=dev).clamp(max=bw_ - 1)
            return p.to(torch.int32).index_select(0, rows) \
                .index_select(1, cols)
        ref_y = repad(ref_y, ch8, cw8)
        ref_u = repad(ref_u, ch8 // 2, cw8 // 2)
        ref_v = repad(ref_v, ch8 // 2, cw8 // 2)
    cur = y.to(torch.int32)
    refy = ref_y.to(torch.int32)
    u32 = u.to(torch.int32)
    v32 = v.to(torch.int32)

    with record_function("p.me"):
        mv, _, pred = me.motion_estimate(cur, refy, block=s,
                                         precision=me_precision,
                                         subpel_r=me_subpel_r,
                                         sqrt_lam=torch.sqrt(lam))
    pos_y = torch.arange(bh, dtype=torch.int32,
                         device=dev).repeat_interleave(bw) * s
    pos_x = (torch.arange(bw, dtype=torch.int32, device=dev) * s).repeat(bh)
    cur_b = _blocks(cur, s)
    inv16 = None
    if vis_h is not None and vis_w is not None \
            and (vis_h < h or vis_w < w):
        iy = torch.arange(bh, device=dev) * s >= vis_h
        ix = torch.arange(bw, device=dev) * s >= vis_w
        inv16 = (iy[:, None] | ix[None, :]).reshape(-1)
    ref_pad = me.pad_edge(refy, me.REF_PAD).contiguous()

    with record_function("p.merge"):
        mv_flat, level_y, recon_y, pred_sel, cost16 = _merge_skip_rd(
            cur_b, ref_pad, pos_y, pos_x, mv, pred, qpt, lam, s, sbh_scan,
            merge_candidate_fields(mv), inv=inv16)
    mv = mv_flat.reshape(bh, bw, 2)

    excl = torch.zeros((nb,), dtype=torch.bool, device=dev)
    with record_function("p.quadtree"):
        mv, level_y, recon_y, cbf_y, cu_depth, tr_depth, chroma16 = \
            quadtree_consolidate(cur_b, pred_sel, mv, level_y, recon_y,
                                 cost16, excl, qpt, lam, bh, bw, sign_hiding,
                                 inv=inv16,
                                 coded=None if cw8 is None else (cw8, ch8))
    mv_f = mv.reshape(-1, 2)

    with record_function("p.chroma"):
        lvl_c, rec_c, cbf_c = _code_chroma(
            u32, v32, ref_u, ref_v, mv_f, pos_y, pos_x, chroma16, qp_c,
            lam_c * chroma_rd_scale, cs, bh, bw, sbh_scan_c, sign_hiding,
            inv16)

    dist16 = (recon_y - cur_b).abs().sum() // nb
    out_y = _unblocks(recon_y, h, w)
    out_u = _unblocks(rec_c[0], h // 2, w // 2)
    out_v = _unblocks(rec_c[1], h // 2, w // 2)

    if deblocking:
        with record_function("p.deblock"):
            out_y = _deblock_luma_p(out_y, qp, cbf_y | cbf_c[0] | cbf_c[1],
                                    cbf_y, mv, cu_depth, tr_depth, ctu, s,
                                    coded=None if cw8 is None else (cw8, ch8))

    sao_fields = None
    if sao_enabled:
        with record_function("p.sao"):
            out_y, out_u, out_v, sao_fields = sao.sao_frame(
                cur, u32, v32, out_y, out_u, out_v, lam, lam_c, ctu,
                coded=None if cw8 is None else (ch8, cw8))

    cbf = torch.stack([cbf_y, cbf_c[0], cbf_c[1]]).to(torch.int32)
    out = dict(recon_y=out_y, recon_u=out_u, recon_v=out_v,
               coeff_y=_unblocks(level_y, h, w).to(torch.int16),
               coeff_cb=_unblocks(lvl_c[0], h // 2, w // 2).to(torch.int16),
               coeff_cr=_unblocks(lvl_c[1], h // 2, w // 2).to(torch.int16),
               mv=mv, cbf=cbf)
    cap_y, cap_c, esc_y, esc_c = p_caps(nb)
    cap_ys, cap_cs, esc_ys, esc_cs = p_caps_small(nb)
    with record_function("p.pack"):
        pk_y_s, pk_y_f = packing.compact_blocks_i8_tiers(
            level_y, [(cap_ys, esc_ys), (cap_y, esc_y)])
        pk_u_s, pk_u_f = packing.compact_blocks_i8_tiers(
            lvl_c[0], [(cap_cs, esc_cs), (cap_c, esc_c)])
        pk_v_s, pk_v_f = packing.compact_blocks_i8_tiers(
            lvl_c[1], [(cap_cs, esc_cs), (cap_c, esc_c)])
    i16 = dict(dtype=torch.int16, device=dev)
    parts = [mv.to(torch.int16).reshape(-1),
             torch.zeros((nb,), **i16),                 # ref_idx
             cbf.to(torch.int16).reshape(-1),
             torch.zeros((nb,), **i16),                 # is_intra
             torch.zeros((nb,), **i16),                 # intra modes
             cu_depth.to(torch.int16).reshape(-1),
             tr_depth.to(torch.int16).reshape(-1),
             torch.zeros((4 * nb,), **i16),             # per-8 MV deltas
             torch.zeros((nb,), **i16),                 # sub-CU cbfs
             torch.zeros((1,), **i16),                  # intra candidates
             dist16.clamp(0, 32767).to(torch.int16)[None],
             pk_y_s, pk_u_s, pk_v_s]
    if sao_fields is not None:
        parts.append(sao.pack_sao_fields(sao_fields))
    out["packed"] = torch.cat(parts)
    out["packed_full"] = torch.cat([pk_y_f, pk_u_f, pk_v_f])
    return out


def encode_p_chunk(ys, us, vs, ref_y, ref_u, ref_v, qp, **flags) -> dict:
    """K consecutive P frames, each predicted from the previous one's
    reconstruction.  ys uint8/int32 [K, H, W]; qp int or K ints.
    Returns dict(recon_* of the last frame, packed [K, L],
    packed_full [K, L2], coeff_* [K, ...])."""
    k = ys.shape[0]
    qps = [int(qp)] * k if np.ndim(qp) == 0 else [int(q) for q in qp]
    ref = (ref_y, ref_u, ref_v)
    per = []
    for j in range(k):
        out = encode_p_frame(ys[j], us[j], vs[j], *ref, qp=qps[j], **flags)
        ref = (out["recon_y"], out["recon_u"], out["recon_v"])
        per.append(out)
    res = dict(recon_y=ref[0], recon_u=ref[1], recon_v=ref[2])
    for key in ("packed", "packed_full", "coeff_y", "coeff_cb", "coeff_cr"):
        res[key] = torch.stack([o[key] for o in per])
    return res


def encode_p_chunk_packed(buf, ref_y, ref_u, ref_v, *, k: int, vis_h: int,
                          vis_w: int, ctu: int, qp, **flags) -> dict:
    """encode_p_chunk behind ONE host->device buffer: the K frames' raw
    (unpadded) Y|U|V planes raveled into a uint8 vector; padding to the
    CTU multiple (edge replication) happens on the device."""
    ny, nc = vis_h * vis_w, (vis_h // 2) * (vis_w // 2)
    ys = buf[:k * ny].reshape(k, vis_h, vis_w)
    us = buf[k * ny:k * (ny + nc)].reshape(k, vis_h // 2, vis_w // 2)
    vs = buf[k * (ny + nc):].reshape(k, vis_h // 2, vis_w // 2)

    def pad(p, m):
        hh, ww = p.shape[1:]
        rows = torch.arange(hh + (-hh % m), device=p.device).clamp(max=hh - 1)
        cols = torch.arange(ww + (-ww % m), device=p.device).clamp(max=ww - 1)
        return p.index_select(1, rows).index_select(2, cols)
    return encode_p_chunk(pad(ys, ctu), pad(us, ctu // 2),
                          pad(vs, ctu // 2), ref_y, ref_u, ref_v, qp=qp,
                          vis_h=vis_h, vis_w=vis_w, ctu=ctu, **flags)
