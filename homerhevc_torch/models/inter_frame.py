"""Batched P-frame (inter) encoder.

Port of homerhevc_tpu/models/inter_frame.py (`encode_p_frame`,
`encode_p_chunk`, `encode_p_chunk_packed`) for one or two reference
pictures, on one device or in CTU-row bands over a process group, at
the knobs of the reference's speed ladder (rd=FULL's P frame is
rd=FAST's), with a slice QP per frame and an
optional per-CTU QP map (cu_qp_delta; WPP substreams reset the
deblocking QP chain per CTU row), flat quantization or the default
scaling lists (scaling_lists, in every TQ call), and the intra
fallback's serial pass (fallback_serial).

QP and lambda are per 16-block tensors ([nb], built once per frame from
the map) in every RD decision, except motion estimation, the
intra-preference count and SAO, which keep the slice QP's.

Stage order: motion estimation (on each reference, then a per-block
reference pick) -> merge/skip RD over {left, top, own, global, zero}
candidates (a second round re-evaluates left/top from the
first round's winners) -> isolated intra fallback in rounds, then
(fallback_serial) up to N more candidates one by one in coding order -> the
frame's intra-preference count (scene-change restart) -> 8x8 inter
split of divergent-motion 16x16 blocks -> 16/32/64 quadtree
consolidation with TU-size RD (non-uniform groups at their majority MV)
-> chroma coding with chroma MC (4x4 TBs under split CUs) -> chroma of
the fallback blocks -> deblocking with the effective-QP chain -> SAO ->
packed device->host record.

Data-dependent selections keep the reference's static shapes: each
compaction takes a fixed number of candidates (`_FALLBACK_CAP`,
`_NXN_CAP`) with a stable descending sort (equal keys lowest index
first, as the reference's top_k on the CPU), so a P frame makes the same
kernel calls whatever its content, and no stage waits on the host.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from homerhevc_torch import parallel, tables
from homerhevc_torch.models import intra_frame, schedule
from homerhevc_torch.ops import (deblock, f32, interp, intra, me, packing,
                                 quant, rdbits, sao, transform)
from homerhevc_torch.ops.me import blocks as _blocks
from homerhevc_torch.utils.profiler import stage

_PAD_DIST_W = 0.0625
_FALLBACK_CAP = 512          # max intra CUs per fallback round
_NXN_CAP = 512               # max 8x8-split CUs per P frame


def _unblocks(blk: torch.Tensor, h: int, w: int) -> torch.Tensor:
    b = blk.shape[-1]
    return blk.reshape(h // b, w // b, b, b).permute(0, 2, 1, 3) \
        .reshape(h, w)


def topk_stable(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of a 1-D tensor, equal
    values lowest index first."""
    v, i = torch.sort(x, descending=True, stable=True)
    return v[:k], i[:k]


def _put_rows(dst: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor,
              src: torch.Tensor) -> torch.Tensor:
    """dst with rows idx (distinct) replaced by src where ok."""
    okb = ok.reshape(ok.shape + (1,) * (src.dim() - 1))
    out = dst.clone()
    out[idx] = torch.where(okb, src.to(dst.dtype), dst[idx])
    return out


def _tq(resid, size, qp, is_intra, sbh_scan, scaling=False):
    coeff = transform.forward_transform(resid, size)
    level, du = quant.quantize(coeff, qp, size, is_intra=is_intra,
                               scaling=scaling)
    if sbh_scan is not None:
        level = quant.sign_bit_hide(level, du, sbh_scan, size)
    deq = quant.dequantize(level, qp, size, is_intra=is_intra,
                           scaling=scaling)
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


def _cand_rd(cur_c, preds, qp, lam, s, sbh_scan, bits_mv, nc, n, inv=None,
             scaling=False):
    """TQ + zero-residual fold + cost of nc candidate predictions (qp,
    lam: per block [n]).  Returns (level, recon [nc*n, S, S], cost
    [nc, n])."""
    qp = qp.repeat(nc)
    level, rr = _tq(cur_c - preds, s, qp, False, sbh_scan, scaling)
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
                   lam, s, sbh_scan, cand_fields, inv=None, carry_in=None,
                   ref_grid=None, ref_pads=None, scaling=False, y0: int = 0,
                   neigh_refs=None):
    """Merge/skip RD arbitration: every candidate MV (left, top, own,
    global, zero) gets an exact prediction, a full T/Q/IQ/IT
    reconstruction and a forced-zero-residual variant; the per-block
    winner's (mv, level, recon, pred, cost) are returned with a carry.
    Given a previous round's carry, only left/top are re-evaluated and
    compete with the cached own/global/zero candidates and that round's
    winner.  With ref_grid [bh, bw] (the per-block reference) and
    ref_pads [2, Hp, Wp], candidates are (mv, ref) pairs: left/top take
    the neighbour's ref, global and zero ref 0, and the own candidate
    pays its ref_idx bin; the winner's ref is carry["ref"], and
    neigh_refs gives the (left, top) neighbours' refs (from the whole
    frame's grid: on a row band, which starts at pixel row y0, the top
    row's neighbours lie in the band above)."""
    n = cur_b.shape[0]
    bh, bw = mv_own.shape[:2]
    h, w = bh * s, bw * s
    dev = cur_b.device
    left_f = cand_fields[0][0].reshape(-1, 2)
    lt_mv = torch.cat([left_f, cand_fields[1][0].reshape(-1, 2)], 0)
    if ref_grid is None:
        own_ref = lt_ref = None
        lt_pred = me.mc_luma_at(ref_pad, pos_y.repeat(2), pos_x.repeat(2),
                                lt_mv, s)
    else:
        own_ref = ref_grid.reshape(-1)
        lt_ref = torch.cat([r.reshape(-1) for r in neigh_refs])
        lt_pred = me.mc_luma_at(ref_pads, pos_y.repeat(2), pos_x.repeat(2),
                                lt_mv, s, ref=lt_ref)
    bits_lt = torch.full((2, n), 3.0, device=dev)
    lvl_lt, rec_lt, cost_lt = _cand_rd(cur_b.repeat(2, 1, 1), lt_pred, qp,
                                       lam, s, sbh_scan, bits_lt, 2, n,
                                       inv=inv, scaling=scaling)
    if carry_in is None:
        med = cand_fields[2][0][0, 0]
        glob_pred = _blocks(_mc_plane_luma(ref_pad, med, y0, h, w), s)
        zero_pred = _blocks(ref_pad[me.REF_PAD + y0:me.REF_PAD + y0 + h,
                                    me.REF_PAD:me.REF_PAD + w], s)
        own = mv_own.reshape(-1, 2)
        ogz_mv = torch.cat([own, cand_fields[2][0].reshape(-1, 2),
                            torch.zeros_like(own)], 0)
        ogz_pred = torch.cat([pred_own, glob_pred, zero_pred], 0)
        bits_own = rdbits.mvd_bits(own - left_f) + 5.0
        if own_ref is not None:
            # the own candidate pays its ref_idx bin
            bits_own = bits_own + own_ref.to(torch.float32)
        bits_ogz = torch.stack([bits_own,
                                torch.full((n,), 3.0, device=dev),
                                rdbits.mvd_bits(-left_f) + 5.0], 0)
        lvl_ogz, rec_ogz, cost_ogz = _cand_rd(
            cur_b.repeat(3, 1, 1), ogz_pred, qp, lam, s, sbh_scan, bits_ogz,
            3, n, inv=inv, scaling=scaling)
        ogz_ref = None if own_ref is None else torch.cat(
            [own_ref, torch.zeros_like(own_ref).repeat(2)])
        fixed = (ogz_mv, ogz_pred, lvl_ogz, rec_ogz, cost_ogz, ogz_ref)
    else:
        fixed = carry_in["fixed"]
        ogz_mv, ogz_pred, lvl_ogz, rec_ogz, cost_ogz, ogz_ref = fixed
    mvs, preds, levels, recons, costs, refs = (
        [lt_mv, ogz_mv], [lt_pred, ogz_pred], [lvl_lt, lvl_ogz],
        [rec_lt, rec_ogz], [cost_lt, cost_ogz], [lt_ref, ogz_ref])
    if carry_in is not None:
        # the previous round's winner competes as the last candidate
        mvs.append(carry_in["mv"])
        preds.append(carry_in["pred"])
        levels.append(carry_in["level"])
        recons.append(carry_in["recon"])
        costs.append(carry_in["cost"][None])
        refs.append(carry_in["ref"])
    cost = torch.cat(costs, 0)                            # [nc, n]
    pick = torch.argmin(cost, 0) * n + torch.arange(n, device=dev)
    carry = dict(fixed=fixed, mv=torch.cat(mvs)[pick],
                 pred=torch.cat(preds)[pick], level=torch.cat(levels)[pick],
                 recon=torch.cat(recons)[pick], cost=cost.amin(0),
                 ref=None if own_ref is None else torch.cat(refs)[pick])
    return (carry["mv"], carry["level"], carry["recon"], carry["pred"],
            carry["cost"], carry)


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
                    inv=None, coded=None, ref_pad=None, ref_flat=None,
                    scaling=False, y0: int = 0):
    """Fold n x n groups of 16x16 tiles into one (16n)^2 CU when the
    parent RD (32 TB / four 16 TBs / zero residual; four 32 TBs at n=4)
    beats the children.  MV-uniform groups reuse the children's
    predictions; with `ref_pad` (quadtree majority) the other groups are
    evaluated too, at their majority MV (one MC gather per group).  qp,
    lam: per tile [nb]; a group never crosses a CTU, so its tiles share
    them.  With ref_flat [nb] (two references; ref_pad is then the
    stacked [2, Hp, Wp] pad) a group of mixed references is neither
    uniform nor eligible, and the majority MV is taken at the group's
    first tile's reference.  y0: the pixel row of the tiles' first row
    (a row band's offset in the frame)."""
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
    ref_uni = torch.ones_like(uniform)
    ref_grp = None
    if ref_flat is not None:
        ref_tiles = ref_flat[flat].reshape(g, n * n)
        ref_uni = (ref_tiles == ref_tiles[:, :1]).all(-1)
        uniform = uniform & ref_uni
        ref_grp = ref_tiles[:, 0]
    eq = (mv_tiles[:, :, None] == mv_tiles[:, None, :]).all(-1)
    maj_i = torch.argmax(eq.sum(-1), -1)
    maj_mv = mv_tiles[torch.arange(g, device=dev), maj_i]
    pmv = torch.where(uniform[:, None], mv_tiles[:, 0], maj_mv)
    pred_t = pred_sel[flat].reshape(g, n * n, 16, 16)
    if ref_pad is not None:
        s_big = 16 * n
        gpy = (y0 + gy * s_big)[:, None].expand(gh, gw).reshape(-1)
        gpx = (gx * s_big)[None, :].expand(gh, gw).reshape(-1)
        pred_maj = me.mc_luma_at(ref_pad, gpy.to(torch.int32),
                                 gpx.to(torch.int32), maj_mv, s_big,
                                 ref=ref_grp)
        pred_t = torch.where(uniform[:, None, None, None], pred_t,
                             _split_tiles(pred_maj, n))

    qp_tile = qp[flat]
    qp_g = qp_tile.reshape(g, n * n)[:, 0]
    lam_g = lam[flat].reshape(g, n * n)[:, 0]
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
    cost_zero = f32.fma(lam_g, bits_mv + 1.0, ssd_zero)

    if n == 2:
        l16, rr16 = _tq((o_tiles - pred_t).reshape(-1, 16, 16), 16,
                        qp_tile, False, sbh16, scaling)
        rec16 = (pred_t.reshape(-1, 16, 16) + rr16).clamp(0, 255)
        l16 = l16.reshape(g, n * n, 16, 16)
        rec16 = rec16.reshape(g, n * n, 16, 16)
        ssd16 = tile_ssd(rec16, o_tiles)
        rb16 = f32.row_sum(rdbits.residual_bits(
            l16.reshape(-1, 16, 16), 16, qp=qp_tile).reshape(g, n * n))
        cost_tr1 = f32.fma(lam_g, bits_mv + rb16 + 5.0, ssd16)
    else:
        cost_tr1 = torch.full((g,), float("inf"), device=dev)
        l16 = rec16 = None

    orig_big = _asm_tiles(o_tiles, n)
    pred_big = _asm_tiles(pred_t, n)
    if n == 4:
        q = _split_quads64(orig_big - pred_big)
        qp_q = torch.repeat_interleave(qp_g, 4)
        lB, rrB = _tq(q, 32, qp_q, False, sbh32, scaling)
        recB = (_split_quads64(pred_big) + rrB).clamp(0, 255)
        rbB = f32.row_sum(rdbits.residual_bits(lB, 32, qp=qp_q)
                          .reshape(g, 4))
        lvl_big = _join_quads64(lB)
        rec_big = _join_quads64(recB)
        cbf_big_q = (lB != 0).any(-1).any(-1).reshape(g, 4)
    else:
        lvl_big, rrB = _tq(orig_big - pred_big, 32, qp_g, False, sbh32,
                           scaling)
        rec_big = (pred_big + rrB).clamp(0, 255)
        rbB = rdbits.residual_bits(lvl_big, 32, qp=qp_g)
        cbf_big_q = (lvl_big != 0).any(-1).any(-1)[:, None]
    ssd_big = tile_ssd(_split_tiles(rec_big, n), o_tiles)
    cost_big = f32.fma(lam_g, bits_mv + rbB + 4.0, ssd_big)

    parent_cost = torch.minimum(torch.minimum(cost_big, cost_tr1),
                                cost_zero)
    maj_ok = ref_uni if ref_pad is not None else uniform
    elig = maj_ok & ~(elig_tile[flat].reshape(g, n * n).any(-1))
    if coded is not None:
        s_big = 16 * n
        gpy = (y0 + gy * s_big)[:, None]
        gpx = (gx * s_big)[None, :]
        inside = (gpx + s_big <= coded[0]) & (gpy + s_big <= coded[1])
        elig = elig & inside.reshape(-1)
    children = f32.fma(lam_g, 1.0, f32.row_sum(
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
        .reshape(-1, 16, 16).to(pred_sel.dtype)
    mv_flat[flat] = torch.where(take[:, None, None],
                                pmv[:, None].expand(g, n * n, 2),
                                mv_tiles).reshape(-1, 2)
    cost_out = torch.where(take, parent_cost, children)
    return (mv_flat, level_y, recon_y, pred_sel, cost_out, take, cbf_par,
            trd, tidx)


def quadtree_consolidate(cur_b, pred_sel, mv, level_y, recon_y, cost16,
                         excl, qp, lam, bh: int, bw: int, sign_hiding: bool,
                         inv=None, coded=None, ref_pad=None, ref_flat=None,
                         scaling=False, y0: int = 0):
    """Bottom-up CU consolidation 16 -> 32 -> 64 with TU RDO (qp, lam:
    per tile [nb]; ref_pad: non-uniform groups at their majority MV;
    ref_flat: the per-tile reference, ref_pad then stacked; y0: a row
    band's pixel offset).  Returns
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
                               sbh32, inv, coded, ref_pad, ref_flat, scaling,
                               y0)
    cost32_tile = torch.zeros((bh * bw,), dtype=torch.float32, device=dev)
    cost32_tile[tidx32.reshape(-1)] = torch.repeat_interleave(
        cost32 / 4.0, 4)
    (mv_flat, level_y, recon_y, pred_sel, cost64, take64, cbf64_t, trd64,
     tidx64) = _quadtree_level(cur_b, pred_sel, mv_flat, level_y, recon_y,
                               cost32_tile, excl, qp, lam, bh, bw, 4,
                               sbh16, sbh32, inv, coded, ref_pad, ref_flat,
                               scaling, y0)
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


def _rep2(x: torch.Tensor, k: int = 2) -> torch.Tensor:
    """Repeat each entry of the first two axes k times along both."""
    return torch.repeat_interleave(torch.repeat_interleave(x, k, 0), k, 1)


def inter_boundary_strength(cbf, mv, block: int, h: int, w: int,
                            is_intra=None, tb2=None, mv8=None, nxn=None,
                            cbf8=None, ref=None):
    """BS maps for a P frame (spec 8.7.2.4): 2 at a PU/TU boundary where
    either side is intra, else 1 where either side has luma cbf, the
    MVs differ by >= 4 quarter-pel or (ref [bh, bw]) the reference
    pictures differ; interior edges of 32-wide TBs (tb2) are off.  With
    mv8 [2bh, 2bw, 2], nxn [bh, bw] and cbf8 [2bh, 2bw] (8x8 split CUs)
    the MV, cbf and reference terms are evaluated per 8 pel, and a
    16-interior 8-edge is a boundary only inside a split block.
    Returns the vertical-edge map [h/4, w/8] and horizontal [h/8, w/4]."""
    bh, bw = cbf.shape
    dev = cbf.device
    c = cbf.to(torch.bool)
    if mv8 is not None:
        c8 = cbf8.to(torch.bool)
        cond_v = c8[:, 1:-1:2] | c8[:, 2::2]                # [2bh, bw-1]
        cond_h = c8[1:-1:2, :] | c8[2::2, :]                # [bh-1, 2bw]
    else:
        cond_v = (c[:, :-1] | c[:, 1:]) \
            | ((mv[:, :-1] - mv[:, 1:]).abs() >= 4).any(-1)
        cond_h = (c[:-1] | c[1:]) | ((mv[:-1] - mv[1:]).abs() >= 4).any(-1)
    if ref is not None:
        rv = ref[:, :-1] != ref[:, 1:]
        rh = ref[:-1] != ref[1:]
        if mv8 is not None:
            rv = torch.repeat_interleave(rv, 2, 0)
            rh = torch.repeat_interleave(rh, 2, 1)
        cond_v = cond_v | rv
        cond_h = cond_h | rh
    if tb2 is not None:
        j = torch.arange(bw - 1, device=dev)
        interior_v = ((j % 2) == 0)[None, :] & tb2[:, 1:]
        i = torch.arange(bh - 1, device=dev)
        interior_h = ((i % 2) == 0)[:, None] & tb2[1:, :]
        if mv8 is not None:
            interior_v = torch.repeat_interleave(interior_v, 2, 0)
            interior_h = torch.repeat_interleave(interior_h, 2, 1)
        cond_v = cond_v & ~interior_v
        cond_h = cond_h & ~interior_h
    i32 = dict(dtype=torch.int32, device=dev)
    if mv8 is not None:
        mvd8_v = ((mv8[:, :-1] - mv8[:, 1:]).abs() >= 4).any(-1)
        mvd8_h = ((mv8[:-1] - mv8[1:]).abs() >= 4).any(-1)
        val16_v = (cond_v | mvd8_v[:, 1::2]).to(torch.int32)
        val16_h = (cond_h | mvd8_h[1::2, :]).to(torch.int32)
        c8 = cbf8.to(torch.bool)
        ci_v = c8[:, 0:-1:2] | c8[:, 1::2]                  # [2bh, bw]
        ci_h = c8[0:-1:2, :] | c8[1::2, :]                  # [bh, 2bw]
        nxn_r = torch.repeat_interleave(nxn, 2, 0)
        vali_v = ((mvd8_v[:, 0::2] | ci_v) & nxn_r).to(torch.int32)
        nxn_c = torch.repeat_interleave(nxn, 2, 1)
        vali_h = ((mvd8_h[0::2, :] | ci_h) & nxn_c).to(torch.int32)
        if is_intra is not None:
            ii = is_intra.to(torch.bool)
            i_v = torch.repeat_interleave(ii[:, :-1] | ii[:, 1:], 2, 0)
            val16_v = torch.where(i_v, 2, val16_v)
            i_h = torch.repeat_interleave(ii[:-1] | ii[1:], 2, 1)
            val16_h = torch.where(i_h, 2, val16_h)
        bs_v = torch.zeros((h // 4, w // 8), **i32)
        bs_v[:, 2::2] = torch.repeat_interleave(val16_v, 2, 0)
        bs_v[:, 1::2] = torch.repeat_interleave(vali_v, 2, 0)
        bs_h = torch.zeros((h // 8, w // 4), **i32)
        bs_h[2::2, :] = torch.repeat_interleave(val16_h, 2, 1)
        bs_h[1::2, :] = torch.repeat_interleave(vali_h, 2, 1)
        return bs_v, bs_h
    val_v = cond_v.to(torch.int32)
    val_h = cond_h.to(torch.int32)
    if is_intra is not None:
        ii = is_intra.to(torch.bool)
        val_v = torch.where(ii[:, :-1] | ii[:, 1:], 2, val_v)
        val_h = torch.where(ii[:-1] | ii[1:], 2, val_h)
    step = block // 8
    bs_v = torch.zeros((h // 4, w // 8), **i32)
    bs_v[:, step::step] = torch.repeat_interleave(val_v, block // 4, 0)
    bs_h = torch.zeros((h // 8, w // 4), **i32)
    bs_h[step::step, :] = torch.repeat_interleave(val_h, block // 4, 1)
    return bs_v, bs_h


def chroma_boundary_strength(is_intra, block: int, hc: int, wc: int):
    """Chroma BS maps (only BS 2 filters, spec 8.7.2.5.5): 2 where either
    side of a block edge is intra; [hc//2, wc//8] and [hc//8, wc//2]."""
    ii = is_intra.to(torch.bool)
    v2 = (ii[:, :-1] | ii[:, 1:]).to(torch.int32) * 2
    h2 = (ii[:-1] | ii[1:]).to(torch.int32) * 2
    cb = block // 2
    step = cb // 8
    i32 = dict(dtype=torch.int32, device=ii.device)
    bs_v = torch.zeros((hc // 2, wc // 8), **i32)
    bs_v[:, step::step] = torch.repeat_interleave(v2, cb // 2, 0)
    bs_h = torch.zeros((hc // 8, wc // 2), **i32)
    bs_h[step::step, :] = torch.repeat_interleave(h2, cb // 2, 1)
    return bs_v, bs_h


def _edge_qp_maps(eff_map, h: int, w: int, cell: int, chroma_qp_offset=None):
    """Per-edge average QP maps of the deblock passes (spec 8.7.2.5.3:
    qp = (QpP + QpQ + 1) >> 1): luma [h/4, w/8] and [h/8, w/4]; with
    chroma_qp_offset, the chroma maps [hc/2, wc/8] and [hc/8, wc/2]
    mapped through the chroma table (spec 8.7.2.5.5)."""
    ncy, ncx = eff_map.shape
    dev = eff_map.device
    chroma = chroma_qp_offset is not None
    ex = 16 if chroma else 8
    nv = w // 16 if chroma else w // 8
    nh = h // 16 if chroma else h // 8
    rows = torch.repeat_interleave(eff_map, cell // 4, 0)
    x = torch.arange(nv, device=dev) * ex
    cl = torch.div(x - 1, cell, rounding_mode="floor").clamp(0, ncx - 1)
    cr = torch.div(x, cell, rounding_mode="floor").clamp(0, ncx - 1)
    qp_v = (rows[:, cl] + rows[:, cr] + 1) >> 1
    cols = torch.repeat_interleave(eff_map, cell // 4, 1)
    yy = torch.arange(nh, device=dev) * ex
    rt = torch.div(yy - 1, cell, rounding_mode="floor").clamp(0, ncy - 1)
    rb = torch.div(yy, cell, rounding_mode="floor").clamp(0, ncy - 1)
    qp_h = (cols[rt, :] + cols[rb, :] + 1) >> 1
    if chroma:
        cqt = _chroma_qp_table(dev)
        qp_v = cqt[(qp_v + chroma_qp_offset).clamp(0, 57)]
        qp_h = cqt[(qp_h + chroma_qp_offset).clamp(0, 57)]
    return qp_v, qp_h


def _effective_qp16(qp: int, qp_map, cbf_any_g, cu_depth, ctu: int,
                    s: int, wpp: bool = False):
    """Per-16 granule QP the decoder's deblocking uses (spec 8.6.1, QG =
    CTB): a CTU without coded cbf keeps the previous QP in decoding
    order (the slice QP before the first coded one; with WPP substreams
    the chain restarts at the slice QP on every CTU row), and CUs before
    the first cbf-carrying CU of a CTU still use the predicted QP."""
    ncy, ncx = qp_map.shape
    r16 = ctu // s
    dev = qp_map.device
    has_cbf = cbf_any_g.reshape(ncy, r16, ncx, r16).any(3).any(1)
    if wpp:
        # forward fill along each CTU row
        colc = torch.arange(ncx, device=dev).expand(ncy, ncx)
        ffr = torch.cummax(torch.where(has_cbf, colc, -1), 1).values
        eff = torch.where(ffr >= 0,
                          torch.gather(qp_map, 1, ffr.clamp(min=0)), qp)
        prev_eff = torch.cat([torch.full((ncy, 1), qp, dtype=eff.dtype,
                                         device=dev), eff[:, :-1]], 1)
    else:
        # forward fill over the CTU raster
        posc = torch.arange(ncy * ncx, device=dev)
        ff = torch.cummax(torch.where(has_cbf.reshape(-1), posc, -1),
                          0).values
        eff = torch.where(ff >= 0, qp_map.reshape(-1)[ff.clamp(min=0)], qp)
        prev_eff = torch.cat([torch.full((1,), qp, dtype=eff.dtype,
                                         device=dev), eff[:-1]])
    z_g = _zscan_grid(r16, ncy, ncx, dev)
    cstart = torch.where(cu_depth == 2, z_g,
                         torch.where(cu_depth == 1, z_g // 4 * 4, 0))
    first = torch.where(cbf_any_g, cstart, r16 * r16).reshape(
        ncy, r16, ncx, r16).permute(0, 2, 1, 3).reshape(ncy, ncx, -1) \
        .amin(-1)

    def rep(m):
        return _rep2(m, r16)
    return torch.where(cstart < rep(first), rep(prev_eff.reshape(ncy, ncx)),
                       rep(qp_map))


@functools.lru_cache(maxsize=None)
def _zscan_grid(r16: int, ncy: int, ncx: int, device) -> torch.Tensor:
    """z-scan index of each 16-granule inside its CTU, [ncy*r16, ncx*r16]."""
    return torch.as_tensor(np.tile(tables.zscan_of_raster(r16), (ncy, ncx)),
                           device=device)


@functools.lru_cache(maxsize=None)
def _chroma_qp_table(device) -> torch.Tensor:
    return torch.as_tensor(tables.CHROMA_QP_TABLE, dtype=torch.int64,
                           device=device)


@functools.lru_cache(maxsize=None)
def _fallback_avail_np(bw: int, bh: int, s: int, geom=None) -> np.ndarray:
    """Per-block ADI availability [nb, 4s+1] of the fallback blocks at
    target block size s (16 luma, 8 chroma): z-scan neighbour segments
    of the 16-block grid (64x64 CTUs), clipped at the coded picture
    bounds geom = (step, cw, ch) in the target plane."""
    av = schedule.availability(bw, bh, 4)
    seg5 = np.stack([av["bottomleft"], av["left"], av["corner"], av["top"],
                     av["topright"]], -1).reshape(-1, 5)
    blk = intra_frame._avail_mask(seg5, s)
    if geom is not None:
        step, cwt, cht = geom
        idx = np.arange(blk.shape[0])
        px = (idx % bw) * step
        py = (idx // bw) * step
        j = np.arange(4 * s + 1)
        row = np.where(j < 2 * s, py[:, None] + 2 * s - 1 - j,
                       py[:, None] - 1)
        col = np.where(j <= 2 * s, px[:, None] - 1,
                       px[:, None] + (j - 2 * s - 1))
        blk = blk & (row < cht) & (col < cwt)
    return blk


@functools.lru_cache(maxsize=None)
def _fallback_avail(bw, bh, s, geom, device) -> torch.Tensor:
    return torch.as_tensor(_fallback_avail_np(bw, bh, s, geom),
                           device=device)


def _gather_adi_blocks(buf, py, px, size: int):
    """ADI L-shapes [k, 4S+1] of k blocks: one (2S+1)-square window
    gather per block (the window kernel), then its first column
    bottom-up and first row."""
    win = me._gather_windows(buf, py, px, 2 * size + 1)
    left = torch.flip(win[:, 1:2 * size + 1, 0], (-1,))
    return torch.cat([left, win[:, 0, :]], -1)


def _quadrants(device):
    """(dy, dx) [4] of the z-order quadrants of a block."""
    q = torch.arange(4, device=device)
    return q // 2, q % 2


def _neigh8(g: torch.Tensor) -> torch.Tensor:
    """OR of the 8 neighbours of each cell of a bool grid (zero pad)."""
    bh, bw = g.shape
    pad = torch.nn.functional.pad(g.to(torch.uint8), (1, 1, 1, 1)) \
        .to(torch.bool)
    out = torch.zeros_like(g)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                out = out | pad[1 + dy:1 + dy + bh, 1 + dx:1 + dx + bw]
    return out


def _dc_candidates(plane, cur_b, inter_sad, is_intra, inv, s, bh, bw, h,
                   w):
    """The fallback's DC proxy on a reconstruction plane [h, w]: (blocks
    whose DC-prediction SAD, from the first-ring sums of the edge-padded
    plane, beats 0.75 x the inter SAD, not intra yet and not invisible
    [nb] bool; their DC SAD [nb] int32)."""
    nb = bh * bw
    top = torch.cat([plane[:1], plane[s - 1:h - 1:s]], 0)       # [bh, w]
    left = torch.cat([plane[:, :1], plane[:, s - 1:w - 1:s]], 1)
    top_sum = top.reshape(bh, bw, s).sum(-1, dtype=torch.int32)
    left_sum = left.reshape(bh, s, bw).sum(1, dtype=torch.int32)
    dc = torch.div(top_sum + left_sum + s, 2 * s,
                   rounding_mode="floor").reshape(nb)
    dc_sad = (cur_b - dc[:, None, None]).abs().sum((-1, -2),
                                                   dtype=torch.int32)
    cand = (dc_sad.to(torch.float32)
            < 0.75 * inter_sad.to(torch.float32)) & (is_intra == 0)
    if inv is not None:
        cand = cand & ~inv
    return cand, dc_sad


@functools.lru_cache(maxsize=None)
def _coding_order(bw: int, bh: int, bpc: int, device) -> torch.Tensor:
    """Coding index of each block [nb] (CTU raster, z-order inside)."""
    return torch.as_tensor(schedule.coding_order(bw, bh, bpc).reshape(-1),
                           dtype=torch.int32, device=device)


def _put_window(buf, py, px, ok, blk):
    """In place: buf[1+py.., 1+px..] = blk [1, b, b] where ok [1, 1, 1],
    the origin (py, px) [1] read on the device."""
    r = torch.arange(blk.shape[-1], device=buf.device)
    rows = (1 + py + r)[:, None]
    cols = (1 + px + r)[None, :]
    buf[rows, cols] = torch.where(ok, blk, buf[rows, cols])[0]


def _serial_luma(cur_b, recon_y, level_y, cbf, is_intra, modes, inter_sad,
                 qp, avail, pos_y, pos_x, s, bh, bw, h, w, sbh_scan, serial,
                 inv, scaling):
    """The serial pass after the rounds: contiguous candidate regions
    (pan-entry strips, uncovered bands) leave no candidate isolated, so
    up to `serial` remaining candidates are committed one at a time in
    coding order (CTU raster, z-order inside; tiles not considered),
    each from the reconstruction its predecessors left.  Every step runs
    masked, with no host sync: a step whose candidate is not ok writes
    nothing.  Returns the updated (recon, level, cbf, is_intra, modes)
    and (sel, ok, mode) [cap] in coding order."""
    nb = bh * bw
    dev = cur_b.device
    cap = min(serial, nb)
    plane = _unblocks(recon_y, h, w)
    cand, dc_sad = _dc_candidates(plane, cur_b, inter_sad, is_intra, inv,
                                  s, bh, bw, h, w)
    # blocks whose recon a committed block's references may have read
    # stay inter (its 8-neighbourhood and itself)
    ig = is_intra.reshape(bh, bw).to(torch.bool)
    cand = cand & ~(_neigh8(ig) | ig).reshape(nb)
    gv, sel0 = topk_stable(torch.where(cand, inter_sad - dc_sad, -1), cap)
    ok0 = gv > 0
    rank = torch.where(ok0, _coding_order(bw, bh, 64 // s, dev)[sel0],
                       1 << 30)
    perm = torch.argsort(rank, stable=True)
    sel, ok = sel0[perm], ok0[perm]
    buf = torch.nn.functional.pad(plane.to(torch.int32),
                                  (1, s, 1, s)).contiguous()
    recon_y, level_y, cbf, is_intra, modes = (
        t.clone() for t in (recon_y, level_y, cbf, is_intra, modes))
    for i in range(cap):
        sl, okk = sel[i:i + 1], ok[i:i + 1]
        adi = intra.substitute_refs(
            _gather_adi_blocks(buf, pos_y[sl], pos_x[sl], s), avail[sl])
        preds = intra.predict_all_modes(adi, s, True)[0]      # [35, s, s]
        cur1 = cur_b[sl]
        sads = (preds - cur1).abs().sum((-1, -2), dtype=torch.int32)
        bst = torch.argmin(sads)[None]
        pred1 = preds[bst]
        lvl, rr = _tq(cur1 - pred1, s, qp[sl], True, sbh_scan, scaling)
        rec = (pred1 + rr).clamp(0, 255)
        okb = okk[:, None, None]
        recon_y[sl] = torch.where(okb, rec.to(recon_y.dtype), recon_y[sl])
        level_y[sl] = torch.where(okb, lvl.to(level_y.dtype), level_y[sl])
        cbf[sl] = torch.where(okk, (lvl != 0).any(-1).any(-1), cbf[sl])
        is_intra[sl] = torch.where(okk, 1, is_intra[sl])
        modes[sl] = torch.where(okk, bst.to(modes.dtype), modes[sl])
        _put_window(buf, pos_y[sl], pos_x[sl], okb, rec.to(buf.dtype))
    return (recon_y, level_y, cbf, is_intra, modes), (sel, ok, modes[sel])


def _intra_fallback_luma(cur_b, recon_y, level_y, cbf_y, inter_pred, qp,
                         s, bh, bw, h, w, sbh_scan, rounds, inv, geom,
                         scaling=False, serial: int = 0):
    """Luma of the intra fallback: up to _FALLBACK_CAP inter CUs per round
    become intra CUs, over `rounds` batched passes.  Candidates: blocks
    whose DC-prediction SAD beats 0.75 x the inter SAD and whose
    8-neighbourhood holds no other candidate (so their references are
    final); the best by SAD gain are compacted, searched over all 35
    modes from exact references, coded and scattered back.  With
    `serial` > 0 the serial pass (_serial_luma) follows the rounds.
    Returns (recon, level, cbf, is_intra [nb], modes [nb], round-0
    candidate count, per-round (sel, ok, mode), the serial pass's (sel,
    ok, mode) or None)."""
    nb = bh * bw
    kcap = min(_FALLBACK_CAP, nb)
    dev = cur_b.device
    avail = _fallback_avail(bw, bh, s, geom, dev)
    pos_y = torch.arange(bh, dtype=torch.int32,
                         device=dev).repeat_interleave(bw) * s
    pos_x = (torch.arange(bw, dtype=torch.int32, device=dev) * s).repeat(bh)
    inter_sad = (cur_b - inter_pred).abs().sum((-1, -2), dtype=torch.int32)
    is_intra = torch.zeros((nb,), dtype=torch.int32, device=dev)
    modes = torch.zeros((nb,), dtype=torch.int32, device=dev)
    cbf = cbf_y.reshape(-1)
    rounds_out = []
    cand_count = None
    for rnd in range(rounds):
        plane = _unblocks(recon_y, h, w)
        cand, dc_sad = _dc_candidates(plane, cur_b, inter_sad, is_intra, inv,
                                      s, bh, bw, h, w)
        if rnd == 0:
            cand_count = cand.sum(dtype=torch.int32)
        cgrid = cand.reshape(bh, bw)
        isolated = (cgrid & ~_neigh8(cgrid)).reshape(nb)
        gain = torch.where(isolated, inter_sad - dc_sad, -1)
        gv, sel = topk_stable(gain, kcap)
        ok = gv > 0
        # full 35-mode search on the selected blocks, from exact refs
        buf = torch.nn.functional.pad(plane.to(torch.int32),
                                      (1, s, 1, s)).contiguous()
        adi = intra.substitute_refs(
            _gather_adi_blocks(buf, pos_y[sel], pos_x[sel], s), avail[sel])
        preds = intra.predict_all_modes(adi, s, True)
        cur_sel = cur_b[sel]
        sads = (preds - cur_sel[:, None]).abs().sum((-1, -2),
                                                    dtype=torch.int32)
        best = torch.argmin(sads, -1)
        pred_sel = preds[torch.arange(kcap, device=dev), best]
        lvl, rr = _tq(cur_sel - pred_sel, s, qp[sel], True, sbh_scan,
                      scaling)
        rec = (pred_sel + rr).clamp(0, 255)
        recon_y = _put_rows(recon_y, sel, ok, rec)
        level_y = _put_rows(level_y, sel, ok, lvl)
        cbf = _put_rows(cbf, sel, ok, (lvl != 0).any(-1).any(-1))
        is_intra = _put_rows(is_intra, sel, ok, torch.ones_like(sel))
        modes = _put_rows(modes, sel, ok, best)
        rounds_out.append((sel, ok, best))
    serial_out = None
    if serial > 0:
        (recon_y, level_y, cbf, is_intra, modes), serial_out = _serial_luma(
            cur_b, recon_y, level_y, cbf, is_intra, modes, inter_sad, qp,
            avail, pos_y, pos_x, s, bh, bw, h, w, sbh_scan, serial, inv,
            scaling)
    return (recon_y, level_y, cbf.reshape(bh, bw), is_intra, modes,
            cand_count, rounds_out, serial_out)


def _intra_fallback_chroma(rec_blocks, orig_blocks, level_c, cbf_c, sel,
                           ok, best, cs, bh, bw, h, w, qp_c, scan, geom,
                           scaling=False):
    """Chroma (DM) of one fallback round in one plane, after the inter
    chroma pass, so its references are the final reconstruction (qp_c:
    per block [nb])."""
    dev = rec_blocks.device
    plane = _unblocks(rec_blocks, h // 2, w // 2)
    cbuf = torch.nn.functional.pad(plane.to(torch.int32),
                                   (1, cs, 1, cs)).contiguous()
    py = torch.div(sel, bw, rounding_mode="floor") * cs
    px = (sel % bw) * cs
    adi = intra.substitute_refs(
        _gather_adi_blocks(cbuf, py, px, cs),
        _fallback_avail(bw, bh, cs, geom, dev)[sel])
    pred = intra.predict_single_mode(adi, best, cs, False)
    lvl, rr = _tq(orig_blocks[sel] - pred, cs, qp_c[sel], True, scan,
                  scaling)
    rec = (pred + rr).clamp(0, 255)
    return (_put_rows(rec_blocks, sel, ok, rec),
            _put_rows(level_c, sel, ok, lvl),
            _put_rows(cbf_c.reshape(-1), sel, ok,
                      (lvl != 0).any(-1).any(-1)).reshape(bh, bw))


def _intra_fallback_chroma_serial(rec_blocks, orig_blocks, level_c, cbf_c,
                                  serial_out, cs, bh, bw, h, w, qp_c, scan,
                                  geom, scaling=False):
    """Chroma (DM) of the serial pass's blocks in one plane, one at a time
    in the luma pass's coding order, chaining the chroma reconstruction
    (the blocks may be adjacent); after every round's chroma."""
    sel, ok, best = serial_out
    dev = rec_blocks.device
    plane = _unblocks(rec_blocks, h // 2, w // 2)
    cbuf = torch.nn.functional.pad(plane.to(torch.int32),
                                   (1, cs, 1, cs)).contiguous()
    avail = _fallback_avail(bw, bh, cs, geom, dev)
    rec_blocks, level_c = rec_blocks.clone(), level_c.clone()
    cbf = cbf_c.reshape(-1).clone()
    for i in range(sel.shape[0]):
        sl, okk = sel[i:i + 1], ok[i:i + 1]
        py = torch.div(sl, bw, rounding_mode="floor") * cs
        px = (sl % bw) * cs
        adi = intra.substitute_refs(_gather_adi_blocks(cbuf, py, px, cs),
                                    avail[sl])
        pred = intra.predict_single_mode(adi, best[i:i + 1], cs, False)
        lvl, rr = _tq(orig_blocks[sl] - pred, cs, qp_c[sl], True, scan,
                      scaling)
        rec = (pred + rr).clamp(0, 255)
        okb = okk[:, None, None]
        rec_blocks[sl] = torch.where(okb, rec.to(rec_blocks.dtype),
                                     rec_blocks[sl])
        level_c[sl] = torch.where(okb, lvl.to(level_c.dtype), level_c[sl])
        cbf[sl] = torch.where(okk, (lvl != 0).any(-1).any(-1), cbf[sl])
        _put_window(cbuf, py, px, okb, rec.to(cbuf.dtype))
    return rec_blocks, level_c, cbf.reshape(bh, bw)


def _maybe_scene(sad_me, cand_count, h: int, w: int, n_bands: int = 1):
    """The cheap scene-change signals: many fallback candidates, or a
    mean ME cost above 6 per pixel (sad_me [h/16, w/16] float32, summed
    in XLA-CPU's order, band by band over n_bands row bands as the
    row-sharded reference sums it, and divided as the reference does,
    ops/f32)."""
    nb16 = (h // 16) * (w // 16)
    mean_sad_px = f32.band_sum(sad_me.reshape(h // 16, w // 16), n_bands) \
        * float(np.float32(1.0 / (h * w)))
    return (cand_count > nb16 // 4) | (mean_sad_px > 6.0)


def _intra_pref_count(cur, sad_me, cand_count, qpt, ctu: int,
                      n_bands: int = 1):
    """The frame's intra-preference count for the scene-change restart:
    blocks whose dense 35-mode SATD cost beats the ME cost, counted when
    the cheap signals suggest a scene change (_maybe_scene), else 0.  The
    dense pass always runs and the count is selected on the device: no
    host sync."""
    h, w = cur.shape
    sqrt_lam = torch.sqrt(rdbits.rd_lambda_f32(qpt, True))
    _, ip_cost = intra_frame._dense_best(cur, 16, ctu, sqrt_lam)
    count = (ip_cost.reshape(-1) < sad_me.reshape(-1)).sum(dtype=torch.int32)
    return torch.where(_maybe_scene(sad_me, cand_count, h, w, n_bands),
                       count, 0)


def _split8(cur, cur_b, ref_pad, mv, pred_sel, cost16, level_y, recon_y,
            cbf_y, is_intra, dil, inv16, qp_t, lam_t, sign_hiding,
            ref_sel=None, scaling=False, bands=None, row0: int = 0):
    """8x8 inter CUs: 16x16 blocks with divergent motion re-code as four
    8x8 CUs with their own MVs (+-3 integer pel around the CU's MV,
    keeping its subpel phase) and 8x8 TBs, when the RD with the split's
    header and MV bits beats the 16x16 winner.  Candidates: the
    _NXN_CAP eligible blocks of largest residual SAD.  With ref_sel [nb]
    (ref_pad then the stacked [2, Hp, Wp] pad) each sub-CU searches and
    predicts from its CU's reference.  On a row band (bands, a
    parallel.RowBands, and its pixel offset row0) the candidates are
    chosen over the whole frame's grid, so every band takes the blocks
    one device would.  Returns (nxn16 [nb], mv8 per 8x8 [4nb, 2], cbf8
    [4nb], level_y, recon_y, cbf_y, cost16)."""
    r8 = 3
    bh, bw = mv.shape[:2]
    nb = bh * bw
    dev = cur.device
    capb = min(_NXN_CAP, nb)
    bw8 = 2 * bw
    mv16_8 = _rep2(mv).reshape(-1, 2)                   # [4nb, 2]
    resid16 = (cur_b - pred_sel).abs().sum((-1, -2)).to(torch.float32)
    elig = (is_intra == 0) & ~dil.reshape(-1)
    if inv16 is not None:
        elig = elig & ~inv16
    key = torch.where(elig, resid16, -1.0)
    if bands is not None:
        key = bands.gather(key.reshape(bh, bw)).reshape(-1)
    kv_f, sel_gf = topk_stable(key, min(_NXN_CAP, key.shape[0]))
    keep = torch.zeros_like(key, dtype=torch.bool)
    keep[sel_gf] = kv_f > 0
    if bands is not None:
        keep = bands.band(keep.reshape(-1, bw)).reshape(-1)
    kb, bsel = topk_stable(torch.where(
        keep & elig, (1 << 30) - torch.arange(nb, device=dev), 0), capb)
    okb = kb > 0
    qdy, qdx = _quadrants(dev)
    byi = torch.div(bsel, bw, rounding_mode="floor")
    bxi = bsel % bw
    pu_sel = ((2 * byi[:, None] + qdy) * bw8
              + 2 * bxi[:, None] + qdx).reshape(-1)
    cur8 = _blocks(cur, 8)[pu_sel]                     # [4capb, 8, 8]
    p8y = (row0 + torch.div(pu_sel, bw8, rounding_mode="floor") * 8) \
        .to(torch.int32)
    p8x = ((pu_sel % bw8) * 8).to(torch.int32)
    mv16_q = mv16_8[pu_sel]
    g8y = me.REF_PAD + p8y + (mv16_q[:, 0] >> 2) - r8
    g8x = me.REF_PAD + p8x + (mv16_q[:, 1] >> 2) - r8
    if ref_sel is None:
        ref8 = None
        win8 = me._gather_windows(ref_pad, g8y, g8x, 8 + 2 * r8)
    else:
        ref8 = torch.repeat_interleave(ref_sel[bsel], 4)
        win8 = me._gather_windows_ref(ref_pad, ref8, g8y, g8x, 8 + 2 * r8)
    sads8 = me._stacked_window_sads(win8, cur8, 8, r8)
    mv8 = mv16_q + 4 * me._offsets(r8, dev)[torch.argmin(sads8, 0)]
    pred8 = me.mc_luma_at(ref_pad, p8y, p8x, mv8, 8, ref=ref8)

    def asm8(t):    # [4capb, 8, 8] quadrant-major -> [capb, 16, 16]
        return t.reshape(-1, 2, 2, 8, 8).permute(0, 1, 3, 2, 4) \
            .reshape(-1, 16, 16)

    sbh8 = tuple(tables.scan_order(8, tables.SCAN_DIAG)) \
        if sign_hiding else None
    qp_q = torch.repeat_interleave(qp_t[bsel], 4)
    lam_q = torch.repeat_interleave(lam_t[bsel], 4)
    lvl8, rr8 = _tq(cur8 - pred8, 8, qp_q, False, sbh8, scaling)
    rec8 = (pred8 + rr8).clamp(0, 255)
    lvl8, rec8 = _rd_zero(lvl8, rec8, pred8, cur8, lam_q, qp=qp_q)
    rec_nxn = asm8(rec8)
    lvl_nxn = asm8(lvl8)
    ssd_n = _ssd(rec_nxn, cur_b[bsel])
    mvd8 = mv8 - mv16_q
    cu_bits = 3.0 + torch.where((mvd8 == 0).all(-1), 2.0,
                                rdbits.mvd_bits(mvd8) + 4.0)
    rb_q = rdbits.residual_bits(lvl8, 8, qp=qp_q)
    bits16 = f32.row_sum((cu_bits + rb_q).reshape(-1, 4)) + 1.0
    cost_nxn = f32.fma(lam_t[bsel], bits16, ssd_n)
    diverged = (mvd8 != 0).any(-1).reshape(-1, 4).any(-1)
    take = okb & diverged & (cost_nxn < cost16[bsel])
    take4 = torch.repeat_interleave(take, 4)
    nxn16 = _put_rows(torch.zeros((nb,), dtype=torch.bool, device=dev),
                      bsel, take, take)
    level_y = _put_rows(level_y, bsel, take, lvl_nxn)
    recon_y = _put_rows(recon_y, bsel, take, rec_nxn)
    cbf_y = _put_rows(cbf_y.reshape(-1), bsel, take,
                      (lvl_nxn != 0).any(-1).any(-1)).reshape(bh, bw)
    cost16 = _put_rows(cost16, bsel, take, cost_nxn)
    mv8_pu = _put_rows(mv16_8, pu_sel, take4, mv8)
    cbf8q = _put_rows(torch.zeros((4 * nb,), dtype=torch.bool, device=dev),
                      pu_sel, take4, (lvl8 != 0).any(-1).any(-1))
    return nxn16, mv8_pu, cbf8q, level_y, recon_y, cbf_y, cost16


def _chroma_planes(*planes):
    """The edge-padded chroma reference planes, stacked: [U, V] with one
    reference, [U0, U1, V0, V1] with two."""
    cpad = me.REF_PAD // 2
    return torch.stack([me.pad_edge(p.to(torch.int32), cpad)
                        for p in planes]).contiguous()


def _chroma_plane_index(ref, n: int, device) -> torch.Tensor:
    """Plane index of each U then each V window in _chroma_planes' stack:
    [0]*n + [1]*n with one reference; the block's ref r ([n]) picks U_r
    (r) and V_r (2 + r) with two."""
    if ref is None:
        return torch.repeat_interleave(torch.arange(2, device=device), n)
    return torch.cat([ref, 2 + ref])


def _code_chroma(u32, v32, cplanes, mv_f, pos_y, pos_x, chroma16, qp_c,
                 lam_cs, cs: int, bh: int, bw: int, sbh_scan_c,
                 sign_hiding: bool, inv16, ref_sel=None, scaling=False):
    """Chroma coding at the final MVs (and references, ref_sel [nb]): one
    16x16 chroma TB where the luma TB is 32-wide, else four 8x8 TBs;
    both planes' MC windows come from ONE plane-indexed gather.  qp_c,
    lam_cs: per block [nb]; a 16x16 TB takes its 2x2 group's top-left
    block's.  Returns per-plane (levels, recon, cbf)."""
    dev = u32.device
    nb = bh * bw
    cpad = me.REF_PAD // 2
    cby = cpad + pos_y // 2 + (mv_f[:, 0] >> 3) - 1
    cbx = cpad + pos_x // 2 + (mv_f[:, 1] >> 3) - 1
    ri2 = _chroma_plane_index(ref_sel, nb, dev)
    cw2 = me._gather_windows_ref(cplanes, ri2, cby.repeat(2),
                                 cbx.repeat(2), cs + 3) \
        .reshape(2, nb, cs + 3, cs + 3)
    g2h, g2w = bh // 2, bw // 2
    scan16 = tuple(tables.scan_order(2 * cs, tables.SCAN_DIAG)) \
        if sign_hiding else None
    inv16g = None
    if inv16 is not None:
        ig = inv16.reshape(bh, bw)
        inv16g = (ig[::2, ::2] & ig[1::2, 1::2]).reshape(-1)
    ch16 = _rep2(chroma16)
    qp_cg = qp_c.reshape(g2h, 2, g2w, 2)[:, 0, :, 0].reshape(-1)
    lam_cg = lam_cs.reshape(g2h, 2, g2w, 2)[:, 0, :, 0].reshape(-1)

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
        lvl8, rr8 = _tq(cb - cpred, cs, qp_c, False, sbh_scan_c, scaling)
        rec8 = (cpred + rr8).clamp(0, 255)
        lvl8, rec8 = _rd_zero(lvl8, rec8, cpred, cb, lam_cs, inv=inv16,
                              qp=qp_c)
        pred16 = asm(cpred)
        orig16 = asm(cb)
        lvl16c, rr16c = _tq(orig16 - pred16, 2 * cs, qp_cg, False, scan16,
                            scaling)
        rec16c = (pred16 + rr16c).clamp(0, 255)
        lvl16c, rec16c = _rd_zero(lvl16c, rec16c, pred16, orig16, lam_cg,
                                  inv=inv16g, qp=qp_cg)
        cbf16c = (lvl16c != 0).any(-1).any(-1)
        sel16 = ch16.reshape(-1)[:, None, None]
        new_lvl = torch.where(sel16, tiles(lvl16c), lvl8)
        lvl_c.append(new_lvl)
        rec_c.append(torch.where(sel16, tiles(rec16c), rec8))
        cbf_c.append(torch.where(
            ch16, _rep2(cbf16c.reshape(g2h, g2w)),
            (new_lvl != 0).any(-1).any(-1).reshape(bh, bw)))
    return lvl_c, rec_c, cbf_c


def _split8_chroma(u32, v32, cplanes, nxn16, mv8_pu, pos_y, pos_x, lvl_c,
                   rec_c, cbf_c, qp_c, lam_cs, cs: int, bh: int,
                   bw: int, sign_hiding: bool, ref_sel=None,
                   scaling=False):
    """Chroma of the 8x8 split CUs: each sub-CU's 4x4 chroma TB, MC'd at
    its own MV (compacted to _NXN_CAP blocks), overwrites the TB8 result
    (qp_c, lam_cs: per block [nb]).  Returns (lvl_c, rec_c, cbf_c,
    per-8 chroma cbfs [2, 4nb])."""
    nb = bh * bw
    dev = u32.device
    capb = min(_NXN_CAP, nb)
    cpad = me.REF_PAD // 2
    kv, bsel = topk_stable(torch.where(
        nxn16, (1 << 30) - torch.arange(nb, device=dev), 0), capb)
    okb = kv > 0
    qdy, qdx = _quadrants(dev)
    byi = torch.div(bsel, bw, rounding_mode="floor")
    bxi = bsel % bw
    pu_idx = ((2 * byi[:, None] + qdy) * (2 * bw)
              + 2 * bxi[:, None] + qdx).reshape(-1)
    mv8s = mv8_pu[pu_idx]                               # [4capb, 2]
    puy = (pos_y[bsel][:, None] + qdy * 8).reshape(-1)
    pux = (pos_x[bsel][:, None] + qdx * 8).reshape(-1)
    cby = cpad + puy // 2 + (mv8s[:, 0] >> 3) - 1
    cbx = cpad + pux // 2 + (mv8s[:, 1] >> 3) - 1
    ri = _chroma_plane_index(
        None if ref_sel is None else torch.repeat_interleave(ref_sel[bsel], 4),
        4 * capb, dev)
    cw = me._gather_windows_ref(cplanes, ri, cby.repeat(2), cbx.repeat(2),
                                4 + 3)                  # [2*4capb, 7, 7]
    pn = interp.mc_chroma_phases(cw, (mv8s[:, 0] & 7).repeat(2),
                                 (mv8s[:, 1] & 7).repeat(2), 4)

    def quads(c):      # [capb, 8, 8] -> [capb*4, 4, 4]
        return c.reshape(-1, 2, 4, 2, 4).permute(0, 1, 3, 2, 4) \
            .reshape(-1, 4, 4)

    def unquads(q):    # [capb*4, 4, 4] -> [capb, 8, 8]
        return q.reshape(-1, 2, 2, 4, 4).permute(0, 1, 3, 2, 4) \
            .reshape(-1, 8, 8)

    orig4 = torch.cat([quads(_blocks(p, cs)[bsel]) for p in (u32, v32)])
    scan4 = tuple(tables.scan_order(4, tables.SCAN_DIAG)) \
        if sign_hiding else None
    qpc_sel = torch.repeat_interleave(qp_c[bsel], 4).repeat(2)
    lamc_sel = torch.repeat_interleave(lam_cs[bsel], 4).repeat(2)
    lvl4, rr4 = _tq(orig4 - pn, 4, qpc_sel, False, scan4, scaling)
    rec4 = (pn + rr4).clamp(0, 255)
    lvl4, rec4 = _rd_zero(lvl4, rec4, pn, orig4, lamc_sel, qp=qpc_sel)
    cbf4 = (lvl4 != 0).any(-1).any(-1)                 # [2*4capb]
    ok4 = torch.repeat_interleave(okb, 4)
    cbf8c = []
    for p in range(2):
        part = slice(4 * capb * p, 4 * capb * (p + 1))
        lvl_c[p] = _put_rows(lvl_c[p], bsel, okb, unquads(lvl4[part]))
        rec_c[p] = _put_rows(rec_c[p], bsel, okb, unquads(rec4[part]))
        cbf8c.append(_put_rows(
            torch.zeros((4 * nb,), dtype=torch.bool, device=dev), pu_idx,
            ok4, cbf4[part]))
        cbf_c[p] = _put_rows(cbf_c[p].reshape(-1), bsel, okb,
                             cbf4[part].reshape(capb, 4).any(-1)) \
            .reshape(bh, bw)
    return lvl_c, rec_c, cbf_c, cbf8c


def encode_p_frame(y, u, v, ref_y, ref_u, ref_v, qp: int, block: int = 16,
                   sign_hiding: bool = False, deblocking: bool = False,
                   sao_enabled: bool = False, ctu: int = 64,
                   intra_fallback: bool = False,
                   chroma_rd_scale: float = 1.0, chroma_qp_offset: int = 0,
                   me_precision: int = 2, me_subpel_r: int = 2, qp_map=None,
                   vis_h: int = None, vis_w: int = None,
                   merge_rounds: int = 2, fallback_rounds: int = 2,
                   fallback_serial: int = 0, quadtree_majority: bool = True,
                   inter_nxn: bool = False, true_size: bool = False,
                   wpp_substreams: bool = False, scaling_lists: bool = False,
                   ref2_y=None, ref2_u=None, ref2_v=None, has_ref2=None,
                   group=None, n_bands: int = 1) -> dict:
    """Encode one P frame against one or two references.  y/u/v:
    uint8/int32 CTU-padded planes; ref_*: int32 reconstructed (deblocked,
    SAO'd) reference planes of the same shapes; qp: the slice QP; qp_map:
    the per-CTU QPs [ctus_y, ctus_x] (a tensor; None = the slice QP
    everywhere).  ref2_*: the picture before ref_* (list0 index 1): ME
    runs on both and each 16-block takes ref 1 where its cost plus a
    sqrt(lambda)-priced ref_idx bin beats ref 0's; the pick flows through
    merge/skip, split8, the quadtree, chroma MC, deblocking and the
    record's ref_idx.  has_ref2 (a bool tensor, default True) masks the
    pick to ref 0 where the second reference does not exist yet.

    Row bands (the reference's axis_name body): with `group`, a process
    group of n_bands ranks, y/u/v are this rank's CTU-row band of the
    frame (band i on rank i) and the references are whole.  The
    cross-band points gather the bands in one collective each: the ME
    median, the merge candidates' neighbour fields, the intra fallback
    and the scene gate (run replicated on the gathered frame), the 8x8
    split's candidate cap (over the whole grid), frame assembly (with
    the RC distortion), the vertical deblocking pass (band-local, then
    gathered); the horizontal pass, SAO and packing run on the whole
    frame.  Every rank returns the whole frame's outputs, bit-identical
    to one device.  With group None and n_bands > 1, one device codes
    the whole frame as n_bands ranks would (the scene gate sums band by
    band).

    Returns a dict of tensors (recon planes, coefficient planes, mv,
    cbf, `packed`, `packed_full`; `ref_idx` with two references)."""
    hb, w = y.shape                   # the band (the frame unless sharded)
    dev = y.device
    sharded = group is not None
    bands = parallel.RowBands(group, n_bands)
    h = hb * n_bands if sharded else hb
    row0 = bands.index * hb           # the band's first pixel row
    s = block
    cs = block // 2
    bh, bw = hb // s, w // s
    nb = bh * bw
    BH, NB = h // s, (h // s) * bw    # the whole frame's block grid
    qp = int(qp)
    qp_c = int(tables.CHROMA_QP_TABLE[min(max(qp + chroma_qp_offset, 0),
                                          57)])
    # slice-QP lambdas: ME, the intra-preference count and SAO
    qpt = torch.full((), qp, dtype=torch.int64, device=dev)
    lam = rdbits.rd_lambda_f32(qpt, False)
    lam_c = rdbits.rd_lambda_f32(torch.full_like(qpt, qp_c), False)
    # per-16-block QPs and lambdas of every RD decision (the map is the
    # whole frame's; the band's rows are sliced out)
    ncy, ncx = h // ctu, w // ctu
    qp_map = torch.full((ncy, ncx), qp, dtype=torch.int64, device=dev) \
        if qp_map is None else torch.as_tensor(qp_map, dtype=torch.int64,
                                               device=dev)
    qp_t_full = _rep2(qp_map, ctu // s)                  # [BH, bw]
    qp_ct_full = _chroma_qp_table(dev)[
        (qp_t_full.reshape(-1) + chroma_qp_offset).clamp(0, 57)]
    qp_t = bands.band(qp_t_full).reshape(-1)
    qp_ct = bands.band(qp_ct_full)
    lam_t = rdbits.rd_lambda_f32(qp_t, False)
    lam_ct = rdbits.rd_lambda_f32(qp_ct, False)
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
        if ref2_y is not None:
            ref2_y = repad(ref2_y, ch8, cw8)
            ref2_u = repad(ref2_u, ch8 // 2, cw8 // 2)
            ref2_v = repad(ref2_v, ch8 // 2, cw8 // 2)
    geom_l = None if cw8 is None else (s, cw8, ch8)
    geom_c = None if cw8 is None else (cs, cw8 // 2, ch8 // 2)
    coded = None if cw8 is None else (cw8, ch8)
    cur = y.to(torch.int32)
    refy = ref_y.to(torch.int32)
    u32 = u.to(torch.int32)
    v32 = v.to(torch.int32)

    # the global-motion candidate sees the whole field
    median_fn = None
    if sharded:
        def median_fn(mv0):
            return me.field_median(bands.gather(mv0))
    multi_ref = ref2_y is not None
    ref_sel = None
    with stage("p.me"):
        mv, sad_me, pred = me.motion_estimate(cur, refy, block=s,
                                              precision=me_precision,
                                              subpel_r=me_subpel_r,
                                              sqrt_lam=torch.sqrt(lam),
                                              row0=row0, median_fn=median_fn)
        if multi_ref:
            ref2y = ref2_y.to(torch.int32)
            mv1, sad1, pred1 = me.motion_estimate(
                cur, ref2y, block=s, precision=me_precision,
                subpel_r=me_subpel_r, sqrt_lam=torch.sqrt(lam), row0=row0,
                median_fn=median_fn)
            # per-block reference pick: ref 1 pays a sqrt(lambda)-priced
            # ref_idx bin at the block's own lambda (sad_me stays ref 0's
            # cost: the intra-preference count reads it)
            pen = torch.sqrt(lam_t.reshape(bh, bw))
            sel = f32.fma(pen, 1.5, sad1) < sad_me
            if has_ref2 is not None:
                sel = sel & torch.as_tensor(has_ref2, device=dev)
            ref_sel = sel.to(torch.int32)
            mv = torch.where(sel[..., None], mv1, mv)
            pred = torch.where(sel.reshape(-1)[:, None, None], pred1, pred)
    pos_y = row0 + torch.arange(bh, dtype=torch.int32,
                                device=dev).repeat_interleave(bw) * s
    pos_x = (torch.arange(bw, dtype=torch.int32, device=dev) * s).repeat(bh)
    cur_b = _blocks(cur, s)
    inv_full = inv16 = None
    if vis_h is not None and vis_w is not None \
            and (vis_h < h or vis_w < w):
        iy = torch.arange(BH, device=dev) * s >= vis_h
        ix = torch.arange(bw, device=dev) * s >= vis_w
        inv_full = (iy[:, None] | ix[None, :]).reshape(-1)
        inv16 = bands.band(inv_full)
    ref_pad = me.pad_edge(refy, me.REF_PAD).contiguous()
    ref_pads = None
    if multi_ref:
        ref_pads = torch.stack([ref_pad, me.pad_edge(ref2y, me.REF_PAD)]) \
            .contiguous()

    with stage("p.merge"):
        # round 2 re-evaluates only the left/top candidates, built from
        # round 1's winners (and their references), from the whole
        # frame's fields
        mv_me, carry = mv, None
        for _ in range(merge_rounds):
            nrefs = None
            if ref_sel is None:
                mv_full = bands.gather(mv)
            else:
                mv_full, r_full = bands.gather(mv, ref_sel)
                nrefs = (bands.band(torch.cat([r_full[:, :1],
                                               r_full[:, :-1]], 1)),
                         bands.band(torch.cat([r_full[:1], r_full[:-1]], 0)))
            cands = [(bands.band(c), m)
                     for c, m in merge_candidate_fields(mv_full)]
            mv_flat, level_y, recon_y, pred_sel, cost16, carry = \
                _merge_skip_rd(cur_b, ref_pad, pos_y, pos_x, mv_me, pred,
                               qp_t, lam_t, s, sbh_scan, cands, inv=inv16,
                               carry_in=carry, ref_grid=ref_sel,
                               ref_pads=ref_pads, scaling=scaling_lists,
                               y0=row0, neigh_refs=nrefs)
            mv = mv_flat.reshape(bh, bw, 2)
            if multi_ref:
                ref_sel = carry["ref"].reshape(bh, bw)
    ref_flat = None if ref_sel is None else ref_sel.reshape(-1)
    ref_pad_sel = ref_pad if ref_pads is None else ref_pads
    cbf_y = (level_y != 0).any(-1).any(-1).reshape(bh, bw)

    # the intra fallback's state is the whole frame's (it runs replicated
    # on the gathered frame when sharded)
    is_intra_f = torch.zeros((NB,), dtype=torch.int32, device=dev)
    intra_modes = torch.zeros((NB,), dtype=torch.int32, device=dev)
    cand_count = torch.zeros((), dtype=torch.int32, device=dev)
    fb_rounds = []
    cur_full = None if sharded else cur
    if intra_fallback:
        full = bands.gather(cur_b, recon_y, level_y, cbf_y, pred_sel, sad_me)
        with stage("p.fallback"):
            (rec_f, lvl_f, cbf_f, is_intra_f, intra_modes, cand_count,
             fb_rounds, fb_serial) = _intra_fallback_luma(
                full[0], full[1], full[2], full[3], full[4],
                qp_t_full.reshape(-1), s, BH, bw, h, w, sbh_scan,
                fallback_rounds, inv_full, geom_l, scaling_lists,
                fallback_serial)
            recon_y = bands.band(rec_f)
            level_y = bands.band(lvl_f)
            cbf_y = bands.band(cbf_f)
        if sharded:
            cur_full = _unblocks(full[0], h, w)
        with stage("p.intra_pref"):
            cand_count = torch.maximum(
                cand_count, _intra_pref_count(cur_full, full[5], cand_count,
                                              qpt, ctu, n_bands))
    is_intra = bands.band(is_intra_f)

    # blocks whose recon a fallback block's references may have read stay
    # as they are through split8 and the quadtree
    ig = is_intra_f.reshape(BH, bw).to(torch.bool)
    dil = bands.band(_neigh8(ig) | ig)
    nxn16 = torch.zeros((nb,), dtype=torch.bool, device=dev)
    mv8_pu = cbf8q = None
    if inter_nxn:
        with stage("p.split8"):
            nxn16, mv8_pu, cbf8q, level_y, recon_y, cbf_y, cost16 = _split8(
                cur, cur_b, ref_pad_sel, mv, pred_sel, cost16, level_y,
                recon_y, cbf_y, is_intra, dil, inv16, qp_t, lam_t,
                sign_hiding, ref_sel=ref_flat, scaling=scaling_lists,
                bands=bands if sharded else None, row0=row0)

    with stage("p.quadtree"):
        mv, level_y, recon_y, cbf_y, cu_depth, tr_depth, chroma16 = \
            quadtree_consolidate(cur_b, pred_sel, mv, level_y, recon_y,
                                 cost16, dil.reshape(-1) | nxn16, qp_t,
                                 lam_t,
                                 bh, bw, sign_hiding, inv=inv16, coded=coded,
                                 ref_pad=ref_pad_sel if quadtree_majority
                                 else None, ref_flat=ref_flat,
                                 scaling=scaling_lists, y0=row0)
        # split blocks become four 8x8 CUs (depth 3, TU8 leaves)
        cu_depth = torch.where(nxn16.reshape(bh, bw), 3, cu_depth) \
            .to(torch.int32)
    mv_f = mv.reshape(-1, 2)

    lam_cs = lam_ct * chroma_rd_scale
    with stage("p.chroma"):
        cplanes = (_chroma_planes(ref_u, ref2_u, ref_v, ref2_v) if multi_ref
                   else _chroma_planes(ref_u, ref_v))
        lvl_c, rec_c, cbf_c = _code_chroma(
            u32, v32, cplanes, mv_f, pos_y, pos_x, chroma16, qp_ct, lam_cs,
            cs, bh, bw, sbh_scan_c, sign_hiding, inv16, ref_sel=ref_flat,
            scaling=scaling_lists)
        cbf8c = [torch.zeros((4 * nb,), dtype=torch.bool, device=dev)] * 2
        if inter_nxn:
            lvl_c, rec_c, cbf_c, cbf8c = _split8_chroma(
                u32, v32, cplanes, nxn16, mv8_pu, pos_y, pos_x, lvl_c,
                rec_c, cbf_c, qp_ct, lam_cs, cs, bh, bw, sign_hiding,
                ref_sel=ref_flat, scaling=scaling_lists)

    # RC distortion signal: the mean per-16-block luma SAD of the
    # unfiltered reconstruction (an exact integer sum over the bands)
    dsum = (recon_y - cur_b).abs().sum()
    out_y = _unblocks(recon_y, hb, w)
    if sharded:
        # frame assembly: the band's maps to the whole frame's (one
        # gather); the luma reconstruction follows its vertical deblock
        with stage("p.assemble"):
            parts = [level_y, lvl_c[0], lvl_c[1], rec_c[0], rec_c[1],
                     cbf_y, cbf_c[0], cbf_c[1], mv, cu_depth, tr_depth,
                     nxn16.reshape(bh, bw), u32, v32, dsum]
            if multi_ref:
                parts.append(ref_sel)
            if mv8_pu is not None:
                parts += [mv8_pu.reshape(2 * bh, 2 * bw, 2),
                          cbf8q.reshape(2 * bh, 2 * bw),
                          cbf8c[0].reshape(2 * bh, 2 * bw),
                          cbf8c[1].reshape(2 * bh, 2 * bw)]
            if cur_full is None:
                parts.append(cur)
            g = bands.gather(*parts)
            (level_y, lvl_c[0], lvl_c[1], rec_c[0], rec_c[1], cbf_y,
             cbf_c[0], cbf_c[1], mv, cu_depth, tr_depth, nxn16, u32, v32,
             dsum) = g[:15]
            dsum = dsum.sum()
            nxn16 = nxn16.reshape(-1)
            rest = iter(g[15:])
            if multi_ref:
                ref_sel = next(rest)
            if mv8_pu is not None:
                mv8_pu = next(rest).reshape(-1, 2)
                cbf8q, *cbf8c = (next(rest).reshape(-1) for _ in range(3))
            if cur_full is None:
                cur_full = next(rest)
        bh, nb = BH, NB
    dist16 = dsum // nb

    if intra_fallback:
        # per round, so a later round's references read the chroma the
        # earlier rounds committed (whole frame, replicated when sharded)
        with stage("p.fallback_chroma"):
            orig_c = [_blocks(u32, cs), _blocks(v32, cs)]
            for sel, ok, best in fb_rounds:
                for p in range(2):
                    rec_c[p], lvl_c[p], cbf_c[p] = _intra_fallback_chroma(
                        rec_c[p], orig_c[p], lvl_c[p], cbf_c[p], sel, ok,
                        best, cs, bh, bw, h, w, qp_ct_full, sbh_scan_c,
                        geom_c, scaling_lists)
            if fb_serial is not None:
                for p in range(2):
                    rec_c[p], lvl_c[p], cbf_c[p] = \
                        _intra_fallback_chroma_serial(
                            rec_c[p], orig_c[p], lvl_c[p], cbf_c[p],
                            fb_serial, cs, bh, bw, h, w, qp_ct_full,
                            sbh_scan_c, geom_c, scaling_lists)
    out_u = _unblocks(rec_c[0], h // 2, w // 2)
    out_v = _unblocks(rec_c[1], h // 2, w // 2)

    # per-8x8 sub-CU MVs and TB cbfs: split blocks keep their quadrants,
    # the rest replicate the CU's
    mv8_final = _rep2(mv).reshape(-1, 2)
    cbf8_y = _rep2(cbf_y).reshape(-1)
    cbf8_bits = torch.zeros((4 * nb,), dtype=torch.int32, device=dev)
    if mv8_pu is not None:
        nxn8f = _rep2(nxn16.reshape(bh, bw)).reshape(-1)
        mv8_final = torch.where(nxn8f[:, None], mv8_pu, mv8_final)
        cbf8_y = torch.where(nxn8f, cbf8q, cbf8_y)
        cbf8_bits = ((nxn8f & cbf8q).to(torch.int32)
                     | (cbf8c[0].to(torch.int32) << 1)
                     | (cbf8c[1].to(torch.int32) << 2))

    if deblocking:
        with stage("p.deblock"):
            qp_g16 = _effective_qp16(qp, qp_map, cbf_y | cbf_c[0] | cbf_c[1],
                                     cu_depth, ctu, s, wpp_substreams)
            ii = is_intra_f.reshape(bh, bw) if intra_fallback else None
            tb2 = (tr_depth == 0) & (cu_depth == 1) | (cu_depth == 0)
            bs_v, bs_h = inter_boundary_strength(
                cbf_y, mv, s, h, w, is_intra=ii, tb2=tb2,
                mv8=mv8_final.reshape(2 * bh, 2 * bw, 2) if inter_nxn
                else None,
                nxn=nxn16.reshape(bh, bw) if inter_nxn else None,
                cbf8=cbf8_y.reshape(2 * bh, 2 * bw) if inter_nxn else None,
                ref=ref_sel)
            if coded is not None:
                bs_v[:, coded[0] // 8:] = 0
                bs_h[coded[1] // 8:, :] = 0
            qp_v, qp_h = _edge_qp_maps(qp_g16, h, w, 16)
            # the vertical pass is row-local: each band filters its rows
            out_y = bands.gather(deblock._luma_pass(
                out_y, bands.band(bs_v), bands.band(qp_v)))
            out_y = deblock._luma_pass(out_y.T.contiguous(), bs_h.T,
                                       qp_h.T).T.contiguous()
            if intra_fallback:
                # chroma filters only BS 2 edges (intra-adjacent)
                bs_vc, bs_hc = chroma_boundary_strength(ii, s, h // 2,
                                                        w // 2)
                if coded is not None:
                    bs_vc[:, coded[0] // 16:] = 0
                    bs_hc[coded[1] // 16:, :] = 0
                qpcv, qpch = _edge_qp_maps(qp_g16, h, w, 16,
                                           chroma_qp_offset)
                out_u, out_v = (
                    deblock._chroma_pass(deblock._chroma_pass(
                        p, bs_vc, qpcv).T.contiguous(), bs_hc.T,
                        qpch.T).T.contiguous() for p in (out_u, out_v))
    else:
        out_y = bands.gather(out_y)

    sao_fields = None
    if sao_enabled:
        with stage("p.sao"):
            out_y, out_u, out_v, sao_fields = sao.sao_frame(
                cur_full, u32, v32, out_y, out_u, out_v, lam, lam_c, ctu,
                coded=None if cw8 is None else (ch8, cw8))

    cbf = torch.stack([cbf_y, cbf_c[0], cbf_c[1]]).to(torch.int32)
    out = dict(recon_y=out_y, recon_u=out_u, recon_v=out_v,
               coeff_y=_unblocks(level_y, h, w).to(torch.int16),
               coeff_cb=_unblocks(lvl_c[0], h // 2, w // 2).to(torch.int16),
               coeff_cr=_unblocks(lvl_c[1], h // 2, w // 2).to(torch.int16),
               mv=mv, cbf=cbf)
    if multi_ref:
        out["ref_idx"] = ref_sel
    cap_y, cap_c, esc_y, esc_c = p_caps(nb)
    cap_ys, cap_cs, esc_ys, esc_cs = p_caps_small(nb)
    with stage("p.pack"):
        pk_y_s, pk_y_f = packing.compact_blocks_i8_tiers(
            level_y, [(cap_ys, esc_ys), (cap_y, esc_y)])
        pk_u_s, pk_u_f = packing.compact_blocks_i8_tiers(
            lvl_c[0], [(cap_cs, esc_cs), (cap_c, esc_c)])
        pk_v_s, pk_v_f = packing.compact_blocks_i8_tiers(
            lvl_c[1], [(cap_cs, esc_cs), (cap_c, esc_c)])
        # split-CU sidebands: per-8 MV deltas vs the CU MV as int8 pairs
        # (dy | dx << 8), and the four sub-CUs' 3-bit TB-cbf fields in
        # one int16 per 16-block
        d8 = mv8_final - _rep2(mv).reshape(-1, 2)
        mvd8_pk = (d8[:, 0] & 0xFF) | ((d8[:, 1] & 0xFF) << 8)
        mvd8_pk = torch.where(mvd8_pk >= 1 << 15, mvd8_pk - (1 << 16),
                              mvd8_pk)
        c8g = cbf8_bits.reshape(bh, 2, bw, 2)
        cbf8_blk = (c8g[:, 0, :, 0] | (c8g[:, 0, :, 1] << 3)
                    | (c8g[:, 1, :, 0] << 6) | (c8g[:, 1, :, 1] << 9))
        i16 = dict(dtype=torch.int16, device=dev)
        parts = [mv.to(torch.int16).reshape(-1),
                 (torch.zeros((nb,), **i16) if ref_sel is None
                  else ref_sel.to(torch.int16).reshape(-1)),
                 cbf.to(torch.int16).reshape(-1),
                 is_intra_f.to(torch.int16),
                 intra_modes.to(torch.int16),
                 cu_depth.to(torch.int16).reshape(-1),
                 tr_depth.to(torch.int16).reshape(-1),
                 mvd8_pk.to(torch.int16),
                 cbf8_blk.to(torch.int16).reshape(-1),
                 cand_count.to(torch.int16)[None],
                 dist16.clamp(0, 32767).to(torch.int16)[None],
                 pk_y_s, pk_u_s, pk_v_s]
        if sao_fields is not None:
            parts.append(sao.pack_sao_fields(sao_fields))
        out["packed"] = torch.cat(parts)
        out["packed_full"] = torch.cat([pk_y_f, pk_u_f, pk_v_f])
    return out


def encode_p_chunk(ys, us, vs, ref_y, ref_u, ref_v, qp, qp_maps=None,
                   ref2_y=None, ref2_u=None, ref2_v=None, has_ref2=None,
                   group=None, n_bands: int = 1, **flags) -> dict:
    """K consecutive P frames, each predicted from the previous one's
    reconstruction.  ys uint8/int32 [K, H, W]; qp int or K ints; qp_maps
    None or a tensor of K per-CTU QP maps [K, ctus_y, ctus_x].  With
    ref2_* (the picture before ref_*) each frame also predicts from the
    one two back; has_ref2 [K] bool (a tensor) masks the frames whose
    second reference does not exist yet.  Returns dict(recon_* of the
    last frame, recon2_* of the one before with two references,
    packed [K, L], packed_full [K, L2], coeff_* [K, ...]).

    Row bands: with `group` (n_bands ranks, every one passing the whole
    chunk) each rank codes its CTU-row band of every frame against the
    whole references, and every output is the whole frame's on every
    rank (encode_p_frame's group mode); n_bands > 1 without a group codes
    on this device what n_bands ranks would."""
    k = ys.shape[0]
    assert (ys.shape[1] // n_bands) % flags.get("ctu", 64) == 0, \
        "band height must be CTU-aligned"
    bands = parallel.RowBands(group, n_bands)
    qps = [int(qp)] * k if np.ndim(qp) == 0 else [int(q) for q in qp]
    ref = (ref_y, ref_u, ref_v)
    ref2 = None if ref2_y is None else (ref2_y, ref2_u, ref2_v)
    per = []
    for j in range(k):
        kw = {}
        if ref2 is not None:
            kw = dict(ref2_y=ref2[0], ref2_u=ref2[1], ref2_v=ref2[2],
                      has_ref2=None if has_ref2 is None else has_ref2[j])
        with stage("p.frame"):
            out = encode_p_frame(
                bands.band(ys[j]), bands.band(us[j]), bands.band(vs[j]),
                *ref, qp=qps[j],
                qp_map=None if qp_maps is None else qp_maps[j], group=group,
                n_bands=n_bands, **kw, **flags)
        if ref2 is not None:
            ref2 = ref
        ref = (out["recon_y"], out["recon_u"], out["recon_v"])
        per.append(out)
    res = dict(recon_y=ref[0], recon_u=ref[1], recon_v=ref[2])
    if ref2 is not None:
        res.update(recon2_y=ref2[0], recon2_u=ref2[1], recon2_v=ref2[2])
    for key in ("packed", "packed_full", "coeff_y", "coeff_cb", "coeff_cr"):
        res[key] = torch.stack([o[key] for o in per])
    return res


def encode_p_chunk_packed(buf, ref_y, ref_u, ref_v, *, k: int, vis_h: int,
                          vis_w: int, ctu: int, qp, qp_maps=None,
                          ref2_y=None, ref2_u=None, ref2_v=None,
                          has_ref2=None, **flags) -> dict:
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
                          qp_maps=qp_maps, ref2_y=ref2_y, ref2_u=ref2_u,
                          ref2_v=ref2_v, has_ref2=has_ref2, vis_h=vis_h,
                          vis_w=vis_w, ctu=ctu, **flags)
