"""Batched motion estimation: coarse pyramid full search, full-res
refinement, global-median arbitration and dense subpel search.

Port of homerhevc_tpu/ops/me.py.  The per-block window reads go through
the hand-written gather kernel (ops/kernels.gather_windows*), the coarse
full searches through the slab-search kernel.  MVs are quarter-pel,
(y, x) order; all pixel arithmetic is integer, and the sqrt(lambda)
priced costs are float32 in the reference's order (ops/f32.fma).
"""
from __future__ import annotations

import torch

from homerhevc_torch.ops import f32, interp, kernels, rdbits

REF_PAD = 144
COARSE_RY = 8
COARSE_RX = 16
REFINE_R = 3


def pad_edge(x: torch.Tensor, py: int, px: int = None) -> torch.Tensor:
    """Edge-replicate padding of the last two axes (index clamping)."""
    px = py if px is None else px
    h, w = x.shape[-2:]
    rows = torch.arange(-py, h + py, device=x.device).clamp(0, h - 1)
    cols = torch.arange(-px, w + px, device=x.device).clamp(0, w - 1)
    return x.index_select(-2, rows).index_select(-1, cols)


def block_sum(x: torch.Tensor, b: int) -> torch.Tensor:
    """[H, W] -> [H/b, W/b] block sums (exact int32)."""
    h, w = x.shape
    return x.reshape(h // b, b, w // b, b).sum((1, 3), dtype=torch.int32)


def blocks(plane: torch.Tensor, b: int) -> torch.Tensor:
    """[H, W] -> [nb, b, b] raster-ordered blocks."""
    h, w = plane.shape
    return plane.reshape(h // b, b, w // b, b).permute(0, 2, 1, 3) \
        .reshape(-1, b, b)


def _gather_windows(ref_pad, base_y, base_x, size: int):
    return kernels.gather_windows(ref_pad, base_y.to(torch.int32)
                                  .contiguous(),
                                  base_x.to(torch.int32).contiguous(), size)


def _gather_windows_ref(ref_pads, ref, base_y, base_x, size: int):
    return kernels.gather_windows_ref(
        ref_pads, ref.to(torch.int32).contiguous(),
        base_y.to(torch.int32).contiguous(),
        base_x.to(torch.int32).contiguous(), size)


def _slab_search(cur_s, ref_s, bs: int, ry: int, rx: int, row0: int = 0):
    """Full search of cur_s (blocks of bs) against ref_s over
    [-ry, ry] x [-rx, rx]; |mv| tie-break.  Returns [bh, bw, 2] int32."""
    h, _ = cur_s.shape
    slab = pad_edge(ref_s, ry, rx)[row0:row0 + h + 2 * ry].contiguous()
    best = kernels.slab_search(cur_s.contiguous(), slab, bs, ry, rx)
    dy = torch.div(best, 2 * rx + 1, rounding_mode="floor") - ry
    dx = best % (2 * rx + 1) - rx
    return torch.stack([dy, dx], -1).to(torch.int32)


def _offsets(r: int, device) -> torch.Tensor:
    return torch.tensor([(dy, dx) for dy in range(-r, r + 1)
                         for dx in range(-r, r + 1)], dtype=torch.int32,
                        device=device)


def _stacked_window_sads(win, cur_b, bs: int, r: int):
    """SADs of every (dy, dx) in [-r, r]^2 between win[:, r+dy.., r+dx..]
    and cur_b plus the |dy|+|dx| tie-break: [(2r+1)^2, n] int32."""
    k = 2 * r + 1
    wins = win.unfold(1, bs, 1).unfold(2, bs, 1)        # [n, k, k, bs, bs]
    sads = (wins - cur_b[:, None, None]).abs().sum((-1, -2),
                                                    dtype=torch.int32)
    sads = sads.reshape(-1, k * k).T
    pen = _offsets(r, win.device).abs().sum(-1, dtype=torch.int32)
    return sads + pen[:, None]


def _gather_refine(cur_s, ref_s, bs: int, r: int, base, row0: int,
                   max_base: int):
    """+-r refinement around per-block base MVs [bh, bw, 2]."""
    h, w = cur_s.shape
    bh, bw = h // bs, w // bs
    dev = cur_s.device
    pos_y = row0 + torch.arange(bh, dtype=torch.int32,
                                device=dev).repeat_interleave(bw) * bs
    pos_x = (torch.arange(bw, dtype=torch.int32, device=dev) * bs).repeat(bh)
    bflat = base.reshape(-1, 2)
    off0 = r + max_base
    big = pad_edge(ref_s, off0).contiguous()
    win = _gather_windows(big, off0 + pos_y + bflat[:, 0] - r,
                          off0 + pos_x + bflat[:, 1] - r, bs + 2 * r)
    sads = _stacked_window_sads(win, blocks(cur_s, bs), bs, r)
    best = torch.argmin(sads, 0)
    return (bflat + _offsets(r, dev)[best]).reshape(bh, bw, 2)


def coarse_search(cur, ref, block: int, row0: int = 0):
    """Two coarse MV candidate chains [2, bh, bw, 2] (full-res pel):
    [0] zero-anchored half-res search, [1] eighth-res slab search refined
    at half res."""
    cur_h = block_sum(cur, 2)
    ref_h = block_sum(ref, 2)
    cur_e = block_sum(cur, 8)
    ref_e = block_sum(ref, 8)
    mv_e = _slab_search(cur_e, ref_e, block // 8, COARSE_RY, COARSE_RX,
                        row0 // 8)
    mv_h = _gather_refine(cur_h, ref_h, block // 2, 6, mv_e * 4,
                          row0 // 2, max_base=4 * COARSE_RX + 8)
    z_h = _slab_search(cur_h, ref_h, block // 2, 3, 3, row0 // 2)
    return torch.stack([z_h * 2, mv_h * 2])


def subpel_search(cur_blocks, ref_pad, pos_y, pos_x, mv_int, block: int,
                  precision: int, r: int, anchor, sqrt_lam):
    """Dense subpel search over every quarter-pel offset in [-r, r]^2
    around mv_int, priced as SAD + sqrt(lambda) * MVD bits against
    anchor.  Returns (quarter-pel MV [n, 2], cost [n] float32,
    prediction [n, B, B])."""
    dev = cur_blocks.device
    win9 = _gather_windows(ref_pad, REF_PAD + pos_y + mv_int[:, 0] - 4,
                           REF_PAD + pos_x + mv_int[:, 1] - 4, block + 9)
    step = {0: 4, 1: 2, 2: 1}[precision]
    offs = [(dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1)
            if dy % step == 0 and dx % step == 0]
    taps = interp._filters(True, dev)
    hstage = {}
    for _, dx in offs:
        if dx not in hstage:
            hstage[dx] = interp.fir_h(win9, taps[dx & 3], block,
                                      (dx >> 2) + 1)
    preds = torch.stack([interp.finish_uni(interp.fir_v(
        hstage[dx], taps[dy & 3], block, (dy >> 2) + 1))
        for dy, dx in offs])                            # [P, n, B, B]
    sads = (preds - cur_blocks[None]).abs().sum(
        (-1, -2), dtype=torch.int32).to(torch.float32)  # [P, n]
    offs_t = torch.tensor(offs, dtype=torch.int32, device=dev)
    mvd = mv_int[None] * 4 + offs_t[:, None] - anchor[None] * 4
    sads = f32.fma(sqrt_lam, rdbits.mvd_bits(mvd), sads)
    best = torch.argmin(sads, 0)
    n = cur_blocks.shape[0]
    sad = sads[best, torch.arange(n, device=dev)]
    pred = preds[best, torch.arange(n, device=dev)]
    return mv_int * 4 + offs_t[best], sad, pred


def mc_luma_at(ref_pad, pos_y, pos_x, mv, block: int, ref=None):
    """MC prediction at per-block quarter-pel MVs (one window gather);
    with `ref` [n], ref_pad is a stacked [R, Hp, Wp] pad."""
    by = REF_PAD + pos_y + (mv[:, 0] >> 2) - 3
    bx = REF_PAD + pos_x + (mv[:, 1] >> 2) - 3
    if ref is None:
        win = _gather_windows(ref_pad, by, bx, block + 7)
    else:
        win = _gather_windows_ref(ref_pad, ref, by, bx, block + 7)
    return interp.mc_separable_phases(win, mv[:, 0] & 3, mv[:, 1] & 3,
                                      block, True)


def field_median(mv_grid: torch.Tensor) -> torch.Tensor:
    """Component-wise median MV of a [..., 2] field: the mean of the two
    middle values for an even count (jnp.median), truncated to int32."""
    v = mv_grid.reshape(-1, 2).to(torch.float32)
    s = torch.sort(v, 0).values
    n = s.shape[0]
    lo, hi = s[(n - 1) // 2], s[n // 2]
    return ((lo + hi) * 0.5).to(torch.int32)


def motion_estimate(cur: torch.Tensor, ref: torch.Tensor, sqrt_lam,
                    block: int = 16, precision: int = 2, subpel_r: int = 2,
                    row0: int = 0, median_fn=None):
    """Full ME pipeline, priced with sqrt(lambda) (the encoder's use; the
    reference's unpriced variant is not ported).  cur/ref int32 [H, W];
    cur may be a row band of ref starting at pixel row `row0`, and then
    `median_fn` gives the global-motion candidate from the whole field
    (the row-sharded path passes one that gathers the bands' fields).
    Returns (mv_q [bh, bw, 2], cost [bh, bw] float32, pred [n, B, B])."""
    h, w = cur.shape
    bh, bw = h // block, w // block
    n = bh * bw
    dev = cur.device
    cands = coarse_search(cur, ref, block, row0=row0)   # [2, bh, bw, 2]
    ref_pad = pad_edge(ref, REF_PAD).contiguous()
    pos_y = row0 + torch.arange(bh, dtype=torch.int32,
                                device=dev).repeat_interleave(bw) * block
    pos_x = (torch.arange(bw, dtype=torch.int32, device=dev)
             * block).repeat(bh)
    cur_blocks = blocks(cur, block)
    r = REFINE_R
    bases = cands.reshape(-1, 2)                        # [2n, 2]
    win = _gather_windows(ref_pad,
                          REF_PAD + pos_y.repeat(2) + bases[:, 0] - r,
                          REF_PAD + pos_x.repeat(2) + bases[:, 1] - r,
                          block + 2 * r)
    sads = _stacked_window_sads(win, cur_blocks.repeat(2, 1, 1), block, r)
    k2 = (2 * r + 1) ** 2
    sads2 = sads.reshape(k2, 2, n) \
        + bases.abs().sum(-1, dtype=torch.int32).reshape(2, n)[None]
    flat = sads2.reshape(k2 * 2, n)
    best = torch.argmin(flat, 0)
    sad0 = flat.amin(0)
    mv_all = (bases.reshape(2, n, 2)[None]
              + _offsets(r, dev)[:, None, None]).reshape(k2 * 2, n, 2)
    mv0 = mv_all[best, torch.arange(n, device=dev)]

    med = (median_fn or field_median)(mv0.reshape(bh, bw, 2))
    # one whole-plane slice at the median (start clamped into the pad,
    # as a dynamic slice clamps it)
    ys = (REF_PAD + row0 + med[0]).clamp(0, ref_pad.shape[0] - h) \
        + torch.arange(h, device=dev)
    xs = (REF_PAD + med[1]).clamp(0, ref_pad.shape[1] - w) \
        + torch.arange(w, device=dev)
    med_plane = ref_pad.index_select(0, ys).index_select(1, xs)
    sad_med = (blocks(med_plane, block) - cur_blocks).abs().sum(
        (-1, -2), dtype=torch.int32)
    c0 = f32.fma(sqrt_lam, rdbits.mvd_bits(4 * (mv0 - med[None])),
                 sad0.to(torch.float32))
    cm = f32.fma(sqrt_lam, rdbits.mvd_bits(
        torch.zeros((1, 2), dtype=torch.int32, device=dev)),
        sad_med.to(torch.float32))
    take_med = cm < c0
    mv1 = torch.where(take_med[:, None], med[None], mv0)
    mv2, sad, pred = subpel_search(cur_blocks, ref_pad, pos_y, pos_x, mv1,
                                   block, precision, subpel_r, anchor=med,
                                   sqrt_lam=sqrt_lam)
    return mv2.reshape(bh, bw, 2), sad.reshape(bh, bw), pred
