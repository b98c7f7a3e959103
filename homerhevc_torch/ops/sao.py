"""Sample-adaptive offset (SAO), frame-batched encoder side.

Port of homerhevc_tpu/ops/sao.py: class maps and per-CTU statistics as
dense passes, iterate-toward-zero offsets, per-CTU mode decision, the
two-pass merge-left / merge-up adoption, and the spec 8.7.3 apply.  The
float32 costs follow the reference's evaluation order (ops/f32).

`sao_frame` takes three CUDA kernels (csrc/sao.cu, through
ops.kernels) for planes on the card and the plain version,
`sao_frame_plain`, for planes on the CPU; both give the same bytes.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from homerhevc_torch.models.schedule import tile_bounds
from homerhevc_torch.ops import f32, kernels

_EO_NEIGHBORS = ((0, -1, 0, 1), (-1, 0, 1, 0), (-1, -1, 1, 1),
                 (-1, 1, 1, -1))
_MERGE_FLAG_BITS = 0.9


def _shift(p, dy, dx):
    return torch.roll(p, (-dy, -dx), (0, 1))


def eo_class_maps(rec: torch.Tensor, bounds=None):
    """(cls [4, H, W] int32 in 0..4, valid [4, H, W] bool)."""
    h, w = rec.shape
    bh, bw = bounds if bounds is not None else (h, w)
    dev = rec.device
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    cls_all, valid_all = [], []
    for (ady, adx, bdy, bdx) in _EO_NEIGHBORS:
        a = _shift(rec, ady, adx)
        b = _shift(rec, bdy, bdx)
        raw = 2 + torch.sign(rec - a) + torch.sign(rec - b)
        mapped = torch.where(raw == 2, 0, torch.where(raw < 2, raw + 1, raw))
        ok = ((yy + ady >= 0) & (yy + ady < bh) & (xx + adx >= 0)
              & (xx + adx < bw) & (yy + bdy >= 0) & (yy + bdy < bh)
              & (xx + bdx >= 0) & (xx + bdx < bw))
        cls_all.append(mapped.to(torch.int32))
        valid_all.append(ok)
    return torch.stack(cls_all), torch.stack(valid_all)


def _ctu_sum(x: torch.Tensor, ctb: int) -> torch.Tensor:
    """[..., H, W] -> [..., H/ctb, W/ctb] block sums (exact int32)."""
    h, w = x.shape[-2:]
    return x.reshape(*x.shape[:-2], h // ctb, ctb, w // ctb, ctb) \
        .sum((-3, -1), dtype=torch.int32)


def sao_stats(org, rec, ctb: int, bounds=None):
    """(eo_diff, eo_cnt [4, 5, by, bx], bo_diff, bo_cnt [32, by, bx],
    cls, valid)."""
    cls, valid = eo_class_maps(rec, bounds)
    diff = (org - rec).to(torch.int32)
    cats = torch.arange(5, dtype=torch.int32, device=rec.device)
    oh = ((cls[None] == cats[:, None, None, None]) & valid[None]) \
        .to(torch.int32)                                # [5, 4, H, W]
    eo_diff = _ctu_sum(diff[None, None] * oh, ctb).transpose(0, 1)
    eo_cnt = _ctu_sum(oh, ctb).transpose(0, 1)
    bands = torch.arange(32, dtype=torch.int32, device=rec.device)
    ohb = ((rec >> 3)[None] == bands[:, None, None]).to(torch.int32)
    bo_diff = _ctu_sum(diff[None] * ohb, ctb)
    bo_cnt = _ctu_sum(ohb, ctb)
    return eo_diff, eo_cnt, bo_diff, bo_cnt, cls, valid


def _floordiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _best_offset(diff, cnt, lam, sign):
    """Iterate-toward-zero offset choice; sign +1 / -1 clip the offset's
    sign (EO categories), 0 = BO (free sign, priced).  Returns
    (offset, cost)."""
    init = torch.where(cnt > 0, _floordiv(diff + torch.sign(diff)
                                          * _floordiv(cnt, 2),
                                          torch.clamp(cnt, min=1)),
                       torch.zeros_like(diff))
    init = init.clamp(-7, 7)
    if isinstance(sign, torch.Tensor):
        init = torch.where(sign > 0, init.clamp(0, 7), init.clamp(-7, 0))
        bo = False
    else:
        if sign > 0:
            init = init.clamp(0, 7)
        elif sign < 0:
            init = init.clamp(-7, 0)
        bo = sign == 0
    best_o = torch.zeros_like(init)
    best_c = torch.zeros(diff.shape, dtype=torch.float32, device=diff.device)
    for mag in range(1, 8):
        o = torch.sign(init) * mag
        dist = (cnt * o * o - 2 * diff * o).to(torch.float32)
        rate = mag + 1.0 - (mag == 7) + (1.0 if bo else 0.0)
        cost = f32.fma(lam, rate, dist)
        take = (mag <= init.abs()) & (cost < best_c)
        best_o = torch.where(take, o, best_o)
        best_c = torch.where(take, cost, best_c)
    return best_o, best_c


def derive_params(stats, lam, secondary: bool = False):
    """Per-CTU mode decision for one component's stats."""
    eo_diff, eo_cnt, bo_diff, bo_cnt = stats
    dev = eo_diff.device
    sgn = torch.tensor([1, 1, -1, -1], dtype=torch.int32,
                       device=dev)[:, None, None, None]
    o4, c4 = _best_offset(eo_diff[:, 1:5].transpose(0, 1),
                          eo_cnt[:, 1:5].transpose(0, 1), lam, sgn)
    eo_off = o4.permute(1, 2, 3, 0)                      # [4, by, bx, 4]
    eo_rate = 0.0 if secondary else 4.0
    eo_cost = f32.fma(lam, eo_rate, ((c4[0] + c4[1]) + c4[2]) + c4[3])
    bo_o, bo_c = _best_offset(bo_diff, bo_cnt, lam, 0)   # [32, by, bx]
    cs = f32.cumsum0(torch.cat([torch.zeros_like(bo_c[:1]), bo_c]))
    win = cs[4:33] - cs[0:29]                            # [29, by, bx]
    band_pos = torch.argmin(win, 0).to(torch.int32)
    bo_rate = 5.0 if secondary else 7.0
    bo_cost = f32.fma(lam, bo_rate, win.amin(0))
    bo_off = torch.stack(
        [torch.gather(bo_o, 0, (band_pos + k)[None].long())[0]
         for k in range(4)], -1)                         # [by, bx, 4]
    off_rate = 0.0 if secondary else 1.0
    off_cost = (lam * off_rate).expand(band_pos.shape)
    return dict(eo_off=eo_off, eo_cost=eo_cost, bo_off=bo_off,
                bo_cost=bo_cost, band_pos=band_pos, off_cost=off_cost)


def select_luma(p):
    all_costs = torch.cat([p["off_cost"][None], p["bo_cost"][None],
                           p["eo_cost"]])
    best = torch.argmin(all_costs, 0)
    offsets = torch.where((best == 1)[..., None], p["bo_off"],
                          torch.zeros_like(p["bo_off"]))
    for t in range(4):
        offsets = torch.where((best == t + 2)[..., None], p["eo_off"][t],
                              offsets)
    return (best.to(torch.int32), offsets, p["band_pos"],
            all_costs.amin(0))


def select_chroma(pcb, pcr):
    all_costs = torch.cat([
        (pcb["off_cost"] + pcr["off_cost"])[None],
        (pcb["bo_cost"] + pcr["bo_cost"])[None],
        pcb["eo_cost"] + pcr["eo_cost"]])
    best = torch.argmin(all_costs, 0).to(torch.int32)

    def offs(p):
        o = torch.where((best == 1)[..., None], p["bo_off"],
                        torch.zeros_like(p["bo_off"]))
        for t in range(4):
            o = torch.where((best == t + 2)[..., None], p["eo_off"][t], o)
        return o
    return (best, offs(pcb), offs(pcr), pcb["band_pos"], pcr["band_pos"],
            all_costs.amin(0))


def _adopt_dist(stats, typ, off, bp):
    """Exact SSD change of applying params (typ, off [..., 4], bp) to CTUs
    with statistics `stats`."""
    eo_d, eo_c, bo_d, bo_c = stats
    of = torch.movedim(off.to(torch.int32), -1, 0)       # [4, ...]
    d_eo = (eo_c[:, 1:5] * (of ** 2)[None]
            - 2 * eo_d[:, 1:5] * of[None]).sum(1, dtype=torch.int32)
    sel_eo = torch.gather(d_eo, 0, (typ - 2).clamp(0, 3)[None].long())[0]
    shape = (4,) + (1,) * bp.dim()
    bands = (bp[None] + torch.arange(4, dtype=torch.int32,
                                     device=bp.device).reshape(shape)) & 31
    bd = torch.gather(bo_d, 0, bands.long())
    bc = torch.gather(bo_c, 0, bands.long())
    d_bo = (bc * (of ** 2) - 2 * bd * of).sum(0, dtype=torch.int32)
    return torch.where(typ == 0, torch.zeros_like(d_bo),
                       torch.where(typ == 1, d_bo, sel_eo)) \
        .to(torch.float32)


def merge_adopt_rdo(stats_y, stats_cb, stats_cr, expl, expl_cost, lam_y,
                    avail_l, avail_u):
    """Two-pass left-chain / up adoption (see the reference module)."""
    by, bx = expl_cost.shape
    keys = ("t_y", "off_y", "bp_y", "t_c", "off_cb", "bp_cb", "off_cr",
            "bp_cr")
    fbits = lam_y * _MERGE_FLAG_BITS
    big = torch.tensor(3e38, dtype=torch.float32, device=expl_cost.device)

    def cand_cost(sts, c):
        sy, scb, scr = sts
        return (_adopt_dist(sy, c["t_y"], c["off_y"], c["bp_y"])
                + _adopt_dist(scb, c["t_c"], c["off_cb"], c["bp_cb"])
                + _adopt_dist(scr, c["t_c"], c["off_cr"], c["bp_cr"]))

    prev = {k: torch.zeros((by,) + expl[k].shape[2:], dtype=expl[k].dtype,
                           device=expl[k].device) for k in keys}
    cols = {k: [] for k in keys}
    costs = []
    for x in range(bx):
        sts = tuple(tuple(a[..., x] for a in s)
                    for s in (stats_y, stats_cb, stats_cr))
        ex = {k: expl[k][:, x] for k in keys}
        has_l = avail_l[:, x]
        has_u = avail_u[:, x]
        c_l = torch.where(has_l, cand_cost(sts, prev) + fbits, big)
        c_e = f32.fma(fbits, has_l.to(torch.float32)
                      + has_u.to(torch.float32), expl_cost[:, x])
        take_l = c_l < c_e
        new = {}
        for k in keys:
            tl = take_l.reshape((by,) + (1,) * (ex[k].dim() - 1))
            new[k] = torch.where(tl, prev[k], ex[k])
            cols[k].append(new[k])
        costs.append(torch.minimum(c_l, c_e))
        prev = new
    p1 = {k: torch.stack(cols[k], 1) for k in keys}
    cost1 = torch.stack(costs, 1)

    upc = {k: torch.cat([p1[k][:1], p1[k][:-1]], 0) for k in keys}
    c_u = torch.where(avail_u, f32.fma(2.0, fbits, cand_cost(
        (stats_y, stats_cb, stats_cr), upc)), big)
    take_u = c_u < cost1
    fin = {}
    for k in keys:
        tu = take_u.reshape((by, bx) + (1,) * (p1[k].dim() - 2))
        fin[k] = torch.where(tu, upc[k], p1[k])
    return fin


def sao_component(org, rec, ctb: int, lam, secondary: bool = False,
                  bounds=None):
    eo_d, eo_c, bo_d, bo_c, cls, valid = sao_stats(org, rec, ctb, bounds)
    st = (eo_d, eo_c, bo_d, bo_c)
    return derive_params(st, lam, secondary), st, cls, valid


@functools.lru_cache(maxsize=None)
def avail_lu_np(by: int, bx: int, tiles=None):
    """([by, bx], [by, bx]) bool: the left / above CTU exists and lies
    in the same tile (spec 7.3.8.3 leftCtbInTile / upCtbInTile)."""
    av_l = np.ones((by, bx), bool)
    av_l[:, 0] = False
    av_u = np.ones((by, bx), bool)
    av_u[0, :] = False
    if tiles is not None:
        for b in tile_bounds(bx, tiles[0])[1:-1]:
            av_l[:, b] = False
        for b in tile_bounds(by, tiles[1])[1:-1]:
            av_u[b, :] = False
    return av_l, av_u


@functools.lru_cache(maxsize=None)
def _avail_lu(by: int, bx: int, tiles, device):
    """avail_lu_np as tensors on `device`, uploaded once."""
    return tuple(torch.as_tensor(a, device=device)
                 for a in avail_lu_np(by, bx, tiles))


def sao_frame(org_y, org_u, org_v, rec_y, rec_u, rec_v, lam_y, lam_c,
              ctu: int = 64, tiles=None, merge_rdo: bool = True,
              coded=None):
    """Full-frame SAO encode: decide + apply for Y/Cb/Cr.  The planes are
    contiguous int32, luma [h, w] and chroma [h/2, w/2] with h and w
    multiples of the CTU size (64, the only one); lam_y/lam_c are
    float32 0-d tensors; with a (cols, rows) tile grid no CTU merges
    across a tile boundary; `coded` (bh, bw) bounds the edge classes.
    Returns (new_y, new_u, new_v, fields), new planes: rec_* is not
    written.  On a CUDA device three kernel launches (no host sync); on
    the CPU the plain version.  Raises on any other input."""
    org, rec = (org_y, org_u, org_v), (rec_y, rec_u, rec_v)
    if not kernels.check_sao_frame(org, rec, lam_y, lam_c, ctu, coded):
        return sao_frame_plain(*org, *rec, lam_y, lam_c, ctu, tiles,
                               merge_rdo, coded)
    by, bx = rec_y.shape[0] // ctu, rec_y.shape[1] // ctu
    av_l, av_u = _avail_lu(by, bx, tiles, rec_y.device)
    (new_y, new_u, new_v), buf = kernels.sao_frame_launch(
        org, rec, lam_y, lam_c, av_l, av_u, merge_rdo and by * bx > 1,
        coded)
    n = by * bx
    fields = dict(type=buf[:3 * n].view(3, by, bx),
                  offsets=buf[3 * n:15 * n].view(3, by, bx, 4),
                  band_pos=buf[15 * n:].view(3, by, bx))
    return new_y, new_u, new_v, fields


def sao_frame_plain(org_y, org_u, org_v, rec_y, rec_u, rec_v, lam_y, lam_c,
                    ctu: int = 64, tiles=None, merge_rdo: bool = True,
                    coded=None):
    """The plain version of sao_frame, in eager torch ops."""
    by = bc = None
    if coded is not None:
        by = (coded[0], coded[1])
        bc = (coded[0] // 2, coded[1] // 2)
    py, sy, cy, vy = sao_component(org_y, rec_y, ctu, lam_y, bounds=by)
    pcb, scb, ccb, vcb = sao_component(org_u, rec_u, ctu // 2, lam_c,
                                       bounds=bc)
    pcr, scr, ccr, vcr = sao_component(org_v, rec_v, ctu // 2, lam_c,
                                       secondary=True, bounds=bc)
    t_y, off_y, bp_y, cost_y = select_luma(py)
    t_c, off_cb, off_cr, bp_cb, bp_cr, cost_c = select_chroma(pcb, pcr)
    if merge_rdo and t_y.numel() > 1:
        expl = dict(t_y=t_y, off_y=off_y, bp_y=bp_y, t_c=t_c,
                    off_cb=off_cb, bp_cb=bp_cb, off_cr=off_cr, bp_cr=bp_cr)
        av_l, av_u = _avail_lu(t_y.shape[0], t_y.shape[1], tiles,
                               rec_y.device)
        fin = merge_adopt_rdo(sy, scb, scr, expl, cost_y + cost_c, lam_y,
                              av_l, av_u)
        t_y, off_y, bp_y = fin["t_y"], fin["off_y"], fin["bp_y"]
        t_c, off_cb, bp_cb = fin["t_c"], fin["off_cb"], fin["bp_cb"]
        off_cr, bp_cr = fin["off_cr"], fin["bp_cr"]
    new_y = apply_sao(rec_y, cy, vy, t_y, off_y, bp_y, ctu)
    new_u = apply_sao(rec_u, ccb, vcb, t_c, off_cb, bp_cb, ctu // 2)
    new_v = apply_sao(rec_v, ccr, vcr, t_c, off_cr, bp_cr, ctu // 2)
    fields = dict(type=torch.stack([t_y, t_c, t_c]),
                  offsets=torch.stack([off_y, off_cb, off_cr]),
                  band_pos=torch.stack([bp_y, bp_cb, bp_cr]))
    return new_y, new_u, new_v, fields


def pack_sao_fields(fields) -> torch.Tensor:
    return torch.cat([fields["type"].to(torch.int16).reshape(-1),
                      fields["offsets"].to(torch.int16).reshape(-1),
                      fields["band_pos"].to(torch.int16).reshape(-1)])


def unpack_sao_fields(vec, by: int, bx: int):
    """Host inverse of pack_sao_fields -> (type, offsets, band_pos)."""
    n = 3 * by * bx
    t = vec[:n].reshape(3, by, bx)
    off = vec[n:n * 5].reshape(3, by, bx, 4)
    bp = vec[n * 5:n * 6].reshape(3, by, bx)
    return t, off, bp


def apply_sao(rec, cls, valid, type_map, offsets, band_pos, ctb: int):
    """Spec 8.7.3 SAO application (bit-exact decoder behaviour)."""
    def rep(m):
        return torch.repeat_interleave(
            torch.repeat_interleave(m, ctb, 0), ctb, 1)
    t_pix = rep(type_map)
    add = torch.zeros_like(rec)
    for t in range(4):
        sel = t_pix == t + 2
        off_k = torch.zeros_like(rec)
        for k in range(4):
            off_k = off_k + torch.where(cls[t] == k + 1,
                                        rep(offsets[..., k]), 0)
        add = add + torch.where(sel & valid[t], off_k, 0)
    band = rec >> 3
    sel = t_pix == 1
    pos_pix = rep(band_pos)
    off_b = torch.zeros_like(rec)
    for k in range(4):
        off_b = off_b + torch.where(band == ((pos_pix + k) & 31),
                                    rep(offsets[..., k]), 0)
    add = add + torch.where(sel, off_b, 0)
    return (rec + add).clamp(0, 255).to(rec.dtype)
