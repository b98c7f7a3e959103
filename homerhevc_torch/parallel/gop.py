"""Frame and closed-GOP sharding over the ranks of a process group (the
reference's n_enc_engines).  Port of homerhevc_tpu/parallel/gop.py.

Every rank passes the whole stack and codes its share of it (frames or
closed GOPs, rank r the r-th share); the records are gathered in order,
so every rank returns all of them, bit-identical to one device (the
frames of an all-intra stack, and closed GOPs, are independent).  The
engines' rate-control exchange is the mean distortion: an exact integer
sum over the ranks divided in float32, as the reference computes it.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from homerhevc_torch import parallel
from homerhevc_torch.models import inter_frame, intra_frame


def _share(x, group):
    """This rank's share of the leading axis (divisible by the ranks)."""
    n = dist.get_world_size(group)
    m = x.shape[0] // n
    assert m * n == x.shape[0], (x.shape[0], n)
    r = dist.get_rank(group)
    return x[r * m:(r + 1) * m]


def mean_dist(total: torch.Tensor, n: int) -> torch.Tensor:
    """The reference's psum(int32 sum) / float32(n): float32."""
    return total.to(torch.int32).to(torch.float32) / float(n)


def encode_gop(y, u, v, *, qp: int, group=None, cu: int = 16,
               ctu: int = 64, sign_hiding: bool = True):
    """All-intra frames split over the ranks of `group` (default: the
    default process group).  y: uint8 [N, H, W], u/v [N, H/2, W/2],
    CTU-padded, N a multiple of the ranks.  `cu` is accepted as the
    reference accepts it (unused).  Returns (records, avg_dist):
    intra_frame's records with a leading frame axis, all N frames on
    every rank, and the mean squared luma error per frame (float32)."""
    group = dist.group.WORLD if group is None else group
    ys = _share(y, group)
    out = intra_frame.encode_i_chunk(ys, _share(u, group), _share(v, group),
                                     qp, ctu=ctu, sign_hiding=sign_hiding,
                                     search_8x8=True)
    d = ((out["recon_y"] - ys.to(torch.int32)) ** 2).sum()
    recs = parallel.gather_rows(group, *out.values(), d)
    return dict(zip(out, recs[:-1])), mean_dist(recs[-1].sum(), y.shape[0])


def _ippp_local(y, u, v, *, qp: int, ctu: int = 64, sign_hiding: bool = True,
                deblocking: bool = True, sao_enabled: bool = True,
                intra_fallback: bool = True, chroma_qp_offset: int = 0,
                me_precision: int = 2):
    """Closed GOPs [n, g, H, W] on this device: each an I frame, then its
    g - 1 P frames as one chunk.  Returns (dict(i_packed [n, Li],
    p_packed [n, g-1, Lp]), the int64 sum of each GOP's last-frame
    squared luma error)."""
    i_packed, p_packed, total = [], [], 0
    for yy, uu, vv in zip(y, u, v):
        i_out = intra_frame.encode_frame(
            yy[0], uu[0], vv[0], qp=qp, ctu=ctu, sign_hiding=sign_hiding,
            deblocking=deblocking, sao_enabled=sao_enabled,
            chroma_qp_offset=chroma_qp_offset, search_8x8=True)
        p_out = inter_frame.encode_p_chunk(
            yy[1:], uu[1:], vv[1:], i_out["recon_y"], i_out["recon_u"],
            i_out["recon_v"], qp=qp, block=16, sign_hiding=sign_hiding,
            deblocking=deblocking, sao_enabled=sao_enabled, ctu=ctu,
            intra_fallback=intra_fallback, chroma_qp_offset=chroma_qp_offset,
            me_precision=me_precision)
        total = total + ((p_out["recon_y"] - yy[-1].to(torch.int32)) ** 2
                         ).sum()
        i_packed.append(i_out["packed"])
        p_packed.append(p_out["packed"])
    return dict(i_packed=torch.stack(i_packed),
                p_packed=torch.stack(p_packed)), total


def encode_ippp_gops(y, u, v, *, qp: int, group=None, ctu: int = 64,
                     sign_hiding: bool = True, deblocking: bool = True,
                     sao_enabled: bool = True, intra_fallback: bool = True,
                     chroma_qp_offset: int = 0, me_precision: int = 2):
    """Frame-parallel engines for IPPP: each rank of `group` (default:
    the default process group) codes its share of n_gops CLOSED GOPs
    (IDR + P...P), so no reference crosses a rank.  y: uint8 [n_gops, g,
    H, W] (CTU-padded), u/v the chroma halves; n_gops a multiple of the
    ranks.  Returns (records, avg_dist): dict(i_packed [n_gops, Li],
    p_packed [n_gops, g-1, Lp]), all GOPs on every rank, and the mean of
    the GOPs' last-frame squared luma error (float32)."""
    group = dist.group.WORLD if group is None else group
    recs, total = _ippp_local(
        _share(y, group), _share(u, group), _share(v, group), qp=qp, ctu=ctu,
        sign_hiding=sign_hiding, deblocking=deblocking,
        sao_enabled=sao_enabled, intra_fallback=intra_fallback,
        chroma_qp_offset=chroma_qp_offset, me_precision=me_precision)
    i_packed, p_packed, totals = parallel.gather_rows(
        group, recs["i_packed"], recs["p_packed"], total)
    return (dict(i_packed=i_packed, p_packed=p_packed),
            mean_dist(totals.sum(), y.shape[0]))
