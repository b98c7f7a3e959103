"""P-frame CTU-row bands over the ranks of a process group (the WPP
replacement).  Port of homerhevc_tpu/parallel/wpp.py.

The band-local body is `models.inter_frame.encode_p_frame` itself (its
group mode): each rank codes a contiguous band of CTU rows against the
whole reference, and the few cross-band points gather the bands.  The
result is the single-device `encode_p_frame` output on every rank.
The Encoder routes through `inter_frame.encode_p_chunk(group=...)`,
which runs the same body per frame of a chunk.
"""
from __future__ import annotations

import torch.distributed as dist

from homerhevc_torch.models import inter_frame
from homerhevc_torch.parallel import RowBands


def encode_p_frame_rowsharded(y, u, v, ref_y, ref_u, ref_v, *, qp,
                              group=None, block: int = 16,
                              sign_hiding: bool = True,
                              deblocking: bool = True,
                              sao_enabled: bool = True, ctu: int = 64,
                              chroma_rd_scale: float = 1.0,
                              chroma_qp_offset: int = 0,
                              scaling_lists: bool = False,
                              vis_h: int = None, vis_w: int = None,
                              intra_fallback: bool = False,
                              me_precision: int = 2,
                              me_subpel_r: int = 2,
                              merge_rounds: int = 2,
                              fallback_rounds: int = 2,
                              quadtree_majority: bool = True,
                              inter_nxn: bool = False,
                              ref2_y=None, ref2_u=None, ref2_v=None,
                              has_ref2=None) -> dict:
    """One P frame in CTU-row bands over the ranks of `group` (default:
    the default process group).  Every rank passes the whole frame
    (y/u/v, CTU-padded) and the whole references, and gets the
    single-device encode_p_frame's recon, mv, packed records and
    coefficient planes (and ref_idx with a second reference)."""
    group = dist.group.WORLD if group is None else group
    n = dist.get_world_size(group)
    assert (y.shape[0] // n) % ctu == 0, "band height must be CTU-aligned"
    bands = RowBands(group, n)
    out = inter_frame.encode_p_frame(
        bands.band(y), bands.band(u), bands.band(v), ref_y, ref_u, ref_v,
        qp=qp, block=block, sign_hiding=sign_hiding, deblocking=deblocking,
        sao_enabled=sao_enabled, ctu=ctu, chroma_rd_scale=chroma_rd_scale,
        chroma_qp_offset=chroma_qp_offset, scaling_lists=scaling_lists,
        vis_h=vis_h, vis_w=vis_w, intra_fallback=intra_fallback,
        me_precision=me_precision, me_subpel_r=me_subpel_r,
        merge_rounds=merge_rounds, fallback_rounds=fallback_rounds,
        quadtree_majority=quadtree_majority, inter_nxn=inter_nxn,
        ref2_y=ref2_y, ref2_u=ref2_u, ref2_v=ref2_v, has_ref2=has_ref2,
        group=group, n_bands=n)
    keys = ["recon_y", "recon_u", "recon_v", "mv", "packed", "packed_full",
            "coeff_y", "coeff_cb", "coeff_cr"]
    if ref2_y is not None:
        keys.append("ref_idx")
    return {k: out[k] for k in keys}
