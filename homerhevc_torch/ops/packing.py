"""Device-side record compaction for the device->host transfer.

Port of homerhevc_tpu/ops/packing.py; the packed int16 layout is the
reference's, bit for bit: only blocks with nonzero levels are shipped
(stable-order compaction into fixed capacities), as int8 level pairs with
a block-granular escape list for |level| > 127.
"""
from __future__ import annotations

import numpy as np
import torch


def compact_blocks_i8_tiers(level_blocks: torch.Tensor, tiers):
    """level_blocks [nB, b, b]; tiers: list of (cap, esc_cap) pairs (caps
    even).  Returns one int16 vector per tier:
    [count, esc_count, ids(cap), lo_packed(cap*b*b/2),
     esc_ids(esc_cap), esc_rows(esc_cap*b*b)]."""
    nb, b, _ = level_blocks.shape
    n = b * b
    dev = level_blocks.device
    assert all(c % 2 == 0 for c, _ in tiers)
    cap_max = max(c for c, _ in tiers)
    flat = level_blocks.reshape(nb, n).to(torch.int16)
    nz = (flat != 0).any(-1)
    order = torch.argsort((~nz).to(torch.int32), stable=True)[:cap_max]
    ids_max = torch.where(nz[order], order.to(torch.int16),
                          torch.full_like(order, -1, dtype=torch.int16))
    data_max = flat[order] * nz[order, None]             # [cap_max, n]
    count = nz.sum().to(torch.int16)
    lo_max = data_max.clamp(-128, 127)
    esc_rows_max = (data_max != lo_max).any(-1)

    outs = []
    for cap, esc_cap in tiers:
        ids = ids_max[:cap]
        data = data_max[:cap]
        lo_u = lo_max[:cap].to(torch.int32) & 0xFF
        pair = lo_u[0::2, :] | (lo_u[1::2, :] << 8)       # uint16 values
        packed_lo = (pair - ((pair >> 15) << 16)).to(torch.int16) \
            .reshape(-1)
        esc_rows = esc_rows_max[:cap]
        esc_count = esc_rows.sum()
        ridx = torch.arange(cap, dtype=torch.int32, device=dev)
        key = torch.where(esc_rows, (1 << 30) - ridx, 0)
        # top_k of the keys: descending, ties (the zero keys) in
        # ascending index order
        esc_id = torch.argsort(-key, stable=True)[:esc_cap]
        esc_data = data[esc_id].reshape(-1)
        outs.append(torch.cat([
            count[None],
            torch.clamp(esc_count, max=30000).to(torch.int16)[None],
            ids, packed_lo, esc_id.to(torch.int16), esc_data]))
    return outs


def compact_i8_size(cap: int, b: int, esc_cap: int) -> int:
    return 2 + cap + cap * b * b // 2 + esc_cap * (1 + b * b)


def unpack_blocks_i8(vec, cap: int, b: int, nb: int, esc_cap: int):
    """Host-side (numpy) inverse; returns (count, plane_blocks|None)."""
    count = int(vec[0])
    esc_count = int(vec[1])
    if count > cap or esc_count > esc_cap:
        return max(count, esc_count), None
    n = b * b
    ids = vec[2:2 + cap][:count].astype(np.int32)
    packed_lo = vec[2 + cap:2 + cap + cap * n // 2].view(np.uint16) \
        .reshape(cap // 2, n)
    lo = np.empty((cap, n), np.int8)
    lo[0::2] = (packed_lo & 0xFF).astype(np.uint8).view(np.int8)
    lo[1::2] = (packed_lo >> 8).astype(np.uint8).view(np.int8)
    data = lo.astype(np.int16)
    esc = vec[2 + cap + cap * n // 2:]
    esc_id = esc[:esc_cap][:esc_count].astype(np.int32)
    esc_rows = esc[esc_cap:].reshape(esc_cap, n)[:esc_count]
    data[esc_id] = esc_rows
    out = np.zeros((nb, n), np.int16)
    out[ids] = data[:count]
    return count, out
