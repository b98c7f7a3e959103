"""Static dependency scheduling for intra reconstruction wavefronts.

HEVC decodes CTUs in raster order and blocks within a CTU in z-order;
intra prediction of a block may reference reconstructed samples of its
left / top-left / top / top-right / bottom-left neighbours whenever
those precede it in coding order (spec 6.4.1).  The reference resolves
this with sequential WPP threads (ref: wfpp_encoder_thread,
hmr_encoder_lib.c:2357); the TPU-native design instead precomputes a
static parallel schedule: step[b] = longest dependency chain to block b,
then reconstructs all blocks of equal step in one batched kernel launch
(lax.scan over steps).

All functions are pure numpy executed once per (resolution, block size)
and cached; their outputs are compile-time constants of the jitted
frame program.
"""
from __future__ import annotations

import functools

import numpy as np

from homerhevc_torch import tables


def tile_bounds(n_ctus: int, n_tiles: int) -> tuple:
    """Uniform-spacing tile boundaries in CTU units (spec 6.5.1:
    colBd[i] = (i * n_ctus) / n_tiles, integer division)."""
    return tuple((i * n_ctus) // n_tiles for i in range(n_tiles + 1))


def _tile_id_1d(bounds, v):
    """Tile index along one axis for coordinate v (bounds in same units)."""
    t = 0
    for i in range(len(bounds) - 1):
        if v >= bounds[i]:
            t = i
    return t


@functools.lru_cache(maxsize=None)
def _tile_maps(blocks_w: int, blocks_h: int, bpc: int, tiles):
    """(tile_id[bh, bw], per-block) for a (cols, rows) uniform tile
    grid; tiles=None -> all zeros (single tile)."""
    tid = np.zeros((blocks_h, blocks_w), np.int32)
    if tiles is None:
        return tid
    tx, ty = tiles
    ctus_x = (blocks_w + bpc - 1) // bpc
    ctus_y = (blocks_h + bpc - 1) // bpc
    cb = [b * bpc for b in tile_bounds(ctus_x, tx)]
    rb = [b * bpc for b in tile_bounds(ctus_y, ty)]
    for y in range(blocks_h):
        for x in range(blocks_w):
            tid[y, x] = _tile_id_1d(rb, y) * tx + _tile_id_1d(cb, x)
    return tid


@functools.lru_cache(maxsize=None)
def coding_order(blocks_w: int, blocks_h: int, bpc: int,
                 tiles=None) -> np.ndarray:
    """coding index of each block; bpc = blocks per CTU side.  With a
    (cols, rows) tile grid, CTUs are coded in tile-scan order (tiles in
    raster order, CTUs raster within each tile — spec 6.5.1)."""
    z = tables.zscan_of_raster(bpc)
    by, bx = np.mgrid[0:blocks_h, 0:blocks_w]
    ctu_y, ctu_x = by // bpc, bx // bpc
    ctus_x = (blocks_w + bpc - 1) // bpc
    ctu_idx = ctu_y * ctus_x + ctu_x
    if tiles is not None:
        tid = _tile_maps(blocks_w, blocks_h, bpc, tiles)
        # tile-major ordering: stable rank of (tile, raster ctu idx)
        key = tid[::bpc, ::bpc].repeat(bpc, 0)[:blocks_h].repeat(
            bpc, 1)[:, :blocks_w].astype(np.int64) * (ctus_x * 10 ** 6) \
            + ctu_idx
        # re-rank CTUs by key to get tile-scan ctu order
        uniq = np.unique(key)
        rank = {int(k): i for i, k in enumerate(uniq)}
        ctu_idx = np.vectorize(lambda k: rank[int(k)])(key)
    return ctu_idx * (bpc * bpc) + z[by % bpc, bx % bpc]


_NEIGHBORS = {
    "left": (-1, 0),
    "corner": (-1, -1),
    "top": (0, -1),
    "topright": (1, -1),
    "bottomleft": (-1, 1),
}


@functools.lru_cache(maxsize=None)
def availability(blocks_w: int, blocks_h: int, bpc: int, tiles=None):
    """Per-block availability of the 5 neighbour segments (bool maps).
    With tiles, a neighbour in a different tile is unavailable
    (spec 6.4.1: zavail requires same tile)."""
    order = coding_order(blocks_w, blocks_h, bpc, tiles)
    tid = _tile_maps(blocks_w, blocks_h, bpc, tiles)
    out = {}
    for name, (dx, dy) in _NEIGHBORS.items():
        m = np.zeros((blocks_h, blocks_w), dtype=bool)
        for y in range(blocks_h):
            for x in range(blocks_w):
                nx, ny = x + dx, y + dy
                if 0 <= nx < blocks_w and 0 <= ny < blocks_h:
                    m[y, x] = bool(order[ny, nx] < order[y, x]
                                   and tid[ny, nx] == tid[y, x])
        out[name] = m
    return out


@functools.lru_cache(maxsize=None)
def wavefront_schedule(blocks_w: int, blocks_h: int, bpc: int,
                       tiles=None):
    """Longest-path levels over the intra dependency DAG.

    Returns (steps[bh, bw] int32, n_steps, batches) where batches is an
    int32 array [n_steps, max_batch, 2] of (by, bx) per step, padded
    with -1.
    """
    avail = availability(blocks_w, blocks_h, bpc, tiles)
    order = coding_order(blocks_w, blocks_h, bpc, tiles)
    # process blocks in coding order; deps guaranteed to precede
    idx_sorted = np.argsort(order, axis=None)
    steps = np.zeros((blocks_h, blocks_w), dtype=np.int32)
    for flat in idx_sorted:
        y, x = divmod(int(flat), blocks_w)
        s = 0
        for name, (dx, dy) in _NEIGHBORS.items():
            if avail[name][y, x]:
                s = max(s, steps[y + dy, x + dx] + 1)
        steps[y, x] = s
    n_steps = int(steps.max()) + 1
    max_batch = max(int((steps == s).sum()) for s in range(n_steps))
    batches = np.full((n_steps, max_batch, 2), -1, dtype=np.int32)
    for s in range(n_steps):
        ys, xs = np.nonzero(steps == s)
        batches[s, : len(ys), 0] = ys
        batches[s, : len(ys), 1] = xs
    return steps, n_steps, batches
