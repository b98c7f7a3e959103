"""Seeded synthetic YUV420 video for smoke runs and measurements."""
from __future__ import annotations

import numpy as np


def synthetic_video(n: int, h: int, w: int, seed: int = 7) -> list:
    """n frames (Y, U, V) uint8: textured luma under a global pan of
    (1, 3) pixels per frame, smooth low-frequency chroma (the pattern of
    the JAX package's bench)."""
    rng = np.random.default_rng(seed)
    m = 4 * n + 8
    yy, xx = np.mgrid[0:h + m, 0:w + m]
    base = np.clip(((xx * 3 + yy * 2) % 235)
                   + rng.integers(0, 20, xx.shape), 0, 255).astype(np.uint8)
    cyy, cxx = np.mgrid[0:(h + m) // 2, 0:(w + m) // 2]
    cb = (128 + 40 * np.sin(cxx / 37.0) * np.cos(cyy / 29.0)) \
        .astype(np.uint8)
    cr = (128 + 40 * np.cos(cxx / 31.0 + 1.0) * np.sin(cyy / 41.0)) \
        .astype(np.uint8)
    out = []
    for i in range(n):
        dx, dy = 3 * i, i
        out.append((base[dy:dy + h, dx:dx + w].copy(),
                    cb[dy // 2:dy // 2 + h // 2,
                       dx // 2:dx // 2 + w // 2].copy(),
                    cr[dy // 2:dy // 2 + h // 2,
                       dx // 2:dx // 2 + w // 2].copy()))
    return out
