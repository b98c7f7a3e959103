"""Seeded synthetic YUV420 video: the benchmark's content generator.

A frozen copy of `synthetic_video` from homerhevc_torch/utils/synthetic.py
at commit daefa91, kept here so that the yardstick does not move when
the program changes.  Only the module docstring differs.
"""
from __future__ import annotations

import numpy as np


def synthetic_video(n: int, h: int, w: int, seed: int = 7,
                    plants: int = 0, diverge: int = 0, quads: int = 0,
                    scene_cut: int = None, flicker: int = 0,
                    patches: int = 0, strip: int = 0) -> list:
    """n frames (Y, U, V) uint8: textured luma under a global pan of
    (1, 3) pixels per frame, smooth low-frequency chroma (the pattern of
    the JAX package's bench).  The options add content for the rd=FAST
    P-frame tools (all off by default):

    * plants: from frame 1 on, up to `plants` isolated 16x16 blocks of
      new flat content (255 and 0 in turns, frame by frame) with the
      ring of pixels above and left of each in the same value: blocks no
      reference holds, that DC prediction from their neighbours does;
    * diverge: an aligned diverge x diverge patch whose 8x8 quadrants, on
      odd frames, move apart: each shows the previous frame's pixels
      displaced by its own (1 or 3, 1 or 3) pel;
    * quads: an aligned quads x quads patch in the bottom-right corner,
      the same in every frame: vertical stripes over a flat level per
      8x8 quadrant, which the I frame codes as four 8x8 CUs of one mode
      (folded into a 16x16 CU with a split transform tree);
    * scene_cut: from this frame on, the luma shows other texture and a
      vertical gradient near 255 (above anything the texture holds);
    * flicker: odd frames add a fixed noise field of amplitude +-flicker,
      moving with the pan, over the left half of the picture: there the
      frame two back (same parity) is the better reference, elsewhere
      the previous frame (two-reference coding);
    * patches: from frame 1 on, up to `patches` patches of 2 x 3 16x16
      blocks of new flat content (the plants' values), each with the
      ring of pixels above and left of it in the same value, near the
      bottom of the picture: every block of a patch has a candidate
      neighbour, so none is isolated (the P intra fallback's serial
      pass);
    * strip: from frame 1 on, the right `strip` columns (a multiple of
      16) show new flat content of another level in every frame, with
      the column left of them in the same value: the blocks where a pan
      enters, mutually adjacent.
    Plant sites next to a patch or the strip are left out.
    """
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
    # plant sites: every 4th 16-block, away from the frame's first row
    # and column of blocks
    sites = [(by, bx) for by in range(1, h // 16, 4)
             for bx in range(1, w // 16, 4)][:plants]
    # patch sites (top-left block): rows up from the bottom, a block
    # column apart, clear of the strip
    psites = [(by, bx) for by in range(h // 16 - 3, 0, -4)
              for bx in range(1, w // 16 - strip // 16 - 4, 5)][:patches]
    sx = w - strip                       # the strip's first column
    sites = [(by, bx) for by, bx in sites
             if not any(py - 1 <= by <= py + 2 and px - 1 <= bx <= px + 3
                        for py, px in psites)
             and not (strip and 16 * bx + 16 >= sx - 16)]
    q0y, q0x = (h - quads) // 16 * 16, (w - quads) // 16 * 16
    levels = rng.integers(0, 6, (quads // 8, quads // 8)) * 16
    flick = rng.integers(-flicker, flicker + 1, xx.shape) if flicker else None
    quad_patch = (((np.arange(quads) // 2) % 2) * 50 + 40)[None, :] \
        + np.repeat(np.repeat(levels, 8, 0), 8, 1)
    out = []
    for i in range(n):
        dx, dy = 3 * i, i
        y = base[dy:dy + h, dx:dx + w].copy()
        if flicker and i % 2 == 1:
            f = flick[dy:dy + h, dx:dx + w]
            y[:, :w // 2] = np.clip(y[:, :w // 2].astype(np.int32)
                                    + f[:, :w // 2], 0, 255)
        if scene_cut is not None and i >= scene_cut:
            g = np.mgrid[0:h, 0:w]
            y = (250 + g[0] // 16 + 2 * (i - scene_cut)).clip(0, 255) \
                .astype(np.uint8)
            y[:, : w // 2] = ((g[1][:, :w // 2] * 7 + g[0][:, :w // 2] * 5)
                              % 200).astype(np.uint8)
        if diverge and i % 2 == 1:
            prev = out[-1][0]
            p0y, p0x = (h // 2 - diverge // 2) // 16 * 16, \
                (w // 2 - diverge // 2) // 16 * 16
            for by in range(p0y, p0y + diverge, 8):
                for bx in range(p0x, p0x + diverge, 8):
                    oy = (by // 8 % 2) * 2 + 1
                    ox = (bx // 8 % 2) * 2 + 1
                    y[by:by + 8, bx:bx + 8] = prev[by + oy:by + oy + 8,
                                                   bx + ox:bx + ox + 8]
        if strip and i >= 1:
            y[:, sx - 1:] = (i * 77) % 200 + 28
        if quads:
            y[q0y:q0y + quads, q0x:q0x + quads] = quad_patch
        if i >= 1:
            val = 255 if i % 2 else 0
            for by, bx in sites:
                y[16 * by - 1:16 * by + 16, 16 * bx - 1:16 * bx + 16] = val
            for by, bx in psites:
                y[16 * by - 1:16 * by + 32, 16 * bx - 1:16 * bx + 48] = val
        out.append((y,
                    cb[dy // 2:dy // 2 + h // 2,
                       dx // 2:dx // 2 + w // 2].copy(),
                    cr[dy // 2:dy // 2 + h // 2,
                       dx // 2:dx // 2 + w // 2].copy()))
    return out
