"""Constant tables of the HEVC (H.265) standard, as NumPy arrays.

This module is the TPU-native equivalent of the reference's table layer
(ref: hmr_tables.c, hmr_transform.c:54-128 — constants dictated by
ITU-T Rec. H.265 / ISO-IEC 23008-2).  Everything here is generated
programmatically from the spec definitions where a closed form exists
(DCT fold symmetry, scan orders, context-state init), and transcribed as
spec constants otherwise (base cosine integers, quantizer scales,
context init values).

All tables are plain numpy so they can be baked into jitted JAX programs
as compile-time constants and also consumed by the host entropy coder.
"""
from __future__ import annotations

import functools
import numpy as np

# ---------------------------------------------------------------------------
# Transform matrices (spec 8.6.4; ref hmr_transform.c:54-131)
# ---------------------------------------------------------------------------

# Base integer cosine values v[k] ~ hand-optimized round(64*sqrt(2)*cos(k*pi/64))
# for k = 1..31 (index 0 is the DC row, handled separately: all 64).
_DCT_BASE = np.array(
    [64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80, 78, 75, 73, 70, 67,
     64, 61, 57, 54, 50, 46, 43, 38, 36, 31, 25, 22, 18, 13, 9, 4],
    dtype=np.int32,
)


def _dct_entry(k: int, n: int, size: int) -> int:
    """T_size[k][n] via cosine-angle folding (angle units of pi/64).

    The angle (2n+1)*k*(32/size) never lands on a multiple of 32 for
    k >= 1, so the base table (defined on (0, 32)) always applies after
    folding by the period (128 units = 2*pi) and half-period symmetry.
    """
    if k == 0:
        return 64
    m = ((2 * n + 1) * k * (32 // size)) % 128  # cos period = 128 units
    if m > 64:
        m = 128 - m                              # cos(2*pi - x) = cos(x)
    if m > 32:
        return -int(_DCT_BASE[64 - m])           # cos(pi - x) = -cos(x)
    return int(_DCT_BASE[m])


@functools.lru_cache(maxsize=None)
def dct_matrix(size: int) -> np.ndarray:
    """HEVC integer DCT matrix T (size x size), int16-ranged int32."""
    assert size in (4, 8, 16, 32)
    t = np.zeros((size, size), dtype=np.int32)
    for k in range(size):
        for n in range(size):
            t[k, n] = _dct_entry(k, n, size)
    return t


# 4x4 DST-VII matrix for intra luma 4x4 (spec 8.6.4.2; ref fastForwardDst
# hmr_transform.c:133-151 — identical to full matrix multiply per its comment).
DST4 = np.array(
    [[29, 55, 74, 84],
     [74, 74, 0, -74],
     [84, -29, -74, 55],
     [55, -84, 74, -29]],
    dtype=np.int32,
)

# ---------------------------------------------------------------------------
# Quantizer scales (spec 8.6.3/8.6.5; ref hmr_tables.c init_quant_pyramids)
# ---------------------------------------------------------------------------

QUANT_SCALES = np.array([26214, 23302, 20560, 18396, 16384, 14564], dtype=np.int32)
INV_QUANT_SCALES = np.array([40, 45, 51, 57, 64, 72], dtype=np.int32)

MAX_TR_DYNAMIC_RANGE = 15
QUANT_SHIFT = 14
QUANT_IQUANT_SHIFT = 20

# ---------------------------------------------------------------------------
# Chroma QP mapping (spec Table 8-10; ref hmr_encoder_lib.c:1753-1759)
# ---------------------------------------------------------------------------


def _chroma_qp(qpi: int) -> int:
    if qpi < 30:
        return qpi
    if qpi >= 44:
        return qpi - 6
    return [29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37][qpi - 30]


CHROMA_QP_TABLE = np.array([_chroma_qp(q) for q in range(58)], dtype=np.int32)

# ---------------------------------------------------------------------------
# Scan orders (spec 6.5.2-6.5.5; ref init_scan_pyramid hmr_tables.c:63-198)
#
# scan_order(size, idx)[i] = raster position of the i-th coefficient in
# scan order.  idx: 0 = up-right diagonal, 1 = horizontal, 2 = vertical.
# For TBs > 4x4 the scan is hierarchical: the 4x4 coefficient groups are
# scanned in the same pattern as the coefficients within each group.
# ---------------------------------------------------------------------------

SCAN_DIAG, SCAN_HOR, SCAN_VER = 0, 1, 2


def _scan_block(n: int, idx: int) -> np.ndarray:
    """Scan order over an n x n grid; returns (r, c) pairs in scan order."""
    pos = []
    if idx == SCAN_HOR:
        for r in range(n):
            for c in range(n):
                pos.append((r, c))
    elif idx == SCAN_VER:
        for c in range(n):
            for r in range(n):
                pos.append((r, c))
    else:  # up-right diagonal: within each anti-diagonal go bottom-left -> top-right
        for d in range(2 * n - 1):
            for r in range(min(d, n - 1), -1, -1):
                c = d - r
                if c < 0 or c >= n:
                    continue
                pos.append((r, c))
    return np.array(pos, dtype=np.int64)


@functools.lru_cache(maxsize=None)
def scan_order(size: int, idx: int) -> np.ndarray:
    """Raster indices, in scan order, for a size x size transform block."""
    if size == 4:
        rc = _scan_block(4, idx)
        return rc[:, 0] * size + rc[:, 1]
    ncg = size // 4
    cg_rc = _scan_block(ncg, idx)
    in_rc = _scan_block(4, idx)
    out = np.zeros(size * size, dtype=np.int64)
    i = 0
    for cg_r, cg_c in cg_rc:
        for r, c in in_rc:
            out[i] = (cg_r * 4 + r) * size + (cg_c * 4 + c)
            i += 1
    return out


@functools.lru_cache(maxsize=None)
def cg_scan_order(size: int, idx: int) -> np.ndarray:
    """Raster CG indices in scan order for the (size/4)^2 coefficient groups."""
    ncg = max(size // 4, 1)
    rc = _scan_block(ncg, idx)
    return rc[:, 0] * ncg + rc[:, 1]


def residual_scan_idx(log2_size: int, is_intra: bool, pred_mode: int,
                      is_luma: bool) -> int:
    """Mode-dependent coefficient scan selection (spec 7.4.9.11).

    Intra 4x4/8x8 (luma; chroma only 4x4 i.e. log2==2) use horizontal scan
    for near-vertical modes (22..30) and vertical scan for near-horizontal
    modes (6..14); everything else uses the up-right diagonal scan.
    """
    if is_intra and (log2_size == 2 or (log2_size == 3 and is_luma)):
        if 6 <= pred_mode <= 14:
            return SCAN_VER
        if 22 <= pred_mode <= 30:
            return SCAN_HOR
    return SCAN_DIAG


# ---------------------------------------------------------------------------
# Z-order (Morton) tables (ref create_abs2raster_tables hmr_tables.c:275-310)
# ---------------------------------------------------------------------------


def zscan_of_raster(num_side: int) -> np.ndarray:
    """z[r, c] = z-scan index of the (r, c) sub-block in a num_side^2 grid."""
    z = np.zeros((num_side, num_side), dtype=np.int64)
    for r in range(num_side):
        for c in range(num_side):
            v = 0
            for b in range(16):
                v |= ((c >> b) & 1) << (2 * b)
                v |= ((r >> b) & 1) << (2 * b + 1)
            z[r, c] = v
    return z


# ---------------------------------------------------------------------------
# RD lambda (ref hmr_rd_init hmr_tables.c:316-375)
# ---------------------------------------------------------------------------


def rd_lambda(qp: int, slice_type_i: bool) -> float:
    qp_factor = 0.57 if slice_type_i else 0.4624 * 0.95
    return qp_factor * (2.0 ** ((qp - 12) / 3.0))


# ---------------------------------------------------------------------------
# Intra prediction angle tables (spec 8.4.4.2.6; ref hmr_encoder_lib.c:36-37)
# ---------------------------------------------------------------------------

# intraPredAngle for modes 2..34 (index by mode-2)
ANG_TABLE = np.array([0, 2, 5, 9, 13, 17, 21, 26, 32], dtype=np.int32)
INV_ANG_TABLE = np.array([0, 4096, 1638, 910, 630, 482, 390, 315, 256],
                         dtype=np.int32)


def intra_pred_angle(mode: int) -> int:
    """Signed prediction angle for angular mode 2..34 (spec Table 8-4)."""
    assert 2 <= mode <= 34
    is_ver = mode >= 18
    idx = abs(mode - (26 if is_ver else 10))
    ang = int(ANG_TABLE[idx])
    if (is_ver and mode < 26) or (not is_ver and mode > 10):
        ang = -ang
    return ang


def intra_inv_angle(mode: int) -> int:
    idx = abs(mode - (26 if mode >= 18 else 10))
    return int(INV_ANG_TABLE[idx])


# Mode-dependent reference smoothing threshold per log2 size (spec 8.4.4.2.3;
# ref intra_filter table hmr_motion_intra.c:148-155): index log2size-2.
INTRA_FILTER_THRESH = np.array([10, 7, 1, 0, 10], dtype=np.int32)

# ---------------------------------------------------------------------------
# CABAC engine tables (spec 9.3.4.3 Tables 9-46/9-47/9-48)
# ---------------------------------------------------------------------------

# rangeTabLPS[pState][qRangeIdx]  (spec Table 9-46)
CABAC_LPS_TABLE = np.array([
    [128, 176, 208, 240], [128, 167, 197, 227], [128, 158, 187, 216],
    [123, 150, 178, 205], [116, 142, 169, 195], [111, 135, 160, 185],
    [105, 128, 152, 175], [100, 122, 144, 166], [95, 116, 137, 158],
    [90, 110, 130, 150], [85, 104, 123, 142], [81, 99, 117, 135],
    [77, 94, 111, 128], [73, 89, 105, 122], [69, 85, 100, 116],
    [66, 80, 95, 110], [62, 76, 90, 104], [59, 72, 86, 99],
    [56, 69, 81, 94], [53, 65, 77, 89], [51, 62, 73, 85],
    [48, 59, 69, 80], [46, 56, 66, 76], [43, 53, 63, 72],
    [41, 50, 59, 69], [39, 48, 56, 65], [37, 45, 54, 62],
    [35, 43, 51, 59], [33, 41, 48, 56], [32, 39, 46, 53],
    [30, 37, 43, 50], [29, 35, 41, 48], [27, 33, 39, 45],
    [26, 31, 37, 43], [24, 30, 35, 41], [23, 28, 33, 39],
    [22, 27, 32, 37], [21, 26, 30, 35], [20, 24, 29, 33],
    [19, 23, 27, 31], [18, 22, 26, 30], [17, 21, 25, 28],
    [16, 20, 23, 27], [15, 19, 22, 25], [14, 18, 21, 24],
    [14, 17, 20, 23], [13, 16, 19, 22], [12, 15, 18, 21],
    [12, 14, 17, 20], [11, 14, 16, 19], [11, 13, 15, 18],
    [10, 12, 15, 17], [10, 12, 14, 16], [9, 11, 13, 15],
    [9, 11, 12, 14], [8, 10, 12, 14], [8, 9, 11, 13],
    [7, 9, 11, 12], [7, 9, 10, 12], [7, 8, 10, 11],
    [6, 8, 9, 11], [6, 7, 9, 10], [6, 7, 8, 9], [2, 2, 2, 2],
], dtype=np.int32)

# transIdxMPS / transIdxLPS (spec Table 9-47): generated per spec formulas.
CABAC_NEXT_STATE_MPS = np.array(
    [min(s + 1, 62) for s in range(63)] + [63], dtype=np.int32)
_TRANS_LPS = [0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9, 11, 11, 12,
              13, 13, 15, 15, 16, 16, 18, 18, 19, 19, 21, 21, 22, 22, 23, 24,
              24, 25, 26, 26, 27, 27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33,
              33, 33, 34, 34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63]
CABAC_NEXT_STATE_LPS = np.array(_TRANS_LPS, dtype=np.int32)

# Renormalization shift table (spec 9.3.4.3.3; count of leading zeros of
# range>>3 within [0,32)): renorm[r >> 3] for r in [0, 256).
CABAC_RENORM_TABLE = np.array(
    [6, 5, 4, 4, 3, 3, 3, 3, 2, 2, 2, 2, 2, 2, 2, 2] + [1] * 16,
    dtype=np.int32)

# Fractional-bit estimation LUT in 1/32768 bit units, indexed by
# (state << 1) | bin vs MPS — HM's entropy bits table, generated from the
# CABAC state probability model p(state) = p0 * alpha^state,
# alpha = (0.01875/0.5)^(1/63), p0 = 0.5 (ref g_bc_entropy_bits usage,
# hmr_binary_encoding.c:280-362).
_alpha = (0.01875 / 0.5) ** (1.0 / 63)
_FIX15 = 32768.0


def _entropy_bits() -> np.ndarray:
    out = np.zeros(128, dtype=np.int32)
    for state in range(64):
        p_lps = 0.5 * (_alpha ** state)
        out[2 * state] = int(round(-np.log2(1.0 - p_lps) * _FIX15))  # MPS bin
        out[2 * state + 1] = int(round(-np.log2(p_lps) * _FIX15))    # LPS bin
    return out


ENTROPY_BITS = _entropy_bits()


def ctx_init_state(init_value: int, qp: int) -> int:
    """Context state from init value + QP (spec 9.3.2.2; ref
    calc_ctx_state hmr_arithmetic_encoding.c:128-135).

    Returns packed state ((pState << 1) | MPS), pState in 0..62.
    """
    qp = min(max(qp, 0), 51)
    slope = (init_value >> 4) * 5 - 45
    offset = ((init_value & 15) << 3) - 16
    s = min(max(1, ((slope * qp) >> 4) + offset), 126)
    mps = 1 if s >= 64 else 0
    p_state = (s - 64) if mps else (63 - s)
    return (p_state << 1) | mps


# ---------------------------------------------------------------------------
# Inter interpolation filters (spec 8.5.3.2.2; ref hmr_motion_inter.c:241-257)
# ---------------------------------------------------------------------------

LUMA_FILTERS = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1],
], dtype=np.int32)

CHROMA_FILTERS = np.array([
    [0, 64, 0, 0],
    [-2, 58, 10, -2],
    [-4, 54, 16, -2],
    [-6, 46, 28, -4],
    [-4, 36, 36, -4],
    [-4, 28, 46, -6],
    [-2, 16, 54, -4],
    [-2, 10, 58, -2],
], dtype=np.int32)

# ---------------------------------------------------------------------------
# Deblocking filter tables (spec Table 8-12; ref hmr_deblocking_filter.c:28-36)
# ---------------------------------------------------------------------------

DEBLOCK_TC_TABLE = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11,
     13, 14, 16, 18, 20, 22, 24], dtype=np.int32)

DEBLOCK_BETA_TABLE = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 6, 7, 8, 9, 10, 11, 12,
     13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28, 30, 32, 34, 36, 38, 40, 42,
     44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64], dtype=np.int32)

# ---------------------------------------------------------------------------
# Default scaling lists (spec 7.4.5 Table 7-5/7-6; ref get_default_qtable
# hmr_tables.c:200-251 — ITU-T spec constants).  4x4 lists are flat 16;
# 8x8 lists below are upsampled 2x/4x for 16x16/32x32 with the DC
# coefficient overridden to the default dc value 16.
# ---------------------------------------------------------------------------

DEFAULT_SCALING_8x8_INTRA = np.array([
    16, 16, 16, 16, 17, 18, 21, 24,
    16, 16, 16, 16, 17, 19, 22, 25,
    16, 16, 17, 18, 20, 22, 25, 29,
    16, 16, 18, 21, 24, 27, 31, 36,
    17, 17, 20, 24, 30, 35, 41, 47,
    18, 19, 22, 27, 35, 44, 54, 65,
    21, 22, 25, 31, 41, 54, 70, 88,
    24, 25, 29, 36, 47, 65, 88, 115], dtype=np.int32).reshape(8, 8)

DEFAULT_SCALING_8x8_INTER = np.array([
    16, 16, 16, 16, 17, 18, 20, 24,
    16, 16, 16, 17, 18, 20, 24, 25,
    16, 16, 17, 18, 20, 24, 25, 28,
    16, 17, 18, 20, 24, 25, 28, 33,
    17, 18, 20, 24, 25, 28, 33, 41,
    18, 20, 24, 25, 28, 33, 41, 54,
    20, 24, 25, 28, 33, 41, 54, 71,
    24, 25, 28, 33, 41, 54, 71, 91], dtype=np.int32).reshape(8, 8)


@functools.lru_cache(maxsize=None)
def scaling_matrix(size: int, is_intra: bool) -> np.ndarray:
    """Default scaling factors m[y][x] for a size x size TB (spec
    8.6.3 with scaling_list_enabled=1, data_present=0)."""
    if size == 4:
        return np.full((4, 4), 16, np.int32)
    base = DEFAULT_SCALING_8x8_INTRA if is_intra \
        else DEFAULT_SCALING_8x8_INTER
    if size == 8:
        return base.copy()
    r = size // 8
    m = np.repeat(np.repeat(base, r, 0), r, 1)
    m[0, 0] = 16                     # default DC value
    return m
