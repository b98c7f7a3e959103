"""Bit-exact HEVC forward/inverse core transforms, batched.

Port of homerhevc_tpu/ops/transform.py: the full matrix products
T @ X @ T^T with the spec's two-stage rounding shifts (spec 8.6).  The
products run as float64 matmuls: every operand and partial sum is an
integer far below 2^53, so they are exact on any device and in any
summation order (CUDA has no integer GEMM).
"""
from __future__ import annotations

import functools

import torch

from homerhevc_torch import tables

_CLIP_MIN = -32768
_CLIP_MAX = 32767


@functools.lru_cache(maxsize=None)
def _matrix(size: int, is_dst: bool, device) -> torch.Tensor:
    t = tables.DST4 if is_dst else tables.dct_matrix(size)
    return torch.as_tensor(t, dtype=torch.float64, device=device)


def _rshift_round(x: torch.Tensor, shift: int) -> torch.Tensor:
    return (x + (1 << (shift - 1))) >> shift


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b).to(torch.int64)


def forward_transform(block: torch.Tensor, size: int, is_dst: bool = False,
                      bit_depth: int = 8) -> torch.Tensor:
    """int32 [..., size, size] residual -> int32 coefficients (vertical
    frequency first axis)."""
    log2 = size.bit_length() - 1
    shift1 = log2 - 1 + bit_depth - 8
    shift2 = log2 + 6
    t = _matrix(size, is_dst, block.device)
    x = block.to(torch.float64)
    s1 = _rshift_round(_mm(x, t.T), shift1)
    s2 = _rshift_round(_mm(t, s1.to(torch.float64)), shift2)
    return s2.to(torch.int32)


def inverse_transform(coeff: torch.Tensor, size: int, is_dst: bool = False,
                      bit_depth: int = 8) -> torch.Tensor:
    """Inverse core transform with the int16 clamp after each stage."""
    t = _matrix(size, is_dst, coeff.device)
    c = coeff.to(torch.float64)
    shift2 = 12 - (bit_depth - 8)
    s1 = _rshift_round(_mm(t.T, c), 7).clamp(_CLIP_MIN, _CLIP_MAX)
    s2 = _rshift_round(_mm(s1.to(torch.float64), t), shift2) \
        .clamp(_CLIP_MIN, _CLIP_MAX)
    return s2.to(torch.int32)
