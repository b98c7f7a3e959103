"""Arithmetic that turns a profiler trace into per-layer numbers.

`busy_us` is a frozen copy of `_busy_us` from
homerhevc_torch/profile_main.py at commit daefa91: the length of the
union of time ranges.  The rest is written for the benchmark on the
same pattern.  Every function takes plain (start, end) pairs or
(name, start, end) triples in microseconds, so the tests can feed them
fixed inputs.
"""
from __future__ import annotations


def busy_us(spans) -> float:
    """Length of the union of the (start, end) ranges."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def idle_gaps(spans, t0: float, t1: float) -> list:
    """The gaps in [t0, t1] that no (start, end) range covers, as
    (start, end) pairs, longest first."""
    gaps, end = [], t0
    for a, b in sorted(spans):
        if a > end:
            gaps.append((end, min(a, t1)))
        end = max(end, b)
        if end >= t1:
            break
    if end < t1:
        gaps.append((end, t1))
    gaps = [(a, b) for a, b in gaps if b > a]
    return sorted(gaps, key=lambda g: g[0] - g[1])


def top_by_time(named) -> list:
    """(name, summed duration) of (name, start, end) triples, largest
    first."""
    acc: dict = {}
    for name, a, b in named:
        acc[name] = acc.get(name, 0.0) + (b - a)
    return sorted(acc.items(), key=lambda kv: -kv[1])
