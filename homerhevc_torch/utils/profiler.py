"""Lightweight stage profiler (role of hmr_profiler.c: named wall-time
accumulators around pipeline stages, compiled out unless enabled).

Host stages use `with stage("entropy"):`.  Enable printing with HOMERHEVC_PROFILE=1; `report()` returns the
accumulated table programmatically.
"""
from __future__ import annotations

import collections
import contextlib
import os
import time

_ENABLED = os.environ.get("HOMERHEVC_PROFILE", "") not in ("", "0")
_acc = collections.defaultdict(float)
_cnt = collections.defaultdict(int)


@contextlib.contextmanager
def stage(name: str):
    if not _ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _acc[name] += time.perf_counter() - t0
        _cnt[name] += 1


def report() -> dict:
    return {k: dict(total_s=round(_acc[k], 4), calls=_cnt[k],
                    avg_ms=round(1000 * _acc[k] / max(_cnt[k], 1), 2))
            for k in sorted(_acc)}


def print_report():
    for k, v in report().items():
        print(f"[profile] {k}: {v['total_s']:.3f}s over {v['calls']} "
              f"calls ({v['avg_ms']:.2f} ms avg)")


def reset():
    _acc.clear()
    _cnt.clear()
