"""The port's tracing: named spans and counters at its layer boundaries
(role of hmr_profiler.c: wall-time accumulators around pipeline stages,
off unless enabled).

    with stage("p.me"):                     # a layer boundary
        ...
    with stage("api.dispatch", chunk=7, kind="p", frames=4):
        ...
    count("i.steps")

With HOMERHEVC_PROFILE=1 in the environment (or after enable()), each
stage() adds its seconds to its name's total (report()) and records a
Span: its name, thread, parent (the span open on the same thread when
it began), chunk id (given as `chunk=`, else the parent's) and start
and end in epoch nanoseconds, the clock of torch.profiler's events, so
that spans line up with a device trace.  Spans go into a ring of the
newest RING spans (spans()); reset() clears the totals and counters
and keeps the ring, so that a reader can still find a part of the run
that ended before the last reset by its time.  While a torch profiler
records, stage() also opens a record_function range of the same name.
With neither, stage() returns one shared no-op context.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import NamedTuple, Optional

import torch.autograd.profiler as _autograd_profiler

RING = 65536

_ENABLED = os.environ.get("HOMERHEVC_PROFILE", "") not in ("", "0")
_acc = collections.defaultdict(float)      # name -> seconds
_cnt = collections.defaultdict(int)        # name -> calls
_counters = collections.defaultdict(int)
_ring: collections.deque = collections.deque(maxlen=RING)
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()
_NOOP = contextlib.nullcontext()


class Span(NamedTuple):
    id: int
    name: str
    thread: int                 # its thread's native id
    parent: Optional[int]       # the enclosing span's id
    chunk: Optional[int]
    start_ns: int               # epoch ns, torch.profiler's clock
    end_ns: int
    attrs: dict


_EPOCH_MINUS_PERF = 0


def _anchor():
    """One (epoch ns, perf_counter ns) pair: spans are timed on the
    cheap perf_counter and placed on the epoch clock through it."""
    global _EPOCH_MINUS_PERF
    _EPOCH_MINUS_PERF = time.time_ns() - time.perf_counter_ns()


_anchor()


class _Stage:
    __slots__ = ("name", "attrs", "range", "t0", "id", "parent", "chunk")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.range = self.t0 = None

    def __enter__(self):
        if _ENABLED:
            stack = _stack()
            up = stack[-1] if stack else None
            self.id = next(_ids)
            self.parent = up and up.id
            self.chunk = self.attrs.pop("chunk", up and up.chunk)
            stack.append(self)
            self.t0 = time.perf_counter_ns()
        # the profiler's range opens after the span and closes before it
        if _autograd_profiler._is_profiler_enabled:
            self.range = _autograd_profiler.record_function(self.name)
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        if self.t0 is not None:
            t1 = time.perf_counter_ns()
            _stack().pop()
            with _lock:
                _acc[self.name] += (t1 - self.t0) / 1e9
                _cnt[self.name] += 1
            _ring.append(Span(self.id, self.name, threading.get_native_id(),
                              self.parent, self.chunk,
                              self.t0 + _EPOCH_MINUS_PERF,
                              t1 + _EPOCH_MINUS_PERF, self.attrs))
        return False


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


def stage(name: str, **attrs):
    """A context that spans `name` (see the module docstring); `chunk=`
    sets the span's chunk id, other keywords are kept in its attrs."""
    if not _ENABLED and not _autograd_profiler._is_profiler_enabled:
        return _NOOP
    return _Stage(name, attrs)


def count(name: str, n: int = 1):
    """Adds n to counter `name` while spans are on."""
    if _ENABLED:
        with _lock:
            _counters[name] += n


def enable(on: bool = True):
    """Turns spans, totals and counters on or off; turning them on
    starts an empty ring on a fresh clock anchor."""
    global _ENABLED
    if on and not _ENABLED:
        _ring.clear()
        _anchor()
    _ENABLED = on


def report() -> dict:
    """{name: total_s, calls, avg_ms} of every stage since reset()."""
    with _lock:
        return {k: dict(total_s=round(_acc[k], 4), calls=_cnt[k],
                        avg_ms=round(1000 * _acc[k] / max(_cnt[k], 1), 2))
                for k in sorted(_acc)}


def counters() -> dict:
    with _lock:
        return dict(_counters)


def spans() -> list:
    """The ring's spans, oldest first (each recorded when it ended)."""
    return list(_ring)


def reset():
    """Clears the stage totals and the counters (the ring stays)."""
    with _lock:
        _acc.clear()
        _cnt.clear()
        _counters.clear()
    _anchor()
