"""What the benchmark reads of the program's own spans
(homerhevc_torch.utils.profiler, recording in a traced run): a span
name's host seconds over the window, per frame, and how the device's
idle time in the traced part lines up with the spans the dispatching
thread had open.

The program's spans are on the device trace's clock (epoch ns; the
trace's (name, start, end) triples are in microseconds).  The profiler
keeps its newest spans across the reset that starts the window, so the
traced part's spans are still there when the metrics are read.  A
program without spans (an older commit) gives nothing to read: every
function returns None there.
"""
from __future__ import annotations

import bisect

from frozen import trace_math


def span_ms_per_frame(run, name: str):
    """The program's stage total of `name` over the window, per frame,
    in ms; None where the run has none (spans off, or no such span)."""
    s = run.stages.get(name)
    return None if s is None else s * 1e3 / run.frames


def program_spans():
    """The program's recorded spans, or None where it records none."""
    from homerhevc_torch.utils import profiler
    spans = getattr(profiler, "spans", None)
    return spans() if spans is not None else None


def traced_host_spans(run, spans=None, ring: int = None):
    """(name, start_us, end_us) of the spans of the dispatching thread
    (the one whose api.dispatch spans overlap the traced part) that
    overlap the traced part's device time, its first operation's start
    to its last one's end.  None where there is no traced part, no span,
    or the profiler's ring (of `ring` spans; the program's by default)
    has dropped spans that ended in the traced part."""
    t = run.traced
    if spans is None:
        spans = program_spans()
        from homerhevc_torch.utils import profiler
        ring = getattr(profiler, "RING", 0)
    if t is None or not t["device"] or not spans:
        return None
    t0 = min(a for _, a, _ in t["device"])
    t1 = max(b for _, _, b in t["device"])
    if ring is not None and len(spans) >= ring \
            and spans[0].end_ns / 1e3 > t0:
        return None
    mine = [s for s in spans
            if s.end_ns / 1e3 > t0 and s.start_ns / 1e3 < t1]
    thread = next((s.thread for s in mine if s.name == "api.dispatch"), None)
    if thread is None:
        return None
    return [(s.name, s.start_ns / 1e3, s.end_ns / 1e3) for s in mine
            if s.thread == thread]


def _idle(device) -> list:
    iv = [(a, b) for _, a, b in device]
    return trace_math.idle_gaps(iv, min(a for a, _ in iv),
                                max(b for _, b in iv))


def unattributed_idle_share(device, spans):
    """The share, in %, of the device's idle time (the gaps between its
    first operation's start and its last one's end) that no span covers;
    device and spans are (name, start, end) triples.  None where the
    device was never idle."""
    gaps = sorted(_idle(device))
    idle = sum(b - a for a, b in gaps)
    if idle <= 0:
        return None
    cover, covered, j = [], 0.0, 0
    for _, a, b in sorted(spans, key=lambda s: s[1]):
        if cover and a <= cover[-1][1]:
            cover[-1][1] = max(cover[-1][1], b)
        else:
            cover.append([a, b])
    for a, b in gaps:
        while j < len(cover) and cover[j][1] <= a:
            j += 1
        k = j
        while k < len(cover) and cover[k][0] < b:
            covered += min(b, cover[k][1]) - max(a, cover[k][0])
            k += 1
    return 100.0 * (1.0 - covered / idle)


def _innermost(spans):
    """(times, names): from times[i] on, names[i] is the innermost open
    span ("none" where none is open).  Spans of one thread nest."""
    times, names, stack = [], [], []

    def close_before(t):
        while stack and stack[-1][1] <= t:
            times.append(stack.pop()[1])
            names.append(stack[-1][0] if stack else "none")
    for name, a, b in sorted(spans, key=lambda s: (s[1], -s[2])):
        close_before(a)
        stack.append((name, b))
        times.append(a)
        names.append(name)
    close_before(float("inf"))
    return times, names


def _named_gaps(device, spans) -> list:
    """[innermost span open at the gap's midpoint, seconds] of every idle
    gap, longest first."""
    times, names = _innermost(spans)
    out = []
    for a, b in _idle(device):
        i = bisect.bisect_right(times, (a + b) / 2) - 1
        out.append([names[i] if i >= 0 else "none", (b - a) / 1e6])
    return out


def idle_gaps_host(device, spans, n: int = 10) -> list:
    """The n longest idle gaps, each named by the innermost span open at
    its midpoint, or "none"."""
    return _named_gaps(device, spans)[:n]


def idle_by_host_span(device, spans, n: int = 10) -> list:
    """Idle seconds summed by the span each gap is named by, the n
    largest."""
    return trace_math.top_by_time(
        (name, 0.0, s) for name, s in _named_gaps(device, spans))[:n]
