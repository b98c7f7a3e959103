"""The readers of the program's spans (program_spans.py and the metrics
that use it) on fixed spans and device intervals, and on whole tiny runs
on the CPU with the program's spans on."""
import pytest

import harness
import program_spans as ps
from bench_tiny import run_tiny, tiny_cell
from homerhevc_torch.utils import profiler
from homerhevc_torch.utils.profiler import Span

LDP, AI = "ldp720.chunk4", "ai720.chunk16"
SPAN_METRICS = {
    **{f"p_{m}_ms_per_frame": f"p.{m}" for m in (
        "me", "merge", "fallback", "split8", "quadtree", "chroma",
        "deblock", "sao", "pack")},
    **{f"i_{m}_ms_per_frame": f"i.{m}" for m in (
        "dense", "step", "deblock", "sao", "pack")},
    **{f"{m}_ms_per_frame{ai}": name for m, name in (
        ("upload", "api.upload"), ("drain_wait", "api.drain_wait"),
        ("device_wait", "api.device_wait"), ("transfer", "transfer"))
       for ai in ("", ".ai")}}


class _Run:
    frames = 4
    stages = {}
    traced = None


def _span(name, a_us, b_us, thread=1, sid=0, parent=None):
    return Span(sid, name, thread, parent, None, int(a_us * 1e3),
                int(b_us * 1e3), {})


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_span_readers(metric):
    run = _Run()
    read = harness.metric_reader(metric)
    assert read(run) is None                 # spans off: nothing to read
    run.stages = {SPAN_METRICS[metric]: 0.2, "other": 1.0}
    assert read(run) == pytest.approx(50.0)


# the device busy in [0, 10], [20, 30], [50, 60], [100, 110]: idle gaps
# (30, 50) 20 us, (60, 100) 40 us and (10, 20) 10 us
DEVICE = [("k", 0, 10), ("k", 20, 30), ("k", 50, 60), ("k", 100, 110)]
NESTED = [("api.dispatch", 0, 70), ("p.frame", 5, 65), ("p.me", 12, 40),
          ("api.drain_wait", 90, 95)]


def test_unattributed_idle_share():
    # covered: (10, 20), (30, 50) and (60, 70) by the dispatch, (90, 95)
    # by the drain wait: 45 us of 70 idle
    assert ps.unattributed_idle_share(DEVICE, NESTED) == \
        pytest.approx(100 * (1 - 45 / 70))
    assert ps.unattributed_idle_share(DEVICE, []) == pytest.approx(100.0)
    assert ps.unattributed_idle_share(DEVICE, [("x", -5, 200)]) == \
        pytest.approx(0.0)
    assert ps.unattributed_idle_share([("k", 0, 10)], NESTED) is None


def test_idle_gaps_named_by_the_innermost_span():
    # midpoints: 80 (no span open), 40 (p.frame: p.me ended at 40),
    # 15 (p.me inside p.frame inside api.dispatch)
    assert ps.idle_gaps_host(DEVICE, NESTED) == [
        ["none", 40e-6], ["p.frame", 20e-6], ["p.me", 10e-6]]
    assert ps.idle_gaps_host(DEVICE, NESTED, n=1) == [["none", 40e-6]]
    assert ps.idle_by_host_span(DEVICE, NESTED[:2]) == [
        ("none", pytest.approx(40e-6)), ("p.frame", pytest.approx(30e-6))]


def test_traced_host_spans_keep_the_dispatching_thread():
    run = _Run()
    run.traced = dict(device=DEVICE, wall_s=1.0, frames=2)
    ring = [_span("api.dispatch", -50, -40),           # before the part
            _span("api.dispatch", 0, 70, sid=1),
            _span("p.me", 12, 40, sid=2, parent=1),
            _span("entropy", 60, 100, thread=2),       # the worker's
            _span("api.drain_wait", 90, 95),
            _span("api.dispatch", 120, 130)]           # after it
    got = ps.traced_host_spans(run, sorted(ring, key=lambda s: s.end_ns))
    assert got == [("p.me", 12.0, 40.0), ("api.dispatch", 0.0, 70.0),
                   ("api.drain_wait", 90.0, 95.0)]
    # a ring that never filled holds the traced part's first spans; a
    # full one whose oldest span ended in the traced part has dropped some
    assert sorted(ps.traced_host_spans(run, ring[1:])) == sorted(got)
    assert ps.traced_host_spans(run, ring[1:], ring=5) is None
    assert ps.traced_host_spans(run, ring, ring=6) is not None
    # no dispatch in the traced part, or no traced part
    assert ps.traced_host_spans(run, [ring[0], ring[3]]) is None
    run.traced = None
    assert ps.traced_host_spans(run, ring) is None


def test_unattributed_reader(monkeypatch):
    run = _Run()
    run.traced = dict(device=DEVICE, wall_s=1.0, frames=2)
    ring = [_span("api.dispatch", -50, -40),
            _span("p.me", 12, 40, sid=2, parent=1),
            _span("api.dispatch", 0, 70, sid=1),
            _span("entropy", 60, 100, thread=2)]
    monkeypatch.setattr(ps, "program_spans", lambda: ring)
    for name in ("device_idle_unattributed_share",
                 "device_idle_unattributed_share.ai"):
        assert harness.metric_reader(name)(run) == \
            pytest.approx(100 * (1 - 40 / 70))
    monkeypatch.setattr(ps, "program_spans", lambda: None)
    assert harness.metric_reader("device_idle_unattributed_share")(run) \
        is None


def test_a_program_without_spans_has_nothing_to_read(monkeypatch):
    monkeypatch.delattr(profiler, "spans")
    assert ps.program_spans() is None


@pytest.mark.parametrize("cell", [LDP, AI])
def test_tiny_run_reports_the_span_metrics(cell, monkeypatch):
    """A traced tiny run with the program's spans on reads every span
    metric of its cell over the window (the CPU has no device trace, so
    the device metrics read nothing)."""
    monkeypatch.setattr(profiler, "_ENABLED", False)
    profiler.enable()
    correct, checks, run = run_tiny(cell, trace=True)
    assert correct, checks
    names = {m["name"] for m in tiny_cell(cell)["per_layer"]}
    got = harness.metrics_of(run, tiny_cell(cell)["per_layer"])
    want = {m for m in names if m in SPAN_METRICS} - {
        "device_wait_ms_per_frame", "device_wait_ms_per_frame.ai"}
    assert want and want <= set(got), sorted(want - set(got))
    assert all(got[m]["value"] > 0 for m in want)
