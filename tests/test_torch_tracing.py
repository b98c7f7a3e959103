"""The port's spans (homerhevc_torch.utils.profiler) on the CPU at 128x64:
an rd=FAST IPPP stream (1 I frame, then one chunk of 4 P frames) and a
2-frame all-intra chunk through encode_async/flush, with spans on.

Every p.* stage nests in a p.frame, every p.frame in its chunk's
api.dispatch; the worker's transfer and entropy spans carry the chunk
id of their dispatch; the bytes are the same with spans on and off, and
with spans off nothing is recorded.  An all-intra chunk spans each
frame's dense decision once and each wavefront step once, as many as
the i.steps counter and the plan count.  A span's start and end hold
the torch profiler's range of the same name, on the same clock."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from homerhevc_torch import api
from homerhevc_torch.config import EncoderConfig
from homerhevc_torch.models import intra_frame
from homerhevc_torch.utils import profiler
from homerhevc_torch.utils.synthetic import synthetic_video

torch.set_num_threads(1)

W, H = 128, 64
# the I frames without NxN 4x4 PUs keep the streams short
FAST = dict(width=W, height=H, max_pred_depth=3)
P_STAGES = {"p.me", "p.merge", "p.fallback", "p.intra_pref", "p.split8",
            "p.quadtree", "p.chroma", "p.fallback_chroma", "p.deblock",
            "p.sao", "p.pack"}


@pytest.fixture
def spans_on(monkeypatch):
    """Spans on, on an empty ring, for the test; as before after it."""
    monkeypatch.setattr(profiler, "_ENABLED", False)
    profiler.enable()
    profiler.reset()


def _stream(cfg, frames) -> bytes:
    enc = api.Encoder(cfg, device="cpu")
    out = []
    for f in frames:
        out += enc.encode_async(*f)
    out += enc.flush()
    enc.close()
    assert len(out) == len(frames)
    return b"".join(f.nalus for f in out)


def _inside(child, parent) -> bool:
    return (child.parent == parent.id and child.chunk == parent.chunk
            and parent.start_ns <= child.start_ns <= child.end_ns
            <= parent.end_ns)


def test_ippp_spans_nest_by_layer_and_chunk(spans_on, monkeypatch):
    cfg = EncoderConfig(frames_per_launch=4, **FAST)
    frames = synthetic_video(5, H, W, plants=4, diverge=16, quads=16)
    on = _stream(cfg, frames)
    got = profiler.spans()
    by_id = {s.id: s for s in got}
    dispatch = [s for s in got if s.name == "api.dispatch"]
    assert [(s.attrs["kind"], s.attrs["frames"]) for s in dispatch] == \
        [("i", 1), ("p", 4)]
    i_chunk, p_chunk = (s.chunk for s in dispatch)
    assert i_chunk != p_chunk
    p_frames = [s for s in got if s.name == "p.frame"]
    assert len(p_frames) == 4
    assert all(_inside(s, dispatch[1]) for s in p_frames)
    stages = [s for s in got if s.name in P_STAGES]
    assert {s.name for s in stages} == P_STAGES
    assert len(stages) == 4 * len(P_STAGES)
    assert all(_inside(s, by_id[s.parent]) and by_id[s.parent].name ==
               "p.frame" for s in stages)
    uploads = [s for s in got if s.name == "api.upload"]
    assert [by_id[s.parent] for s in uploads] == dispatch
    main = dispatch[0].thread
    worker = [s for s in got if s.name in ("transfer", "entropy")]
    assert sorted((s.name, s.chunk) for s in worker) == sorted(
        [("transfer", i_chunk), ("transfer", p_chunk),
         ("entropy", i_chunk)] + [("entropy", p_chunk)] * 4)
    assert all(s.thread != main and s.parent is None for s in worker)
    assert profiler.report()["p.frame"]["calls"] == 4

    monkeypatch.setattr(profiler, "_ENABLED", False)
    profiler.reset()
    assert _stream(cfg, frames) == on
    assert profiler.spans() == got
    assert profiler.report() == {} and profiler.counters() == {}


def test_all_intra_chunk_spans_each_frame_and_step(spans_on):
    cfg = EncoderConfig(intra_period=1, intra_frames_per_launch=2, **FAST)
    _stream(cfg, synthetic_video(2, H, W, quads=16))
    got = profiler.spans()
    (dispatch,) = [s for s in got if s.name == "api.dispatch"]
    assert dispatch.attrs == dict(kind="i_chunk", frames=2)
    calls = {k: v["calls"] for k, v in profiler.report().items()}
    n_plan = len(intra_frame.build_plan(W, H, 64, (W, H), cfg.tiles))
    assert calls["i.step"] == profiler.counters()["i.steps"] == n_plan
    assert calls["i.dense"] == calls["i.deblock"] == calls["i.sao"] == \
        calls["i.pack"] == 2
    for s in got:
        if s.name.startswith("i."):
            assert _inside(s, dispatch), s


def test_spans_share_the_profilers_clock(monkeypatch):
    monkeypatch.setattr(profiler, "_ENABLED", False)
    assert profiler.stage("a") is profiler.stage("b")       # the no-op
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiler.stage("off"):
            torch.ones(4).add_(1)
        profiler.enable()
        with profiler.stage("x"):
            torch.ones(4).add_(1)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    (span,) = [s for s in profiler.spans() if s.name == "x"]
    ev = events["x"]
    assert span.start_ns <= ev.start_ns() <= ev.start_ns() + \
        ev.duration_ns() <= span.end_ns
    assert "off" in events              # a range even with spans off
    assert all(s.name != "off" for s in profiler.spans())
