"""Where the time of the port's main path goes on one CUDA device.

    python -m homerhevc_torch.profile_main [qp32] [cbr1250] [full2ref]
                                           [allintra]

Encodes 1280x720 IPPP (frames_per_launch=4) from seeded synthetic video
whose content fires the rd=FAST tools, with up to three encoders (all
three unless named): at fixed QP32 in the default configuration, rd=FAST
(chip_smoke.py phase 5); under CBR at 1250 kbps and 25 fps (per-CTU QP
with cu_qp_delta; its phase 6); and at fixed QP32, rd=FULL with two
reference pictures, on the same video plus a flicker on odd frames over
the left half (its phase 7).  Each encodes its I frame (wall time only:
its wavefront launches millions of operations, more than the profiler's
post-processing can digest in a run) and a first P chunk as warm-up;
then they encode P chunks in turns, each timed by wall clock (P fps of
all from one stretch of the run); then, per encoder, a P chunk
through encode_async/flush under torch.profiler.  Prints one JSON line
per window, tagged with its configuration: its wall time and, for the
profiled P window, the share of it in which the device ran work, the
device operations launched per frame, the host and device time of each
encoder stage (the "p.*" record_function ranges: p.me, p.merge,
p.fallback, p.intra_pref, p.split8, p.quadtree, p.chroma,
p.fallback_chroma, p.deblock, p.sao, p.pack) and the kernels with the
most device time.  A last pass over one more P chunk counts the
host<->device synchronisations, in all and by source line (torch.cuda
sync debug mode).

`allintra` (only when named) encodes 1280x720 all-intra chunks
(intra_period=1, tile_auto: a 4x3 tile grid, default scaling lists,
intra_frames_per_launch=8, rd=FAST) on the same video: a warm-up chunk,
a chunk timed by wall clock, and a chunk with its stages clocked (each
frame's dense decision and each wavefront step between synchronisations;
the rest is deblocking, SAO, packing and entropy coding) and one
wavefront step under torch.profiler (its device operations, the share
of the step in which the device ran work, its top kernels).  Needs a
CUDA device.
"""
from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import time
import warnings

import torch
from torch.profiler import ProfilerActivity, profile

from homerhevc_torch.api import Encoder
from homerhevc_torch.config import BitrateMode, EncoderConfig, RDMode
from homerhevc_torch.models import intra_frame
from homerhevc_torch.utils.synthetic import synthetic_video


def _dev_attr(ev, name: str) -> float:
    """Device time attribute across torch versions (cuda_* before 2.4)."""
    if hasattr(ev, name):
        return float(getattr(ev, name))
    return float(getattr(ev, name.replace("device", "cuda")))


def _is_stage(name: str) -> bool:
    return name[:2] in ("i.", "p.")


def _busy_us(events) -> float:
    """Length of the union of the device operations' time ranges."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def _sync_sites(fn) -> tuple:
    """(count, {file:line: count} of the 40 most frequent sites) of the
    synchronising CUDA operations fn makes (all threads)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = collections.Counter(
        f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))
    return sum(sites.values()), dict(sites.most_common(40))


def _wall(name: str, fn) -> dict:
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return dict(window=name, frames=1,
                wall_ms=(time.perf_counter() - t0) * 1e3)


def _window(name: str, fn, n_frames: int):
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    rows = prof.key_averages()
    # a stage range appears as a host row (its wall time on the host and
    # the device time of the kernels launched inside it) and, on the
    # card, as a device-timeline annotation (first to last kernel)
    stages = collections.defaultdict(dict)
    for r in rows:
        if not _is_stage(r.key):
            continue
        dev_ms = _dev_attr(r, "device_time_total") / 1e3
        if r.cpu_time_total > 0:
            stages[r.key].update(host_ms=r.cpu_time_total / 1e3,
                                 kernel_ms=dev_ms, calls=r.count)
        else:
            stages[r.key]["device_span_ms"] = dev_ms
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not _is_stage(e.name)]
    kern = sorted(((_dev_attr(r, "self_device_time_total"), r.key, r.count)
                   for r in rows if not _is_stage(r.key)
                   and _dev_attr(r, "self_device_time_total") > 0),
                  reverse=True)[:12]
    return dict(window=name, frames=n_frames, wall_ms=wall_s * 1e3,
                stages=dict(stages),
                device_busy_share=_busy_us(dev) / (wall_s * 1e6),
                device_ops=len(dev) / n_frames,
                top_kernels=[dict(name=k[:80], device_ms=t / 1e3, count=c)
                             for t, k, c in kern])


class StepProbe:
    """Within the block, the arguments of wavefront step number `which`
    (counted from 1) are kept; replay() runs that step again, after the
    run (the step only writes its slots into the chunk's buffers): once
    between two synchronisations for its wall time, once under
    torch.profiler for its device operations and device-busy share.
    clock=True also times every dense decision and wavefront step of
    the run between synchronisations (`clocks`)."""

    def __init__(self, which: int, clock: bool = False):
        self.which, self.clock = which, clock
        self.calls = 0
        self.args = None
        self.clocks = collections.defaultdict(float)

    def _timed(self, name, fn):
        def call(*args):
            if not self.clock:
                return fn(*args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            self.clocks[name + "_ms"] += (time.perf_counter() - t0) * 1e3
            self.clocks[name + "_calls"] += 1
            return out
        return call

    def __enter__(self):
        self.real = (intra_frame._wavefront_step, intra_frame._dense_decision)
        step_t = self._timed("wavefront", self.real[0])

        def step(*args):
            self.calls += 1
            if self.calls == self.which:
                self.args = args
            return step_t(*args)
        intra_frame._wavefront_step = step
        intra_frame._dense_decision = self._timed("dense", self.real[1])
        return self

    def __exit__(self, *exc):
        intra_frame._wavefront_step, intra_frame._dense_decision = self.real

    @torch.inference_mode()
    def replay(self) -> dict:
        """Runs as the Encoder's dispatches run the step: its buffers are
        inference tensors."""
        step = self.real[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(*self.args)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(*self.args)
            torch.cuda.synchronize()
            prof_s = time.perf_counter() - t0
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        slots = int(self.args[0]["by"].shape[0])
        self.args = None
        return dict(step=self.which, slots=slots, device_ops=len(dev),
                    wall_ms=wall_s * 1e3,
                    device_busy_share=_busy_us(dev) / (prof_s * 1e6))


def all_intra(card: str, size=(1280, 720), k: int = 8):
    """The all-intra configuration: chunk wall time, stage clocks and one
    profiled wavefront step (see the module docstring)."""
    cfg = EncoderConfig(width=size[0], height=size[1], qp=32,
                        intra_period=1, tile_auto=True, scaling_lists=True,
                        intra_frames_per_launch=k)
    frames = synthetic_video(k, size[1], size[0], plants=64, diverge=128,
                             quads=64)
    enc = Encoder(cfg)

    def chunk():
        out = []
        for f in frames:
            out.extend(enc.encode_async(*f))
        out.extend(enc.flush())
        assert len(out) == k and all(f._is_idr for f in out)
        return out

    def emit(res):
        print(json.dumps(dict(res, config="allintra", card=card,
                              tiles=cfg.tiles)), flush=True)
    emit(dict(_wall("warmup_chunk", chunk), frames=k))
    res = _wall("i_chunk", chunk)
    emit(dict(res, frames=k, s_per_frame=res["wall_ms"] / 1e3 / k))
    with StepProbe(which=10, clock=True) as probe:
        res = _wall("i_chunk_clocked", chunk)
    emit(dict(res, frames=k, stages=dict(probe.clocks),
              profiled_step=probe.replay()))


P_FRAMES = 4
TURNS = 4            # timed P chunks per configuration, taken in turns


def _encoder(cfg, frames, emit):
    """An encoder past its I frame (timed) and one warm-up P chunk.
    Returns (coded frames, a function that encodes its next P chunk
    through encode_async/flush)."""
    enc = Encoder(cfg)
    out = []
    emit(_wall("i_frame", lambda: out.extend(enc.encode_async(*frames[0]))))
    nxt = [1]

    def chunk():
        for f in frames[nxt[0]:nxt[0] + P_FRAMES]:
            out.extend(enc.encode_async(*f))
        out.extend(enc.flush())
        nxt[0] += P_FRAMES
    chunk()                              # warm-up: allocator, libraries
    return out, chunk


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_main: CUDA is not available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    size = dict(width=1280, height=720, intra_period=100)
    configs = {"qp32": EncoderConfig(qp=32, **size),
               "cbr1250": EncoderConfig(bitrate_mode=BitrateMode.CBR,
                                        bitrate=1250, frame_rate=25,
                                        **size),
               "full2ref": EncoderConfig(qp=32, rd_mode=RDMode.RD_FULL,
                                         num_ref_frames=2, **size)}
    pick = sys.argv[1:] or list(configs)
    if "allintra" in pick:
        all_intra(card)
        pick.remove("allintra")
        if not pick:
            return
    configs = {c: configs[c] for c in pick}
    n = 1 + (3 + TURNS) * P_FRAMES
    video = dict(plants=64, diverge=128, quads=64)

    def emitter(label):
        return lambda res: print(
            json.dumps(dict(res, config=label, card=card)), flush=True)
    runs = {c: _encoder(cfg, synthetic_video(
        n, 720, 1280, flicker=20 if cfg.num_ref_frames == 2 else 0,
        **video), emitter(c)) for c, cfg in configs.items()}
    # P chunks timed in turns (a b b a ...): the host's speed drifts
    # within a run, and this alternation cancels a linear drift
    order = list(configs) + list(configs)[::-1]
    secs = {c: [] for c in configs}
    for c in order * (TURNS // 2):
        secs[c].append(_wall("p_chunk", runs[c][1])["wall_ms"] / 1e3)
    for c, (out, chunk) in runs.items():
        emit = emitter(c)
        emit(dict(window="p_chunks_in_turns", frames=P_FRAMES,
                  chunk_s=secs[c],
                  p_fps=P_FRAMES * len(secs[c]) / sum(secs[c])))
        emit(_window("p_frames", chunk, P_FRAMES))
        total, sites = _sync_sites(chunk)
        emit(dict(window="sync_sites", frames=P_FRAMES, syncs=total,
                  sites=sites))
        assert len(out) == n, len(out)
        assert not any(f._is_idr for f in out[1:]), "unexpected IDR restart"
        emit(dict(window="frames", slice_qp=[f._qp for f in out],
                  bits=[f.bits for f in out]))


if __name__ == "__main__":
    main()
