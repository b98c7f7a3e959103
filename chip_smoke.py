"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. build the CUDA kernels (nvcc, sm_90a) and the native entropy library
     from the sources in this checkout;
  2. hold every kernel against its plain PyTorch version on the card,
     bit for bit, at the shapes of the paths of phases 5 and 7 (the
     gathers' stacks of R = 1, 2 and 4 planes) and around them: clamped
     origins and plane index, outputs that are not a multiple of 4 words
     or of a CTA's tile, window sizes and block sizes that take the
     kernels' run-time instantiations, planted slab-search ties (the
     far-corner tie must resolve to flat index 0), values at the top of
     their real range;
  3. encode 176x144 on cuda and on cpu, at rd=ULTRAFAST (1 I + 4 P), at
     rd=FAST (six frames with isolated new blocks, divergent motion and
     a scene cut that restarts the GOP), at rd=FULL with two reference
     pictures (eight such frames with a flicker, the first P after each
     IDR masked to one reference), under CBR (1 I + 8 P, per-CTU QP with
     cu_qp_delta), under VBR with WPP substreams (1 I + 4 P), all-intra
     with a 2x2 tile grid and the default scaling lists (six frames in
     chunks of four, the second padded) and IPPP with the default
     scaling lists (1 I + 4 P): the Annex-B bytes and the
     reconstructions must be identical;
  4. the rd=ULTRAFAST path: 1280x720 IPPP at QP32, 1 I + 4 P frames
     through Encoder.encode_async/flush: every kernel launched, at the
     path's shapes;
  5. the default configuration: 1280x720 IPPP at QP32, rd=FAST, 1 I +
     8 P frames through Encoder.encode_async/flush, on video whose
     content fires the P frames' intra fallback and 8x8 split and the I
     frame's NxN; every kernel must have been launched at every call site
     of the path; prints the tools' counts per frame and fps;
  6. the rate-controlled path, the README's console example: 1280x720
     CBR at 1250 kbps and 25 fps, rd=FAST, 1 I + 8 P frames through
     Encoder.encode_async/flush on phase 5's video: every kernel launched
     at every call site, each equal to its plain version on one CBR P
     frame's recorded inputs; prints per frame the slice QP, the per-CTU
     QP range and the bits, the achieved rate against the target, P fps
     and the I frame's seconds;
  7. this slice's path: 1280x720 IPPP at QP32, rd=FULL (the I frame's
     top-3 full-RD mode refinement) with two reference pictures, 1 I +
     8 P frames through Encoder.encode_async/flush on phase 5's video
     plus a flicker on odd frames over the left half: every kernel
     launched at every call site (ME on both references: 4 slab searches
     per P frame), each equal to its plain version on one P frame's
     recorded inputs; prints the share of ref 1 per frame, P fps and the
     I frame's seconds;
  8. this slice's path, all-intra: 1280x720 at QP32 with intra_period=1,
     tile_auto (a 4x3 tile grid) and the default scaling lists, 8 frames
     of phase 5's video through Encoder.encode_async/flush as one chunk
     of intra_frames_per_launch=8, then its first frame alone through
     Encoder.encode (one frame per wavefront step), which must give the
     chunk's bytes for it: no kernel may be launched (the I frame has
     none); prints the wavefront steps with and without the tiles, the
     chunk's and the single frame's seconds, bits and PSNR per frame, and
     the device operations and wall time of one wavefront step at 8
     frames and at 1 (step 10, run again after its run).
The line before the last two is {"kernels": [...]}: per kernel, on one
phase-7 P frame's inputs, its launches over the phase, error, time
(median and spread of 5 runs of 50), the plain version's and a PyTorch
call's time and its bound, and the same for phase 5 (`rd_fast_path`);
then the card's name and power limit; the last line of stdout is
{"ok": true, "device": {...}}.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: CUDA is not available")

from homerhevc_torch.api import Encoder                       # noqa: E402
from homerhevc_torch.config import (                        # noqa: E402
    BitrateMode, EncoderConfig, RDMode)
from homerhevc_torch.entropy import binding                   # noqa: E402
from homerhevc_torch.models import schedule                   # noqa: E402
from homerhevc_torch.ops import kernels                       # noqa: E402
from homerhevc_torch.profile_main import StepProbe            # noqa: E402
from homerhevc_torch.utils.synthetic import synthetic_video   # noqa: E402

DEV = torch.device("cuda")
# Published H100 SXM peaks at 700 W (NVIDIA data sheet): device memory
# 3.35 TB/s; 67 TFLOP/s float32 outside the tensor cores, used here for
# the slab search's 32-bit integer sub/abs/add (the card's int32 rate is
# no higher, so the bound stays a lower bound on time)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12
KERNELS = {
    "gather_windows": dict(
        source="homerhevc_torch/csrc/gather_windows.cu",
        replaces="homerhevc_tpu/ops/pallas_kernels.py:87"),
    "gather_windows_ref": dict(
        source="homerhevc_torch/csrc/gather_windows.cu",
        replaces="homerhevc_tpu/ops/pallas_kernels.py:152"),
    "slab_search": dict(
        source="homerhevc_torch/csrc/slab_search.cu",
        replaces="homerhevc_tpu/ops/pallas_kernels.py:237"),
}


def log(*a):
    print(*a, flush=True)


def i32(a) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a, np.int32), device=DEV)


def same(got: torch.Tensor, want: torch.Tensor, what: str) -> int:
    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}")
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    if err != 0:
        raise AssertionError(f"{what}: kernel differs from plain, "
                             f"max abs err {err}")
    return err


SLEEP_CYCLES_PER_S = 2.0e9     # >= the H100's top SM clock (1.98 GHz)


def time_ms(fn, reps: int, repeats: int = 5) -> tuple:
    """Device milliseconds per call (CUDA events): the median and the
    (min, max) of `repeats` runs of `reps` calls each.  Each run starts
    behind a spin kernel twice as long as the host takes to queue the
    run, so the card finds the calls queued back to back and the time is
    the device's, not the host's queueing rate."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    runs = []
    for _ in range(repeats):
        torch.cuda._sleep(int(min(2 * host_s, 0.5) * SLEEP_CYCLES_PER_S))
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        runs.append(a.elapsed_time(b) / reps)
    return float(np.median(runs)), (min(runs), max(runs))


# ---------------------------------------------------------------- phase 1
def phase_build():
    t0 = time.perf_counter()
    secs = kernels.build(verbose=True)
    binding.load_library()
    log(f"[build] kernels {secs} native+all {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------- phase 2
def main_path_calls(cfg):
    """The shapes of the kernel calls one P frame makes at this config:
    name -> list of (n, size, plane shape) or (h, w, bs, ry, rx).  With
    two references ME runs on each, and every luma MC and split8 window
    reads a stack of the R = 2 luma planes, chroma MC one of R = 4
    (U0, U1, V0, V1).  rd=FULL's P frame is rd=FAST's."""
    h, w = cfg.padded_height, cfg.padded_width
    n = (h // 16) * (w // 16)
    pad = 144                                   # me.REF_PAD
    half = (h // 2 + 2 * 78, w // 2 + 2 * 78)   # coarse refine pad 6+72
    full = (h + 2 * pad, w + 2 * pad)
    chroma = (h // 2 + pad, w // 2 + pad)
    r = cfg.num_ref_frames
    # luma MC after ME: one plane, or the stack of both references
    mc_name, mc_full = (("gather_windows", full) if r == 1 else
                        ("gather_windows_ref", (2,) + full))
    calls = dict(
        gather_windows=[(n, 20, half), (2 * n, 22, full), (n, 25, full)] * r,
        gather_windows_ref=[(2 * n, 11, (2 * r,) + chroma)],
        slab_search=[(h // 8, w // 8, 2, 8, 16),
                     (h // 2, w // 2, 8, 3, 3)] * r)
    rounds = 1 if cfg.rd_mode == RDMode.RD_ULTRAFAST else 2
    calls[mc_name] += [(2 * n, 23, mc_full)] * rounds   # merge left/top
    if cfg.rd_mode != RDMode.RD_ULTRAFAST:
        k = min(512, n)                         # fallback and split caps
        calls["gather_windows"] += (
            [(k, 33, (1 + h + 16, 1 + w + 16))] * 2     # fallback ADI x2
            + [(k, 17, (1 + h // 2 + 8, 1 + w // 2 + 8))] * 4)  # fb chroma
        calls[mc_name] += [
            (4 * k, 14, mc_full), (4 * k, 15, mc_full),  # split8 refine, MC
            ((h // 32) * (w // 32), 39, mc_full),        # quadtree majority
            ((h // 64) * (w // 64), 71, mc_full)]
        calls["gather_windows_ref"].append((8 * k, 7, (2 * r,) + chroma))
    return calls


def gather_args(rng, n, size, shape):
    plane = i32(rng.integers(0, 1 << 20, shape))
    hp, wp = shape[-2:]
    by = rng.integers(-8, hp - size + 8, n)
    bx = rng.integers(-8, wp - size + 8, n)
    k = min(n, 3)                               # clamped origins
    by[:k] = (-5, hp - 1, hp + 40)[:k]
    bx[:k] = (wp + 9, -1, wp - 1)[:k]
    return plane, i32(by), i32(bx)


def plant_far_corners(cur, slab, b0, b1, bs, ry, rx):
    """Exact matches of the cur block at (b0, b1) at flat index 0 and at
    the last, (2ry, 2rx): equal |mv| penalties, so index 0 must win.
    Where bs > 2r the two planted regions overlap, and the block's
    bottom-right corner is made equal to its top-left one."""
    oy, ox = bs - 2 * ry, bs - 2 * rx
    if oy > 0 and ox > 0:
        cur[b0 + 2 * ry:b0 + bs, b1 + 2 * rx:b1 + bs] = \
            cur[b0:b0 + oy, b1:b1 + ox]
    blk = cur[b0:b0 + bs, b1:b1 + bs].copy()
    slab[b0:b0 + bs, b1:b1 + bs] = blk
    slab[b0 + 2 * ry:b0 + 2 * ry + bs, b1 + 2 * rx:b1 + 2 * rx + bs] = blk


def slab_args(rng, h, w, bs, ry, rx, lo=0, hi=1020, far_corners=False):
    cur = rng.integers(lo, hi, (h, w))
    slab = rng.integers(lo, hi, (h + 2 * ry, w + 2 * rx))
    # planted exact matches at two offsets of equal |mv| cost
    b0, b1 = min(4 * bs, h - bs), min(4 * bs, w - bs)
    blk = cur[b0:b0 + bs, b1:b1 + bs]
    slab[ry + b0 - 1:ry + b0 - 1 + bs, rx + b1:rx + b1 + bs] = blk
    slab[ry + b0:ry + b0 + bs, rx + b1 - 1:rx + b1 - 1 + bs] = blk
    # a block whose every offset ties (flat content)
    cur[:bs, :bs] = 7
    slab[:2 * ry + bs, :2 * rx + bs] = 7
    if far_corners:
        plant_far_corners(cur, slab, (h // bs // 2) * bs,
                          (w // bs // 2) * bs, bs, ry, rx)
    return i32(cur), i32(slab)


def slab_cases(calls):
    """Phase 2's slab-search cases: (h, w, bs, ry, rx, lo, hi, far)."""
    cases = []
    for (h, w, bs, ry, rx) in calls:
        # the main path's shape and value range (hi exclusive)
        cases.append((h, w, bs, ry, rx, 0, 1020, False))
        # one more row and column of output blocks than the main path
        # (not a multiple of a CTA's tile), the far-corner tie, and the
        # values' real top: sums of 64 pixels at the eighth-res call,
        # of 4 at the half-res one
        top = 16321 if bs == 2 else 1021
        cases.append((h + bs, w + bs, bs, ry, rx, 0, top, True))
        cases.append((h + bs, w + bs, bs, ry, rx, top - 1021, top, True))
    # block sizes of the run-time instantiation and the 4x4 one, a
    # radius whose tile needs shared memory past 48 KB, and one whose
    # 2 x 4 tile does not fit at all (one block per CTA)
    cases += [(30, 45, 3, 2, 5, 0, 1020, True),
              (24, 40, 4, 2, 5, 0, 1020, True),
              (64, 64, 8, 90, 90, 0, 1020, True),
              (16, 16, 8, 108, 108, 0, 1020, True)]
    return cases


def gather_cases(calls):
    """Phase 2's gather cases: (name, n, size, plane shape)."""
    cases = []
    for name in ("gather_windows", "gather_windows_ref"):
        for n, size, shape in calls[name]:
            # one window more than the main path gives
            cases.append((name, n + 1, size, shape))
        shape = calls[name][0][2]
        # n * size^2 not a multiple of 4, n below one CTA's stride,
        # sizes outside the templated list (run-time size)
        cases += [(name, 4097, 23, shape), (name, 3, 25, shape),
                  (name, 1001, 13, shape), (name, 5, 1, shape),
                  (name, 333, 2, shape)]
    return cases


def phase_compare(cfgs):
    """Edge cases at the shapes of the paths of `cfgs` and around them:
    clamped origins and plane index, planted ties, ragged tiles and
    tails, sizes and radii off the main path."""
    rng = np.random.default_rng(0)
    calls = {}
    for cfg in cfgs:
        for name, v in main_path_calls(cfg).items():
            calls.setdefault(name, [])
            calls[name] += [c for c in v if c not in calls[name]]
    for name, n, size, shape in gather_cases(calls):
        plane, by, bx = gather_args(rng, n, size, shape)
        if name == "gather_windows":
            got = kernels.gather_windows(plane, by, bx, size)
            want = kernels.gather_windows_plain(plane[None], None, by, bx,
                                                size)
        else:
            ri = i32(rng.integers(-1, shape[0] + 1, n))
            got = kernels.gather_windows_ref(plane, ri, by, bx, size)
            want = kernels.gather_windows_plain(plane, ri, by, bx, size)
        same(got, want, f"{name} n={n} size={size}")
    for (h, w, bs, ry, rx, lo, hi, far) in slab_cases(calls["slab_search"]):
        cur, slab = slab_args(rng, h, w, bs, ry, rx, lo, hi, far)
        got = kernels.slab_search(cur, slab, bs, ry, rx)
        same(got, kernels.slab_search_plain(cur, slab, bs, ry, rx),
             f"slab_search {h}x{w} bs={bs} r=({ry},{rx}) values {lo}..{hi}")
        if far:
            b0, b1 = h // bs // 2, w // bs // 2
            assert int(got[b0, b1]) == 0, \
                f"far-corner tie: got index {int(got[b0, b1])}"
    # argmin's first-minimum rule on the card (the port relies on it)
    x = torch.tensor([[3, 1, 1, 2], [0, 0, 0, 0]], device=DEV)
    assert torch.argmin(x, 1).tolist() == [1, 0], "argmin tie rule"
    assert torch.argmin(x.T.contiguous(), 0).tolist() == [1, 0]
    log(f"[compare] all kernels bit-identical to their plain versions")


# ---------------------------------------------------------------- phase 3
def encode_all(enc, frames):
    out = []
    for f in frames:
        out += enc.encode_async(*f)
    out += enc.flush()
    return out


def fast_video(n, h, w):
    """Video whose content fires the rd=FAST tools: isolated new blocks
    (P intra fallback), divergent 8x8 motion (8x8 inter split), striped
    quadrants (I-frame NxN and TU split)."""
    return synthetic_video(n, h, w, plants=64, diverge=128, quads=64)


def phase_cpu_parity():
    small = dict(width=176, height=144, qp=32, intra_period=100)
    rc_video = synthetic_video(9, 144, 176, plants=4, diverge=32)
    cut_video = synthetic_video(6, 144, 176, plants=8, diverge=32, quads=32,
                                scene_cut=4)
    for cfg, frames, sync in (
            (EncoderConfig(rd_mode=RDMode.RD_ULTRAFAST, **small),
             synthetic_video(5, 144, 176), False),
            (EncoderConfig(**small), cut_video, True),
            # two references: the first P after each IDR has one; the
            # eighth frame predicts from both pictures of the restarted GOP
            (EncoderConfig(rd_mode=RDMode.RD_FULL, num_ref_frames=2,
                           **small),
             synthetic_video(8, 144, 176, plants=8, diverge=32, quads=32,
                             scene_cut=4, flicker=12), True),
            (EncoderConfig(bitrate_mode=BitrateMode.CBR, bitrate=150,
                           **small), rc_video, False),
            (EncoderConfig(bitrate_mode=BitrateMode.VBR, bitrate=150,
                           wpp_substreams=True, **small), rc_video[:5],
             False),
            (EncoderConfig(**dict(small, intra_period=1),
                           intra_frames_per_launch=4, tile_cols=2,
                           tile_rows=2, scaling_lists=True),
             fast_video(6, 144, 176), False),
            (EncoderConfig(scaling_lists=True, **small),
             synthetic_video(5, 144, 176, plants=8, diverge=32, quads=32),
             False)):
        name = cfg.rd_mode.name if cfg.bitrate_mode == BitrateMode.FIXED_QP \
            else cfg.bitrate_mode.name + ("+WPP" if cfg.wpp_substreams
                                          else "")
        if cfg.num_ref_frames == 2:
            name += "+2ref"
        if cfg.intra_period == 1:
            name += f"+all-intra+tiles{cfg.tiles}"
        if cfg.scaling_lists:
            name += "+scaling-lists"
        res = {}
        for dev in ("cuda", "cpu"):
            enc = Encoder(cfg, device=dev)
            # rd=FAST through encode(): each frame's scene check lands
            # before the next frame, so the cut restarts the GOP
            out = ([enc.encode(*f) for f in frames] if sync
                   else encode_all(enc, frames))
            res[dev] = ([f.nalus for f in out], [f._is_idr for f in out],
                        [r.cpu().numpy() for r in enc._ref
                         + (enc._ref2 or ())],
                        [f._qp for f in out])
        assert len(res["cuda"][0]) == len(frames)
        assert res["cuda"][0] == res["cpu"][0], \
            f"{name}: cuda/cpu Annex-B bytes differ"
        for a, b in zip(res["cuda"][2], res["cpu"][2]):
            assert np.array_equal(a, b), \
                f"{name}: cuda/cpu reconstructions differ"
        if sync:
            assert res["cuda"][1] == [i in (0, 5) for i in
                                      range(len(frames))], res["cuda"][1]
        if cfg.intra_period == 1:
            assert all(res["cuda"][1]), res["cuda"][1]
        if cfg.bitrate_mode == BitrateMode.CBR:
            assert len(set(res["cuda"][3][1:])) >= 2, \
                f"CBR kept one P-frame QP: {res['cuda'][3]}"
        log(f"[parity] 176x144 {name} {len(frames)} frames (IDR at "
            f"{[i for i, x in enumerate(res['cuda'][1]) if x]}, QPs "
            f"{res['cuda'][3]}): cuda == cpu "
            f"({sum(len(x) for x in res['cuda'][0])} bytes)")


# ------------------------------------------------------------ phases 4-6
def psnr(a, b) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def record_calls(fn):
    """Run fn with every kernel wrapper recording a copy of its
    arguments; returns {name: [args, ...]} in call order."""
    calls = {k: [] for k in KERNELS}
    orig = {k: getattr(kernels, k) for k in KERNELS}

    def recorder(name):
        def call(*args):
            calls[name].append(tuple(
                a.clone() if isinstance(a, torch.Tensor) else a
                for a in args))
            return orig[name](*args)
        return call
    for k in KERNELS:
        setattr(kernels, k, recorder(k))
    try:
        fn()
    finally:
        for k, f in orig.items():
            setattr(kernels, k, f)
    return calls


def tool_counts(rec) -> dict:
    """CUs of the rd=FAST tools in one FrameRecord (4x4 granules): NxN
    8x8 CUs of an I frame; intra 16x16 CUs and 8x8-split 16x16 blocks of
    a P frame."""
    if rec.is_idr:
        return dict(nxn=0 if rec.part_size is None
                    else int(rec.part_size.sum()) // 4)
    return dict(intra=int(rec.pred_mode.sum()) // 16,
                split8=int((rec.cu_depth == 3).sum()) // 16)


def drive(cfg, frames, label):
    """One path: frames[0] as the I frame, then the P frames in chunks of
    cfg.frames_per_launch through encode_async/flush.  The launch counts
    are zeroed just before and read just after; the wrappers' arguments
    are recorded in the first chunk, and the chunks after it are timed.
    Returns (counts, one P frame's calls, FrameRecords, coded frames,
    I-frame seconds, P fps of the timed chunks)."""
    k = cfg.frames_per_launch
    n_p = len(frames) - 1
    assert n_p % k == 0, (n_p, k)
    recs = []
    real = binding.encode_slice

    def spy(ccfg, rec):
        recs.append(rec)
        return real(ccfg, rec)
    binding.encode_slice = spy
    try:
        enc = Encoder(cfg)
        out = []
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out += enc.encode_async(*frames[0])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rec = record_calls(lambda: [out.extend(enc.encode_async(*f))
                                    for f in frames[1:1 + k]])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for f in frames[1 + k:]:
            out += enc.encode_async(*f)
        out += enc.flush()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        counts = kernels.launch_counts()
    finally:
        binding.encode_slice = real
    assert len(out) == 1 + n_p and len(recs) == 1 + n_p, (len(out), len(recs))
    per_frame = {}
    for name, v in rec.items():
        assert v and len(v) % k == 0, (name, len(v))
        per_frame[name] = v[:len(v) // k]
    # phase 2 checked the edge cases at these shapes
    shapes = {name: sorted(tuple(a[0].shape) + a[2:]
                           if name == "slab_search" else
                           (a[-2].numel(), a[-1], tuple(a[0].shape))
                           for a in v) for name, v in per_frame.items()}
    assert shapes == {name: sorted(v) for name, v in
                      main_path_calls(cfg).items()}, shapes
    for name in KERNELS:
        assert counts[name] > 0, \
            f"kernel {name} was not launched on the {label} path"
        assert counts[name] == n_p * len(per_frame[name]), \
            (name, counts[name], n_p, len(per_frame[name]))
    assert not any(f._is_idr for f in out[1:]), "unexpected IDR restart"
    y = enc._ref[0].cpu().numpy()[:cfg.height, :cfg.width]
    p = psnr(frames[-1][0], y)
    assert 28.0 < p < 60.0, f"implausible Y PSNR {p:.2f} dB"
    timed = (f", {n_p - k} P frames {t3 - t2:.3f}s -> P fps "
             f"{(n_p - k) / (t3 - t2):.3f}" if n_p > k else "")
    log(f"[{label}] {cfg.width}x{cfg.height} {cfg.rd_mode.name} 1I+{n_p}P: "
        f"I frame {t1 - t0:.3f}s, first chunk (recording) {t2 - t1:.3f}s"
        f"{timed}; last-frame Y PSNR {p:.2f} dB; bits "
        f"{[f.bits for f in out]}; launches {counts}")
    p_fps = (n_p - k) / (t3 - t2) if n_p > k else None
    return counts, per_frame, recs, out, t1 - t0, p_fps


def phase_ultrafast():
    cfg = EncoderConfig(width=1280, height=720, qp=32, intra_period=100,
                        rd_mode=RDMode.RD_ULTRAFAST)
    drive(cfg, synthetic_video(5, cfg.height, cfg.width), "ultrafast")


def phase_main(n_p=8):
    """The default configuration (rd=FAST).  Returns the launch counts of
    its run and the kernel calls one P frame of its first chunk made."""
    cfg = EncoderConfig(width=1280, height=720, qp=32, intra_period=100)
    assert cfg.rd_mode == RDMode.RD_FAST
    counts, per_frame, recs, out, _, _ = drive(
        cfg, fast_video(1 + n_p, cfg.height, cfg.width), "main")
    tools = [tool_counts(r) for r in recs]
    for i, (t, f) in enumerate(zip(tools, out)):
        log(f"[tools] frame {i} {'I' if f._is_idr else 'P'}: {t}, "
            f"intra_frac {f._intra_frac:.4f}")
    for key in ("nxn", "intra", "split8"):
        assert sum(t.get(key, 0) for t in tools) > 0, \
            f"the main path's video fired no {key} CU"
    return counts, per_frame


def phase_cbr(n_p=8):
    """The rate-controlled path: the README's console example (CBR at
    1250 kbps, 25 fps) at 720p on phase 5's video.  Every kernel call of
    one P frame is held against its plain version on its recorded CBR
    inputs."""
    cfg = EncoderConfig(width=1280, height=720, intra_period=100,
                        bitrate_mode=BitrateMode.CBR, bitrate=1250,
                        frame_rate=25)
    counts, per_frame, recs, out, i_s, p_fps = drive(
        cfg, fast_video(1 + n_p, cfg.height, cfg.width), "cbr")
    err = hold_against_plain(per_frame, "CBR inputs")
    for i, (r, f) in enumerate(zip(recs, out)):
        log(f"[cbr] frame {i} {'I' if f._is_idr else 'P'}: slice QP "
            f"{r.slice_qp}, CTU QP {int(r.qp_map.min())}.."
            f"{int(r.qp_map.max())}, {f.bits} bits")
    assert any(len(np.unique(r.qp_map)) >= 2 for r in recs[1:]), \
        "no P frame coded more than one CTU QP"
    kbps = sum(f.bits for f in out) * cfg.frame_rate / len(out) / 1e3
    kbps_p = sum(f.bits for f in out[1:]) * cfg.frame_rate / n_p / 1e3
    log(f"[cbr] achieved {kbps:.1f} kbps over {len(out)} frames "
        f"({kbps_p:.1f} over the P frames) against the {cfg.bitrate} kbps "
        f"target; P fps {p_fps:.3f}; I frame {i_s:.3f} s; kernels equal "
        f"to their plain versions on CBR inputs (max abs err {err}); "
        f"launches {counts}")


def phase_two_ref(n_p=8):
    """This slice's path: rd=FULL (the I frame's top-3 full-RD mode
    refinement) with two reference pictures at 720p, on phase 5's video
    plus a flicker on odd frames over the left half, where the picture
    two back is the better reference.  ME runs on both references (4
    slab searches per P frame), and every kernel call of one P frame is
    held against its plain version on its recorded inputs.  Returns the
    launch counts and that P frame's calls."""
    cfg = EncoderConfig(width=1280, height=720, qp=32, intra_period=100,
                        rd_mode=RDMode.RD_FULL, num_ref_frames=2)
    frames = synthetic_video(1 + n_p, cfg.height, cfg.width, plants=64,
                             diverge=128, quads=64, flicker=20)
    counts, per_frame, recs, out, i_s, p_fps = drive(cfg, frames, "two_ref")
    assert counts["slab_search"] == 4 * n_p, counts
    err = hold_against_plain(per_frame, "two-reference inputs")
    shares = []
    for i, (r, f) in enumerate(zip(recs, out)):
        if f._is_idr:
            continue
        inter = r.pred_mode == 0
        shares.append(float(r.ref_idx[inter].mean()) if inter.any() else 0.0)
        log(f"[two_ref] frame {i} P: num_ref_l0 {r.num_ref_l0}, ref 1 "
            f"share {shares[-1]:.4f} of the inter area, {f.bits} bits")
    assert shares[0] == 0.0 and max(shares[1:]) > 0.0, shares
    log(f"[two_ref] P fps {p_fps:.3f}; I frame (rd=FULL) {i_s:.3f} s; "
        f"kernels equal to their plain versions on two-reference inputs "
        f"(max abs err {err}); launches {counts}")
    return counts, per_frame


def phase_all_intra(k=8, size=(1280, 720), tiles=(4, 3), n_steps=(146, 38)):
    """This slice's path: all-intra with tile_auto (at 720p a 4x3 grid:
    146 wavefront steps become 38) and the default scaling lists, one
    chunk of k frames, then the first frame alone.  No kernel may
    launch.  Returns the numbers it prints."""
    cfg = EncoderConfig(width=size[0], height=size[1], qp=32,
                        intra_period=1, tile_auto=True, scaling_lists=True,
                        intra_frames_per_launch=k)
    assert cfg.tiles == tiles, cfg.tiles
    slots = (cfg.padded_width // 32, cfg.padded_height // 32, 2)
    steps = {t: schedule.wavefront_schedule(*slots, t)[1]
             for t in (None, cfg.tiles)}
    assert (steps[None], steps[cfg.tiles]) == n_steps, steps
    frames = fast_video(k, cfg.height, cfg.width)
    enc = Encoder(cfg)
    recon = []
    real = enc._dispatch_i_chunk

    def spy(fr):
        pend = real(fr)
        recon.append(pend["out"]["recon_y"][:len(fr)])
        return pend
    enc._dispatch_i_chunk = spy
    kernels.reset_launch_counts()
    with StepProbe(which=10) as probe:
        t0 = time.perf_counter()
        out = encode_all(enc, frames)
        torch.cuda.synchronize()
        chunk_s = time.perf_counter() - t0
    step_k = probe.replay()
    with StepProbe(which=10) as probe:
        t0 = time.perf_counter()
        one = Encoder(cfg).encode(*frames[0], compute_recon=False)
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t0
    step_1 = probe.replay()
    counts = kernels.launch_counts()
    assert not any(counts.values()), f"the all-intra path launched {counts}"
    assert len(out) == k and all(f._is_idr for f in out), len(out)
    assert one.nalus == out[0].nalus, "one frame alone != its chunk's bytes"
    rec = recon[0].cpu().numpy()[:, :cfg.height, :cfg.width]
    psnrs = [float(psnr(f[0], r)) for f, r in zip(frames, rec)]
    assert all(28.0 < p < 60.0 for p in psnrs), psnrs
    assert step_k["slots"] == k * step_1["slots"], (step_k, step_1)
    res = dict(steps_untiled=steps[None], steps_tiled=steps[cfg.tiles],
               chunk_s=chunk_s, s_per_frame=chunk_s / k, one_frame_s=one_s,
               bits=[f.bits for f in out], psnr_y=psnrs,
               step_k8=step_k, step_k1=step_1)
    log(f"[all_intra] {cfg.width}x{cfg.height} QP32 tiles {cfg.tiles} "
        f"scaling lists: "
        f"wavefront steps {steps[cfg.tiles]} (untiled {steps[None]}); "
        f"chunk of {k} {chunk_s:.3f}s ({chunk_s / k:.3f}s per frame), one "
        f"frame alone {one_s:.3f}s; bits {res['bits']}; Y PSNR "
        f"{[round(p, 2) for p in psnrs]}; step 10 again: {k} frames "
        f"{step_k}, 1 frame {step_1}; launches {counts}")
    return res


def hold_against_plain(per_frame, what: str) -> int:
    """Every recorded kernel call against its plain version; returns the
    largest difference (0, or it raises)."""
    err = 0
    for name, calls in per_frame.items():
        for args in calls:
            err = max(err, same(getattr(kernels, name)(*args),
                                plain_of(name, args), f"{name} on {what}"))
    return err


def plain_of(name, args):
    """The plain PyTorch version of a recorded kernel call."""
    if name == "gather_windows":
        plane, by, bx, size = args
        return kernels.gather_windows_plain(plane[None], None, by, bx, size)
    if name == "gather_windows_ref":
        return kernels.gather_windows_plain(*args)
    return kernels.slab_search_plain(*args)


def gather_read_bytes(shape, ri, by, bx, size) -> int:
    """Bytes of the planes a gather must read: the distinct 32-byte
    sectors its window rows touch, from this call's clamped origins."""
    r, hp, wp = shape
    byc = by.cpu().numpy().clip(0, hp - size).astype(np.int64)
    bxc = bx.cpu().numpy().clip(0, wp - size).astype(np.int64)
    ric = (np.zeros_like(byc) if ri is None else
           ri.cpu().numpy().clip(0, r - 1).astype(np.int64))
    rows = (ric * hp + byc)[:, None] + np.arange(size)[None]
    first = (rows * wp + bxc[:, None]) * 4 // 32
    last = (rows * wp + bxc[:, None] + size - 1) * 4 // 32
    n_sec = (r * hp * wp * 4 + 31) // 32
    edge = np.zeros(n_sec + 1, np.int64)
    np.add.at(edge, first.ravel(), 1)
    np.add.at(edge, last.ravel() + 1, -1)
    return 32 * int((np.cumsum(edge[:n_sec]) > 0).sum())


def unfold_gather(planes, ri, by, bx, size):
    """One PyTorch call computing a window gather: advanced indexing
    into an unfold view of the planes.  Clamping the indices happens
    here, outside the returned (timed) function."""
    r, hp, wp = planes.shape
    byc = by.clamp(0, hp - size).long()
    bxc = bx.clamp(0, wp - size).long()
    if ri is None:
        view = planes[0].unfold(0, size, 1).unfold(1, size, 1)
        return lambda: view[byc, bxc]
    ric = ri.clamp(0, r - 1).long()
    view = planes.unfold(1, size, 1).unfold(2, size, 1)
    return lambda: view[ric, byc, bxc]


def kernel_report(counts, per_frame):
    """Per kernel, on the inputs one P frame gave it: the largest
    difference from the plain version, the time of the frame's calls
    (kernel, plain version and, for the gathers, one PyTorch call that
    computes the same function; median and spread of 5 runs) and the
    least time the card could take, in all and per call site (`calls`:
    the call's windows n or blocks, window size or (bs, ry, rx), plane
    stack shape and bound)."""
    rows = []
    for name, calls in per_frame.items():
        fns, plains, libs, sites = [], [], [], []
        bound = by_ops = 0.0
        err = 0
        for args in calls:
            f = (lambda a=args, k=name: getattr(kernels, k)(*a))
            g = (lambda a=args, k=name: plain_of(k, a))
            if name == "slab_search":
                cur, slab, bs, ry, rx = args
                lib = None      # no one PyTorch call does block matching
                h, w = cur.shape
                nbytes = 4 * (cur.numel() + slab.numel()
                              + (h // bs) * (w // bs))
                ops = 3.0 * (2 * ry + 1) * (2 * rx + 1) * h * w
                site = dict(n=(h // bs) * (w // bs), size=[bs, ry, rx],
                            planes=list(slab.shape))
            elif name == "gather_windows":
                plane, by, bx, size = args
                lib = unfold_gather(plane[None], None, by, bx, size)
                n = by.numel()
                nbytes = (gather_read_bytes((1,) + tuple(plane.shape), None,
                                            by, bx, size)
                          + 4 * (2 * n + n * size * size))
                ops = 0.0
                site = dict(n=n, size=size, planes=[1] + list(plane.shape))
            else:
                planes, ri, by, bx, size = args
                lib = unfold_gather(planes, ri, by, bx, size)
                n = by.numel()
                nbytes = (gather_read_bytes(tuple(planes.shape), ri, by, bx,
                                            size)
                          + 4 * (3 * n + n * size * size))
                ops = 0.0
                site = dict(n=n, size=size, planes=list(planes.shape))
            err = max(err, same(f(), g(), f"{name} on main-path inputs"))
            if lib is not None:
                same(lib(), g(), f"{name}: unfold + index")
                libs.append(lib)
            fns.append(f)
            plains.append(g)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / INT32_OPS_PER_S * 1e3
            bound += max(t_bytes, t_ops)
            by_ops += t_ops - t_bytes
            sites.append(dict(site, bound_ms=max(t_bytes, t_ops)))

        def frame(fs):
            return lambda: [fn() for fn in fs]
        ms, spread = time_ms(frame(fns), 50)
        plain_ms, _ = time_ms(frame(plains), 5)
        library_ms = time_ms(frame(libs), 50)[0] if libs else None
        rows.append(dict(
            name=name, route="cuda", source=KERNELS[name]["source"],
            replaces=KERNELS[name]["replaces"], launches=counts[name],
            max_abs_err=err, ms=ms, ms_spread=list(spread),
            plain_ms=plain_ms, bound_ms=bound,
            bound_by="operations" if by_ops > 0 else "bytes",
            library_ms=library_ms, calls=sites))
    return rows


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_build()
    size = dict(width=1280, height=720, qp=32, intra_period=100)
    phase_compare([EncoderConfig(**size),
                   EncoderConfig(rd_mode=RDMode.RD_FULL, num_ref_frames=2,
                                 **size)])
    phase_cpu_parity()
    phase_ultrafast()
    fast_counts, fast_calls = phase_main()
    phase_cbr()
    counts, per_frame = phase_two_ref()
    phase_all_intra()
    # the kernels line reports this slice's path (two references,
    # rd=FULL); each row also carries the rd=FAST path's numbers
    fast = {r["name"]: r for r in kernel_report(fast_counts, fast_calls)}
    rows = kernel_report(counts, per_frame)
    for r in rows:
        f = fast[r["name"]]
        r["rd_fast_path"] = {k: f[k] for k in (
            "launches", "ms", "ms_spread", "plain_ms", "bound_ms",
            "library_ms")}
        for label, x in (("two_ref", r), ("rd_fast", f)):
            lib = ("none" if x["library_ms"] is None
                   else f"{x['library_ms']:.4f}")
            log(f"[kernel] {r['name']} ({label} path): {x['ms']:.4f} "
                f"ms/P-frame (spread {x['ms_spread'][0]:.4f}-"
                f"{x['ms_spread'][1]:.4f}, plain {x['plain_ms']:.4f}, "
                f"library {lib}, bound {x['bound_ms']:.5f} "
                f"{r['bound_by']}), {x['launches']} launches")
    log(f"[time] phases 1-8 {time.perf_counter() - t0:.1f}s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print(json.dumps({"kernels": rows}))
    print(smi[0] if smi else "nvidia-smi: no output")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
