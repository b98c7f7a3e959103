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
     chunks of four, the second padded), IPPP with the default
     scaling lists (1 I + 4 P), rd=FAST with the intra fallback's serial
     pass of 16 steps (1 I + 4 P with patches of new content and a strip
     where the pan enters, through SerialEncoder; every P frame must
     commit at least 2 blocks in it), and the IPPP knobs of the console app
     through homerhevc_torch.cli.main: K1 on its synchronous path
     (-o-raw, -stats; intra_period 0, performance_mode FULL, half-pel
     ME, max_pred_depth 3, max_intra_tr_depth 0, no sign hiding, a
     skipped frame) and K2 through encode_async (integer-pel ME,
     max_pred_depth 2, no SAO, no deblocking, chroma QP offset -3), and
     K3 through Encoder (padded-size coding, no P intra fallback, no
     scene-cut restart, control() to another QP in mid-stream): the
     Annex-B bytes, the app's raw and stats files and the
     reconstructions must be identical (the cases run in four child
     processes, half the cases on each device in each,
     `chip_smoke.py --parity DEV PART PARTS FILE`);
  4. the rd=ULTRAFAST path: 1280x720 IPPP at QP32, 1 I + 8 P frames
     through Encoder.encode_async/flush: every kernel launched, at the
     path's shapes; prints P fps;
  5. the default configuration: 1280x720 IPPP at QP32, rd=FAST, 1 I +
     8 P frames through Encoder.encode_async/flush (the I frame's state
     saved by save_checkpoint in stage A, the P frames after
     load_checkpoint), on video whose
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
     8 P frames through Encoder.encode_async/flush (checkpointed after
     the I frame, as phase 5) on phase 5's video
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
     chunk's bytes for it: no kernel may be launched but SAO's three,
     once per frame (the I frame has no other); prints the wavefront steps with and without the tiles, the
     chunk's and the single frame's seconds, bits and PSNR per frame, and
     the device operations and wall time of one wavefront step at 8
     frames and at 1 (step 10, run again after its run);
  9. the console app's path at 720p: (a) `python -m
     homerhevc_torch` as a subprocess with the README's console flags
     (CBR at 1250 kbps, 25 fps, 9 frames) on phase 6's video written to a
     .yuv: its .265 must equal phase 6's bytes; it relays the app's fps
     and kbps lines; (b) homerhevc_torch.cli.main in-process at rd=
     ULTRAFAST, performance_mode FULL and half-pel ME on the same file:
     every kernel launched at the path's shapes, each equal to its plain
     version on one P frame's recorded inputs; prints the I frame's
     seconds and P fps;
 10. the multi-device path: two ranks of one torch.distributed group
     (gloo) on the one card, spawned after the kernels are built: (a)
     phase 5's 8 P frames (num_chips=2: two bands of 6 CTU rows) from
     phase 5's state after its I frame (a checkpoint, so no I frame is
     coded again) must give phase 5's bytes, frame by frame, on each
     rank, every kernel launched at the band shapes and equal to its
     plain version on each rank's recorded inputs of one band P frame;
     prints per rank the band count, launches per band P frame and P fps
     (no claim: the ranks share the card); (b) phase 8's chunk of 8 in
     two frame shards must give phase 8's bytes, with no kernel
     launched but SAO's; (c) NCCL with one rank per card runs (a) again where the
     machine has two cards, and otherwise a line says it did not run
     and why;
 11. the intra fallback's serial pass: 8 P frames at 1280x720 rd=FAST
     with fallback_serial=32 (SerialEncoder, the GOP kept) from phase 5's
     checkpoint after its I frame, on phase 5's video plus 8 patches of
     2 x 3 blocks of new flat content and a 32-pixel strip of new content
     along the right edge: every kernel launched at every call site, the
     serial steps' window reads included (one luma and two chroma
     gathers of one window per step), each equal to its plain version on
     one P frame's recorded inputs; the first P frame's bytes equal to
     the CPU's from the same checkpoint (a stage-A child, `chip_smoke.py
     --serial-cpu DIR`); prints the serial commits per frame, P fps with
     and without the pass (two encoders from the same state, chunk by
     chunk in turns) and the device operations per P frame of each;
 12. SAO's three kernels (sao_stats, sao_decide, sao_apply) against the
     plain version, byte for byte on the planes (padding included), the
     fields and the packed tail: a 720p rd=ULTRAFAST stream's own inputs
     of its I frame and first P frame (1280x768, coded 720x1280; the I
     frame's also with the all-intra cell's 4x3 tiles, the P frame's also
     without merge RDO), grain at QPs 22-37 and a mosaic of exact and
     near ties (flat CTBs, CTBs whose EO classes tie, BO windows equal
     but for the float32 order of their sums) at 720p and at 1920x1088
     coded 1080x1920, each untiled, tiled and without merge RDO; each
     kernel's device time at the P frame's shapes beside its bytes bound
     and the plain version's time; no host sync in a call; 3 launches
     per frame of the stream.  `chip_smoke.py --sao` runs phase 1 and
     this phase alone.
The work runs in two stages.  Stage A runs at once what no number of
this script times: phase 3's cases (cuda and cpu, two child processes
each), phase 9(a)'s console app, the I frames of phases 5 and 7
(children that save the encoder's state after them, `chip_smoke.py
--i-frame LABEL DIR`) and phase 11's CPU frame, while this process codes
phase 6's I frame (it
stays in flight, as in a continuous run: under CBR a flush after the I
frame would change the P frames' QPs).  These are launch-bound and leave
the card idle most of the time, so the jobs share it.  Stage B then
runs, alone, everything that is timed: phase 4, the P frames of phases
5-7 (5 and 7 from their checkpoints), phases 8, 9(b), 10, 11 and 12 and
the kernel timings.
The line before the kernels line is {"sao_kernels": [...]}, phase 12's
rows.  The line before the last two is {"kernels": [...]}: per kernel, on one
phase-7 P frame's inputs, its launches over the phase, error, time
(median and spread of 5 runs of 50), the plain version's and a PyTorch
call's time and its bound, and the same for phase 5 (`rd_fast_path`),
phase 9(b) (`cli_path`), phase 10(a) on the lower band's rank
(`band_path`, launches over its 8 band P frames) and phase 11
(`serial_path`);
then the card's name and power limit; the last line of stdout is
{"ok": true, "device": {...}}.
"""
import concurrent.futures
import contextlib
import dataclasses
import datetime
import io
import json
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist

if not torch.cuda.is_available():
    sys.exit("chip_smoke: CUDA is not available")

from homerhevc_torch import cli, tables                       # noqa: E402
from homerhevc_torch.api import Encoder                       # noqa: E402
from homerhevc_torch.config import (                        # noqa: E402
    BitrateMode, EncoderConfig, RDMode)
from homerhevc_torch.entropy import binding                   # noqa: E402
from homerhevc_torch.models import (                         # noqa: E402
    inter_frame, intra_frame, schedule)
from homerhevc_torch.ops import kernels, rdbits, sao          # noqa: E402
from homerhevc_torch.parallel import multihost                # noqa: E402
from homerhevc_torch.profile_main import StepProbe            # noqa: E402
from homerhevc_torch.profile_main import _busy_us                # noqa: E402
from homerhevc_torch.utils.synthetic import synthetic_video   # noqa: E402

DEV = torch.device("cuda")
ROOT = os.path.dirname(os.path.abspath(__file__))
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
LAUNCH_QUEUE = 900             # kernels queued ahead of the device, at most


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
def main_path_calls(cfg, bands: int = 1, serial: int = 0):
    """The shapes of the kernel calls one P frame makes at this config:
    name -> list of (n, size, plane shape) or (h, w, bs, ry, rx).  With
    two references ME runs on each, and every luma MC and split8 window
    reads a stack of the R = 2 luma planes, chroma MC one of R = 4
    (U0, U1, V0, V1).  rd=FULL's P frame is rd=FAST's.  The ME knobs
    (performance_mode, motion_estimation_precision) change no call: every
    subpel offset lies in the one window of block + 9 per block.  With
    `bands` row bands, one rank's calls: its band's blocks against the
    whole reference planes, and the intra fallback's on the whole frame
    (it runs replicated).  With the intra fallback's serial pass of
    `serial` steps, each step reads one luma window and one per chroma
    plane."""
    h, w = cfg.padded_height, cfg.padded_width
    hb = h // bands
    n = (hb // 16) * (w // 16)
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
        slab_search=[(hb // 8, w // 8, 2, 8, 16),
                     (hb // 2, w // 2, 8, 3, 3)] * r)
    rounds = 1 if cfg.rd_mode == RDMode.RD_ULTRAFAST else 2
    calls[mc_name] += [(2 * n, 23, mc_full)] * rounds   # merge left/top
    if cfg.rd_mode != RDMode.RD_ULTRAFAST:
        k = min(512, n)                         # fallback and split caps
        kf = min(512, (h // 16) * (w // 16))
        if cfg.intra_in_p:
            calls["gather_windows"] += (
                [(kf, 33, (1 + h + 16, 1 + w + 16))] * 2    # fallback ADI
                + [(kf, 17, (1 + h // 2 + 8, 1 + w // 2 + 8))] * 4)
            cap = min(serial, (h // 16) * (w // 16))
            calls["gather_windows"] += (
                [(1, 33, (1 + h + 16, 1 + w + 16))] * cap
                + [(1, 17, (1 + h // 2 + 8, 1 + w // 2 + 8))] * 2 * cap)
        calls[mc_name] += [
            (4 * k, 14, mc_full), (4 * k, 15, mc_full),  # split8 refine, MC
            ((hb // 32) * (w // 32), 39, mc_full),       # quadtree majority
            ((hb // 64) * (w // 64), 71, mc_full)]
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
        cfg, serial = cfg if isinstance(cfg, tuple) else (cfg, 0)
        for name, v in main_path_calls(cfg, serial=serial).items():
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
class SerialEncoder(Encoder):
    """Encoder whose P frames run the intra fallback's serial pass of
    `serial` steps (no knob of the encoder turns it on)."""

    def __init__(self, cfg, serial: int, **kw):
        super().__init__(cfg, **kw)
        self.serial = serial

    def _p_knobs(self) -> dict:
        return dict(super()._p_knobs(), fallback_serial=self.serial)


@contextlib.contextmanager
def serial_commits():
    """Collect, per serial luma pass run inside, the count of blocks it
    committed (a device tensor, read after the block)."""
    counts = []
    real = inter_frame._serial_luma

    def spy(*a, **k):
        out = real(*a, **k)
        counts.append(out[1][1].sum())
        return out
    inter_frame._serial_luma = spy
    try:
        yield counts
    finally:
        inter_frame._serial_luma = real


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


# The console app's IPPP knobs (homerhevc_torch.cli flags), in two groups
# that each cost one compile of the JAX reference's programs in the tests:
# K1 on the app's synchronous path, K2 on its encode_async path.
K1 = ("-qp 30 -intra_period 0 -performance_mode 0 "
      "-motion_estimation_precision 1 -max_pred_depth 3 "
      "-max_intra_tr_depth 0 -sign_hiding 0 -skipped_frames 1 "
      "-n_frames 5").split()
K2 = ("-qp 36 -motion_estimation_precision 0 -max_pred_depth 2 -sao 0 "
      "-deblocking 0 -chroma_qp_offset -3 -frame_rate 30 -n_frames 6").split()
# K3, the knobs only Encoder reaches; control() switches to QP 27 before
# frame CONTROL_AT
K3 = dict(width=176, height=144, code_true_size=False, intra_in_p=False,
          scene_change_reinit=False)
CONTROL_AT = 3
# the README's console example, without its -stats (which would take the
# synchronous path)
README_CBR = ("-widthxheight 1280x720 -frame_rate 25 -qp 32 -intra_period "
              "100 -bitrate_mode 1 -bitrate 1250 -n_frames 9").split()
CLI_UFAST = ("-widthxheight 1280x720 -qp 32 -rd 2 -performance_mode 0 "
             "-motion_estimation_precision 1 -n_frames 9").split()


def cli_cfg(flags) -> EncoderConfig:
    return cli.parse_args(flags)[0]


def write_yuv(path, frames):
    with open(path, "wb") as f:
        for planes in frames:
            for p in planes:
                f.write(np.ascontiguousarray(p).tobytes())


@contextlib.contextmanager
def recons_kept():
    """Keep a host copy of the reconstruction of every frame the frame
    programs make (a padded chunk's repeats of its last frame included)."""
    kept = []
    real = intra_frame.encode_frame, inter_frame.encode_p_frame

    def keep(fn):
        def call(*a, **k):
            out = fn(*a, **k)
            kept.append([out[f"recon_{p}"].cpu().numpy() for p in "yuv"])
            return out
        return call
    intra_frame.encode_frame = keep(real[0])
    inter_frame.encode_p_frame = keep(real[1])
    try:
        yield kept
    finally:
        intra_frame.encode_frame, inter_frame.encode_p_frame = real


def cli_case(flags, sync: bool, dev: str, d: str) -> tuple:
    """The port's console app on `dev` on d/in.yuv (176x144): (.265,
    -o-raw bytes, -stats lines, every reconstruction)."""
    base = os.path.join(d, dev)
    argv = ["-i", os.path.join(d, "in.yuv"), "-o", base + ".265",
            "-widthxheight", "176x144"] + flags
    if sync:
        argv += ["-o-raw", base + ".yuv", "-stats", base + ".jsonl"]
    with recons_kept() as kept, contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(argv, device=dev) == 0
    with open(base + ".265", "rb") as f:
        stream = f.read()
    raw = stats = None
    if sync:
        with open(base + ".yuv", "rb") as f:
            raw = f.read()
        with open(base + ".jsonl") as f:
            stats = f.read().splitlines()
    return stream, raw, stats, kept


def same_recons(a, b, what: str):
    assert len(a) == len(b), f"{what}: {len(a)} vs {len(b)} frames"
    for k, (x, y) in enumerate(zip(a, b)):
        for p, q in zip(x, y):
            assert np.array_equal(p, q), \
                f"{what}: cuda/cpu reconstructions differ at frame {k}"


def encoder_case(cfg, frames, sync, serial: int = 0):
    """A phase-3 case through Encoder: frames through encode() (`sync`:
    each frame's scene check lands before the next frame, so a cut
    restarts the GOP) or encode_async/flush; with `serial`, through
    SerialEncoder (the blocks each P frame's serial pass committed)."""
    def run(dev):
        enc = (SerialEncoder(cfg, serial, device=dev) if serial
               else Encoder(cfg, device=dev))
        with serial_commits() as commits:
            out = ([enc.encode(*f) for f in frames] if sync
                   else encode_all(enc, frames))
        res = dict(
            bytes=[f.nalus for f in out], idr=[f._is_idr for f in out],
            qps=[f._qp for f in out],
            recon=[[r.cpu().numpy() for r in enc._ref + (enc._ref2 or ())]])
        if serial:
            res["serial"] = [int(c) for c in commits]
        return res
    return run


def cli_knob_case(flags, sync):
    """A phase-3 case through the console app on a 176x144 .yuv."""
    def run(dev):
        with tempfile.TemporaryDirectory() as d:
            write_yuv(os.path.join(d, "in.yuv"),
                      synthetic_video(6, 144, 176, plants=8, diverge=32))
            stream, raw, stats, kept = cli_case(flags, sync, dev, d)
        return dict(bytes=[stream], raw=raw, stats=stats, recon=kept)
    return run


def control_case(dev):
    """K3 through Encoder, with control() to QP 27 before CONTROL_AT."""
    cfg = EncoderConfig(**K3)
    enc = Encoder(cfg, device=dev)
    out = []
    for k, f in enumerate(synthetic_video(6, 144, 176, plants=8, diverge=32,
                                          quads=32, scene_cut=4)):
        if k == CONTROL_AT:
            enc.control(dataclasses.replace(cfg, qp=27))
        out.append(enc.encode(*f))
    return dict(bytes=[f.nalus for f in out], idr=[f._is_idr for f in out],
                qps=[f._qp for f in out], recon=[f.recon for f in out])


def parity_cases() -> list:
    """Phase 3's cases, 176x144: (name, fn(dev) -> what must be identical
    on both devices: Annex-B, IDR flags, slice QPs, reconstructions, and
    for the console app its raw and stats files; all picklable)."""
    small = dict(width=176, height=144, qp=32, intra_period=100)
    rc_video = synthetic_video(9, 144, 176, plants=4, diverge=32)
    cut_video = synthetic_video(6, 144, 176, plants=8, diverge=32, quads=32,
                                scene_cut=4)
    cases = []
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
        cases.append((name, encoder_case(cfg, frames, sync)))
    # rd=FAST with the serial pass on patches of new content and a strip
    # where the pan enters (the GOP kept: the content makes half the
    # blocks prefer intra)
    cases.append(("RD_FAST+serial16", encoder_case(
        EncoderConfig(scene_change_reinit=False, **small),
        synthetic_video(5, 144, 176, plants=4, patches=2, strip=16), False,
        serial=16)))
    cases += [("K1 through the console app", cli_knob_case(K1, True)),
              ("K2 through the console app", cli_knob_case(K2, False)),
              (f"K3 with control() at frame {CONTROL_AT}", control_case)]
    return cases


def parity_results(dev: str, part: int = 0, parts: int = 1) -> dict:
    """Every parts-th phase-3 case from the part-th on `dev`."""
    return {name: fn(dev) for name, fn in parity_cases()[part::parts]}


STAGE_A_LIMIT_S = 700


def start_job(jobs, name, argv, d, env=None):
    """Start a stage-A child; its stdout and stderr go to d/NAME.out and
    d/NAME.err."""
    with open(os.path.join(d, name + ".out"), "w") as out, \
            open(os.path.join(d, name + ".err"), "w") as err:
        jobs[name] = subprocess.Popen(argv, cwd=ROOT, stdout=out,
                                      stderr=err, env=env)


def watch_jobs(jobs, t0, ends):
    """Note each stage-A child's seconds from t0 in `ends` as it ends (a
    thread of its own, so the ends are seen while this process works)."""
    while any(name not in ends for name in jobs):
        for name, proc in jobs.items():
            if name not in ends and proc.poll() is not None:
                ends[name] = time.perf_counter() - t0
        time.sleep(0.2)


def wait_jobs(jobs, d, t0, watch):
    """Wait for every stage-A child (watch_jobs' thread), STAGE_A_LIMIT_S
    after t0 at most; fail if one failed."""
    watch.join(max(1.0, STAGE_A_LIMIT_S - (time.perf_counter() - t0)))
    running = [name for name, proc in jobs.items() if proc.poll() is None]
    if running:
        raise TimeoutError(f"stage A: {running} still running after "
                           f"{STAGE_A_LIMIT_S} s")
    for name, proc in jobs.items():
        if proc.returncode != 0:
            with open(os.path.join(d, name + ".err")) as f:
                err = f.read()[-4000:]
            raise AssertionError(f"stage A: {name} exited "
                                 f"{proc.returncode}:\n{err}")


def stop_jobs(jobs):
    for proc in jobs.values():
        if proc.poll() is None:
            proc.kill()
        proc.wait()


PARITY_KIDS = [(dev, part, 2) for dev in ("cuda", "cpu") for part in (0, 1)]


def start_parity(jobs, d):
    """Phase 3's children: every case on cuda and on cpu, each device's
    cases in two halves (`chip_smoke.py --parity DEV PART PARTS FILE`,
    the results in d/parity_DEVPART.pkl)."""
    for dev, part, parts in PARITY_KIDS:
        name = f"parity_{dev}{part}"
        start_job(jobs, name,
                  [sys.executable, os.path.abspath(__file__), "--parity",
                   dev, str(part), str(parts), os.path.join(d, name + ".pkl")],
                  d)


def phase_parity(d, ends):
    """Phase 3: the children's results on cuda and on cpu must be
    identical (their processes have ended; `ends`: their seconds)."""
    got = {}
    for dev, part, _ in PARITY_KIDS:
        with open(os.path.join(d, f"parity_{dev}{part}.pkl"), "rb") as f:
            got.setdefault(dev, {}).update(pickle.load(f))
    gpu, cpu = got["cuda"], got["cpu"]
    secs = max(t for name, t in ends.items() if name.startswith("parity"))
    log(f"[parity] {len(cpu)} cases, on cuda and on cpu in two processes "
        f"each: {secs:.1f}s (stage A)")
    assert sorted(gpu) == sorted(cpu), (sorted(gpu), sorted(cpu))
    for name, c in cpu.items():
        g = gpu[name]
        for key in g:
            if key == "recon":
                same_recons(g[key], c[key], name)
            else:
                assert g[key] == c[key], f"{name}: cuda/cpu {key} differ"
        idr = [i for i, x in enumerate(g.get("idr", [])) if x]
        if name in ("RD_FAST", "RD_FULL+2ref"):
            assert idr == [0, 5], idr
        if "all-intra" in name:
            assert all(g["idr"]), g["idr"]
        if name == "CBR":
            assert len(set(g["qps"][1:])) >= 2, \
                f"CBR kept one P-frame QP: {g['qps']}"
        if name == "RD_FAST+serial16":
            assert not any(g["idr"][1:]) and min(g["serial"]) >= 2, \
                (g["idr"], g["serial"])
        if name.startswith("K3"):
            # control() restarts with an IDR; the scene cut at frame 4
            # does not (no intra fallback, no reinit)
            assert idr == [0, CONTROL_AT], idr
        log(f"[parity] 176x144 {name}"
            + (f" {len(g['idr'])} frames (IDR at {idr}, QPs {g['qps']})"
               if "idr" in g else "")
            + (f", serial commits per P frame {g['serial']}"
               if "serial" in g else "")
            + f": cuda == cpu ({sum(len(x) for x in g['bytes'])} bytes"
            + (f", {len(g['stats'])} stats lines" if g.get("stats") else "")
            + ")")


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


def check_shapes(per_frame, cfg, bands: int = 1, serial: int = 0):
    """One P frame's recorded kernel calls must be main_path_calls."""
    shapes = {name: sorted(tuple(a[0].shape) + a[2:]
                           if name == "slab_search" else
                           (a[-2].numel(), a[-1], tuple(a[0].shape))
                           for a in v) for name, v in per_frame.items()}
    assert shapes == {name: sorted(v) for name, v in
                      main_path_calls(cfg, bands, serial).items()}, shapes


@contextlib.contextmanager
def slices_to(recs):
    """Append every FrameRecord the host stage entropy-codes to recs."""
    real = binding.encode_slice

    def spy(ccfg, rec):
        recs.append(rec)
        return real(ccfg, rec)
    binding.encode_slice = spy
    try:
        yield
    finally:
        binding.encode_slice = real


def drive_i(cfg, frames, ckpt=None) -> dict:
    """The I frame of a path: frames[0] through encode_async.  With
    `ckpt`, then flush() and the encoder's state saved there; without, the
    I frame stays in flight (its host stage done, its bits not yet
    accounted), so the P frames are dispatched as in a continuous run.
    The I frame must launch no kernel but SAO's three (one each, with SAO
    on).  Returns the run for drive."""
    enc = Encoder(cfg)
    run = dict(enc=enc, out=[], recs=[])
    with slices_to(run["recs"]):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        run["out"] += enc.encode_async(*frames[0])
        if ckpt is not None:
            run["out"] += enc.flush()
            enc.save_checkpoint(ckpt)
        else:
            concurrent.futures.wait(enc._pending)
        torch.cuda.synchronize()
        run["i_s"] = time.perf_counter() - t0
    counts = kernels.launch_counts()
    assert not any(counts[k] for k in KERNELS) and all(
        counts[k] == cfg.sao for k in kernels.SAO_KERNELS), \
        f"the I frame launched {counts}"
    return run


def drive(cfg, frames, label, run=None, i_note="", serial: int = 0):
    """One path: frames[0] as the I frame (or `run`, drive_i's result for
    it), then the P frames in chunks of cfg.frames_per_launch through
    encode_async/flush.  The launch counts are zeroed just before the P
    frames (the I frame launches none) and read just after; the
    wrappers' arguments are recorded in the first chunk, and the chunks
    after it are timed.  Returns (counts, one P frame's calls,
    FrameRecords, coded frames, I-frame seconds, P fps of the timed
    chunks)."""
    k = cfg.frames_per_launch
    n_p = len(frames) - 1
    assert n_p % k == 0, (n_p, k)
    run = run or drive_i(cfg, frames)
    enc, out, recs = run["enc"], run["out"], run["recs"]
    with slices_to(recs):
        kernels.reset_launch_counts()
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
    assert len(out) == 1 + n_p and len(recs) == 1 + n_p, (len(out), len(recs))
    per_frame = {}
    for name, v in rec.items():
        assert v and len(v) % k == 0, (name, len(v))
        per_frame[name] = v[:len(v) // k]
    # phase 2 checked the edge cases at these shapes
    check_shapes(per_frame, cfg, serial=serial)
    for name in KERNELS:
        assert counts[name] > 0, \
            f"kernel {name} was not launched on the {label} path"
        assert counts[name] == n_p * len(per_frame[name]), \
            (name, counts[name], n_p, len(per_frame[name]))
    for name in kernels.SAO_KERNELS:
        assert counts[name] == n_p * cfg.sao, (name, counts[name], n_p)
    assert not any(f._is_idr for f in out[1:]), "unexpected IDR restart"
    y = enc._ref[0].cpu().numpy()[:cfg.height, :cfg.width]
    p = psnr(frames[-1][0], y)
    assert 28.0 < p < 60.0, f"implausible Y PSNR {p:.2f} dB"
    timed = (f", {n_p - k} P frames {t3 - t2:.3f}s -> P fps "
             f"{(n_p - k) / (t3 - t2):.3f}" if n_p > k else "")
    log(f"[{label}] {cfg.width}x{cfg.height} {cfg.rd_mode.name} 1I+{n_p}P: "
        f"I frame {run['i_s']:.3f}s{i_note}, first chunk (recording) "
        f"{t2 - t1:.3f}s"
        f"{timed}; last-frame Y PSNR {p:.2f} dB; bits "
        f"{[f.bits for f in out]}; launches {counts}")
    p_fps = (n_p - k) / (t3 - t2) if n_p > k else None
    return counts, per_frame, recs, out, run["i_s"], p_fps


def phase_ultrafast(n_p=8):
    """The rd=ULTRAFAST path; returns its P fps (the second chunk)."""
    cfg = EncoderConfig(width=1280, height=720, qp=32, intra_period=100,
                        rd_mode=RDMode.RD_ULTRAFAST)
    return drive(cfg, synthetic_video(1 + n_p, cfg.height, cfg.width),
                 "ultrafast")[-1]


def path_cfg(label) -> EncoderConfig:
    """The 720p IPPP configurations of phases 5, 6 and 7."""
    size = dict(width=1280, height=720, intra_period=100)
    if label == "cbr":
        return EncoderConfig(bitrate_mode=BitrateMode.CBR, bitrate=1250,
                             frame_rate=25, **size)
    if label == "two_ref":
        return EncoderConfig(qp=32, rd_mode=RDMode.RD_FULL,
                             num_ref_frames=2, **size)
    return EncoderConfig(qp=32, **size)


def path_video(label, n_p=8) -> list:
    """Phases 5 and 6 code fast_video; phase 7 the same plus a flicker on
    odd frames over the left half, where the picture two back is the
    better reference."""
    if label != "two_ref":
        return fast_video(1 + n_p, 720, 1280)
    return synthetic_video(1 + n_p, 720, 1280, plants=64, diverge=128,
                           quads=64, flicker=20)


def i_frame(label, d):
    """The I frame of path `label` (a stage-A child, `chip_smoke.py
    --i-frame LABEL DIR`): the encoder's state after it goes to
    DIR/LABEL_after_i.npz, its coded frame, FrameRecord and seconds to
    DIR/LABEL_i.pkl."""
    run = drive_i(path_cfg(label), path_video(label),
                  os.path.join(d, f"{label}_after_i.npz"))
    with open(os.path.join(d, f"{label}_i.pkl"), "wb") as f:
        pickle.dump({k: run[k] for k in ("out", "recs", "i_s")}, f)


def resumed(label, d, enc=None) -> dict:
    """i_frame's run of path `label`, its encoder (or `enc`) restored from
    the checkpoint, for drive."""
    with open(os.path.join(d, f"{label}_i.pkl"), "rb") as f:
        run = pickle.load(f)
    run["enc"] = enc or Encoder(path_cfg(label))
    run["enc"].load_checkpoint(os.path.join(d, f"{label}_after_i.npz"))
    return run


RESUMED = " (stage A, a child; the P frames from its checkpoint)"


def phase_main(d, n_p=8):
    """The default configuration (rd=FAST), its P frames from the state
    i_frame saved in d after its I frame.  Returns the launch counts of
    its run, the kernel calls one P frame of its first chunk made and the
    P frames' Annex-B bytes."""
    cfg = path_cfg("main")
    assert cfg.rd_mode == RDMode.RD_FAST
    counts, per_frame, recs, out, _, _ = drive(
        cfg, path_video("main", n_p), "main", resumed("main", d), RESUMED)
    tools = [tool_counts(r) for r in recs]
    for i, (t, f) in enumerate(zip(tools, out)):
        log(f"[tools] frame {i} {'I' if f._is_idr else 'P'}: {t}, "
            f"intra_frac {f._intra_frac:.4f}")
    for key in ("nxn", "intra", "split8"):
        assert sum(t.get(key, 0) for t in tools) > 0, \
            f"the main path's video fired no {key} CU"
    return counts, per_frame, [f.nalus for f in out[1:]]


def phase_cbr(run, frames, n_p=8):
    """The rate-controlled path: the README's console example (CBR at
    1250 kbps, 25 fps) at 720p on phase 5's video, from drive_i's `run`
    of its I frame.  Every kernel call of one P frame is held against its
    plain version on its recorded CBR inputs.  Returns the Annex-B stream
    it gave."""
    cfg = path_cfg("cbr")
    assert cfg == cli_cfg(README_CBR), "phase 6 is not the README's example"
    counts, per_frame, recs, out, i_s, p_fps = drive(cfg, frames, "cbr", run,
                                                     " (stage A)")
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
    return b"".join(f.nalus for f in out)


def phase_two_ref(d, n_p=8):
    """rd=FULL (the I frame's top-3 full-RD mode refinement) with two
    reference pictures at 720p on path_video("two_ref"), its P frames
    from the state i_frame saved in d after its I frame.  ME runs on
    both references (4 slab searches per P frame), and every kernel call
    of one P frame is held against its plain version on its recorded
    inputs.  Returns the launch counts and that P frame's calls."""
    cfg = path_cfg("two_ref")
    counts, per_frame, recs, out, i_s, p_fps = drive(
        cfg, path_video("two_ref", n_p), "two_ref", resumed("two_ref", d),
        RESUMED)
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


def all_intra_cfg(k=8, size=(1280, 720), **kw) -> EncoderConfig:
    return EncoderConfig(width=size[0], height=size[1], qp=32,
                         intra_period=1, tile_auto=True, scaling_lists=True,
                         intra_frames_per_launch=k, **kw)


def phase_all_intra(k=8, size=(1280, 720), tiles=(4, 3), n_steps=(146, 38)):
    """The all-intra path: tile_auto (at 720p a 4x3 grid: 146 wavefront
    steps become 38) and the default scaling lists, one chunk of k
    frames, then the first frame alone.  No kernel may launch but SAO's
    three, once per frame.  Returns the numbers it prints and the chunk's
    Annex-B bytes per frame."""
    cfg = all_intra_cfg(k, size)
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
    assert not any(counts[n] for n in KERNELS) and all(
        counts[n] == (k + 1) * cfg.sao for n in kernels.SAO_KERNELS), \
        f"the all-intra path launched {counts}"
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
    return res, [f.nalus for f in out]


def phase_cli(d, frames, cbr_stream, wall_a, n_p=8):
    """The console app at 720p on phase 6's video, d/in.yuv: (a) `python
    -m homerhevc_torch` with the README's flags (a stage-A child, which
    wrote d/cbr.265 and d/cli_a.out) must have written phase 6's stream;
    (b) cli.main in-process at rd=ULTRAFAST with performance_mode FULL and
    half-pel ME, every kernel call of one P frame held against its plain
    version.  Returns (b)'s launch counts, its largest difference from
    the plain versions and the numbers it prints."""
    yuv = os.path.join(d, "in.yuv")
    with open(os.path.join(d, "cli_a.out")) as f:
        lines_a = f.read().strip().splitlines()
    with open(os.path.join(d, "cbr.265"), "rb") as f:
        assert f.read() == cbr_stream, \
            "the console app's .265 differs from phase 6's stream"
    for line in lines_a:
        log(f"[cli] (a) {line}")
    log(f"[cli] (a) python -m homerhevc_torch {' '.join(README_CBR)}: "
        f"{wall_a:.3f}s (stage A), .265 == phase 6's stream "
        f"({len(cbr_stream)} bytes)")
    argv = ["-i", yuv, "-o", os.path.join(d, "ufast.265")] + CLI_UFAST
    cfg = cli_cfg(CLI_UFAST)
    encs, t_p = [], []
    real = Encoder._dispatch_p_chunk

    def p_chunk(self, *a, **k):
        # the work before each P chunk ends before the chunk is queued:
        # the I frame before the first, the first chunk before the
        # second (timed, as drive() times its chunks after the first)
        torch.cuda.synchronize()
        encs.append(self)
        t_p.append(time.perf_counter())
        return real(self, *a, **k)
    Encoder._dispatch_p_chunk = p_chunk
    printed = io.StringIO()
    try:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            rec = record_calls(lambda: assert_zero(cli.main(argv)))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        counts = kernels.launch_counts()
    finally:
        Encoder._dispatch_p_chunk = real
    for name in kernels.SAO_KERNELS:
        assert counts[name] == (n_p + 1) * cfg.sao, (name, counts)
    per_frame = {}
    for name, v in rec.items():
        assert counts[name] > 0, \
            f"kernel {name} was not launched on the console app's path"
        assert len(v) % n_p == 0 and counts[name] == len(v), \
            (name, len(v), counts[name])
        per_frame[name] = v[:len(v) // n_p]
    check_shapes(per_frame, cfg)
    err = hold_against_plain(per_frame, "the console app's inputs")
    y = encs[0]._ref[0].cpu().numpy()[:cfg.height, :cfg.width]
    p = psnr(frames[-1][0], y)
    assert 28.0 < p < 60.0, f"implausible Y PSNR {p:.2f} dB"
    k = cfg.frames_per_launch
    assert len(t_p) == n_p // k, len(t_p)
    i_s, p_fps = t_p[0] - t0, (n_p - k) / (t1 - t_p[1])
    for line in printed.getvalue().strip().splitlines():
        log(f"[cli] (b) {line}")
    log(f"[cli] (b) cli.main {' '.join(CLI_UFAST)}: I frame {i_s:.3f}s "
        f"(from the app's start), {n_p - k} P frames after the first chunk "
        f"{t1 - t_p[1]:.3f}s -> P fps {p_fps:.3f}; last-frame Y PSNR "
        f"{p:.2f} dB; kernels equal to their plain versions on its inputs "
        f"(max abs err {err}); launches {counts}")
    return counts, per_frame, dict(wall_a=wall_a, cli_a=lines_a, i_s=i_s,
                                   p_fps=p_fps)


# -------------------------------------------------------------- phase 10
MULTI_TIMEOUT_S = 600


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def multi_device_rank(rank, world, port, d, ckpt, backend, n_p):
    """One rank of phase 10 (a child process): (a) phase 5's P frames in
    row bands from phase 5's state after its I frame, the first chunk's
    kernel calls recorded, the chunks after it timed; with gloo also (b)
    phase 8's all-intra chunk in frame shards.  Writes its results to
    d/rank{rank}.pkl and its recorded calls to d/calls{rank}.pt."""
    torch.set_num_threads(4)
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    multihost.init_distributed(f"127.0.0.1:{port}", world, rank,
                               backend=backend,
                               timeout=datetime.timedelta(seconds=300))
    try:
        cfg = EncoderConfig(width=1280, height=720, qp=32, intra_period=100,
                            num_chips=world)
        k = cfg.frames_per_launch
        frames = fast_video(1 + n_p, cfg.height, cfg.width)[1:]
        enc = Encoder(cfg, device=dev)
        enc.load_checkpoint(ckpt)
        out = []
        kernels.reset_launch_counts()
        rec = record_calls(lambda: [out.extend(enc.encode_async(*f))
                                    for f in frames[:k]])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out += encode_all(enc, frames[k:])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        res = dict(a=dict(n_bands=enc.n_bands,
                          counts=kernels.launch_counts(),
                          nalus=[f.nalus for f in out],
                          p_fps=(n_p - k) / (t2 - t1)))
        torch.save({name: [tuple(a.cpu() if isinstance(a, torch.Tensor)
                                 else a for a in args)
                           for args in v[:len(v) // k]]
                    for name, v in rec.items()},
                   os.path.join(d, f"calls{rank}.pt"))
        if backend == "gloo":
            cfg = all_intra_cfg(num_chips=world)
            enc = Encoder(cfg, device=dev)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            out = encode_all(enc, fast_video(cfg.intra_frames_per_launch,
                                             cfg.height, cfg.width))
            torch.cuda.synchronize()
            res["b"] = dict(n_frame_shards=enc.n_frame_shards,
                            counts=kernels.launch_counts(),
                            nalus=[f.nalus for f in out],
                            seconds=time.perf_counter() - t0)
        with open(os.path.join(d, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def run_ranks(world, ckpt, backend, d, n_p):
    """Start `world` ranks of multi_device_rank (spawned processes), wait
    for each with a time limit, fail if any failed; returns their
    results."""
    ctx = torch.multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=multi_device_rank,
                         args=(r, world, port, d, ckpt, backend, n_p))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + MULTI_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"{backend} ranks exited {codes}"
    res = []
    for r in range(world):
        with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return res


def phase_multi_device(ckpt, p_nalus, ai_nalus, n_p=8):
    """Phase 10: the multi-device path on the card, two ranks of one
    process group (gloo) on the one H100: (a) phase 5's P frames in two
    CTU-row bands must give phase 5's bytes, frame by frame, every
    kernel launched at the band shapes and, on each rank's recorded
    inputs of one band P frame, equal to its plain version; (b) phase 8's
    all-intra chunk in two frame shards must give phase 8's bytes, with
    no kernel launched but SAO's; (c) NCCL with one rank per card where
    the machine has two cards.  Returns rank 1's (the lower band's) launch counts and
    recorded calls of one P frame."""
    world = 2
    cfg = EncoderConfig(width=1280, height=720, qp=32, intra_period=100,
                        num_chips=world)
    k = cfg.frames_per_launch
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        res = run_ranks(world, ckpt, "gloo", d, n_p)
        calls = [torch.load(os.path.join(d, f"calls{r}.pt"))
                 for r in range(world)]
    wall = time.perf_counter() - t0
    per_rank = []
    for r, x in enumerate(res):
        a, b = x["a"], x["b"]
        assert a["n_bands"] == world, a["n_bands"]
        assert len(a["nalus"]) == n_p, len(a["nalus"])
        for i, (got, want) in enumerate(zip(a["nalus"], p_nalus)):
            assert got == want, \
                f"rank {r}: band P frame {i + 1} differs from phase 5's"
        per_frame = {name: [tuple(t.to(DEV) if isinstance(t, torch.Tensor)
                                  else t for t in args) for args in v]
                     for name, v in calls[r].items()}
        check_shapes(per_frame, cfg, world)
        for name in KERNELS:
            assert a["counts"][name] == n_p * len(per_frame[name]) > 0, \
                (r, name, a["counts"][name], len(per_frame[name]))
        # SAO runs on the whole frame on every rank, after the gather
        for name in kernels.SAO_KERNELS:
            assert a["counts"][name] == n_p, (r, name, a["counts"])
        err = hold_against_plain(per_frame, f"rank {r}'s band inputs")
        assert b["n_frame_shards"] == world, b["n_frame_shards"]
        # each rank runs SAO on the frames of its shard
        sao_b = {b["counts"][name] for name in kernels.SAO_KERNELS}
        assert not any(b["counts"][name] for name in KERNELS) and \
            len(sao_b) == 1 and sao_b.pop() > 0, b["counts"]
        assert b["nalus"] == ai_nalus, f"rank {r}: all-intra shards differ"
        per_rank.append(per_frame)
        log(f"[multi_device] (a) gloo rank {r} of {world} on cuda:0: "
            f"{a['n_bands']} row bands of {cfg.padded_height // world} rows; "
            f"{n_p} P frames == phase 5's bytes; launches per band P frame "
            f"{ {n: c // n_p for n, c in a['counts'].items()} }; kernels "
            f"equal to their plain versions on its band's inputs (max abs "
            f"err {err}); P fps {a['p_fps']:.3f} (the chunks after the "
            f"first; no claim: two ranks share one card)")
        log(f"[multi_device] (b) gloo rank {r}: {b['n_frame_shards']} frame "
            f"shards of phase 8's chunk: {len(b['nalus'])} frames == phase "
            f"8's bytes in {b['seconds']:.3f}s; launches {b['counts']}")
    log(f"[multi_device] (a)+(b) two gloo ranks on one card: "
        f"{wall:.1f}s with the ranks' start")
    if torch.cuda.device_count() >= 2:
        with tempfile.TemporaryDirectory() as d:
            nccl = run_ranks(world, ckpt, "nccl", d, n_p)
        for r, x in enumerate(nccl):
            assert x["a"]["nalus"] == p_nalus, f"nccl rank {r} differs"
        log(f"[multi_device] (c) NCCL, one rank per card on "
            f"{torch.cuda.device_count()} cards: P frames == phase 5's; P "
            f"fps {[round(x['a']['p_fps'], 3) for x in nccl]}")
    else:
        log(f"[multi_device] (c) NCCL, one rank per card: NOT RUN: "
            f"torch.cuda.device_count() is {torch.cuda.device_count()} "
            f"(NCCL refuses two ranks on one card)")
    return res[1]["a"]["counts"], per_rank[1]


# -------------------------------------------------------------- phase 11
SERIAL = 32              # phase 11's serial-pass steps per P frame


def serial_cfg() -> EncoderConfig:
    """Phase 5's configuration with its GOP kept (the patches and the
    strip make about half the blocks prefer intra, which would restart
    it)."""
    return dataclasses.replace(path_cfg("main"), scene_change_reinit=False)


def serial_video(n_p=8) -> list:
    """Phase 5's video plus, from frame 1 on, 8 patches of 2 x 3 blocks
    of new flat content and a 32-pixel strip of new content along the
    right edge, where the pan enters (frame 0, the I frame phase 5
    checkpoints, is phase 5's)."""
    return synthetic_video(1 + n_p, 720, 1280, plants=64, diverge=128,
                           quads=64, patches=8, strip=32)


def serial_cpu(d):
    """Phase 11's first P frame on the CPU (a stage-A child, `chip_smoke.py
    --serial-cpu DIR`): once phase 5's I-frame child has saved its state
    in DIR, that state through SerialEncoder on cpu.  The frame's Annex-B
    bytes and serial commits go to DIR/serial_cpu.pkl."""
    t0 = time.perf_counter()
    while not os.path.exists(os.path.join(d, "main_i.pkl")):
        if time.perf_counter() - t0 > STAGE_A_LIMIT_S:
            raise TimeoutError("phase 5's I frame did not end")
        time.sleep(1.0)
    enc = SerialEncoder(serial_cfg(), SERIAL, device="cpu")
    enc.load_checkpoint(os.path.join(d, "main_after_i.npz"))
    with serial_commits() as commits:
        out = enc.encode_async(*serial_video()[1]) + enc.flush()
    with open(os.path.join(d, "serial_cpu.pkl"), "wb") as f:
        pickle.dump(dict(nalus=out[0].nalus, serial=int(commits[0])), f)


def phase_serial(d, n_p=8):
    """Phase 11: the intra fallback's serial pass (SERIAL steps) at 720p
    rd=FAST on serial_video, the P frames from phase 5's state after its
    I frame.  Every kernel launched at every call site, the serial
    steps' window reads included, each equal to its plain version on one
    P frame's recorded inputs; the first P frame's bytes equal to the
    CPU's (serial_cpu).  Then the pass's cost: two encoders from the same
    state, with and without the pass, code the P frames chunk by chunk
    in turns (P fps each), and one chunk of each under torch.profiler
    (device operations per P frame).  Returns the launch counts and one
    P frame's calls."""
    t_phase = time.perf_counter()
    cfg = serial_cfg()
    frames = serial_video(n_p)
    ckpt = os.path.join(d, "main_after_i.npz")
    with serial_commits() as commits:
        counts, per_frame, recs, out, _, p_fps = drive(
            cfg, frames, "serial", resumed("main", d,
                                           SerialEncoder(cfg, SERIAL)),
            RESUMED, serial=SERIAL)
    commits = [int(c) for c in commits]
    assert len(commits) == n_p and min(commits) >= 2, commits
    err = hold_against_plain(per_frame, "serial-pass inputs")
    with open(os.path.join(d, "serial_cpu.pkl"), "rb") as f:
        cpu = pickle.load(f)
    assert out[1].nalus == cpu["nalus"] and commits[0] == cpu["serial"], \
        "phase 11: the first P frame differs between cuda and cpu"
    k = cfg.frames_per_launch
    encs = dict(serial=SerialEncoder(cfg, SERIAL), plain=Encoder(cfg))
    secs = dict.fromkeys(encs, 0.0)
    for e in encs.values():
        e.load_checkpoint(ckpt)
    for c in range(n_p // k):
        for name, e in encs.items():
            t0 = time.perf_counter()
            encode_all(e, frames[1 + c * k:1 + (c + 1) * k])
            torch.cuda.synchronize()
            secs[name] += time.perf_counter() - t0
    prof = {}
    for name, e in encs.items():
        e.load_checkpoint(ckpt)
        prof[name] = device_ops(lambda e=e: encode_all(e, frames[1:1 + k]),
                                k)
    log(f"[serial] 1280x720 rd=FAST fallback_serial={SERIAL} 1I+{n_p}P: "
        f"serial commits per P frame {commits}; first P frame == cpu "
        f"({len(cpu['nalus'])} bytes); bits {[f.bits for f in out]}; "
        f"kernels equal to their plain versions (max abs err {err}); "
        f"launches {counts}; P fps {p_fps:.3f} (drive's timed chunk)")
    for name in encs:
        log(f"[serial] {name}: P fps {n_p / secs[name]:.3f} ({n_p} P "
            f"frames in turns, {secs[name]:.3f}s); per P frame under the "
            f"profiler: {prof[name]['device_ops']:.1f} device operations, "
            f"device busy {prof[name]['device_busy_share']:.4f}, wall "
            f"{prof[name]['wall_ms']:.1f} ms")
    log(f"[serial] phase 11 {time.perf_counter() - t_phase:.1f}s")
    return counts, per_frame


# -------------------------------------------------------------- phase 12
SAO_QPS = (22, 27, 32, 37)      # the synthetic cases' lambdas
SAO_REPS = 20                   # calls per kernel timing


def sao_lams(qp):
    """(lam_y, lam_c) of a P slice at qp, as the encoder computes them
    (chroma QP offset 2)."""
    qpc = int(tables.CHROMA_QP_TABLE[qp + 2])
    return tuple(rdbits.rd_lambda_f32(torch.tensor(q, device=DEV), False)
                 for q in (qp, qpc))


def sao_noise(seed, h, w):
    """Original and pre-SAO reconstruction (Y, Cb, Cr; a luma h x w frame)
    of smooth content with grain, the reconstruction a few levels off with
    a bias that varies slowly across the frame (so that neighbouring CTUs
    want like parameters and merges fire)."""
    rng = np.random.default_rng(seed)
    planes = []
    for s in (1, 2, 2):
        yy, xx = np.mgrid[0:h // s, 0:w // s] * s
        org = (128 + 70 * np.sin(yy / 41.0) * np.cos(xx / 67.0)
               + rng.normal(0, 9, yy.shape))
        bias = np.round(3 * np.sin(xx / 300.0 + yy / 170.0))
        rec = org + bias + rng.integers(-4, 5, yy.shape) * (xx % 5 == 0)
        planes.append((org, rec))
    return ([i32(np.clip(o, 0, 255)) for o, _ in planes]
            + [i32(np.clip(r, 0, 255)) for _, r in planes])


def tie_ctb(kind, b, rng):
    """(org, rec) of one b x b CTB of a tie mosaic kind:
    0 flat and exact (every EO category empty, every BO cost 0);
    1 symmetric under transpose and both flips (EO classes 0 / 1 and
      2 / 3 see the same statistics, so their costs tie exactly and the
      first must win), tiled so that the symmetry holds across CTBs,
      with a ringing that makes EO the best mode;
    2 bands 8..15 in equal counts with mirrored errors (band 8 + i and
      15 - i alike): BO windows that are equal in exact arithmetic and
      differ only by the float32 order of the prefix sums;
    3 grain (no tie)."""
    if kind == 0:
        o = np.full((b, b), 100)
        return o, o
    if kind == 1:
        # a gentle slope under a checkerboard of +-4 in (|y - c|, |x - c|)
        c = (b - 1) / 2.0
        yy, xx = np.mgrid[0:b, 0:b]
        dy = np.abs(yy - c).astype(int)
        dx = np.abs(xx - c).astype(int)
        org = 90 + dy + dx + rng.integers(0, 40)
        return org, org + 4 * (2 * ((dy + dx) % 2) - 1)
    if kind == 2:
        bands = rng.permutation(np.arange(b * b) % 8) + 8
        d = np.array([3, -2, 5, 1, 1, 5, -2, 3])[bands - 8]
        rec = (bands * 8 + rng.integers(0, 8, b * b)).reshape(b, b)
        return np.clip(rec + d.reshape(b, b), 0, 255), rec
    o = rng.integers(40, 210, (b, b))
    return o, np.clip(o + rng.integers(-3, 4, (b, b)), 0, 255)


def sao_ties(seed, h, w):
    """A mosaic of tie_ctb kinds in runs along each CTU row (a run of like
    CTBs makes merge chains; a run's end breaks them), the same kind in
    a CTU's luma and chroma CTBs."""
    rng = np.random.default_rng(seed)
    by, bx = h // 64, w // 64
    kinds = np.repeat(rng.integers(0, 4, (by, (bx + 2) // 3)), 3, 1)[:, :bx]
    out = []
    for b in (64, 32, 32):
        tiles = {k: tie_ctb(k, b, rng) for k in range(4)}
        org = np.zeros((by * b, bx * b), np.int64)
        rec = np.zeros_like(org)
        for r in range(by):
            for c in range(bx):
                o, x = tiles[int(kinds[r, c])]
                org[r * b:(r + 1) * b, c * b:(c + 1) * b] = o
                rec[r * b:(r + 1) * b, c * b:(c + 1) * b] = x
        out.append((org, rec))
    return [i32(o) for o, _ in out] + [i32(r) for _, r in out]


def sao_differs(got, want) -> list:
    """What differs between two sao_frame results: planes (every sample,
    the padding included), the fields and the packed tail."""
    bad = []
    for name, g, w_ in zip(("Y", "Cb", "Cr"), got[:3], want[:3]):
        if g.shape != w_.shape or g.dtype != w_.dtype:
            bad.append(f"{name} {tuple(g.shape)} {g.dtype} vs "
                       f"{tuple(w_.shape)} {w_.dtype}")
        elif not torch.equal(g, w_):
            at = (g != w_).nonzero()
            bad.append(f"{name}: {at.shape[0]} samples, first at "
                       f"{at[0].tolist()}")
    for k in ("type", "offsets", "band_pos"):
        g, w_ = got[3][k], want[3][k]
        if g.shape != w_.shape or g.dtype != w_.dtype:
            bad.append(f"{k} {tuple(g.shape)} {g.dtype} vs "
                       f"{tuple(w_.shape)} {w_.dtype}")
        elif not torch.equal(g, w_):
            at = (g != w_).nonzero()
            first = tuple(at[0].tolist())
            bad.append(f"{k}: {at.shape[0]} entries, first at {first}: "
                       f"{int(g[first])} vs {int(w_[first])} (component, "
                       f"CTU row, column[, k])")
    if not torch.equal(sao.pack_sao_fields(got[3]),
                       sao.pack_sao_fields(want[3])):
        bad.append("packed tail")
    return bad


def record_sao(fn) -> list:
    """Run fn with sao.sao_frame recording a copy of its arguments on
    each call; returns [(args, kwargs), ...] in call order."""
    calls = []
    real = sao.sao_frame

    def spy(*a, **k):
        calls.append((tuple(t.clone() if isinstance(t, torch.Tensor) else t
                            for t in a), dict(k)))
        return real(*a, **k)
    sao.sao_frame = spy
    try:
        fn()
    finally:
        sao.sao_frame = real
    return calls


def sao_encode(n_p=4):
    """A 720p rd=ULTRAFAST stream of 1 I + n_p P frames (one chunk of
    P frames) through encode_async/flush; returns the SAO launches of the
    I frame and of the P chunk, and the recorded sao_frame calls of the
    I frame and of the first P frame."""
    cfg = EncoderConfig(width=1280, height=720, qp=32, intra_period=100,
                        rd_mode=RDMode.RD_ULTRAFAST)
    assert cfg.sao and cfg.frames_per_launch == n_p, cfg
    frames = fast_video(1 + n_p, cfg.height, cfg.width)
    enc = Encoder(cfg)
    out = []
    counts = []
    for fr in (frames[:1], frames[1:]):
        kernels.reset_launch_counts()
        calls = record_sao(lambda fr=fr: [out.extend(enc.encode_async(*f))
                                          for f in fr])
        out += enc.flush()
        torch.cuda.synchronize()
        counts.append((kernels.launch_counts(), calls))
    assert len(out) == 1 + n_p, len(out)
    (c_i, calls_i), (c_p, calls_p) = counts
    assert len(calls_i) == 1 and len(calls_p) == n_p, \
        (len(calls_i), len(calls_p))
    for k in kernels.SAO_KERNELS:
        assert c_i[k] == 1 and c_p[k] == n_p, (k, c_i, c_p)
    return c_i, c_p, calls_i[0], calls_p[0]


def sao_bytes(h, w) -> dict:
    """Least bytes of each SAO kernel at luma h x w: the stats read org
    and rec and write their records; the decisions read the records and
    write the fields; the apply reads rec and the fields and writes the
    new planes."""
    px = h * w * 3 // 2
    n = (h // 64) * (w // 64)
    recs = 3 * n * 122 * 4
    fields = 18 * n * 4
    return dict(sao_stats=8 * px + recs, sao_decide=recs + fields,
                sao_apply=8 * px + fields)


def host_syncs(fn) -> list:
    """The sites of the CUDA operations that synchronise with the host
    while fn runs (torch's sync debug mode)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
            if "synchroniz" in str(w.message)]


def sao_kernel_ms(args, kw) -> dict:
    """Device ms per call of each SAO kernel (torch.profiler, SAO_REPS
    calls after a warm one)."""
    sao.sao_frame(*args, **kw)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(SAO_REPS):
            sao.sao_frame(*args, **kw)
        torch.cuda.synchronize()
    ms = dict.fromkeys(kernels.SAO_KERNELS, 0.0)
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for k in ms:
            if f"{k}_kernel" in e.name:
                ms[k] += (e.time_range.end - e.time_range.start) / 1e3
    assert all(v > 0 for v in ms.values()), ms
    return {k: v / SAO_REPS for k, v in ms.items()}


def phase_sao():
    """Phase 12: SAO's three kernels against the plain version on the
    card, byte for byte on the planes (padding included), the fields and
    the packed tail: the encoder's own inputs of a P frame and of an I
    frame (untiled and with the all-intra cell's 4x3 tiles, and the P
    frame's without merge RDO), grain at four QPs and a tie mosaic at
    720p (untiled, tiled, no merge RDO) and at 1920x1088 with the coded
    size 1080x1920.  Then each kernel's device time at the P frame's
    shapes beside its bytes bound and the plain version's time, the
    host syncs of one call (none), and the launches of an encoded stream
    (3 per frame).  Returns the kernel rows."""
    t0 = time.perf_counter()
    c_i, c_p, (i_args, i_kw), (p_args, p_kw) = sao_encode()
    assert p_kw.get("coded") == (720, 1280) and not p_kw.get("tiles"), p_kw
    cases = [("P frame", p_args, p_kw), ("I frame", i_args, i_kw),
             ("I frame, 4x3 tiles", i_args, dict(i_kw, tiles=(4, 3))),
             ("P frame, no merge RDO", p_args, dict(p_kw, merge_rdo=False))]
    for size, coded in (((768, 1280), (720, 1280)),
                        ((1088, 1920), (1080, 1920))):
        for qp in SAO_QPS:
            planes = sao_noise(qp + size[0], *size)
            for tiles, merge in ((None, True), ((4, 3), True),
                                 (None, False)):
                cases.append((f"grain {size[1]}x{size[0]} QP{qp} tiles "
                              f"{tiles} merge {merge}",
                              (*planes, *sao_lams(qp)),
                              dict(ctu=64, coded=coded, tiles=tiles,
                                   merge_rdo=merge)))
        for qp in SAO_QPS:
            planes = sao_ties(qp, *size)
            for tiles, merge in ((None, True), ((4, 3), True),
                                 (None, False)):
                cases.append((f"ties {size[1]}x{size[0]} QP{qp} tiles "
                              f"{tiles} merge {merge}",
                              (*planes, *sao_lams(qp)),
                              dict(ctu=64, coded=coded, tiles=tiles,
                                   merge_rdo=merge)))
    failed, merges = [], {}
    for what, args, kw in cases:
        got = sao.sao_frame(*args, **kw)
        want = sao.sao_frame_plain(*args, **kw)
        torch.cuda.synchronize()
        bad = sao_differs(got, want)
        if bad:
            failed.append(f"{what}: {'; '.join(bad)}")
        # how many CTUs took a neighbour's parameters (no merge RDO: none)
        expl = sao.sao_frame_plain(*args, **dict(kw, merge_rdo=False))[3]
        moved = (want[3]["offsets"] != expl["offsets"]).any(-1).any(0) | \
            (want[3]["type"] != expl["type"]).any(0)
        merges[what] = int(moved.sum())
    log(f"[sao] {len(cases)} cases, {len(failed)} differ; CTUs that took a "
        f"neighbour's parameters per case: {merges}")
    for f in failed:
        log(f"[sao] DIFFERS {f}")
    assert not failed, f"{len(failed)} SAO cases differ from the plain version"
    assert sum(merges.values()) > 0, "no case merged a CTU"
    # the plain version's constant uploads show that the count sees syncs
    plain_syncs = host_syncs(lambda: sao.sao_frame_plain(*p_args, **p_kw))
    syncs = host_syncs(lambda: sao.sao_frame(*p_args, **p_kw))
    assert plain_syncs and not syncs, (plain_syncs, syncs)
    ms = sao_kernel_ms(p_args, p_kw)
    total_ms, spread = time_ms(lambda: sao.sao_frame(*p_args, **p_kw),
                               SAO_REPS)
    plain_ms, _ = time_ms(lambda: sao.sao_frame_plain(*p_args, **p_kw), 3)
    h, w = p_args[3].shape
    rows = []
    for k, nbytes in sao_bytes(h, w).items():
        rows.append(dict(name=k, route="cuda", source="homerhevc_torch/csrc/"
                         "sao.cu", replaces="none", launches=dict(
                             i_frame=c_i[k], p_chunk=c_p[k]),
                         max_abs_err=0, ms=ms[k],
                         bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                         bound_by="bytes", plain_ms=plain_ms,
                         library_ms=None))
    for r in rows:
        log(f"[sao] {r['name']}: {r['ms']:.5f} ms per 720p P frame (device, "
            f"{SAO_REPS} calls), bound {r['bound_ms']:.5f} (bytes), the "
            f"plain version's whole stage {plain_ms:.3f} ms")
    log(f"[sao] sao_frame on the card: {total_ms:.4f} ms per call back to "
        f"back (spread {spread[0]:.4f}-{spread[1]:.4f}; 3 launches, the "
        f"allocations included), plain {plain_ms:.3f} ms; host syncs per "
        f"call {len(syncs)} (plain {len(plain_syncs)}); launches: I frame {c_i}, the P chunk of 4 {c_p}; "
        f"phase {time.perf_counter() - t0:.1f}s")
    return rows


def device_ops(fn, n) -> dict:
    """fn under torch.profiler (device activity only): its device
    operations per frame over its n frames, the device's busy share and
    the wall ms per frame."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    assert dev, "the profiler saw no device operation"
    return dict(device_ops=len(dev) / n, wall_ms=wall_s * 1e3 / n,
                device_busy_share=_busy_us(dev) / (wall_s * 1e6))


def assert_zero(code):
    assert code == 0, f"cli.main returned {code}"


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
        # past ~1,000 queued launches the host waits for the queue to
        # drain, and a run's time becomes the host's launch rate: keep a
        # run of a frame's calls below that
        reps = max(1, min(50, LAUNCH_QUEUE // len(fns)))
        ms, spread = time_ms(frame(fns), reps)
        plain_ms, _ = time_ms(frame(plains), 5)
        library_ms = time_ms(frame(libs), reps)[0] if libs else None
        rows.append(dict(
            name=name, route="cuda", source=KERNELS[name]["source"],
            replaces=KERNELS[name]["replaces"], launches=counts[name],
            max_abs_err=err, ms=ms, ms_spread=list(spread),
            plain_ms=plain_ms, bound_ms=bound,
            bound_by="operations" if by_ops > 0 else "bytes",
            library_ms=library_ms, calls=sites))
    return rows


def stage_a(work, jobs) -> dict:
    """Phase 3's cases, phase 9(a)'s console app and the I frames of
    phases 5 and 7 in child processes, beside this process's I frame of
    phase 6.  Returns phase 6's run, its video and every job's seconds."""
    t0 = time.perf_counter()
    frames = path_video("cbr")
    write_yuv(os.path.join(work, "in.yuv"), frames)
    start_parity(jobs, work)
    start_job(jobs, "cli_a",
              [sys.executable, "-m", "homerhevc_torch", "-i",
               os.path.join(work, "in.yuv"), "-o",
               os.path.join(work, "cbr.265")] + README_CBR,
              work, env=dict(os.environ, OMP_NUM_THREADS="2"))
    for label in ("main", "two_ref"):
        start_job(jobs, f"{label}_i",
                  [sys.executable, os.path.abspath(__file__), "--i-frame",
                   label, work], work)
    start_job(jobs, "serial_cpu", [sys.executable, os.path.abspath(__file__),
                                   "--serial-cpu", work], work)
    ends = {}
    watch = threading.Thread(target=watch_jobs, args=(jobs, t0, ends),
                             daemon=True)
    watch.start()
    cbr_run = drive_i(path_cfg("cbr"), frames)
    ends["cbr_i (here)"] = time.perf_counter() - t0
    wait_jobs(jobs, work, t0, watch)
    log(f"[time] stage A {time.perf_counter() - t0:.1f}s; each job's end "
        f"{ {k: round(v, 1) for k, v in ends.items()} }")
    return dict(cbr=cbr_run, cbr_frames=frames, ends=ends)


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    work = tempfile.mkdtemp()
    jobs = {}
    try:
        phase_build()
        size = dict(width=1280, height=720, qp=32, intra_period=100)
        small = ["-widthxheight", "176x144"]
        phase_compare([EncoderConfig(**size),
                       EncoderConfig(rd_mode=RDMode.RD_FULL, num_ref_frames=2,
                                     **size),
                       cli_cfg(small + K1), cli_cfg(small + K2),
                       EncoderConfig(**K3), cli_cfg(CLI_UFAST),
                       (serial_cfg(), SERIAL)])
        a = stage_a(work, jobs)
        t_b = time.perf_counter()
        phase_parity(work, a["ends"])
        ufast_fps = phase_ultrafast()
        fast_counts, fast_calls, p_nalus = phase_main(work)
        cbr_stream = phase_cbr(a["cbr"], a["cbr_frames"])
        counts, per_frame = phase_two_ref(work)
        _, ai_nalus = phase_all_intra()
        cli_counts, cli_calls, cli_nums = phase_cli(
            work, a["cbr_frames"], cbr_stream, a["ends"]["cli_a"])
        band_counts, band_calls = phase_multi_device(
            os.path.join(work, "main_after_i.npz"), p_nalus, ai_nalus)
        serial_counts, serial_calls = phase_serial(work)
        sao_rows = phase_sao()
    finally:
        stop_jobs(jobs)
        shutil.rmtree(work, ignore_errors=True)
    log(f"[cli] rd=ULTRAFAST P fps at 720p: performance_mode FULL with "
        f"half-pel ME through the app {cli_nums['p_fps']:.3f}, "
        f"performance_mode UFAST (phase 4) {ufast_fps:.3f}")
    # the kernels line reports the two-reference rd=FULL path; each row
    # also carries the rd=FAST path's, the console app's (9(b)), the
    # row-band path's (phase 10, the lower band's rank) and the serial
    # pass's (phase 11) numbers
    t_k = time.perf_counter()
    paths = {label: {r["name"]: r for r in kernel_report(c, calls)}
             for label, c, calls in (
                 ("rd_fast_path", fast_counts, fast_calls),
                 ("cli_path", cli_counts, cli_calls),
                 ("band_path", band_counts, band_calls),
                 ("serial_path", serial_counts, serial_calls))}
    rows = kernel_report(counts, per_frame)
    log(f"[time] kernel timings {time.perf_counter() - t_k:.1f}s")
    for r in rows:
        for label, by_name in paths.items():
            f = by_name[r["name"]]
            r[label] = {k: f[k] for k in (
                "launches", "max_abs_err", "ms", "ms_spread", "plain_ms",
                "bound_ms", "library_ms")}
        for label, x in [("two_ref", r)] + [(k, r[k]) for k in paths]:
            lib = ("none" if x["library_ms"] is None
                   else f"{x['library_ms']:.4f}")
            log(f"[kernel] {r['name']} ({label}): {x['ms']:.4f} "
                f"ms/P-frame (spread {x['ms_spread'][0]:.4f}-"
                f"{x['ms_spread'][1]:.4f}, plain {x['plain_ms']:.4f}, "
                f"library {lib}, bound {x['bound_ms']:.5f} "
                f"{r['bound_by']}), {x['launches']} launches")
    log(f"[time] phases 1-12 {time.perf_counter() - t0:.1f}s (stage B "
        f"{time.perf_counter() - t_b:.1f}s)")
    print(json.dumps({"sao_kernels": sao_rows}))
    print(json.dumps({"kernels": rows}))
    card_lines()


def card_lines():
    """The card's name and power limit, then the last line, ok."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parity"]:
        # a share of phase 3's cases (start_parity)
        dev, part, parts, path = sys.argv[2:6]
        torch.set_num_threads(2)
        with open(path, "wb") as f:
            pickle.dump(parity_results(dev, int(part), int(parts)), f)
    elif sys.argv[1:2] == ["--i-frame"]:
        # a path's I frame, checkpointed (i_frame)
        torch.set_num_threads(2)
        i_frame(*sys.argv[2:4])
    elif sys.argv[1:2] == ["--serial-cpu"]:
        # phase 11's first P frame on the CPU (serial_cpu)
        torch.set_num_threads(2)
        serial_cpu(sys.argv[2])
    elif sys.argv[1:2] == ["--sao"]:
        # phases 1 and 12 alone
        phase_build()
        print(json.dumps({"sao_kernels": phase_sao()}))
        card_lines()
    else:
        main()
