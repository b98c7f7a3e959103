"""The port's console app (`python -m homerhevc_torch`) against the JAX
package's (`homerhevc_tpu.cli`), both run in-process on one 176x144
YUV file, on two groups of the IPPP knobs the app exposes:

* K1, the synchronous path (`-o-raw` and `-stats`): intra_period 0,
  performance_mode FULL (ME subpel radius 3), half-pel ME, max_pred_depth
  3 (no I-frame NxN), max_intra_tr_depth 0 (no TU split), sign hiding
  off, one skipped frame;
* K2, the encode_async/flush path: integer-pel ME, max_pred_depth 2 (no
  I-frame 8x8 split), SAO and deblocking off, a chroma QP offset of -3.

The `.265` files are byte-identical, K1's `-o-raw` files and `-stats`
lines too, and libde265 decodes each stream to the port's own
reconstruction.  One more item drives the app's exits and errors without
any JAX compile."""
import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from homerhevc_torch import cli as tcli
from homerhevc_torch.models import inter_frame as tinter
from homerhevc_torch.models import intra_frame as tintra
from homerhevc_torch.utils.synthetic import synthetic_video
from homerhevc_tpu import cli as jcli
from homerhevc_tpu.ops import pallas_kernels
from tests import jax_cache
from tools import de265

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, N = 176, 144, 6
K1 = ("-qp 30 -intra_period 0 -performance_mode 0 "
      "-motion_estimation_precision 1 -max_pred_depth 3 "
      "-max_intra_tr_depth 0 -sign_hiding 0 -skipped_frames 1 "
      "-n_frames 5").split()
K2 = ("-qp 36 -motion_estimation_precision 0 -max_pred_depth 2 -sao 0 "
      "-deblocking 0 -chroma_qp_offset -3 -frame_rate 30 -n_frames 6").split()


@pytest.fixture(scope="module")
def video():
    return synthetic_video(N, H, W, plants=8, diverge=32)


@pytest.fixture(scope="module")
def yuv(video, tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "in.yuv"
    with open(path, "wb") as f:
        for planes in video:
            for p in planes:
                f.write(np.ascontiguousarray(p).tobytes())
    return path


def _run(main, yuv, flags, sync, **kw):
    """One app run: (.265 bytes, -o-raw bytes, -stats lines, kbps line)."""
    d = yuv.parent
    tag = main.__module__.split(".")[0] + ("_sync" if sync else "_async")
    argv = ["-i", str(yuv), "-o", str(d / f"{tag}.265"),
            "-widthxheight", f"{W}x{H}"] + flags
    if sync:
        argv += ["-o-raw", str(d / f"{tag}.yuv"),
                 "-stats", str(d / f"{tag}.jsonl")]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv, **kw) == 0
    kbps = [x for x in out.getvalue().splitlines() if x.startswith("kbps:")]
    return ((d / f"{tag}.265").read_bytes(),
            (d / f"{tag}.yuv").read_bytes() if sync else None,
            (d / f"{tag}.jsonl").read_text().splitlines() if sync else None,
            kbps)


def _jax_run(yuv, flags, sync):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HEVC_TPU_NO_COMPILE_CACHE", "1")
        mp.setattr(pallas_kernels, "_GATHER_CHUNK", 8)
        return _run(jcli.main, yuv, flags, sync)


def _torch_run(yuv, flags, sync):
    """The port's run, with the reconstruction of every frame its frame
    programs made (a padded chunk's repeats of its last frame included)
    and the number of frames of each dispatched chunk."""
    recons, chunks = [], []
    real_i, real_p = tintra.encode_frame, tinter.encode_p_frame
    real_chunk = tinter.encode_p_chunk_packed

    def keep(out):
        recons.append(tuple(out[f"recon_{p}"].numpy() for p in "yuv"))
        return out
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tintra, "encode_frame", lambda *a, **k: keep(
            real_i(*a, **k)))
        mp.setattr(tinter, "encode_p_frame", lambda *a, **k: keep(
            real_p(*a, **k)))
        mp.setattr(tinter, "encode_p_chunk_packed", lambda *a, **k: (
            chunks.append(k["k"]), real_chunk(*a, **k))[1])
        res = _run(tcli.main, yuv, flags, sync, device="cpu")
    return res, recons, chunks


@pytest.fixture(scope="module")
def k1_jax(yuv, tmp_path_factory):
    return jax_cache.once(tmp_path_factory, "cli_k1",
                          lambda d: _jax_run(yuv, K1, True))


@pytest.fixture(scope="module")
def k1_torch(yuv):
    return _torch_run(yuv, K1, True)


@pytest.fixture(scope="module")
def k2_jax(yuv, tmp_path_factory):
    return jax_cache.once(tmp_path_factory, "cli_k2",
                          lambda d: _jax_run(yuv, K2, False))


@pytest.fixture(scope="module")
def k2_torch(yuv):
    return _torch_run(yuv, K2, False)


def _decode_to(stream, recons):
    dec = de265.decode(stream)
    assert len(dec) == len(recons)
    for k, (got, want) in enumerate(zip(dec, recons)):
        for d, r in zip(got, want):
            np.testing.assert_array_equal(d, r[:d.shape[0], :d.shape[1]],
                                          err_msg=f"frame {k}")


def test_k1_sync_path_matches_jax_cli_and_decodes(k1_jax, k1_torch):
    """K1 through encode(): the same .265, -o-raw and -stats as the JAX
    app; five frames after the skipped one, the first of them the only
    IDR (intra_period 0); the raw file is what libde265 decodes."""
    (tb, traw, tstats, tkbps), recons, chunks = k1_torch
    jb, jraw, jstats, jkbps = k1_jax
    assert tb == jb, "K1: .265 bytes differ"
    assert traw == jraw, "K1: -o-raw reconstructions differ"
    assert tstats == jstats and tkbps == jkbps
    assert len(tstats) == 5 and chunks == [1] * 4
    assert tb.count(b"\x00\x00\x01\x40\x01") == 1     # one VPS: one IDR
    fs = W * H * 3 // 2
    frames = []
    for k in range(5):
        y = np.frombuffer(traw, np.uint8, W * H, k * fs).reshape(H, W)
        u = np.frombuffer(traw, np.uint8, fs // 6, k * fs + W * H) \
            .reshape(H // 2, W // 2)
        v = np.frombuffer(traw, np.uint8, fs // 6, k * fs + W * H + fs // 6) \
            .reshape(H // 2, W // 2)
        frames.append((y, u, v))
        for p, r in zip((y, u, v), recons[k]):
            np.testing.assert_array_equal(p, r[:p.shape[0], :p.shape[1]])
    _decode_to(tb, frames)


def test_k2_async_path_matches_jax_cli_and_decodes(k2_jax, k2_torch):
    """K2 through encode_async/flush: the same .265 as the JAX app (the
    I frame, a chunk of four P frames, then a chunk holding the last
    frame padded to four); libde265 decodes it to the port's
    reconstructions."""
    (tb, _, _, tkbps), recons, chunks = k2_torch
    jb, _, _, jkbps = k2_jax
    assert tb == jb, "K2: .265 bytes differ"
    assert tkbps == jkbps
    assert chunks == [4, 4]
    # the I frame, frames 1-4, then frame 5 (its chunk's first frame)
    _decode_to(tb, recons[:6])


def test_cli_exits_and_errors(tmp_path, video):
    """-h, no arguments, an unknown option, missing -i/-o, -num_chips 2
    without a process group (one device: the -num_chips 1 bytes, as the
    JAX app with fewer devices), a file shorter than -n_frames
    (rd=ULTRAFAST, 64x64 crop), main()
    without a device on a machine without CUDA, and `python -m
    homerhevc_torch -h` importing neither jax nor homerhevc_tpu."""
    for argv, code, text in (
            (["-h"], 0, "homerhevc_torch [-option]"),
            (["-qp", "30", "-bogus", "1"], 1, "unknown option -bogus"),):
        out = io.StringIO()
        with contextlib.redirect_stdout(out), \
                pytest.raises(SystemExit) as e:
            tcli.main(argv, device="cpu")
        assert e.value.code == code and text in out.getvalue()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tcli.main([], device="cpu") == 0
        assert tcli.main(["-i", "x.yuv"], device="cpu") == 1
    assert "no args passed!" in out.getvalue()
    assert "need -i and -o" in out.getvalue()
    yuv = tmp_path / "short.yuv"
    with open(yuv, "wb") as f:
        for y, u, v in video[:3]:
            for p in (y[:64, :64], u[:32, :32], v[:32, :32]):
                f.write(np.ascontiguousarray(p).tobytes())
    base = ["-i", str(yuv), "-o", str(tmp_path / "o.265"),
            "-widthxheight", "64x64", "-rd", "2", "-n_frames", "5"]
    two = [str(tmp_path / "o2.265") if a.endswith("o.265") else a
           for a in base] + ["-num_chips", "2"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tcli.main(base, device="cpu") == 0
        assert tcli.main(two, device="cpu") == 0
    assert out.getvalue().startswith("3 frames in ")
    assert len(de265.decode((tmp_path / "o.265").read_bytes())) == 3
    assert (tmp_path / "o2.265").read_bytes() == \
        (tmp_path / "o.265").read_bytes()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tcli.main(base)
    code = ("import runpy, sys\n"
            "sys.argv = ['homerhevc_torch', '-h']\n"
            "try:\n"
            "    runpy.run_module('homerhevc_torch', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'homerhevc_tpu')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("homerhevc_torch [-option]")
    res = subprocess.run([sys.executable, "-m", "homerhevc_torch", "-h"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and "-num_chips" in res.stdout
