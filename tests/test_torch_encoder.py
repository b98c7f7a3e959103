"""The torch `Encoder` against the JAX `Encoder` at the port's supported
configuration (IPPP, rd=ULTRAFAST, fixed QP, one reference): 176x144,
1 I + 4 P frames through encode_async/flush.  The Annex-B streams are
byte-identical, the reconstructions equal, and libde265 decodes the
stream to them.  Also: the checkpoint hand-over from the JAX encoder to
the torch one, the port's import isolation, and num_chips/num_hosts
without a process group."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from homerhevc_torch import api as tapi
from homerhevc_torch.config import EncoderConfig, RDMode
from homerhevc_torch.utils.synthetic import synthetic_video
from homerhevc_tpu import api as japi
from homerhevc_tpu import config as jconfig
from tests import jax_cache
from tools import de265

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
W, H, N = 176, 144, 5
SLICE = dict(width=W, height=H, qp=32, intra_period=100)


def _planes(ref):
    return [np.asarray(r.cpu().numpy() if isinstance(r, torch.Tensor)
                       else r).astype(np.int32) for r in ref]


def _run(enc, frames, ckpt):
    """I frame, flush, checkpoint, then the P frames as one chunk.
    Returns (per-frame Annex-B, I recon planes, last recon planes)."""
    out = enc.encode_async(*frames[0]) + enc.flush()
    i_ref = _planes(enc._ref)
    enc.save_checkpoint(str(ckpt))
    for f in frames[1:]:
        out += enc.encode_async(*f)
    out += enc.flush()
    return [f.nalus for f in out], i_ref, _planes(enc._ref)


@pytest.fixture(scope="module")
def video():
    return synthetic_video(N, H, W)


@pytest.fixture(scope="module")
def jax_run(video, tmp_path_factory):
    def run(d):
        cfg = jconfig.EncoderConfig(rd_mode=jconfig.RDMode.RD_ULTRAFAST,
                                    **SLICE)
        return _run(japi.Encoder(cfg), video, d / "after_i.npz") \
            + (d / "after_i.npz",)
    return jax_cache.once(tmp_path_factory, "encoder", run)


@pytest.fixture(scope="module")
def torch_run(video, tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("torch") / "after_i.npz"
    cfg = EncoderConfig(rd_mode=RDMode.RD_ULTRAFAST, **SLICE)
    return _run(tapi.Encoder(cfg, device="cpu"), video, ckpt) + (ckpt,)


def test_stream_and_recon_match_jax_and_decode(jax_run, torch_run):
    jn, ji, jl, _ = jax_run
    tn, ti, tl, _ = torch_run
    assert len(tn) == N
    for k, (a, b) in enumerate(zip(tn, jn)):
        assert a == b, f"frame {k}: Annex-B bytes differ"
    for a, b in zip(ti + tl, ji + jl):
        np.testing.assert_array_equal(a, b)
    dec = de265.decode(b"".join(tn))
    assert len(dec) == N
    for got, want in ((dec[0], ti), (dec[-1], tl)):
        for p, (d, r) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(
                d, r[:H >> (p > 0), :W >> (p > 0)])


def test_checkpoints_match_jax(jax_run, torch_run):
    zj, zt = np.load(jax_run[3]), np.load(torch_run[3])
    assert sorted(zj.files) == sorted(zt.files)
    for k in zj.files:
        np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
    st = tapi.state_from_numpy(
        {"poc": np.int64(3), "ref_y": np.zeros((4, 4), np.uint8),
         "rc.qp": np.float64(30.0)}, "cpu")
    assert st["ref_y"].dtype == torch.int32 and int(st["poc"]) == 3
    assert float(st["rc.qp"]) == 30.0


def test_p_frames_from_jax_checkpoint(video, jax_run):
    """The JAX encoder's state after its I frame, handed to the torch
    encoder, gives the same P frames."""
    cfg = EncoderConfig(rd_mode=RDMode.RD_ULTRAFAST, **SLICE)
    enc = tapi.Encoder(cfg, device="cpu")
    enc.load_checkpoint(str(jax_run[3]))
    assert all(r.dtype == torch.int32 for r in enc._ref)
    out = []
    for f in video[1:]:
        out += enc.encode_async(*f)
    out += enc.flush()
    assert [f.nalus for f in out] == jax_run[0][1:]
    for a, b in zip(_planes(enc._ref), jax_run[2]):
        np.testing.assert_array_equal(a, b)


def _port_sources():
    return sorted((ROOT / "homerhevc_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_reference():
    banned = ("jax", "jaxlib", "homerhevc_tpu")
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, (path, name)
    code = ("import sys, pkgutil, importlib, homerhevc_torch\n"
            "for m in pkgutil.walk_packages(homerhevc_torch.__path__, "
            "'homerhevc_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'homerhevc_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_encoder_runs_on_cuda_unless_told(monkeypatch):
    cfg = EncoderConfig(rd_mode=RDMode.RD_ULTRAFAST, **SLICE)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tapi.Encoder(cfg)
    assert tapi.Encoder(cfg, device="cpu").device.type == "cpu"


def test_configs_outside_the_port_raise(video, torch_run, tmp_path):
    """num_chips and num_hosts above 1 are accepted, as the JAX Encoder
    accepts them: without a process group num_chips=2 runs on one device
    (the JAX Encoder with fewer devices), and num_hosts is not read; both
    give the num_chips=1 stream."""
    for kw in [dict(num_chips=2), dict(num_hosts=2)]:
        args = dict(SLICE, rd_mode=RDMode.RD_ULTRAFAST)
        args.update(kw)
        enc = tapi.Encoder(EncoderConfig(**args), device="cpu")
        assert (enc.n_bands, enc.n_frame_shards) == (1, 1)
        nalus = _run(enc, video, tmp_path / "ckpt.npz")[0]
        assert nalus == torch_run[0], kw
