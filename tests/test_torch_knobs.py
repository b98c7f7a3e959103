"""The torch `Encoder` against the JAX `Encoder` on the knobs the console
app does not reach (K3): padded-size coding (code_true_size=False), P
frames without the intra fallback (intra_in_p=False) and no GOP restart
at a scene cut (scene_change_reinit=False), with `control()` in
mid-stream to the same configuration at another QP.

176x144 (coded as 192x192), six frames through encode(): frames 0-2 at
QP 32, then control() and frames 3-5 at QP 27.  control() restarts the
stream with an IDR at frame 3; frame 4 is the scene cut, which stays a P
frame, and so does frame 5.  The Annex-B bytes and the reconstructions
are identical, and libde265 decodes the stream to them."""
import dataclasses

import numpy as np
import pytest
import torch

from homerhevc_torch import api as tapi
from homerhevc_torch.config import EncoderConfig
from homerhevc_torch.utils.synthetic import synthetic_video
from homerhevc_tpu import api as japi
from homerhevc_tpu import config as jconfig
from homerhevc_tpu.ops import pallas_kernels
from tests import jax_cache
from tools import de265

torch.set_num_threads(1)

W, H, N, CUT, CONTROL_AT = 176, 144, 6, 4, 3
K3 = dict(width=W, height=H, code_true_size=False, intra_in_p=False,
          scene_change_reinit=False)


@pytest.fixture(scope="module")
def video():
    return synthetic_video(N, H, W, plants=8, diverge=32, quads=32,
                           scene_cut=CUT)


def _encode(enc, cfg, frames):
    """Frames before CONTROL_AT at cfg's QP, the rest at QP 27 after
    control(): per frame (bytes, recon, IDR flag, intra share)."""
    out = []
    for k, f in enumerate(frames):
        if k == CONTROL_AT:
            enc.control(dataclasses.replace(cfg, qp=27))
        fr = enc.encode(*f)
        out.append((fr.nalus, fr.recon, fr._is_idr, fr._intra_frac))
    return out


@pytest.fixture(scope="module")
def jax_run(video, tmp_path_factory):
    def run(d):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pallas_kernels, "_GATHER_CHUNK", 8)
            cfg = jconfig.EncoderConfig(**K3)
            return _encode(japi.Encoder(cfg), cfg, video)
    return jax_cache.once(tmp_path_factory, "knobs", run)


@pytest.fixture(scope="module")
def torch_run(video):
    cfg = EncoderConfig(**K3)
    return _encode(tapi.Encoder(cfg, device="cpu"), cfg, video)


def test_knobs_with_control_match_jax_and_decode(jax_run, torch_run):
    assert len(torch_run) == N
    for k, (t, j) in enumerate(zip(torch_run, jax_run)):
        assert t[0] == j[0], f"frame {k}: Annex-B bytes differ"
        for p, (a, b) in enumerate(zip(t[1], j[1])):
            np.testing.assert_array_equal(a, b, err_msg=f"frame {k} p{p}")
    dec = de265.decode(b"".join(t[0] for t in torch_run))
    assert len(dec) == N
    for k, (got, t) in enumerate(zip(dec, torch_run)):
        for d, r in zip(got, t[1]):
            np.testing.assert_array_equal(d, r, err_msg=f"frame {k}")


def test_scene_cut_keeps_the_gop_without_reinit(jax_run, torch_run):
    """Neither package restarts at the cut.  Without the intra fallback a
    P frame counts no intra candidates (both report a share of 0), so the
    scene gate has nothing to fire on; test_torch_fast_encoder.py holds
    scene_change_reinit=False where the gate does fire."""
    idr = [k in (0, CONTROL_AT) for k in range(N)]
    assert [t[2] for t in torch_run] == [j[2] for j in jax_run] == idr
    assert [t[3] for t in torch_run] == [j[3] for j in jax_run] == [0.0] * N
