"""The torch `Encoder` against the JAX `Encoder` at the default
rd=FAST: 128x64, six frames through encode() — a pan with isolated
blocks of new content (intra CUs in P frames), divergent 8x8 motion on
odd frames (8x8 inter CUs), a patch of striped 8x8 quadrants (NxN and
the TU-split fold in I frames), and a scene cut at frame 4 that restarts
the GOP with an IDR at frame 5.  The Annex-B streams are byte-identical,
the reconstructions equal, libde265 decodes the stream to them, and each
rd=FAST tool fired in the torch records."""
import numpy as np
import pytest
import torch

from homerhevc_torch import api as tapi
from homerhevc_torch.config import EncoderConfig
from homerhevc_torch.entropy import binding
from homerhevc_torch.utils.synthetic import synthetic_video
from homerhevc_tpu import api as japi
from homerhevc_tpu import config as jconfig
from tests import jax_cache
from tools import de265

torch.set_num_threads(1)

W, H, N, CUT = 128, 64, 6, 4
SLICE = dict(width=W, height=H, qp=32, intra_period=100)


@pytest.fixture(scope="module")
def video():
    return synthetic_video(N, H, W, plants=8, diverge=32, quads=32,
                           scene_cut=CUT)


def _encode(enc, frames):
    out = [enc.encode(*f) for f in frames]
    return ([f.nalus for f in out], [f.recon for f in out],
            [f._is_idr for f in out])


@pytest.fixture(scope="module")
def jax_run(video, tmp_path_factory):
    return jax_cache.once(tmp_path_factory, "fast_encoder", lambda d: _encode(
        japi.Encoder(jconfig.EncoderConfig(**SLICE)), video))


@pytest.fixture(scope="module")
def torch_run(video):
    """The torch run, with the FrameRecord of every frame it coded."""
    records = []
    real = binding.encode_slice

    def spy(ccfg, rec):
        records.append(rec)
        return real(ccfg, rec)
    binding.encode_slice = spy
    try:
        enc = tapi.Encoder(EncoderConfig(**SLICE), device="cpu")
        return _encode(enc, video) + (records,)
    finally:
        binding.encode_slice = real


def test_fast_stream_and_recon_match_jax_and_decode(jax_run, torch_run):
    jn, jr, _ = jax_run
    tn, tr, _, _ = torch_run
    assert len(tn) == N
    for k, (a, b) in enumerate(zip(tn, jn)):
        assert a == b, f"frame {k}: Annex-B bytes differ"
    for k, (a, b) in enumerate(zip(tr, jr)):
        for p, (x, y) in enumerate(zip(a, b)):
            np.testing.assert_array_equal(x, y, err_msg=f"frame {k} p{p}")
    dec = de265.decode(b"".join(tn))
    assert len(dec) == N
    for k, (got, want) in enumerate(zip(dec, tr)):
        for d, r in zip(got, want):
            np.testing.assert_array_equal(d, r, err_msg=f"frame {k}")


def test_fast_scene_cut_restarts_at_the_same_frame(video, jax_run,
                                                   torch_run):
    """The cut restarts the GOP at frame 5 in both packages; with
    scene_change_reinit=False (a host-side knob: the same compiled JAX
    programs) the cut frame is still mostly intra candidates, but
    neither restarts, and the streams and reconstructions are identical,
    equal to the restarting run's up to the cut, and decode."""
    assert torch_run[2] == jax_run[2]
    assert torch_run[2] == [True, False, False, False, False, True]
    cfg = dict(SLICE, scene_change_reinit=False)
    jenc = japi.Encoder(jconfig.EncoderConfig(**cfg))
    j = [jenc.encode(*f) for f in video]
    tenc = tapi.Encoder(EncoderConfig(**cfg), device="cpu")
    t = [tenc.encode(*f) for f in video]
    assert [f.nalus for f in t] == [f.nalus for f in j]
    assert [f.nalus for f in t[:CUT + 1]] == jax_run[0][:CUT + 1]
    assert [f._is_idr for f in t] == [f._is_idr for f in j] \
        == [True] + [False] * (N - 1)
    assert t[CUT]._intra_frac == j[CUT]._intra_frac > 0.5
    for k, (a, b) in enumerate(zip(t, j)):
        for x, y in zip(a.recon, b.recon):
            np.testing.assert_array_equal(x, y, err_msg=f"frame {k}")
    dec = de265.decode(b"".join(f.nalus for f in t))
    assert len(dec) == N
    for k, (got, f) in enumerate(zip(dec, t)):
        for d, r in zip(got, f.recon):
            np.testing.assert_array_equal(d, r, err_msg=f"frame {k}")


def test_fast_tools_fired(torch_run):
    recs = torch_run[3]
    assert len(recs) == N
    i_recs, p_recs = (recs[0], recs[CUT + 1]), recs[1:CUT + 1]
    # NxN 4x4 PUs in the I frames
    assert all(r.part_size is not None and r.part_size.any()
               for r in i_recs)
    # the TU-split fold: four same-mode 8x8 CUs coded as one 16x16 CU
    # with a split transform tree
    assert any(((r.cu_depth == 2) & (r.tr_depth == 1)).any()
               for r in i_recs)
    # intra CUs and 8x8 inter CUs in P frames
    assert any(r.pred_mode.any() for r in p_recs)
    assert any((r.cu_depth == 3).any() for r in p_recs)
