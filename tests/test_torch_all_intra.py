"""All-intra streams in the port against the JAX package: the torch and
JAX `Encoder`s at intra_period=1 with tiles and the default scaling
lists (chunks of independent I frames, a padded partial chunk), the
K-frame wavefront against per-frame encodes, and tile knobs that an
IPPP stream ignores."""
import numpy as np
import pytest
import torch

from homerhevc_torch import api as tapi
from homerhevc_torch.config import EncoderConfig, RDMode
from homerhevc_torch.models import intra_frame as tintra
from homerhevc_torch.utils.synthetic import synthetic_video
from homerhevc_tpu import api as japi
from homerhevc_tpu import config as jconfig
from tests import jax_cache
from tools import de265

torch.set_num_threads(1)

W, H, N = 176, 144, 6
# 3x3 CTUs in a 2x2 tile grid: tiles of 1 and 2 CTUs per axis
ALL_INTRA = dict(width=W, height=H, qp=32, intra_period=1,
                 intra_frames_per_launch=4, tile_cols=2, tile_rows=2,
                 scaling_lists=True)


def _video():
    """Six frames: striped quadrants (NxN, TU split) in the textured
    ones, and frame 3 flat with mild texture, where SAO derives the same
    parameters in neighbouring CTUs, tile boundaries included."""
    frames = synthetic_video(N, H, W, quads=32)
    y = np.full((H, W), 100, np.uint8)
    y[::7, ::5] = 110
    frames[3] = (y, np.full((H // 2, W // 2), 120, np.uint8),
                 np.full((H // 2, W // 2), 130, np.uint8))
    return frames


def _chunk_recons(enc):
    """Spy on enc._dispatch_i_chunk: a list that collects each chunk's
    reconstructions of its real frames."""
    got = []
    real = enc._dispatch_i_chunk

    def spy(frames):
        pend = real(frames)
        got.append([np.asarray(pend["out"][k][:len(frames)])
                    if not isinstance(pend["out"][k], torch.Tensor)
                    else pend["out"][k][:len(frames)].cpu().numpy()
                    for k in ("recon_y", "recon_u", "recon_v")])
        return pend
    enc._dispatch_i_chunk = spy
    return got


def _run(enc, frames):
    recons = _chunk_recons(enc)
    out = []
    for f in frames:
        out += enc.encode_async(*f)
    out += enc.flush()
    planes = [np.concatenate([r[p] for r in recons]).astype(np.int32)
              for p in range(3)]
    return out, planes


@pytest.fixture(scope="module")
def video():
    return _video()


@pytest.fixture(scope="module")
def jax_run(video, tmp_path_factory):
    return jax_cache.once(tmp_path_factory, "all_intra", lambda d: _run(
        japi.Encoder(jconfig.EncoderConfig(**ALL_INTRA)), video))


def test_all_intra_tiles_scaling_match_jax_and_decode(video, jax_run):
    """Two chunks of four (the second padded): the same bytes frame by
    frame and the same reconstructions as JAX; libde265 decodes the
    stream to them; the synchronous encode() gives the same bytes."""
    cfg = EncoderConfig(**ALL_INTRA)
    assert cfg.tiles == (2, 2)
    enc = tapi.Encoder(cfg, device="cpu")
    out, planes = _run(enc, video)
    jout, jplanes = jax_run
    assert len(out) == len(jout) == N
    assert all(f._is_idr for f in out)
    for k, (a, b) in enumerate(zip(out, jout)):
        assert a.nalus == b.nalus, f"frame {k}: Annex-B bytes differ"
    for p, (a, b) in enumerate(zip(planes, jplanes)):
        np.testing.assert_array_equal(a, b, err_msg=f"plane {p}")
    dec = de265.decode(b"".join(f.nalus for f in out))
    assert len(dec) == N
    for k in range(N):
        for p, d in enumerate(dec[k]):
            np.testing.assert_array_equal(
                d, planes[p][k][:d.shape[0], :d.shape[1]],
                err_msg=f"frame {k} plane {p}: decode != recon")
    sync = tapi.Encoder(cfg, device="cpu")
    assert [sync.encode(*f).nalus for f in video] == [f.nalus for f in out]


def test_i_chunk_equals_per_frame_encodes():
    """encode_i_chunk of three frames at rd=FULL's refinement, NxN and
    the TU split (no tiles) equals three encode_frame calls in every
    output tensor."""
    frames = synthetic_video(3, 64, 128, quads=32, scene_cut=2)
    kw = dict(ctu=64, sign_hiding=True, deblocking=True, sao_enabled=True,
              search_8x8=True, search_nxn=True, tu_split=True,
              rd_refine=True, chroma_qp_offset=2, vis_h=64, vis_w=128,
              true_size=True)
    planes = [torch.as_tensor(np.stack([f[p] for f in frames]))
              for p in range(3)]
    chunk = tintra.encode_i_chunk(*planes, 30, **kw)
    for k in range(3):
        one = tintra.encode_frame(planes[0][k], planes[1][k], planes[2][k],
                                  30, **kw)
        assert sorted(one) == sorted(chunk)
        for key, t in one.items():
            np.testing.assert_array_equal(chunk[key][k].numpy(), t.numpy(),
                                          err_msg=f"frame {k} {key}")
    assert not torch.equal(chunk["recon_y"][0], chunk["recon_y"][2])


def test_tile_knobs_are_ignored_by_ippp():
    """tile_cols / tile_auto at intra_period=100 give no tile grid: the
    port encodes such a stream with the bytes it gives without them."""
    frames = synthetic_video(3, 64, 128)
    base = dict(width=128, height=64, qp=32, intra_period=100,
                rd_mode=RDMode.RD_ULTRAFAST)
    streams = []
    for kw in ({}, dict(tile_cols=2), dict(tile_rows=2, tile_auto=True)):
        cfg = EncoderConfig(**base, **kw)
        assert cfg.tiles is None
        enc = tapi.Encoder(cfg, device="cpu")
        streams.append([enc.encode(*f).nalus for f in frames])
    assert streams[1] == streams[0] and streams[2] == streams[0]
