"""The default scaling lists in the port against the JAX package: the
quantizer at every TB size, and the IPPP `Encoder` with
scaling_lists=True (every TQ call of the I and P frames).  Also the
P frame's scene-change gate, whose mean ME cost is a float32 sum in
XLA-CPU's order, at planted costs right at its threshold."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homerhevc_torch import api as tapi
from homerhevc_torch.config import EncoderConfig
from homerhevc_torch.entropy import binding
from homerhevc_torch.models import inter_frame as tinter
from homerhevc_torch.ops import quant as tquant
from homerhevc_torch.utils.synthetic import synthetic_video
from homerhevc_tpu import api as japi
from homerhevc_tpu import config as jconfig
from homerhevc_tpu.ops import quant as jquant
from tools import de265

torch.set_num_threads(1)

W, H, N = 128, 64, 5
SLICE = dict(width=W, height=H, qp=30, intra_period=100, scaling_lists=True)


def test_quant_scaling_lists_match_jax():
    """quantize / dequantize(scaling=True) at sizes 4-32, intra and
    inter, one QP and a per-block QP tensor, on coefficients up to the
    clip range: exact, and unlike the flat path above 4x4."""
    rng = np.random.default_rng(6)
    for size in (4, 8, 16, 32):
        n = 24
        coeff = rng.integers(-32768, 32768, (n, size, size))
        coeff[: n // 2] //= rng.integers(1, 2000, (n // 2, 1, 1))
        coeff = coeff.astype(np.int32)
        qp_blk = rng.integers(0, 52, n).astype(np.int32)
        for is_intra in (True, False):
            for qp in (27, qp_blk):
                q_t = qp if np.ndim(qp) == 0 else torch.as_tensor(qp)
                lv_j, du_j = jquant.quantize(jnp.asarray(coeff), qp, size,
                                             is_intra=is_intra, scaling=True)
                lv_t, du_t = tquant.quantize(torch.as_tensor(coeff), q_t,
                                             size, is_intra=is_intra,
                                             scaling=True)
                what = f"size {size} intra {is_intra} qp {np.ndim(qp)}-d"
                np.testing.assert_array_equal(lv_t.numpy(), np.asarray(lv_j),
                                              err_msg=what)
                np.testing.assert_array_equal(du_t.numpy(), np.asarray(du_j),
                                              err_msg=what)
                dq_j = jquant.dequantize(lv_j, qp, size, is_intra=is_intra,
                                         scaling=True)
                dq_t = tquant.dequantize(lv_t, q_t, size, is_intra=is_intra,
                                         scaling=True)
                np.testing.assert_array_equal(dq_t.numpy(), np.asarray(dq_j),
                                              err_msg=what)
                flat = tquant.dequantize(lv_t, q_t, size, is_intra=is_intra)
                assert (size == 4) == torch.equal(flat, dq_t), what


def _run(enc, frames):
    """The I frame, flush, then the four P frames as one chunk: per-frame
    Annex-B, the I and the last reconstruction."""
    out = enc.encode_async(*frames[0]) + enc.flush()
    refs = [np.asarray(r.cpu().numpy() if isinstance(r, torch.Tensor)
                       else r).astype(np.int32) for r in enc._ref]
    for f in frames[1:]:
        out += enc.encode_async(*f)
    out += enc.flush()
    refs += [np.asarray(r.cpu().numpy() if isinstance(r, torch.Tensor)
                        else r).astype(np.int32) for r in enc._ref]
    return [f.nalus for f in out], refs


@pytest.fixture(scope="module")
def video():
    return synthetic_video(N, H, W, plants=8, diverge=32, quads=32)


def test_ippp_scaling_lists_match_jax_and_decode(video):
    """128x64, 1 I + 4 P in one chunk, rd=FAST with the intra fallback
    and the 8x8 split firing: the same bytes and reconstructions as JAX,
    and libde265 decodes the stream to them."""
    want, want_refs = _run(japi.Encoder(jconfig.EncoderConfig(**SLICE)),
                           video)
    records = []
    real = binding.encode_slice

    def spy(ccfg, rec):
        records.append(rec)
        return real(ccfg, rec)
    binding.encode_slice = spy
    try:
        got, refs = _run(tapi.Encoder(EncoderConfig(**SLICE), device="cpu"),
                         video)
    finally:
        binding.encode_slice = real
    assert len(got) == N
    for k, (a, b) in enumerate(zip(got, want)):
        assert a == b, f"frame {k}: Annex-B bytes differ"
    for a, b in zip(refs, want_refs):
        np.testing.assert_array_equal(a, b)
    assert records[0].is_idr and not any(r.is_idr for r in records[1:])
    assert sum(int(r.pred_mode.sum()) for r in records[1:]) > 0, \
        "no intra CU in a P frame"
    assert sum(int((r.cu_depth == 3).sum()) for r in records[1:]) > 0, \
        "no 8x8 inter split"
    dec = de265.decode(b"".join(got))
    assert len(dec) == N
    for got_planes, want_planes in ((dec[0], refs[:3]), (dec[-1], refs[3:])):
        for d, r in zip(got_planes, want_planes):
            np.testing.assert_array_equal(d, r[:d.shape[0], :d.shape[1]])


def test_scene_gate_mean_matches_xla_at_the_threshold():
    """sad_me planted so that its exact sum lies within a few float32
    steps of 6.0 per pixel, at the grids of 128x64, 128x128, 176x144,
    416x240, 1280x720 and 1920x1080 frames, and of the tall narrow
    pictures 64 or 128 wide and 256-512 or 1024 tall (which XLA sums in
    vector lanes): the port's gate equals the reference's (jnp.sum of
    the float32 grid, then the division, under jax.jit on the CPU),
    where a float64 mean would not."""
    rng = np.random.default_rng(12)
    f64_differs = 0
    tall = [(r, c) for r in (16, 20, 24, 28, 32, 64) for c in (4, 8)]
    for bh, bw in [(4, 8), (8, 8), (12, 12), (16, 28), (48, 80),
                   (68, 120)] + tall:
        h, w = 16 * bh, 16 * bw
        ref = jax.jit(lambda s, c: (c > bh * bw // 4) | (
            jnp.sum(s).astype(jnp.float32) / (h * w) > 6.0))
        for t in range(40):
            x = rng.random((bh, bw)) * 3072.0 + 0.3
            x = (x * (6.0 * h * w / x.sum())).astype(np.float32)
            i, j = rng.integers(0, bh), rng.integers(0, bw)
            step = np.float32(np.inf if t % 2 else -np.inf)
            for _ in range(t % 7):
                x[i, j] = np.nextafter(x[i, j], step)
            cand = np.int32(0 if t % 10 else bh * bw)
            want = bool(ref(x, cand))
            got = bool(tinter._maybe_scene(torch.as_tensor(x),
                                           torch.tensor(cand), h, w))
            assert got == want, ((bh, bw), t)
            f64_differs += (x.astype(np.float64).sum() / (h * w) > 6.0) \
                != want
    assert f64_differs > 0
