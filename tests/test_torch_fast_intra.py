"""Units of the rd=FAST slice against the JAX package on seeded inputs,
all exact: the intra frame with the 8x8 split, NxN and the TU split;
sign-bit hiding in the mode-dependent scans; the stable top-k that takes
the place of lax.top_k; and the intra fallback's window gathers at
sizes 33 and 17 against the Pallas kernel in interpret mode."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from homerhevc_torch.models import inter_frame as tinter
from homerhevc_torch.models import intra_frame as tintra
from homerhevc_torch.ops import quant as tquant
from homerhevc_torch.utils.synthetic import synthetic_video
from homerhevc_tpu.models import inter_frame as jinter
from homerhevc_tpu.models import intra_frame as jintra
from homerhevc_tpu.ops import pallas_kernels
from homerhevc_tpu.ops import quant as jquant

torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def test_intra_frame_fast_flags_match_jax():
    """encode_frame at 64x64 with search_8x8, search_nxn and tu_split:
    every output (records, coefficients, reconstructions) equal."""
    y, u, v = synthetic_video(1, 64, 64, quads=32)[0]
    kw = dict(qp=32, ctu=64, sign_hiding=True, deblocking=True,
              sao_enabled=True, search_8x8=True, search_nxn=True,
              tu_split=True, vis_h=64, vis_w=64, true_size=True)
    want = jintra.encode_frame_jit(y, u, v, **kw)
    got = tintra.encode_frame(_t(y), _t(u), _t(v), **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert int(got["nxn"].sum()) > 0 and int((got["depth"] == 3).sum()) > 0


def test_sbh_by_mode_matches_jax_in_all_three_scans():
    rng = np.random.default_rng(11)
    for size in (4, 8):
        n = 96
        coeff = (rng.laplace(0, 600, (n, size, size))
                 * (rng.random((n, size, size)) < 0.5)).astype(np.int32)
        # modes 0..34 cover the diagonal, horizontal (22-30) and
        # vertical (6-14) scans
        mode = np.arange(n, dtype=np.int32) % 35
        for qp in (22, 32):
            lv_j, du_j = jquant.quantize(jnp.asarray(coeff), qp, size,
                                         is_intra=True)
            lv_t, du_t = tquant.quantize(_t(coeff), qp, size, is_intra=True)
            np.testing.assert_array_equal(lv_t.numpy(), np.asarray(lv_j))
            want = jax.jit(lambda a, b, m: jintra._sbh_by_mode(
                a, b, m, size, True))(lv_j, du_j, jnp.asarray(mode))
            got = tintra._sbh_by_mode(lv_t, du_t, _t(mode), size, True)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=str((size, qp)))
            assert not np.array_equal(got.numpy(), lv_t.numpy())


def test_topk_stable_matches_lax_top_k_with_planted_ties():
    rng = np.random.default_rng(3)
    for dtype in (np.int32, np.float32):
        x = rng.integers(-2, 6, 300).astype(dtype)
        x[[5, 17, 250]] = 9                  # a planted three-way tie
        x[-4:] = -1                          # ties at the bottom too
        for k in (1, 3, 64, 300):
            wv, wi = jax.lax.top_k(jnp.asarray(x), k)
            gv, gi = tinter.topk_stable(_t(x), k)
            np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
            np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        assert tinter.topk_stable(_t(x), 3)[1].tolist() == [5, 17, 250]


def test_fallback_adi_gathers_match_jax_and_pallas(monkeypatch):
    """_gather_adi_blocks at the fallback's window sizes: 33 (luma,
    16x16 blocks) and 17 (chroma, 8x8), against the JAX function and,
    for the windows, the Pallas gather in interpret mode."""
    monkeypatch.setattr(pallas_kernels, "_GATHER_CHUNK", 8)
    rng = np.random.default_rng(17)
    for s, (hp, wp) in ((16, (1 + 64 + 16, 1 + 96 + 16)),
                        (8, (1 + 32 + 8, 1 + 48 + 8))):
        buf = rng.integers(0, 256, (hp, wp)).astype(np.int32)
        n = 11
        py = (rng.integers(0, (hp - 1 - s) // s, n) * s).astype(np.int32)
        px = (rng.integers(0, (wp - 1 - s) // s, n) * s).astype(np.int32)
        want = jax.jit(lambda b, a, c: jinter._gather_adi_blocks(
            b, a, c, s))(buf, py, px)
        got = tinter._gather_adi_blocks(_t(buf), _t(py), _t(px), s)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        win = pallas_kernels.gather_windows_pallas(
            jnp.asarray(buf), jnp.asarray(py), jnp.asarray(px), 2 * s + 1,
            interpret=True)
        np.testing.assert_array_equal(
            got.numpy(), np.concatenate(
                [np.asarray(win)[:, 2 * s:0:-1, 0], np.asarray(win)[:, 0]],
                -1))
