"""The port's ops against the JAX package on small seeded inputs:
transform, quant + sign-bit hiding, interpolation, RD bit estimates
(float32, exact), intra prediction, deblocking, SAO and packing.  The JAX
side runs jitted where its float32 evaluation order matters, as in the
encoder.  Each test loops over its cases, so that the file stays a few
items long for the test runner's per-file scheduling; SAO's cases are
items of their own."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homerhevc_torch import tables
from homerhevc_torch.ops import (deblock, interp, intra, packing, quant,
                                 rdbits, sao, transform)
from homerhevc_tpu import tables as jtables
from homerhevc_tpu.ops import deblock as jdeblock
from homerhevc_tpu.ops import interp as jinterp
from homerhevc_tpu.ops import intra as jintra
from homerhevc_tpu.ops import packing as jpacking
from homerhevc_tpu.ops import quant as jquant
from homerhevc_tpu.ops import rdbits as jrdbits
from homerhevc_tpu.ops import sao as jsao
from homerhevc_tpu.ops import transform as jtransform

torch.set_num_threads(1)


def _t(a, dtype=np.int32):
    return torch.as_tensor(np.ascontiguousarray(a, dtype))


def _eq(got, want, case=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=str(case))


def test_transforms_quant_dequant_sbh():
    for size, dst in [(4, False), (4, True), (8, False), (16, False),
                      (32, False)]:
        rng = np.random.default_rng(size)
        res = rng.integers(-255, 256, (6, size, size)).astype(np.int32)
        _eq(transform.forward_transform(_t(res), size, is_dst=dst),
            jax.jit(lambda a: jtransform.forward_transform(
                a, size, is_dst=dst))(res), (size, dst))
        coeff = rng.integers(-3000, 3000, (6, size, size)).astype(np.int32)
        _eq(transform.inverse_transform(_t(coeff), size, is_dst=dst),
            jax.jit(lambda a: jtransform.inverse_transform(
                a, size, is_dst=dst))(coeff), (size, dst))
    for size, qp, is_intra in [(4, 22, True), (8, 32, False),
                               (16, 37, False), (32, 30, True)]:
        case = (size, qp, is_intra)
        rng = np.random.default_rng(qp)
        coeff = (rng.laplace(0, 60, (5, size, size))).astype(np.int32)
        lv, du = quant.quantize(_t(coeff), qp, size, is_intra=is_intra)
        jlv, jdu = jax.jit(lambda c: jquant.quantize(
            c, qp, size, is_intra=is_intra))(coeff)
        _eq(lv, jlv, case)
        _eq(du, jdu, case)
        scan = tables.scan_order(size, tables.SCAN_DIAG)
        sb = quant.sign_bit_hide(lv, du, scan, size)
        _eq(sb, jax.jit(lambda a, b: jquant.sign_bit_hide(
            a, b, tuple(scan), size))(jlv, jdu), case)
        _eq(quant.dequantize(sb, qp, size, is_intra=is_intra),
            jax.jit(lambda a: jquant.dequantize(
                a, qp, size, is_intra=is_intra))(sb.numpy()), case)


def test_mc_phases_and_fir_stages():
    for luma, size in [(True, 16), (True, 8), (False, 8), (False, 4)]:
        rng = np.random.default_rng(size + luma)
        taps = 8 if luma else 4
        n = 40
        win = rng.integers(0, 256, (n, size + taps - 1, size + taps - 1))
        ph = 4 if luma else 8
        fy = rng.integers(0, ph, n)
        fx = rng.integers(0, ph, n)
        got = interp.mc_separable_phases(_t(win), _t(fy), _t(fx), size,
                                         luma)
        want = jax.jit(lambda a, y, x: jinterp.mc_separable_phases(
            a, y, x, size, luma))(win.astype(np.int32), fy, fx)
        _eq(got, want, (luma, size))
    # the port's tap sums against the reference's band-matrix form
    for luma, phase in [(True, 1), (True, 2), (False, 5)]:
        size, off = 8, 1
        taps = 8 if luma else 4
        rows = size + taps - 1 + off
        band = interp._band_np(phase, luma, size, rows, off)
        _eq(band, jinterp._band_np(phase, luma, size, rows, off),
            (luma, phase))
        rng = np.random.default_rng(phase)
        win = rng.integers(0, 256, (3, rows, rows)).astype(np.int32)
        coef = interp._filters(luma, torch.device("cpu"))[phase]
        band64 = band.astype(np.int64)
        _eq(interp.fir_h(_t(win), coef, size, off), win @ band64,
            (luma, phase))
        _eq(interp.fir_v(_t(win), coef, size, off),
            np.swapaxes(band64, 0, 1) @ win, (luma, phase))


def _sparse_levels(rng, n, size):
    lv = rng.integers(-40, 41, (n, size, size))
    lv = np.where(rng.random(lv.shape) < 0.8, 0, lv)
    lv[0] = 0                                  # an all-zero TB
    lv[1, 0, 0] = 9000                         # large escape level
    lv[2, -1, -1] = -3
    return lv.astype(np.int32)


def test_rd_bits_exact_f32():
    for size in (4, 8, 16, 32):
        rng = np.random.default_rng(size)
        lv = _sparse_levels(rng, 24, size)
        qp = rng.integers(18, 46, 24).astype(np.int32)
        got = rdbits.residual_bits(_t(lv), size, qp=_t(qp))
        want = jax.jit(lambda a, q: jrdbits.residual_bits(a, size, qp=q))(
            jnp.asarray(lv), jnp.asarray(qp))
        assert got.dtype == torch.float32
        _eq(got, want, size)
        _eq(rdbits.residual_bits(_t(lv), size),
            jax.jit(lambda a: jrdbits.residual_bits(a, size))(
                jnp.asarray(lv)), size)
    rng = np.random.default_rng(0)
    mvd = rng.integers(-600, 601, (500, 2)).astype(np.int32)
    mvd[:4] = [[0, 0], [1, -1], [2, 3], [16382 * 2, 4]]
    _eq(rdbits.mvd_bits(_t(mvd)), jax.jit(jrdbits.mvd_bits)(mvd))
    qps = np.arange(0, 58, dtype=np.int32)
    _eq(rdbits.qp_scale(_t(qps)), jax.jit(jrdbits.qp_scale)(qps))
    for intra_slice in (True, False):
        want = jax.jit(lambda q: jtables.rd_lambda(q, intra_slice)
                       .astype(jnp.float32))(qps)
        _eq(rdbits.rd_lambda_f32(_t(qps), intra_slice), want, intra_slice)


def test_intra_prediction():
    for size, luma in [(4, True), (8, True), (16, True), (32, True),
                       (8, False), (16, False)]:
        case = (size, luma)
        rng = np.random.default_rng(size * 3 + luma)
        n = 12
        adi = rng.integers(0, 256, (n, 4 * size + 1)).astype(np.int32)
        adi[0] = 100 + np.arange(4 * size + 1) // 8  # smooth: strong filter
        avail = rng.random((n, 4 * size + 1)) < 0.7
        avail[1] = False
        sub = intra.substitute_refs(_t(adi), torch.as_tensor(avail))
        jsub = jax.jit(jintra.substitute_refs)(adi, avail)
        _eq(sub, jsub, case)
        strong = luma and size == 32
        _eq(intra.predict_all_modes(sub, size, luma, strong=strong),
            jax.jit(lambda a: jintra.predict_all_modes(
                a, size, luma, strong=strong))(jsub), case)
        mode = rng.integers(0, 35, n).astype(np.int32)
        mode[:4] = (0, 1, 10, 26)
        _eq(intra.predict_single_mode(sub, _t(mode), size, luma,
                                      strong=strong),
            jax.jit(lambda a, m: jintra.predict_single_mode(
                a, m, size, luma, strong=strong))(jsub, mode), case)


def test_deblock_luma_chroma():
    rng = np.random.default_rng(5)
    h, w = 64, 96
    y = np.clip(rng.normal(128, 20, (h, w)), 0, 255).astype(np.int32)
    y[:, 40:] += 9                                # a real edge
    y = np.clip(y, 0, 255)
    bs_v = rng.integers(0, 3, (h // 4, w // 8)).astype(np.int32)
    bs_h = rng.integers(0, 3, (h // 8, w // 4)).astype(np.int32)
    qp = rng.integers(22, 45, (h // 4, w // 8)).astype(np.int32)
    _eq(deblock._luma_pass(_t(y), _t(bs_v), _t(qp)),
        jax.jit(jdeblock._luma_pass)(y, bs_v, qp))
    _eq(deblock.deblock_luma(_t(y), _t(bs_v), _t(bs_h), 37),
        jax.jit(lambda a, v, hh: jdeblock.deblock_luma(a, v, hh, 37))(
            y, bs_v, bs_h))
    c = y[::2, ::2].copy()
    cbv = rng.integers(0, 3, (h // 4, w // 16)).astype(np.int32)
    cbh = rng.integers(0, 3, (h // 16, w // 4)).astype(np.int32)
    _eq(deblock.deblock_chroma(_t(c), _t(cbv), _t(cbh), 33),
        jax.jit(lambda a, v, hh: jdeblock.deblock_chroma(a, v, hh, 33))(
            c, cbv, cbh))


# (qp, luma h x w, coded, tiles, merge_rdo): untiled with and without a
# coded size, a 4x3 tile grid of 2x2 CTUs each, no merge RDO, and four CTU
# rows whose coded height leaves a padded band in the last
@pytest.mark.parametrize("qp, h, w, coded, tiles, merge_rdo", [
    (32, 128, 192, None, None, True),
    (26, 128, 192, (120, 176), None, True),
    (30, 384, 512, None, (4, 3), True),
    (34, 128, 192, None, None, False),
    (28, 256, 192, (200, 192), None, True)])
def test_sao_frame(qp, h, w, coded, tiles, merge_rdo):
    case = (qp, h, w, coded, tiles, merge_rdo)
    rng = np.random.default_rng(qp)
    org = [np.clip(rng.normal(128, 30, s), 0, 255).astype(np.int32)
           for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    rec = [np.clip(o + rng.integers(-6, 7, o.shape)
                   + (np.arange(o.shape[1]) % 7 == 0) * 4, 0, 255)
           .astype(np.int32) for o in org]
    lam = jax.jit(lambda q: jtables.rd_lambda(q, False))(jnp.int32(qp))
    qpc = int(jtables.CHROMA_QP_TABLE[qp + 2])
    lam_c = jax.jit(lambda q: jtables.rd_lambda(q, False))(jnp.int32(qpc))
    want = jax.jit(lambda *a: jsao.sao_frame(
        *a, ctu=64, tiles=tiles, merge_rdo=merge_rdo, coded=coded))(
        *[jnp.asarray(a) for a in org + rec], lam, lam_c)
    got = sao.sao_frame(*[_t(a) for a in org + rec],
                        rdbits.rd_lambda_f32(torch.tensor(qp), False),
                        rdbits.rd_lambda_f32(torch.tensor(qpc), False),
                        ctu=64, tiles=tiles, merge_rdo=merge_rdo,
                        coded=coded)
    for g, wv in zip(got[:3], want[:3]):
        _eq(g, wv, case)
    for k in ("type", "offsets", "band_pos"):
        _eq(got[3][k], want[3][k], (case, k))
    _eq(sao.pack_sao_fields(got[3]), jsao.pack_sao_fields(want[3]), case)


def test_packing_tiers_bit_exact():
    rng = np.random.default_rng(9)
    nb, b = 60, 8
    lv = rng.integers(-20, 21, (nb, b, b))
    lv = np.where(rng.random(lv.shape) < 0.9, 0, lv)
    lv[::3] = 0                                   # empty blocks
    lv[4, 0, 0], lv[10, 2, 3], lv[31, 7, 7] = 300, -200, 128
    tiers = [(16, 2), (nb, 8)]
    got = packing.compact_blocks_i8_tiers(_t(lv), tiers)
    want = jax.jit(lambda a: jpacking.compact_blocks_i8_tiers(a, tiers))(
        jnp.asarray(lv, jnp.int32))
    for g, wv in zip(got, want):
        assert g.dtype == torch.int16
        _eq(g, wv)
    cnt, blk = packing.unpack_blocks_i8(got[1].numpy(), nb, b, nb, 8)
    assert cnt == int((lv != 0).reshape(nb, -1).any(-1).sum())
    np.testing.assert_array_equal(blk, lv.reshape(nb, -1))
