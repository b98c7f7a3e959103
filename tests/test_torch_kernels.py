"""The port's kernel wrappers on the CPU (their plain versions) against
the JAX package: the window gathers against me._gather_windows /
me._gather_windows_ref and the Pallas kernels in interpret mode, the slab
search against me.slab_search_jnp and slab_search_pallas.  Exact.  The
wrappers' checks of their inputs, SAO's among them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homerhevc_torch.ops import kernels, sao
from homerhevc_tpu.ops import me as jme
from homerhevc_tpu.ops import pallas_kernels

torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a, np.int32))


def test_gather_windows_plain_matches_jax():
    for size, n in [(23, 70), (11, 129), (20, 65), (25, 33)]:
        rng = np.random.default_rng(size)
        hp, wp = 96, 200
        ref = rng.integers(0, 1020, (hp, wp)).astype(np.int32)
        by = rng.integers(0, hp - size, n).astype(np.int32)
        bx = rng.integers(0, wp - size, n).astype(np.int32)
        # origins past the far edge clamp back into the plane
        by[:2] = (hp - 1, hp + 40)
        bx[1:3] = (wp + 9, wp - 1)
        got = kernels.gather_windows(_t(ref), _t(by), _t(bx), size).numpy()
        want = np.asarray(jax.jit(lambda r, y, x: jme._gather_windows(
            r, y, x, size))(ref, by, bx))
        np.testing.assert_array_equal(got, want, err_msg=str((size, n)))


# Interpret mode runs the Pallas gathers op by op, and its time is set by
# the windows per grid step (_GATHER_CHUNK, 64), whatever n is: eight
# windows a step keep the same kernel body about 8x cheaper here.
_INTERPRET_CHUNK = 8


def test_gather_windows_plain_matches_pallas_clamped(monkeypatch):
    monkeypatch.setattr(pallas_kernels, "_GATHER_CHUNK", _INTERPRET_CHUNK)
    rng = np.random.default_rng(1)
    hp, wp, size, n = 96, 200, 22, 19     # three grid steps, one partial
    ref = rng.integers(0, 1020, (hp, wp)).astype(np.int32)
    by = rng.integers(0, hp - size, n).astype(np.int32)
    bx = rng.integers(0, wp - size, n).astype(np.int32)
    by[:3] = (-5, hp - 1, hp + 40)        # the TPU kernel's clamp
    bx[:3] = (wp + 9, -1, wp - 1)
    got = kernels.gather_windows(_t(ref), _t(by), _t(bx), size).numpy()
    want = np.asarray(pallas_kernels.gather_windows_pallas(
        jnp.asarray(ref), jnp.asarray(by), jnp.asarray(bx), size,
        interpret=True))
    np.testing.assert_array_equal(got, want)


def test_gather_windows_ref_plain_matches_jax(monkeypatch):
    monkeypatch.setattr(pallas_kernels, "_GATHER_CHUNK", _INTERPRET_CHUNK)
    rng = np.random.default_rng(2)
    hp, wp, size, n, r = 64, 160, 11, 33, 2
    refs = rng.integers(0, 1020, (r, hp, wp)).astype(np.int32)
    by = rng.integers(0, hp - size, n).astype(np.int32)
    bx = rng.integers(0, wp - size, n).astype(np.int32)
    ri = rng.integers(0, r, n).astype(np.int32)
    got = kernels.gather_windows_ref(_t(refs), _t(ri), _t(by), _t(bx),
                                     size).numpy()
    want = np.asarray(jax.jit(lambda p, i, y, x: jme._gather_windows_ref(
        p, i, y, x, size))(refs, ri, by, bx))
    np.testing.assert_array_equal(got, want)
    ri, by, bx = ri[:11], by[:11], bx[:11]
    ri[:2] = (-1, 5)                      # plane index clamped too
    by[2], bx[3] = hp + 3, -7
    got = kernels.gather_windows_ref(_t(refs), _t(ri), _t(by), _t(bx),
                                     size).numpy()
    want = np.asarray(pallas_kernels.gather_windows_ref_pallas(
        jnp.asarray(refs), jnp.asarray(ri), jnp.asarray(by),
        jnp.asarray(bx), size, interpret=True))
    np.testing.assert_array_equal(got, want)


def _slab_case(seed, h, w, bs, ry, rx, hi=1020, far_corners=False):
    rng = np.random.default_rng(seed)
    cur = rng.integers(0, hi, (h, w)).astype(np.int32)
    slab = rng.integers(0, hi, (h + 2 * ry, w + 2 * rx)).astype(np.int32)
    # planted exact matches at two offsets of equal |mv| penalty: the
    # first in flat order must win
    blk = cur[4:4 + bs, 8:8 + bs]
    slab[ry + 3:ry + 3 + bs, rx + 8:rx + 8 + bs] = blk
    slab[ry + 4:ry + 4 + bs, rx + 7:rx + 7 + bs] = blk
    if far_corners:
        # exact matches at flat index 0 and at the last, (2ry, 2rx), of
        # the block at (b0, b1); where bs > 2r the planted regions
        # overlap, so the block's two corners are made to agree there
        b0, b1 = (h // bs // 2) * bs, (w // bs // 2) * bs
        oy, ox = bs - 2 * ry, bs - 2 * rx
        if oy > 0 and ox > 0:
            cur[b0 + 2 * ry:b0 + bs, b1 + 2 * rx:b1 + bs] = \
                cur[b0:b0 + oy, b1:b1 + ox]
        blk = cur[b0:b0 + bs, b1:b1 + bs].copy()
        slab[b0:b0 + bs, b1:b1 + bs] = blk
        slab[b0 + 2 * ry:b0 + 2 * ry + bs, b1 + 2 * rx:b1 + 2 * rx + bs] = blk
    return cur, slab


def test_slab_search_plain_matches_jnp():
    # the last two are the encoder's two calls at 720p, the eighth-res
    # one with values up to 16,320 (sums of 64 pixels), each with the
    # far-corner tie planted
    for h, w, bs, ry, rx, hi, far in [
            (16, 32, 2, 8, 16, 1020, False), (32, 48, 8, 3, 3, 1020, False),
            (24, 40, 4, 2, 5, 1020, False), (96, 160, 2, 8, 16, 16321, True),
            (384, 640, 8, 3, 3, 1020, True)]:
        cur, slab = _slab_case(h + w, h, w, bs, ry, rx, hi, far)
        got = kernels.slab_search(_t(cur), _t(slab), bs, ry, rx).numpy()
        want = np.asarray(jax.jit(lambda c, s: jme.slab_search_jnp(
            c, s, bs, ry, rx))(cur, slab))
        np.testing.assert_array_equal(got, want,
                                      err_msg=str((h, w, bs, ry, rx)))
        if far:
            assert got[h // bs // 2, w // bs // 2] == 0


def test_slab_search_plain_matches_pallas_square():
    cur, slab = _slab_case(0, 32, 48, 4, 4, 4)
    got = kernels.slab_search(_t(cur), _t(slab), 4, 4, 4).numpy()
    want = np.asarray(pallas_kernels.slab_search_pallas(
        jnp.asarray(cur), jnp.asarray(slab), 4, 4, interpret=True))
    np.testing.assert_array_equal(got, want)


def test_wrappers_reject_bad_inputs():
    plane = torch.zeros((32, 32), dtype=torch.int32)
    idx = torch.zeros((4,), dtype=torch.int32)
    with pytest.raises(TypeError):
        kernels.gather_windows(plane.float(), idx, idx, 8)
    with pytest.raises(ValueError):
        kernels.gather_windows(plane.T, idx, idx, 8)
    with pytest.raises(ValueError):
        kernels.slab_search(plane, plane, 4, 2, 2)
    counts = kernels.launch_counts()
    kernels.gather_windows(plane, idx, idx, 8)     # CPU: plain, no launch
    assert kernels.launch_counts() == counts


def test_sao_wrapper_rejects_bad_inputs():
    def planes(h=128, w=192):
        return [torch.zeros(s, dtype=torch.int32)
                for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))] * 2
    lam = torch.tensor(10.0)
    with pytest.raises(TypeError):            # a float plane
        p = planes()
        p[3] = p[3].float()
        sao.sao_frame(*p, lam, lam)
    with pytest.raises(ValueError):           # a non-contiguous plane
        p = planes()
        p[1] = torch.zeros((96, 64), dtype=torch.int32).T
        sao.sao_frame(*p, lam, lam)
    with pytest.raises(ValueError):           # a CTU other than 64
        sao.sao_frame(*planes(), lam, lam, ctu=32)
    with pytest.raises(ValueError):           # not CTU-aligned
        sao.sao_frame(*planes(120, 176), lam, lam)
    with pytest.raises(TypeError):            # a float64 lambda
        sao.sao_frame(*planes(), lam.double(), lam)
    counts = kernels.launch_counts()
    sao.sao_frame(*planes(), lam, lam)        # CPU: plain, no launch
    assert kernels.launch_counts() == counts
    assert all(counts[k] == 0 for k in kernels.SAO_KERNELS)
