"""The intra fallback's serial pass (fallback_serial) and the I frame's
remaining encode_frame options in the port against the JAX package, on
the CPU, exact.  The content is a pan with patches of 2 x 3 blocks of
flat new content and a strip of new content along the right edge, where
the pan enters: every block there has a candidate neighbour, so the
rounds' isolation rule takes none of them and the serial pass commits
them one by one, mutually adjacent blocks among them.

(a) the luma and chroma serial passes against the reference's
    `_intra_fallback_luma(serial=N)` and `_intra_fallback_chroma_serial`;
(b) one whole P frame against `encode_p_frame_jit(fallback_serial=16)`,
    and in two row bands on one device;
(c) a 1 I + 2 P stream of the port's Encoder with the serial pass,
    decoded by libde265;
(d) encode_frame / encode_i_chunk with the reference's keywords and
    defaults against `encode_frame_jit`."""
import inspect

import __graft_entry__
import jax
import jax.numpy as jnp
import numpy as np
import torch

from homerhevc_torch import api as tapi
from homerhevc_torch import tables
from homerhevc_torch.config import EncoderConfig
from homerhevc_torch.models import inter_frame as tinter
from homerhevc_torch.models import intra_frame as tintra
from homerhevc_torch.utils.synthetic import synthetic_video
from homerhevc_tpu.models import inter_frame as jinter
from homerhevc_tpu.models import intra_frame as jintra
from tools import de265

torch.set_num_threads(1)

VH, VW = 144, 176                  # the visible frame
H, W = 192, 192                    # padded to the 64x64 CTU
S, CS = 16, 8
BH, BW = H // S, W // S


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _pad(p, m):
    return np.pad(p, ((0, -p.shape[0] % m), (0, -p.shape[1] % m)),
                  mode="edge")


def _blocks(p, s):
    h, w = p.shape
    return p.reshape(h // s, s, w // s, s).transpose(0, 2, 1, 3) \
        .reshape(-1, s, s)


def _video(n, patches=2, **kw):
    return synthetic_video(n, VH, VW, plants=4, patches=patches, strip=16,
                           **kw)


def _adjacent_pair(sel, bw):
    """Whether two of the block indices sel are 8-neighbours."""
    rc = [(int(i) // bw, int(i) % bw) for i in sel]
    return any(max(abs(a[0] - b[0]), abs(a[1] - b[1])) == 1
               for k, a in enumerate(rc) for b in rc[k + 1:])


def _spy_serial(monkeypatch):
    """Record the committed block indices of every serial luma pass."""
    commits = []
    real = tinter._serial_luma

    def spy(*a, **k):
        out = real(*a, **k)
        sel, ok, _ = out[1]
        commits.append(sel[ok].tolist())
        return out
    monkeypatch.setattr(tinter, "_serial_luma", spy)
    return commits


def test_serial_pass_modules_match_jax():
    """Luma and chroma serial passes at 176x144 (true-size availability
    and invisible blocks) on one P frame's blocks: the inter prediction
    the previous frame panned, a reconstruction near the source.  Cases:
    N below and above the number of candidates, a non-uniform per-block
    QP, and content with no candidate at all; every output equal."""
    fr = _video(2)
    rng = np.random.default_rng(1)
    cur = _pad(fr[1][0], 64).astype(np.int32)
    pred = np.pad(_pad(fr[0][0], 64).astype(np.int32), ((0, 1), (0, 3)),
                  mode="edge")[1:, 3:]
    recon = np.clip(cur + rng.integers(-2, 3, cur.shape), 0, 255)
    cur_c = [_pad(p, 32).astype(np.int32) for p in fr[1][1:]]
    rec_c = [np.clip(p + rng.integers(-2, 3, p.shape), 0, 255)
             for p in cur_c]
    iy = np.arange(BH) * S >= VH
    ix = np.arange(BW) * S >= VW
    inv = (iy[:, None] | ix[None, :]).reshape(-1)
    scan = tuple(tables.scan_order(S, tables.SCAN_DIAG))
    scan_c = tuple(tables.scan_order(CS, tables.SCAN_DIAG))
    geom_j, geom_cj = (BW, S, VW, VH), (BW, CS, VW // 2, VH // 2)

    def ref_pass(serial):
        def f(cur_b, rec_b, pred_b, qp, qp_c, planes_c, rec_cb):
            z = jnp.zeros_like(rec_b)
            out = jinter._intra_fallback_luma(
                cur_b, rec_b, z, jnp.zeros((BH, BW), bool), pred_b, qp, S,
                BH, BW, H, W, scan, False, rounds=2, inv=jnp.asarray(inv),
                geom=geom_j, serial=serial)
            chroma = []
            for p in range(2):
                blk = rec_cb[p]
                lv, cb = jnp.zeros_like(blk), jnp.zeros((BH, BW), bool)
                for sel, slot, best in out[6]:
                    blk, lv, cb = jinter._intra_fallback_chroma(
                        blk, planes_c[p], lv, cb, sel, slot, best, out[7],
                        qp_c, CS, BH, BW, H, W, scan_c, False, geom=geom_cj)
                chroma.append(jinter._intra_fallback_chroma_serial(
                    blk, planes_c[p], lv, cb, out[8], out[7], qp_c, CS, BH,
                    BW, H, W, scan_c, False, geom=geom_cj))
            return out[:5], out[8], chroma
        return jax.jit(f)

    def port_pass(serial, cur_b, rec_b, pred_b, qp, qp_c, planes_c, rec_cb):
        z = torch.zeros_like(rec_b)
        out = tinter._intra_fallback_luma(
            cur_b, rec_b, z, torch.zeros((BH, BW), dtype=torch.bool),
            pred_b, qp, S, BH, BW, H, W, scan, 2, _t(inv), (S, VW, VH),
            False, serial)
        chroma = []
        for p in range(2):
            blk, orig = rec_cb[p], tinter._blocks(planes_c[p], CS)
            lv = torch.zeros_like(blk)
            cb = torch.zeros((BH, BW), dtype=torch.bool)
            for sel, ok, best in out[6]:
                blk, lv, cb = tinter._intra_fallback_chroma(
                    blk, orig, lv, cb, sel, ok, best, CS, BH, BW, H, W, qp_c,
                    scan_c, (CS, VW // 2, VH // 2))
            chroma.append(tinter._intra_fallback_chroma_serial(
                blk, orig, lv, cb, out[7], CS, BH, BW, H, W, qp_c, scan_c,
                (CS, VW // 2, VH // 2)))
        return out[:5], out[7], chroma

    qp_flat = np.full(BH * BW, 32, np.int32)
    qp_mixed = qp_flat.copy()
    qp_mixed[::3] = 27
    qp_mixed[1::5] = 38
    still = _pad(fr[0][0], 64).astype(np.int32)
    cases = [("N=6", 6, cur, recon, pred, qp_flat),
             ("N=64, mixed QP", 64, cur, recon, pred, qp_mixed),
             ("N=6, mixed QP", 6, cur, recon, pred, qp_mixed),
             ("no candidate", 6, still, still, still, qp_flat)]
    progs = {}
    n_cand = None
    for name, serial, c, r, p, qp in cases:
        qp_c = np.asarray(tables.CHROMA_QP_TABLE, np.int32)[qp]
        args = (_blocks(c, S), _blocks(r, S), _blocks(p, S), qp, qp_c,
                [cc if c is cur else _pad(fr[0][k + 1], 32).astype(np.int32)
                 for k, cc in enumerate(cur_c)],
                [_blocks(rc, CS) for rc in rec_c])
        if serial not in progs:
            progs[serial] = ref_pass(serial)
        want = progs[serial](*args)
        got = port_pass(serial, *(_t(a) if not isinstance(a, list) else
                                  [_t(x) for x in a] for a in args))
        for k in range(5):
            np.testing.assert_array_equal(got[0][k].numpy(),
                                          np.asarray(want[0][k]),
                                          err_msg=f"{name}: luma {k}")
        sel_s, _, best_s, ok_s = (np.asarray(a) for a in want[1])
        for g, w_ in zip(got[1], (sel_s, ok_s, best_s)):
            np.testing.assert_array_equal(g.numpy(), w_, err_msg=name)
        for p in range(2):
            for g, w_ in zip(got[2][p], want[2][p]):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w_),
                                              err_msg=f"{name}: chroma {p}")
        n_ok = int(ok_s.sum())
        if name == "no candidate":
            assert n_ok == 0
        elif serial == 6:
            assert n_ok == 6, name
        else:
            n_cand = n_ok
            assert 6 < n_ok < serial, n_ok
        if n_ok:
            assert _adjacent_pair(sel_s[ok_s], BW), (name, sel_s[ok_s])
    assert n_cand is not None


P_KW = dict(qp=32, block=16, sign_hiding=True, deblocking=True,
            sao_enabled=True, ctu=64, intra_fallback=True,
            chroma_rd_scale=1.0, chroma_qp_offset=0, me_precision=2,
            me_subpel_r=2, vis_h=VH, vis_w=VW, merge_rounds=2,
            fallback_rounds=2, quadtree_majority=True, inter_nxn=True,
            true_size=True, fallback_serial=16)


def test_p_frame_with_serial_pass_matches_jax_and_bands(monkeypatch):
    """encode_p_frame with the rd=FAST knobs and fallback_serial=16 at
    176x144: every output (packed included) equals encode_p_frame_jit's;
    two row bands on one device give the one-device outputs."""
    commits = _spy_serial(monkeypatch)
    fr = _video(2, diverge=32)
    ref = [_pad(p, 64 >> (k > 0)).astype(np.int32)
           for k, p in enumerate(fr[0])]
    cur = [_pad(p, 64 >> (k > 0)) for k, p in enumerate(fr[1])]
    want = {k: np.asarray(v) for k, v in
            jinter.encode_p_frame_jit(*cur, *ref, **P_KW).items()}
    got = tinter.encode_p_frame(*(_t(p) for p in cur + ref), **P_KW)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert len(commits) == 1 and _adjacent_pair(commits[0], BW), commits
    banded = tinter.encode_p_frame(*(_t(p) for p in cur + ref), n_bands=2,
                                   **P_KW)
    for k in want:
        np.testing.assert_array_equal(banded[k].numpy(), want[k],
                                      err_msg=f"bands: {k}")
    assert commits[1] == commits[0]


class _SerialEncoder(tapi.Encoder):
    def _p_knobs(self) -> dict:
        return dict(super()._p_knobs(), fallback_serial=16)


def test_serial_stream_decodes_to_the_recon(monkeypatch):
    """The port's Encoder with the serial pass in its P frames (1 I + 2
    P at 176x144, rd=FAST): libde265 decodes the stream to the
    encoder's reconstruction, and the serial pass committed adjacent
    blocks."""
    commits = _spy_serial(monkeypatch)
    # the new content makes half the blocks prefer intra: keep the GOP
    enc = _SerialEncoder(EncoderConfig(width=VW, height=VH, qp=32,
                                       intra_period=100,
                                       scene_change_reinit=False),
                         device="cpu")
    frames = [enc.encode(*f) for f in _video(3)]
    assert not any(f._is_idr for f in frames[1:])
    assert len(commits) == 2 and all(_adjacent_pair(c, BW) for c in commits)
    dec = de265.decode(b"".join(f.nalus for f in frames))
    assert len(dec) == 3
    for k, (got, f) in enumerate(zip(dec, frames)):
        for d, r in zip(got, f.recon):
            np.testing.assert_array_equal(d, r, err_msg=f"frame {k}")


def test_intra_frame_options_match_jax():
    """encode_frame with the reference's keywords: the JAX package's
    entry-point call (cu=16, the default search_8x8) at 128x192; split_8x8=False with
    NxN, the TU split, rd_lambda_scale and a decision plane at 64x64;
    encode_i_chunk of two frames sharing that plane.  Every output equal;
    every keyword of the reference's encode_frame is taken with its
    default."""
    ref_sig = inspect.signature(jintra.encode_frame).parameters
    for sig in (inspect.signature(tintra.encode_frame).parameters,
                inspect.signature(tintra.encode_i_chunk).parameters):
        for name, par in list(ref_sig.items())[4:]:
            assert name in sig and sig[name].default == par.default, name

    def check(got, want, what):
        assert sorted(got) == sorted(want), what
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]),
                                          err_msg=f"{what}: {k}")

    # the JAX package's entry point (__graft_entry__): 128x192, qp 32, cu 16, sign hiding
    fn, args = __graft_entry__.entry()
    kw = fn.keywords
    got = tintra.encode_frame(*(_t(a) for a in args), **kw)
    check(got, jintra.encode_frame_jit(*args, **kw), "entry()")
    assert int((got["depth"] == 3).sum()) > 0       # the 8x8 split ran

    frames = synthetic_video(2, 64, 64, quads=32, seed=5)
    dec_y = np.clip(frames[0][0].astype(np.int32) + 9, 0, 255) \
        .astype(np.uint8)
    kw = dict(qp=30, ctu=64, sign_hiding=True, deblocking=True,
              sao_enabled=True, split_8x8=False, search_nxn=True,
              tu_split=True, rd_lambda_scale=1.25)
    wants = [jintra.encode_frame_jit(*f, dec_y=dec_y, **kw) for f in frames]
    check(tintra.encode_frame(*(_t(p) for p in frames[0]), dec_y=_t(dec_y),
                              **kw), wants[0], "split_8x8=False")
    assert "nxn" in wants[0] and "pu4" in wants[0]
    chunk = tintra.encode_i_chunk(
        *(_t(np.stack([f[p] for f in frames])) for p in range(3)),
        dec_y=_t(dec_y), **kw)
    for k, want in enumerate(wants):
        check({key: t[k] for key, t in chunk.items()}, want,
              f"encode_i_chunk frame {k}")
