"""rd=FULL (the I frame's top-3 full-RD mode refinement) and two reference
pictures (num_ref_frames=2) in the port against the JAX package, on the
CPU, exact: the torch `Encoder` against the JAX `Encoder` on flicker
video whose blocks pick different references in one frame, with a scene
cut that restarts the GOP, and a JAX two-reference checkpoint resumed in
the port; `encode_p_frame` with a second reference and a planted QP map
against `encode_p_frame_jit`; and `encode_frame(rd_refine=True)` with
ties planted in the top-3 against the JAX frame program."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from homerhevc_torch import api as tapi
from homerhevc_torch.config import EncoderConfig, RDMode
from homerhevc_torch.entropy import binding
from homerhevc_torch.models import inter_frame as tinter
from homerhevc_torch.models import intra_frame as tintra
from homerhevc_torch.ops import kernels, rdbits
from homerhevc_torch.utils.synthetic import synthetic_video
from homerhevc_tpu import api as japi
from homerhevc_tpu import config as jconfig
from homerhevc_tpu.models import inter_frame as jinter
from homerhevc_tpu.models import intra_frame as jintra
from homerhevc_tpu.ops import pallas_kernels
from tools import de265

torch.set_num_threads(1)

W, H, M = 128, 64, 16
# 1 I frame, P frames 1-5 (frame 5 is a scene cut the encoder sees as
# mostly intra), so frame 6 restarts the GOP and frame 7 is a P frame
# with one reference; the checkpoint is taken after frame 4
N, CUT, CKPT_AFTER = 9, 5, 4
CFG = dict(width=W, height=H, qp=30, intra_period=100, deblocking=True,
           sao=True)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _content(n, mixed=False, seed=9, cut=None):
    """Flicker stream: odd frames add a noise field, so the same-parity
    frame TWO back is the far better reference.  With `mixed`, only the
    left half flickers — blocks pick different refs within one frame.
    From frame `cut` on, the luma shows another texture (a scene cut)."""
    rng = np.random.default_rng(seed)
    g = np.mgrid[0:H + M, 0:W + M]
    base = np.clip(((g[1] * 3 + g[0] * 2) % 235)
                   + rng.integers(0, 16, g[0].shape), 0, 255) \
        .astype(np.int32)
    flick = rng.integers(-25, 26, g[0].shape)
    if mixed:
        flick[:, (W + M) // 2:] = 0
    other = np.clip(((g[1] * 5 + g[0] * 7) % 200) + 30
                    + rng.integers(0, 40, g[0].shape), 0, 255)
    frames = []
    for i in range(n):
        dx, dy = 2 * i, i
        luma = other if cut is not None and i >= cut else base
        y = np.clip(luma + (i % 2) * flick, 0, 255) \
            .astype(np.uint8)[dy:dy + H, dx:dx + W]
        u = np.clip(128 + base[dy // 2:dy // 2 + H // 2,
                               dx // 2:dx // 2 + W // 2] // 4
                    + (i % 2) * 10, 0, 255).astype(np.uint8)
        v = np.clip(110 + base[dy // 2 + 4:dy // 2 + 4 + H // 2,
                               dx // 2 + 4:dx // 2 + 4 + W // 2] // 4,
                    0, 255).astype(np.uint8)
        frames.append((y, u, v))
    return frames


def _encode(enc, frames, ckpt=None):
    """Frame by frame through encode(); with `ckpt`, a checkpoint after
    frame CKPT_AFTER.  Returns the CodedFrames."""
    out = []
    for i, f in enumerate(frames):
        out.append(enc.encode(*f))
        if ckpt is not None and i == CKPT_AFTER:
            enc.save_checkpoint(str(ckpt))
    return out


def _refined_cus(out, y, qp):
    """CUs of an I frame whose luma mode is not the SATD cost's best:
    32x32 CUs (depth 1) against the dense decision at 32, 16x16 CUs
    (depth 2) against the one at 16."""
    y32 = _t(y).to(torch.int32)
    sqrt_lam = torch.sqrt(rdbits.rd_lambda_f32(torch.tensor(qp), True))
    best = {s: tintra._dense_best(y32, s, 64, sqrt_lam)[0].numpy()
            for s in (32, 16)}
    depth = out["depth"].numpy()
    modes = out["modes"].numpy()[::2, ::2]        # per 16-granule
    gy, gx = np.mgrid[0:depth.shape[0], 0:depth.shape[1]]
    n32 = (depth == 1) & (modes != best[32][gy // 2, gx // 2])
    n16 = (depth == 2) & (modes != best[16])
    return int(n32.sum()) // 4 + int(n16.sum())


def test_two_ref_rd_full_stream_matches_jax_decodes_and_resumes(tmp_path):
    frames = _content(N, mixed=True, cut=CUT)
    jckpt, tckpt = tmp_path / "jax.npz", tmp_path / "torch.npz"
    jcfg = jconfig.EncoderConfig(rd_mode=jconfig.RDMode.RD_FULL,
                                 num_ref_frames=2, **CFG)
    j = _encode(japi.Encoder(jcfg), frames, jckpt)

    cfg = EncoderConfig(rd_mode=RDMode.RD_FULL, num_ref_frames=2, **CFG)
    records, i_frames = [], []
    real_slice, real_i = binding.encode_slice, tintra.encode_frame

    def spy_slice(ccfg, rec):
        records.append(rec)
        return real_slice(ccfg, rec)

    def spy_i(y, *a, **kw):
        out = real_i(y, *a, **kw)
        i_frames.append((y.numpy(), kw["qp"], out))
        return out
    binding.encode_slice, tintra.encode_frame = spy_slice, spy_i
    try:
        t = _encode(tapi.Encoder(cfg, device="cpu"), frames, tckpt)
    finally:
        binding.encode_slice, tintra.encode_frame = real_slice, real_i

    # byte-identical Annex-B, equal reconstructions, the restart after
    # the cut, and libde265 decodes the port's stream to its recon
    assert len(t) == len(j) == N
    for k, (a, b) in enumerate(zip(t, j)):
        assert a.nalus == b.nalus, f"frame {k}: Annex-B bytes differ"
        for p, q in zip(a.recon, b.recon):
            np.testing.assert_array_equal(p, q, err_msg=f"frame {k}")
    assert [f._is_idr for f in t] == [i in (0, CUT + 1) for i in range(N)]
    dec = de265.decode(b"".join(f.nalus for f in t))
    assert len(dec) == N
    for k, (d, f) in enumerate(zip(dec, t)):
        for a, b in zip(d, f.recon):
            np.testing.assert_array_equal(a, b, err_msg=f"frame {k}")
    # blocks coded from the picture two back; the first P after each
    # IDR has one active reference and no ref_idx 1
    p_recs = [r for r in records if r.slice_type == 1]
    assert [r.num_ref_l0 for r in p_recs] == [1, 2, 2, 2, 2, 1, 2]
    assert any(r.ref_idx.any() for r in p_recs)
    assert not p_recs[0].ref_idx.any() and not p_recs[5].ref_idx.any()
    # the I frames' top-3 refinement took a mode other than the SATD best
    assert len(i_frames) == 2
    assert sum(_refined_cus(out, y, qp) for y, qp, out in i_frames) > 0

    # the second reference pays off from the third frame on
    one = _encode(tapi.Encoder(EncoderConfig(
        rd_mode=RDMode.RD_FULL, num_ref_frames=1, **CFG), device="cpu"),
        frames)
    assert sum(f.bits for f in t[2:]) < sum(f.bits for f in one[2:])

    # both checkpoints hold the two references; the JAX one resumes in
    # the port with the JAX stream's bytes
    zj, zt = np.load(jckpt), np.load(tckpt)
    assert sorted(zj.files) == sorted(zt.files) and "ref2_y" in zj.files
    for k in zj.files:
        np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
    enc = tapi.Encoder(cfg, device="cpu")
    enc.load_checkpoint(str(jckpt))
    assert all(r.dtype == torch.int32 for r in enc._ref2)
    tail = _encode(enc, frames[CKPT_AFTER + 1:])
    assert [f.nalus for f in tail] == [f.nalus for f in j[CKPT_AFTER + 1:]]


def test_two_ref_p_frame_with_planted_qp_map_matches_jax(monkeypatch):
    """128x128, one P frame: the middle reference flickers in the left
    half and the picture two back is noisy in the right half, so blocks
    take ref 1 on the left and ref 0 on the right; neighbouring CTUs at
    QPs 6-18 apart.  Equal outputs with has_ref2 False and True; the
    boundary strengths with the reference term against the reference's
    (BS 1 where only the references differ); the chroma window gather
    of 4 planes against the Pallas kernel in interpret mode."""
    monkeypatch.setattr(pallas_kernels, "_GATHER_CHUNK", 8)
    h = w = 128
    fr = synthetic_video(3, h, w, plants=2, diverge=32)
    rng = np.random.default_rng(3)
    ref2 = [np.asarray(p, np.int32) for p in fr[0]]
    ref = [np.asarray(p, np.int32) for p in fr[1]]
    cur = [np.array(p) for p in fr[2]]
    ref[0][:, :64] = np.clip(ref[0][:, :64]
                             + rng.integers(-25, 26, (h, 64)), 0, 255)
    ref2[0][:, 64:] = np.clip(ref2[0][:, 64:]
                              + rng.integers(-25, 26, (h, 64)), 0, 255)
    qmap = np.array([[26, 38], [44, 31]], np.int32)
    kw = dict(qp=32, block=16, sign_hiding=True, deblocking=True,
              sao_enabled=True, ctu=64, intra_fallback=True,
              chroma_rd_scale=1.0, chroma_qp_offset=0, me_precision=2,
              me_subpel_r=2, vis_h=h, vis_w=w, merge_rounds=2,
              fallback_rounds=2, quadtree_majority=True, inter_nxn=True,
              true_size=True)
    recs = {}
    for has in (False, True):
        want = {k: np.asarray(v) for k, v in jinter.encode_p_frame_jit(
            *cur, *ref, qp_map=qmap, ref2_y=ref2[0], ref2_u=ref2[1],
            ref2_v=ref2[2], has_ref2=jnp.bool_(has), **kw).items()}
        got = tinter.encode_p_frame(
            *(_t(p) for p in cur + ref), qp_map=_t(qmap),
            ref2_y=_t(ref2[0]), ref2_u=_t(ref2[1]), ref2_v=_t(ref2[2]),
            has_ref2=torch.tensor(has), **kw)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k],
                                          err_msg=f"{k} has_ref2={has}")
        recs[has] = want
    assert not recs[False]["ref_idx"].any()
    ri = recs[True]["ref_idx"]
    assert ri[:, :4].mean() > 0.75 and ri[:, 4:].mean() < 0.25, ri
    assert not np.array_equal(recs[False]["recon_y"], recs[True]["recon_y"])
    # boundary strengths against the reference's, on the frame's fields
    # and on still, uncoded ones, each with and without an 8x8 split map:
    # on the still fields only the reference term sets edges, BS 1
    bh, bw = ri.shape
    nxn = np.zeros((bh, bw), bool)
    nxn[1, 2] = True
    tb2 = np.zeros((bh, bw), bool)
    tb2[4:6, 0:2] = True
    fields = [(recs[True]["cbf"][0], recs[True]["mv"]),
              (np.zeros((bh, bw), np.int32), np.zeros((bh, bw, 2), np.int32))]
    for still, (cbf, mv) in enumerate(fields):
        mv8 = np.repeat(np.repeat(mv, 2, 0), 2, 1)
        cbf8 = np.repeat(np.repeat(cbf, 2, 0), 2, 1)
        for split in (False, True):
            sk = dict(mv8=mv8, nxn=nxn, cbf8=cbf8) if split else {}
            got = tinter.inter_boundary_strength(
                _t(cbf), _t(mv), 16, h, w, tb2=_t(tb2), ref=_t(ri),
                **{k: _t(v) for k, v in sk.items()})
            want = jinter.inter_boundary_strength(
                cbf, mv, 16, h, w, tb2=tb2, ref=ri, **sk)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            if still:
                bs = np.concatenate([a.numpy().ravel() for a in got])
                assert set(bs.tolist()) == {0, 1}, (split, set(bs.tolist()))
    # the 4-plane chroma gather (U0, U1, V0, V1) with per-block plane
    # indices, against the Pallas kernel
    planes = rng.integers(0, 256, (4, 136, 136)).astype(np.int32)
    pi = np.concatenate([ri.reshape(-1)[:10], 2 + ri.reshape(-1)[-9:]]) \
        .astype(np.int32)
    by = rng.integers(-2, 132, pi.size).astype(np.int32)
    bx = rng.integers(-2, 132, pi.size).astype(np.int32)
    for size in (7, 11):
        got = kernels.gather_windows_ref(_t(planes), _t(pi), _t(by), _t(bx),
                                         size).numpy()
        want = np.asarray(pallas_kernels.gather_windows_ref_pallas(
            jnp.asarray(planes), jnp.asarray(pi, jnp.int32),
            jnp.asarray(by), jnp.asarray(bx), size, interpret=True))
        np.testing.assert_array_equal(got, want, err_msg=str(size))


def test_rd_refine_intra_frame_matches_jax_with_planted_ties():
    """encode_frame at 64x64 with rd_refine (and the rd=FAST tools): flat
    blocks tie every mode's SATD, so the top-3 is decided by the mode
    bits and the index order; a smooth gradient ties pairs of angular
    modes.  The top-3 modes and mode bits at 32 and 16, and every output
    of the frame, equal the JAX ones, and some CU takes a mode other
    than the SATD best."""
    y, u, v = synthetic_video(1, 64, 64, quads=32, seed=3)[0]
    y = np.array(y)
    y[:16, :16] = 90
    y[32:48, 16:32] = 200
    y[16:32, 32:48] = 100 + np.add.outer(np.arange(16), np.arange(16))
    qp = 32
    y32 = _t(y).to(torch.int32)
    sqrt_lam = torch.sqrt(rdbits.rd_lambda_f32(torch.tensor(qp), True))
    for s in (32, 16):
        gm, gb = tintra._dense_best(y32, s, 64, sqrt_lam, topk=3)
        wm, wb = jax.jit(lambda a, lam, s=s: jintra._dense_best(
            a, s, 64, lam, topk=3))(y.astype(np.int32),
                                    np.float32(sqrt_lam.item()))
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
        np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
        assert gm.shape[0] == 3
    # the 16x16 CU's exposed cost: XLA-CPU rounds the scalar product
    # lambda * 6 before the add (no FMA), which the port reproduces
    rng = np.random.default_rng(4)
    base = rng.uniform(0, 1e5, 4096).astype(np.float32)
    for lam in rng.uniform(1, 3000, 8).astype(np.float32):
        want = jax.jit(lambda b, lm: b + lm * tintra._CU_HDR_BITS)(base, lam)
        got = _t(base) + torch.tensor(lam) * tintra._CU_HDR_BITS
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the flat 16x16 block ties: its three candidates are its MPMs in
    # mode order
    m16, _ = tintra._dense_best(y32, 16, 64, sqrt_lam, topk=3)
    assert m16[:, 0, 0].tolist() == sorted(m16[:, 0, 0].tolist())
    kw = dict(qp=qp, ctu=64, sign_hiding=True, deblocking=True,
              sao_enabled=True, search_8x8=True, search_nxn=True,
              tu_split=True, rd_refine=True, vis_h=64, vis_w=64,
              true_size=True)
    want = jintra.encode_frame_jit(y, u, v, **kw)
    got = tintra.encode_frame(_t(y), _t(u), _t(v), **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert _refined_cus(got, y, qp) > 0
