"""Rate control in the port against the JAX package: the torch `Encoder`
under CBR, VBR and fixed-QP adaptive_qp (per-CTU QP with cu_qp_delta)
gives the JAX `Encoder`'s Annex-B bytes, reconstructions and rate-control
state at 176x144 (not a multiple of 64: the true-size pad band is coded),
and libde265 decodes the stream to the reconstructions; a JAX CBR
checkpoint resumes in the port; and `encode_p_frame` with a planted
per-CTU QP map equals `encode_p_frame_jit`, with WPP substreams off and
on."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homerhevc_torch import api as tapi
from homerhevc_torch import config as tconfig
from homerhevc_torch.entropy import binding
from homerhevc_torch.models import inter_frame as tinter
from homerhevc_torch.models import intra_frame as tintra
from homerhevc_torch.ops import rdbits
from homerhevc_torch.utils.synthetic import synthetic_video
from homerhevc_tpu import api as japi
from homerhevc_tpu import config as jconfig
from homerhevc_tpu import tables as jtables
from homerhevc_tpu.models import inter_frame as jinter
from tools import de265

torch.set_num_threads(1)

W, H = 176, 144
BASE = dict(width=W, height=H, qp=32, intra_period=100, frame_rate=25)
# the CBR run: the I frame; P chunk 1 (frames 1-4, the scene cut at 2);
# flush, which accounts the cut, so frame 5 restarts the GOP as an IDR;
# flush, checkpoint; P chunk 2 (frames 6-9); frame 10, a partial chunk at
# the final flush
CBR = dict(BASE, bitrate_mode="CBR", bitrate=150)
CBR_N, CUT, FLUSH_AFTER, CKPT_AT = 11, 2, (4, 5), 6
OTHERS = {"VBR": dict(BASE, bitrate_mode="VBR", bitrate=150),
          "adaptive_qp": dict(BASE, adaptive_qp=True)}


def _cfg(mod, kw):
    kw = dict(kw)
    if "bitrate_mode" in kw:
        kw["bitrate_mode"] = getattr(mod.BitrateMode, kw["bitrate_mode"])
    return mod.EncoderConfig(**kw)


def _planes(ref):
    return tuple(np.asarray(r.cpu().numpy() if isinstance(r, torch.Tensor)
                            else r).astype(np.int32) for r in ref)


def _crop(planes):
    return tuple(p[:H >> (i > 0), :W >> (i > 0)]
                 for i, p in enumerate(planes))


def _drive(enc, frames, first=0, ckpt=None, recons=None):
    """Encode frames (POCs first, first+1, ...) through encode_async,
    with flush() after the POCs in FLUSH_AFTER and at the end; with
    `ckpt`, save a checkpoint after the flush before CKPT_AT.  Returns
    dict(nalus, qps, idr per coded frame; rc, the final RC state;
    dispatches, [(poc, n real frames, full chunk or I frame, reference
    planes after it, the real frames' reconstructions from `recons`)])."""
    dispatches = []
    for name in ("_dispatch_i", "_dispatch_p_chunk"):
        real = getattr(enc, name)

        def wrapped(*a, _real=real, **kw):
            start = len(recons) if recons is not None else 0
            pend = _real(*a, **kw)
            n = pend.get("n", 1)
            full = pend["kind"] == "i" or n == enc.cfg.frames_per_launch
            ref = _planes(enc._ref)         # waits for the dispatch
            if pend["kind"] == "i" and recons is not None \
                    and len(recons) == start:
                recons.append(ref)          # JAX: I frames run no callback
            own = recons[start:start + n] if recons is not None else None
            dispatches.append((pend["poc"], n, full, ref, own))
            return pend
        setattr(enc, name, wrapped)
    out = []
    for i, f in enumerate(frames):
        out += enc.encode_async(*f)
        if first + i in FLUSH_AFTER:
            out += enc.flush()
            if ckpt is not None and first + i + 1 == CKPT_AT:
                enc.save_checkpoint(str(ckpt))
    out += enc.flush()
    return dict(nalus=[f.nalus for f in out], qps=[f._qp for f in out],
                idr=[f._is_idr for f in out], rc=enc._rc.state_dict(),
                dispatches=dispatches)


def _torch_drive(cfg, frames, load=None, first=0):
    """_drive on the torch Encoder on the CPU, with the reconstruction of
    every frame the frame programs code and every FrameRecord."""
    recons, records = [], []
    real_p, real_i = tinter.encode_p_frame, tintra.encode_frame
    real_slice = binding.encode_slice

    def keep_recon(fn):
        def call(*a, **k):
            out = fn(*a, **k)
            recons.append(_planes((out["recon_y"], out["recon_u"],
                                   out["recon_v"])))
            return out
        return call

    def spy(ccfg, rec):
        records.append(rec)
        return real_slice(ccfg, rec)
    tinter.encode_p_frame = keep_recon(real_p)
    tintra.encode_frame = keep_recon(real_i)
    binding.encode_slice = spy
    try:
        enc = tapi.Encoder(_cfg(tconfig, cfg), device="cpu")
        if load is not None:
            enc.load_checkpoint(str(load))
        res = _drive(enc, frames, first=first, recons=recons)
    finally:
        tinter.encode_p_frame, tintra.encode_frame = real_p, real_i
        binding.encode_slice = real_slice
    res["records"] = records
    return res


def _check_against_jax(t, j):
    """Bytes, slice QPs, IDR decisions, reference planes after every
    dispatch and the final RC state equal; so is every frame's
    reconstruction, where the JAX run gives them per frame.  Returns the
    torch reconstruction of every coded frame, in POC order."""
    assert len(t["nalus"]) == len(j["nalus"])
    for k, (a, b) in enumerate(zip(t["nalus"], j["nalus"])):
        assert a == b, f"frame {k}: Annex-B bytes differ"
    assert t["qps"] == j["qps"] and t["idr"] == j["idr"]
    assert t["rc"] == j["rc"]
    assert len(t["dispatches"]) == len(j["dispatches"])
    per_frame = []
    for (tp, tn, full, tref, own), (jp, jn, _, jref, jown) in zip(
            t["dispatches"], j["dispatches"]):
        assert (tp, tn) == (jp, jn)
        for a, b in zip(tref, jref):
            np.testing.assert_array_equal(a, b, err_msg=f"poc {tp}")
        assert len(own) == tn
        for k, (ta, ja) in enumerate(zip(own, jown or ())):
            for a, b in zip(ta, ja):
                np.testing.assert_array_equal(a, b, err_msg=f"poc {tp + k}")
        if full:
            # a partial chunk's reference is its padded duplicate's
            for a, b in zip(own[-1], tref):
                np.testing.assert_array_equal(a, b, err_msg=f"poc {tp}")
        per_frame += [_crop(r) for r in own]
    return per_frame


def _decode_mismatches(nalus, recons):
    """POCs whose libde265 decode differs from the encoder's
    reconstruction."""
    dec = de265.decode(b"".join(nalus))
    assert len(dec) == len(recons)
    return [i for i, (d, r) in enumerate(zip(dec, recons))
            if any(not np.array_equal(a, b) for a, b in zip(d, r))]


def _ctu_maps(rec):
    """(QP per CTU, any coded cbf per CTU) of a P FrameRecord."""
    r = 16                                      # 4x4 granules per CTU
    qp = rec.qp_map[::r, ::r].astype(np.int32)
    cbf = (rec.cbf_y | rec.cbf_cb | rec.cbf_cr).astype(bool)
    ncy, ncx = qp.shape
    return qp, cbf.reshape(ncy, r, ncx, r).any((1, 3))


# the JAX chunk program is traced once with the callback and reused, so
# its target must outlive any one run
_JAX_P_RECONS = []
_JAX_TRACED = []


def _jax_drive(kw, frames, **drive_kw):
    """_drive on the JAX Encoder, with every P frame's reconstruction
    taken out of its chunk program by a debug callback (the program is
    traced anew with it on the module's first run, then reused)."""
    real = jinter.encode_p_frame

    def with_recon(*a, **k):
        out = real(*a, **k)
        jax.debug.callback(
            lambda *p: _JAX_P_RECONS.append(_planes(p)), out["recon_y"],
            out["recon_u"], out["recon_v"])
        return out
    if not _JAX_TRACED:
        jinter.encode_p_chunk_packed_jit.clear_cache()
        _JAX_TRACED.append(True)
    _JAX_P_RECONS.clear()
    jinter.encode_p_frame = with_recon
    try:
        res = _drive(japi.Encoder(_cfg(jconfig, kw)), frames,
                     recons=_JAX_P_RECONS, **drive_kw)
    finally:
        jinter.encode_p_frame = real
    assert all(len(d[4]) == d[1] for d in res["dispatches"])
    return res


def _check_stream(t, j):
    """The torch run against the JAX run (_check_against_jax), and
    libde265 decodes the port's stream as it decodes the reference's:
    the two reconstructions disagree with the decoder on the same frames
    (the reference's own streams are not all conformant at this size:
    ROADMAP queue 3).  Returns those frames."""
    recons = _check_against_jax(t, j)
    jrec = [_crop(r) for d in j["dispatches"] for r in d[4]]
    bad = _decode_mismatches(t["nalus"], recons)
    assert bad == _decode_mismatches(j["nalus"], jrec)
    return bad


def _fill_decides(maps, slice_qps):
    """Whether, in some frame, a CTU without coded cbf takes a deblocking
    QP from the forward fill (the QP of the last CTU with cbf before it in
    raster order, or the slice QP) that differs from its own map QP."""
    for (q, c), sq in zip(maps, slice_qps):
        prev = sq
        for qi, ci in zip(q.ravel(), c.ravel()):
            if ci:
                prev = qi
            elif qi != prev:
                return True
    return False


@pytest.fixture(scope="module")
def cbr_frames():
    return synthetic_video(CBR_N, H, W, plants=4, diverge=32, scene_cut=CUT)


@pytest.fixture(scope="module")
def jax_cbr(cbr_frames, tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("cbr") / "after_chunk1.npz"
    res = _jax_drive(CBR, cbr_frames, ckpt=ckpt)
    res["ckpt"] = ckpt
    return res


def test_cbr_stream_matches_jax_decodes_and_resumes(cbr_frames, jax_cbr):
    t = _torch_drive(CBR, cbr_frames)
    # the reference's own stream decodes to its reconstruction except in
    # frames 1, 3 and 4 (up to 25 luma pixels each; ROADMAP queue 3)
    assert _check_stream(t, jax_cbr) == [1, 3, 4]
    assert t["idr"] == [True] + [False] * 4 + [True] + [False] * 5
    # the controller moved the QP, per frame and per CTU, and the
    # cbf-less-CTU forward fill decided a QP in some frame
    p_qps = [q for q, i in zip(t["qps"], t["idr"]) if not i]
    assert len(set(p_qps)) >= 2, p_qps
    p_recs = [r for r in t["records"] if r.slice_type == 1]
    maps = [_ctu_maps(r) for r in p_recs]
    assert any(len(np.unique(q)) >= 2 for q, _ in maps)
    assert _fill_decides(maps, [r.slice_qp for r in p_recs])
    # the JAX checkpoint after chunk 1 (and the IDR) resumes in the port
    r = _torch_drive(CBR, cbr_frames[CKPT_AT:], load=jax_cbr["ckpt"],
                     first=CKPT_AT)
    assert r["nalus"] == jax_cbr["nalus"][CKPT_AT:]
    assert r["rc"] == jax_cbr["rc"]
    for a, b in zip(r["dispatches"][-1][3], jax_cbr["dispatches"][-1][3]):
        np.testing.assert_array_equal(a, b)


def test_vbr_and_adaptive_qp_match_jax_and_decode():
    frames = synthetic_video(5, H, W, plants=4, diverge=32)
    for name, kw in OTHERS.items():
        j = _jax_drive(kw, frames)
        t = _torch_drive(kw, frames)
        assert _check_stream(t, j) == [], name
        assert t["idr"] == [True, False, False, False, False], name
        maps = [_ctu_maps(r)[0] for r in t["records"] if r.slice_type == 1]
        assert any(len(np.unique(q)) >= 2 for q in maps), name


def test_p_frame_with_planted_qp_map_matches_jax_with_and_without_wpp():
    """128x128, one P frame against a given reference: neighbouring CTUs
    at QPs 6-18 apart; the second CTU row starts with a CTU that codes no
    cbf (the source equals the reference there), so the deblocking QP
    chain's per-row reset under WPP decides its QP.  Also the merged
    edge-QP maps and the per-block lambdas against the reference's."""
    h = w = 128
    fr = synthetic_video(2, h, w, plants=2, diverge=32)
    ref = [np.asarray(p, np.int32) for p in fr[0]]
    cur = [np.array(p) for p in fr[1]]
    for i, s in enumerate((64, 32, 32)):
        cur[i][s:, :s] = fr[0][i][s:, :s]
    qmap = np.array([[26, 38], [44, 31]], np.int32)
    kw = dict(qp=32, block=16, sign_hiding=True, deblocking=True,
              sao_enabled=True, ctu=64, intra_fallback=True,
              chroma_rd_scale=1.0, chroma_qp_offset=0, me_precision=2,
              me_subpel_r=2, vis_h=h, vis_w=w, merge_rounds=2,
              fallback_rounds=2, quadtree_majority=True, inter_nxn=True,
              true_size=True)
    recon = {}
    for wpp in (False, True):
        want = {k: np.asarray(v) for k, v in jinter.encode_p_frame_jit(
            *cur, *ref, qp_map=qmap, wpp_substreams=wpp, **kw).items()}
        got = tinter.encode_p_frame(
            *(torch.as_tensor(p) for p in cur + ref),
            qp_map=torch.as_tensor(qmap), wpp_substreams=wpp, **kw)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k],
                                          err_msg=f"{k} wpp={wpp}")
        cbf = want["cbf"].any(0).reshape(2, 4, 2, 4).any((1, 3))
        assert cbf.tolist() == [[True, True], [False, True]], cbf
        recon[wpp] = want["recon_y"]
    assert not np.array_equal(recon[False], recon[True])
    # the merged edge-QP maps, chroma branch included, on a varied
    # 16-granule map
    rng = np.random.default_rng(5)
    g16 = np.repeat(np.repeat(qmap, 4, 0), 4, 1) \
        + rng.integers(-3, 4, (8, 8)).astype(np.int32)
    for off in (0, 3, -2):
        gt = tinter._edge_qp_maps(torch.as_tensor(g16, dtype=torch.int64),
                                  h, w, 16, off)
        wt = jinter._edge_qp_maps_chroma(g16, h, w, 16, off)
        for a, b in zip(gt, wt):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tinter._edge_qp_maps(torch.as_tensor(g16), h, w, 16),
                    jinter._edge_qp_maps(g16, h, w, 16)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # per-block lambdas: every QP of the chroma table's range, in vectors
    # of the lengths the frame programs use (XLA vectorises the power)
    for n in (1, 16, 144, 3600):
        q = np.resize(np.arange(58, dtype=np.int32), n)
        for intra in (False, True):
            want = jax.jit(lambda x, i=intra: jtables.rd_lambda(x, i)
                           .astype(jnp.float32))(q)
            got = rdbits.rd_lambda_f32(torch.as_tensor(q), intra)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
