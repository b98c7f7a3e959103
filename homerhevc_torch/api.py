"""Public encoder API: YUV420 8-bit frames in, Annex-B bytes out.

Port of homerhevc_tpu/api.py.  Device compute (PyTorch, on the card by
default) produces one packed int16 record per frame; a host worker thread
pulls it (one device->host copy per chunk) and the native C++ library
entropy-codes it, overlapping the device compute of the next chunk.

Supported configuration: IPPP (intra_period > 1 or 0) and all-intra
streams (intra_period == 1: chunks of intra_frames_per_launch
independent I frames, each wavefront step running the chunk's frames
together, with tiles where cfg.tiles gives a grid) at every rd_mode
(rd=FAST, the default; rd=ULTRAFAST; rd=FULL, whose I frame refines the
top-3 intra modes by full RD), one or two reference frames; fixed QP
or CBR/VBR rate control, per-CTU QP with cu_qp_delta (under CBR/VBR or
adaptive_qp), WPP substreams, flat quantization or the default scaling
lists.

cfg.num_chips > 1 runs on the ranks of the default torch.distributed
process group (one process per device, each holding its own Encoder of
the same config and feeding it the same frames): P chunks in CTU-row
bands (n_bands, the largest divisor of the CTU-row count up to
num_chips and the world size) and all-intra chunks by frame
(n_frame_shards = num_chips where it divides the chunk and enough ranks
exist), bit-identical to one device; with fewer ranks it runs on what
there is, one device without a group.  Every rank computes the same
records and runs the same host stage, so rate control stays in lockstep
with no collective of its own; the stream's I frames run replicated.
cfg.num_hosts is accepted and not read, as in the reference: multi-host
work goes through parallel/multihost.py.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
from typing import BinaryIO, Optional

import numpy as np
import torch

from homerhevc_torch import parallel
from homerhevc_torch.config import EncoderConfig, PerfMode, RDMode
from homerhevc_torch.entropy import binding
from homerhevc_torch.models import inter_frame, intra_frame
from homerhevc_torch.ops import packing
from homerhevc_torch.ops import sao as sao_ops
from homerhevc_torch.rc import RateControl, ctu_qp_map
from homerhevc_torch.utils.profiler import stage


@dataclasses.dataclass
class CodedFrame:
    poc: int
    nalus: bytes            # Annex-B bytes (parameter sets + slice)
    bits: int
    recon: Optional[tuple] = None  # (Y, U, V) uint8, cropped
    psnr: Optional[tuple] = None


def _pad_plane(p: np.ndarray, mult: int) -> np.ndarray:
    h, w = p.shape
    ph = (h + mult - 1) // mult * mult
    pw = (w + mult - 1) // mult * mult
    if (ph, pw) == (h, w):
        return p
    return np.pad(p, ((0, ph - h), (0, pw - w)), mode="edge")


def state_from_numpy(state: dict, device) -> dict:
    """Checkpoint state (numpy arrays / scalars, the save_checkpoint
    format) -> the same dict with the reference planes as int32 tensors
    on `device`."""
    out = {}
    for k, v in state.items():
        if k.startswith(("ref_", "ref2_")):
            out[k] = torch.as_tensor(np.asarray(v, np.int32), device=device)
        else:
            out[k] = v
    return out


class Encoder:
    """HEVC encoder: YUV420 8-bit in, Annex-B out.  Runs on the CUDA
    device unless `device` says otherwise (the tests pass "cpu")."""

    def __init__(self, cfg: EncoderConfig, device=None):
        self.cfg = cfg.validate()
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Encoder: CUDA is not available; pass "
                               "device='cpu' to run on the CPU")
        self.device = dev
        self.ccfg = binding.make_cfg(cfg)
        binding.load_library()
        self._headers = binding.write_parameter_sets(self.ccfg)
        self._poc = 0
        self._gop_poc = 0
        self._ref = None
        self._ref2 = None      # the picture before _ref (list0 index 1)
        self._out: list[CodedFrame] = []
        self._pending: list = []
        self._inbuf: list = []
        self._rc = RateControl(cfg)
        self._per_ctu_qp = bool(self.ccfg.cu_qp_delta_enabled)
        self._force_idr = False
        # the I frame's tools below ULTRAFAST: the 8x8 split (with the TU
        # split at the parent's mode) and NxN 4x4 PUs with DST
        ultra = cfg.rd_mode == RDMode.RD_ULTRAFAST
        self._search_8x8 = not ultra and cfg.max_pred_depth >= 3
        self._search_nxn = not ultra and cfg.max_pred_depth >= 4
        self._tu_split = self._search_8x8 and cfg.max_intra_tr_depth >= 1
        self._rd_refine = cfg.rd_mode == RDMode.RD_FULL
        self._shard(cfg)
        self._worker = concurrent.futures.ThreadPoolExecutor(max_workers=1)

    def _shard(self, cfg):
        """The effective device counts (the reference's _p_mesh and
        _chip_mesh over the default group's ranks): n_bands, the CTU-row
        bands of an IPPP stream's P frames, and n_frame_shards, the
        frame shards of an all-intra chunk (1 where not sharded), with
        their group.  A rank outside a group of the first n ranks codes
        the whole frame or chunk itself, as those ranks together do."""
        world = parallel.world_size()
        n = cfg.num_chips
        rows = cfg.padded_height // cfg.ctu_size
        self.n_bands = self.n_frame_shards = 1
        self._p_group = self._i_group = None
        if cfg.intra_period == 1:
            k = max(cfg.intra_frames_per_launch, 1)
            if 1 < n <= world and k % n == 0:
                self.n_frame_shards = n
                group, member = parallel.first_ranks(n)
                self._i_group = group if member else None
        else:
            self.n_bands = max(d for d in range(1, min(n, rows, world) + 1)
                               if rows % d == 0)
            if self.n_bands > 1:
                group, member = parallel.first_ranks(self.n_bands)
                self._p_group = group if member else None

    def _p_knobs(self) -> dict:
        """P-frame knobs per rd_mode (the reference's speed ladder): the
        second merge round, the intra fallback's rounds, quadtree majority
        and the 8x8 inter split are off at rd=ULTRAFAST."""
        cfg = self.cfg
        ultra = cfg.rd_mode == RDMode.RD_ULTRAFAST
        return dict(
            block=16, sign_hiding=cfg.sign_hiding,
            deblocking=cfg.deblocking, sao_enabled=cfg.sao,
            wpp_substreams=cfg.wpp_substreams,
            intra_fallback=cfg.intra_in_p and not ultra,
            chroma_rd_scale=3.0 if ultra else 1.0,
            chroma_qp_offset=cfg.chroma_qp_offset,
            me_precision=cfg.motion_estimation_precision,
            me_subpel_r=3 if cfg.performance_mode == PerfMode.FULL_COMPUTATION
            else 2,
            merge_rounds=1 if ultra else 2,
            fallback_rounds=1 if ultra else 2,
            quadtree_majority=not ultra, inter_nxn=not ultra,
            scaling_lists=cfg.scaling_lists, true_size=cfg.code_true_size)

    def control(self, cfg: EncoderConfig):
        """Reconfigure mid-stream (drains in-flight work first)."""
        if getattr(self, "_worker", None) is not None:
            self.flush()
            self._worker.shutdown(wait=True)
        out = list(getattr(self, "_out", []))
        self.__init__(cfg, self.device)
        self._out = out

    def encode(self, y: np.ndarray, u: np.ndarray, v: np.ndarray,
               compute_recon: bool = True) -> CodedFrame:
        """Encode one frame, blocking until its bytes are ready."""
        pend = self._dispatch(y, u, v, compute_recon)
        frames = self._finalize(pend)
        for fr in frames:
            self._account(fr)
        return frames[0]

    def encode_async(self, y: np.ndarray, u: np.ndarray, v: np.ndarray
                     ) -> list:
        """Pipelined encode: buffers up to cfg.frames_per_launch P frames
        (all-intra: cfg.intra_frames_per_launch I frames) into one device
        chunk, entropy-coding the previous chunk on the host worker
        meanwhile.  Returns newly completed CodedFrames; drain the tail
        with flush()."""
        done = []
        if self.cfg.intra_period == 1:
            # all-intra: the frames are independent, chunk them too
            self._inbuf.append((y, u, v))
            if len(self._inbuf) >= max(self.cfg.intra_frames_per_launch, 1):
                done += self._flush_inbuf()
            done += self._drain(keep=1)
            return done
        next_poc = self._poc + len(self._inbuf)
        is_idr = (self.cfg.intra_period > 1
                  and next_poc % self.cfg.intra_period == 0) or \
            (self._ref is None and not self._pending
             and not self._inbuf) or self._force_idr
        if is_idr:
            done += self._flush_inbuf()
            self._force_idr = False
            self._pending.append(
                self._submit(self._dispatch_i(y, u, v, False)))
        else:
            self._inbuf.append((y, u, v))
            if len(self._inbuf) >= max(self.cfg.frames_per_launch, 1):
                done += self._flush_inbuf()
        done += self._drain(keep=1)
        return done

    def flush(self) -> list:
        done = self._flush_inbuf()
        done += self._drain(keep=0)
        return done

    def _submit(self, pend):
        return self._worker.submit(self._finalize, pend)

    def _drain(self, keep: int) -> list:
        """Collect finalized chunks in FIFO order, keeping up to `keep`
        in flight; RC and scene-change bookkeeping happen here, on the
        calling thread."""
        done = []
        while len(self._pending) > keep:
            frs = self._pending.pop(0).result()
            for fr in frs:
                self._account(fr)
            self._out.extend(frs)
            done += frs
        return done

    def _account(self, fr: CodedFrame):
        """Post-frame rate-control and scene-change bookkeeping."""
        is_idr = fr._is_idr
        if self._rc.enabled:
            # refresh the real state's per-picture target before the VBV
            # update (the dispatched QPs came from a projection)
            self._rc.start_pic(is_idr)
        self._rc.end_pic(fr.bits, is_idr, avg_dist=fr._dist,
                         qp=getattr(fr, "_qp", None))
        if (not is_idr and self.cfg.scene_change_reinit
                and self.cfg.intra_period != 1 and fr._intra_frac > 0.5):
            self._force_idr = True

    def _flush_inbuf(self) -> list:
        if self._inbuf:
            frames = self._inbuf
            self._inbuf = []
            dispatch = self._dispatch_i_chunk if self.cfg.intra_period == 1 \
                else self._dispatch_p_chunk
            self._pending.append(self._submit(dispatch(frames)))
        return self._drain(keep=1)

    def _dispatch(self, y, u, v, compute_recon):
        """Single-frame dispatch (synchronous encode path)."""
        cfg = self.cfg
        is_idr = cfg.intra_period == 1 or \
            (cfg.intra_period > 1 and self._poc % cfg.intra_period == 0) or \
            self._ref is None or self._force_idr
        self._force_idr = False
        if is_idr:
            return self._dispatch_i(y, u, v, compute_recon)
        return self._dispatch_p_chunk([(y, u, v)], compute_recon, k=1)

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _mark(self):
        """A CUDA event behind the work just enqueued (the worker thread
        waits on it before touching the chunk's tensors)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _i_knobs(self) -> dict:
        """The I frame's knobs (one I frame or an all-intra chunk)."""
        cfg = self.cfg
        return dict(
            ctu=cfg.ctu_size, sign_hiding=cfg.sign_hiding,
            deblocking=cfg.deblocking, sao_enabled=cfg.sao,
            search_8x8=self._search_8x8, search_nxn=self._search_nxn,
            tu_split=self._tu_split, rd_refine=self._rd_refine,
            scaling_lists=cfg.scaling_lists, tiles=cfg.tiles,
            chroma_qp_offset=cfg.chroma_qp_offset, vis_h=cfg.height,
            vis_w=cfg.width, true_size=cfg.code_true_size)

    @torch.inference_mode()
    def _dispatch_i(self, y, u, v, compute_recon=False):
        ctu = self.cfg.ctu_size
        yp = _pad_plane(np.asarray(y, np.uint8), ctu)
        up = _pad_plane(np.asarray(u, np.uint8), ctu // 2)
        vp = _pad_plane(np.asarray(v, np.uint8), ctu // 2)
        qp = self._rc.start_pic(True)
        self._gop_poc = 0
        out = intra_frame.encode_frame(
            self._to_dev(yp), self._to_dev(up), self._to_dev(vp), qp=qp,
            **self._i_knobs())
        self._ref = (out["recon_y"], out["recon_u"], out["recon_v"])
        self._ref2 = None
        pend = dict(kind="i", out=out, qp=qp, poc=self._poc,
                    gop_poc=self._gop_poc, padded=yp.shape,
                    orig=(y, u, v) if compute_recon else None,
                    event=self._mark())
        self._poc += 1
        self._gop_poc += 1
        return pend

    @torch.inference_mode()
    def _dispatch_i_chunk(self, frames):
        """An all-intra chunk: intra_frames_per_launch independent I
        frames at one QP in one encode_i_chunk call; a partial chunk is
        padded with its last frame (whose extra copies are not coded)."""
        ctu = self.cfg.ctu_size
        n_real = len(frames)
        k = max(self.cfg.intra_frames_per_launch, 1)
        frames = list(frames) + [frames[-1]] * (k - n_real)
        planes = [self._to_dev(np.stack([
            _pad_plane(np.asarray(f[i], np.uint8), ctu if i == 0 else ctu // 2)
            for f in frames])) for i in range(3)]
        qp = self._rc.start_pic(True)
        if self._i_group is not None:
            out = intra_frame.encode_i_chunk_sharded(
                *planes, qp, group=self._i_group, **self._i_knobs())
        else:
            out = intra_frame.encode_i_chunk(*planes, qp, **self._i_knobs())
        self._ref = (out["recon_y"][-1], out["recon_u"][-1],
                     out["recon_v"][-1])
        self._ref2 = None
        pend = dict(kind="i_chunk", out=out, qp=qp, poc=self._poc,
                    gop_poc=0, padded=tuple(planes[0].shape[1:]), n=n_real,
                    orig=None, event=self._mark())
        self._poc += n_real
        self._gop_poc = 1
        return pend

    @torch.inference_mode()
    def _dispatch_p_chunk(self, frames, compute_recon=False, k=None):
        cfg = self.cfg
        ctu = cfg.ctu_size
        n_real = len(frames)
        if k is None:
            k = max(cfg.frames_per_launch, 1)
        if n_real < k:
            # a partial chunk re-encodes its last frame; that duplicate's
            # reconstruction becomes the reference, so the next frame must
            # be an IDR for the stream to stay decodable
            frames = list(frames) + [frames[-1]] * (k - n_real)
            self._force_idr = True
        else:
            frames = list(frames)
        buf = np.concatenate([np.asarray(f[i], np.uint8).ravel()
                              for i in range(3) for f in frames])
        qps = self._rc.project_chunk(k)
        qp_maps = None
        if self._per_ctu_qp:
            # per-CTU QPs from each frame's activity, uploaded as one
            # tensor per chunk
            qp_maps = np.stack([
                ctu_qp_map(qps[j], _pad_plane(np.asarray(f[0], np.uint8),
                                              ctu), ctu)
                for j, f in enumerate(frames)])
        ref2_kw = {}
        if cfg.num_ref_frames >= 2:
            # list0 index 1 is the picture before self._ref; the first P
            # after an IDR has none yet (gop_poc counts pictures since the
            # IDR), and the mask keeps its blocks on ref 0
            r2 = self._ref2 if self._ref2 is not None else self._ref
            ref2_kw = dict(
                ref2_y=r2[0], ref2_u=r2[1], ref2_v=r2[2],
                has_ref2=self._to_dev(np.asarray(
                    [self._gop_poc + j >= 2 for j in range(k)])))
        out = inter_frame.encode_p_chunk_packed(
            self._to_dev(buf), *self._ref, k=k, vis_h=cfg.height,
            vis_w=cfg.width, ctu=ctu, qp=qps,
            qp_maps=None if qp_maps is None else self._to_dev(qp_maps),
            group=self._p_group, n_bands=self.n_bands, **ref2_kw,
            **self._p_knobs())
        self._ref = (out["recon_y"], out["recon_u"], out["recon_v"])
        if ref2_kw:
            self._ref2 = (out["recon2_y"], out["recon2_u"], out["recon2_v"])
        pend = dict(kind="p", out=out, qps=qps, poc=self._poc,
                    gop_poc=self._gop_poc,
                    padded=(-cfg.height % ctu + cfg.height,
                            -cfg.width % ctu + cfg.width),
                    n=n_real, qp_maps=qp_maps,
                    orig=frames[-1] if compute_recon else None,
                    event=self._mark())
        self._poc += n_real
        self._gop_poc += n_real
        return pend

    def _records(self, packed, pend):
        """Per-frame (pend, record, is_idr) triples of a pulled chunk."""
        cfg = self.cfg
        if pend["kind"] == "i":
            yield pend, self._i_record(packed, pend, cfg), True
        elif pend["kind"] == "i_chunk":
            for k in range(pend["n"]):
                pk = dict(pend, poc=pend["poc"] + k, gop_poc=0, k=k)
                yield pk, self._i_record(packed[k], pk, cfg), True
        else:
            for k in range(pend["n"]):
                pk = dict(pend, poc=pend["poc"] + k,
                          gop_poc=pend["gop_poc"] + k, k=k)
                yield pk, self._p_record(packed[k], pk, cfg), False

    @staticmethod
    def _host(t: torch.Tensor) -> np.ndarray:
        return t.cpu().numpy()

    def _finalize(self, pend) -> list:
        """Worker thread: ONE device->host pull of the chunk's packed
        records, then entropy coding."""
        out = pend["out"]
        if pend.get("event") is not None:
            pend["event"].synchronize()
        with stage("transfer"):
            packed = self._host(out["packed"])
        frames = []
        for pk, rec, is_idr in self._records(packed, pend):
            frames.append(self._emit(rec, pk, is_idr))
        if pend["orig"] is not None:
            y, u, v = pend["orig"]
            fr = frames[-1]
            fr.recon = tuple(
                self._host(out[n]).astype(np.uint8)[:p.shape[0], :p.shape[1]]
                for n, p in (("recon_y", y), ("recon_u", u),
                             ("recon_v", v)))
            fr.psnr = tuple(_psnr(a, b) for a, b in zip((y, u, v), fr.recon))
        return frames

    def _emit(self, rec, pend, is_idr: bool) -> CodedFrame:
        with stage("entropy"):
            slice_bytes = binding.encode_slice(self.ccfg, rec)
        nalus = (self._headers if is_idr else b"") + slice_bytes
        frame = CodedFrame(poc=pend["poc"], nalus=nalus,
                           bits=len(slice_bytes) * 8)
        frame._is_idr = is_idr
        frame._intra_frac = pend.get("intra_frac", 0.0)
        frame._dist = pend.get("dist")
        frame._qp = int(pend["qps"][pend["k"]]) if "qps" in pend \
            else int(pend["qp"])
        return frame

    @staticmethod
    def _unpack(packed, h, w):
        ny, nc = h * w, (h // 2) * (w // 2)
        coeff_y = packed[:ny].reshape(h, w)
        coeff_cb = packed[ny:ny + nc].reshape(h // 2, w // 2)
        coeff_cr = packed[ny + nc:ny + 2 * nc].reshape(h // 2, w // 2)
        return coeff_y, coeff_cb, coeff_cr, packed[ny + 2 * nc:]

    def _apply_sao_fields(self, rec, tail, h, w):
        """Fill the record's SAO maps from the packed tail, with
        merge-left / merge-up where the derived params coincide."""
        ctus_y, ctus_x = h // 64, w // 64
        t, off, bp = sao_ops.unpack_sao_fields(tail, ctus_y, ctus_x)
        n_real = ctus_y * ctus_x
        nctu = (h // 64 + 1) * (w // 64 + 1) * 4
        sao_type = np.zeros(nctu * 3, np.uint8)
        sao_type.reshape(-1, 3)[:n_real] = \
            t.transpose(1, 2, 0).reshape(-1, 3)
        sao_off = np.zeros(nctu * 3 * 4, np.int8)
        sao_off.reshape(-1, 3, 4)[:n_real] = \
            off.transpose(1, 2, 0, 3).reshape(-1, 3, 4)
        sao_bp = np.zeros(nctu * 3, np.uint8)
        sao_bp.reshape(-1, 3)[:n_real] = \
            bp.transpose(1, 2, 0).reshape(-1, 3)
        rec.sao_type = sao_type
        rec.sao_offset = sao_off
        rec.sao_band_pos = sao_bp
        tg = sao_type.reshape(-1, 3)[:n_real].reshape(ctus_y, ctus_x, 3)
        og = sao_off.reshape(-1, 3, 4)[:n_real] \
            .reshape(ctus_y, ctus_x, 12)
        bg = sao_bp.reshape(-1, 3)[:n_real].reshape(ctus_y, ctus_x, 3)
        allp = np.concatenate([tg, og, bg], axis=-1)
        eq_l = np.zeros((ctus_y, ctus_x), bool)
        eq_l[:, 1:] = (allp[:, 1:] == allp[:, :-1]).all(-1)
        eq_u = np.zeros((ctus_y, ctus_x), bool)
        eq_u[1:, :] = (allp[1:] == allp[:-1]).all(-1)
        # no merge across a tile boundary (spec 7.3.8.3 leftCtbInTile /
        # upCtbInTile: the writer emits no merge flag there)
        av_l, av_u = sao_ops.avail_lu_np(ctus_y, ctus_x, self.cfg.tiles)
        eq_l &= av_l
        eq_u &= av_u
        merge = np.where(eq_l, 1, np.where(eq_u, 2, 0)).astype(np.uint8)
        sao_merge = np.zeros(nctu, np.uint8)
        sao_merge[:n_real] = merge.reshape(-1)
        rec.sao_merge = sao_merge
        rec.sao_luma = True
        rec.sao_chroma = True
        return rec

    # -- checkpoint / resume: reference planes + POC counters + RC state
    def save_checkpoint(self, path: str):
        assert not self._pending and not self._inbuf, \
            "flush() before checkpointing"
        state = dict(poc=self._poc, gop_poc=self._gop_poc,
                     rc=self._rc.state_dict())
        for key, ref in (("ref", self._ref), ("ref2", self._ref2)):
            if ref is not None:
                for p, t in zip("yuv", ref):
                    state[f"{key}_{p}"] = self._host(t).astype(np.int32)
        np.savez(path, **_flatten_ckpt(state))

    def load_checkpoint(self, path: str):
        z = np.load(path)
        st = state_from_numpy({k: z[k] for k in z.files}, self.device)
        self._poc = int(st["poc"])
        self._gop_poc = int(st["gop_poc"])
        self._rc.load_state_dict(
            {k[3:]: float(st[k]) if k != "rc.num_encoded_frames"
             else int(st[k]) for k in st if k.startswith("rc.")})
        self._ref = (st["ref_y"], st["ref_u"], st["ref_v"]) \
            if "ref_y" in st else None
        self._ref2 = (st["ref2_y"], st["ref2_u"], st["ref2_v"]) \
            if "ref2_y" in st else None
        self._pending.clear()
        self._out.clear()

    def get_coded_frame(self) -> Optional[CodedFrame]:
        return self._out.pop(0) if self._out else None

    @staticmethod
    def write_annex_b_output(frame: CodedFrame, f: BinaryIO):
        f.write(frame.nalus)

    def close(self):
        self._out.clear()

    # -- packed device buffer -> host FrameRecord --
    def _i_record(self, packed, pend, cfg) -> binding.FrameRecord:
        h, w = pend["padded"]
        h4, w4 = h // 4, w // 4
        bh, bw = h // 16, w // 16
        cy, cb, cr, tail = self._unpack(packed, h, w)
        n8 = (2 * bh) * (2 * bw)
        modes8 = tail[:n8].reshape(2 * bh, 2 * bw).astype(np.uint8)
        cmodes8 = tail[n8:2 * n8].reshape(2 * bh, 2 * bw).astype(np.uint8)
        cbf8 = tail[2 * n8:5 * n8].reshape(3, 2 * bh, 2 * bw) \
            .astype(np.uint8)
        depth = tail[5 * n8:5 * n8 + bh * bw].reshape(bh, bw)
        pend["dist"] = float(tail[5 * n8 + bh * bw])
        sao_tail = tail[5 * n8 + bh * bw + 1:]
        nxn8 = np.zeros((2 * bh, 2 * bw), bool)
        if self._search_nxn:
            # NxN CUs: the 8-granule flags, then the 4-granule PU map
            # (mode | cbf << 8)
            nxn8 = sao_tail[:n8].reshape(2 * bh, 2 * bw).astype(bool)
            pu4 = sao_tail[n8:5 * n8].reshape(4 * bh, 4 * bw) \
                .astype(np.int32)
            sao_tail = sao_tail[5 * n8:]

        def rep2(m):
            return np.repeat(np.repeat(m, 2, 0), 2, 1)

        def rep4(m):
            return np.repeat(np.repeat(m, 4, 0), 4, 1)

        def quartets(a, s):
            return a[:a.shape[0] // s * s, :a.shape[1] // s * s] \
                .reshape(a.shape[0] // s, s, a.shape[1] // s, s)

        # TU-tree relabel: same-mode quartets fold into the parent CU with
        # a split transform tree (identical reconstruction, fewer bits);
        # NxN CUs never fold
        tr16 = np.zeros((bh, bw), np.uint8)
        fold_ok = cfg.max_intra_tr_depth >= 1
        m8q = quartets(modes8, 2)
        c8q = quartets(cmodes8, 2)
        same8 = (fold_ok
                 & (m8q == m8q[:, :1, :, :1]).all((1, 3))
                 & (c8q == c8q[:, :1, :, :1]).all((1, 3))
                 & ~quartets(nxn8, 2).any((1, 3))
                 & (depth == 3))
        depth = np.where(same8, 2, depth)
        tr16 = np.where(same8, 1, tr16).astype(np.uint8)
        d16q = quartets(depth, 2)
        t16q = quartets(tr16, 2)
        m16q = quartets(modes8, 4)
        c16q = quartets(cmodes8, 4)
        same16 = (fold_ok
                  & (d16q == 2).all((1, 3)) & (t16q == 0).all((1, 3))
                  & (m16q == m16q[:, :1, :, :1]).all((1, 3))
                  & (c16q == c16q[:, :1, :, :1]).all((1, 3)))
        if cfg.code_true_size:
            j32 = np.arange(same16.shape[1])
            i32 = np.arange(same16.shape[0])
            inside32 = ((32 * (j32 + 1) <= cfg.coded_width)[None, :]
                        & (32 * (i32 + 1) <= cfg.coded_height)[:, None])
            same16 = same16 & inside32
        m32 = np.zeros((bh, bw), bool)
        m32[:bh // 2 * 2, :bw // 2 * 2] = \
            np.repeat(np.repeat(same16, 2, 0), 2, 1)
        depth = np.where(m32, 1, depth)
        tr16 = np.where(m32, 1, tr16).astype(np.uint8)
        # 64x64 CUs: four same-mode 32-CUs fold into a depth-0 CU
        d32q = quartets(depth, 4)
        t32q = quartets(tr16, 4)
        m32q = quartets(modes8, 8)
        c32q = quartets(cmodes8, 8)
        same32 = ((d32q == 1).all((1, 3)) & (t32q == 0).all((1, 3))
                  & (m32q == m32q[:, :1, :, :1]).all((1, 3))
                  & (c32q == c32q[:, :1, :, :1]).all((1, 3)))
        m64 = np.zeros((bh, bw), bool)
        m64[:bh // 4 * 4, :bw // 4 * 4] = \
            np.repeat(np.repeat(same32, 4, 0), 4, 1)
        depth = np.where(m64, 0, depth)
        tr16 = np.where(m64, 0, tr16).astype(np.uint8)
        luma4 = rep2(modes8)
        cbf_y4 = rep2(cbf8[0])
        part4 = None
        if nxn8.any():
            # NxN CUs: per-4x4 PU modes and TB cbfs, part_size 1
            nxn4 = rep2(nxn8)
            luma4 = np.where(nxn4, (pu4 & 0xff).astype(np.uint8), luma4)
            cbf_y4 = np.where(nxn4, ((pu4 >> 8) & 1).astype(np.uint8),
                              cbf_y4)
            part4 = nxn4.astype(np.uint8)
        # the I frame codes one QP; with cu_qp_delta its map says so
        qpm = np.full((h4, w4), pend["qp"], np.int8) \
            if self._per_ctu_qp else None
        rec = binding.FrameRecord(
            width=w, height=h, slice_type=2, slice_qp=pend["qp"],
            poc=pend["gop_poc"], is_idr=True, qp_map=qpm,
            cu_depth=rep4(np.clip(depth, 0, 3)).astype(np.uint8),
            tr_depth=rep4(tr16), intra_luma_mode=luma4,
            intra_chroma_mode=rep2(cmodes8), part_size=part4,
            cbf_y=cbf_y4, cbf_cb=rep2(cbf8[1]),
            cbf_cr=rep2(cbf8[2]),
            coeff_y=cy, coeff_cb=cb, coeff_cr=cr,
            pred_mode=np.ones((h4, w4), np.uint8))
        if cfg.sao:
            rec = self._apply_sao_fields(rec, sao_tail, h, w)
        return rec

    def _p_record(self, packed, pend, cfg) -> binding.FrameRecord:
        h, w = pend["padded"]
        bh, bw = h // 16, w // 16
        nb = bh * bw
        mv = packed[:nb * 2].reshape(bh, bw, 2)
        o = nb * 2
        ref_idx = packed[o:o + nb].reshape(bh, bw).astype(np.uint8)
        cbf = packed[o + nb:o + 4 * nb].reshape(3, bh, bw).astype(np.uint8)
        is_intra = packed[o + 4 * nb:o + 5 * nb].reshape(bh, bw) \
            .astype(np.uint8)
        imodes = packed[o + 5 * nb:o + 6 * nb].reshape(bh, bw) \
            .astype(np.uint8)
        cu_depth = packed[o + 6 * nb:o + 7 * nb].reshape(bh, bw) \
            .astype(np.uint8)
        tr_depth = packed[o + 7 * nb:o + 8 * nb].reshape(bh, bw) \
            .astype(np.uint8)
        mvd8p = packed[o + 8 * nb:o + 12 * nb].view(np.uint16) \
            .reshape(2 * bh, 2 * bw)
        mvd8 = np.stack([(mvd8p & 0xFF).astype(np.uint8).view(np.int8),
                         (mvd8p >> 8).astype(np.uint8).view(np.int8)],
                        -1).astype(np.int16)
        cbf8_blk = packed[o + 12 * nb:o + 13 * nb].reshape(bh, bw)
        cbf8 = np.zeros((2 * bh, 2 * bw), np.uint8)
        for q, (qy, qx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
            cbf8[qy::2, qx::2] = (cbf8_blk >> (3 * q)) & 7
        pend["intra_frac"] = float(packed[o + 13 * nb]) / nb
        pend["dist"] = float(packed[o + 13 * nb + 1])
        cap_ys, cap_cs, esc_ys, esc_cs = inter_frame.p_caps_small(nb)
        off = o + 13 * nb + 2
        sz_ys = packing.compact_i8_size(cap_ys, 16, esc_ys)
        sz_cs = packing.compact_i8_size(cap_cs, 8, esc_cs)
        _, blk_y = packing.unpack_blocks_i8(packed[off:off + sz_ys],
                                            cap_ys, 16, nb, esc_ys)
        off += sz_ys
        _, blk_b = packing.unpack_blocks_i8(packed[off:off + sz_cs],
                                            cap_cs, 8, nb, esc_cs)
        off += sz_cs
        _, blk_r = packing.unpack_blocks_i8(packed[off:off + sz_cs],
                                            cap_cs, 8, nb, esc_cs)
        off += sz_cs
        sao_tail = packed[off:]
        out = pend["out"]
        if blk_y is None or blk_b is None or blk_r is None:
            # small-tier overflow: one pull of the chunk's full tier,
            # cached on the shared out dict
            cap_y, cap_c, esc_y, esc_c = inter_frame.p_caps(nb)
            if "_pf_host" not in out:
                out["_pf_host"] = self._host(out["packed_full"])
            pf = out["_pf_host"][pend["k"]]
            sz_y = packing.compact_i8_size(cap_y, 16, esc_y)
            sz_c = packing.compact_i8_size(cap_c, 8, esc_c)
            if blk_y is None:
                _, blk_y = packing.unpack_blocks_i8(pf[:sz_y], cap_y, 16, nb,
                                                    esc_y)
            if blk_b is None:
                _, blk_b = packing.unpack_blocks_i8(
                    pf[sz_y:sz_y + sz_c], cap_c, 8, nb, esc_c)
            if blk_r is None:
                _, blk_r = packing.unpack_blocks_i8(
                    pf[sz_y + sz_c:sz_y + 2 * sz_c], cap_c, 8, nb, esc_c)

        def plane(blocks, hh, ww, b):
            return np.ascontiguousarray(
                blocks.reshape(hh // b, ww // b, b, b)
                .transpose(0, 2, 1, 3).reshape(hh, ww))

        def raw(name):
            return self._host(out[name][pend["k"]])

        cy = plane(blk_y, h, w, 16) if blk_y is not None else raw("coeff_y")
        cb = plane(blk_b, h // 2, w // 2, 8) if blk_b is not None \
            else raw("coeff_cb")
        cr = plane(blk_r, h // 2, w // 2, 8) if blk_r is not None \
            else raw("coeff_cr")

        def rep(m):
            return np.repeat(np.repeat(m, 4, 0), 4, 1)

        def rep2(m):
            return np.repeat(np.repeat(m, 2, 0), 2, 1)

        imode4 = rep(imodes)
        mv8 = rep2(mv).astype(np.int16) + mvd8
        mv4 = rep2(mv8)
        split4 = rep(cu_depth == 3)
        cbf_y4 = np.where(split4, rep2(cbf8 & 1), rep(cbf[0]))
        cbf_cb4 = np.where(split4, rep2((cbf8 >> 1) & 1), rep(cbf[1]))
        cbf_cr4 = np.where(split4, rep2((cbf8 >> 2) & 1), rep(cbf[2]))
        qpm = None
        if pend.get("qp_maps") is not None:
            r = cfg.ctu_size // 4
            qpm = np.repeat(np.repeat(pend["qp_maps"][pend["k"]], r, 0),
                            r, 1).astype(np.int8)
        rec = binding.FrameRecord(
            width=w, height=h, slice_type=1,
            slice_qp=int(pend["qps"][pend["k"]]),
            poc=pend["gop_poc"], is_idr=False, num_merge_cands=2,
            cu_depth=rep(cu_depth), tr_depth=rep(tr_depth),
            pred_mode=rep(is_intra),
            intra_luma_mode=imode4, intra_chroma_mode=imode4,
            mv_x=np.ascontiguousarray(mv4[..., 1]),
            mv_y=np.ascontiguousarray(mv4[..., 0]),
            cbf_y=np.ascontiguousarray(cbf_y4.astype(np.uint8)),
            cbf_cb=np.ascontiguousarray(cbf_cb4.astype(np.uint8)),
            cbf_cr=np.ascontiguousarray(cbf_cr4.astype(np.uint8)),
            coeff_y=cy, coeff_cb=cb, coeff_cr=cr, qp_map=qpm,
            ref_idx=rep(ref_idx),
            num_ref_l0=max(1, min(cfg.num_ref_frames, pend["gop_poc"])))
        if cfg.sao:
            rec = self._apply_sao_fields(rec, sao_tail, h, w)
        return rec


def _flatten_ckpt(state: dict) -> dict:
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            for kk, vv in v.items():
                out[f"{k}.{kk}"] = vv
        else:
            out[k] = v
    return out


def _psnr(ref: np.ndarray, rec: np.ndarray) -> float:
    mse = np.mean((np.asarray(ref, np.float64)
                   - np.asarray(rec, np.float64)) ** 2)
    if mse == 0:
        return 99.0
    return 10.0 * np.log10(255.0 * 255.0 / mse)
