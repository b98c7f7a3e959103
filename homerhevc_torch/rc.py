"""Rate control: CBR / VBR with a VBV buffer model.

Host-side scalar math port of the reference's controller semantics
(ref: hmr_rate_control.c — init :30, per-pic targets :89-136, QP from
pic/vbv correctors :261-337, end-pic VBV update with I-cost
amortization :148-258, VBR drift nudging :214-238), at FRAME
granularity: the TPU pipeline encodes whole frames in one launch, so
the per-CTU running-bit feedback collapses to its start-of-frame state
(pic_corrector = 0) and QP is constant within a frame (cu_qp_delta not
signalled).  QP is a traced device argument, so changing it per frame
costs no recompilation.
"""
from __future__ import annotations

import math

from homerhevc_torch.config import BitrateMode, EncoderConfig

MAX_QP = 51.0


class RateControl:
    def __init__(self, cfg: EncoderConfig):
        self.cfg = cfg
        self.enabled = cfg.bitrate_mode != BitrateMode.FIXED_QP
        self.vbr = cfg.bitrate_mode == BitrateMode.VBR
        # VBR mode widens the buffer and floors QP (ref
        # hmr_encoder_lib.c:666-672)
        vbv_scale = 20.0 if self.vbr else 1.0
        self.qp_min = 15 if self.vbr else 1
        self.vbv_size = cfg.vbv_size * cfg.bitrate * 1000.0 * vbv_scale
        self.vbv_fullness = cfg.vbv_init * self.vbv_size
        self.average_pict_size = cfg.bitrate * 1000.0 / cfg.frame_rate
        self.acc_rate = 0.0
        self.acc_avg = 0.0
        self.target_pict_size = self.average_pict_size
        self.num_encoded_frames = 0
        self.avg_dist = 5000.0   # running distortion proxy (see end_pic)
        # Rate-quantization model: bits(qp) ~= cplx * 2^(-qp/6), one
        # complexity estimate per slice type, EWMA-updated from actual
        # (bits, qp) pairs in end_pic.  This plays the role of the
        # reference's pic/vbv correctors (hmr_rate_control.c:261-337)
        # but at frame granularity: the model picks the QP that lands
        # the target, and the VBV caps below enforce buffer bounds.
        self.cplx_i = None
        self.cplx_p = None

    # -- per picture --------------------------------------------------
    def _intra_period(self) -> int:
        ip = self.cfg.intra_period
        return 20 if ip == 0 else max(ip, 1)

    def start_pic(self, is_intra: bool) -> int:
        """Target-size bookkeeping + QP for the coming picture
        (ref hmr_rc_init_pic + hmr_rc_calc_cu_qp at consumed = 0)."""
        if not self.enabled:
            if is_intra and self.cfg.intra_period != 1:
                return int(_clip(self.cfg.qp
                                 + self.cfg.intra_qp_offset, 0, 51))
            return self.cfg.qp
        ip = self._intra_period()
        intra_avg = 2.25 * self.average_pict_size * math.sqrt(ip)
        if is_intra:
            self.target_pict_size = min(intra_avg, self.vbv_fullness)
        else:
            self.target_pict_size = \
                (self.average_pict_size * ip - intra_avg) / max(ip - 1, 1)

        cplx = self.cplx_i if is_intra else self.cplx_p
        if cplx is not None:
            # model QP that lands the per-picture target
            qp = 6.0 * math.log2(cplx / max(self.target_pict_size, 1.0))
            # VBV underflow cap: never plan to spend more than what the
            # buffer (plus this picture's channel refill) holds
            avail = 0.9 * (self.vbv_fullness + self.average_pict_size)
            if avail <= 1.0:
                qp = MAX_QP
            else:
                qp = max(qp, 6.0 * math.log2(cplx / avail))
            # VBV overflow cap: when the buffer is near full, spend at
            # least the surplus so fullness stays in bounds
            surplus = (self.vbv_fullness + self.average_pict_size
                       - 0.95 * self.vbv_size)
            if surplus > 1.0:
                qp = min(qp, 6.0 * math.log2(cplx / surplus))
        else:
            # no measurement yet: the reference's vbv_corrector law
            min_vbv = min(self.vbv_fullness, self.vbv_size * 0.95)
            vbv_corrector = 1.0 - _clip(min_vbv / self.vbv_size,
                                        0.0, 1.0)
            qp = vbv_corrector * MAX_QP
            if self.cfg.intra_period > 1 and is_intra:
                qp /= _clip(1.5 - self.avg_dist / 15000.0, 1.15, 1.5)
            if self.num_encoded_frames == 0:
                qp += 4
        if self.vbr and qp < self.qp_min:
            qp = self.qp_min
        return int(_clip(qp + 0.5, 1.0, MAX_QP))

    def predict_bits(self, qp: int, is_intra: bool) -> float:
        """Model-predicted bits for a picture at `qp` (used by the
        chunk projection; falls back to the on-target assumption when
        the model has no measurement for the slice type yet)."""
        cplx = self.cplx_i if is_intra else self.cplx_p
        if cplx is None:
            return float(self.target_pict_size)
        return cplx * 2.0 ** (-qp / 6.0)

    def project_chunk(self, k: int) -> list[int]:
        """Per-frame QPs for the next k P frames (closed-loop RC inside
        a batched chunk: the reference updates QP every picture from
        running bit counts, hmr_rate_control.c:89-136; the chunked TPU
        pipeline projects the same recurrence forward on a shadow state,
        assuming each frame lands on its target).  The REAL state is
        updated with actual bits at the FIFO drain point (end_pic), so
        projection errors self-correct with one chunk of lag — the same
        topology as the reference's inter-engine RC exchange
        (hmr_encoder_lib.c:2773-2784)."""
        if not self.enabled:
            return [self.start_pic(False)] * k
        shadow = RateControl(self.cfg)
        shadow.load_state_dict(self.state_dict())
        qps = []
        for _ in range(k):
            q = shadow.start_pic(False)
            qps.append(q)
            # advance the shadow VBV on the MODEL-predicted bits (not
            # the target): under pressure the predicted overshoot keeps
            # draining the shadow buffer, so later frames in the chunk
            # ramp QP — the within-chunk analogue of the reference's
            # per-CTU running-bits feedback
            shadow.end_pic(int(shadow.predict_bits(q, False)), False,
                           qp=q, learn=False)
        return qps

    def end_pic(self, bits: int, is_intra: bool,
                avg_dist: float | None = None,
                qp: int | None = None, learn: bool = True):
        """VBV update after a picture (ref hmr_rc_end_pic): I-frame cost
        is halved immediately and the rest amortized over the period via
        acc_rate; VBR nudges drift against the target."""
        self.num_encoded_frames += 1
        if avg_dist is not None:
            self.avg_dist = 0.75 * self.avg_dist + 0.25 * avg_dist
        if not self.enabled:
            return
        if learn and qp is not None and bits > 0:
            obs = float(bits) * 2.0 ** (qp / 6.0)
            if is_intra:
                self.cplx_i = obs if self.cplx_i is None \
                    else 0.5 * self.cplx_i + 0.5 * obs
            else:
                self.cplx_p = obs if self.cplx_p is None \
                    else 0.6 * self.cplx_p + 0.4 * obs
        consumed = float(bits)
        period = self._intra_period() if self.cfg.intra_period != 0 \
            else 100
        self.vbv_fullness += self.average_pict_size
        if is_intra and self.cfg.intra_period != 1:
            self.acc_rate += consumed / 2
            consumed /= 2
            self.acc_avg = self.acc_rate / period
            self.vbv_fullness -= consumed + self.acc_avg
            self.acc_rate -= self.acc_avg
        else:
            if self.vbr and not is_intra:
                if consumed < 0.45 * self.target_pict_size and \
                        self.vbv_fullness < 0.75 * self.vbv_size:
                    self.acc_rate += 0.005 * self.vbv_size
                    consumed -= 0.005 * self.vbv_size
                    self.acc_avg = self.acc_rate / period
                elif consumed > 1.55 * self.target_pict_size and \
                        self.vbv_fullness > 0.1 * self.vbv_size:
                    self.acc_rate -= 0.005 * self.vbv_size
                    consumed += 0.005 * self.vbv_size
                    self.acc_avg = self.acc_rate / period
            self.vbv_fullness -= consumed + self.acc_avg
            self.acc_rate -= self.acc_avg
        # clamp with over/underflow semantics (ref :241-256)
        self.vbv_fullness = _clip(self.vbv_fullness, 0.0, self.vbv_size)

    # -- checkpoint/resume (GOP-boundary state, SURVEY.md §5) ----------
    def state_dict(self) -> dict:
        # "no measurement yet" serializes as -1.0 (numeric, so the
        # checkpoint's np.savez stays pickle-free)
        return dict(vbv_fullness=self.vbv_fullness,
                    acc_rate=self.acc_rate, acc_avg=self.acc_avg,
                    num_encoded_frames=self.num_encoded_frames,
                    avg_dist=self.avg_dist,
                    cplx_i=-1.0 if self.cplx_i is None else self.cplx_i,
                    cplx_p=-1.0 if self.cplx_p is None else self.cplx_p)

    def load_state_dict(self, st: dict):
        self.vbv_fullness = st["vbv_fullness"]
        self.acc_rate = st["acc_rate"]
        self.acc_avg = st["acc_avg"]
        self.num_encoded_frames = st["num_encoded_frames"]
        self.avg_dist = st["avg_dist"]
        ci = st.get("cplx_i", -1.0)
        cp = st.get("cplx_p", -1.0)
        self.cplx_i = None if ci is None or ci < 0 else ci
        self.cplx_p = None if cp is None or cp < 0 else cp


def _clip(v, lo, hi):
    return max(lo, min(hi, v))


def ctu_qp_map(base_qp: int, y_plane, ctu: int,
               strength: float = 1.5, max_delta: int = 3):
    """Per-CTU QP map from source activity (the TPU-batched reshape of
    the reference's per-CU QP modulation, hmr_rc_calc_cu_qp
    hmr_rate_control.c:261: the serial running-bits feedback becomes a
    content-adaptive pre-pass so the whole frame still encodes in one
    launch; VBV tracking stays at frame granularity).

    y_plane: padded uint8 luma.  Returns [ctus_y, ctus_x] int32.
    """
    import numpy as np
    h, w = y_plane.shape
    ncy, ncx = h // ctu, w // ctu
    b = y_plane.reshape(ncy, ctu // 8, 8, ncx, ctu // 8, 8) \
        .astype(np.float32)
    v = b.var(axis=(2, 5)).mean(axis=(1, 3)) + 1.0     # [ncy, ncx]
    log_act = np.log2(v)
    offs = np.clip(np.round(strength * (log_act - log_act.mean())),
                   -max_delta, max_delta)
    return np.clip(base_qp + offs, 1, 51).astype(np.int32)
