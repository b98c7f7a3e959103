"""HEVC parameter sets and slice segment headers, read by the benchmark.

Written from the syntax tables of ITU-T H.265 (7.3.1 NAL unit header,
7.3.2.2 SPS, 7.3.2.3 PPS, 7.3.6.1 slice segment header, 7.3.7
short-term reference picture set) for the Main profile with one slice
segment per picture.  Syntax that a stream of this shape does not carry
(scaling list data, VUI, PCM, long-term pictures, extensions, predicted
reference picture sets) raises `Unsupported`, and the benchmark counts
the picture as breaking its configuration.  Only the fields that the
configuration's guarantees name are kept.
"""
from __future__ import annotations

import numpy as np

IDR_TYPES = (19, 20)           # IDR_W_RADL, IDR_N_LP
VCL_MAX = 31
VPS, SPS, PPS = 32, 33, 34


class Unsupported(ValueError):
    pass


HEADER_BYTES = 1024             # a slice header lies within its first bytes


def split_nals(data: bytes) -> list:
    """Annex-B byte stream -> [(nal_unit_type, rbsp bytes)], with the
    emulation prevention bytes removed; of a slice NAL unit only the
    first HEADER_BYTES, which hold its header."""
    arr = np.frombuffer(data, np.uint8)
    z = np.flatnonzero((arr[:-2] == 0) & (arr[1:-1] == 0) & (arr[2:] == 1))
    starts = list(z + 3)
    out = []
    for k, p in enumerate(starts):
        end = starts[k + 1] - 3 if k + 1 < len(starts) else len(data)
        while end > p and data[end - 1] == 0:
            end -= 1
        nal_type = (data[p] >> 1) & 0x3F
        if nal_type <= VCL_MAX:
            end = min(end, p + 2 + HEADER_BYTES)
        out.append((nal_type, _rbsp(data[p + 2:end])))
    return out


def _rbsp(b: bytes) -> bytes:
    out = bytearray()
    zeros = 0
    for x in b:
        if zeros >= 2 and x == 3:
            zeros = 0
            continue
        out.append(x)
        zeros = zeros + 1 if x == 0 else 0
    return bytes(out)


class Bits:
    def __init__(self, data: bytes):
        self.d = data
        self.pos = 0

    def u(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.d[self.pos >> 3] if self.pos >> 3 < len(self.d) else 0
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def ue(self) -> int:
        z = 0
        while self.u(1) == 0:
            z += 1
            if z > 31:
                raise Unsupported("exp-Golomb code longer than 32 bits")
        return (1 << z) - 1 + self.u(z)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k & 1 else -(k // 2)


def _profile_tier_level(r: Bits, max_sub_layers_minus1: int):
    r.u(2 + 1 + 5 + 32 + 4 + 43 + 1 + 8)
    present = [(r.u(1), r.u(1)) for _ in range(max_sub_layers_minus1)]
    if max_sub_layers_minus1 > 0:
        r.u(2 * (8 - max_sub_layers_minus1))
    for profile, level in present:
        r.u(88 if profile else 0)
        r.u(8 if level else 0)


def _st_ref_pic_set(r: Bits, idx: int) -> int:
    """Returns the number of pictures the set keeps as references."""
    if idx != 0 and r.u(1):
        raise Unsupported("inter_ref_pic_set_prediction_flag")
    neg, pos = r.ue(), r.ue()
    used = 0
    for _ in range(neg + pos):
        r.ue()
        used += r.u(1)
    return used


def parse_sps(rbsp: bytes) -> dict:
    r = Bits(rbsp)
    r.u(4)
    msl = r.u(3)
    r.u(1)
    _profile_tier_level(r, msl)
    s = dict(sps_id=r.ue(), chroma_format_idc=r.ue())
    if s["chroma_format_idc"] == 3:
        r.u(1)
    s["coded_width"], s["coded_height"] = r.ue(), r.ue()
    win = (0, 0, 0, 0)
    if r.u(1):
        win = (r.ue(), r.ue(), r.ue(), r.ue())
    s["conf_win"] = win
    s["bit_depth_luma"] = 8 + r.ue()
    s["bit_depth_chroma"] = 8 + r.ue()
    s["log2_max_poc_lsb"] = 4 + r.ue()
    for _ in range(0 if r.u(1) else msl, msl + 1):
        r.ue(), r.ue(), r.ue()
    for _ in range(6):
        r.ue()
    if r.u(1):                                   # scaling_list_enabled_flag
        if r.u(1):
            raise Unsupported("sps_scaling_list_data")
        s["scaling_lists"] = True
    else:
        s["scaling_lists"] = False
    s["amp"] = r.u(1)
    s["sao"] = r.u(1)
    if r.u(1):
        raise Unsupported("pcm_enabled_flag")
    s["num_st_rps"] = r.ue()
    for i in range(s["num_st_rps"]):
        _st_ref_pic_set(r, i)
    if r.u(1):
        raise Unsupported("long_term_ref_pics_present_flag")
    s["temporal_mvp"] = r.u(1)
    s["strong_intra_smoothing"] = r.u(1)
    if r.u(1):
        raise Unsupported("vui_parameters_present_flag")
    if r.u(1):
        raise Unsupported("sps_extension_present_flag")
    w, h = s["coded_width"], s["coded_height"]
    s["width"] = w - 2 * (win[0] + win[1])
    s["height"] = h - 2 * (win[2] + win[3])
    return s


def parse_pps(rbsp: bytes) -> dict:
    r = Bits(rbsp)
    p = dict(pps_id=r.ue(), sps_id=r.ue())
    p["dependent_slices"] = r.u(1)
    p["output_flag_present"] = r.u(1)
    p["num_extra_slice_header_bits"] = r.u(3)
    p["sign_hiding"] = r.u(1)
    p["cabac_init_present"] = r.u(1)
    p["num_ref_idx_l0_default"] = 1 + r.ue()
    r.ue()
    p["init_qp"] = 26 + r.se()
    r.u(1)
    p["transform_skip"] = r.u(1)
    p["cu_qp_delta"] = r.u(1)
    if p["cu_qp_delta"]:
        r.ue()
    p["cb_qp_offset"], p["cr_qp_offset"] = r.se(), r.se()
    p["slice_chroma_qp_offsets_present"] = r.u(1)
    p["weighted_pred"] = r.u(1)
    r.u(1)
    p["transquant_bypass"] = r.u(1)
    p["tiles"] = r.u(1)
    p["wpp"] = r.u(1)
    p["tile_grid"] = None
    if p["tiles"]:
        cols, rows = 1 + r.ue(), 1 + r.ue()
        if not r.u(1):
            raise Unsupported("non-uniform tile spacing")
        r.u(1)
        p["tile_grid"] = [cols, rows]
    p["loop_filter_across_slices"] = r.u(1)
    p["deblocking_override_enabled"] = 0
    p["deblocking_disabled"] = 0
    if r.u(1):                          # deblocking_filter_control_present
        p["deblocking_override_enabled"] = r.u(1)
        p["deblocking_disabled"] = r.u(1)
        if not p["deblocking_disabled"]:
            r.se(), r.se()
    if r.u(1):
        raise Unsupported("pps_scaling_list_data")
    p["lists_modification_present"] = r.u(1)
    r.ue()
    p["header_extension"] = r.u(1)
    return p


def parse_slice(rbsp: bytes, nal_type: int, sps: dict, pps: dict) -> dict:
    """The slice segment header's fields (7.3.6.1) for a picture coded
    as one independent slice segment."""
    r = Bits(rbsp)
    s = dict(nal_type=nal_type, idr=nal_type in IDR_TYPES)
    if not r.u(1):
        raise Unsupported("more than one slice segment in a picture")
    if 16 <= nal_type <= 23:
        r.u(1)
    r.ue()
    r.u(pps["num_extra_slice_header_bits"])
    s["slice_type"] = r.ue()                 # 0 B, 1 P, 2 I
    if pps["output_flag_present"]:
        r.u(1)
    s["temporal_mvp"] = 0
    if not s["idr"]:
        s["poc_lsb"] = r.u(sps["log2_max_poc_lsb"])
        if r.u(1):
            if sps["num_st_rps"] > 1:
                raise Unsupported("short_term_ref_pic_set_idx")
        else:
            _st_ref_pic_set(r, sps["num_st_rps"])
        if sps["temporal_mvp"]:
            s["temporal_mvp"] = r.u(1)
    s["sao_luma"] = s["sao_chroma"] = 0
    if sps["sao"]:
        s["sao_luma"] = r.u(1)
        s["sao_chroma"] = r.u(1)
    s["num_ref_idx_l0"] = 0
    if s["slice_type"] in (0, 1):
        s["num_ref_idx_l0"] = pps["num_ref_idx_l0_default"]
        if r.u(1):
            s["num_ref_idx_l0"] = 1 + r.ue()
            if s["slice_type"] == 0:
                r.ue()
        if s["slice_type"] == 0:
            raise Unsupported("B slices")
        if pps["lists_modification_present"]:
            raise Unsupported("ref_pic_lists_modification")
        if pps["cabac_init_present"]:
            r.u(1)
        if s["temporal_mvp"]:
            raise Unsupported("collocated picture syntax")
        if pps["weighted_pred"]:
            raise Unsupported("pred_weight_table")
        s["max_merge_cand"] = 5 - r.ue()
    s["slice_qp"] = pps["init_qp"] + r.se()
    if pps["slice_chroma_qp_offsets_present"]:
        r.se(), r.se()
    s["deblocking_disabled"] = pps["deblocking_disabled"]
    if pps["deblocking_override_enabled"] and r.u(1):
        s["deblocking_disabled"] = r.u(1)
        if not s["deblocking_disabled"]:
            r.se(), r.se()
    if pps["loop_filter_across_slices"] and (
            s["sao_luma"] or s["sao_chroma"] or not s["deblocking_disabled"]):
        r.u(1)
    s["entry_points"] = 0
    if pps["tiles"] or pps["wpp"]:
        s["entry_points"] = r.ue()
        if s["entry_points"]:
            n = 1 + r.ue()
            for _ in range(s["entry_points"]):
                r.u(n)
    return s


def pictures(stream: bytes) -> list:
    """One entry per coded picture of the stream: its slice header's
    fields with the SPS and PPS in force, or {"error": text} where the
    headers cannot be read."""
    sps = pps = None
    out = []
    for nal_type, rbsp in split_nals(stream):
        try:
            if nal_type == SPS:
                sps = parse_sps(rbsp)
            elif nal_type == PPS:
                pps = parse_pps(rbsp)
            elif nal_type <= VCL_MAX and nal_type < VPS:
                if sps is None or pps is None:
                    raise Unsupported("slice before its parameter sets")
                out.append(dict(parse_slice(rbsp, nal_type, sps, pps),
                                sps=sps, pps=pps))
        except (Unsupported, IndexError) as e:
            if nal_type <= VCL_MAX:
                out.append(dict(error=f"{type(e).__name__}: {e}"))
            else:
                sps = pps = None
    return out
