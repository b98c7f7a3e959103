"""ctypes binding to the native host entropy library (libhevc_host.so).

The device compute path produces a FrameRecord of dense numpy maps;
this module marshals it to the C++ CABAC/syntax writer.  Equivalent
role to the reference's entropy layer glue (ref: hmr_encoder_lib.c
slice/NALU assembly :2818-2831), as a host stage pipelined behind
device compute.
"""
from __future__ import annotations

import ctypes
import glob
import os
import subprocess
import threading
from dataclasses import dataclass, field

import numpy as np

# native/ is the shared C++ host stage: the port reads its sources and
# builds its own copy of the library into the package's (git-ignored)
# build directory, writing nothing under native/
_NATIVE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "native"))
_BUILD_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "_build"))
_LIB_PATH = os.path.join(_BUILD_DIR, "libhevc_host.so")
# flags of native/Makefile
_CXXFLAGS = ["-O2", "-fPIC", "-std=c++17", "-shared"]
_lock = threading.Lock()


class CHevcCfg(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int32) for n in (
        "width", "height", "conf_win_right", "conf_win_bottom", "ctu_size",
        "min_cu_size", "min_tu_size", "max_tu_size", "max_intra_tr_depth",
        "max_inter_tr_depth", "init_qp", "sign_hiding", "sao_enabled",
        "deblock_disabled", "num_ref_frames", "bit_depth",
        "strong_intra_smoothing", "cu_qp_delta_enabled",
        "diff_cu_qp_delta_depth", "frame_rate_num", "frame_rate_den",
        "chroma_qp_offset", "scaling_list_enabled", "wpp_enabled",
        "tile_cols", "tile_rows", "coded_width", "coded_height")]


_U8P = ctypes.POINTER(ctypes.c_uint8)
_I8P = ctypes.POINTER(ctypes.c_int8)
_I16P = ctypes.POINTER(ctypes.c_int16)


class CFrameRec(ctypes.Structure):
    _fields_ = [
        ("cu_depth", _U8P), ("pred_mode", _U8P), ("part_size", _U8P),
        ("intra_luma_mode", _U8P), ("intra_chroma_mode", _U8P),
        ("tr_depth", _U8P), ("cbf_y", _U8P), ("cbf_cb", _U8P),
        ("cbf_cr", _U8P), ("qp_map", _I8P),
        ("coeff_y", _I16P), ("coeff_cb", _I16P), ("coeff_cr", _I16P),
        ("skip_flag", _U8P), ("merge_flag", _U8P), ("merge_idx", _U8P),
        ("mv_x", _I16P), ("mv_y", _I16P), ("mvd_x", _I16P), ("mvd_y", _I16P),
        ("mvp_idx", _U8P), ("ref_idx", _U8P),
        ("sao_merge", _U8P), ("sao_type", _U8P), ("sao_offset", _I8P),
        ("sao_band_pos", _U8P),
        ("slice_type", ctypes.c_int32), ("poc", ctypes.c_int32),
        ("slice_qp", ctypes.c_int32), ("is_idr", ctypes.c_int32),
        ("num_merge_cands", ctypes.c_int32), ("sao_luma", ctypes.c_int32),
        ("sao_chroma", ctypes.c_int32), ("last_idr_poc", ctypes.c_int32),
        ("num_ref_l0", ctypes.c_int32),
    ]


def _build_native() -> None:
    """g++ the native/*.cpp sources into one shared library (written to
    a temporary name first, so a concurrent loader never sees a partial
    file)."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    srcs = sorted(glob.glob(os.path.join(_NATIVE_DIR, "*.cpp")))
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    subprocess.run(["g++", *_CXXFLAGS, "-o", tmp, *srcs], check=True,
                   capture_output=True)
    os.replace(tmp, _LIB_PATH)


def _stale() -> bool:
    if not os.path.exists(_LIB_PATH):
        return True
    t = os.path.getmtime(_LIB_PATH)
    return any(os.path.getmtime(p) > t for p in glob.glob(
        os.path.join(_NATIVE_DIR, "*.[ch]*")))


_lib = None


def load_library():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _stale():
            _build_native()
        _lib = ctypes.CDLL(_LIB_PATH)
        _lib.hevc_write_parameter_sets.restype = ctypes.c_int32
        _lib.hevc_write_parameter_sets.argtypes = [
            ctypes.POINTER(CHevcCfg), ctypes.c_char_p, ctypes.c_int32]
        _lib.hevc_encode_slice.restype = ctypes.c_int32
        _lib.hevc_encode_slice.argtypes = [
            ctypes.POINTER(CHevcCfg), ctypes.POINTER(CFrameRec),
            ctypes.c_char_p, ctypes.c_int32]
        _lib.hevc_encode_slice_stats.restype = ctypes.c_int32
        _lib.hevc_encode_slice_stats.argtypes = [
            ctypes.POINTER(CHevcCfg), ctypes.POINTER(CFrameRec),
            ctypes.c_char_p, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_double)]
    return _lib


@dataclass
class FrameRecord:
    """Dense per-4x4 decision maps + raster coefficient planes.

    All 2-D maps are [h/4, w/4] (uint8/int8/int16); coefficient planes
    are [h, w] (luma) and [h/2, w/2] (chroma) int16.
    """
    width: int
    height: int
    slice_type: int          # 2 = I, 1 = P
    slice_qp: int
    poc: int = 0
    is_idr: bool = True
    num_merge_cands: int = 2
    num_ref_l0: int = 1
    sao_luma: bool = False
    sao_chroma: bool = False
    cu_depth: np.ndarray = None
    pred_mode: np.ndarray = None
    part_size: np.ndarray = None
    intra_luma_mode: np.ndarray = None
    intra_chroma_mode: np.ndarray = None
    tr_depth: np.ndarray = None
    cbf_y: np.ndarray = None
    cbf_cb: np.ndarray = None
    cbf_cr: np.ndarray = None
    qp_map: np.ndarray = None
    coeff_y: np.ndarray = None
    coeff_cb: np.ndarray = None
    coeff_cr: np.ndarray = None
    skip_flag: np.ndarray = None
    merge_flag: np.ndarray = None
    merge_idx: np.ndarray = None
    mv_x: np.ndarray = None
    mv_y: np.ndarray = None
    mvd_x: np.ndarray = None
    mvd_y: np.ndarray = None
    mvp_idx: np.ndarray = None
    ref_idx: np.ndarray = None
    sao_merge: np.ndarray = None
    sao_type: np.ndarray = None
    sao_offset: np.ndarray = None
    sao_band_pos: np.ndarray = None
    _keepalive: list = field(default_factory=list)

    def _fill_defaults(self):
        h4, w4 = self.height // 4, self.width // 4
        def dflt(name, dtype, shape):
            if getattr(self, name) is None:
                setattr(self, name, np.zeros(shape, dtype=dtype))
        for n in ("cu_depth", "pred_mode", "part_size", "intra_luma_mode",
                  "intra_chroma_mode", "tr_depth", "cbf_y", "cbf_cb",
                  "cbf_cr", "skip_flag", "merge_flag", "merge_idx",
                  "mvp_idx", "ref_idx"):
            dflt(n, np.uint8, (h4, w4))
        dflt("qp_map", np.int8, (h4, w4))
        for n in ("mv_x", "mv_y", "mvd_x", "mvd_y"):
            dflt(n, np.int16, (h4, w4))
        dflt("coeff_y", np.int16, (self.height, self.width))
        dflt("coeff_cb", np.int16, (self.height // 2, self.width // 2))
        dflt("coeff_cr", np.int16, (self.height // 2, self.width // 2))
        nctu = (self.height // 64 + 1) * (self.width // 64 + 1) * 4
        dflt("sao_merge", np.uint8, (nctu,))
        dflt("sao_type", np.uint8, (nctu * 3,))
        dflt("sao_offset", np.int8, (nctu * 3 * 4,))
        dflt("sao_band_pos", np.uint8, (nctu * 3,))

    def to_ctypes(self) -> CFrameRec:
        self._fill_defaults()
        rec = CFrameRec()
        self._keepalive.clear()

        def ptr(name, ctype):
            arr = np.ascontiguousarray(getattr(self, name))
            self._keepalive.append(arr)
            return arr.ctypes.data_as(ctypes.POINTER(ctype))

        for n in ("cu_depth", "pred_mode", "part_size", "intra_luma_mode",
                  "intra_chroma_mode", "tr_depth", "cbf_y", "cbf_cb",
                  "cbf_cr", "skip_flag", "merge_flag", "merge_idx",
                  "mvp_idx", "ref_idx", "sao_merge", "sao_type",
                  "sao_band_pos"):
            setattr(rec, n, ptr(n, ctypes.c_uint8))
        rec.qp_map = ptr("qp_map", ctypes.c_int8)
        rec.sao_offset = ptr("sao_offset", ctypes.c_int8)
        for n in ("coeff_y", "coeff_cb", "coeff_cr", "mv_x", "mv_y",
                  "mvd_x", "mvd_y"):
            setattr(rec, n, ptr(n, ctypes.c_int16))
        rec.slice_type = self.slice_type
        rec.poc = self.poc
        rec.slice_qp = self.slice_qp
        rec.is_idr = 1 if self.is_idr else 0
        rec.num_merge_cands = self.num_merge_cands
        rec.sao_luma = 1 if self.sao_luma else 0
        rec.sao_chroma = 1 if self.sao_chroma else 0
        rec.last_idr_poc = 0
        rec.num_ref_l0 = self.num_ref_l0
        return rec


def make_cfg(cfg) -> CHevcCfg:
    """Build the C config from an EncoderConfig."""
    c = CHevcCfg()
    c.width = cfg.padded_width
    c.height = cfg.padded_height
    # coded picture dims: true (min-CU-multiple) picture coding with
    # implicit boundary splits; gated until the device side (ref
    # repad, boundary availability/deblock/SAO masks) lands
    if getattr(cfg, "code_true_size", False):
        c.coded_width = cfg.coded_width
        c.coded_height = cfg.coded_height
    else:
        c.coded_width = cfg.padded_width
        c.coded_height = cfg.padded_height
    c.conf_win_right = (c.coded_width - cfg.width) // 2
    c.conf_win_bottom = (c.coded_height - cfg.height) // 2
    c.ctu_size = cfg.ctu_size
    c.min_cu_size = 8
    c.min_tu_size = 4
    c.max_tu_size = 32
    c.max_intra_tr_depth = cfg.max_intra_tr_depth
    c.max_inter_tr_depth = cfg.max_inter_tr_depth
    c.init_qp = cfg.qp
    c.sign_hiding = 1 if cfg.sign_hiding else 0
    c.sao_enabled = 1 if cfg.sao else 0
    c.deblock_disabled = 0 if cfg.deblocking else 1
    c.num_ref_frames = cfg.num_ref_frames
    c.bit_depth = cfg.bit_depth
    # bilinear 32x32 reference smoothing, like the reference encoder
    # (hmr_encoder_lib.c:1289); the device path applies it (ops/intra)
    c.strong_intra_smoothing = 1
    from homerhevc_torch.config import BitrateMode
    c.cu_qp_delta_enabled = 1 if (
        getattr(cfg, "adaptive_qp", False)
        or cfg.bitrate_mode != BitrateMode.FIXED_QP) else 0
    c.diff_cu_qp_delta_depth = 0
    c.frame_rate_num = int(cfg.frame_rate * 1000)
    c.frame_rate_den = 1000
    c.chroma_qp_offset = cfg.chroma_qp_offset
    c.scaling_list_enabled = 1 if getattr(cfg, "scaling_lists", False) \
        else 0
    c.wpp_enabled = 1 if getattr(cfg, "wpp_substreams", False) else 0
    tiles = getattr(cfg, "tiles", None)
    c.tile_cols, c.tile_rows = tiles if tiles else (1, 1)
    if tiles:
        c.wpp_enabled = 0    # Main profile: one of tiles/WPP
    return c


def write_parameter_sets(ccfg: CHevcCfg) -> bytes:
    lib = load_library()
    buf = ctypes.create_string_buffer(1 << 16)
    n = lib.hevc_write_parameter_sets(ctypes.byref(ccfg), buf, len(buf))
    assert n > 0
    return buf.raw[:n]


def encode_slice(ccfg: CHevcCfg, record: FrameRecord) -> bytes:
    lib = load_library()
    cap = record.width * record.height * 4 + (1 << 16)
    buf = ctypes.create_string_buffer(cap)
    rec = record.to_ctypes()
    n = lib.hevc_encode_slice(ctypes.byref(ccfg), ctypes.byref(rec), buf, cap)
    assert n > 0, "slice buffer overflow"
    return buf.raw[:n]


def encode_slice_stats(ccfg: CHevcCfg, record: FrameRecord):
    """encode_slice + the live-context fractional CABAC bits spent in
    residual_coding() (the honest calibration target for ops/rdbits)."""
    lib = load_library()
    cap = record.width * record.height * 4 + (1 << 16)
    buf = ctypes.create_string_buffer(cap)
    rec = record.to_ctypes()
    rb = (ctypes.c_double * 4)()
    n = lib.hevc_encode_slice_stats(ctypes.byref(ccfg), ctypes.byref(rec),
                                    buf, cap, rb)
    assert n > 0, "slice buffer overflow"
    return buf.raw[:n], (float(rb[0]), float(rb[1]), float(rb[2]),
                         float(rb[3]))
