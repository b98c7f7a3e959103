"""A conformant HEVC decoder for the benchmark: libde265 through ctypes.

The library is the build of libde265 1.0.11 (LGPL-3+, source at
https://github.com/strukturag/libde265; `libde265.COPYRIGHT` beside it)
kept in this directory, so that the decoder is the same wherever the
benchmark runs and no machine needs it installed.  It shares no code
with the encoder under test.  The wrapper follows tools/de265.py;
pictures come out one at a time, in output order.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

LIB_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "libde265.so.0")
_OK = 0
_IMAGE_BUFFER_FULL = 9        # DE265_ERROR_IMAGE_BUFFER_FULL
_WAITING_FOR_INPUT = 13       # DE265_ERROR_WAITING_FOR_INPUT_DATA


class DecodeError(RuntimeError):
    pass


def _load():
    lib = ctypes.CDLL(LIB_PATH)
    vp = ctypes.c_void_p
    lib.de265_new_decoder.restype = vp
    lib.de265_push_data.argtypes = [vp, ctypes.c_char_p, ctypes.c_int,
                                    ctypes.c_int64, vp]
    lib.de265_flush_data.argtypes = [vp]
    lib.de265_decode.argtypes = [vp, ctypes.POINTER(ctypes.c_int)]
    lib.de265_get_next_picture.restype = vp
    lib.de265_get_next_picture.argtypes = [vp]
    lib.de265_get_warning.argtypes = [vp]
    lib.de265_get_image_width.argtypes = [vp, ctypes.c_int]
    lib.de265_get_image_height.argtypes = [vp, ctypes.c_int]
    lib.de265_get_image_plane.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.de265_get_image_plane.argtypes = [vp, ctypes.c_int,
                                          ctypes.POINTER(ctypes.c_int)]
    lib.de265_free_decoder.argtypes = [vp]
    lib.de265_get_error_text.restype = ctypes.c_char_p
    lib.de265_get_error_text.argtypes = [ctypes.c_int]
    lib.de265_disable_logging()
    return lib


def _planes(lib, img) -> tuple:
    planes = []
    for c in range(3):
        w = lib.de265_get_image_width(img, c)
        h = lib.de265_get_image_height(img, c)
        stride = ctypes.c_int(0)
        p = lib.de265_get_image_plane(img, c, ctypes.byref(stride))
        buf = np.ctypeslib.as_array(p, shape=(h, stride.value))
        planes.append(buf[:, :w].copy())
    return tuple(planes)


class Decoder:
    """decode(stream) yields (Y, U, V) uint8 pictures, cropped to the
    conformance window; `warnings` collects the decoder's warning codes
    and `errors` its error texts (a conformant stream gives neither)."""

    def __init__(self):
        self.lib = _load()
        self.warnings: list = []
        self.errors: list = []

    def _warn(self, dec):
        while True:
            w = self.lib.de265_get_warning(dec)
            if w == _OK:
                return
            self.warnings.append(int(w))

    def decode(self, stream: bytes):
        lib = self.lib
        dec = lib.de265_new_decoder()
        if not dec:
            raise DecodeError("de265_new_decoder failed")
        try:
            err = lib.de265_push_data(dec, stream, len(stream), 0, None)
            if err != _OK:
                raise DecodeError(lib.de265_get_error_text(err).decode())
            lib.de265_flush_data(dec)
            more = ctypes.c_int(1)
            while more.value:
                err = lib.de265_decode(dec, ctypes.byref(more))
                self._warn(dec)
                if err not in (_OK, _IMAGE_BUFFER_FULL, _WAITING_FOR_INPUT):
                    self.errors.append(
                        lib.de265_get_error_text(err).decode())
                    break
                img = lib.de265_get_next_picture(dec)
                while img:
                    yield _planes(lib, img)
                    img = lib.de265_get_next_picture(dec)
        finally:
            lib.de265_free_decoder(dec)
