"""Per-frame stats records (what the console app's `-stats` writes) and
PSNR helpers, in numpy only.

Port of homerhevc_tpu/metrics.py: the same FrameStats fields and the same
JSONL line, keys and rounding included.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np


@dataclasses.dataclass
class FrameStats:
    poc: int
    bits: int
    psnr: Optional[tuple] = None        # (Y, U, V) dB
    qp: Optional[int] = None
    vbv_fullness: Optional[float] = None
    slice_type: Optional[str] = None

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        if d["psnr"] is not None:
            d["psnr"] = [round(float(x), 4) for x in d["psnr"]]
        return json.dumps(d)


class StatsSink:
    """JSONL per-frame stats writer."""

    def __init__(self, path: str):
        self._f = open(path, "w")

    def write(self, st: FrameStats):
        self._f.write(st.to_json() + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


def psnr(ref: np.ndarray, rec: np.ndarray, peak: float = 255.0) -> float:
    """PSNR in dB; 99.0 for identical planes."""
    mse = np.mean((np.asarray(ref, np.float64)
                   - np.asarray(rec, np.float64)) ** 2)
    if mse == 0:
        return 99.0
    return 10.0 * np.log10(peak * peak / mse)


def psnr_yuv(ref_planes, rec_planes):
    return tuple(psnr(a, b) for a, b in zip(ref_planes, rec_planes))
