"""The comparison that decides `correct`, and the decoded-picture
numbers the end-to-end metrics take.

An encoder has many right answers, so the reference is the decoding
process that the standard defines: the stream the run produced is
decoded by libde265 (`de265.py`), which shares no code with the
encoder, and its headers are read by `headers.py`.  What is compared:

* decode_errors: errors and warnings the decoder raised, and frames
  sent that came out as no picture (or pictures that no frame sent);
* recon_diff_px: samples (Y, U and V) where a decoded picture differs
  from the encoder's own reconstruction of that frame, over every frame
  whose reconstruction the run kept; a kept frame with no decoded
  picture, and a frame whose reconstruction was due but not kept,
  counts all its samples;
* guarantee_breaks: pictures whose parameter sets or slice header
  break what the configuration states (size, bit depth, QP, SAO,
  deblocking, sign hiding, fixed QP, tiles, scaling lists, picture
  types, references), or whose headers cannot be read;
* worst_frame_mse_y: the largest luma mean squared error of a decoded
  picture in the window against its source frame.
"""
from __future__ import annotations

import numpy as np

from reference import headers
from reference.de265 import Decoder


def picture_breaks(pic: dict, index: int, g: dict) -> list:
    """What in one picture's headers breaks the guarantees `g`."""
    if "error" in pic:
        return [pic["error"]]
    sps, pps = pic["sps"], pic["pps"]
    want = dict(
        width=(sps["width"], g["width"]),
        height=(sps["height"], g["height"]),
        chroma_format_idc=(sps["chroma_format_idc"], 1),
        bit_depth=((sps["bit_depth_luma"], sps["bit_depth_chroma"]),
                   (g["bit_depth"], g["bit_depth"])),
        slice_qp=(pic["slice_qp"], g["slice_qp"]),
        sao=((sps["sao"], pic["sao_luma"], pic["sao_chroma"]),
             (int(g["sao"]),) * 3),
        deblocking=(int(not pic["deblocking_disabled"]),
                    int(g["deblocking"])),
        sign_hiding=(pps["sign_hiding"], int(g["sign_hiding"])),
        cu_qp_delta=(pps["cu_qp_delta"], int(g["cu_qp_delta"])),
        scaling_lists=(int(sps["scaling_lists"]), int(g["scaling_lists"])),
        tile_grid=(pps["tile_grid"], g["tile_grid"]),
        transform_skip=(pps["transform_skip"], 0),
        transquant_bypass=(pps["transquant_bypass"], 0))
    idr = index == 0 or g["idr_period"] == 1
    want["idr"] = (pic["idr"], idr)
    want["slice_type"] = (pic["slice_type"], 2 if idr else 1)
    if not idr:
        want["num_ref_idx_l0"] = (pic["num_ref_idx_l0"], g["num_ref_idx_l0"])
    return [f"{k} {got} != {exp}" for k, (got, exp) in want.items()
            if (list(got) if isinstance(got, tuple) else got)
            != (list(exp) if isinstance(exp, tuple) else exp)]


def judge(coded: list, source, recons: dict, window: range,
          guarantees: dict, due=()) -> dict:
    """coded: the Annex-B bytes of each coded frame, in coding order
    (frame i is source frame `source(i)`); recons: frame index ->
    (Y, U, V) uint8 reconstruction kept from the encoder; window: the
    frame indices of the run (a traced run's traced part, then the
    measured window); due: the frame indices whose
    reconstruction the encoder must have handed over.  Returns the
    readings and the window's luma squared error."""
    stream = b"".join(coded)
    pics = headers.pictures(stream)
    breaks = []
    for i, pic in enumerate(pics):
        why = picture_breaks(pic, i, guarantees)
        if why:
            breaks.append((i, why))
    dec = Decoder()
    n_dec = 0
    diff_px = 0
    seen = set()
    worst_mse = 0.0
    sse_y = 0
    px_y = 0
    for i, planes in enumerate(dec.decode(stream)):
        n_dec += 1
        if i in recons:
            seen.add(i)
            diff_px += sum(int(np.count_nonzero(a != b)) if a.shape == b.shape
                           else b.size for a, b in zip(planes, recons[i]))
        if i in window:
            src = source(i)[0]
            if planes[0].shape != src.shape:
                worst_mse = 255.0 ** 2          # the most there can be
                continue
            d = planes[0].astype(np.int32) - src.astype(np.int32)
            e = int(np.einsum("ij,ij->", d, d, dtype=np.int64))
            sse_y += e
            px_y += d.size
            worst_mse = max(worst_mse, e / d.size)
    for i, rec in recons.items():
        if i not in seen:
            diff_px += sum(p.size for p in rec)
    missing = [i for i in due if i not in recons]
    for i in missing:
        diff_px += sum(p.size for p in source(i))
    decoded_window = sum(1 for i in window if i < n_dec)
    return dict(
        readings=dict(
            decode_errors=len(dec.errors) + len(dec.warnings)
            + abs(len(coded) - n_dec),
            recon_diff_px=diff_px,
            guarantee_breaks=len(breaks) + abs(len(coded) - len(pics)),
            worst_frame_mse_y=worst_mse),
        sse_y=sse_y, px_y=px_y, decoded_window=decoded_window,
        compared_frames=len(recons), missing_recons=missing[:3],
        pictures=len(pics),
        first_breaks=breaks[:3], decoder_errors=dec.errors[:3],
        decoder_warnings=sorted(set(dec.warnings))[:5])
