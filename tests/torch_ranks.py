"""Ranks of the port's multi-device tests (tests/test_torch_parallel.py):
each child process joins a gloo process group on the CPU and runs one
case, and each rank pickles what it got.

    python -m tests.torch_ranks CASE RANK WORLD PORT OUTDIR

It imports neither JAX nor the JAX package, so a rank starts quickly.
"""
import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

from homerhevc_torch import api as tapi
from homerhevc_torch import cli as tcli
from homerhevc_torch.config import BitrateMode, EncoderConfig
from homerhevc_torch.models import inter_frame, intra_frame
from homerhevc_torch.parallel import gop, multihost, wpp
from homerhevc_torch.utils.synthetic import synthetic_video

W, H = 176, 144
# tests/test_torch_rate_control.py holds this stream to the JAX Encoder's
ADAPTIVE = dict(width=W, height=H, qp=32, intra_period=100, frame_rate=25,
                adaptive_qp=True)
# tests/test_torch_all_intra.py holds this stream to the JAX Encoder's
# (its first chunk of four frames here: the frames are independent)
ALL_INTRA = dict(width=W, height=H, qp=32, intra_period=1,
                 intra_frames_per_launch=4, tile_cols=2, tile_rows=2,
                 scaling_lists=True)
# the reference's test_num_chips_ippp_feature_matrix cases in one: CBR,
# two references and WPP substreams at rd=FAST with the intra fallback
FEATURES = dict(width=128, height=120, qp=31, intra_period=100,
                frames_per_launch=2, bitrate_mode=BitrateMode.CBR,
                bitrate=150, frame_rate=25, num_ref_frames=2,
                wpp_substreams=True)
TILES3 = dict(width=W, height=H, qp=33, intra_period=1,
              intra_frames_per_launch=3, tile_cols=2, tile_rows=2)


def all_intra_video():
    """tests/test_torch_all_intra.py's six frames."""
    frames = synthetic_video(6, H, W, quads=32)
    y = np.full((H, W), 100, np.uint8)
    y[::7, ::5] = 110
    frames[3] = (y, np.full((H // 2, W // 2), 120, np.uint8),
                 np.full((H // 2, W // 2), 130, np.uint8))
    return frames


def encoder_cases():
    """(name, config, frames, num_chips) of the Encoder case."""
    return [
        ("adaptive_qp 176x144", ADAPTIVE,
         synthetic_video(5, H, W, plants=4, diverge=32), 3),
        ("features 128x120", FEATURES,
         synthetic_video(5, 120, 128, plants=4, diverge=32, flicker=20), 2),
        ("all-intra 176x144", ALL_INTRA, all_intra_video()[:4], 2),
        ("all-intra tiles, k=3", TILES3, synthetic_video(3, H, W, quads=32),
         3),
    ]


def run_encoder(kw, frames, num_chips):
    """Frames through encode_async/flush.  Returns (per-frame Annex-B,
    every dispatched chunk's reconstruction planes, effective counts)."""
    enc = tapi.Encoder(EncoderConfig(num_chips=num_chips, **kw),
                       device="cpu")
    recons = []
    for name in ("_dispatch_p_chunk", "_dispatch_i_chunk", "_dispatch_i"):
        real = getattr(enc, name)

        def spy(*a, _real=real, **k):
            pend = _real(*a, **k)
            recons.append([pend["out"][p].numpy().copy()
                           for p in ("recon_y", "recon_u", "recon_v")])
            return pend
        setattr(enc, name, spy)
    out = []
    for f in frames:
        out += enc.encode_async(*f)
    out += enc.flush()
    return [f.nalus for f in out], recons, (enc.n_bands, enc.n_frame_shards)


def case_encoder(rank, world, outdir):
    res = [run_encoder(kw, frames, n)
           for _, kw, frames, n in encoder_cases()]
    _dump(outdir, rank, res)


def _pad(p, m):
    return np.pad(p, ((0, -p.shape[0] % m), (0, -p.shape[1] % m)),
                  mode="edge")


def module_inputs():
    """Inputs of the parallel modules' case: 4 all-intra 64x64 frames, 2
    closed GOPs of 3 frames at 128x64, and one 128x128 P frame."""
    v = synthetic_video(4, 64, 64, quads=32)
    ys, us, vs = (torch.as_tensor(np.stack([f[i] for f in v]))
                  for i in range(3))
    g = [synthetic_video(3, 64, 128, seed=s, plants=2) for s in (3, 4)]
    gy, gu, gv = (torch.as_tensor(np.stack([np.stack([f[i] for f in x])
                                            for x in g])) for i in range(3))
    p = synthetic_video(2, 120, 128, plants=4, diverge=32)
    ref = [torch.as_tensor(_pad(a, m).astype(np.int32))
           for a, m in zip(p[0], (64, 32, 32))]
    cur = [torch.as_tensor(_pad(a, m)) for a, m in zip(p[1], (64, 32, 32))]
    return (ys, us, vs), (gy, gu, gv), (cur, ref)


IPPP_KW = dict(sign_hiding=True, deblocking=True, sao_enabled=True,
               intra_fallback=True)
WPP_KW = dict(intra_fallback=True, inter_nxn=True, vis_h=120, vis_w=128)


def case_modules(rank, world, outdir):
    (ys, us, vs), (gy, gu, gv), (cur, ref) = module_inputs()
    numpy = lambda d: {k: t.numpy() for k, t in d.items()}    # noqa: E731
    recs, avg = gop.encode_gop(ys, us, vs, qp=30)
    res = dict(gop=(numpy(recs), float(avg)))
    recs, avg = gop.encode_ippp_gops(gy, gu, gv, qp=30, **IPPP_KW)
    res["ippp"] = (numpy(recs), float(avg))
    mine = slice(rank, rank + 1)
    res["multihost"] = multihost.encode_ippp_multihost(
        gy[mine], gu[mine], gv[mine], qp=30, **IPPP_KW)
    res["wpp"] = numpy(wpp.encode_p_frame_rowsharded(*cur, *ref, qp=30,
                                                     **WPP_KW))
    _dump(outdir, rank, res)


def module_references():
    """The parallel modules' results on one device (no process group)."""
    (ys, us, vs), (gy, gu, gv), (cur, ref) = module_inputs()
    numpy = lambda d: {k: t.numpy() for k, t in d.items()}    # noqa: E731
    out = intra_frame.encode_i_chunk(ys, us, vs, 30, sign_hiding=True,
                                     search_8x8=True)
    d = int(((out["recon_y"] - ys.to(torch.int32)) ** 2).sum())
    res = dict(gop=(numpy(out), d, len(ys)))
    recs, total = gop._ippp_local(gy, gu, gv, qp=30, **IPPP_KW)
    res["ippp"] = (numpy(recs), int(total), len(gy))
    full = inter_frame.encode_p_frame(*cur, *ref, qp=30, block=16,
                                      sign_hiding=True, deblocking=True,
                                      sao_enabled=True, **WPP_KW)
    res["wpp"] = numpy({k: full[k] for k in (
        "recon_y", "recon_u", "recon_v", "mv", "packed", "packed_full",
        "coeff_y", "coeff_cb", "coeff_cr")})
    return res


def write_yuv(path, frames):
    with open(path, "wb") as f:
        for fr in frames:
            for p in fr:
                f.write(np.ascontiguousarray(p).tobytes())


def cli_argv(d, name, num_chips):
    return ["-i", os.path.join(d, "in.yuv"), "-o", os.path.join(d, name),
            "-widthxheight", "128x120", "-qp", "31", "-rd", "2",
            "-n_frames", "3", "-num_chips", str(num_chips)]


def case_cli(rank, world, outdir):
    """The console app as torchrun starts it: the group from the
    environment, every rank encoding, rank 0 writing."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world))
    code = tcli.main(cli_argv(outdir, "two.265", 2), device="cpu")
    _dump(outdir, rank, (code, dist.is_initialized()))


def _dump(outdir, rank, obj):
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(obj, f)


def main(case, rank, world, port, outdir):
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    if case != "cli":
        multihost.init_distributed(f"127.0.0.1:{port}", world, rank)
    try:
        globals()[f"case_{case}"](rank, world, outdir)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
         sys.argv[5])
