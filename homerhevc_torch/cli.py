"""Console encoder app, the port of homerhevc_tpu/cli.py.

The same flags, defaults and exits as the JAX package's app, the same
read/encode/write loop and the same closing "%d frames in %d
milliseconds: %f fps" and "kbps:" lines.  It runs on the CUDA device;
`main(argv, device="cpu")` runs it on the CPU (the tests do), and
without CUDA `main(argv)` fails as `Encoder` does.

`-num_chips N` shards over the ranks of a torch.distributed process
group, one process per device, as the JAX app shards over its devices:
every rank reads the input and encodes, and rank 0 alone writes the
.265, -o-raw and -stats files and prints.  With fewer ranks than N it
runs on what there is (one device without a group).  Started by
torchrun (WORLD_SIZE > 1 in the environment), main() joins the group
itself: NCCL with each rank on cuda:LOCAL_RANK, or gloo on the CPU
(`backend` overrides it).

Usage:
  python -m homerhevc_torch -i in.yuv -o out.265 -widthxheight 1280x720 \
      -frame_rate 25 -intra_period 100 -qp 32 -n_frames 100
  torchrun --nproc_per_node 2 -m homerhevc_torch -i in.yuv -o out.265 \
      -widthxheight 1280x720 -num_chips 2
"""
from __future__ import annotations

import contextlib
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from homerhevc_torch import parallel
from homerhevc_torch.api import Encoder
from homerhevc_torch.config import (BitrateMode, EncoderConfig, PerfMode,
                                    RDMode)
from homerhevc_torch.metrics import FrameStats, StatsSink
from homerhevc_torch.parallel import multihost


HELP = """homerhevc_torch [-option] [value]...
options:
-h                              help
-i                              input yuv file (YUV420 8-bit planar)
-o                              output 265 file
-o-raw                          output reconstructed frames (yuv)
-widthxheight                   e.g. 1280x720 (default)
-frame_rate                     default 25
-cu_size                        [16, 32, 64], default 64
-intra_period                   0=only first, 1=all intra; default 100
-gop_size                       0: intra profile, 1: IPPP; default 1
-num_ref_frames                 default 1
-qp                             [0-51], default 32
-motion_estimation_precision    0=pel 1=half 2=quarter; default 2
-chroma_qp_offset               [-12, 12], default 2
-max_pred_depth                 [0-4], default 4
-max_intra_tr_depth             [0-4], default 1
-max_inter_tr_depth             [0-4], default 1
-sign_hiding                    0/1, default 1
-sao                            0/1, default 1
-deblocking                     0/1, default 1
-bitrate_mode                   0=FIXED_QP 1=CBR 2=VBR; default 0
-bitrate                        kbps for CBR/VBR, default 1250
-vbv_size                       x bitrate seconds, default 1.0
-vbv_init                       x vbv_size, default 0.35
-performance_mode               0=full 1=fast 2=ufast; default 2
-rd                             0=full 1=fast 2=ufast; default 1
-n_frames                       default 1000
-skipped_frames                 default 0
-stats                          per-frame stats JSONL file
-tiles                          CxR tile grid (all-intra), e.g. 4x2;
                                "auto" picks one from the resolution
-num_chips                      shard over N ranks of a torch.distributed
                                group: all-intra chunks by frame, IPPP
                                by CTU-row bands (bit-transparent);
                                default 1
-adaptive_qp                    0/1 per-CTU activity QP; default 0
"""


def parse_args(argv):
    cfg = EncoderConfig()
    opts = dict(infile=None, outfile=None, rawfile=None, n_frames=1000,
                skipped=0, stats=None)
    i = 0
    intmap = {
        "-frame_rate": "frame_rate", "-cu_size": "cu_size",
        "-intra_period": "intra_period", "-gop_size": "gop_size",
        "-num_ref_frames": "num_ref_frames", "-qp": "qp",
        "-motion_estimation_precision": "motion_estimation_precision",
        "-chroma_qp_offset": "chroma_qp_offset",
        "-max_pred_depth": "max_pred_depth",
        "-max_intra_tr_depth": "max_intra_tr_depth",
        "-max_inter_tr_depth": "max_inter_tr_depth",
        "-bitrate": "bitrate", "-num_chips": "num_chips",
        "-adaptive_qp": "adaptive_qp",
    }
    boolmap = {"-sign_hiding": "sign_hiding", "-sao": "sao",
               "-deblocking": "deblocking"}
    optmap = {"-i": "infile", "-o": "outfile", "-o-raw": "rawfile",
              "-stats": "stats"}
    while i < len(argv):
        a = argv[i]
        if a == "-h":
            print(HELP)
            sys.exit(0)
        elif a in optmap:
            i += 1
            opts[optmap[a]] = argv[i]
        elif a == "-widthxheight":
            i += 1
            w, h = argv[i].split("x")
            cfg.width, cfg.height = int(w), int(h)
        elif a in intmap:
            i += 1
            setattr(cfg, intmap[a], int(argv[i]))
        elif a in boolmap:
            i += 1
            setattr(cfg, boolmap[a], bool(int(argv[i])))
        elif a == "-bitrate_mode":
            i += 1
            cfg.bitrate_mode = BitrateMode(int(argv[i]))
        elif a == "-vbv_size":
            i += 1
            cfg.vbv_size = float(argv[i])
        elif a == "-vbv_init":
            i += 1
            cfg.vbv_init = float(argv[i])
        elif a == "-performance_mode":
            i += 1
            cfg.performance_mode = PerfMode(int(argv[i]))
        elif a == "-rd":
            i += 1
            cfg.rd_mode = RDMode(int(argv[i]))
        elif a == "-n_frames":
            i += 1
            opts["n_frames"] = int(argv[i])
        elif a == "-skipped_frames":
            i += 1
            opts["skipped"] = int(argv[i])
        elif a == "-tiles":
            i += 1
            if argv[i] == "auto":
                cfg.tile_auto = True
            else:
                c, r = argv[i].split("x")
                cfg.tile_cols, cfg.tile_rows = int(c), int(r)
        else:
            print(f"unknown option {a} (use -h)")
            sys.exit(1)
        i += 1
    return cfg, opts


def read_frame(f, w, h):
    n = w * h
    nc = n // 4
    buf = bytearray(f.read(n + 2 * nc))     # writable, for torch.from_numpy
    if len(buf) < n + 2 * nc:
        return None
    y = np.frombuffer(buf[:n], np.uint8).reshape(h, w)
    u = np.frombuffer(buf[n:n + nc], np.uint8).reshape(h // 2, w // 2)
    v = np.frombuffer(buf[n + nc:], np.uint8).reshape(h // 2, w // 2)
    return y, u, v


def main(argv=None, device=None, backend=None):
    """Run the app on `argv` (default sys.argv[1:]) on `device` (default
    the CUDA device, cuda:LOCAL_RANK under torchrun); returns the exit
    code.  Under torchrun it joins the process group with `backend`
    (default NCCL on CUDA, gloo on the CPU) and leaves it at the end."""
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("no args passed!\ntype -h for help")
        return 0
    cfg, opts = parse_args(argv)
    if not opts["infile"] or not opts["outfile"]:
        print("need -i and -o (use -h)")
        return 1
    joined = False
    torchrun = int(os.environ.get("WORLD_SIZE", "1")) > 1
    if torchrun and not dist.is_initialized():
        if device is None:
            device = f"cuda:{os.environ.get('LOCAL_RANK', '0')}"
        if backend is None:
            backend = "gloo" if str(device).startswith("cpu") else "nccl"
        if not str(device).startswith("cpu"):
            torch.cuda.set_device(device)
        multihost.init_distributed(backend=backend)
        joined = True
    try:
        if parallel.rank() == 0:
            return _run(cfg, opts, device)
        # the other ranks encode alongside and write nothing
        with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
            return _run(cfg, opts, device, write=False)
    finally:
        if joined:
            dist.destroy_process_group()


def _run(cfg, opts, device, write=True) -> int:
    enc = Encoder(cfg, device=device)
    sink = StatsSink(opts["stats"]) if opts["stats"] and write else None
    raw = open(opts["rawfile"], "wb") if opts["rawfile"] and write else None
    # the synchronous path wherever rank 0 needs reconstructions, on
    # every rank alike
    want_recon = bool(opts["rawfile"] or opts["stats"])

    n_in = 0
    n_out = 0
    total_bits = 0
    t0 = time.time()
    with open(opts["infile"], "rb") as fin, \
            open(opts["outfile"] if write else os.devnull, "wb") as fout:
        for _ in range(opts["skipped"]):
            read_frame(fin, cfg.width, cfg.height)

        def emit(frame):
            nonlocal n_out, total_bits
            fout.write(frame.nalus)
            total_bits += frame.bits
            if raw is not None and frame.recon is not None:
                for pl in frame.recon:
                    raw.write(np.ascontiguousarray(pl).tobytes())
            if sink is not None:
                sink.write(FrameStats(
                    poc=frame.poc, bits=frame.bits,
                    psnr=frame.psnr,
                    vbv_fullness=enc._rc.vbv_fullness))
            n_out += 1

        while n_in < opts["n_frames"]:
            planes = read_frame(fin, cfg.width, cfg.height)
            if planes is None:
                break
            n_in += 1
            if want_recon:
                emit(enc.encode(*planes))     # recon path is synchronous
            else:
                for done in enc.encode_async(*planes):
                    emit(done)
        if not want_recon:
            for frame in enc.flush():
                emit(frame)
    ms = int((time.time() - t0) * 1000)
    fps = n_out / max(ms / 1000.0, 1e-9)
    print(f"{n_out} frames in {ms} milliseconds: {fps:f} fps")
    print(f"kbps: {total_bits * cfg.frame_rate / max(n_out, 1) / 1000.0:.1f}")
    if raw is not None:
        raw.close()
    if sink is not None:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
