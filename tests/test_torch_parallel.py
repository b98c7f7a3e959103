"""The port's multi-device path (torch.distributed, one process per
device) against one device, on the CPU with gloo: ranks run as child
processes (tests/torch_ranks.py) on a free localhost port, each with its
own time limit, while this process computes the one-device results.

* The row-banded scene-gate sum equals the reference's row-sharded
  `psum(jnp.sum(x))` on 2, 3, 4 and 8 virtual CPU devices.
* `Encoder(num_chips=N)` on three ranks gives the num_chips=1 bytes and
  reconstructions: P chunks in 3 row bands (176x144) and in 2 (128x120,
  the third rank computing the frame alone), all-intra chunks with
  tiles in 2 and 3 frame shards.  Two of its num_chips=1 streams are
  the ones the port's tests hold to the JAX Encoder: the 176x144
  adaptive_qp stream (tests/test_torch_rate_control.py,
  test_vbr_and_adaptive_qp_match_jax_and_decode) and the first four
  frames of the 176x144 all-intra stream with tiles and scaling lists
  (tests/test_torch_all_intra.py), so the sharded streams equal the
  reference's too.  No JAX multi-device program runs here.
* parallel.wpp, parallel.gop and parallel.multihost on two ranks give
  the port's one-device results, avg_dist by the reference's formula.
* The console app under two ranks with -num_chips 2 writes the
  -num_chips 1 .265.
"""
import os
import pathlib
import pickle
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from homerhevc_torch import cli as tcli
from homerhevc_torch.models import inter_frame as tinter
from homerhevc_torch.ops import f32
from tests import torch_ranks

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Ranks:
    """`world` child processes running one torch_ranks case; the caller
    works meanwhile, then collects each rank's pickled result."""

    def __init__(self, case, world, outdir, timeout=240):
        port = _free_port()
        self.outdir, self.timeout = outdir, timeout
        env = dict(os.environ, OMP_NUM_THREADS="1")
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", "tests.torch_ranks", case, str(r),
             str(world), str(port), str(outdir)], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(world)]

    def results(self) -> list:
        logs = []
        try:
            for p in self.procs:
                logs.append(p.communicate(timeout=self.timeout)[0].decode())
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(self.procs, logs)):
            assert p.returncode == 0, f"rank {r}:\n{log[-3000:]}"
        out = []
        for r in range(len(self.procs)):
            with open(os.path.join(self.outdir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def _threshold_grid(rng, rows, cols, h, w):
    """sad_me-like values whose float32 mean lands on 6.0 per pixel up to
    rounding: the band sums' order decides the gate."""
    x = (1536.0 + rng.normal(0, 40, (rows, cols))).astype(np.float32)
    x[rng.integers(0, rows), rng.integers(0, cols)] += np.float32(
        6.0 * h * w - x.astype(np.float64).sum())
    return x


def test_band_sum_equals_row_sharded_psum():
    """f32.band_sum (and the scene gate) against shard_map of
    psum(jnp.sum(band)) over n virtual CPU devices, the reference's
    row-sharded gate (homerhevc_tpu/models/inter_frame.py:1459-1474),
    on band grids of 1-8 CTU rows (4-32 block rows) and 4-80 columns;
    half the grids sit on the gate's mean_sad_px > 6.0 threshold."""
    rng = np.random.default_rng(5)
    gate_flips = 0
    for n in (2, 3, 4, 8):
        mesh = Mesh(np.asarray(jax.devices()[:n]), ("row",))
        for rows in range(1, 9):
            bh = 4 * rows
            for bw in (4, 8, 20, 80)[rows % 2::2]:
                h, w = 16 * bh * n, 16 * bw

                def gate(a, h=h, w=w):
                    s = jax.lax.psum(jnp.sum(a), "row")
                    return jnp.stack([s, (s.astype(jnp.float32) / (h * w)
                                          > 6.0).astype(jnp.float32)])
                f = jax.jit(shard_map(gate, mesh=mesh, in_specs=P("row"),
                                      out_specs=P(), check_vma=False))
                for x in ((rng.random((n * bh, bw)) * 3000)
                          .astype(np.float32),
                          _threshold_grid(rng, n * bh, bw, h, w)):
                    want_sum, want_gate = np.asarray(f(x))
                    t = torch.as_tensor(x)
                    got = f32.band_sum(t, n)
                    assert got.dtype == torch.float32
                    assert np.float32(got) == want_sum, (n, bh, bw)
                    got_gate = bool(tinter._maybe_scene(
                        t, torch.tensor(0), h, w, n))
                    assert got_gate == bool(want_gate), (n, bh, bw)
                    whole = bool(tinter._maybe_scene(t, torch.tensor(0), h,
                                                     w))
                    gate_flips += whole != got_gate
    # the banded order is not the one-device order: some gates flip
    assert gate_flips > 0


def _equal(a, b, what):
    assert len(a) == len(b), what
    for x, y in zip(a, b):
        for p, q in zip(x, y):
            np.testing.assert_array_equal(p, q, err_msg=what)


def test_encoder_row_bands_and_frame_shards(tmp_path):
    """Encoder(num_chips=N) on three gloo ranks against num_chips=1: the
    Annex-B bytes of every frame and every chunk's reconstruction, on
    every rank, and the effective counts that show the sharded path
    ran."""
    ranks = _Ranks("encoder", 3, tmp_path)
    want = [torch_ranks.run_encoder(kw, frames, 1)
            for _, kw, frames, _ in torch_ranks.encoder_cases()]
    got = ranks.results()
    counts = {"adaptive_qp 176x144": (3, 1), "features 128x120": (2, 1),
              "all-intra 176x144": (1, 2), "all-intra tiles, k=3": (1, 3)}
    for i, (name, _, frames, _) in enumerate(torch_ranks.encoder_cases()):
        nalus, recons, eff = want[i]
        assert eff == (1, 1) and len(nalus) == len(frames), name
        for r, res in enumerate(got):
            assert res[i][2] == counts[name], (name, r, res[i][2])
            assert res[i][0] == nalus, f"{name}: rank {r}'s bytes"
            _equal(res[i][1], recons, f"{name}: rank {r}'s recons")


def test_parallel_modules_equal_one_device(tmp_path):
    """parallel.gop.encode_gop, encode_ippp_gops, multihost's
    encode_ippp_multihost (each rank its own GOP) and
    wpp.encode_p_frame_rowsharded on two ranks against the port's
    one-device calls; avg_dist = float32(int32 sum) / float32(n)."""
    ranks = _Ranks("modules", 2, tmp_path)
    ref = torch_ranks.module_references()
    got = ranks.results()
    recs, d, n = ref["gop"]
    avg = float(np.float32(np.int32(d)) / np.float32(n))
    for r, res in enumerate(got):
        g, a = res["gop"]
        assert set(g) == set(recs) and a == avg, r
        for k in recs:
            np.testing.assert_array_equal(g[k], recs[k], err_msg=k)
        for key in ("ippp", "multihost"):
            (want, d2, n2), (g2, a2) = ref["ippp"], res[key]
            mine = slice(r, r + 1) if key == "multihost" else slice(None)
            assert a2 == float(np.float32(np.int32(d2)) / np.float32(n2))
            for k in ("i_packed", "p_packed"):
                np.testing.assert_array_equal(g2[k], want[k][mine],
                                              err_msg=f"{key} {k} {r}")
        assert set(res["wpp"]) == set(ref["wpp"])
        for k, v in ref["wpp"].items():
            np.testing.assert_array_equal(res["wpp"][k], v, err_msg=k)


def test_cli_num_chips_under_two_ranks(tmp_path):
    """`-num_chips 2` with two ranks that join the group from torchrun's
    environment: rank 0 writes the -num_chips 1 .265 and the other rank
    writes nothing; both leave the group at the end."""
    torch_ranks.write_yuv(tmp_path / "in.yuv", torch_ranks.synthetic_video(
        3, 120, 128, plants=4))
    ranks = _Ranks("cli", 2, tmp_path)
    assert tcli.main(torch_ranks.cli_argv(tmp_path, "one.265", 1),
                     device="cpu") == 0
    assert ranks.results() == [(0, False), (0, False)]
    one = (tmp_path / "one.265").read_bytes()
    assert one and (tmp_path / "two.265").read_bytes() == one
