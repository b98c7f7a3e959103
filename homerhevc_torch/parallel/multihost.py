"""Multi-host frame-parallel encoding.  Port of
homerhevc_tpu/parallel/multihost.py.

One process per device on every host joins one process group; closed
GOPs split over the ranks, and because each GOP starts with its own IDR
no reference pixel crosses a host: the only traffic is the rate-control
signal (the engines' RC-state exchange, an exact integer sum).  Each
process codes the GOPs it was given and keeps their records for its own
entropy stage; joining the streams across hosts is the caller's
transport concern, as in the reference.

Host-side flow (each process):
  init_distributed(...) -> encode_ippp_multihost(this process's GOPs).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from homerhevc_torch import parallel
from homerhevc_torch.parallel import gop as gop_mod


def init_distributed(coordinator: str = None, num_processes: int = None,
                     process_id: int = None, *, backend: str = "gloo",
                     timeout=parallel.TIMEOUT):
    """Join the process group (a no-op for one process).  coordinator:
    "host:port" of rank 0 (or an init_method URL); without it the
    torchrun environment (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE)
    is read.  backend: "gloo" (the CPU, or ranks that share a card) or
    "nccl" (one card per rank), as the caller chooses.  Collectives that
    a rank never joins fail after `timeout`."""
    if num_processes is not None and num_processes <= 1:
        return
    url = None
    if coordinator is not None:
        url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(
        backend, init_method=url,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id, timeout=timeout)


def global_group():
    """The group of every rank of every host (None for one process)."""
    return dist.group.WORLD if parallel.world_size() > 1 else None


def encode_ippp_multihost(y, u, v, *, qp: int, group=None, **kw):
    """Encode this process's closed GOPs (y: uint8 [n_local, g, H, W],
    CTU-padded, on this rank's device; the same n_local on every rank)
    with encode_ippp_gops' knobs.  Returns (local_records, avg_dist):
    numpy i_packed [n_local, Li] and p_packed [n_local, g-1, Lp] of ONLY
    this process's GOPs, ready for the host entropy stage, and the global
    rate-control signal (the same float on every rank)."""
    recs, total = gop_mod._ippp_local(y, u, v, qp=qp, **kw)
    group = global_group() if group is None else group
    n = y.shape[0]
    if group is not None:
        both = parallel.gather_rows(
            group, torch.stack([total, torch.tensor(n, device=total.device)]))
        total, n = both[0][0::2].sum(), int(both[0][1::2].sum())
    return ({k: t.cpu().numpy() for k, t in recs.items()},
            float(gop_mod.mean_dist(total, n)))
