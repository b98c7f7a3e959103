"""Multi-device encoding on torch.distributed: one process per device.

Port of homerhevc_tpu/parallel/.  Where the reference runs one program
over a device mesh (shard_map), the port runs one process per device in
a torch.distributed process group; the mesh axis is the group, its
size the device count ("devices" = the default group's world size, or 1
without one).  The caller starts the processes (torchrun or
torch.multiprocessing) and picks the backend: NCCL where each rank has
its own card, gloo on the CPU and for ranks that share a card.  The
port never changes a rank's backend or device.

Every cross-device point is an all_gather of rows in rank order; an
all-reduce, whose order the backend chooses, is never used for a value
that feeds a decision, so the results are bit-identical to one device.
Collectives run on the calling (compute) thread, in the same order on
every rank.

This module holds the collective helpers; `multihost` sets the group up,
`wpp` shards a P frame's CTU rows, `gop` shards frames and closed GOPs.
"""
from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

# every process group is made with this timeout: a collective that a rank
# never joins fails after it instead of hanging
TIMEOUT = datetime.timedelta(seconds=600)


def world_size() -> int:
    """Ranks of the default process group, 1 without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def rank() -> int:
    """This process's rank in the default group, 0 without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def first_ranks(n: int):
    """(group of ranks 0..n-1, whether this rank is in it).  The default
    group itself when n is its size; otherwise every rank must call this,
    in the same order (dist.new_group is collective)."""
    if n == world_size():
        return dist.group.WORLD, True
    return dist.new_group(list(range(n)), timeout=TIMEOUT), rank() < n


def _words(x: torch.Tensor) -> torch.Tensor:
    """x as a flat int32 tensor that _unwords restores exactly."""
    x = x.contiguous().reshape(-1)
    if x.dtype in (torch.float32, torch.int32, torch.int64):
        return x.view(torch.int32)
    return x.to(torch.int32)


def _unwords(w: torch.Tensor, like: torch.Tensor, shape) -> torch.Tensor:
    if like.dtype in (torch.float32, torch.int32, torch.int64):
        return w.contiguous().view(like.dtype).reshape(shape)
    if like.dtype == torch.bool:
        return (w != 0).reshape(shape)
    return w.to(like.dtype).reshape(shape)


def gather_rows(group, *xs: torch.Tensor) -> list:
    """Every x of every rank of `group`, concatenated along axis 0 in rank
    order (jax.lax.all_gather then a reshape), exact for every dtype: all
    of xs travel in ONE all_gather.  A backend other than NCCL gathers a
    CUDA tensor through the host (gloo takes no CUDA all_gather)."""
    n = dist.get_world_size(group)
    flat = [_words(x) for x in xs]
    buf = torch.cat(flat)
    host = buf.is_cuda and dist.get_backend(group) != "nccl"
    send = buf.cpu() if host else buf
    parts = [torch.empty_like(send) for _ in range(n)]
    dist.all_gather(parts, send, group=group)
    allw = torch.stack(parts).to(buf.device)          # [n, words]
    out, off = [], 0
    for x, f in zip(xs, flat):
        k = f.numel()
        shape = (n * x.shape[0],) + tuple(x.shape[1:]) if x.dim() else (n,)
        out.append(_unwords(allw[:, off:off + k], x, shape))
        off += k
    return out


class RowBands:
    """A frame cut into n CTU-row bands, band i held by rank i of `group`.
    With group None this process holds the whole frame (the n bands
    included): gather and band are the identity."""

    def __init__(self, group=None, n: int = 1):
        self.group = group
        self.n = n
        self.index = 0 if group is None else dist.get_rank(group)

    def gather(self, *xs):
        """The full arrays from each rank's band rows (one collective)."""
        if self.group is None:
            return xs if len(xs) > 1 else xs[0]
        out = gather_rows(self.group, *xs)
        return out if len(xs) > 1 else out[0]

    def band(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a full array (its n-th part of axis 0)."""
        if self.group is None:
            return x
        r = x.shape[0] // self.n
        return x[self.index * r:(self.index + 1) * r]
