"""Multi-process start and every collective the port uses (counterpart of
the JAX package's `parallel/dist.py`).

One process per rank, started by `torchrun` (or any launcher that sets
`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR` and `MASTER_PORT`), by
SLURM (`SLURM_PROCID`, `SLURM_NTASKS`, `SLURM_LOCALID`, with
`MASTER_ADDR`/`MASTER_PORT` set by the batch script), or by a caller that
passes them (`parallel/launch.py`). `--device cuda` means NCCL with one
GPU per rank (`cuda:LOCAL_RANK`), `--device cpu` gloo.

Gloo serves ranks that share one card (NCCL refuses two ranks on one
GPU): torch's gloo (2.11 on the H100) takes CUDA tensors in every
collective used here (all-reduce, all-gather, broadcast) and stages them
through the host itself; `chip_smoke.py`'s multi-rank phase runs each of
them so on the card.

Each collective counts its calls (`all_gather.calls`, `all_reduce.calls`,
`broadcast.calls`), as the kernel wrappers count launches; a call on a
group of one rank is no collective and counts nothing.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as tdist

from ..utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Topology:
    """This process's place: its rank among `world_size`, the backend
    (None in one process) and its device."""
    rank: int
    world_size: int
    backend: Optional[str]
    device: torch.device


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if name in os.environ:
            return int(os.environ[name])
    return None


def init_distributed(device: str = "cuda", *, backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> Topology:
    """Join the process group; a no-op in one process. Missing arguments
    come from torchrun's variables, else SLURM's (as the JAX package's
    `init_distributed` reads them). `device` 'cuda' takes `cuda:LOCAL_RANK`
    (raises where that GPU is absent), 'cuda:N' that GPU for every rank,
    'cpu' the CPU; the backend is NCCL for a GPU and gloo for the CPU
    unless `backend` says otherwise. `init_method` defaults to `env://`
    (`MASTER_ADDR`, `MASTER_PORT`). In one process the device is `device`
    as given."""
    if rank is None:
        rank = _env_int("RANK", "SLURM_PROCID")
    if world_size is None:
        world_size = _env_int("WORLD_SIZE", "SLURM_NTASKS")
    rank, world_size = rank or 0, world_size or 1
    local_rank = _env_int("LOCAL_RANK", "SLURM_LOCALID")
    local_rank = rank if local_rank is None else local_rank
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and world_size > 1:
        dev = torch.device("cuda", local_rank)
    dev = resolve_device(str(dev))
    if dev.type == "cuda" and dev.index is not None:
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} wants {dev}, but "
                               f"{torch.cuda.device_count()} GPU(s) are "
                               "visible")
        torch.cuda.set_device(dev)
    if world_size == 1:
        return Topology(0, 1, None, dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if not tdist.is_initialized():
        tdist.init_process_group(backend, init_method=init_method or "env://",
                                 rank=rank, world_size=world_size)
    return Topology(rank, world_size, backend, dev)


def shutdown() -> None:
    """Leave the process group (no-op where none was joined)."""
    if tdist.is_initialized():
        tdist.destroy_process_group()


def is_main_process() -> bool:
    """The process that writes checkpoints, models and logs."""
    return not tdist.is_initialized() or tdist.get_rank() == 0


def _size(group) -> int:
    return tdist.get_world_size(group) if tdist.is_initialized() else 1


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum `t` over `group`'s ranks in place; returns `t`."""
    if _size(group) == 1:
        return t
    all_reduce.calls += 1
    tdist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """`group`'s ranks' `t` (equal shapes) stacked on a new first axis,
    in rank order."""
    n = _size(group)
    if n == 1:
        return t[None]
    all_gather.calls += 1
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    tdist.all_gather(parts, t, group=group)
    return torch.stack(parts)


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """`t` from global rank `src` to every rank of `group`, in place."""
    if _size(group) == 1:
        return t
    broadcast.calls += 1
    tdist.broadcast(t, src, group=group)
    return t


all_reduce.calls = all_gather.calls = broadcast.calls = 0


def barrier(device: torch.device) -> None:
    """Returns once every rank has reached it (an all-reduce of one zero
    on `device`), with the card's queue drained; in one process it only
    drains the queue. The measurement harnesses start their timed loops
    here."""
    all_reduce(torch.zeros(1, device=device))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def reset_counts() -> None:
    all_reduce.calls = all_gather.calls = broadcast.calls = 0


def counts() -> Dict[str, int]:
    return {"all_reduce": all_reduce.calls, "all_gather": all_gather.calls,
            "broadcast": broadcast.calls}


def same_on_every_rank(tensors: Sequence[torch.Tensor], group=None) -> bool:
    """Whether every rank of `group` holds bit-equal `tensors` (one
    all-gather of them all, as float64)."""
    flat = torch.cat([t.detach().double().reshape(-1) for t in tensors])
    every = all_gather(flat, group)
    return all(torch.equal(every[0], e) for e in every[1:])


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group in the forward, and the same sum of the gradients
    in the backward (the sum's adjoint)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group), None


def all_reduce_sum_autograd(x: torch.Tensor, group=None) -> torch.Tensor:
    """`all_reduce` that autograd differentiates (global BatchNorm)."""
    if _size(group) == 1:
        return x
    return _AllReduceSum.apply(x, group)


def all_reduce_metrics(metrics: Dict[str, float], group=None,
                       device: Optional[torch.device] = None
                       ) -> Dict[str, float]:
    """Mean of scalar metrics over `group`'s ranks (the reference's metric
    all-reduce): one collective for the whole dict."""
    n = _size(group)
    if n == 1:
        return dict(metrics)
    keys = sorted(metrics)
    vals = torch.tensor([float(metrics[k]) for k in keys],
                        dtype=torch.float64, device=device)
    all_reduce(vals, group)
    return {k: v / n for k, v in zip(keys, vals.tolist())}


def partition_shard_paths(paths: Sequence[str], process_index: int,
                          process_count: int, seed: int = 0
                          ) -> Tuple[List[str], int, int, int]:
    """Split DCTA shards across data ranks (DistributedSampler's role):
    (paths, seed, stride, offset) for `NativeLoader`. With at least one
    file per rank the files go round-robin (stride 1); with fewer, every
    rank opens every file and the loader serves the disjoint rows
    offset::stride of the global sample index."""
    if process_count <= 1:
        return list(paths), seed, 1, 0
    if len(paths) < process_count:
        return list(paths), seed, process_count, process_index
    return list(paths)[process_index::process_count], seed, 1, 0
