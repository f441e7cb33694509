"""Starting ranks from Python: `spawn(fn, n, *args)` runs fn(rank, n,
*args) in n fresh processes (the `spawn` start method) and waits for all.
The tests, the dry run and the chip check start their ranks so; a user
starts the CLI's with `torchrun --nproc-per-node N -m
dnn_compression_tensor_admm_tpu_torch ...`. `fn` must be importable by
its module path, and each rank joins the group itself
(`dist.init_distributed(..., init_method=file_init_method(d), rank=rank,
world_size=n)`): a rendezvous file, no TCP port.

`run_jobs` runs measurement jobs (`bench/`) on n ranks and merges each
job's per-rank results in the caller: one rank in the calling process,
several spawned, each joining the group for them."""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from typing import Callable, List, Sequence

import torch
import torch.multiprocessing as mp

from ..utils.device import resolve_device
from . import dist


def file_init_method(directory: str) -> str:
    """A rendezvous through a file in `directory`, which must not hold one
    yet (a file left from an earlier group would mislead the new one)."""
    path = os.path.join(os.path.abspath(directory), "rendezvous")
    if os.path.exists(path):
        raise FileExistsError(f"{path} is left from an earlier group")
    return "file://" + path


def spawn(fn, nprocs: int, *args, timeout: float = 600.0) -> None:
    """Run fn(rank, nprocs, *args) for rank 0..nprocs-1, each in its own
    process, and wait; a rank's exception is raised here (the others are
    ended), and so is a run past `timeout` seconds."""
    ctx = mp.start_processes(fn, args=(nprocs, *args), nprocs=nprocs,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join(10)
            raise TimeoutError(f"{nprocs} ranks of {fn.__name__} ran past "
                               f"{timeout} s")


@dataclasses.dataclass(frozen=True)
class Job:
    """`fn(device, **kwargs)`, run on every rank (`device` the rank's),
    returns a JSON-able dict; `merge(outs, ranks)` makes the job's row in
    the caller from the ranks' dicts in rank order and `ranks` =
    {"ranks", "backend", "gpus_visible"}. `fn` must be importable by its
    module path (a spawned rank unpickles it); `merge` runs in the
    caller only."""
    fn: Callable[..., dict]
    kwargs: dict
    merge: Callable[[List[dict], dict], dict]


def _rank_devices(nprocs: int, device: str = "cuda"):
    """(backend, each rank's device) for `nprocs` ranks on `device`: gloo
    on the CPU; on the card NCCL with one GPU a rank where there are
    enough, else gloo with every rank on cuda:0 (NCCL refuses two ranks
    on one GPU). One rank: no group."""
    dev = resolve_device(device)
    if nprocs == 1:
        return None, str(dev)
    if dev.type == "cpu":
        return "gloo", "cpu"
    if torch.cuda.device_count() >= nprocs:
        return "nccl", "cuda"
    return "gloo", "cuda:0"


def _job_rank(rank: int, world: int, init_method: str, out_dir: str,
              device: str, backend: str, threads: int, jobs) -> None:
    torch.set_num_threads(threads)
    topo = dist.init_distributed(device, backend=backend,
                                 init_method=init_method, rank=rank,
                                 world_size=world)
    try:
        outs = [fn(topo.device, **kwargs) for fn, kwargs in jobs]
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(outs, f)
    finally:
        dist.shutdown()


def run_jobs(jobs: Sequence[Job], nprocs: int, device: str = "cuda",
             timeout: float = 600.0) -> List[dict]:
    """Each of `jobs` on `nprocs` ranks -> its merged row, in order. One
    rank runs the jobs in this process; several are spawned once for all
    the jobs, each with this process's torch thread count, placed by
    `_rank_devices`, and a failing rank raises here."""
    backend, rank_device = _rank_devices(nprocs, device)
    ranks = {"ranks": nprocs, "backend": backend,
             "gpus_visible": (torch.cuda.device_count()
                              if rank_device.startswith("cuda") else 0)}
    if nprocs == 1:
        dev = torch.device(rank_device)
        return [job.merge([job.fn(dev, **job.kwargs)], ranks) for job in jobs]
    with tempfile.TemporaryDirectory() as d:
        spawn(_job_rank, nprocs, file_init_method(d), d, rank_device, backend,
              torch.get_num_threads(), [(j.fn, j.kwargs) for j in jobs],
              timeout=timeout)
        outs = []
        for r in range(nprocs):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                outs.append(json.load(f))
    return [job.merge([o[i] for o in outs], ranks)
            for i, job in enumerate(jobs)]
