"""Starting ranks from Python: `spawn(fn, n, *args)` runs fn(rank, n,
*args) in n fresh processes (the `spawn` start method) and waits for all.
The tests, the dry run and the chip check start their ranks so; a user
starts the CLI's with `torchrun --nproc-per-node N -m
dnn_compression_tensor_admm_tpu_torch ...`. `fn` must be importable by
its module path, and each rank joins the group itself
(`dist.init_distributed(..., init_method=file_init_method(d), rank=rank,
world_size=n)`): a rendezvous file, no TCP port."""

from __future__ import annotations

import os
import time

import torch.multiprocessing as mp


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
