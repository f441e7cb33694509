"""Fused epochs: several ADMM epochs run on the card as one chunk (the
JAX package's `run_epochs`, `--epochs-per-dispatch`).

An epoch of a chunk is `epoch_start` (the Z/U step written in place, the
epoch's permutation or shuffled copy, the epoch's sums and row counter
set to 0) and `steps` calls of `x_step` (one optimizer step on the rows
of the device's counter, its loss and accuracy added to the sums). On a
card the first epoch of the first chunk calls both eagerly, as the
per-epoch route does; then each is captured once in a CUDA graph, with
the device generator registered, and every later call is a replay:
nothing is read to the host between the chunk's first replay and its one
read of the [k] sums at its end, which runs under
`torch.cuda.set_sync_debug_mode("error")`. A capture or a replay that
fails raises; the chunk never gives way to the per-epoch route. On the
CPU the same chunk runs eagerly.

`chunkable` and `chunk_size` are the JAX package's rule
(`train/engine.py:654-671` there); `exclusion` names what the port
leaves on the per-epoch route although that rule would chunk it.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, List, Optional, Sequence

import torch

from ..ops.cuda import subspace_kernel as sk
from ..ops.cuda import tucker_kernel as tk


def chunkable(cfg, streaming: bool) -> bool:
    """The JAX package's predicate: chunks only where the host observes
    nothing per epoch."""
    return (not streaming and cfg.epochs_per_dispatch > 1
            and not cfg.verbose_admm and not cfg.log_path
            and cfg.checkpoint_dir is None and cfg.profile_dir is None
            and not cfg.adjust_rho_late)


def chunk_size(cfg, epoch: int, epochs: int, has_val: bool) -> int:
    """Epochs in the chunk that starts at `epoch` (0-based) of a run that
    stops at `epochs`: up to `epochs_per_dispatch`, ending at the next
    evaluation and at the last epoch."""
    if has_val and cfg.eval_every <= epochs:
        nxt = (epoch // cfg.eval_every + 1) * cfg.eval_every
    else:
        nxt = epochs
    return max(1, min(cfg.epochs_per_dispatch, nxt - epoch, epochs - epoch))


def exclusion(cfg, mesh=None) -> Optional[str]:
    """Why the port runs a chunkable run per epoch, or None."""
    if mesh is not None and mesh.size > 1:
        return (f"a mesh of {mesh.size} ranks: collectives are not "
                "captured in CUDA graphs")
    if cfg.mixup > 0 or cfg.cutmix > 0:
        return "Mixup/CutMix draws its lambda and box on the host"
    if cfg.admm and cfg.admm_method != "kernel":
        return (f"the {cfg.admm_method!r} Z/U step's torch.linalg calls read "
                "their error flags back to the host")
    return None


def register_generators(graph, generators: Sequence[torch.Generator]) -> None:
    """Each replay of `graph` draws from `generators` where the eager calls
    would have, and advances them."""
    for g in generators:
        graph.register_generator_state(g)


class _Graph:
    """`fn` captured once in a CUDA graph; each replay adds the kernel
    launches the capture took to the wrappers' `launches`."""

    def __init__(self, fn: Callable[[], None],
                 generators: Sequence[torch.Generator]):
        wrappers = (tk.tucker2_factors_batched,
                    sk.dominant_left_subspace_batched)
        before = [getattr(w, "captured", 0) for w in wrappers]
        self.graph = torch.cuda.CUDAGraph()
        register_generators(self.graph, generators)
        # relaxed: the kernel wrappers' libraries are loaded and their
        # attributes set by the eager call before the capture
        with torch.cuda.graph(self.graph, capture_error_mode="relaxed"):
            fn()
        self.launches = [(w, getattr(w, "captured", 0) - b)
                         for w, b in zip(wrappers, before)]

    def replay(self) -> None:
        self.graph.replay()
        for w, n in self.launches:
            w.launches += n


@contextlib.contextmanager
def _no_host_reads(on_card: bool):
    if not on_card:
        yield
        return
    saved = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(saved)


class EpochChunks:
    """The chunks of one run (see the module docstring). `sums` is the
    [2] tensor (loss, accuracy) that `x_step` adds to and `epoch_start`
    sets to 0; its graphs are kept for every later chunk of the run.
    `capture_s` is the host time of the first epoch's eager calls and the
    two captures (the capture waits for the card first)."""

    def __init__(self, epoch_start: Callable[[], None],
                 x_step: Callable[[], None], sums: torch.Tensor, steps: int,
                 generators: Sequence[torch.Generator]):
        self.epoch_start, self.x_step = epoch_start, x_step
        self.sums, self.steps = sums, steps
        self.generators = tuple(generators)
        self.on_card = sums.device.type == "cuda"
        self.start_fn, self.step_fn = epoch_start, x_step
        self.captured = False
        self.capture_s = 0.0

    def run(self, k: int) -> List[List[float]]:
        """k epochs -> their [loss sum, accuracy sum] over the steps, read
        to the host once, at the end."""
        out = torch.empty((k, 2), dtype=torch.float32,
                          device=self.sums.device)
        warm = self.on_card and not self.captured
        if warm:  # the first epoch's Z/U step and first step, eagerly
            t0 = time.perf_counter()
            self.epoch_start()
            self.x_step()
            # the step first: its graph reads Z and U where the eager
            # Z/U step left them, and the Z/U step's graph writes there
            self.step_fn = _Graph(self.x_step, self.generators).replay
            self.start_fn = _Graph(self.epoch_start, self.generators).replay
            self.captured = True
            self.capture_s = time.perf_counter() - t0
        with _no_host_reads(self.on_card):
            for j in range(k):
                first = int(warm and j == 0)
                if not first:
                    self.start_fn()
                for _ in range(first, self.steps):
                    self.step_fn()
                out[j].copy_(self.sums)
        return out.tolist()
