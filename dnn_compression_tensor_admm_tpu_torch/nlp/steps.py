"""The NLP training steps and eval forwards as the JAX package compiles them
(`jax.jit` of `t_step`, `stage1_step`, `stage2_step` and the eval steps in
`nlp/task_distill.py`, `step` in `nlp/general_distill.py`, `step` and
`predict` in `nlp/squad.py` there): each is one function that reads its
batch at a counter on the device, which the eager route calls and the
captured route replays from a CUDA graph (`train/capture.py`). Both routes
call the same function, so they cannot drift apart.

* `DeviceBatches`: the set on the device, gathered a batch at a time at
  `at`, a 0-d counter on the device, through `order`: the epoch's
  permutation (drawn by the host's `RandomState` in the JAX `_batches`
  order, the last partial batch dropped), uploaded once at the epoch's
  start, or a fixed order.
* `TrainLoop`: one optimizer step (the forward, any teacher's no-grad
  forward inside `loss_fn`, the backward, `BertAdam.update`), its loss
  written into an [n_steps] buffer that the host reads once an epoch.
  With `grad_accum_steps` k > 1 it keeps two steps, one that accumulates
  and one that accumulates and applies; the host knows the micro-batch
  index, so it picks which to call, and reads no flag back.
* `EvalLoop`: one no-grad forward, its outputs written at the batch's rows
  of buffers the host reads once a pass.

On a card each step's first call runs eagerly and is captured; every later
call replays it under `torch.cuda.set_sync_debug_mode("error")`, with the
dropout generator registered with the graph. A failed capture or replay
raises; the card never gives way to the eager route. On the CPU, and where
the caller asks for the eager reference loop, the same functions run
eagerly (`route`).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..data.device_pipeline import batch_rows_at
from ..train import capture
from .optimization import BertAdam


def route(device: torch.device, eager: bool, log: Callable) -> Optional[str]:
    """Why the run's steps run eagerly (said once), or None: captured."""
    why = "the eager reference loop" if eager else capture.eager_reason(device)
    if why:
        log(f"the NLP steps run eagerly ({why})")
    return why


class StepClock:
    """Wall ms a step after the first one (whose call primes and captures
    a step), the device synchronised at both ends."""

    def __init__(self, device: torch.device):
        self.device, self.n, self.t0 = device, 0, None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def tick(self) -> None:
        self.n += 1
        if self.n == 1:
            self._sync()
            self.t0 = time.perf_counter()

    def ms_per_step(self) -> Optional[float]:
        if self.n < 2:
            return None
        self._sync()
        return (time.perf_counter() - self.t0) * 1e3 / (self.n - 1)


class DeviceBatches:
    """`data` (tensors of equal length on the device) read `batch` rows at
    a time: step i takes `order[i * batch:(i + 1) * batch]`, i the device
    counter `at` (see the module docstring). `steps` batches a pass."""

    def __init__(self, data: Dict[str, torch.Tensor], batch: int,
                 n: Optional[int] = None):
        self.data, self.batch = data, batch
        device = next(iter(data.values())).device
        self.n = n if n is not None else len(next(iter(data.values())))
        self.steps = self.n // batch
        self.order = torch.zeros(self.n, dtype=torch.long, device=device)
        self.at = torch.zeros((), dtype=torch.long, device=device)

    def start(self, order: np.ndarray) -> None:
        """A pass in `order` (one upload), from its first batch."""
        self.order.copy_(torch.from_numpy(np.asarray(order, np.int64)))
        self.at.zero_()

    def next(self):
        """(the batch's slots in the pass [B], its rows of each tensor) at
        the counter; the caller advances `at`."""
        slots = batch_rows_at(self.at, self.n, self.batch)
        rows = self.order[slots]
        return slots, {k: v[rows] for k, v in self.data.items()}


class TrainLoop:
    """The optimizer step of one stage over `batches` (see the module
    docstring): `loss_fn(batch)` -> a 0-d loss whose backward reaches the
    parameters `opt` updates; `generators` are the dropout's."""

    def __init__(self, loss_fn: Callable[[Dict[str, torch.Tensor]],
                                         torch.Tensor],
                 opt: BertAdam, batches: DeviceBatches,
                 generators: Sequence[torch.Generator], why_eager):
        self.loss_fn, self.opt, self.batches = loss_fn, opt, batches
        self.losses = torch.zeros(batches.steps, device=batches.at.device)
        kinds = (False, True) if opt.grad_accum_steps > 1 else (True,)
        self.steps = {apply: capture.CapturedStep(
            lambda apply=apply: self.step(apply), generators,
            why_eager is None) for apply in kinds}

    def step(self, apply: bool) -> None:
        """One micro-batch: forward, backward and `opt.update(apply)`."""
        batches = self.batches
        _, b = batches.next()
        loss = self.loss_fn(b)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.update(apply)
        self.losses.index_copy_(0, batches.at.view(1), loss.detach().view(1))
        batches.at.add_(1)

    def epoch(self, rng: np.random.RandomState, clock: StepClock) -> float:
        """One pass in `rng`'s permutation -> the mean of its losses."""
        self.batches.start(rng.permutation(self.batches.n))
        for _ in range(self.batches.steps):
            apply = self.opt.applies()
            capture.call(self.steps[apply])
            self.opt.advance(apply)
            clock.tick()
        return float(self.losses.double().mean())

    def last_loss(self) -> float:
        return float(self.losses[-1])


class EvalLoop:
    """A no-grad forward `fn(batch)` -> {name: [B, ...]} over `batches`, in
    eval mode; `run(order)` -> each output's rows in the pass's order,
    [steps * B, ...] on the host."""

    def __init__(self, model: torch.nn.Module,
                 fn: Callable[[Dict[str, torch.Tensor]],
                              Dict[str, torch.Tensor]],
                 batches: DeviceBatches, why_eager):
        self.model, self.fn, self.batches = model, fn, batches
        self.out: Optional[Dict[str, torch.Tensor]] = None
        self.forward = capture.CapturedStep(self.step, (), why_eager is None)

    @torch.no_grad()
    def step(self) -> None:
        batches = self.batches
        slots, b = batches.next()
        out = self.fn(b)
        if self.out is None:  # at the first (eager) call, before a capture
            rows = batches.steps * batches.batch
            self.out = {k: torch.empty((rows, *v.shape[1:]), dtype=v.dtype,
                                       device=v.device)
                        for k, v in out.items()}
        for k, v in out.items():
            self.out[k].index_copy_(0, slots, v)
        batches.at.add_(1)

    def run(self, order: np.ndarray) -> Dict[str, np.ndarray]:
        self.model.eval()
        self.batches.start(order)
        for _ in range(self.batches.steps):
            capture.call(self.forward)
        if self.out is None:  # no whole batch
            return {}
        return {k: v.cpu().numpy() for k, v in self.out.items()}
