"""Optimizers and the per-step schedules (counterpart of the JAX package's
`train/optim.py`): the cosine with its optional linear warmup, the step
decay and the constant.

`momentum` matches the JAX package's optax chain `add_decayed_weights(wd)`
+ `sgd(momentum)`: the decay is added to every parameter's gradient (L2),
and the momentum buffer starts at the first gradient. `sgd` is the same
with Nesterov momentum (`sgd(momentum, nesterov=True)`; torch's Nesterov
update g + m * buf is optax's). `adamw` matches
`optax.adamw(schedule, weight_decay=wd)`: b1 0.9, b2 0.999, eps 1e-8 and
the decay lr * wd * p decoupled from the gradient, on every parameter.
`adam` matches `optax.adam(schedule)`: the same moments and no weight
decay at all.
With a clip, optax's chain starts with `clip_by_global_norm`, so the clip
sees the gradient of the loss (penalty included) before any decay: the
train loop runs torch's `clip_grad_norm_` on every parameter before
`opt.step()`, which adds the decay (torch divides by the norm + 1e-6,
optax by the norm).
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch

OPTIMIZERS = ("momentum", "adamw", "sgd", "adam")
SCHEDULES = ("cosine", "step", "constant")


WARMUP_INIT_LR = 1e-6  # the JAX package's warmup start


def cosine_lr(step: int, base_lr: float, total_steps: int, min_lr: float,
              warmup_steps: int = 0) -> float:
    """The JAX package's cosine schedule at `step` (from 0):
    optax.cosine_decay_schedule(base_lr, total_steps,
    alpha=min_lr/base_lr), or with `warmup_steps` > 0
    optax.warmup_cosine_decay_schedule(1e-6, base_lr, warmup_steps,
    total_steps, min_lr): linear from 1e-6 to base_lr over the warmup, then
    a cosine over the remaining total_steps - warmup_steps that ends at
    min_lr."""
    alpha = min_lr / base_lr
    if warmup_steps > 0:
        if step < warmup_steps:
            return (WARMUP_INIT_LR
                    + (base_lr - WARMUP_INIT_LR) * step / warmup_steps)
        step -= warmup_steps
        total = total_steps - warmup_steps
        if total <= 0:  # optax refuses the schedule too
            raise ValueError(f"{warmup_steps} warmup steps leave no cosine "
                             f"steps of {total_steps}")
    else:
        total = max(1, total_steps)
    t = min(step, total) / total
    return base_lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t)) + alpha)


def step_lr(step: int, base_lr: float, boundaries: Iterable[int],
            decay_rate: float) -> float:
    """optax.piecewise_constant_schedule(base_lr, {b: decay_rate for b in
    boundaries}) at `step`: the factors multiply, each from its boundary
    step itself."""
    lr = base_lr
    for b in boundaries:
        if step >= b:
            lr *= decay_rate
    return lr


def make_schedule(kind: str, base_lr: float, epochs: int,
                  steps_per_epoch: int, warmup_epochs: int = 0,
                  min_lr: float = 1e-5, decay_epochs: int = 30,
                  decay_rate: float = 0.1) -> Callable[[int], float]:
    """The learning rate by step (from 0), as the JAX package's
    `make_schedule` builds it: 'cosine' (`cosine_lr` over
    epochs x steps_per_epoch steps, with the warmup), 'step' (x decay_rate
    at every decay_epochs epochs, as many times as epochs // decay_epochs
    and at least once) or 'constant'."""
    if kind == "cosine":
        total = max(1, epochs * steps_per_epoch)
        warm = warmup_epochs * steps_per_epoch
        return lambda step: cosine_lr(step, base_lr, total, min_lr, warm)
    if kind == "step":
        bounds = [i * decay_epochs * steps_per_epoch
                  for i in range(1, max(1, epochs // decay_epochs) + 1)]
        return lambda step: step_lr(step, base_lr, bounds, decay_rate)
    if kind == "constant":
        return lambda step: base_lr
    raise ValueError(f"unknown schedule {kind!r}; choose from {SCHEDULES}")


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float, *,
                   opt: str = "momentum", momentum: float = 0.9,
                   weight_decay: float = 1e-4) -> torch.optim.Optimizer:
    if opt in ("momentum", "sgd"):
        return torch.optim.SGD(params, lr=lr, momentum=momentum,
                               weight_decay=weight_decay,
                               nesterov=opt == "sgd")
    if opt == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=weight_decay)
    if opt == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=0.0)
    raise ValueError(f"unknown optimizer {opt!r}; choose from {OPTIMIZERS}")
