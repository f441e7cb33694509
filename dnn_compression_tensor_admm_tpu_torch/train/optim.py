"""Optimizers and the per-step cosine schedule.

`momentum` matches the JAX package's optax chain `add_decayed_weights(wd)`
+ `sgd(momentum)`: the decay is added to every parameter's gradient (L2),
and the momentum buffer starts at the first gradient. `adamw` matches
`optax.adamw(schedule, weight_decay=wd)`: b1 0.9, b2 0.999, eps 1e-8 and
the decay lr * wd * p decoupled from the gradient, on every parameter.
"""

from __future__ import annotations

import math
from typing import Iterable

import torch

OPTIMIZERS = ("momentum", "adamw")


def cosine_lr(step: int, base_lr: float, total_steps: int,
              min_lr: float) -> float:
    """optax.cosine_decay_schedule(base_lr, total_steps, alpha=min_lr/base_lr)."""
    total = max(1, total_steps)
    alpha = min_lr / base_lr
    t = min(step, total) / total
    return base_lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t)) + alpha)


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float, *,
                   opt: str = "momentum", momentum: float = 0.9,
                   weight_decay: float = 1e-4) -> torch.optim.Optimizer:
    if opt == "momentum":
        return torch.optim.SGD(params, lr=lr, momentum=momentum,
                               weight_decay=weight_decay, nesterov=False)
    if opt == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=weight_decay)
    raise ValueError(f"unknown optimizer {opt!r}; choose from {OPTIMIZERS}")
