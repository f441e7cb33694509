"""SGD with momentum and L2, and the per-step cosine schedule.

Matches the JAX package's optax chain `add_decayed_weights(wd)` +
`sgd(momentum)`: the decay is added to every parameter's gradient
(L2), and the momentum buffer starts at the first gradient.
"""

from __future__ import annotations

import math
from typing import Iterable

import torch


def cosine_lr(step: int, base_lr: float, total_steps: int,
              min_lr: float) -> float:
    """optax.cosine_decay_schedule(base_lr, total_steps, alpha=min_lr/base_lr)."""
    total = max(1, total_steps)
    alpha = min_lr / base_lr
    t = min(step, total) / total
    return base_lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t)) + alpha)


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float, *,
                   momentum: float = 0.9,
                   weight_decay: float = 1e-4) -> torch.optim.SGD:
    return torch.optim.SGD(params, lr=lr, momentum=momentum,
                           weight_decay=weight_decay, nesterov=False)
