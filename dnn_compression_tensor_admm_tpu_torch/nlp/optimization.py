"""BertAdam and its warmup schedules (counterpart of the JAX package's
`nlp/optimization.py`; the reference's
xcompression/transformer/optimization.py:35-301).

BertAdam differs from AdamW in three ways that change the result:

* no bias correction: m and v are used raw from the first step;
* each parameter's gradient is clipped to `max_grad_norm` by its own L2
  norm (so every flax leaf is a parameter of its own here);
* decoupled weight decay added to the Adam direction before the lr:
  p -= lr_t * (m / (sqrt(v) + eps) + wd * p), skipped for the flax leaves
  named 'bias' and 'scale' (torch: every `bias`, and a LayerNorm's
  `weight`), as `no_decay_names` lists them.

`grad_accum_steps` = k > 1 is optax.MultiSteps: `step()` is called each
micro-batch and keeps the running mean of the k gradients; the k-th call
applies one update and advances the schedule once. The schedule factor
and lr are taken in float32, as the JAX package computes them.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

_F = np.float32


def _progress(step: int, t_total: int):
    return np.minimum(_F(step) / _F(max(1, t_total)), _F(1.0))


def warmup_linear(warmup: float, t_total: int) -> Callable[[int], float]:
    """0 -> 1 linearly over the `warmup` fraction, then 1 -> 0 linearly."""
    def fn(step):
        p = _progress(step, t_total)
        if p < _F(warmup):
            return p / _F(max(warmup, 1e-8))
        return np.maximum((p - _F(1.0)) / _F(min(warmup - 1.0, -1e-8)), _F(0))
    return fn


def warmup_constant(warmup: float, t_total: int) -> Callable[[int], float]:
    """0 -> 1 linearly over `warmup`, then 1."""
    def fn(step):
        p = _progress(step, t_total)
        return p / _F(max(warmup, 1e-8)) if p < _F(warmup) else _F(1.0)
    return fn


def warmup_cosine(warmup: float, t_total: int,
                  cycles: float = 0.5) -> Callable[[int], float]:
    """0 -> 1 linearly over `warmup`, then a cosine decay."""
    def fn(step):
        p = _progress(step, t_total)
        if p < _F(warmup):
            return p / _F(max(warmup, 1e-8))
        q = (p - _F(warmup)) / _F(max(1.0 - warmup, 1e-8))
        return _F(0.5) * (_F(1.0) + np.cos(_F(math.pi * cycles * 2.0) * q))
    return fn


def warmup_cosine_hard_restarts(warmup: float, t_total: int,
                                cycles: float = 1.0) -> Callable[[int], float]:
    """A cosine with `cycles` hard restarts after the warmup."""
    assert cycles >= 1.0

    def fn(step):
        p = _progress(step, t_total)
        if p < _F(warmup):
            return p / _F(max(warmup, 1e-8))
        q = (p - _F(warmup)) / _F(max(1.0 - warmup, 1e-8))
        return _F(0.5) * (_F(1.0) + np.cos(_F(math.pi) * ((_F(cycles) * q)
                                                         % _F(1.0))))
    return fn


def _constant(warmup, t_total):
    return lambda step: _F(1.0)


SCHEDULES = {
    None: _constant,
    "none": _constant,
    "warmup_linear": warmup_linear,
    "warmup_constant": warmup_constant,
    "warmup_cosine": warmup_cosine,
    "warmup_cosine_hard_restarts": warmup_cosine_hard_restarts,
}


def no_decay_names(model: nn.Module) -> List[str]:
    """Parameters that take no weight decay: those whose flax leaf is
    'bias' or 'scale' (a LayerNorm's weight)."""
    out = []
    for mname, module in model.named_modules():
        for pname, _ in module.named_parameters(recurse=False):
            if pname == "bias" or isinstance(module, nn.LayerNorm):
                out.append(f"{mname}.{pname}" if mname else pname)
    return out


def param_groups(model: nn.Module, weight_decay: float = 0.01) -> List[Dict]:
    """The decayed and the undecayed parameters, as BertAdam's groups."""
    skip = set(no_decay_names(model))
    named = list(model.named_parameters())
    return [{"params": [p for n, p in named if n not in skip],
             "weight_decay": weight_decay},
            {"params": [p for n, p in named if n in skip],
             "weight_decay": 0.0}]


class BertAdam(torch.optim.Optimizer):
    def __init__(self, params, lr: float, *,
                 schedule: Optional[str] = "warmup_linear",
                 warmup: float = -1.0, t_total: int = -1,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
                 weight_decay: float = 0.01, max_grad_norm: float = 1.0,
                 grad_accum_steps: int = 1):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay))
        # with t_total <= 0 the lr stays the base lr (reference `get_lr`)
        self.schedule = (SCHEDULES[schedule](max(warmup, 0.0), t_total)
                         if t_total > 0 else _constant(0, 0))
        self.b1, self.b2, self.eps = b1, b2, eps
        self.max_grad_norm = max_grad_norm
        self.grad_accum_steps = grad_accum_steps
        for g in self.param_groups:
            g.setdefault("step", 0)
            g.setdefault("mini_step", 0)

    def lr_at(self, group) -> float:
        """This update's lr, lr * schedule(step), in float32."""
        return float(_F(group["lr"]) * _F(self.schedule(group["step"])))

    def _clip(self, g: torch.Tensor) -> torch.Tensor:
        if self.max_grad_norm <= 0:
            return g
        n = torch.linalg.vector_norm(g.float())
        return g * torch.clamp(self.max_grad_norm / torch.clamp(n, min=1e-12),
                               max=1.0)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        k = self.grad_accum_steps
        b1, b2 = self.b1, self.b2
        for group in self.param_groups:
            n_acc = group["mini_step"]
            emit = n_acc == k - 1
            lr_t = self.lr_at(group)
            wd = group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["m"] = torch.zeros_like(p)
                    st["v"] = torch.zeros_like(p)
                    if k > 1:
                        st["acc"] = torch.zeros_like(p)
                g = p.grad
                if k > 1:
                    # the running mean of the micro-batches' gradients
                    acc = st["acc"]
                    acc.copy_(acc + (g - acc) / (n_acc + 1))
                    if not emit:
                        continue
                    g = acc
                g = self._clip(g)
                m, v = st["m"], st["v"]
                m.copy_(b1 * m + (1 - b1) * g)
                v.copy_(b2 * v + (1 - b2) * g * g)
                u = m / (torch.sqrt(v) + self.eps)
                if wd:
                    u = u + wd * p
                p.add_(-lr_t * u)
                if k > 1:
                    st["acc"].zero_()
            if emit:
                group["step"] += 1
            group["mini_step"] = (n_acc + 1) % k
        return loss
