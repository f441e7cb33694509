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

A parameter that got no gradient takes a zero one, as optax gives it: its
m and v decay, and a decayed leaf still loses lr_t * wd * p.

`grad_accum_steps` = k > 1 is optax.MultiSteps: `step()` is called each
micro-batch and keeps the running mean of the k gradients; the k-th call
applies one update and advances the schedule once. The schedule factor
and lr are taken in float32, as the JAX package computes them.

The update is multi-tensor (`torch._foreach_*` over each group) and reads
nothing to the host, so a CUDA graph can hold it: the lr comes from a
float32 table of lr * schedule(step) on the parameters' device, indexed
by an update counter there, and MultiSteps' micro-batch count lives there
too. `step()` is `update(applies())` and `advance(...)`: the device work,
then the host's counters (`group["step"]`, `group["mini_step"]`), which a
caller that replays a captured `update` advances itself after each
replay.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

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
        self.t_total = max(t_total, 0)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.max_grad_norm = max_grad_norm
        self.grad_accum_steps = grad_accum_steps
        for g in self.param_groups:
            g.setdefault("step", 0)
            g.setdefault("mini_step", 0)
        self._device_state = None  # counters and lr tables, made at need

    def lr_at(self, group, step: Optional[int] = None) -> float:
        """The lr of update `step` (default: the group's next),
        lr * schedule(step), in float32."""
        step = group["step"] if step is None else step
        return float(_F(group["lr"]) * _F(self.schedule(step)))

    def lr_table(self, group) -> np.ndarray:
        """`lr_at` of every update step up to the schedule's end, float32:
        past t_total the progress stays 1, so later steps take the last."""
        return np.asarray([self.lr_at(group, s)
                           for s in range(self.t_total + 1)], np.float32)

    def load_state_dict(self, state_dict) -> None:
        super().load_state_dict(state_dict)
        self._device_state = None  # the counters follow the loaded groups

    def _on_device(self, device: torch.device) -> dict:
        """The update counter, MultiSteps' micro-batch count and each
        group's lr table on `device`, from the host's counters."""
        if self._device_state is None:
            group = self.param_groups[0]
            self._device_state = {
                "step": torch.tensor(group["step"], dtype=torch.long,
                                     device=device),
                "micro": torch.tensor(float(group["mini_step"]),
                                      device=device),
                "lr": [torch.from_numpy(self.lr_table(g)).to(device)
                       for g in self.param_groups]}
        return self._device_state

    def _lr(self, dev: dict, index: int) -> torch.Tensor:
        """Group `index`'s lr at the device's update counter, 0-d."""
        table = dev["lr"][index]
        at = torch.clamp(dev["step"], max=table.numel() - 1)
        return table.index_select(0, at.view(1)).view(())

    @staticmethod
    def _with_grads(params: Sequence[torch.Tensor]):
        """(the parameters, their gradients): one that got none takes a
        zero one (held as its `.grad`), as optax gives it."""
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return list(params), [p.grad for p in params]

    def _clip(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each gradient scaled by min(1, max_grad_norm / max(its norm,
        1e-12))."""
        if self.max_grad_norm <= 0:
            return grads
        norms = torch.stack(torch._foreach_norm(grads))
        scale = torch.full_like(norms, self.max_grad_norm).div_(
            torch.clamp(norms, min=1e-12)).clamp_(max=1.0)
        return torch._foreach_mul(grads, list(scale.unbind(0)))

    def _state(self, p: torch.Tensor) -> dict:
        st = self.state[p]
        if not st:
            st["m"] = torch.zeros_like(p)
            st["v"] = torch.zeros_like(p)
            if self.grad_accum_steps > 1:
                st["acc"] = torch.zeros_like(p)
        return st

    def applies(self) -> bool:
        """Whether the next step applies an update (MultiSteps' k-th
        micro-batch)."""
        return self.param_groups[0]["mini_step"] == self.grad_accum_steps - 1

    def advance(self, apply: bool) -> None:
        """The host's counters after a step that applied or not."""
        for g in self.param_groups:
            g["step"] += int(apply)
            g["mini_step"] = (g["mini_step"] + 1) % self.grad_accum_steps

    @torch.no_grad()
    def update(self, apply: bool) -> None:
        """One step's device work: the micro-batch into the running mean
        (k > 1) and, where `apply`, the update; nothing read to the host."""
        k = self.grad_accum_steps
        b1, b2 = self.b1, self.b2
        dev = None
        for index, group in enumerate(self.param_groups):
            if not group["params"]:
                continue
            dev = dev or self._on_device(group["params"][0].device)
            params, grads = self._with_grads(group["params"])
            states = [self._state(p) for p in params]
            if k > 1:  # acc + (g - acc) / (n + 1), optax's running mean
                acc = [st["acc"] for st in states]
                delta = torch._foreach_sub(grads, acc)
                torch._foreach_div_(delta, dev["micro"] + 1)
                torch._foreach_add_(acc, delta)
                if not apply:
                    continue
                grads = acc
            grads = self._clip(grads)
            m = [st["m"] for st in states]
            v = [st["v"] for st in states]
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, grads, alpha=1 - b1)
            torch._foreach_mul_(v, b2)
            torch._foreach_addcmul_(v, grads, grads, value=1 - b2)
            u = torch._foreach_sqrt(v)
            torch._foreach_add_(u, self.eps)
            u = torch._foreach_div(m, u)
            if group["weight_decay"]:
                torch._foreach_add_(u, params, alpha=group["weight_decay"])
            torch._foreach_mul_(u, self._lr(dev, index))
            torch._foreach_sub_(params, u)
            if k > 1:
                torch._foreach_zero_(acc)
        if dev is None:
            return
        if k > 1:
            if apply:
                dev["micro"].zero_()
            else:
                dev["micro"].add_(1)
        if apply:
            dev["step"].add_(1)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        apply = self.applies()
        self.update(apply)
        self.advance(apply)
        return loss
