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

The Stiefel models ('stftkc_*') keep their 2-D first and last factors
orthonormal with `RiemannianSGD` (the JAX package's `riemannian_sgd`, the
reference's geoopt RiemannianSGD) beside the base optimizer on the rest
(`make_train_optimizer`).
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch

from ..ops.precision import full_f32

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


class LrTable:
    """The schedule's lr at every step of a run, float32 on the device,
    and a step counter on the device that indexes it: `advance()` writes
    the lr of the counter's step into `lr`, the 0-d tensor every param
    group holds (`attach`), and counts the step. Nothing is read to the
    host, so a step captured in a CUDA graph takes its own step's lr at
    each replay."""

    def __init__(self, schedule: Callable[[int], float], total_steps: int,
                 device: torch.device, step: int = 0):
        self.table = torch.tensor([schedule(s) for s in range(total_steps)],
                                  dtype=torch.float32, device=device)
        self.step = torch.tensor(step, dtype=torch.long, device=device)
        self.lr = self.table[min(step, total_steps - 1)].clone()

    def attach(self, optimizer) -> None:
        """Every param group of `optimizer` reads `lr` (again after a
        `load_state_dict`, which puts the saved value in its place)."""
        for group in optimizer.param_groups:
            group["lr"] = self.lr

    def advance(self) -> None:
        self.lr.copy_(self.table.index_select(0, self.step.view(1))[0])
        self.step += 1


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   lr: float | torch.Tensor, *, opt: str = "momentum",
                   momentum: float = 0.9,
                   weight_decay: float = 1e-4) -> torch.optim.Optimizer:
    """`opt` at `lr`, a float or a 0-d tensor (`LrTable.lr`). A tensor lr
    on a card is read there: SGD takes torch's fused kernel (the foreach
    one reads a tensor lr back to the host), Adam and AdamW
    `capturable=True`; on the CPU both take the single-tensor loop."""
    sgd_kw, adam_kw = {}, {}
    if isinstance(lr, torch.Tensor):
        card = lr.device.type == "cuda"
        sgd_kw = {"fused": True} if card else {"foreach": False}
        adam_kw = ({"capturable": True, "foreach": True} if card
                   else {"foreach": False})
    if opt in ("momentum", "sgd"):
        return torch.optim.SGD(params, lr=lr, momentum=momentum,
                               weight_decay=weight_decay,
                               nesterov=opt == "sgd", **sgd_kw)
    if opt == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=weight_decay, **adam_kw)
    if opt == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=0.0, **adam_kw)
    raise ValueError(f"unknown optimizer {opt!r}; choose from {OPTIMIZERS}")


# --- Riemannian SGD on the Stiefel manifold (the 'stf*' models) -----------

STIEFEL_SUFFIXES = ("first_factor", "last_factor")


def is_stiefel(name: str, p: torch.Tensor) -> bool:
    """A 2-D first or last factor: kept orthonormal on its manifold."""
    return name.endswith(STIEFEL_SUFFIXES) and p.dim() == 2


def tangent_project(w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The gradient g projected onto the Stiefel manifold's tangent space
    at w (canonical metric): g - w sym(w^T g), on the tall side (a wide
    factor through its transpose)."""
    tall = w.shape[0] >= w.shape[1]
    a, ga = (w, g) if tall else (w.T, g.T)
    wtg = a.T @ ga
    t = ga - a @ (0.5 * (wtg + wtg.T))
    return t if tall else t.T


def retract(w: torch.Tensor) -> torch.Tensor:
    """QR retraction onto the manifold, on the tall side, with the sign of
    R's diagonal moved into Q (a zero counts as +1)."""
    tall = w.shape[0] >= w.shape[1]
    q, r = torch.linalg.qr(w if tall else w.T)
    d = torch.sign(torch.diagonal(r))
    q = q * torch.where(d == 0, torch.ones_like(d), d)[None, :]
    return q if tall else q.T


class RiemannianSGD(torch.optim.Optimizer):
    """The JAX package's `riemannian_sgd`: the tangent-projected gradient
    into a momentum buffer (which starts at the first one), then
    w <- w + (retract(w - lr * m) - w). No weight decay."""

    def __init__(self, params, lr: float, momentum: float = 0.9):
        super().__init__(params, {"lr": lr, "momentum": momentum})

    @torch.no_grad()
    def step(self, closure=None):
        with full_f32():
            for group in self.param_groups:
                for p in group["params"]:
                    if p.grad is None:
                        continue
                    rg = tangent_project(p, p.grad)
                    state = self.state[p]
                    buf = state.get("momentum_buffer")
                    if buf is None:
                        state["momentum_buffer"] = buf = rg.clone()
                    else:
                        buf.mul_(group["momentum"]).add_(rg)
                    p.add_(retract(p - group["lr"] * buf) - p)


class WithStiefel:
    """A base optimizer on every other parameter and `RiemannianSGD` on the
    Stiefel factors, as the JAX package's `optax.multi_transform` routes
    them. `param_groups` holds both's groups, so the per-step lr reaches
    both; the state dict holds both's."""

    def __init__(self, base: torch.optim.Optimizer,
                 stiefel: RiemannianSGD):
        self.base, self.stiefel = base, stiefel

    @property
    def param_groups(self):
        return self.base.param_groups + self.stiefel.param_groups

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.base.zero_grad(set_to_none=set_to_none)
        self.stiefel.zero_grad(set_to_none=set_to_none)

    def step(self) -> None:
        self.base.step()
        self.stiefel.step()

    def state_dict(self) -> dict:
        return {"base": self.base.state_dict(),
                "stiefel": self.stiefel.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.base.load_state_dict(state["base"])
        self.stiefel.load_state_dict(state["stiefel"])


def make_train_optimizer(named_params, lr: float | torch.Tensor, *,
                         opt: str = "momentum",
                         momentum: float = 0.9, weight_decay: float = 1e-4,
                         stiefel: bool = False):
    """(optimizer, the parameters a clip by global norm covers). With
    `stiefel` the 2-D first and last factors take `RiemannianSGD` (same
    lr schedule and momentum, no weight decay, no clip: in the JAX package
    the clip sits inside the base branch of the multi-transform, so its
    norm covers the other parameters only); the rest takes `opt`."""
    named = list(named_params)
    on_manifold = [p for n, p in named if stiefel and is_stiefel(n, p)]
    base = [p for n, p in named if not (stiefel and is_stiefel(n, p))]
    optimizer = make_optimizer(base, lr, opt=opt, momentum=momentum,
                               weight_decay=weight_decay)
    if on_manifold:
        optimizer = WithStiefel(optimizer,
                                RiemannianSGD(on_manifold, lr, momentum))
    return optimizer, base
