"""Training and evaluation loops (counterpart of the JAX package's
`train/engine.py`).

One ADMM epoch is the Z/U step (`admm_update`) followed by
`steps_per_epoch` X-steps, each with the in-loss penalty (at 5 rho in the
epochs past 85% with `adjust_rho_late`) and, with `orthogonal`, the
factors' soft-orthogonality penalty at the same rho. A fine-tune may
distil from a frozen dense teacher, run in the same autocast. Batches come
from the device-resident dataset: an epoch permutation drawn on the
device, a contiguous slice of it per step, then crop, flip and
normalise on the device. The host reads back a few scalars per epoch.
Every model's forward takes that device generator; a ViT draws its drop
path from it, a ResNet ignores it.

With `ema_decay` > 0 an EMA shadow of the parameters follows each
optimizer step and is evaluated beside them (`ema_test_*`, with the live
BatchNorm buffers). With `checkpoint_dir` the whole train state
(`train/state.py`: model, optimizer, ADMM duals and targets, EMA, step,
the generators) is written after each epoch's row; `resume` restores it
and goes on at the next epoch, with the same batches, crops, flips, lr and
Z-steps as a run that never stopped.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..admm import (AdmmState, admm_init, admm_penalty, admm_update,
                    adjust_rho, build_program, orthogonal_penalty)
from ..configs.resolver import get_rank_plan
from ..data.datasets import DatasetInfo, load_dataset
from ..data.device_pipeline import (augment_batch, batch_at, normalize,
                                    random_crop_flip)
from ..models import create_model, parse_compressed_name
from ..utils.device import resolve_device
from .losses import DISTILLATION_TYPES, cross_entropy, distillation_loss
from .optim import make_schedule, make_train_optimizer
from .state import TrainState, load_train_state, save_train_state


@dataclasses.dataclass
class TrainConfig:
    model: str = "resnet32"
    dataset: str = "synthetic-cifar10"
    batch_size: int = 256
    epochs: int = 200
    steps_per_epoch: Optional[int] = None  # default: len(train) // batch
    num_classes: Optional[int] = None  # default: the dataset's
    data_dir: Optional[str] = None  # cifar10 | cifar100 | mnist files
    opt: str = "momentum"  # momentum | adamw | sgd (nesterov) | adam
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 1e-4
    sched: str = "cosine"  # cosine | step | constant
    min_lr: float = 1e-5
    warmup_epochs: int = 0  # linear warmup from 1e-6 before the cosine
    decay_epochs: int = 30  # step: x decay_rate every decay_epochs epochs
    decay_rate: float = 0.1
    clip_grad: Optional[float] = None  # clip by global norm before the step
    smoothing: float = 0.0
    # ADMM
    admm: bool = False
    rho: float = 0.001
    fmt: str = "tk"  # rank format of the ADMM plan: tk | tt | svd
    ratio: str = "3"
    tt_type: str = "general"
    admm_method: str = "kernel"  # CUDA kernels (Tucker-2 factor, TT subspace)
                                 # | subspace | gram | svd | ns
    admm_hooi_iters: int = 6
    adjust_rho_late: bool = False  # rho x 5 past 85% of the epochs
    verbose_admm: bool = False  # one per-layer residual row per epoch
    orthogonal: bool = False  # + orthogonal_penalty of the factors, at rho
    # distillation from a frozen teacher (its weights are required)
    distillation_type: str = "none"  # none | soft | hard
    distillation_alpha: float = 0.5
    distillation_tau: float = 1.0
    teacher_model: Optional[str] = None
    teacher_state_dict: Optional[Dict[str, torch.Tensor]] = None
    # misc
    ema_decay: float = 0.0  # > 0: an EMA shadow of the parameters
    eval_every: int = 1  # evaluate every N epochs and after the last
    checkpoint_dir: Optional[str] = None  # the train state after each epoch
    resume: Optional[str] = None  # a checkpoint_dir to go on from
    seed: int = 0
    compute_dtype: Optional[str] = "bfloat16"  # X-step forward/backward
    synthetic_size: Optional[int] = None
    log_path: Optional[str] = None
    device: str = "cuda"
    print_fn: Callable = print


def _autocast(device: torch.device, compute_dtype: Optional[str]):
    return torch.autocast(device.type, dtype=torch.bfloat16,
                          enabled=compute_dtype == "bfloat16")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


@torch.no_grad()
def evaluate_model(model: torch.nn.Module, x_np: np.ndarray, y_np: np.ndarray,
                   info: DatasetInfo, batch_size: int = 512,
                   compute_dtype: Optional[str] = None) -> Dict[str, float]:
    """Top-1/top-5 accuracy (%) and mean CE over a uint8 NHWC eval set,
    on the model's device."""
    dev = _model_device(model)
    images = torch.from_numpy(x_np).to(dev)
    labels = torch.from_numpy(y_np).long().to(dev)
    model.eval()
    t1 = torch.zeros((), device=dev)
    t5 = torch.zeros((), device=dev)
    ls = torch.zeros((), device=dev)
    for i in range(0, images.shape[0], batch_size):
        y = labels[i:i + batch_size]
        with _autocast(dev, compute_dtype):
            logits = model(normalize(images[i:i + batch_size], info.mean,
                                     info.std)).float()
        t1 += (logits.argmax(-1) == y).sum()
        top = logits.topk(min(5, logits.shape[-1]), dim=-1).indices
        t5 += (top == y[:, None]).any(-1).sum()
        ls += F.cross_entropy(logits, y, reduction="sum")
    n = images.shape[0]
    return {"acc1": 100.0 * t1.item() / n, "acc5": 100.0 * t5.item() / n,
            "loss": ls.item() / n}


@torch.no_grad()
def eval_runtime(model: torch.nn.Module, info: DatasetInfo,
                 batch_size: int = 256, iters: int = 50, warmup: int = 5,
                 compute_dtype: Optional[str] = None) -> Dict[str, float]:
    """Per-image inference latency over repeated forward passes."""
    dev = _model_device(model)
    x = torch.zeros((batch_size, len(info.mean), info.input_size,
                     info.input_size), device=dev)
    model.eval()
    with _autocast(dev, compute_dtype):
        for _ in range(warmup + 1):
            model(x)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            model(x)
        _sync(dev)
    dt = time.perf_counter() - t0
    return {"ms_per_image": 1000.0 * dt / (iters * batch_size),
            "images_per_s": iters * batch_size / dt}


@contextlib.contextmanager
def _swapped(params: Dict[str, torch.nn.Parameter],
             values: Dict[str, torch.Tensor]):
    """The parameters hold `values` inside the block (the buffers stay),
    their own values again after it."""
    saved = {n: p.detach().clone() for n, p in params.items()}
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(values[n])
    try:
        yield
    finally:
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(saved[n])


def _make_teacher(cfg: TrainConfig, num_classes: int,
                  device: torch.device) -> Optional[torch.nn.Module]:
    """The frozen teacher of a distilled run (None without distillation):
    `cfg.teacher_model` with `cfg.teacher_state_dict`, in eval mode and
    outside the optimizer's parameters."""
    if cfg.distillation_type not in DISTILLATION_TYPES:
        raise ValueError(f"unknown distillation type "
                         f"{cfg.distillation_type!r}; choose from "
                         f"{DISTILLATION_TYPES}")
    if cfg.distillation_type == "none":
        return None
    if cfg.teacher_model is None or cfg.teacher_state_dict is None:
        raise ValueError("distillation needs a teacher model and its weights "
                         "(--teacher-model, --teacher-path)")
    teacher = create_model(cfg.teacher_model, num_classes=num_classes)
    teacher.load_state_dict(cfg.teacher_state_dict)
    return teacher.to(device).eval().requires_grad_(False)


def train_model(cfg: TrainConfig, *,
                init_state_dict: Optional[Dict[str, torch.Tensor]] = None,
                max_epochs: Optional[int] = None):
    """Train `cfg.model` (ADMM with `cfg.admm`) -> (model, history).

    `init_state_dict` (e.g. from `decompose_params`) replaces the random
    init for the fine-tune phase. `max_epochs` stops the run after that
    many epochs (counted from the first, a resumed run's included) while
    the schedule and the rho boost still count `cfg.epochs`."""
    log = cfg.print_fn
    device = resolve_device(cfg.device)
    x_tr, y_tr, info = load_dataset(cfg.dataset, True, cfg.synthetic_size,
                                    cfg.data_dir)
    x_va, y_va, _ = load_dataset(
        cfg.dataset, False,
        cfg.synthetic_size // 4 if cfg.synthetic_size else None, cfg.data_dir)
    if len(x_tr) < cfg.batch_size:
        raise ValueError(f"{len(x_tr)} training images < batch {cfg.batch_size}")
    num_classes = cfg.num_classes or info.num_classes
    kw = ({"ratio": cfg.ratio, "tt_type": cfg.tt_type}
          if parse_compressed_name(cfg.model) else {})
    init_gen = torch.Generator().manual_seed(cfg.seed)
    model = create_model(cfg.model, num_classes=num_classes,
                         generator=init_gen, **kw)
    if init_state_dict is not None:
        model.load_state_dict(init_state_dict)
    model.to(device)
    params = dict(model.named_parameters())
    images = torch.from_numpy(x_tr).to(device)
    labels = torch.from_numpy(y_tr).long().to(device)
    steps = cfg.steps_per_epoch or max(1, len(x_tr) // cfg.batch_size)
    schedule = make_schedule(cfg.sched, cfg.lr, cfg.epochs, steps,
                             cfg.warmup_epochs, cfg.min_lr, cfg.decay_epochs,
                             cfg.decay_rate)
    # a Stiefel model ('stf*', the JAX package's rule) keeps its factors
    # on the manifold; the clip covers the other parameters
    opt, clipped = make_train_optimizer(
        model.named_parameters(), cfg.lr, opt=cfg.opt, momentum=cfg.momentum,
        weight_decay=cfg.weight_decay, stiefel=cfg.model.startswith("stf"))
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    teacher = _make_teacher(cfg, num_classes, device)
    # a copy of its own: the shadow never aliases the parameters
    ema = ({n: p.detach().clone() for n, p in params.items()}
           if cfg.ema_decay > 0 else None)

    program = admm = None
    if cfg.admm:
        plan = get_rank_plan(cfg.model, cfg.fmt, cfg.ratio, cfg.tt_type)
        program = build_program(params, plan)
        admm = admm_init(params, program)

    def train_state(step: int, epoch: int) -> TrainState:
        return TrainState(step=step, epoch=epoch, model=model.state_dict(),
                          optimizer=opt.state_dict(), admm=admm, ema=ema,
                          rng={"device": gen.get_state(),
                               "cpu": init_gen.get_state()})

    step = 0
    start_epoch = 0
    if cfg.resume:
        saved, extra = load_train_state(cfg.resume, train_state(0, -1))
        if extra and extra.get("model") != cfg.model:
            raise ValueError(f"{cfg.resume} holds a {extra.get('model')} run, "
                             f"not {cfg.model}")
        model.load_state_dict(saved.model)
        opt.load_state_dict(saved.optimizer)
        if saved.admm is not None:
            admm = AdmmState(
                u={n: t.to(device) for n, t in saved.admm.u.items()},
                z={n: t.to(device) for n, t in saved.admm.z.items()},
                nonfinite=(None if saved.admm.nonfinite is None
                           else saved.admm.nonfinite.to(device)))
        if saved.ema is not None:
            ema = {n: t.to(device) for n, t in saved.ema.items()}
        gen.set_state(saved.rng["device"])
        init_gen.set_state(saved.rng["cpu"])
        step, start_epoch = saved.step, saved.epoch + 1
        log(f"resumed from {cfg.resume} at epoch {start_epoch}")
    elif program is not None:
        admm, _ = admm_update(params, admm, program, update_u=False,
                              method=cfg.admm_method,
                              n_iter=cfg.admm_hooi_iters)

    history = []
    epochs = max_epochs or cfg.epochs
    for epoch in range(start_epoch, epochs):
        t0 = time.perf_counter()
        row = {"epoch": epoch + 1}
        rho = (adjust_rho(epoch, cfg.epochs, cfg.rho) if cfg.adjust_rho_late
               else cfg.rho)
        if cfg.admm:
            admm, residuals = admm_update(params, admm, program, update_u=True,
                                          method=cfg.admm_method,
                                          n_iter=cfg.admm_hooi_iters)
            names = sorted(residuals)
            vals = torch.stack([residuals[n] for n in names]).tolist()
            row["z_step_s"] = time.perf_counter() - t0
            row["rho"] = rho
            row["admm_nonfinite_layers"] = int(admm.nonfinite)
            row["admm_residual_total"] = float(sum(vals))
            row["admm_residuals"] = dict(zip(names, vals))
            if cfg.verbose_admm:
                log(json.dumps({"admm_residuals": {
                    n: round(v, 5) for n, v in row["admm_residuals"].items()}}))
        t_x = time.perf_counter()
        model.train()
        perm = torch.randperm(images.shape[0], device=device, generator=gen)
        loss_sum = torch.zeros((), device=device)
        acc_sum = torch.zeros((), device=device)
        for i in range(steps):
            idx = batch_at(perm, i, cfg.batch_size)
            yb = labels[idx]
            offsets, flips = random_crop_flip(cfg.batch_size, gen)
            x = augment_batch(images[idx], offsets, flips, mean=info.mean,
                              std=info.std)
            lr = schedule(step)
            for group in opt.param_groups:
                group["lr"] = lr
            with _autocast(device, cfg.compute_dtype):
                logits = model(x, generator=gen)
            loss = cross_entropy(logits, yb, cfg.smoothing)
            if teacher is not None:
                with torch.no_grad(), _autocast(device, cfg.compute_dtype):
                    t_logits = teacher(x)
                loss = distillation_loss(loss, logits, t_logits,
                                         cfg.distillation_type,
                                         cfg.distillation_alpha,
                                         cfg.distillation_tau)
            if program is not None:
                loss = loss + admm_penalty(params, admm, program, rho)
            if cfg.orthogonal:
                loss = loss + orthogonal_penalty(params, rho)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            if cfg.clip_grad is not None:
                torch.nn.utils.clip_grad_norm_(clipped, cfg.clip_grad)
            opt.step()
            if ema is not None:  # e <- d e + (1 - d) p, each product rounded
                with torch.no_grad():
                    shadow = [ema[n] for n in params]
                    live = list(params.values())
                    torch._foreach_mul_(shadow, cfg.ema_decay)
                    torch._foreach_add_(
                        shadow, torch._foreach_mul(live, 1 - cfg.ema_decay))
            step += 1
            loss_sum += loss.detach()
            acc_sum += (logits.argmax(-1) == yb).float().mean()
        train_loss = loss_sum.item() / steps
        row["x_step_s"] = time.perf_counter() - t_x
        if not math.isfinite(train_loss):
            raise FloatingPointError(f"loss is {train_loss}, stopping")
        row.update(train_loss=train_loss, train_acc=acc_sum.item() / steps,
                   epoch_time_s=time.perf_counter() - t0)
        if (epoch + 1) % cfg.eval_every == 0 or epoch + 1 == epochs:
            ev = evaluate_model(model, x_va, y_va, info,
                                compute_dtype=cfg.compute_dtype)
            row.update({f"test_{k}": v for k, v in ev.items()})
            if ema is not None:
                with _swapped(params, ema):
                    ev = evaluate_model(model, x_va, y_va, info,
                                        compute_dtype=cfg.compute_dtype)
                row.update({f"ema_test_{k}": v for k, v in ev.items()})
        history.append(row)
        log(json.dumps(row))
        if cfg.checkpoint_dir:
            save_train_state(cfg.checkpoint_dir, train_state(step, epoch),
                             {"model": cfg.model})
        if cfg.log_path:
            with open(cfg.log_path, "a") as f:
                f.write(json.dumps(row) + "\n")
    return model, history
