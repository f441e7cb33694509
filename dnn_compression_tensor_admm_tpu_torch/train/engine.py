"""Training and evaluation loops (counterpart of the JAX package's
`train/engine.py`).

One ADMM epoch is the Z/U step (`admm_update`) followed by
`steps_per_epoch` X-steps, each with the in-loss penalty (at 5 rho in the
epochs past 85% with `adjust_rho_late`) and, with `orthogonal`, the
factors' soft-orthogonality penalty at the same rho. A fine-tune may
distil from a frozen dense teacher, run in the same autocast. Batches come
from the device-resident dataset (`sampling`: a slice of an epoch
permutation drawn on the device, a slice of a shuffled copy, or uniform
draws; `repeated_aug` views of each row), or, with `shard_dir`, are
streamed from DCTA shards by the native loader through pinned buffers
(`shard_cache='hbm'` reads the shards whole into the device-resident
route). Then crop, flip, RandAugment, normalise and RandomErasing on the
device, and Mixup/CutMix against soft targets, every draw from that
device generator. The host reads back a few scalars per epoch. Every
model's forward takes that device generator; a ViT draws its drop path
from it, a ResNet ignores it. The lr of each step comes from a table on
the device (`optim.LrTable`), rho from a 0-d tensor filled before each
epoch, and the Z/U step writes Z and U in place (`admm_update_`).

The X-step is the JAX package's compiled step (`train/capture.py`): one
`CapturedStep` that reads the set's rows at a counter on the device, or
the streamed batch copied into static buffers, and adds its loss,
accuracy and failed Mixup draws to the epoch's sums. On the card it is
captured in a CUDA graph after one eager call and replayed: per epoch
between the eager Z/U steps, evaluations, logs and checkpoints (the sums
read once an epoch; `profile_dir` traces the first epoch's replays), or,
where the host observes nothing per epoch, in fused chunks of up to
`epochs_per_dispatch` epochs (the JAX package's `run_epochs`), each
epoch's Z/U step replayed too, the rows (`epoch`, `train_loss`,
`train_acc`, `epoch_time_s` = the chunk's time / k) read at the chunk's
end and the evaluation run after its last epoch. On the CPU and on a
mesh of several ranks the same step runs eagerly. `train_model(...,
eager=True)` runs the eager reference loop instead: each step on its own
batch tensors.

With `ema_decay` > 0 an EMA shadow of the parameters follows each
optimizer step and is evaluated beside them (`ema_test_*`, with the live
BatchNorm buffers). With `checkpoint_dir` the whole train state
(`train/state.py`: model, optimizer, ADMM duals and targets, EMA, step,
the generators) is written after each epoch's row; `resume` restores it
and goes on at the next epoch, with the same batches, crops, flips, lr and
Z-steps as a run that never stopped.

With a `mesh` (`parallel/mesh.py`, one process per rank) the run is the
JAX package's mesh run: `batch_size` is the global batch, which every rank
draws and augments from identically seeded generators (a streamed one is
gathered from the data ranks' strided loaders) and cuts along 'data'; the
BatchNorms normalise over the global batch and the gradients are averaged
over the data ranks (`parallel/data_parallel.py`), so n ranks compute what
one computes up to the order of the reductions. The Z/U step is sharded
over layers (`admm_update(mesh=)`), evaluation over the data ranks' rows,
and only the main process logs and writes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import json
import math
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..admm import (AdmmState, admm_init, admm_penalty, admm_update,
                    admm_update_, adjust_rho, build_program,
                    orthogonal_penalty)
from ..configs.resolver import get_rank_plan
from ..data.augment import (draw_mix, draw_rand_augment,
                            draw_random_erasing, mixup_cutmix)
from ..data.datasets import DatasetInfo, dataset_info, load_dataset
from ..data.device_pipeline import (DevicePrefetcher, augment_batch,
                                    batch_at_views, batch_rows_at, normalize,
                                    random_crop_flip, sample_batch,
                                    sample_batch_repeated, shuffle_epoch)
from ..data.records import read_shard, shard_sample_count, shard_shape
from ..models import create_model, parse_compressed_name
from ..models.vit import BatchRows
from ..parallel import dist
from ..parallel.data_parallel import (all_reduce_grads,
                                      convert_global_batchnorm, gather_rows)
from ..utils.device import resolve_device
from ..utils.profiling import PhaseTimer, trace
from . import capture
from .losses import (DISTILLATION_TYPES, cross_entropy, distillation_loss,
                     soft_target_cross_entropy)
from .optim import LrTable, make_schedule, make_train_optimizer
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
    mixup: float = 0.0  # Mixup alpha (0 = off)
    cutmix: float = 0.0  # CutMix alpha (0 = off)
    repeated_aug: int = 0  # views of each row in a batch (0 = off)
    randaug_magnitude: float = 0.0  # RandAugment's m (0 = off)
    randaug_std: float = 0.5  # its magnitude's std
    erase_prob: float = 0.0  # RandomErasing's probability
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
    sampling: str = "perm"  # perm | shuffle | replacement (SAMPLING)
    shard_dir: Optional[str] = None  # train-*.dcta / val-*.dcta, streamed
    shard_cache: Optional[str] = None  # 'hbm': the shards read whole onto
                                       # the device-resident route
    loader_workers: int = 4  # the native loader's threads
    profile_dir: Optional[str] = None  # a trace of the first epoch's X-step
    ema_decay: float = 0.0  # > 0: an EMA shadow of the parameters
    eval_every: int = 1  # evaluate every N epochs and after the last
    epochs_per_dispatch: int = 8  # epochs a fused chunk (train/capture.py)
    checkpoint_dir: Optional[str] = None  # the train state after each epoch
    resume: Optional[str] = None  # a checkpoint_dir to go on from
    seed: int = 0
    compute_dtype: Optional[str] = "bfloat16"  # X-step forward/backward
    synthetic_size: Optional[int] = None
    log_path: Optional[str] = None
    device: str = "cuda"
    print_fn: Callable = print


# 'perm': a slice of the epoch's permutation a step, then a gather;
# 'shuffle': a slice of a shuffled copy of the set (the same rows);
# 'replacement': uniform rows a step (any set smaller than a batch)
SAMPLING = ("perm", "shuffle", "replacement")


def _criterion(cfg: TrainConfig):
    """Soft-target CE against the mixed targets where Mixup or CutMix is
    on, else CE against the labels with `smoothing`."""
    if cfg.mixup > 0 or cfg.cutmix > 0:
        return soft_target_cross_entropy
    return lambda logits, y: cross_entropy(logits, y, cfg.smoothing)


def _load_shards(cfg: TrainConfig):
    """The shard route's sets: (train paths, val images or None, val
    labels or None); with `shard_cache='hbm'` the train set is read whole
    too, as (images, labels) in place of the paths."""
    def read(paths):
        parts = [read_shard(p) for p in paths]
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]))

    train = sorted(glob.glob(os.path.join(cfg.shard_dir, "train-*.dcta")))
    val = sorted(glob.glob(os.path.join(cfg.shard_dir, "val-*.dcta")))
    if not train:
        raise FileNotFoundError(f"no train-*.dcta shards in {cfg.shard_dir}")
    if cfg.shard_cache not in (None, "hbm"):
        raise ValueError(f"unknown shard cache {cfg.shard_cache!r}")
    x_va, y_va = read(val) if val else (None, None)
    return (read(train) if cfg.shard_cache == "hbm" else train), x_va, y_va


def _autocast(device: torch.device, compute_dtype: Optional[str],
              cache_enabled: bool = True):
    return torch.autocast(device.type, dtype=torch.bfloat16,
                          enabled=compute_dtype == "bfloat16",
                          cache_enabled=cache_enabled)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


@torch.no_grad()
def evaluate_model(model: torch.nn.Module, x_np: np.ndarray, y_np: np.ndarray,
                   info: DatasetInfo, batch_size: int = 512,
                   compute_dtype: Optional[str] = None,
                   mesh=None) -> Dict[str, float]:
    """Top-1/top-5 accuracy (%) and mean CE over a uint8 NHWC eval set,
    on the model's device. With a `mesh` of several data ranks, each
    evaluates the rows d::n_data in batches of batch_size / n_data and the
    sums are all-reduced over the data ranks (the JAX package's
    `_evaluate_on_mesh`): every sample counts once, an odd tail too."""
    dp = mesh is not None and mesh.n_data > 1
    if dp:
        x_np = x_np[mesh.data_index::mesh.n_data]
        y_np = y_np[mesh.data_index::mesh.n_data]
        batch_size = max(1, batch_size // mesh.n_data)
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
    if dp:
        sums = torch.stack([t1, t5, ls, torch.tensor(float(n), device=dev)])
        dist.all_reduce(sums, mesh.data_group)
        t1, t5, ls, n = sums[0], sums[1], sums[2], sums[3].item()
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
                max_epochs: Optional[int] = None, mesh=None,
                eager: bool = False):
    """Train `cfg.model` (ADMM with `cfg.admm`) -> (model, history).

    `init_state_dict` (e.g. from `decompose_params`) replaces the random
    init for the fine-tune phase. `max_epochs` stops the run after that
    many epochs (counted from the first, a resumed run's included) while
    the schedule and the rho boost still count `cfg.epochs`. `mesh`: this
    process's rank on a (data, layer) grid (see the module docstring);
    every rank returns the same history. `eager` runs every epoch through
    the eager reference loop: each step on its own batch tensors, rho a
    Python float, no CUDA graph and no fused chunk (what `chip_smoke.py`
    holds the captured routes against)."""
    main = mesh is None or mesh.rank == 0
    log = cfg.print_fn if main else (lambda *a, **k: None)
    dp = mesh is not None and mesh.n_data > 1
    rows = mesh.rows(cfg.batch_size) if dp else (0, cfg.batch_size)
    device = resolve_device(cfg.device)
    if cfg.sampling not in SAMPLING:
        raise ValueError(f"unknown sampling {cfg.sampling!r}; choose from "
                         f"{SAMPLING}")
    streaming = False
    if cfg.shard_dir is not None:
        info = dataset_info(cfg.dataset)
        train, x_va, y_va = _load_shards(cfg)
        streaming = cfg.shard_cache is None
        if not streaming:
            x_tr, y_tr = train
        held = shard_shape(train[0]) if streaming else x_tr.shape[1:]
        want = (info.input_size, info.input_size, len(info.mean))
        if tuple(held) != want:
            raise ValueError(f"the shards hold {tuple(held)} images; "
                             f"{cfg.dataset} takes {want}")
    else:
        x_tr, y_tr, info = load_dataset(cfg.dataset, True, cfg.synthetic_size,
                                        cfg.data_dir)
        x_va, y_va, _ = load_dataset(
            cfg.dataset, False,
            cfg.synthetic_size // 4 if cfg.synthetic_size else None,
            cfg.data_dir)
    num_classes = cfg.num_classes or info.num_classes
    kw = ({"ratio": cfg.ratio, "tt_type": cfg.tt_type}
          if parse_compressed_name(cfg.model) else {})
    init_gen = torch.Generator().manual_seed(cfg.seed)
    model = create_model(cfg.model, num_classes=num_classes,
                         generator=init_gen, **kw)
    if init_state_dict is not None:
        model.load_state_dict(init_state_dict)
    model.to(device)
    if dp:
        convert_global_batchnorm(model, mesh.data_group, mesh.n_data)
    params = dict(model.named_parameters())
    # on a mesh the ranks of layer index 0 read the shards (each data
    # rank its part) and the others take the global batch from them, as
    # the JAX mesh replicates it along 'layer': two loaders of the same
    # rows would hand them out in the order their threads finish
    reads = streaming and (mesh is None or mesh.layer_index == 0)
    if reads:
        from ..data.native_loader import NativeLoader
        paths, seed, stride, offset = dist.partition_shard_paths(
            train, mesh.data_index if dp else 0, mesh.n_data if dp else 1,
            cfg.seed)
        loader = NativeLoader(paths, rows[1] - rows[0],
                              workers=cfg.loader_workers, seed=seed,
                              drop_last=True, loop=True, stride=stride,
                              offset=offset)
        stream = DevicePrefetcher(loader, device)
        n_train = loader.total
    if streaming:
        if mesh is not None:  # the same steps on every rank
            n_train = sum(shard_sample_count(p) for p in train)
    else:
        images = torch.from_numpy(x_tr).to(device)
        labels = torch.from_numpy(y_tr).long().to(device)
        n_train = len(x_tr)
    steps = cfg.steps_per_epoch or max(1, n_train // cfg.batch_size)
    schedule = make_schedule(cfg.sched, cfg.lr, cfg.epochs, steps,
                             cfg.warmup_epochs, cfg.min_lr, cfg.decay_epochs,
                             cfg.decay_rate)
    # the lr of every step, read on the device by the optimizer; a
    # Stiefel model ('stf*', the JAX package's rule) keeps its factors on
    # the manifold, and the clip covers the other parameters
    lrs = LrTable(schedule, max(cfg.epochs, max_epochs or 0, 1) * steps,
                  device)
    opt, clipped = make_train_optimizer(
        model.named_parameters(), lrs.lr, opt=cfg.opt,
        momentum=cfg.momentum, weight_decay=cfg.weight_decay,
        stiefel=cfg.model.startswith("stf"))
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
        lrs.attach(opt)
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
        lrs.step.fill_(step)
        log(f"resumed from {cfg.resume} at epoch {start_epoch}")
    elif program is not None:
        admm, _ = admm_update(params, admm, program, update_u=False,
                              method=cfg.admm_method,
                              n_iter=cfg.admm_hooi_iters, mesh=mesh)

    criterion = _criterion(cfg)
    repeats = cfg.repeated_aug
    mix = cfg.mixup > 0 or cfg.cutmix > 0
    timer = PhaseTimer()
    # the step's rho, read on the device: filled before each epoch, so the
    # late boost reaches a captured step
    rho_t = torch.full((), cfg.rho, device=device)
    if not streaming:
        n = images.shape[0]
        mode = cfg.sampling if n >= cfg.batch_size else "replacement"

    def next_batch():
        """The streamed route's next global batch (uint8 NHWC images,
        labels), gathered from the data ranks' slices."""
        if reads:
            xb, yb = next(stream)
            if dp:
                xb = gather_rows(xb, mesh.data_group)
                yb = gather_rows(yb, mesh.data_group)
        if mesh is not None and mesh.n_layer > 1:
            if not reads:
                xb = torch.empty((cfg.batch_size, *held), dtype=torch.uint8,
                                 device=device)
                yb = torch.empty(cfg.batch_size, dtype=torch.long,
                                 device=device)
            src = mesh.data_index * mesh.n_layer  # its layer 0
            dist.broadcast(xb, src, mesh.layer_group)
            dist.broadcast(yb, src, mesh.layer_group)
        return xb, yb

    def epoch_batches():
        """The eager reference loop's batches: the epoch's global (uint8
        NHWC images, labels) a step, streamed, or picked from the
        device-resident set by the epoch's sampling mode ('replacement'
        where the set is smaller than a batch)."""
        if streaming:
            for _ in range(steps):
                yield next_batch()
            return
        if mode == "shuffle":
            step_images, step_labels = shuffle_epoch(images, labels, gen)
            for i in range(steps):
                yield (batch_at_views(step_images, i, cfg.batch_size, repeats),
                       batch_at_views(step_labels, i, cfg.batch_size, repeats))
            return
        if mode == "perm":
            perm = torch.randperm(n, device=device, generator=gen)
        for i in range(steps):
            if mode == "perm":
                idx = batch_at_views(perm, i, cfg.batch_size, repeats)
            elif repeats > 1:
                idx = sample_batch_repeated(n, gen, cfg.batch_size, repeats)
            else:
                idx = sample_batch(n, gen, cfg.batch_size)
            yield images[idx], labels[idx]

    def one_step(x, target, rho):
        """One optimizer step on augmented `x` -> (loss, logits), reading
        nothing to the host (a CUDA graph captures it); data-parallel, x
        is this rank's rows of the global batch and the loss its rows'
        mean plus the penalty."""
        lrs.advance()
        with _autocast(device, cfg.compute_dtype, cache_enabled=False):
            logits = model(x, generator=BatchRows(gen, cfg.batch_size,
                                                  rows[0]) if dp else gen)
        loss = criterion(logits, target)
        if teacher is not None:
            with torch.no_grad(), _autocast(device, cfg.compute_dtype,
                                            cache_enabled=False):
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
        if dp:
            all_reduce_grads(params.values(), mesh.data_group, mesh.n_data)
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
        return loss, logits

    def train_batch(xb, yb, rho):
        """Augment one global batch (uint8 NHWC) and take an optimizer
        step on it -> (loss, accuracy, Mixup/CutMix's failed Beta draws or
        None), 0-d on the device (of this rank's rows where
        data-parallel)."""
        b, h, w, c = xb.shape
        offsets, flips = random_crop_flip(b, gen)
        ra = er = None
        if cfg.randaug_magnitude > 0:
            ra = draw_rand_augment(b, gen, magnitude=cfg.randaug_magnitude,
                                   mag_std=cfg.randaug_std)
        if cfg.erase_prob > 0:
            er = draw_random_erasing((b, c, h, w), gen, prob=cfg.erase_prob)
        x = augment_batch(xb, offsets, flips, mean=info.mean, std=info.std,
                          randaug=ra, erase=er)
        target, failed = yb, None
        if mix:  # one lambda a batch, drawn on the device
            draws = draw_mix(gen, h, w, mixup_alpha=cfg.mixup,
                             cutmix_alpha=cfg.cutmix)
            x, target = mixup_cutmix(x, yb, draws, num_classes=num_classes,
                                     smoothing=cfg.smoothing)
            failed = draws.failed
        if dp:  # this rank's rows of the global batch
            x, target, yb = (t[rows[0]:rows[1]] for t in (x, target, yb))
        loss, logits = one_step(x, target, rho)
        return (loss.detach(), (logits.argmax(-1) == yb).float().mean(),
                failed)

    # the step both routes replay: its input at fixed addresses (the
    # streamed batch's buffers, or the set's rows at a counter on the
    # device: the epoch's permutation or shuffled copy drawn into buffers
    # of its own), its loss, accuracy and failed draws added to `sums`
    sums = torch.zeros(3, device=device)
    if streaming:
        batch = capture.StaticBatch()
    else:
        at = torch.zeros((), dtype=torch.long, device=device)  # its step
        order = (torch.empty(n, dtype=torch.long, device=device)
                 if mode == "perm" else None)
        shuffled = ((torch.empty_like(images), torch.empty_like(labels))
                    if mode == "shuffle" else None)

    def epoch_prep():
        """The epoch's sampling drawn into its buffers, its sums and row
        counter set to 0."""
        if not streaming:
            if mode == "perm":
                order.copy_(torch.randperm(n, device=device, generator=gen))
            elif mode == "shuffle":
                for buf, t in zip(shuffled, shuffle_epoch(images, labels,
                                                          gen)):
                    buf.copy_(t)
            at.zero_()
        sums.zero_()

    def x_step():
        if streaming:
            xb, yb = batch.x, batch.y
        else:
            if mode == "replacement":
                idx = (sample_batch_repeated(n, gen, cfg.batch_size, repeats)
                       if repeats > 1 else sample_batch(n, gen,
                                                        cfg.batch_size))
            else:  # `epoch_batches`' rows, at the device's counter
                idx = batch_rows_at(at, n, cfg.batch_size, repeats)
                if mode == "perm":
                    idx = order[idx]
            xs, ys = shuffled if mode == "shuffle" else (images, labels)
            xb, yb = xs[idx], ys[idx]
        loss, acc, failed = train_batch(xb, yb, rho_t)
        sums[0] += loss
        sums[1] += acc
        if failed is not None:
            sums[2] += failed
        if not streaming:
            at.add_(1)

    why_eager = "the eager reference loop" if eager else capture.eager_reason(
        device, mesh)
    if why_eager:  # logged once
        log(f"the X-step runs eagerly ({why_eager})")
    captured_step = capture.CapturedStep(x_step, (gen,), why_eager is None)

    def epoch_chunks():
        """The run's fused chunks (`train/capture.py`) on the
        device-resident set: each epoch's start the Z/U step written in
        place and `epoch_prep`, its steps `captured_step`."""
        def epoch_start():
            if program is not None:
                admm_update_(params, admm, program, update_u=True,
                             method=cfg.admm_method,
                             n_iter=cfg.admm_hooi_iters)
            epoch_prep()

        return capture.EpochChunks(epoch_start, captured_step, sums, steps)

    def evaluates(epoch: int) -> bool:
        return x_va is not None and ((epoch + 1) % cfg.eval_every == 0
                                     or epoch + 1 == epochs)

    def evaluate_into(row: dict) -> None:
        ev = evaluate_model(model, x_va, y_va, info,
                            compute_dtype=cfg.compute_dtype, mesh=mesh)
        row.update({f"test_{k}": v for k, v in ev.items()})
        if ema is not None:
            with _swapped(params, ema):
                ev = evaluate_model(model, x_va, y_va, info,
                                    compute_dtype=cfg.compute_dtype,
                                    mesh=mesh)
            row.update({f"ema_test_{k}": v for k, v in ev.items()})

    history = []
    epochs = max_epochs or cfg.epochs
    fuse = not eager and capture.chunkable(cfg, streaming)
    chunks = None
    fused_until = start_epoch
    try:
        for epoch in range(start_epoch, epochs):
            if epoch < fused_until:
                continue
            k = (capture.chunk_size(cfg, epoch, epochs, x_va is not None)
                 if fuse else 1)
            why = capture.exclusion(cfg, mesh, program) if k > 1 else None
            if why:  # logged once: the run goes on per epoch
                log(f"--epochs-per-dispatch: the per-epoch route ({why})")
                fuse, k = False, 1
            if k > 1:  # k epochs on the card, one read at the end
                chunks = chunks or epoch_chunks()
                t0 = time.perf_counter()
                model.train()
                rho_t.fill_(cfg.rho)
                sums_k = chunks.run(k)
                dt = (time.perf_counter() - t0) / k
                step += k * steps
                for j, (loss_sum, acc_sum, failed) in enumerate(sums_k):
                    train_loss = loss_sum / steps
                    if not math.isfinite(train_loss):
                        raise FloatingPointError(
                            f"loss is {train_loss}, stopping")
                    row = {"epoch": epoch + j + 1, "train_loss": train_loss,
                           "train_acc": acc_sum / steps, "epoch_time_s": dt}
                    if mix:
                        row["mix_failed_draws"] = int(failed)
                    if j == k - 1 and evaluates(epoch + j):
                        evaluate_into(row)
                    history.append(row)
                    log(json.dumps(row))
                fused_until = epoch + k
                continue
            t0 = time.perf_counter()
            row = {"epoch": epoch + 1}
            rho = (adjust_rho(epoch, cfg.epochs, cfg.rho)
                   if cfg.adjust_rho_late else cfg.rho)
            if cfg.admm:
                residuals = admm_update_(params, admm, program,
                                         update_u=True,
                                         method=cfg.admm_method,
                                         n_iter=cfg.admm_hooi_iters,
                                         mesh=mesh)
                names = sorted(residuals)
                vals = torch.stack([residuals[n] for n in names]).tolist()
                row["z_step_s"] = time.perf_counter() - t0
                timer.add("z_step", row["z_step_s"])
                row["rho"] = rho
                row["admm_nonfinite_layers"] = int(admm.nonfinite)
                row["admm_residual_total"] = float(sum(vals))
                row["admm_residuals"] = dict(zip(names, vals))
                if cfg.verbose_admm:
                    log(json.dumps({"admm_residuals": {
                        n: round(v, 5)
                        for n, v in row["admm_residuals"].items()}}))
            t_x = time.perf_counter()
            model.train()
            profiled = (cfg.profile_dir is not None and epoch == start_epoch
                        and main)
            traced = ((lambda: trace(cfg.profile_dir)) if profiled
                      else contextlib.nullcontext)
            if reads:
                host_s, batches = stream.host_s, stream.batches
                wait_s = stream.wait_s
            if eager:  # each step on its own batch tensors, rho a float
                epoch_sums = torch.zeros(3, device=device)
                with traced():
                    for xb, yb in epoch_batches():
                        loss, acc, failed = train_batch(xb, yb, rho)
                        epoch_sums[0] += loss
                        epoch_sums[1] += acc
                        if failed is not None:
                            epoch_sums[2] += failed
                traced_steps = steps
            else:
                rho_t.fill_(rho)
                epoch_prep()
                traced_steps = capture.run_epoch(
                    captured_step, steps,
                    (lambda: batch.load(*next_batch())) if streaming
                    else None, traced)
                epoch_sums = sums
            step += steps
            loss_sum, acc_sum, failed = epoch_sums.tolist()
            train_loss, train_acc = loss_sum / steps, acc_sum / steps
            if dp:  # the means over the data ranks
                means = dist.all_reduce_metrics(
                    {"loss": train_loss, "acc": train_acc}, mesh.data_group,
                    device)
                train_loss, train_acc = means["loss"], means["acc"]
            row["x_step_s"] = time.perf_counter() - t_x
            timer.add("x_step", row["x_step_s"])
            if reads:
                row["loader_host_ms_per_batch"] = (
                    1000 * (stream.host_s - host_s)
                    / max(1, stream.batches - batches))
                row["loader_wait_ms_per_step"] = (
                    1000 * (stream.wait_s - wait_s) / steps)
            if profiled:
                row["profile_trace"] = os.path.join(cfg.profile_dir,
                                                    "trace.json")
                row["profile_steps"] = traced_steps
            if mix:
                row["mix_failed_draws"] = int(failed)
            if not math.isfinite(train_loss):
                raise FloatingPointError(f"loss is {train_loss}, stopping")
            row.update(train_loss=train_loss, train_acc=train_acc,
                       epoch_time_s=time.perf_counter() - t0)
            if evaluates(epoch):
                evaluate_into(row)
            history.append(row)
            log(json.dumps(row))
            if cfg.checkpoint_dir and main:
                save_train_state(cfg.checkpoint_dir, train_state(step, epoch),
                                 {"model": cfg.model})
            if cfg.log_path and main:
                with open(cfg.log_path, "a") as f:
                    f.write(json.dumps(row) + "\n")
    finally:
        if reads:
            stream.close()
            loader.close()
    if cfg.profile_dir and main:
        timer.log(log)
    return model, history
