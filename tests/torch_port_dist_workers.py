"""Rank functions of the multi-rank CPU tests (`tests/test_torch_port_dist*.py`).

Each runs in a process of its own, started by the port's
`parallel.launch.spawn`, joins a gloo group through a rendezvous file,
and writes what it computed to `out_dir/rank{r}.pt`, which the tests
read. The ranks import torch and the port only, never JAX; the inputs
come from seeds (`zstep_inputs`, `xstep_inputs`), which the tests call
too for the one-process and JAX sides."""

import dataclasses
import os

import numpy as np
import torch

from dnn_compression_tensor_admm_tpu_torch.admm import engine as teng
from dnn_compression_tensor_admm_tpu_torch.configs import get_rank_plan
from dnn_compression_tensor_admm_tpu_torch.data.datasets import (dataset_info,
                                                                 load_dataset)
from dnn_compression_tensor_admm_tpu_torch.models import create_model
from dnn_compression_tensor_admm_tpu_torch.models.densenet import DenseNetInet
from dnn_compression_tensor_admm_tpu_torch.parallel import dist
from dnn_compression_tensor_admm_tpu_torch.parallel.data_parallel import (
    all_reduce_grads, convert_global_batchnorm)
from dnn_compression_tensor_admm_tpu_torch.parallel.mesh import make_mesh
from dnn_compression_tensor_admm_tpu_torch.train import (TrainConfig,
                                                         evaluate_model,
                                                         train_model)
from dnn_compression_tensor_admm_tpu_torch.train.losses import cross_entropy
from dnn_compression_tensor_admm_tpu_torch.train.optim import (cosine_lr,
                                                               make_optimizer)

RHO, LR, SMOOTHING = 1e-3, 0.1, 0.1
# the small ImageNet DenseNet of tests/test_torch_port_zoo_models.py
DENSENET_BLOCKS = (2, 2, 2, 2)
EVAL_IMAGES, EVAL_BATCH = 52, 16  # 52 = 3 x 16 + an odd tail of 4


def zstep_inputs(fmt: str):
    """ResNet32 @3x in `fmt` from seed 0: (params, program, state) with
    U = 0.01 N(0, 1) from numpy seed 1 and Z = W."""
    model = create_model("resnet32", generator=torch.Generator().manual_seed(0))
    params = dict(model.named_parameters())
    program = teng.build_program(params, get_rank_plan("resnet32", fmt, "3"))
    state = teng.admm_init(params, program)
    rng = np.random.RandomState(1)
    for n in program.names:
        state.u[n] = torch.from_numpy(
            (0.01 * rng.standard_normal(tuple(params[n].shape)))
            .astype(np.float32))
    return params, program, state


def block_program(program, mesh):
    """The rank's block of each bucket of `program` as a program of its
    own (a bucket whose block is all padding left out): what the rank's
    sharded Z/U step computes, for the one-process step to run alone."""
    groups = []
    for g in program.groups:
        lo, hi, _ = mesh.block(len(g.names))
        if hi > lo:
            groups.append(dataclasses.replace(g, names=g.names[lo:hi]))
    return teng.ProjectionProgram(
        groups=tuple(groups), names=tuple(n for g in groups for n in g.names))


def _xstep_inputs(model, plan, shape, classes):
    """(model, program, state, x, y): a batch of `shape` (NHWC float32)
    with labels below `classes`, and an ADMM state of `plan` with
    U = 0.01 N and Z = W + 0.05 N (numpy seed 2), so the penalty is not
    0."""
    params = dict(model.named_parameters())
    program = teng.build_program(params, plan)
    state = teng.admm_init(params, program)
    rng = np.random.RandomState(2)
    x = rng.standard_normal(shape).astype(np.float32)
    y = rng.randint(0, classes, shape[0]).astype(np.int64)
    for n in program.names:
        shape = tuple(params[n].shape)
        state.u[n] = torch.from_numpy(
            (0.01 * rng.standard_normal(shape)).astype(np.float32))
        state.z[n] = state.z[n] + torch.from_numpy(
            (0.05 * rng.standard_normal(shape)).astype(np.float32))
    return model, program, state, x, y


def xstep_inputs():
    """One ResNet32 TK@3x X-step's inputs: the model from seed 0 and a
    batch of 8 at 32 x 32 (`_xstep_inputs`)."""
    model = create_model("resnet32", generator=torch.Generator().manual_seed(0))
    return _xstep_inputs(model, get_rank_plan("resnet32", "tk", "3"),
                         (8, 32, 32, 3), 10)


def densenet_plan():
    """DenseNet121's TK@2x plan cut to the layers of a `DENSENET_BLOCKS`
    DenseNet (the first two of each block and the first transition)."""
    plan = get_rank_plan("densenet121", "tk", "2")
    names = dict(DenseNetInet(DENSENET_BLOCKS,
                              num_classes=1).named_parameters())
    return dataclasses.replace(plan, layers={
        n: s for n, s in plan.layers.items() if n in names})


def densenet_xstep_inputs():
    """One X-step's inputs of the ImageNet DenseNet at DENSENET_BLOCKS
    with `densenet_plan`: the model from seed 0 and a batch of 8 at
    64 x 64 (`_xstep_inputs`); its dense layers are recomputed in the
    backward."""
    model = DenseNetInet(DENSENET_BLOCKS,
                         generator=torch.Generator().manual_seed(0))
    return _xstep_inputs(model, densenet_plan(), (8, 64, 64, 3), 1000)


def xstep_buffers(model, program, state, x, y, mesh=None):
    """One SGD-momentum step on the batch (this rank's rows of it with a
    data mesh) with the penalty -> (this rank's loss, parameters after the
    step, buffers after it)."""
    params = dict(model.named_parameters())
    lo, hi = mesh.rows(len(x)) if mesh is not None else (0, len(x))
    if mesh is not None:
        convert_global_batchnorm(model, mesh.data_group, mesh.n_data)
    opt = make_optimizer(model.parameters(), cosine_lr(0, LR, 1, 1e-5))
    model.train()
    logits = model(torch.from_numpy(x[lo:hi]).permute(0, 3, 1, 2))
    loss = (cross_entropy(logits, torch.from_numpy(y[lo:hi]), SMOOTHING)
            + teng.admm_penalty(params, state, program, RHO))
    opt.zero_grad()
    loss.backward()
    if mesh is not None:
        all_reduce_grads(params.values(), mesh.data_group, mesh.n_data)
    opt.step()
    return (loss.item(), {k: p.detach().clone() for k, p in params.items()},
            {k: b.clone() for k, b in model.named_buffers()})


def xstep(model, program, state, x, y, mesh=None):
    """`xstep_buffers` with bn1's running mean for the buffers."""
    loss, after, buffers = xstep_buffers(model, program, state, x, y, mesh)
    return loss, after, buffers["bn1.running_mean"]


def train_config(**kw) -> TrainConfig:
    """ResNet20 TK@3x ADMM for 2 epochs x 3 steps at a global batch of 16
    on 128 synthetic images, float32, the kernel route, evaluated after
    epoch 2 on 32; per epoch, as a mesh runs it, so that one process's
    rows carry the Z/U step's residuals too."""
    return TrainConfig(model="resnet20", dataset="synthetic-cifar10",
                       synthetic_size=128, batch_size=16, epochs=2,
                       steps_per_epoch=3, eval_every=2,
                       epochs_per_dispatch=1, admm=True, fmt="tk",
                       ratio="3", admm_method="kernel", admm_hooi_iters=6,
                       lr=0.01, smoothing=0.1, compute_dtype=None,
                       device="cpu",
                       print_fn=lambda *a: None, **kw)


def eval_inputs():
    """(model, images, labels, info): ResNet20 from seed 3 in eval mode
    and EVAL_IMAGES synthetic test images."""
    model = create_model("resnet20", generator=torch.Generator().manual_seed(3))
    x, y, info = load_dataset("synthetic-cifar10", False, EVAL_IMAGES)
    return model.eval(), x, y, dataset_info("synthetic-cifar10")


def _join(rank, world, init_method):
    torch.set_num_threads(1)
    dist.init_distributed("cpu", init_method=init_method, rank=rank,
                          world_size=world)


def _save(out_dir, rank, out):
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def zstep_job(rank, world, init_method, out_dir):
    """The sharded Z/U step of ResNet32 TK@3x and TT@3x (kernel route; the
    plain versions on the CPU) over all `world` ranks, with the collectives
    it made; at 2 ranks also TK@3x by the 'subspace' method (n_iter 4) for
    the JAX comparison; then the evaluation over `world` data ranks."""
    _join(rank, world, init_method)
    try:
        out = {}
        mesh = make_mesh(n_layer=world)  # the Z/U step flattens the mesh
        for fmt, method, n_iter in (("tk", "kernel", 6), ("tt", "kernel", 6),
                                    *([("tk", "subspace", 4)]
                                      if world == 2 else [])):
            params, program, state = zstep_inputs(fmt)
            dist.reset_counts()
            s, r = teng.admm_update(params, state, program, update_u=True,
                                    method=method, n_iter=n_iter, mesh=mesh)
            out[fmt, method] = dict(z=s.z, u=s.u, res=r,
                                    nonfinite=int(s.nonfinite),
                                    counts=dist.counts(),
                                    buckets=len(program.groups))
        model, x, y, info = eval_inputs()
        out["eval"] = evaluate_model(model, x, y, info, batch_size=EVAL_BATCH,
                                     mesh=make_mesh(n_layer=1))
        _save(out_dir, rank, out)
    finally:
        dist.shutdown()


def train_job(rank, world, init_method, out_dir):
    """At 2 data ranks: one X-step (`xstep`) and a 2-epoch `train_model`
    run (`train_config`); and whether a --layer-shards of 3 is refused."""
    _join(rank, world, init_method)
    try:
        mesh = make_mesh(n_layer=1)
        out = {"xstep": xstep(*xstep_inputs(), mesh=mesh)}
        model, hist = train_model(train_config(), mesh=mesh)
        out["train"] = (hist, model.state_dict())
        try:
            make_mesh(n_layer=3)
            out["refused"] = None
        except ValueError as e:
            out["refused"] = str(e)
        _save(out_dir, rank, out)
    finally:
        dist.shutdown()


def densenet_job(rank, world, init_method, out_dir):
    """At 2 data ranks: one X-step of the DenseNet of
    `densenet_xstep_inputs`, its recomputed BatchNorms over the global
    batch (`xstep_buffers`)."""
    _join(rank, world, init_method)
    try:
        mesh = make_mesh(n_layer=1)
        _save(out_dir, rank, {"xstep": xstep_buffers(
            *densenet_xstep_inputs(), mesh=mesh)})
    finally:
        dist.shutdown()
