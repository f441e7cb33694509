"""ADMM engine: state, bucketed Z-projection, dual ascent, penalty.

* state: per-layer dual U (zeros) and auxiliary Z (= W); training starts
  with `admm_update(update_u=False)`, which sets Z to the projection of W.
* each epoch: Z <- proj(W + U); U += W - Z.
* each step: loss += 0.5 * rho * sum_l ||W_l - Z_l + U_l||^2 (or, in a
  custom loop, `admm_grad_add` adds its gradient to each `.grad`).

The plan's layers are bucketed by (kind, spec, shape); each bucket is
stacked into one [L, ...] tensor and projected at once. With
method='kernel' a Tucker-2 bucket (conv, or linear as K = 1) and a plain
SVD bucket of 1x1 convs or linears (as K = 1 at r0 = r1 = min(rank, O,
I): the top-r left and right singular subspaces give the truncated SVD) go
through the CUDA factor kernel (`ops/cuda/tucker_kernel.py`), and a TT
bucket through the batched TT-SVD sweep on the CUDA subspace kernel
(`ops/cuda/subspace_kernel.py`). On the card a bucket that a kernel's
gate refuses raises; on the CPU (where the kernel wrappers run their
plain versions) it goes layer by layer through `ops/tucker.py`,
`ops/ttd.py` or `ops/svd.py`, as every bucket does with another method
(`subspace`, `gram`, `svd` or `ns`: `ops/svd.py::truncated_left_sv`'s; an
SVD layer by exact SVD whatever the method, as the JAX package does).
U and Z are stored in each parameter's own layout (OIHW for convs,
[out, in] for linears); a TT projection works on the [O, kh*kw, I] view
of a conv and on the weight itself for a linear, an SVD one on a 1x1
conv's [O, I] view or a linear's weight.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple, Union

import torch

from ..configs.hp import RankPlan, SVDSpec, TKSpec, TTConvSpec, TTLinearSpec
from ..ops.cuda.subspace_kernel import tt_project_batched, tt_supported
from ..ops.cuda.tucker_kernel import kernel_supported, tucker2_project_batched
from ..ops.precision import full_f32
from ..ops.svd import svd_project
from ..ops.ttd import tt_project
from ..ops.tucker import tucker2_project
from ..parallel.dist import all_gather

METHODS = ("kernel", "subspace", "gram", "svd", "ns")


@dataclasses.dataclass
class AdmmState:
    """Flat name -> tensor maps for the duals U and the targets Z;
    `nonfinite` counts the layers whose last projection was not finite
    and kept their previous Z (a 0-d tensor, None before any step)."""
    u: Dict[str, torch.Tensor]
    z: Dict[str, torch.Tensor]
    nonfinite: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class _Group:
    """One bucket: all layers sharing a projection signature."""
    kind: str
    names: Tuple[str, ...]
    spec: object
    param_shape: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class ProjectionProgram:
    """Static description of the Z-step for one (model, plan) pair."""
    groups: Tuple[_Group, ...]
    names: Tuple[str, ...]


def _classify(spec, w: torch.Tensor) -> str:
    if isinstance(spec, TTConvSpec) and w.dim() == 4:
        return "tt_conv"
    if isinstance(spec, TTLinearSpec) and w.dim() == 2:
        return "tt_linear"
    if isinstance(spec, TKSpec) and w.dim() == 4:
        return "tk_conv"
    if isinstance(spec, TKSpec) and w.dim() == 2:
        return "tk_linear"
    if isinstance(spec, SVDSpec) and w.dim() == 4:
        if tuple(w.shape[2:]) != (1, 1):
            raise ValueError("an SVD projection targets 1x1 convs, not "
                             f"{tuple(w.shape)}")
        return "svd_conv"
    if isinstance(spec, SVDSpec) and w.dim() == 2:
        return "svd_linear"
    raise TypeError(f"{type(spec).__name__} does not apply to a "
                    f"{w.dim()}-d weight")


def build_program(params: Mapping[str, torch.Tensor],
                  plan: RankPlan) -> ProjectionProgram:
    """Bucket the plan's layers; a parameter takes part iff its name is a
    key of the plan."""
    buckets: Dict[tuple, list] = {}
    for name, w in params.items():
        spec = plan.spec(name)
        if spec is None:
            continue
        key = (_classify(spec, w), spec, tuple(w.shape))
        buckets.setdefault(key, []).append(name)
    matched = {n for names in buckets.values() for n in names}
    missing = set(plan.names()) - matched
    if missing:
        raise ValueError(f"plan names not found in params: {sorted(missing)}")
    groups = tuple(
        _Group(kind=k[0], spec=k[1], param_shape=k[2], names=tuple(v))
        for k, v in sorted(buckets.items(), key=lambda kv: kv[1][0]))
    return ProjectionProgram(groups=groups,
                             names=tuple(n for g in groups for n in g.names))


def admm_init(params: Mapping[str, torch.Tensor],
              program: ProjectionProgram) -> AdmmState:
    """U = 0, Z = W."""
    u, z = {}, {}
    for name in program.names:
        w = params[name].detach()
        u[name] = torch.zeros_like(w)
        z[name] = w.clone()
    return AdmmState(u=u, z=z)


def _project_one(g: _Group, w: torch.Tensor, *, method: str,
                 n_iter: int) -> torch.Tensor:
    """Project one weight (OIHW, or [out, in]) onto the group's Tucker-2,
    TT or SVD ranks."""
    if g.kind == "tt_linear":
        return tt_project(w, g.spec.tt_shapes, g.spec.tt_ranks, method=method)
    if g.kind == "tt_conv":
        o, i, kh, kw = w.shape
        t = w.permute(0, 2, 3, 1).reshape(o, kh * kw, i)
        z = tt_project(t, g.spec.tt_shapes, g.spec.tt_ranks, method=method)
        return z.reshape(o, kh, kw, i).permute(0, 3, 1, 2)
    # an SVD layer by exact SVD whatever the method, as in JAX
    if g.kind in ("svd_conv", "svd_linear"):
        return svd_project(w.reshape(w.shape[:2]), g.spec.rank).reshape(
            w.shape)
    sp = g.spec.clamped(w.shape)  # tk_conv and tk_linear: [O, I, ...]
    return tucker2_project(w, sp.out_rank, sp.in_rank, n_iter=n_iter,
                           method=method)


def tk_ranks(spec, shape) -> TKSpec:
    """The Tucker-2 ranks (r0, r1) that the kernel route solves a layer of
    logical shape [O, I, ...] at: a TKSpec clamped to the shape, and an
    SVD 1x1 conv or linear as K = 1 at r0 = r1 = min(rank, O, I)."""
    if isinstance(spec, SVDSpec):
        spec = TKSpec(spec.rank, spec.rank)
    return spec.clamped(shape)


def _project_group_kernel(g: _Group, ts: torch.Tensor,
                          n_iter: int) -> Optional[torch.Tensor]:
    """Kernel Z-step for one bucket ts [L, O, I, kh, kw] or [L, out, in]
    (a Tucker-2 linear, and an SVD 1x1 conv or linear at r0 = r1, as
    K = 1). Where the kernel's gate refuses the bucket: None for CPU
    tensors (the caller goes layer by layer), and ValueError on any other
    device."""
    l = ts.shape[0]
    if g.kind in ("tk_conv", "svd_conv"):
        _, o, i, kh, kw = ts.shape
        sp = tk_ranks(g.spec, (o, i, kh, kw))
        x = ts.permute(0, 3, 4, 1, 2).reshape(l, kh * kw, o, i).contiguous()
        if kernel_supported(x.shape, sp.out_rank, sp.in_rank):
            z = tucker2_project_batched(x, sp.out_rank, sp.in_rank,
                                        sweeps=max(1, n_iter // 3))
            return z.reshape(l, kh, kw, o, i).permute(0, 3, 4, 1, 2)
    elif g.kind in ("tk_linear", "svd_linear"):
        _, o, i = ts.shape
        sp = tk_ranks(g.spec, (o, i))
        x = ts[:, None].contiguous()  # [L, 1, O, I]
        if kernel_supported(x.shape, sp.out_rank, sp.in_rank):
            z = tucker2_project_batched(x, sp.out_rank, sp.in_rank,
                                        sweeps=max(1, n_iter // 3))
            return z[:, 0]
    else:
        # the TT view: a linear's [out, in] weight itself, a conv's
        # [O, kh*kw, I]
        view = ts if g.kind == "tt_linear" else ts.permute(0, 1, 3, 4, 2)
        shapes, ranks = g.spec.tt_shapes, g.spec.tt_ranks
        if tt_supported(l, view[0].numel(), shapes, ranks):
            z = tt_project_batched(view.reshape(l, -1), shapes, ranks,
                                   iters=max(8, n_iter)).reshape(view.shape)
            return z if g.kind == "tt_linear" else z.permute(0, 1, 4, 2, 3)
    if ts.device.type != "cpu":
        raise ValueError(
            f"the {g.kind} kernel's gate refuses the bucket "
            f"{len(g.names)} x {list(g.param_shape)} ({g.names[0]}, ...); "
            "choose another --admm-method")
    return None


def _finite_layers(z: torch.Tensor) -> torch.Tensor:
    """[L] bool: which layers of a stack are finite throughout."""
    return torch.isfinite(z.reshape(z.shape[0], -1)).all(dim=1)


def _finite_or_prev(z: torch.Tensor, z_prev: torch.Tensor) -> torch.Tensor:
    """Per layer, replace a non-finite projection by the previous Z (skip
    this update): late in training the solvers' Gram steps can go
    singular, and one poisoned layer would NaN the penalty."""
    ok = _finite_layers(z)
    return torch.where(ok.reshape((-1,) + (1,) * (z.dim() - 1)), z, z_prev)


def _zstep(g: _Group, ws: torch.Tensor, us: torch.Tensor,
           zs_prev: torch.Tensor, *, method: str, n_iter: int,
           update_u: bool):
    """The whole Z/U step of a stack of the bucket's layers [n, ...] ->
    (Z, U, ||W - Z|| [n], [n] whether the projection was non-finite and
    the layer kept its previous Z)."""
    x = ws + us
    zs = _project_group_kernel(g, x, n_iter) if method == "kernel" else None
    if zs is None:  # another method, or a CPU bucket the gate refuses
        eff = "subspace" if method == "kernel" else method
        zs = torch.stack([_project_one(g, t, method=eff, n_iter=n_iter)
                          for t in x])
    bad = ~_finite_layers(zs)
    zs = _finite_or_prev(zs, zs_prev)
    diffs = ws - zs
    norms = torch.linalg.vector_norm(diffs.reshape(len(zs), -1), dim=1)
    return zs, (us + diffs if update_u else us), norms, bad


def _gather_block(t: torch.Tensor, b: int, l: int) -> torch.Tensor:
    """Every rank's block t [n <= b, ...], each zero-padded to b layers,
    gathered in rank order, with the padding sliced away: [l, ...]."""
    blk = t.new_zeros((b, *t.shape[1:]))
    blk[:len(t)] = t
    return all_gather(blk).reshape(-1, *t.shape[1:])[:l]


@torch.no_grad()
@full_f32()
def admm_update(params: Mapping[str, torch.Tensor], state: AdmmState,
                program: ProjectionProgram, *, update_u: bool = True,
                method: str = "svd", n_iter: int = 10, mesh=None
                ) -> Tuple[AdmmState, Dict[str, torch.Tensor]]:
    """One Z/U step: Z <- proj(W + U); optionally U += W - Z.

    Returns (new_state, {name: ||W - Z||}) with 0-d tensors.

    With a `mesh` (`parallel/mesh.py`) of more than one rank the step is
    sharded over layers, as the JAX package's `_zstep_group_shardmap`:
    each bucket's [L] stack is cut into blocks of b = ceil(L / ranks)
    layers over the flattened mesh, and every rank runs the whole step on
    its own block alone: W + U, the projection (the kernel launched on
    the block's layers, none for a block of padding), the reconstruction,
    the guard, U and the norms. Three all-gathers per bucket (Z, U, and
    the norms with the guard's flags; two without `update_u`), each block
    zero-padded to b layers and the padding sliced away, give every rank
    the whole step. Each rank's layers come out bit for bit as the
    one-process step on its block alone computes them; against the
    one-process step on the whole stack they may differ in the last
    bits, since on the card a batched GEMM's and a row reduction's order
    of summation may follow how many matrices or rows it is given."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; choose from {METHODS}")
    sharded = mesh is not None and mesh.size > 1
    new_u, new_z = dict(state.u), dict(state.z)
    residuals: Dict[str, torch.Tensor] = {}
    nonfinite = 0
    for g in program.groups:
        l = len(g.names)
        lo, hi, b = mesh.block(l) if sharded else (0, l, l)
        names = g.names[lo:hi]
        if names:
            zs, us, norms, bad = _zstep(
                g, torch.stack([params[n].detach().float() for n in names]),
                torch.stack([state.u[n] for n in names]),
                torch.stack([state.z[n] for n in names]), method=method,
                n_iter=n_iter, update_u=update_u)
        else:  # a block of padding: nothing to compute
            zs = us = state.z[g.names[0]].new_zeros((0, *g.param_shape))
            norms = zs.new_zeros((0,))
            bad = norms.bool()
        if sharded:
            zs = _gather_block(zs, b, l)
            if update_u:
                us = _gather_block(us, b, l)
            flagged = _gather_block(torch.stack([norms, bad.float()], 1),
                                    b, l)
            norms, bad = flagged[:, 0], flagged[:, 1] > 0
        nonfinite = nonfinite + bad.sum()
        for j, n in enumerate(g.names):
            new_z[n] = zs[j]
            if update_u:
                new_u[n] = us[j]
            residuals[n] = norms[j]
    return AdmmState(u=new_u, z=new_z, nonfinite=nonfinite), residuals


@torch.no_grad()
def admm_update_(params: Mapping[str, torch.Tensor], state: AdmmState,
                 program: ProjectionProgram, **kw) -> Dict[str, torch.Tensor]:
    """`admm_update` written into `state`'s own tensors: its Z, U and
    `nonfinite` keep their addresses (a captured X-step reads them there),
    bit for bit `admm_update`'s values, with nothing read to the host.
    Returns the residuals {name: ||W - Z||} as 0-d tensors."""
    new, residuals = admm_update(params, state, program, **kw)
    if state.nonfinite is None:
        state.nonfinite = torch.zeros((), dtype=torch.long,
                                      device=new.nonfinite.device)
    state.nonfinite.copy_(new.nonfinite)
    for n in program.names:
        state.z[n].copy_(new.z[n])
        state.u[n].copy_(new.u[n])
    return residuals


def admm_penalty(params: Mapping[str, torch.Tensor], state: AdmmState,
                 program: ProjectionProgram,
                 rho: Union[float, torch.Tensor]) -> torch.Tensor:
    """0.5 * rho * sum_l ||W_l - Z_l + U_l||^2, differentiable in W. `rho`
    may be a 0-d float32 tensor, read on the device (a captured step then
    takes each epoch's value): bit for bit the float's penalty, since
    halving commutes with rounding to float32."""
    total = 0.0
    for name in program.names:
        d = params[name] - state.z[name] + state.u[name]
        total = total + torch.sum(d.float() ** 2)
    return 0.5 * rho * total


@torch.no_grad()
def admm_grad_add(params: Mapping[str, torch.Tensor], state: AdmmState,
                  program: ProjectionProgram, rho: float) -> None:
    """Add the penalty's gradient rho * (W - Z + U) to each target
    parameter's `.grad` (allocated where it is None): the gradient of
    `admm_penalty`, for custom loops that leave the penalty out of the
    loss. The training loop keeps the penalty in the loss."""
    for name in program.names:
        w = params[name]
        g = (rho * (w.float() - state.z[name] + state.u[name])).to(w.dtype)
        if w.grad is None:
            w.grad = g
        else:
            w.grad.add_(g)


def adjust_rho(epoch: int, epochs: int, init_rho: float,
               factor: float = 5.0) -> float:
    """Late-training rho boost (off by default in the reference): rho x 5
    in every epoch index past int(0.85 * epochs)."""
    return factor * init_rho if epoch > int(0.85 * epochs) else init_rho
