"""The data-parallel X-step's pieces (the JAX package's X-step on a
'data'-sharded batch, `train/engine.py:129-180`).

The JAX step is one program over the global batch: XLA reduces the loss,
the gradients and the BatchNorm statistics over the whole batch. Here each
data rank holds a slice of that batch, and three things make its step the
global one:

* `GlobalBatchNorm2d` normalises by the statistics of the global batch
  (the sums of every data rank's slice, all-reduced, and the same sums of
  the gradients in the backward), as flax's BatchNorm does on the sharded
  batch: one pass, E[x^2] - E[x]^2, in float32. Plain DDP would normalise
  each slice by its own statistics, as the reference's DDP does; the port
  is held to the JAX package. It is the port's own module, not torch's
  `SyncBatchNorm`, which refuses CPU tensors in a process group (the CPU
  tests hold this module against JAX) and takes Welford statistics, not
  flax's one pass. The ImageNet DenseNets' `RematBatchNorm2d`, recomputed
  in the backward, becomes a `GlobalRematBatchNorm2d`: XLA reduces over
  the global batch inside `nn.remat` too.
* `all_reduce_grads` averages the gradients over the data ranks (one
  all-reduce of all of them); each rank's loss is the mean over its slice
  plus the replicated ADMM penalty, so the mean is the global loss's
  gradient and the penalty's gradient is not scaled by the rank count.
* The caller draws the global batch and its augmentation on every rank
  from identically seeded generators and keeps its rows (`Mesh.rows`);
  streamed slices are first gathered into the global batch
  (`gather_rows`).
"""

from __future__ import annotations

from typing import Iterable

import torch
import torch.nn as nn

from ..models import densenet
from . import dist


class GlobalBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm over the global batch of `group`'s ranks (each holding an
    equal slice) in training; the running statistics in eval, as
    `nn.BatchNorm2d`. Parameters and buffers keep their names."""

    def __init__(self, bn: nn.BatchNorm2d, group, n_ranks: int):
        super().__init__(bn.num_features, eps=bn.eps, momentum=bn.momentum,
                         affine=bn.affine,
                         track_running_stats=bn.track_running_stats,
                         device=bn.running_mean.device)
        if bn.momentum is None or not bn.track_running_stats:
            raise ValueError("global BatchNorm needs a momentum and running "
                             "statistics")
        # the same parameter objects: an optimizer built on them goes on
        self.weight, self.bias = bn.weight, bn.bias
        self.running_mean, self.running_var = bn.running_mean, bn.running_var
        self.num_batches_tracked = bn.num_batches_tracked
        self.group, self.n_ranks = group, n_ranks

    def _stats(self, xf: torch.Tensor):
        """(mean, biased variance, values a channel holds) of the global
        batch: one pass over the rank's rows, the sums all-reduced."""
        c = xf.shape[1]
        dims = [0, *range(2, xf.dim())]
        sums = dist.all_reduce_sum_autograd(
            torch.cat([xf.sum(dims), (xf * xf).sum(dims)]), self.group)
        n = self.n_ranks * (xf.numel() // c)
        mean = sums[:c] / n
        return mean, torch.clamp(sums[c:] / n - mean * mean, min=0.0), n

    @torch.no_grad()
    def _track(self, mean: torch.Tensor, var: torch.Tensor, n: int) -> None:
        """Move the running statistics (the unbiased variance, as torch's)
        and count the batch."""
        m = self.momentum
        self.running_mean.mul_(1 - m).add_(m * mean)
        self.running_var.mul_(1 - m).add_(m * var * (n / max(n - 1, 1)))
        self.num_batches_tracked.add_(1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        xf = x.float()
        mean, var, n = self._stats(xf)
        self._track(mean, var, n)
        shape = (1, x.shape[1]) + (1,) * (x.dim() - 2)
        y = (xf - mean.reshape(shape)) * torch.rsqrt(var + self.eps).reshape(
            shape)
        y = y * self.weight.reshape(shape) + self.bias.reshape(shape)
        return y.to(x.dtype)


class GlobalRematBatchNorm2d(GlobalBatchNorm2d):
    """`GlobalBatchNorm2d` of a `RematBatchNorm2d`: inside a checkpoint's
    recompute it normalises by the global batch's statistics again (the
    same ops and all-reduce, so it saves the tensors the forward saved)
    and leaves the running statistics and the batch count alone, as the
    JAX package's `nn.remat` leaves `batch_stats`. Every rank recomputes
    the same layers in the same order of its backward, so the
    recompute's all-reduces pair up across the ranks as the forward's
    do."""

    def _track(self, mean: torch.Tensor, var: torch.Tensor, n: int) -> None:
        if not densenet.recomputing():
            super()._track(mean, var, n)


def convert_global_batchnorm(model: nn.Module, group, n_ranks: int
                             ) -> nn.Module:
    """Replace each `nn.BatchNorm2d` of `model` by a `GlobalBatchNorm2d`
    and each `RematBatchNorm2d` by a `GlobalRematBatchNorm2d` over `group`
    (in place; returns `model`). A BatchNorm of another class raises."""
    for name, child in model.named_children():
        if type(child) is nn.BatchNorm2d:
            setattr(model, name, GlobalBatchNorm2d(child, group, n_ranks))
        elif type(child) is densenet.RematBatchNorm2d:
            setattr(model, name, GlobalRematBatchNorm2d(child, group,
                                                        n_ranks))
        elif isinstance(child, nn.modules.batchnorm._BatchNorm):
            raise NotImplementedError(
                f"{type(child).__name__} ({name}) has no global-batch form; "
                "train this model on one data rank")
        else:
            convert_global_batchnorm(child, group, n_ranks)
    return model


@torch.no_grad()
def all_reduce_grads(params: Iterable[torch.nn.Parameter], group,
                     n_ranks: int) -> None:
    """Average the parameters' gradients over `group`'s `n_ranks` ranks
    with one all-reduce (parameters without a gradient are left out on
    every rank alike)."""
    grads = [p.grad for p in params if p.grad is not None]
    if n_ranks == 1 or not grads:
        return
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat, group)
    flat /= n_ranks
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """The data ranks' slices of a batch joined into the global batch, in
    data-index order (the JAX `make_global_batch_fn`'s role)."""
    g = dist.all_gather(t, group)
    return g.reshape(-1, *t.shape[1:])
