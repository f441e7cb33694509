"""DenseNet for CIFAR (densenet40/100) and ImageNet (densenet121/201/264),
dense and Tucker-2 compressed (counterpart of the JAX package's
`models/densenet.py`).

CIFAR: a 3x3 stem `conv1` to 2 x growth channels, three dense blocks of
pre-activation layers (BN `bn1`, ReLU, 3x3 `conv1` to `growth`
channels, concatenated onto the input; 'block{b}.layer.{i}'), with a
reduction-0.5 transition between blocks (BN `trans{b}.bn1`, ReLU, 1x1
`trans{b}.conv1`, 2x2 average pool), then BN `bn1`, ReLU, the spatial mean
and a linear `fc`.

ImageNet (torchvision's names): a 7x7/2 stem `features.conv0`, BN
`features.norm0`, ReLU and a 3x3/2 max pool; dense blocks of bottleneck
layers 'features.denseblock{b}.denselayer{l}' (BN `norm1`, ReLU, 1x1
`conv1` to 4 x growth, BN `norm2`, ReLU, 3x3 `conv2` to growth,
concatenated onto the input), halving transitions
'features.transition{b}' (`norm`, ReLU, 1x1 `conv`, 2x2 average pool),
then `features.norm5`, ReLU, the mean and a linear `classifier`.

Each ImageNet dense layer is recomputed in the backward pass
(`torch.utils.checkpoint`), as the JAX package wraps it in `nn.remat`,
BN included. The JAX recompute leaves `batch_stats` alone; torch's re-runs
the forward, so its BatchNorms (`RematBatchNorm2d`) normalise by the batch
statistics alone while recomputing, and each running statistic is
updated once a step, in the forward. On a data mesh they become
`parallel/data_parallel.py::GlobalRematBatchNorm2d`, which normalises by
the global batch in both. NCHW activations, OIHW kernels;
BatchNorm uses torch momentum 0.1 (flax momentum 0.9) and eps 1e-5.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.hp import RankPlan
from ..configs.plans import build_tk_plan
from ..configs.resolver import get_rank_plan, register_plan
from .registry import register_model
from .substitute import kaiming_, make_conv

_recomputing = 0  # > 0 while a checkpoint recomputes a dense layer


@contextlib.contextmanager
def _recompute():
    global _recomputing
    _recomputing += 1
    try:
        yield
    finally:
        _recomputing -= 1


def recomputing() -> bool:
    """Whether a checkpoint is recomputing a dense layer now."""
    return _recomputing > 0


def _checkpoint_contexts():
    """`torch.utils.checkpoint`'s contexts: none for the forward, the
    recompute flag for the recompute."""
    return contextlib.nullcontext(), _recompute()


class RematBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm (momentum 0.1, eps 1e-5) that leaves its running
    statistics alone inside a checkpoint's recompute: there it normalises
    by the batch statistics, as the forward did, at momentum 0 (the same
    op, so it saves the tensors the forward saved) and without counting a
    batch."""

    def __init__(self, c: int):
        super().__init__(c, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and recomputing():
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, True, 0.0, self.eps)
        return super().forward(x)


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


def _stem(in_ch: int, out_ch: int, k: int, stride: int,
          generator: Optional[torch.Generator]) -> nn.Conv2d:
    conv = nn.Conv2d(in_ch, out_ch, k, stride, k // 2, bias=False)
    kaiming_(conv.weight, generator)
    return conv


def _classifier(in_f: int, num_classes: int,
                generator: Optional[torch.Generator]) -> nn.Linear:
    # LeCun normal on fan-in (untruncated) and a zero bias, as flax's Dense
    # default
    fc = nn.Linear(in_f, num_classes)
    nn.init.kaiming_normal_(fc.weight, nonlinearity="linear",
                            generator=generator)
    nn.init.zeros_(fc.bias)
    return fc


# --------------------------- CIFAR variant ---------------------------------

class CifarDenseLayer(nn.Module):
    def __init__(self, in_planes: int, growth: int, prefix: str,
                 plan: Optional[RankPlan], mode: str,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.bn1 = _bn(in_planes)
        self.conv1 = make_conv(in_planes, growth, 3, padding=1, plan=plan,
                               mode=mode, key=f"{prefix}.conv1.weight",
                               generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([x, self.conv1(F.relu(self.bn1(x)))], dim=1)


class CifarTransition(nn.Module):
    def __init__(self, in_planes: int, out_planes: int, prefix: str,
                 plan: Optional[RankPlan], mode: str,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.bn1 = _bn(in_planes)
        self.conv1 = make_conv(in_planes, out_planes, 1, plan=plan,
                               mode=mode, key=f"{prefix}.conv1.weight",
                               generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(self.conv1(F.relu(self.bn1(x))), 2, 2)


class DenseNetCifar(nn.Module):
    """NCHW input [B, 3, H, W] -> logits [B, num_classes] (float32); the
    basic (non-bottleneck) layers of densenet40 and densenet100."""

    def __init__(self, depth: int, growth: int, num_classes: int = 10,
                 reduction: float = 0.5, plan: Optional[RankPlan] = None,
                 mode: str = "chain",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        n = (depth - 4) // 3
        in_planes = 2 * growth
        self.conv1 = _stem(3, in_planes, 3, 1, generator)
        for b in (1, 2, 3):
            block = nn.Module()
            block.layer = nn.ModuleList()
            for i in range(n):
                block.layer.append(CifarDenseLayer(
                    in_planes, growth, f"block{b}.layer.{i}", plan, mode,
                    generator))
                in_planes += growth
            self.add_module(f"block{b}", block)
            if b < 3:
                out_planes = int(math.floor(in_planes * reduction))
                self.add_module(f"trans{b}", CifarTransition(
                    in_planes, out_planes, f"trans{b}", plan, mode,
                    generator))
                in_planes = out_planes
        self.bn1 = _bn(in_planes)
        self.fc = _classifier(in_planes, num_classes, generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """`generator` is taken for a common signature and not used: the
        network draws nothing at random."""
        y = self.conv1(x)
        for b in (1, 2, 3):
            for layer in getattr(self, f"block{b}").layer:
                y = layer(y)
            if b < 3:
                y = getattr(self, f"trans{b}")(y)
        y = F.relu(self.bn1(y)).mean(dim=(2, 3))
        # the head runs in float32 whatever the compute type
        with torch.autocast(y.device.type, enabled=False):
            return self.fc(y.float())


# --------------------------- ImageNet variant ------------------------------

class InetDenseLayer(nn.Module):
    def __init__(self, in_planes: int, growth: int, prefix: str,
                 plan: Optional[RankPlan], mode: str,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.norm1 = RematBatchNorm2d(in_planes)
        self.conv1 = make_conv(in_planes, 4 * growth, 1, plan=plan,
                               mode=mode, key=f"{prefix}.conv1.weight",
                               generator=generator)
        self.norm2 = RematBatchNorm2d(4 * growth)
        self.conv2 = make_conv(4 * growth, growth, 3, padding=1, plan=plan,
                               mode=mode, key=f"{prefix}.conv2.weight",
                               generator=generator)

    def _layer(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(F.relu(self.norm1(x)))
        y = self.conv2(F.relu(self.norm2(y)))
        return torch.cat([x, y], dim=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and torch.is_grad_enabled():
            return checkpoint(self._layer, x, use_reentrant=False,
                              context_fn=_checkpoint_contexts,
                              preserve_rng_state=False)
        return self._layer(x)


class InetTransition(nn.Module):
    def __init__(self, in_planes: int, prefix: str, plan: Optional[RankPlan],
                 mode: str, generator: Optional[torch.Generator]):
        super().__init__()
        self.norm = _bn(in_planes)
        self.conv = make_conv(in_planes, in_planes // 2, 1, plan=plan,
                              mode=mode, key=f"{prefix}.conv.weight",
                              generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(self.conv(F.relu(self.norm(x))), 2, 2)


class DenseNetInet(nn.Module):
    """NCHW input [B, 3, H, W] -> logits [B, num_classes] (float32)."""

    def __init__(self, block_config, growth: int = 32,
                 num_classes: int = 1000, plan: Optional[RankPlan] = None,
                 mode: str = "chain",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        in_planes = 2 * growth
        self.features = nn.Module()
        self.features.conv0 = _stem(3, in_planes, 7, 2, generator)
        self.features.norm0 = _bn(in_planes)
        self.n_blocks = len(block_config)
        for b, n in enumerate(block_config, start=1):
            block = nn.Module()
            for i in range(1, n + 1):
                block.add_module(f"denselayer{i}", InetDenseLayer(
                    in_planes, growth,
                    f"features.denseblock{b}.denselayer{i}", plan, mode,
                    generator))
                in_planes += growth
            self.features.add_module(f"denseblock{b}", block)
            if b < self.n_blocks:
                self.features.add_module(f"transition{b}", InetTransition(
                    in_planes, f"features.transition{b}", plan, mode,
                    generator))
                in_planes //= 2
        self.features.norm5 = _bn(in_planes)
        self.classifier = _classifier(in_planes, num_classes, generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """`generator` is taken for a common signature and not used: the
        network draws nothing at random."""
        f = self.features
        y = F.relu(f.norm0(f.conv0(x)))
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        for b in range(1, self.n_blocks + 1):
            for layer in getattr(f, f"denseblock{b}").children():
                y = layer(y)
            if b < self.n_blocks:
                y = getattr(f, f"transition{b}")(y)
        y = F.relu(f.norm5(y)).mean(dim=(2, 3))
        # the head runs in float32 whatever the compute type
        with torch.autocast(y.device.type, enabled=False):
            return self.classifier(y.float())


# the plans the JAX package registers (its `_register_plans`)
for _model in ("densenet40", "densenet100", "densenet121", "densenet201",
               "densenet264"):
    register_plan(_model, "tk", "2")(lambda m=_model: build_tk_plan(m, "2"))


def _plan(base: str, fmt: Optional[str], ratio: str, tt_type: str,
          plan: Optional[RankPlan]) -> Optional[RankPlan]:
    if fmt is not None and plan is None:
        return get_rank_plan(base, fmt, ratio, tt_type)
    return plan


def _cifar(depth: int, growth: int, base: str, *, num_classes: int = 10,
           fmt: Optional[str] = None, mode: str = "chain", ratio: str = "2",
           tt_type: str = "general", plan: Optional[RankPlan] = None,
           generator: Optional[torch.Generator] = None) -> DenseNetCifar:
    return DenseNetCifar(depth, growth, num_classes=num_classes,
                         plan=_plan(base, fmt, ratio, tt_type, plan),
                         mode=mode, generator=generator)


def _inet(block_config, base: str, *, num_classes: int = 1000,
          fmt: Optional[str] = None, mode: str = "chain", ratio: str = "2",
          tt_type: str = "general", plan: Optional[RankPlan] = None,
          generator: Optional[torch.Generator] = None) -> DenseNetInet:
    return DenseNetInet(block_config, num_classes=num_classes,
                        plan=_plan(base, fmt, ratio, tt_type, plan),
                        mode=mode, generator=generator)


@register_model
def densenet40(**kw) -> DenseNetCifar:
    return _cifar(40, 16, "densenet40", **kw)


@register_model
def densenet100(**kw) -> DenseNetCifar:
    return _cifar(100, 12, "densenet100", **kw)


@register_model
def densenet121(**kw) -> DenseNetInet:
    return _inet((6, 12, 24, 16), "densenet121", **kw)


@register_model
def densenet201(**kw) -> DenseNetInet:
    return _inet((6, 12, 48, 32), "densenet201", **kw)


@register_model
def densenet264(**kw) -> DenseNetInet:
    return _inet((6, 12, 64, 48), "densenet264", **kw)
