"""CIFAR ResNet-20/32/56 (option-A shortcut), dense, Tucker-2 and
Tensor-Train compressed.

3x3 stem to 16 channels, three stages of BasicBlocks at 16/32/64 with
stride-2 transitions, option-A shortcut (stride-2 subsample + zero-pad
channels), global average pool, linear head. NCHW activations, OIHW
kernels; state-dict names ('layer1.0.conv1.weight', ...) key the rank
plans. BatchNorm uses torch momentum 0.1 (flax momentum 0.9) and
eps 1e-5.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.hp import RankPlan
from ..configs.plans import build_tk_plan, build_tt_conv_plan
from ..configs.resolver import get_rank_plan, register_plan
from .registry import register_model
from .substitute import kaiming_, make_conv


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


class BasicBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int, prefix: str,
                 plan: Optional[RankPlan], mode: str,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.conv1 = make_conv(in_planes, planes, 3, stride=stride, padding=1,
                               plan=plan, mode=mode,
                               key=f"{prefix}.conv1.weight", generator=generator)
        self.bn1 = _bn(planes)
        self.conv2 = make_conv(planes, planes, 3, stride=1, padding=1,
                               plan=plan, mode=mode,
                               key=f"{prefix}.conv2.weight", generator=generator)
        self.bn2 = _bn(planes)
        self.pad = planes // 4 if (stride != 1 or in_planes != planes) else 0

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """`generator` is taken for a common signature and not used: the
        network draws nothing at random."""
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        sc = x
        if self.pad:
            # option-A shortcut: subsample, zero-pad channels
            sc = F.pad(x[:, :, ::2, ::2], (0, 0, 0, 0, self.pad, self.pad))
        return F.relu(y + sc)


class ResNetCifar(nn.Module):
    def __init__(self, num_blocks, num_classes: int = 10,
                 plan: Optional[RankPlan] = None, mode: str = "chain",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 16, 3, padding=1, bias=False)
        kaiming_(self.conv1.weight, generator)
        self.bn1 = _bn(16)
        in_planes = 16
        for stage, (planes, n) in enumerate(zip((16, 32, 64), num_blocks), 1):
            blocks = []
            for i in range(n):
                stride = 2 if (stage > 1 and i == 0) else 1
                blocks.append(BasicBlock(in_planes, planes, stride,
                                         f"layer{stage}.{i}", plan, mode,
                                         generator))
                in_planes = planes
            self.add_module(f"layer{stage}", nn.Sequential(*blocks))
        self.linear = nn.Linear(64, num_classes)
        kaiming_(self.linear.weight, generator)
        nn.init.zeros_(self.linear.bias)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """`generator` is taken for a common signature and not used: the
        network draws nothing at random."""
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.layer3(self.layer2(self.layer1(y)))
        y = y.mean(dim=(2, 3))
        # the head runs in float32 whatever the compute type
        with torch.autocast(y.device.type, enabled=False):
            return self.linear(y.to(self.linear.weight.dtype))


_STAGE_PLANES = {"layer1": 16, "layer2": 32, "layer3": 64}


def _cifar_out_channels(name: str) -> int:
    return _STAGE_PLANES[name.split(".")[0]]


# every ratio the reference names, for every depth; the table lookup
# raises a KeyError that lists what the JSON copy holds (it has no
# resnet20 table)
for _model in ("resnet20", "resnet32", "resnet56"):
    for _ratio in ("1.5", "2", "3", "5"):
        register_plan(_model, "tk", _ratio)(
            lambda m=_model, r=_ratio: build_tk_plan(m, r))
        register_plan(_model, "tt", _ratio)(
            lambda m=_model, r=_ratio: build_tt_conv_plan(
                m, r, "general", _cifar_out_channels))


def _build(num_blocks, model_base: str, *, num_classes: int = 10,
           fmt: Optional[str] = None, mode: str = "chain", ratio: str = "3",
           tt_type: str = "general", plan: Optional[RankPlan] = None,
           generator: Optional[torch.Generator] = None) -> ResNetCifar:
    if fmt is not None and plan is None:
        plan = get_rank_plan(model_base, fmt, ratio, tt_type)
    return ResNetCifar(num_blocks, num_classes=num_classes, plan=plan,
                       mode=mode, generator=generator)


@register_model
def resnet20(**kw) -> ResNetCifar:
    return _build((3, 3, 3), "resnet20", **kw)


@register_model
def resnet32(**kw) -> ResNetCifar:
    return _build((5, 5, 5), "resnet32", **kw)


@register_model
def resnet56(**kw) -> ResNetCifar:
    return _build((9, 9, 9), "resnet56", **kw)
