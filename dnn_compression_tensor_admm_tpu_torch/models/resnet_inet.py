"""ImageNet ResNet-18/34/50 (torchvision topology), dense, Tucker-2 and
Tensor-Train compressed (counterpart of the JAX package's
`models/resnet_inet.py`).

7x7/2 stem conv (padding 3), BN, ReLU and a 3x3/2 max pool (padding 1,
padded with -inf); four stages of BasicBlock (18/34) or Bottleneck v1.5
(50: the stride sits on the 3x3 `conv2`); a dense 1x1 downsample branch
(`downsample.0` conv, `downsample.1` BN) where the stride or the width
changes, never compressed; the spatial mean and a linear `fc` head in
float32. NCHW activations, OIHW kernels; state-dict names
('layer3.2.conv2.weight', ...) key the rank plans. BatchNorm uses torch
momentum 0.1 (flax momentum 0.9) and eps 1e-5.
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


def _downsample(in_ch: int, out_ch: int, stride: int,
                generator: Optional[torch.Generator]) -> nn.Sequential:
    conv = nn.Conv2d(in_ch, out_ch, 1, stride=stride, bias=False)
    kaiming_(conv.weight, generator)
    return nn.Sequential(conv, _bn(out_ch))


class BasicBlock(nn.Module):
    expansion = 1

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
        self.downsample = (_downsample(in_planes, planes, stride, generator)
                           if stride != 1 or in_planes != planes else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        sc = x if self.downsample is None else self.downsample(x)
        return F.relu(y + sc)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int, prefix: str,
                 plan: Optional[RankPlan], mode: str,
                 generator: Optional[torch.Generator]):
        super().__init__()
        out_ch = planes * self.expansion
        self.conv1 = make_conv(in_planes, planes, 1, plan=plan, mode=mode,
                               key=f"{prefix}.conv1.weight", generator=generator)
        self.bn1 = _bn(planes)
        self.conv2 = make_conv(planes, planes, 3, stride=stride, padding=1,
                               plan=plan, mode=mode,
                               key=f"{prefix}.conv2.weight", generator=generator)
        self.bn2 = _bn(planes)
        self.conv3 = make_conv(planes, out_ch, 1, plan=plan, mode=mode,
                               key=f"{prefix}.conv3.weight", generator=generator)
        self.bn3 = _bn(out_ch)
        self.downsample = (_downsample(in_planes, out_ch, stride, generator)
                           if stride != 1 or in_planes != out_ch else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        sc = x if self.downsample is None else self.downsample(x)
        return F.relu(y + sc)


class ResNet(nn.Module):
    """NCHW input [B, 3, H, W] -> logits [B, num_classes] (float32)."""

    def __init__(self, block, num_blocks, num_classes: int = 1000,
                 plan: Optional[RankPlan] = None, mode: str = "chain",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        kaiming_(self.conv1.weight, generator)
        self.bn1 = _bn(64)
        in_planes = 64
        for stage, (planes, n) in enumerate(zip((64, 128, 256, 512),
                                                num_blocks), 1):
            blocks = []
            for i in range(n):
                stride = 2 if (stage > 1 and i == 0) else 1
                blocks.append(block(in_planes, planes, stride,
                                    f"layer{stage}.{i}", plan, mode,
                                    generator))
                in_planes = planes * block.expansion
            self.add_module(f"layer{stage}", nn.Sequential(*blocks))
        self.fc = nn.Linear(in_planes, num_classes)
        kaiming_(self.fc.weight, generator)
        nn.init.zeros_(self.fc.bias)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """`generator` is taken for a common signature and not used: the
        network draws nothing at random."""
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        y = self.layer4(self.layer3(self.layer2(self.layer1(y))))
        y = y.mean(dim=(2, 3))
        # the head runs in float32 whatever the compute type
        with torch.autocast(y.device.type, enabled=False):
            return self.fc(y.float())


def _inet_out_channels(block_expansion: int):
    """A planned conv's output channels from its name: the stage's planes,
    times the expansion for a Bottleneck's `conv3`."""
    def fn(name: str) -> int:
        parts = name.split(".")
        planes = 64 * 2 ** (int(parts[0][len("layer"):]) - 1)
        if block_expansion == 4 and parts[2] == "conv3":
            return planes * 4
        return planes
    return fn


# every ratio the JAX package registers; the table lookup raises a
# KeyError that lists what the JSON copy holds
for _model, _exp in (("resnet18", 1), ("resnet34", 1), ("resnet50", 4)):
    for _ratio in ("2", "3", "4", "5", "10", "sc"):
        register_plan(_model, "tk", _ratio)(
            lambda m=_model, r=_ratio: build_tk_plan(m, r))
        for _tt_type in ("general", "special"):
            register_plan(_model, "tt", _ratio, _tt_type)(
                lambda m=_model, r=_ratio, t=_tt_type, e=_exp:
                build_tt_conv_plan(m, r, t, _inet_out_channels(e)))


def _build(block, num_blocks, model: str, *, num_classes: int = 1000,
           fmt: Optional[str] = None, mode: str = "chain", ratio: str = "2",
           tt_type: str = "general", plan: Optional[RankPlan] = None,
           generator: Optional[torch.Generator] = None) -> ResNet:
    if fmt is not None and plan is None:
        plan = get_rank_plan(model, fmt, ratio, tt_type)
    return ResNet(block, num_blocks, num_classes=num_classes, plan=plan,
                  mode=mode, generator=generator)


@register_model
def resnet18(**kw) -> ResNet:
    return _build(BasicBlock, (2, 2, 2, 2), "resnet18", **kw)


@register_model
def resnet34(**kw) -> ResNet:
    return _build(BasicBlock, (3, 4, 6, 3), "resnet34", **kw)


@register_model
def resnet50(**kw) -> ResNet:
    return _build(Bottleneck, (3, 4, 6, 3), "resnet50", **kw)
