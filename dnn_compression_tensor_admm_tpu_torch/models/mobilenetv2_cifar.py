"""MobileNetV2 for CIFAR, dense and plain-SVD or Tucker-2 compressed
(counterpart of the JAX package's `models/mobilenetv2_cifar.py`).

3x3 stem to 32 channels at stride 1, 17 BaseBlocks (expand 1x1 `conv1`,
depthwise 3x3 `conv2`, project 1x1 `conv3`; names
'bottlenecks.N.conv{1,2,3}'), a 1x1 head `conv1` to 1280 channels, a
spatial mean and a linear `fc` head. NCHW activations, OIHW kernels; the
rank tables key 'bottlenecks.N.conv{1,3}.weight' and 'conv1.weight', so
the 1x1 convs and the head are the compression targets and the depthwise
convs never are. ReLU6 after every BN but the projection's; BatchNorm
uses torch momentum 0.1 (flax momentum 0.9) and eps 1e-5.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.hp import RankPlan
from ..configs.plans import build_svd_plan, build_tk_plan
from ..configs.resolver import get_rank_plan, register_plan
from .registry import register_model
from .substitute import kaiming_, make_conv

# (in, out, expansion t, downsample), the JAX package's `_BLOCKS`
BLOCKS = [(32, 16, 1, False), (16, 24, 6, False), (24, 24, 6, False),
          (24, 32, 6, False), (32, 32, 6, False), (32, 32, 6, False),
          (32, 64, 6, True), (64, 64, 6, False), (64, 64, 6, False),
          (64, 64, 6, False), (64, 96, 6, False), (96, 96, 6, False),
          (96, 96, 6, False), (96, 160, 6, True), (160, 160, 6, False),
          (160, 160, 6, False), (160, 320, 6, False)]
HEAD_CHANNELS = 1280


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


class BaseBlock(nn.Module):
    def __init__(self, inp: int, oup: int, t: int, downsample: bool,
                 prefix: str, plan: Optional[RankPlan], mode: str,
                 generator: Optional[torch.Generator]):
        super().__init__()
        c = inp * t
        self.conv1 = make_conv(inp, c, 1, plan=plan, mode=mode,
                               key=f"{prefix}.conv1.weight",
                               generator=generator)
        self.bn1 = _bn(c)
        self.conv2 = nn.Conv2d(c, c, 3, 2 if downsample else 1, 1, groups=c,
                               bias=False)
        kaiming_(self.conv2.weight, generator)
        self.bn2 = _bn(c)
        self.conv3 = make_conv(c, oup, 1, plan=plan, mode=mode,
                               key=f"{prefix}.conv3.weight",
                               generator=generator)
        self.bn3 = _bn(oup)
        self.residual = not downsample and inp == oup

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu6(self.bn1(self.conv1(x)))
        y = F.relu6(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return x + y if self.residual else y


class MobileNetV2Cifar(nn.Module):
    """NCHW input [B, 3, H, W] -> logits [B, num_classes] (float32)."""

    def __init__(self, num_classes: int = 10, plan: Optional[RankPlan] = None,
                 mode: str = "chain",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv0 = nn.Conv2d(3, 32, 3, padding=1, bias=False)
        kaiming_(self.conv0.weight, generator)
        self.bn0 = _bn(32)
        self.bottlenecks = nn.ModuleList(
            BaseBlock(inp, oup, t, ds, f"bottlenecks.{i}", plan, mode,
                      generator)
            for i, (inp, oup, t, ds) in enumerate(BLOCKS))
        # the 1x1 head is a compression target where the plan names it
        self.conv1 = make_conv(BLOCKS[-1][1], HEAD_CHANNELS, 1, plan=plan,
                               mode=mode, key="conv1.weight",
                               generator=generator)
        self.bn1 = _bn(HEAD_CHANNELS)
        self.fc = nn.Linear(HEAD_CHANNELS, num_classes)
        # LeCun normal on fan-in (untruncated) and a zero bias, as flax's
        # Dense default
        nn.init.kaiming_normal_(self.fc.weight, nonlinearity="linear",
                                generator=generator)
        nn.init.zeros_(self.fc.bias)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """`generator` is taken for a common signature and not used: the
        network draws nothing at random."""
        y = F.relu6(self.bn0(self.conv0(x)))
        for block in self.bottlenecks:
            y = block(y)
        y = F.relu6(self.bn1(self.conv1(y)))
        y = y.mean(dim=(2, 3))
        # the head runs in float32 whatever the compute type
        with torch.autocast(y.device.type, enabled=False):
            return self.fc(y.float())


# the plans the JAX package registers (its `_register_plans`)
register_plan("mobilenetv2_cifar", "tk", "2")(
    lambda: build_tk_plan("mobilenetv2_cifar", "2"))
register_plan("mobilenetv2_cifar", "svd", "2")(
    lambda: build_svd_plan("mobilenetv2_cifar", "2"))


@register_model
def mobilenetv2_cifar(*, num_classes: int = 10, fmt: Optional[str] = None,
                      mode: str = "chain", ratio: str = "2",
                      tt_type: str = "general",
                      plan: Optional[RankPlan] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> MobileNetV2Cifar:
    if fmt is not None and plan is None:
        plan = get_rank_plan("mobilenetv2_cifar", fmt, ratio, tt_type)
    return MobileNetV2Cifar(num_classes=num_classes, plan=plan, mode=mode,
                            generator=generator)
