"""MobileNetV2 for ImageNet, dense and plain-SVD, Tucker-2 or
Tensor-Train compressed (counterpart of the JAX package's
`models/mobilenetv2.py`).

A 3x3/2 stem to 32 channels (`features.0.0`, BN `features.0.1`), 17
inverted residual blocks `features.N` (expand 1x1 `conv.0`, depthwise
3x3 `conv.3`, project 1x1 `conv.6`; in the expand-1 block depthwise
`conv.0` and project `conv.3`, BN at the next index, ReLU6 between),
the 320 -> 1280 1x1 head `conv.0` (BN `conv.1`), the spatial mean and a
linear `classifier` in float32. NCHW activations, OIHW kernels; BatchNorm
uses torch momentum 0.1 (flax momentum 0.9) and eps 1e-5. The depthwise
convs are never compressed.

The three reference tables key three naming schemes (TT torchvision's,
TK timm's, SVD the canonical one above); `remap_tt_key` and
`remap_tk_key` map the first two onto the canonical names, so one model
serves every format.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.hp import RankPlan
from ..configs.plans import build_svd_plan, build_tk_plan, build_tt_conv_plan
from ..configs.resolver import get_rank_plan, register_plan
from .registry import register_model
from .substitute import kaiming_, make_conv

# (expand ratio t, out channels c, blocks n, stride s), the JAX package's
# `_CFGS`
CFGS = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
        (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
_BLOCKS_PER_STAGE = [n for _, _, n, _ in CFGS]
HEAD_CHANNELS = 1280


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


def _depthwise(c: int, stride: int,
               generator: Optional[torch.Generator]) -> nn.Conv2d:
    conv = nn.Conv2d(c, c, 3, stride, 1, groups=c, bias=False)
    kaiming_(conv.weight, generator)
    return conv


class InvertedResidual(nn.Module):
    def __init__(self, inp: int, oup: int, stride: int, expand: int,
                 prefix: str, plan: Optional[RankPlan], mode: str,
                 generator: Optional[torch.Generator]):
        super().__init__()
        hidden = inp * expand
        layers = []
        if expand != 1:
            layers += [make_conv(inp, hidden, 1, plan=plan, mode=mode,
                                 key=f"{prefix}.conv.0.weight",
                                 generator=generator),
                       _bn(hidden), nn.ReLU6()]
        pwl = f"{prefix}.conv.{len(layers) + 3}.weight"
        layers += [_depthwise(hidden, stride, generator), _bn(hidden),
                   nn.ReLU6(),
                   make_conv(hidden, oup, 1, plan=plan, mode=mode, key=pwl,
                             generator=generator),
                   _bn(oup)]
        self.conv = nn.Sequential(*layers)
        self.residual = stride == 1 and inp == oup

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        return x + y if self.residual else y


class MobileNetV2(nn.Module):
    """NCHW input [B, 3, H, W] -> logits [B, num_classes] (float32)."""

    def __init__(self, num_classes: int = 1000,
                 plan: Optional[RankPlan] = None, mode: str = "chain",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        stem = nn.Conv2d(3, 32, 3, 2, 1, bias=False)
        kaiming_(stem.weight, generator)
        features = [nn.Sequential(stem, _bn(32), nn.ReLU6())]
        inp = 32
        for t, c, n, s in CFGS:
            for i in range(n):
                features.append(InvertedResidual(
                    inp, c, s if i == 0 else 1, t,
                    f"features.{len(features)}", plan, mode, generator))
                inp = c
        self.features = nn.Sequential(*features)
        self.conv = nn.Sequential(
            make_conv(inp, HEAD_CHANNELS, 1, plan=plan, mode=mode,
                      key="conv.0.weight", generator=generator),
            _bn(HEAD_CHANNELS), nn.ReLU6())
        self.classifier = nn.Linear(HEAD_CHANNELS, num_classes)
        # LeCun normal on fan-in (untruncated) and a zero bias, as flax's
        # Dense default
        nn.init.kaiming_normal_(self.classifier.weight, nonlinearity="linear",
                                generator=generator)
        nn.init.zeros_(self.classifier.bias)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """`generator` is taken for a common signature and not used: the
        network draws nothing at random."""
        y = self.conv(self.features(x)).mean(dim=(2, 3))
        # the head runs in float32 whatever the compute type
        with torch.autocast(y.device.type, enabled=False):
            return self.classifier(y.float())


def _feat_index(stage: int, block: int) -> int:
    return 1 + sum(_BLOCKS_PER_STAGE[:stage]) + block


def remap_tt_key(k: str) -> str:
    """torchvision's name (the TT table's) -> the canonical one."""
    if k == "conv.0.weight":
        return k
    parts = k.split(".")  # features.N.conv.X(.Y).weight
    n = int(parts[1])
    if parts[2] == "0":  # torchvision's head: features.18.0.weight
        return "conv.0.weight"
    tail = ".".join(parts[2:])
    table = ({"conv.0.0.weight": "conv.0.weight",
              "conv.1.weight": "conv.3.weight"} if n == 1 else
             {"conv.0.0.weight": "conv.0.weight",
              "conv.1.0.weight": "conv.3.weight",
              "conv.2.weight": "conv.6.weight"})
    return f"features.{n}.{table[tail]}"


def remap_tk_key(k: str) -> str:
    """timm's name (the TK table's) -> the canonical one."""
    if k == "conv_head.weight":
        return "conv.0.weight"
    parts = k.split(".")  # blocks.S.B.conv_xx.weight
    s, b, kind = int(parts[1]), int(parts[2]), parts[3]
    expand1 = s == 0
    conv = {"conv_pw": "conv.0", "conv_dw": "conv.0" if expand1 else "conv.3",
            "conv_pwl": "conv.3" if expand1 else "conv.6"}[kind]
    return f"features.{_feat_index(s, b)}.{conv}.weight"


def out_channels(name: str) -> int:
    """A canonical 1x1 conv's output channels (every TT-planned layer is
    one): the head's 1280, an expansion's hidden width, a projection's
    stage width."""
    if name == "conv.0.weight":
        return HEAD_CHANNELS
    n, conv = int(name.split(".")[1]), name.split(".")[3]
    idx, inp = 1, 32
    for t, c, blocks, _ in CFGS:
        for _ in range(blocks):
            if idx == n:
                return c if t == 1 or conv != "0" else inp * t
            inp = c
            idx += 1
    raise KeyError(name)


def _remap(plan: RankPlan, remap) -> RankPlan:
    return RankPlan(plan.fmt, {remap(k): v for k, v in plan.layers.items()})


# the plans the JAX package registers (its `_register_plans`)
register_plan("mobilenetv2", "tk", "2")(
    lambda: _remap(build_tk_plan("mobilenetv2", "2"), remap_tk_key))
register_plan("mobilenetv2", "svd", "2")(
    lambda: build_svd_plan("mobilenetv2", "2"))
register_plan("mobilenetv2", "tt", "2")(
    lambda: _remap(build_tt_conv_plan(
        "mobilenetv2", "2", "general",
        lambda k: out_channels(remap_tt_key(k))), remap_tt_key))


@register_model
def mobilenetv2(*, num_classes: int = 1000, fmt: Optional[str] = None,
                mode: str = "chain", ratio: str = "2",
                tt_type: str = "general", plan: Optional[RankPlan] = None,
                generator: Optional[torch.Generator] = None) -> MobileNetV2:
    if fmt is not None and plan is None:
        plan = get_rank_plan("mobilenetv2", fmt, ratio, tt_type)
    return MobileNetV2(num_classes=num_classes, plan=plan, mode=mode,
                       generator=generator)
