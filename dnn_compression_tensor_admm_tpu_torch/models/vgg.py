"""VGG-16 and VGG-16-BN (timm topology), dense and Tucker-2 compressed
(counterpart of the JAX package's `models/vgg.py`).

The feature convs (3x3, padding 1, with bias) are named by their flat
`nn.Sequential` index ('features.{i}.weight'): BN, ReLU and the 2x2 max
pools each take an index. Then timm's `pre_logits` ConvMlp: `fc1` a 7x7
conv 512 -> 4096 without padding on the 7x7 map and `fc2` a 1x1 conv
4096 -> 4096, both with bias and each followed by ReLU; then the spatial
mean and a linear `head.fc` in float32. The rank tables key the feature
convs and, where they hold them, 'pre_logits.fc1.weight' and
'pre_logits.fc2.weight'. BatchNorm uses torch momentum 0.1 (flax momentum
0.9) and eps 1e-5.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..configs.hp import RankPlan
from ..configs.plans import build_tk_plan
from ..configs.resolver import get_rank_plan, register_plan
from .registry import register_model
from .substitute import kaiming_, make_conv

CFG16 = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
         512, 512, 512, "M", 512, 512, 512, "M"]


class ConvMlp(nn.Module):
    """timm's `pre_logits`: 7x7 conv `fc1`, ReLU, 1x1 conv `fc2`, ReLU."""

    def __init__(self, plan: Optional[RankPlan], mode: str,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.fc1 = make_conv(512, 4096, 7, plan=plan, mode=mode,
                             key="pre_logits.fc1.weight", bias=True,
                             generator=generator)
        self.fc2 = make_conv(4096, 4096, 1, plan=plan, mode=mode,
                             key="pre_logits.fc2.weight", bias=True,
                             generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.fc2(torch.relu(self.fc1(x))))


class VGG(nn.Module):
    """NCHW input [B, 3, H, W] -> logits [B, num_classes] (float32)."""

    def __init__(self, cfg, use_bn: bool, num_classes: int = 1000,
                 plan: Optional[RankPlan] = None, mode: str = "chain",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        layers = []
        in_ch = 3
        for v in cfg:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
                continue
            layers.append(make_conv(in_ch, v, 3, padding=1, plan=plan,
                                    mode=mode,
                                    key=f"features.{len(layers)}.weight",
                                    bias=True, generator=generator))
            if use_bn:
                layers.append(nn.BatchNorm2d(v, eps=1e-5, momentum=0.1))
            layers.append(nn.ReLU())
            in_ch = v
        self.features = nn.Sequential(*layers)
        self.pre_logits = ConvMlp(plan, mode, generator)
        self.head = nn.Module()  # timm's `head.fc`
        self.head.fc = nn.Linear(4096, num_classes)
        kaiming_(self.head.fc.weight, generator)
        nn.init.zeros_(self.head.fc.bias)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """`generator` is taken for a common signature and not used: the
        network draws nothing at random."""
        y = self.pre_logits(self.features(x)).mean(dim=(2, 3))
        # the head runs in float32 whatever the compute type
        with torch.autocast(y.device.type, enabled=False):
            return self.head.fc(y.float())


# the plans the JAX package registers (its `_register_plans`)
for _model in ("vgg16", "vgg16_bn"):
    for _ratio in ("2", "10"):
        register_plan(_model, "tk", _ratio)(
            lambda m=_model, r=_ratio: build_tk_plan(m, r))


def _build(base: str, use_bn: bool, *, num_classes: int = 1000,
           fmt: Optional[str] = None, mode: str = "chain", ratio: str = "2",
           tt_type: str = "general", plan: Optional[RankPlan] = None,
           generator: Optional[torch.Generator] = None) -> VGG:
    if fmt is not None and plan is None:
        plan = get_rank_plan(base, fmt, ratio, tt_type)
    return VGG(CFG16, use_bn, num_classes=num_classes, plan=plan, mode=mode,
               generator=generator)


@register_model
def vgg16(**kw) -> VGG:
    return _build("vgg16", False, **kw)


@register_model
def vgg16_bn(**kw) -> VGG:
    return _build("vgg16_bn", True, **kw)
