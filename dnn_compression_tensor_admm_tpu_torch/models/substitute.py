"""Layer substitution: a dense conv or linear, or the factorized layer a
RankPlan prescribes for its canonical parameter name (TT, Tucker-2 or
plain SVD)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..configs.hp import RankPlan, SVDSpec, TKSpec, TTConvSpec, TTLinearSpec
from ..layers import (SVDConv2d, SVDLinear, TKConv2d, TKLinear, TTConv2d,
                      TTLinear)


def kaiming_(w: torch.Tensor, generator: Optional[torch.Generator]) -> None:
    """He-normal on fan-in, the JAX package's kernel init."""
    nn.init.kaiming_normal_(w, mode="fan_in", nonlinearity="relu",
                            generator=generator)


def make_conv(in_ch: int, out_ch: int, kernel_size: int, *, stride=1,
              padding=0, plan: Optional[RankPlan], mode: str, key: str,
              bias: bool = False,
              generator: Optional[torch.Generator] = None) -> nn.Module:
    """`key` is the dense parameter name ('layer1.0.conv1.weight'); a layer
    is factorized iff the key is in the plan."""
    spec = plan.spec(key) if plan is not None else None
    if spec is None:
        conv = nn.Conv2d(in_ch, out_ch, kernel_size, stride=stride,
                         padding=padding, bias=bias)
        kaiming_(conv.weight, generator)
        if bias:
            nn.init.zeros_(conv.bias)
        return conv
    if isinstance(spec, TTConvSpec):
        tt_mode = "reconstruct" if mode == "reconstruct" else "factorized"
        return TTConv2d(in_ch, out_ch, kernel_size, spec, stride=stride,
                        padding=padding, bias=bias, mode=tt_mode,
                        generator=generator)
    if isinstance(spec, TKSpec):
        tk_mode = "reconstruct" if mode == "reconstruct" else "chain"
        return TKConv2d(in_ch, out_ch, kernel_size, spec, stride=stride,
                        padding=padding, bias=bias, mode=tk_mode,
                        generator=generator)
    if isinstance(spec, SVDSpec):
        svd_mode = "reconstruct" if mode == "reconstruct" else "chain"
        return SVDConv2d(in_ch, out_ch, kernel_size, spec, stride=stride,
                         padding=padding, bias=bias, mode=svd_mode,
                         generator=generator)
    raise TypeError(f"bad conv spec for {key}: {type(spec).__name__}")


def make_linear(in_f: int, out_f: int, *, plan: Optional[RankPlan], mode: str,
                key: str, bias: bool = True,
                generator: Optional[torch.Generator] = None) -> nn.Module:
    """A dense linear (He-normal on fan-in, zero bias), or the TT, Tucker-2
    or SVD linear the plan prescribes for `key`
    ('blocks.0.attn.qkv.weight')."""
    spec = plan.spec(key) if plan is not None else None
    if spec is None:
        linear = nn.Linear(in_f, out_f, bias=bias)
        kaiming_(linear.weight, generator)
        if bias:
            nn.init.zeros_(linear.bias)
        return linear
    if isinstance(spec, TTLinearSpec):
        tt_mode = "reconstruct" if mode == "reconstruct" else "factorized"
        return TTLinear(in_f, out_f, spec, bias=bias, mode=tt_mode,
                        generator=generator)
    if isinstance(spec, TKSpec):
        tk_mode = "reconstruct" if mode == "reconstruct" else "chain"
        return TKLinear(in_f, out_f, spec, bias=bias, mode=tk_mode,
                        generator=generator)
    if isinstance(spec, SVDSpec):
        svd_mode = "reconstruct" if mode == "reconstruct" else "chain"
        return SVDLinear(in_f, out_f, spec, bias=bias, mode=svd_mode,
                         generator=generator)
    raise TypeError(f"bad linear spec for {key}: {type(spec).__name__}")
