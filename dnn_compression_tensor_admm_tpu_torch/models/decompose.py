"""Decompose: dense state dict -> factorized state dict.

Every plan-targeted kernel is factorized and everything else (BN
statistics, the head) is copied through, so the fine-tune phase is
`model.load_state_dict(decompose_params(dense_state_dict, plan))`.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..configs.hp import RankPlan, SVDSpec, TKSpec, TTConvSpec, TTLinearSpec
from ..layers import (SVDConv2d, SVDLinear, TKConv2d, TKLinear, TTConv2d,
                      TTLinear)
from ..ops.precision import full_f32


@full_f32()
def decompose_params(state_dict: Dict[str, torch.Tensor], plan: RankPlan, *,
                     method: str = "svd", n_iter: int = 10
                     ) -> Dict[str, torch.Tensor]:
    """Factorize every plan layer of a dense model's state dict."""
    out = dict(state_dict)
    for name in plan.names():
        if name not in out:
            raise KeyError(f"plan layer {name!r} not present in dense params")
        spec = plan.spec(name)
        w = out.pop(name)
        prefix = name[:-len("weight")]
        with torch.no_grad():
            if isinstance(spec, TTConvSpec) and w.dim() == 4:
                factors = TTConv2d.factorize_dense(w.float(), spec,
                                                   method=method)
            elif isinstance(spec, TTLinearSpec) and w.dim() == 2:
                # a Linear's weight is [out, in] already, the TT view
                factors = TTLinear.factorize_dense(w.float(), spec,
                                                   method=method)
            elif isinstance(spec, TKSpec) and w.dim() == 4:
                factors = TKConv2d.factorize_dense(w.float(), spec,
                                                   n_iter=n_iter, method=method)
            elif isinstance(spec, TKSpec) and w.dim() == 2:
                factors = TKLinear.factorize_dense(w.float(), spec,
                                                   n_iter=n_iter, method=method)
            elif isinstance(spec, SVDSpec) and w.dim() == 4:
                factors = SVDConv2d.factorize_dense(w.float(), spec)
            elif isinstance(spec, SVDSpec) and w.dim() == 2:
                factors = SVDLinear.factorize_dense(w.float(), spec)
            else:
                raise TypeError(f"{type(spec).__name__} does not apply to a "
                                f"{w.dim()}-d weight ({name})")
        out.update({prefix + k: v for k, v in factors.items()})
    return out


def count_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def compression_ratio(dense: nn.Module, compressed: nn.Module) -> float:
    """Dense/compressed parameter-count ratio."""
    return count_params(dense) / count_params(compressed)
