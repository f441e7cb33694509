"""The JAX package's parameter initialisers for the NLP modules, on torch
tensors drawn from an explicit generator.

flax's `xavier_uniform` reads the fans from the last two axes, the rest
being the receptive field (fan_in = shape[-2] * field, fan_out =
shape[-1] * field), where `torch.nn.init.xavier_uniform_` reads them from
the first two; a TT core [r, n, r'] gets another bound in each.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


@torch.no_grad()
def xavier_uniform_(t: torch.Tensor,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """flax `nn.initializers.xavier_uniform()` in place."""
    field = math.prod(t.shape[:-2])
    fan_avg = (t.shape[-2] + t.shape[-1]) * field / 2
    bound = math.sqrt(3.0 / fan_avg)
    return t.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def normal_(t: torch.Tensor, std: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax `nn.initializers.normal(std)` in place."""
    return t.normal_(0.0, std, generator=generator)
