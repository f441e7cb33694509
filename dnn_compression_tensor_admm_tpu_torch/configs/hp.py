"""Typed per-layer rank specifications (counterpart of the JAX package's
`configs/hp.py`; the TT specs wait for the TT slice)."""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional


@dataclasses.dataclass(frozen=True)
class TKSpec:
    """Tucker-2 ranks for a conv kernel or linear weight: (out_rank, in_rank)."""
    out_rank: int
    in_rank: int

    def clamped(self, weight_shape) -> "TKSpec":
        """Clamp to feasible multilinear ranks for a logical weight shape
        [O, I, ...] (mode-k rank <= n_k and <= the product of the rest)."""
        dims = list(weight_shape)
        rest0 = math.prod(dims[1:])
        rest1 = dims[0] * math.prod(dims[2:])
        return TKSpec(min(self.out_rank, dims[0], rest0),
                      min(self.in_rank, dims[1], rest1))


@dataclasses.dataclass(frozen=True)
class SVDSpec:
    """Plain low-rank (matrix SVD) spec."""
    rank: int


@dataclasses.dataclass(frozen=True)
class RankPlan:
    """Per-layer compression plan: canonical parameter name -> spec."""
    fmt: str
    layers: Mapping[str, object]

    def spec(self, name: str) -> Optional[object]:
        return self.layers.get(name)

    def __contains__(self, name: str) -> bool:
        return name in self.layers

    def names(self):
        return self.layers.keys()
