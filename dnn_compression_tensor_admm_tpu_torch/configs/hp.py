"""Typed per-layer rank specifications (counterpart of the JAX package's
`configs/hp.py`)."""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Tuple

from ..ops.ttd import clamp_tt_ranks


@dataclasses.dataclass(frozen=True)
class TTConvSpec:
    """TT factorization of a conv kernel [O, I, kh, kw], tensorized as
    ``[out_shapes..., kh*kw, in_shapes...]`` with prod(out_shapes) == O and
    prod(in_shapes) == I. Ranks are clamped when the spec is created."""
    tt_shapes: Tuple[int, ...]
    tt_ranks: Tuple[int, ...]
    out_order: int  # number of leading shapes that multiply to out_channels

    @property
    def out_shapes(self) -> Tuple[int, ...]:
        return self.tt_shapes[:self.out_order]

    @property
    def filter_dim(self) -> int:
        return self.tt_shapes[self.out_order]

    @property
    def in_shapes(self) -> Tuple[int, ...]:
        return self.tt_shapes[self.out_order + 1:]

    @property
    def out_ranks(self) -> Tuple[int, ...]:
        return self.tt_ranks[:self.out_order + 1]

    @property
    def in_ranks(self) -> Tuple[int, ...]:
        return self.tt_ranks[self.out_order + 1:]

    @property
    def out_channels(self) -> int:
        return math.prod(self.out_shapes)

    @property
    def in_channels(self) -> int:
        return math.prod(self.in_shapes) if self.in_shapes else 1

    @staticmethod
    def create(tt_shapes, tt_ranks, out_channels: int) -> "TTConvSpec":
        """Split at the first prefix of the shapes whose product is
        `out_channels`, and clamp the ranks."""
        shapes = tuple(tt_shapes)
        return TTConvSpec(shapes, tuple(clamp_tt_ranks(shapes, tt_ranks)),
                          _out_order(shapes, out_channels))


def _out_order(shapes: Tuple[int, ...], out_features: int) -> int:
    """Length of the first prefix of the shapes whose product is
    `out_features`."""
    channels = 1
    for i, s in enumerate(shapes):
        channels *= s
        if channels == out_features:
            return i + 1
    raise ValueError(f"tt_shapes {shapes} have no prefix with product "
                     f"{out_features}")


@dataclasses.dataclass(frozen=True)
class TTLinearSpec:
    """TT factorization of a linear weight [out_features, in_features],
    tensorized as ``[out_shapes..., in_shapes...]``. Ranks are clamped
    when the spec is created."""
    tt_shapes: Tuple[int, ...]
    tt_ranks: Tuple[int, ...]
    out_order: int  # number of leading shapes that multiply to out_features

    @property
    def out_shapes(self) -> Tuple[int, ...]:
        return self.tt_shapes[:self.out_order]

    @property
    def in_shapes(self) -> Tuple[int, ...]:
        return self.tt_shapes[self.out_order:]

    @property
    def out_features(self) -> int:
        return math.prod(self.out_shapes)

    @property
    def in_features(self) -> int:
        return math.prod(self.in_shapes)

    @property
    def mid_rank(self) -> int:
        """The TT rank at the out/in boundary: the bottleneck width."""
        return self.tt_ranks[self.out_order]

    @staticmethod
    def create(tt_shapes, tt_ranks, out_features: int) -> "TTLinearSpec":
        """Split at the first prefix of the shapes whose product is
        `out_features`, and clamp the ranks."""
        shapes = tuple(tt_shapes)
        return TTLinearSpec(shapes, tuple(clamp_tt_ranks(shapes, tt_ranks)),
                            _out_order(shapes, out_features))


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
