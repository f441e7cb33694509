"""Tensor-Train decomposition (TT-SVD) and reconstruction (counterpart of
the JAX package's `ops/ttd.py`).

The reference lowers a TT rank at run time when a singular spectrum is
shorter than asked; here, as in the JAX package, `clamp_tt_ranks`
settles that bound from the shapes alone, once, and every consumer
(layers, ADMM projections, plans) uses the clamped ranks.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch

from .precision import full_f32
from .svd import truncated_left_sv


def clamp_tt_ranks(tt_shapes: Sequence[int],
                   tt_ranks: Sequence[int]) -> List[int]:
    """Clamp TT ranks to feasible values: at sweep step i the unfolding is
    ``[r_i * n_i, prod(n_{i+1:}) * r_d]``, so ``r_{i+1}`` is at most the
    smaller side."""
    shapes = list(tt_shapes)
    ranks = list(tt_ranks)
    d = len(shapes)
    if len(ranks) != d + 1:
        raise ValueError(f"need {d + 1} ranks for order-{d} TT, got {len(ranks)}")
    for i in range(d - 1):
        rows = ranks[i] * shapes[i]
        cols = math.prod(shapes[i + 1:]) * ranks[d]
        ranks[i + 1] = min(ranks[i + 1], rows, cols)
    return ranks


@full_f32()
def ten2tt(x: torch.Tensor, tt_shapes: Sequence[int],
           tt_ranks: Sequence[int], method: str = "svd") -> List[torch.Tensor]:
    """TT-SVD sweep: factorize `x` into cores ``[r_i, n_i, r_{i+1}]`` by
    sequential truncated SVDs of the unfoldings."""
    shapes = list(tt_shapes)
    ranks = clamp_tt_ranks(shapes, tt_ranks)
    d = len(shapes)
    t = x.reshape(-1)
    cores = []
    for i in range(d - 1):
        t = t.reshape(ranks[i] * shapes[i], -1)
        u = truncated_left_sv(t, ranks[i + 1], method=method)
        cores.append(u.reshape(ranks[i], shapes[i], ranks[i + 1]))
        # the residual carried on: u^T t (= s vt for the exact SVD)
        t = u.T @ t
    cores.append(t.reshape(ranks[d - 1], shapes[d - 1], ranks[d]))
    return cores


@full_f32()
def tt2ten(tt_cores: Sequence[torch.Tensor],
           tt_shapes: Sequence[int]) -> torch.Tensor:
    """Rebuild the full tensor from TT cores."""
    t = tt_cores[0]
    for core in tt_cores[1:]:
        rank = core.shape[0]
        t = t.reshape(-1, rank) @ core.reshape(rank, -1)
    return t.reshape(tuple(tt_shapes))


def tt_project(x: torch.Tensor, tt_shapes: Sequence[int],
               tt_ranks: Sequence[int], method: str = "svd") -> torch.Tensor:
    """Project `x` onto the tensors of TT ranks <= `tt_ranks` (ten2tt then
    tt2ten), in `x`'s shape: the TT Z-step of one layer."""
    cores = ten2tt(x.reshape(tuple(tt_shapes)), tt_shapes, tt_ranks,
                   method=method)
    return tt2ten(cores, tt_shapes).reshape(x.shape)
