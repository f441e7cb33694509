"""Tensor-Train linear layer (the reference's TTLinearM and TTLinearR).

The dense weight [out_features, in_features] is TT-factorized over
``out_shapes + in_shapes``. Parameters: ``core_0 .. core_{d-1}``, core_i
[r_i, n_i, r_{i+1}], and the bias.

mode='factorized' merges the out cores into A [O, m] and the in cores
into B [m, I] (m the rank at the out/in boundary) and computes
``y = (x @ B^T) @ A^T``; mode='reconstruct' builds W = A @ B and runs one
product. Both modes share the parameters.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.hp import TTLinearSpec
from ..ops.contractions import merge_tt_matrix
from ..ops.ttd import ten2tt


class TTLinear(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 spec: TTLinearSpec, *, bias: bool = True,
                 mode: str = "factorized",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if mode not in ("factorized", "reconstruct"):
            raise ValueError(f"unknown mode {mode!r}")
        if (spec.out_features, spec.in_features) != (out_features,
                                                     in_features):
            raise ValueError(f"{spec} does not fit a linear {in_features} -> "
                             f"{out_features}")
        self.spec, self.mode = spec, mode
        self.n_cores = len(spec.tt_shapes)
        for i, n in enumerate(spec.tt_shapes):
            core = nn.Parameter(torch.empty(spec.tt_ranks[i], n,
                                            spec.tt_ranks[i + 1]))
            nn.init.xavier_uniform_(core, generator=generator)
            self.register_parameter(f"core_{i}", core)
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cores = [getattr(self, f"core_{i}") for i in range(self.n_cores)]
        oo = self.spec.out_order
        # the chains (and a reconstructed weight) are merged in float32
        # whatever the autocast type, as the JAX package merges, then casts
        with torch.autocast(x.device.type, enabled=False):
            a = merge_tt_matrix(cores[:oo])   # [O, m]
            b = merge_tt_matrix(cores[oo:])   # [m, I]
            if self.mode == "reconstruct":
                w = a @ b                     # [O, I]
        if self.mode == "reconstruct":
            return F.linear(x, w, self.bias)
        return F.linear(F.linear(x, b), a, self.bias)

    @staticmethod
    def factorize_dense(dense_w: torch.Tensor, spec: TTLinearSpec,
                        dense_b: Optional[torch.Tensor] = None,
                        method: str = "svd") -> dict:
        """Parameters from a dense [O, I] weight by TT-SVD."""
        cores = ten2tt(dense_w.reshape(spec.tt_shapes), spec.tt_shapes,
                       spec.tt_ranks, method=method)
        params = {f"core_{i}": c.contiguous() for i, c in enumerate(cores)}
        if dense_b is not None:
            params["bias"] = dense_b
        return params
