"""Low-rank (SVD) linear layer (counterpart of the JAX package's
`layers/svd_linear.py`).

Parameters (a truncated SVD of the dense [out_features, in_features]
weight):

* ``first_factor`` — [r, I]
* ``last_factor``  — [O, r]

mode='chain' runs two products (I -> r -> O); mode='reconstruct' rebuilds
[O, I] and runs one. Both modes share the parameters.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.hp import SVDSpec
from ..ops.precision import full_f32
from ..ops.svd import svd_factors_scaled


class SVDLinear(nn.Module):
    def __init__(self, in_features: int, out_features: int, spec: SVDSpec, *,
                 bias: bool = True, mode: str = "chain",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if mode not in ("chain", "reconstruct"):
            raise ValueError(f"unknown mode {mode!r}")
        self.mode = mode
        self.first_factor = nn.Parameter(torch.empty(spec.rank, in_features))
        self.last_factor = nn.Parameter(torch.empty(out_features, spec.rank))
        for p in (self.first_factor, self.last_factor):
            nn.init.xavier_uniform_(p, generator=generator)
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        first, last = self.first_factor, self.last_factor
        if self.mode == "reconstruct":
            return F.linear(x, last @ first, self.bias)
        return F.linear(F.linear(x, first), last, self.bias)

    @staticmethod
    @full_f32()
    def factorize_dense(dense_w: torch.Tensor, spec: SVDSpec,
                        dense_b: Optional[torch.Tensor] = None) -> dict:
        """Parameters from a dense [O, I] weight by truncated SVD, the
        singular values split as their square roots between the two
        factors (as the JAX package does)."""
        last, first = svd_factors_scaled(dense_w, spec.rank)
        params = {"first_factor": first.contiguous(),  # [r, I]
                  "last_factor": last.contiguous()}    # [O, r]
        if dense_b is not None:
            params["bias"] = dense_b
        return params
