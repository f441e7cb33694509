"""Tucker-2 linear layer (the reference's TKLinearM / TKLinearR;
counterpart of the JAX package's `layers/tk_linear.py`).

Parameters (partial Tucker of the [out_features, in_features] weight over
both modes):

* ``first_factor`` — [r_in, I]
* ``core``         — [r_out, r_in]
* ``last_factor``  — [O, r_out]

mode='chain' runs three products (I -> r_in -> r_out -> O);
mode='reconstruct' rebuilds the dense weight and runs one. Both modes
share the parameters.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.hp import TKSpec
from ..ops.tucker import partial_tucker


class TKLinear(nn.Module):
    def __init__(self, in_features: int, out_features: int, spec: TKSpec, *,
                 bias: bool = True, mode: str = "chain",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if mode not in ("chain", "reconstruct"):
            raise ValueError(f"unknown mode {mode!r}")
        sp = spec.clamped((out_features, in_features))
        self.mode = mode
        self.first_factor = nn.Parameter(torch.empty(sp.in_rank, in_features))
        self.core = nn.Parameter(torch.empty(sp.out_rank, sp.in_rank))
        self.last_factor = nn.Parameter(torch.empty(out_features, sp.out_rank))
        for p in (self.first_factor, self.core, self.last_factor):
            nn.init.xavier_uniform_(p, generator=generator)
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        first, core, last = self.first_factor, self.core, self.last_factor
        if self.mode == "reconstruct":
            return F.linear(x, last @ core @ first, self.bias)
        return F.linear(F.linear(F.linear(x, first), core), last, self.bias)

    @staticmethod
    def factorize_dense(dense_w: torch.Tensor, spec: TKSpec,
                        dense_b: Optional[torch.Tensor] = None,
                        n_iter: int = 10, method: str = "svd") -> dict:
        """Parameters from a dense [O, I] weight by partial Tucker."""
        spec = spec.clamped(dense_w.shape)
        core, (last, first) = partial_tucker(
            dense_w, (spec.out_rank, spec.in_rank), modes=(0, 1),
            n_iter=n_iter, method=method)
        params = {"first_factor": first.T.contiguous(),   # [r_in, I]
                  "core": core.contiguous(),              # [r_out, r_in]
                  "last_factor": last.contiguous()}       # [O, r_out]
        if dense_b is not None:
            params["bias"] = dense_b
        return params
