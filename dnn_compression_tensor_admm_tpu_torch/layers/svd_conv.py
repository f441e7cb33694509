"""Low-rank (SVD) conv layer for 1x1 convs (the reference's SVDConv2dR/C/M;
counterpart of the JAX package's `layers/svd_conv.py`).

Parameters (a truncated SVD of the dense [O, I] weight):

* ``first_factor`` — [r, I]
* ``last_factor``  — [O, r]

mode='chain' runs two feature products (two stacked 1x1 convs);
mode='reconstruct' rebuilds [O, I] and runs one. A stride subsamples the
input, as a 1x1 conv with that stride does. Both modes share the
parameters.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.hp import SVDSpec
from ..ops.precision import full_f32
from ..ops.svd import svd_factors_scaled
from .common import IntOrPair, pair


class SVDConv2d(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntOrPair, spec: SVDSpec, *,
                 stride: IntOrPair = 1, padding: IntOrPair = 0,
                 bias: bool = True, mode: str = "chain",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if pair(kernel_size) != (1, 1) or pair(padding) != (0, 0):
            raise ValueError("SVDConv2d supports unpadded 1x1 kernels (as in "
                             "the reference)")
        if mode not in ("chain", "reconstruct"):
            raise ValueError(f"unknown mode {mode!r}")
        self.stride, self.mode = pair(stride), mode
        self.first_factor = nn.Parameter(torch.empty(spec.rank, in_channels))
        self.last_factor = nn.Parameter(torch.empty(out_channels, spec.rank))
        for p in (self.first_factor, self.last_factor):
            nn.init.xavier_uniform_(p, generator=generator)
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sh, sw = self.stride
        if (sh, sw) != (1, 1):
            x = x[:, :, ::sh, ::sw]
        first, last = self.first_factor, self.last_factor
        if self.mode == "reconstruct":
            return F.conv2d(x, (last @ first)[:, :, None, None], self.bias)
        y = F.conv2d(x, first[:, :, None, None])
        return F.conv2d(y, last[:, :, None, None], self.bias)

    @staticmethod
    @full_f32()
    def factorize_dense(dense_w_oihw: torch.Tensor, spec: SVDSpec,
                        dense_b: Optional[torch.Tensor] = None) -> dict:
        """Parameters from a dense [O, I, 1, 1] kernel by truncated SVD,
        the singular values split as their square roots between the two
        factors (as the JAX package does; the reference folds them into
        one)."""
        o, i = dense_w_oihw.shape[:2]
        last, first = svd_factors_scaled(dense_w_oihw.reshape(o, i),
                                         spec.rank)
        params = {"first_factor": first.contiguous(),  # [r, I]
                  "last_factor": last.contiguous()}    # [O, r]
        if dense_b is not None:
            params["bias"] = dense_b
        return params
