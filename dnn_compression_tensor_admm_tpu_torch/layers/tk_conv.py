"""Tucker-2 conv layer (the reference's TKConv2dC / M / R).

Parameters (Tucker-2 of the dense OIHW kernel over modes (O, I)):

* ``first_factor`` — [r_in, I]   (mode-1 factor, transposed)
* ``core_kernel``  — OIHW [r_out, r_in, kh, kw]
* ``last_factor``  — [O, r_out]  (mode-0 factor)

mode='chain' runs 1x1 -> core conv -> 1x1; mode='reconstruct' rebuilds
the dense kernel and runs one conv.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.hp import TKSpec
from ..ops.tucker import partial_tucker
from .common import IntOrPair, pair


class TKConv2d(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntOrPair, spec: TKSpec, *,
                 stride: IntOrPair = 1, padding: IntOrPair = 0,
                 bias: bool = True, mode: str = "chain",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if mode not in ("chain", "reconstruct"):
            raise ValueError(f"unknown mode {mode!r}")
        kh, kw = pair(kernel_size)
        sp = spec.clamped((out_channels, in_channels, kh, kw))
        self.stride, self.padding, self.mode = pair(stride), pair(padding), mode
        self.first_factor = nn.Parameter(torch.empty(sp.in_rank, in_channels))
        self.core_kernel = nn.Parameter(
            torch.empty(sp.out_rank, sp.in_rank, kh, kw))
        self.last_factor = nn.Parameter(torch.empty(out_channels, sp.out_rank))
        for p in (self.first_factor, self.core_kernel, self.last_factor):
            nn.init.xavier_uniform_(p, generator=generator)
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        first, core, last = self.first_factor, self.core_kernel, self.last_factor
        if self.mode == "reconstruct":
            w = torch.einsum("oa,abhw,bi->oihw", last, core, first)
            return F.conv2d(x, w, self.bias, self.stride, self.padding)
        y = F.conv2d(x, first[:, :, None, None])
        y = F.conv2d(y, core, None, self.stride, self.padding)
        return F.conv2d(y, last[:, :, None, None], self.bias)

    @staticmethod
    def factorize_dense(dense_w_oihw: torch.Tensor, spec: TKSpec,
                        dense_b: Optional[torch.Tensor] = None,
                        n_iter: int = 10, method: str = "svd") -> dict:
        """Parameters from a dense OIHW kernel by partial Tucker."""
        spec = spec.clamped(dense_w_oihw.shape)
        core, (last, first) = partial_tucker(
            dense_w_oihw, (spec.out_rank, spec.in_rank), modes=(0, 1),
            n_iter=n_iter, method=method)
        params = {"first_factor": first.T.contiguous(),   # [r_in, I]
                  "core_kernel": core.contiguous(),       # OIHW
                  "last_factor": last.contiguous()}       # [O, r_out]
        if dense_b is not None:
            params["bias"] = dense_b
        return params
