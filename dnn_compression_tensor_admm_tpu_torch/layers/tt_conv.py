"""Tensor-Train conv layer (the reference's TTConv2dM and TTConv2dR).

The dense kernel [O, I, kh, kw] is viewed as ``[O, kh*kw, I]`` and
TT-factorized over ``out_shapes + (kh*kw,) + in_shapes``. Parameters:

* ``out_core_i`` — [r_i, out_shape_i, r_{i+1}], r_0 = 1
* ``core_kernel`` — OIHW [r_outL, r_in0, kh, kw] (the middle TT core as
  a conv kernel)
* ``in_core_i`` — [r_i, in_shape_i, r_{i+1}], r_last = 1

mode='factorized' runs the merged in-chain as a 1x1 conv, the core conv,
then the merged out-chain as a 1x1 conv; mode='reconstruct' rebuilds the
dense kernel and runs one conv. Both modes share the parameters.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.hp import TTConvSpec
from ..ops.contractions import merge_tt_matrix
from ..ops.ttd import ten2tt
from .common import IntOrPair, pair


class TTConv2d(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntOrPair, spec: TTConvSpec, *,
                 stride: IntOrPair = 1, padding: IntOrPair = 0,
                 bias: bool = True, mode: str = "factorized",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if mode not in ("factorized", "reconstruct"):
            raise ValueError(f"unknown mode {mode!r}")
        kh, kw = pair(kernel_size)
        if (spec.out_channels, spec.in_channels, spec.filter_dim) != (
                out_channels, in_channels, kh * kw):
            raise ValueError(f"{spec} does not fit a conv {out_channels}x"
                             f"{in_channels}x{kh}x{kw}")
        self.stride, self.padding, self.mode = pair(stride), pair(padding), mode
        self.n_out, self.n_in = len(spec.out_shapes), len(spec.in_shapes)
        for j, n in enumerate(spec.out_shapes):
            self.register_parameter(f"out_core_{j}", nn.Parameter(torch.empty(
                spec.out_ranks[j], n, spec.out_ranks[j + 1])))
        self.core_kernel = nn.Parameter(torch.empty(
            spec.out_ranks[-1], spec.in_ranks[0], kh, kw))
        for j, n in enumerate(spec.in_shapes):
            self.register_parameter(f"in_core_{j}", nn.Parameter(torch.empty(
                spec.in_ranks[j], n, spec.in_ranks[j + 1])))
        for p in self.parameters():
            nn.init.xavier_uniform_(p, generator=generator)
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the chains (and a reconstructed kernel) are merged in float32
        # whatever the autocast type, as the JAX package merges, then casts
        with torch.autocast(x.device.type, enabled=False):
            a_out = merge_tt_matrix(
                [getattr(self, f"out_core_{j}") for j in range(self.n_out)])
            b_in = merge_tt_matrix(
                [getattr(self, f"in_core_{j}") for j in range(self.n_in)]
            ) if self.n_in else None
            if self.mode == "reconstruct":
                w = torch.einsum("oa,abhw->obhw", a_out, self.core_kernel)
                if b_in is not None:
                    w = torch.einsum("obhw,bi->oihw", w, b_in)
        if self.mode == "reconstruct":
            return F.conv2d(x, w, self.bias, self.stride, self.padding)
        y = x if b_in is None else F.conv2d(x, b_in[:, :, None, None])
        y = F.conv2d(y, self.core_kernel, None, self.stride, self.padding)
        return F.conv2d(y, a_out[:, :, None, None], self.bias)

    @staticmethod
    def factorize_dense(dense_w_oihw: torch.Tensor, spec: TTConvSpec,
                        dense_b: Optional[torch.Tensor] = None,
                        method: str = "svd") -> dict:
        """Parameters from a dense OIHW kernel by TT-SVD of its
        [O, kh*kw, I] view."""
        o, i, kh, kw = dense_w_oihw.shape
        w = dense_w_oihw.reshape(o, i, kh * kw).permute(0, 2, 1)
        cores = ten2tt(w, spec.tt_shapes, spec.tt_ranks, method=method)
        oo = spec.out_order
        params = {f"out_core_{j}": cores[j].contiguous() for j in range(oo)}
        mid = cores[oo]  # [r_outL, kh*kw, r_in0]
        params["core_kernel"] = mid.permute(0, 2, 1).reshape(
            mid.shape[0], mid.shape[2], kh, kw).contiguous()
        for j in range(oo + 1, len(cores)):
            params[f"in_core_{j - oo - 1}"] = cores[j].contiguous()
        if dense_b is not None:
            params["bias"] = dense_b
        return params
