"""TT-matrix (TTM) layers, 4-D cores [r_i, m_i, n_i, r_{i+1}] (counterpart
of the JAX package's `nlp/ttm_layers.py`; the reference's
xcompression/transformer/TTMLinear.py, TTMEmbedding.py).

TTM pairs an input and an output mode in each core. The linear rebuilds
W [prod(m), prod(n)] by a chain of small products, moves the interleaved
(m_i, n_i) axes apart and runs one product; the embedding gathers each
core at the token's mixed-radix digit and chain-contracts per token.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from .initializers import xavier_uniform_
from .tt_embedding import mixed_radix_digits


def _ttm_cores(module: nn.Module, in_shape, out_shape, ranks, generator):
    d = len(in_shape)
    assert len(out_shape) == d and len(ranks) == d + 1
    for i in range(d):
        module.register_parameter(f"core_{i}", nn.Parameter(xavier_uniform_(
            torch.empty(ranks[i], in_shape[i], out_shape[i], ranks[i + 1]),
            generator)))


class TTMLinear(nn.Module):
    """y = x @ W + b, W [prod(input_tt_shape), prod(output_tt_shape)] in
    TTM format (reference TTMLinear.forward)."""

    def __init__(self, input_tt_shape: Sequence[int],
                 output_tt_shape: Sequence[int], tt_ranks: Sequence[int], *,
                 bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_shape, self.out_shape = tuple(input_tt_shape), tuple(output_tt_shape)
        self.ranks = tuple(tt_ranks)
        _ttm_cores(self, self.in_shape, self.out_shape, self.ranks, generator)
        self.bias = (nn.Parameter(torch.zeros(math.prod(self.out_shape)))
                     if bias else None)

    def full_weight(self) -> torch.Tensor:
        """W [in, out], as the JAX layer's kernel."""
        d = len(self.in_shape)
        res = self.core_0
        for i in range(1, d):
            core = getattr(self, f"core_{i}")
            res = res.reshape(-1, self.ranks[i]) @ core.reshape(self.ranks[i], -1)
        inter = [s for mn in zip(self.in_shape, self.out_shape) for s in mn]
        res = res.reshape(inter)
        res = res.permute(*range(0, 2 * d, 2), *range(1, 2 * d, 2))
        return res.reshape(math.prod(self.in_shape), math.prod(self.out_shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.full_weight()
        return y + self.bias if self.bias is not None else y


class TTMEmbedding(nn.Module):
    """Vocab factored over the input modes, features over the output
    modes; a lookup gathers every core at the token's digit and contracts
    the chain per token (reference TTMEmbedding.forward)."""

    def __init__(self, input_tt_shape: Sequence[int],
                 output_tt_shape: Sequence[int], tt_ranks: Sequence[int], *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_shape, self.out_shape = tuple(input_tt_shape), tuple(output_tt_shape)
        self.ranks = tuple(tt_ranks)
        _ttm_cores(self, self.in_shape, self.out_shape, self.ranks, generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        digits = mixed_radix_digits(ids.reshape(-1), self.in_shape)
        res = None
        for i in range(len(self.in_shape)):
            # core_i[:, digit, :, :] -> [T, r_i, n_i, r_{i+1}]
            g = getattr(self, f"core_{i}")[:, digits[i]].permute(1, 0, 2, 3)
            if res is None:
                res = g
            else:
                res = torch.einsum("tapb,tbqc->tapqc", res, g)
                t, a, p, q, c = res.shape
                res = res.reshape(t, a, p * q, c)
        y = res[:, 0, :, 0]                 # the boundary ranks are 1
        return y.reshape(*ids.shape, math.prod(self.out_shape))
