"""TT-factorized embedding with a tensorized index lookup (counterpart of
the JAX package's `nlp/tt_embedding.py`).

The vocab axis is factored into `input_tt_shape` and the embedding axis
into `output_tt_shape`. A token id is split into mixed-radix digits over
the input shapes, each input core is gathered at its digit, and the
gathered slices chain-contract into one [r_mid] vector a token, which
meets the merged output chain [r_mid, features] (`merge_tt_matrix`).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.contractions import merge_tt_matrix
from ..ops.ttd import clamp_tt_ranks
from .factorization import compute_ranks_tt, split_to_factors
from .initializers import xavier_uniform_


def mixed_radix_digits(ids: torch.Tensor, shape: Sequence[int]):
    """Digits of `ids` over `shape`, most significant (shape[0]) first."""
    digits, rem = [], ids
    for place in reversed(range(1, len(shape))):
        digits.append(rem % shape[place])
        rem = rem // shape[place]
    digits.append(rem)
    return digits[::-1]


class TTEmbedding(nn.Module):
    """TT embedding table [prod(input_tt_shape), prod(output_tt_shape)];
    cores ``core_i`` [r_i, n_i, r_{i+1}], the input shapes first. Ranks
    are `tt_ranks` or solved from `compression_ratio`, then clamped."""

    def __init__(self, num_embeddings: int, features: int,
                 input_tt_shape: Optional[Sequence[int]] = None,
                 output_tt_shape: Optional[Sequence[int]] = None,
                 tt_ranks: Optional[Sequence[int]] = None,
                 compression_ratio: Optional[float] = None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        in_shape = tuple(input_tt_shape or split_to_factors(num_embeddings, 3))
        out_shape = tuple(output_tt_shape or split_to_factors(features, 2))
        assert math.prod(in_shape) >= num_embeddings
        assert math.prod(out_shape) == features
        shapes = in_shape + out_shape
        ranks = (list(tt_ranks) if tt_ranks is not None
                 else compute_ranks_tt(shapes, compression_ratio or 4.0))
        ranks = clamp_tt_ranks(shapes, ranks)
        self.in_shape, self.out_shape = in_shape, out_shape
        self.ranks = tuple(ranks)
        self.features = features
        for i, n in enumerate(shapes):
            self.register_parameter(f"core_{i}", nn.Parameter(xavier_uniform_(
                torch.empty(ranks[i], n, ranks[i + 1]), generator)))

    def cores(self):
        return [getattr(self, f"core_{i}")
                for i in range(len(self.in_shape) + len(self.out_shape))]

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        cores = self.cores()
        n_in = len(self.in_shape)
        digits = mixed_radix_digits(ids.reshape(-1), self.in_shape)
        # core_i[:, digit_i, :] -> [T, r_i, r_{i+1}], chained per token
        red = cores[0][:, digits[0], :].permute(1, 0, 2)
        for i in range(1, n_in):
            red = torch.bmm(red, cores[i][:, digits[i], :].permute(1, 0, 2))
        y = red[:, 0, :] @ merge_tt_matrix(cores[n_in:])  # [T, features]
        return y.reshape(*ids.shape, self.features)

    @staticmethod
    def num_params(in_shape, out_shape, ranks) -> int:
        shapes = tuple(in_shape) + tuple(out_shape)
        return sum(ranks[i] * shapes[i] * ranks[i + 1]
                   for i in range(len(shapes)))
