"""Kronecker-product ("word2ket") embeddings (counterpart of the JAX
package's `nlp/ket_embedding.py`; the reference's
xcompression/transformer/embedding_utils.py).

* `KetEmbedding` — only the feature axis is factorized: leaves
  ``weight_leafs`` [order, rank, vocab, d_leaf], d_leaf = ceil(D **
  (1/order)); row v is sum_r leaf[0, r, v] (x) leaf[1, r, v] (x) ...,
  cut to D features.
* `KetXSEmbedding` — both axes factorized: leaves [order, rank, v_leaf,
  d_leaf]; the table is sum_r kron(leaf[0, r], ..., leaf[o-1, r]) cut to
  [vocab, D]. A token id splits into mixed-radix digits over the vocab
  leaves, leaf 0 most significant, so the lookup gathers leaf rows.
* `EarlyStopping` and `fit_ket_to_dense`: the leaves fitted to a dense
  table by MSE with Adam and early stopping.

The forward gathers each token's leaf rows first and builds the Kronecker
chain on those [..., rank, d_leaf] slices: O(tokens * rank * D), never
the [V, D] table (`full_table` builds it, for fitting only).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from .initializers import normal_, xavier_uniform_
from .tt_embedding import mixed_radix_digits


class EarlyStopping:
    """Patience-based stopper (reference embedding_utils.py:20-67)."""

    def __init__(self, mode: str = "min", min_delta: float = 0.0,
                 patience: int = 10, percentage: bool = False):
        if mode not in ("min", "max"):
            raise ValueError(f"mode {mode} is unknown")
        self.mode, self.min_delta, self.percentage = mode, min_delta, percentage
        self.patience = patience
        self.best = None
        self.num_bad_epochs = 0

    def _is_better(self, a, best) -> bool:
        d = best * self.min_delta / 100 if self.percentage else self.min_delta
        return a < best - d if self.mode == "min" else a > best + d

    def step(self, metric: float) -> bool:
        """True when training should stop."""
        if self.patience == 0:
            return False
        if self.best is None:
            self.best = metric
            return False
        if not np.isfinite(metric):
            return True
        if self._is_better(metric, self.best):
            self.num_bad_epochs = 0
            self.best = metric
        else:
            self.num_bad_epochs += 1
        return self.num_bad_epochs >= self.patience


def _khatri_rao_chain(slices) -> torch.Tensor:
    """slices: [order, ..., d_leaf] -> [..., d_leaf ** order], the
    row-wise Kronecker chain, leaf 0 most significant."""
    acc = slices[0]
    for i in range(1, len(slices)):
        acc = acc[..., :, None] * slices[i][..., None, :]
        acc = acc.reshape(*acc.shape[:-2], -1)
    return acc


def ket_rank_from_ratio(num_embeddings: int, features: int, order: int,
                        ratio: float, xs: bool = False) -> int:
    """Smallest rank whose leaves compress the dense [V, D] table by at
    least `ratio`."""
    d_leaf = math.ceil(features ** (1.0 / order))
    v_leaf = math.ceil(num_embeddings ** (1.0 / order)) if xs else num_embeddings
    per_rank = order * v_leaf * d_leaf
    return max(1, int(num_embeddings * features / ratio / per_rank))


class KetEmbedding(nn.Module):
    def __init__(self, num_embeddings: int, features: int, order: int = 2,
                 rank: Optional[int] = None,
                 compression_ratio: Optional[float] = None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.features = features
        self.d_leaf = math.ceil(features ** (1.0 / order))
        self.rank = rank or ket_rank_from_ratio(
            num_embeddings, features, order, compression_ratio or 4.0)
        self.weight_leafs = nn.Parameter(xavier_uniform_(torch.empty(
            order, self.rank, num_embeddings, self.d_leaf), generator))

    def full_table(self) -> torch.Tensor:
        """The [V, D] table (reference get_weights): for fitting only."""
        return _khatri_rao_chain(self.weight_leafs).sum(0)[:, :self.features]

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        leaves = self.weight_leafs[:, :, ids]        # [order, r, ..., d]
        return _khatri_rao_chain(leaves).sum(0)[..., :self.features]


class KetXSEmbedding(nn.Module):
    def __init__(self, num_embeddings: int, features: int, order: int = 4,
                 rank: Optional[int] = None,
                 compression_ratio: Optional[float] = None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_embeddings, self.features, self.order = (
            num_embeddings, features, order)
        self.v_leaf = math.ceil(num_embeddings ** (1.0 / order))
        self.d_leaf = math.ceil(features ** (1.0 / order))
        self.rank = rank or ket_rank_from_ratio(
            num_embeddings, features, order, compression_ratio or 4.0,
            xs=True)
        self.weight_leafs = nn.Parameter(normal_(torch.empty(
            order, self.rank, self.v_leaf, self.d_leaf), 1.0, generator))

    def full_table(self) -> torch.Tensor:
        w = self.weight_leafs                        # [o, r, vl, dl]
        acc = w[0]
        for i in range(1, self.order):
            # Kronecker product over both axes, rows leaf 0 first
            acc = acc[:, :, None, :, None] * w[i][:, None, :, None, :]
            acc = acc.reshape(acc.shape[0], acc.shape[1] * acc.shape[2], -1)
        return acc.sum(0)[:self.num_embeddings, :self.features]

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        digits = mixed_radix_digits(ids, (self.v_leaf,) * self.order)
        leaves = [self.weight_leafs[i][:, digits[i]]  # [r, ..., d] each
                  for i in range(self.order)]
        return _khatri_rao_chain(leaves).sum(0)[..., :self.features]


def fit_ket_to_dense(module: nn.Module, dense, steps: int = 1000,
                     lr: float = 1e-2, patience: int = 6, print_fn=None):
    """Fit `module`'s leaves (as initialised) to a dense [V, D] table by
    MSE (reference BaseEmbedding.initialize) with Adam at optax's
    defaults (betas 0.9 / 0.999, eps 1e-8, bias correction, no decay),
    stopping early. Returns the final loss."""
    dense = torch.as_tensor(dense, dtype=torch.float32,
                            device=module.weight_leafs.device)
    opt = torch.optim.Adam(module.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    es = EarlyStopping(patience=patience)
    loss = float("inf")
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        l = torch.mean((module.full_table() - dense) ** 2)
        l.backward()
        opt.step()
        loss = float(l.detach())
        if print_fn is not None and i % 100 == 0:
            print_fn(f"ket fit step {i}: mse {loss:.6f}")
        if es.step(loss):
            break
    return loss
