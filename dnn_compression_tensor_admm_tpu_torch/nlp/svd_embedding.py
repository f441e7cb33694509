"""SVD-factorized embedding (counterpart of the JAX package's
`nlp/svd_embedding.py`): table = A [vocab, r] @ B [r, features]; a
lookup gathers rows of A, then one small product."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .factorization import compute_rank_svd
from .initializers import normal_


class SVDEmbedding(nn.Module):
    def __init__(self, num_embeddings: int, features: int,
                 rank: Optional[int] = None,
                 compression_ratio: Optional[float] = None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        r = rank or compute_rank_svd(num_embeddings, features,
                                     compression_ratio or 4.0)
        self.first_factor = nn.Parameter(
            normal_(torch.empty(num_embeddings, r), 0.02, generator))
        self.last_factor = nn.Parameter(
            normal_(torch.empty(r, features), 0.02, generator))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.first_factor) @ self.last_factor
