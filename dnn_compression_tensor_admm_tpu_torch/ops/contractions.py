"""Merging TT cores for the factorized layers' forwards (counterpart of
the JAX package's `ops/contractions.py`).

The small cores are contracted into one matrix per chain once per
forward, so the activations meet only 1x1 convolutions and the core
convolution, never a chain of per-core reshapes.
"""

from __future__ import annotations

from typing import Sequence

import torch


def merge_tt_cores(cores: Sequence[torch.Tensor]) -> torch.Tensor:
    """Contract a chain of TT cores [r_i, n_i, r_{i+1}] into
    ``[r_first, prod(n_i), r_last]``."""
    t = cores[0]
    for core in cores[1:]:
        r = core.shape[0]
        t = t.reshape(-1, r) @ core.reshape(r, -1)
    return t.reshape(cores[0].shape[0], -1, cores[-1].shape[-1])


def merge_tt_matrix(cores: Sequence[torch.Tensor]) -> torch.Tensor:
    """Merge a chain with one closed end into a matrix: an 'out' chain
    (r_first == 1) gives [prod(n), r_last], an 'in' chain (r_last == 1)
    gives [r_first, prod(n)]."""
    t = merge_tt_cores(cores)
    r0, n, r1 = t.shape
    if r0 == 1:
        return t.reshape(n, r1)
    if r1 == 1:
        return t.reshape(r0, n)
    raise ValueError(f"chain has open ranks on both ends: {tuple(t.shape)}")
