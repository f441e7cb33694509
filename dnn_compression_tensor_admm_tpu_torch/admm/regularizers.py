"""Auxiliary regularizers for factorized fine-tuning (counterpart of the
JAX package's `admm/regularizers.py`).

`orthogonal_penalty` is the reference's double-soft-orthogonality loss:
for every first/last factor P it adds ``0.5 * rho * ||P P^T - I||^2``.
"""

from __future__ import annotations

from typing import Mapping, Union

import torch

FACTOR_SUFFIXES = ("first_factor", "last_factor")


def orthogonal_penalty(params: Mapping[str, torch.Tensor],
                       rho: Union[float, torch.Tensor]) -> torch.Tensor:
    """0.5 * rho * sum over factor matrices P of ||P P^T - I||^2,
    differentiable in the factors.

    Takes the 2-D parameters whose names end in 'first_factor' or
    'last_factor' (the port keeps the JAX package's names and layout for
    both, `utils/jax_weights.py`); the Gram is the wide orientation's, r x r
    for P [r, n] with r <= n, and of P^T for a tall P. `rho` may be a 0-d
    tensor on the device, as `admm_penalty`'s."""
    total = 0.0
    for name, p in params.items():
        if not name.endswith(FACTOR_SUFFIXES) or p.dim() != 2:
            continue
        p = p.float()
        if p.shape[0] > p.shape[1]:
            p = p.T
        gram = p @ p.T
        eye = torch.eye(gram.shape[0], dtype=gram.dtype, device=gram.device)
        total = total + torch.sum((gram - eye) ** 2)
    return 0.5 * rho * total
