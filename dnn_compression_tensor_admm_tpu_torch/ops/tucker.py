"""Partial Tucker (Tucker-2) by HOSVD init + a fixed number of HOOI sweeps
(counterpart of the JAX package's `ops/tucker.py`).

For ``modes=(0, 1)`` and ``rank=(r0, r1)`` the result is
``core [r0, r1, *rest]`` and factors ``[U0 [n0, r0], U1 [n1, r1]]`` with
``x ~= core x_0 U0 x_1 U1``.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .svd import truncated_left_sv


def _unfold(x: torch.Tensor, mode: int) -> torch.Tensor:
    return torch.movedim(x, mode, 0).reshape(x.shape[mode], -1)


def _mode_dot_t(x: torch.Tensor, u: torch.Tensor, mode: int) -> torch.Tensor:
    """Contract mode `mode` of `x` with `u.T` (u: [n_mode, r])."""
    return torch.movedim(torch.movedim(x, mode, -1) @ u, -1, mode)


def partial_tucker(x: torch.Tensor, rank: Sequence[int],
                   modes: Sequence[int] = (0, 1), n_iter: int = 10,
                   method: str = "svd"):
    """Tucker decomposition over a subset of modes -> (core, factors),
    factors ordered like `modes`."""
    modes = list(modes)
    ranks = [min(r, x.shape[m]) for r, m in zip(rank, modes)]

    def left_sv_padded(a, r):
        # The HOOI sweep unfolds the other-modes-contracted tensor, whose
        # width can fall below the requested rank. The extra basis
        # columns are zero: u @ u.T is unchanged and the factor keeps
        # the spec's rank.
        eff = min(r, a.shape[0], a.shape[1])
        u = truncated_left_sv(a, eff, method=method)
        if u.shape[1] < r:
            u = torch.nn.functional.pad(u, (0, r - u.shape[1]))
        return u

    factors = [left_sv_padded(_unfold(x, m), r) for m, r in zip(modes, ranks)]
    for _ in range(n_iter):
        for k, m in enumerate(modes):
            y = x
            for j, mj in enumerate(modes):
                if j != k:
                    y = _mode_dot_t(y, factors[j], mj)
            factors[k] = left_sv_padded(_unfold(y, m), ranks[k])
    core = x
    for u, m in zip(factors, modes):
        core = _mode_dot_t(core, u, m)
    return core, factors


def tucker_to_tensor(core: torch.Tensor, factors: Sequence[torch.Tensor],
                     modes: Sequence[int] = (0, 1)) -> torch.Tensor:
    """Reconstruct from a partial Tucker decomposition."""
    x = core
    for u, m in zip(factors, modes):
        x = torch.movedim(torch.movedim(x, m, -1) @ u.T, -1, m)
    return x


def tucker2_project(x: torch.Tensor, out_rank: int, in_rank: int,
                    n_iter: int = 10, method: str = "svd") -> torch.Tensor:
    """Project `x` onto tensors of mode-0/mode-1 multilinear ranks
    (out_rank, in_rank)."""
    core, factors = partial_tucker(x, (out_rank, in_rank), modes=(0, 1),
                                   n_iter=n_iter, method=method)
    return tucker_to_tensor(core, factors, modes=(0, 1))
