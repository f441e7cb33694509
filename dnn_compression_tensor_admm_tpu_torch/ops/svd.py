"""Truncated SVD primitives (counterpart of the JAX package's `ops/svd.py`).

* ``method='svd'`` — exact `torch.linalg.svd`; decompose-at-init.
* ``method='subspace'`` — orthogonal iteration on the Gram matrix with
  twice-iterated Cholesky QR; the Z-step's route for buckets the CUDA
  kernel's gate refuses.
"""

from __future__ import annotations

import torch

from .precision import full_f32


def _cholqr(a: torch.Tensor) -> torch.Tensor:
    """Orthonormalize the columns of `a` [m, r] by Cholesky QR, twice."""
    eye = torch.eye(a.shape[1], dtype=a.dtype, device=a.device)
    r1 = torch.linalg.cholesky(a.T @ a + 1e-6 * eye)
    q = torch.linalg.solve_triangular(r1, a.T, upper=False).T
    r2 = torch.linalg.cholesky(q.T @ q + 1e-7 * eye)
    return torch.linalg.solve_triangular(r2, q.T, upper=False).T


@full_f32()
def truncated_left_sv(a: torch.Tensor, rank: int, method: str = "svd",
                      subspace_iters: int = 8) -> torch.Tensor:
    """Top-`rank` left singular vectors of 2-D `a`, as `u` [m, rank].

    Signs are unspecified; reconstructions ``u @ u.T @ a`` are not."""
    m = a.shape[0]
    rank = min(rank, m, a.shape[1])
    if rank == m:
        # full-rank subspace: the projection is exact, any basis works
        return torch.eye(m, dtype=a.dtype, device=a.device)
    if method == "subspace":
        g = a @ a.T
        q = torch.eye(m, rank, dtype=a.dtype, device=a.device)
        for _ in range(subspace_iters):
            q = _cholqr(g @ q)
        return q
    if method != "svd":
        raise ValueError(f"unknown method {method!r}")
    if m < a.shape[1]:
        # the left vectors of a wide matrix are the right vectors of its
        # transpose; the tall SVD is the fast one (CPU LAPACK took 150 ms
        # for a 64 x 576 unfolding wide, 2.5 ms tall)
        _, _, vh = torch.linalg.svd(a.T, full_matrices=False)
        return vh[:rank].T
    u, _, _ = torch.linalg.svd(a, full_matrices=False)
    return u[:, :rank]


@full_f32()
def truncated_svd(a: torch.Tensor, rank: int):
    """Rank-`rank` truncated SVD of 2-D `a` -> (u, s, vt)."""
    rank = min(rank, a.shape[0], a.shape[1])
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    return u[:, :rank], s[:rank], vt[:rank, :]


def svd_project(a: torch.Tensor, rank: int) -> torch.Tensor:
    """Closest (Frobenius) rank-`rank` matrix to `a` (Eckart-Young)."""
    u, s, vt = truncated_svd(a, rank)
    return (u * s[None, :]) @ vt
