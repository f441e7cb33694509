"""Truncated SVD primitives (counterpart of the JAX package's `ops/svd.py`).

* ``method='svd'`` — exact `torch.linalg.svd`; decompose-at-init.
* ``method='subspace'`` — orthogonal iteration on the Gram matrix with
  twice-iterated Cholesky QR; the Z-step's route for buckets the CUDA
  kernel's gate refuses.
* ``method='gram'`` — `torch.linalg.eigh` of the Gram matrix, its
  trailing `rank` eigenvectors, largest first.
* ``method='ns'`` — orthogonal iteration on the Gram matrix with
  Newton-Schulz orthonormalisation: matmuls only.

All run in full float32 (`full_f32`), as the JAX package runs them at
f32-HIGHEST. None raises on a non-finite input or a failed
factorization: the result is NaN, as `jnp.linalg`'s is, and nothing is
read back to the host (the ADMM guard, `admm/engine.py::_finite_or_prev`,
then keeps the layer's previous Z).
"""

from __future__ import annotations

import torch

from .precision import full_f32


def _cholesky(g: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of `g`, NaN where the factorization fails
    (`jnp.linalg.cholesky`'s result), with no check on the host."""
    l, info = torch.linalg.cholesky_ex(g)
    return torch.where(info == 0, l, torch.nan)


def _cholqr(a: torch.Tensor) -> torch.Tensor:
    """Orthonormalize the columns of `a` [m, r] by Cholesky QR, twice."""
    eye = torch.eye(a.shape[1], dtype=a.dtype, device=a.device)
    r1 = _cholesky(a.T @ a + 1e-6 * eye)
    q = torch.linalg.solve_triangular(r1, a.T, upper=False).T
    r2 = _cholesky(q.T @ q + 1e-7 * eye)
    return torch.linalg.solve_triangular(r2, q.T, upper=False).T


def _finite_input(a: torch.Tensor):
    """(ok, a or zeros): a 0-d device flag of whether `a` is finite, and
    the input a LAPACK call may take without raising. The caller puts
    NaN in its output where `ok` is false (`_or_nan`)."""
    ok = torch.isfinite(a).all()
    return ok, torch.where(ok, a, 0.0)


def _or_nan(ok: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.where(ok, t, torch.nan)


def _ns_orth(a: torch.Tensor, iters: int = 12) -> torch.Tensor:
    """Orthonormalize the columns of `a` [m, r] by the Newton-Schulz
    iteration for ``a (a^T a)^(-1/2)``, after scaling by the Frobenius norm
    (every singular value in (0, 1], inside the cubic convergence basin)."""
    x = a / (torch.linalg.vector_norm(a) + 1e-12)
    eye = torch.eye(a.shape[1], dtype=a.dtype, device=a.device)
    for _ in range(iters):
        s = x.T @ x
        x = x @ (0.125 * (15 * eye - s @ (10 * eye - 3 * s)))
    return x


METHODS = ("svd", "subspace", "gram", "ns")


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
    if method == "gram":
        # eigh's eigenvalues ascend: the trailing `rank` vectors, reversed
        ok, a = _finite_input(a)
        _, vecs = torch.linalg.eigh(a @ a.T)
        return _or_nan(ok, vecs[:, m - rank:].flip(1))
    if method in ("subspace", "ns"):
        orth = _cholqr if method == "subspace" else _ns_orth
        g = a @ a.T
        q = torch.eye(m, rank, dtype=a.dtype, device=a.device)
        for _ in range(subspace_iters):
            q = orth(g @ q)
        return q
    if method != "svd":
        raise ValueError(f"unknown method {method!r}; choose from {METHODS}")
    ok, a = _finite_input(a)
    if m < a.shape[1]:
        # the left vectors of a wide matrix are the right vectors of its
        # transpose; the tall SVD is the fast one (CPU LAPACK took 150 ms
        # for a 64 x 576 unfolding wide, 2.5 ms tall)
        _, _, vh = torch.linalg.svd(a.T, full_matrices=False)
        return _or_nan(ok, vh[:rank].T)
    u, _, _ = torch.linalg.svd(a, full_matrices=False)
    return _or_nan(ok, u[:, :rank])


@full_f32()
def truncated_svd(a: torch.Tensor, rank: int):
    """Rank-`rank` truncated SVD of 2-D `a` -> (u, s, vt)."""
    rank = min(rank, a.shape[0], a.shape[1])
    ok, a = _finite_input(a)
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    return (_or_nan(ok, u[:, :rank]), _or_nan(ok, s[:rank]),
            _or_nan(ok, vt[:rank, :]))


def svd_project(a: torch.Tensor, rank: int) -> torch.Tensor:
    """Closest (Frobenius) rank-`rank` matrix to `a` (Eckart-Young)."""
    u, s, vt = truncated_svd(a, rank)
    return (u * s[None, :]) @ vt


def svd_factors_scaled(a: torch.Tensor, rank: int):
    """Balanced rank-`rank` factorization ``a ~= p @ q`` -> (p [m, r],
    q [r, n]): sqrt(s) folded into each factor."""
    u, s, vt = truncated_svd(a, rank)
    rs = torch.sqrt(s)
    return u * rs[None, :], rs[:, None] * vt
