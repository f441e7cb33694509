"""Batched Tucker-2 factor solve: the ADMM Z-step's kernel.

Counterpart of the JAX package's Pallas kernel
(`ops/pallas/tucker_kernel.py::tucker2_factors_batched`). For each layer
of an x[L, K, O, I] stack it computes the mode-0/mode-1 Grams, a HOSVD
start by orthogonal iteration (INIT_ITERS steps) and `sweeps` warm-started
HOOI sweeps (SWEEP_ITERS steps each), orthonormalising by Newton-Schulz
(NS_ITERS steps); the CUDA source `csrc/tucker2_factors.cu` says how.

`tucker2_factors_batched` launches the CUDA kernel for a CUDA tensor and
runs `tucker2_factors_plain`, the same iteration in batched torch
matmuls, for a CPU tensor. `tucker2_project_batched` rebuilds
Z_k = U0 (U0^T X_k U1) U1^T from the factors.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..precision import full_f32
from . import build

# Dynamic shared memory one block may use on Hopper (H100/H200: 227 KB).
MAX_SMEM_BYTES = 232_448

# The reference kernel's iteration counts; the CUDA source fixes the same
# values as kInitIters, kSweepIters and kNsIters.
INIT_ITERS = 8
SWEEP_ITERS = 3
NS_ITERS = 12


MAX_SMEM_FLOATS = MAX_SMEM_BYTES // 4


def _up4(x: int) -> int:
    return (x + 3) & ~3


def _odd4(x: int) -> int:
    """The least multiple of 4 >= x that is an odd number of float4s."""
    s = _up4(x)
    return s if s & 4 else s + 4


def _plan(k: int, o: int, i: int, r0: int, r1: int):
    """(floats, resident, k per HOOI group) of one block's shared-memory
    plan, as `make_plan` in the CUDA source.

    Resident (X held in shared memory), every size rounded up to 4: X
    [K, op, odd4(ip)], the Gram, U0, U1, then the larger of Y plus five
    Newton-Schulz matrices and a group of HOOI products M_k [op,
    odd4(r1p)] / N_k [r0p, ip], as many k as fit, in groups of equal size.
    Where that does not fit, the streamed plan: the first version's
    unpadded plan, n^2 + O r0 + I r1 + n r + max(O r1, r0 I) + 5 r^2
    floats (n = max(O, I), r = max(r0, r1))."""
    op, ip, r0p, r1p = _up4(o), _up4(i), _up4(r0), _up4(r1)
    npad, rp = max(op, ip), max(r0p, r1p)
    fixed = k * op * _odd4(ip) + npad * npad + op * r0p + ip * r1p
    per_k = max(op * _odd4(r1p), r0p * ip)
    room = MAX_SMEM_FLOATS - fixed
    fit = min(k, room // per_k) if room > 0 else 0
    kg = -(-k // -(-k // fit)) if fit > 0 else 0
    total = fixed + max(npad * rp + 5 * rp * rp, kg * per_k)
    if kg > 0 and total <= MAX_SMEM_FLOATS:
        return total, True, kg
    n, r = max(o, i), max(r0, r1)
    base = n * n + o * r0 + i * r1 + n * r + max(o * r1, r0 * i) + 5 * r * r
    return base, False, 0


def smem_bytes(k: int, o: int, i: int, r0: int, r1: int) -> int:
    """Bytes of one block's plan for a [K, O, I] layer
    (`tucker2_factors_smem_bytes`)."""
    return 4 * _plan(k, o, i, r0, r1)[0]


def resident_plan(k: int, o: int, i: int, r0: int, r1: int) -> bool:
    """True if the launch holds X in shared memory; shapes whose X does not
    fit take the streamed plan."""
    return _plan(k, o, i, r0, r1)[1]


def kernel_supported(shape, r0: int, r1: int) -> bool:
    """True if an [L, K, O, I] bucket fits the kernel's shared-memory plan
    (the role of the JAX package's `pallas_tk_supported`): every shape
    whose first version's plan fits, and more where X is small."""
    if len(shape) != 4:
        return False
    _, k, o, i = shape
    r0, r1 = min(r0, o), min(r1, i)
    return (r0 >= 1 and r1 >= 1
            and smem_bytes(k, o, i, r0, r1) <= MAX_SMEM_BYTES)


def ns_flops(r: int) -> int:
    """Operations of one Newton-Schulz inverse square root of an r x r
    matrix (2 per multiply-add)."""
    return NS_ITERS * 3 * 2 * r ** 3


def orth_flops(n: int, r: int, iters: int) -> int:
    """Operations of `iters` orthogonal-iteration steps on an n x n Gram:
    Y = G Q, S = Y^T Y, the inverse square root, Q = Y S^{-1/2}."""
    return iters * (2 * n * n * r + 2 * n * r * r + ns_flops(r)
                    + 2 * n * r * r)


def factor_flops(shape, r0: int, r1: int, *, sweeps: int = 2) -> int:
    """Floating-point operations of one solve (2 per multiply-add)."""
    l, k, o, i = shape
    r0, r1 = min(r0, o), min(r1, i)
    total = 0
    if r0 < o:
        total += 2 * k * o * o * i + orth_flops(o, r0, INIT_ITERS)
        total += sweeps * (k * (2 * o * i * r1 + 2 * o * o * r1)
                           + orth_flops(o, r0, SWEEP_ITERS))
    if r1 < i:
        total += 2 * k * i * i * o + orth_flops(i, r1, INIT_ITERS)
        total += sweeps * (k * (2 * r0 * o * i + 2 * i * i * r0)
                           + orth_flops(i, r1, SWEEP_ITERS))
    return l * total


# ---------------------------------------------------------------------------
# plain version: the same iteration in batched torch matmuls


def _eye(l: int, n: int, r: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, r, dtype=like.dtype, device=like.device).expand(
        l, n, r).contiguous()


def _ns_inv_sqrt(s: torch.Tensor) -> torch.Tensor:
    r = s.shape[-1]
    eye = torch.eye(r, dtype=s.dtype, device=s.device)
    c = torch.diagonal(s, dim1=-2, dim2=-1).sum(-1)[:, None, None] + 1e-30
    y = s / c + 1e-6 * eye
    z = eye.expand_as(s)
    for _ in range(NS_ITERS):
        w = 0.5 * (3.0 * eye - z @ y)
        y = y @ w
        z = w @ z
    return z * torch.rsqrt(c)


def _orth_iter(g, q, iters: int):
    for _ in range(iters):
        y = g @ q
        s = y.transpose(-1, -2) @ y
        q = y @ _ns_inv_sqrt(s)
    return q


def _gram0(ms):  # sum_k M_k M_k^T, summed in k order like the reference
    acc = None
    for m in ms:
        p = m @ m.transpose(-1, -2)
        acc = p if acc is None else acc + p
    return acc


def _gram1(ms):  # sum_k M_k^T M_k
    acc = None
    for m in ms:
        p = m.transpose(-1, -2) @ m
        acc = p if acc is None else acc + p
    return acc


@full_f32()
def tucker2_factors_plain(x: torch.Tensor, r0: int, r1: int, *,
                          sweeps: int = 2):
    """The kernel's iteration in torch: x [L, K, O, I] -> (U0, U1), in
    full float32 whatever the process's TF32 setting."""
    l, k, o, i = x.shape
    r0, r1 = min(r0, o), min(r1, i)
    x = x.float()
    xs = [x[:, kk] for kk in range(k)]
    u0 = _eye(l, o, r0, x)
    u1 = _eye(l, i, r1, x)
    if r0 < o:
        u0 = _orth_iter(_gram0(xs), u0, INIT_ITERS)
    if r1 < i:
        u1 = _orth_iter(_gram1(xs), u1, INIT_ITERS)
    for _ in range(sweeps):
        if r0 < o:
            u0 = _orth_iter(_gram0([xk @ u1 for xk in xs]), u0, SWEEP_ITERS)
        if r1 < i:
            u0t = u0.transpose(-1, -2)
            u1 = _orth_iter(_gram1([u0t @ xk for xk in xs]), u1, SWEEP_ITERS)
    return u0.contiguous(), u1.contiguous()


# ---------------------------------------------------------------------------
# the CUDA kernel


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C interface of a loaded `tucker2_factors` library."""
    fn = lib.tucker2_factors_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.tucker2_factors_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.tucker2_factors_smem_bytes.restype = ctypes.c_int
    return lib


def _library() -> ctypes.CDLL:
    return bind(build.load("tucker2_factors"))


def launch(lib: ctypes.CDLL, x: torch.Tensor, r0: int, r1: int, *,
           sweeps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of `lib`'s kernel on x's device and current stream:
    x [L, K, O, I] float32, contiguous, on a CUDA card -> (U0, U1); the
    caller has checked the shape and clamped the ranks."""
    l, k, o, i = x.shape
    u0 = torch.empty((l, o, r0), dtype=torch.float32, device=x.device)
    u1 = torch.empty((l, i, r1), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.tucker2_factors_launch(
            x.data_ptr(), u0.data_ptr(), u1.data_ptr(), l, k, o, i, r0, r1,
            sweeps, stream)
    if err != 0:
        raise RuntimeError(f"tucker2_factors kernel launch failed: CUDA error {err}")
    return u0, u1


def tucker2_factors_batched(x: torch.Tensor, r0: int, r1: int, *,
                            sweeps: int = 2
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched Tucker-2 factor solve: x [L, K, O, I] float32, contiguous ->
    (U0 [L, O, r0], U1 [L, I, r1]) with r0, r1 clamped to O, I.

    A CUDA tensor goes through the CUDA kernel (or raises); a CPU tensor
    through the plain version. `tucker2_factors_batched.launches` counts
    kernel launches."""
    if x.dim() != 4:
        raise ValueError(f"expected x [L, K, O, I], got shape {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"expected float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    l, k, o, i = x.shape
    r0, r1 = min(r0, o), min(r1, i)
    if r0 < 1 or r1 < 1:
        raise ValueError(f"ranks must be >= 1, got ({r0}, {r1})")
    if x.device.type == "cpu":
        return tucker2_factors_plain(x, r0, r1, sweeps=sweeps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not kernel_supported(x.shape, r0, r1):
        raise ValueError(f"bucket {tuple(x.shape)} at ranks ({r0}, {r1}) "
                         "exceeds the kernel's shared-memory plan")
    u0, u1 = launch(_library(), x, r0, r1, sweeps=sweeps)
    tucker2_factors_batched.launches += 1
    return u0, u1


tucker2_factors_batched.launches = 0


@full_f32()
def tucker2_reconstruct(x: torch.Tensor, u0: torch.Tensor,
                        u1: torch.Tensor) -> torch.Tensor:
    """Z_k = U0 (U0^T X_k U1) U1^T for x [L, K, O, I], in float32."""
    xf = x.float()
    core = torch.einsum("lkoi,lor,lis->lkrs", xf, u0, u1)
    return torch.einsum("lkrs,lor,lis->lkoi", core, u0, u1).to(x.dtype)


def tucker2_project_batched(x: torch.Tensor, r0: int, r1: int, *,
                            sweeps: int = 2) -> torch.Tensor:
    """Batched Tucker-2 projection: x [L, K, O, I] -> Z of the same shape."""
    u0, u1 = tucker2_factors_batched(x, r0, r1, sweeps=sweeps)
    return tucker2_reconstruct(x, u0, u1)
