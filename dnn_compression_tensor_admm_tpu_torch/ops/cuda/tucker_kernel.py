"""Batched Tucker-2 factor solve: the ADMM Z-step's kernel.

Counterpart of the JAX package's Pallas kernel
(`ops/pallas/tucker_kernel.py::tucker2_factors_batched`). For each layer
of an x[L, K, O, I] stack it computes the mode-0/mode-1 Grams, a HOSVD
start by orthogonal iteration (INIT_ITERS steps) and `sweeps` warm-started
HOOI sweeps (SWEEP_ITERS steps each), orthonormalising by Newton-Schulz
(NS_ITERS steps); the CUDA source `csrc/tucker2_factors.cu` says how.

`tucker2_factors_batched` launches the CUDA kernel for a CUDA tensor and
runs `tucker2_factors_plain`, the same iteration in batched torch
matmuls, for a CPU tensor. A shape whose plan fits one block's shared
memory takes a block plan (resident or streamed, `csrc/tucker2_factors.cu`);
any other takes the workspace plan (`csrc/tucker2_factors_ws.cu`, a
library of its own), which keeps what does not fit in a per-layer slab of
device memory that `launch_ws` allocates. `tucker2_project_batched` rebuilds
Z_k = U0 (U0^T X_k U1) U1^T from the factors.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from ..precision import full_f32
from . import build
from .launches import count_launch

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
    (`tucker2_factors_smem_bytes`); more than a block may have where the
    shape takes the workspace plan."""
    return 4 * _plan(k, o, i, r0, r1)[0]


def resident_plan(k: int, o: int, i: int, r0: int, r1: int) -> bool:
    """True if the launch holds X in shared memory; shapes whose X does not
    fit take the streamed plan."""
    return _plan(k, o, i, r0, r1)[1]


def block_plan_fits(k: int, o: int, i: int, r0: int, r1: int) -> bool:
    """True if the shape takes a block plan, False if the workspace plan."""
    return smem_bytes(k, o, i, r0, r1) <= MAX_SMEM_BYTES


# Chunk length along a Gram of X's summed side that the workspace plan's
# stage buffers grow for (kStageLen in the CUDA source).
STAGE_LEN = 64

# regions of the workspace plan, in the order they are taken into shared
# memory (`make_ws_plan`): the Newton-Schulz matrices, the partial S, the
# Gram, Y, the factors, the HOOI products
WS_REGIONS = ("ns", "sp", "g", "y", "u", "m")


class WsPlan(NamedTuple):
    cluster: int       # blocks per layer (one thread-block cluster)
    smem_floats: int   # shared memory of each block, the stage buffers included
    ws_floats: int     # device memory per layer
    in_ws: Tuple[str, ...]  # regions in the workspace
    stage: int         # floats of each of the two stage buffers
    ldc: int           # the longer chunk row stride (G0's or G1's)
    kg: int            # k per HOOI product phase


def ws_cluster(o: int, i: int) -> int:
    """Blocks per layer of the workspace plan (`ws_cluster`): 8 from 192
    padded rows of O or I, 4 from 96, 2 from 48, else 1."""
    npad = max(_up4(o), _up4(i))
    return 8 if npad >= 192 else 4 if npad >= 96 else 2 if npad >= 48 else 1


def split_lo(n: int, q: int, c: int) -> int:
    """First of the rows of an n-row matrix (n a multiple of 4) that block
    q of a c-block cluster owns: groups of 4 rows spread evenly."""
    return 4 * ((n // 4) * q // c)


def _own_cap(n: int, c: int) -> int:
    return 4 * -(-(n // 4) // c)


def ws_plan(k: int, o: int, i: int, r0: int, r1: int,
            cluster: int = 0) -> WsPlan:
    """The workspace plan of a [K, O, I] layer, as `make_ws_plan` in the
    CUDA source, for `cluster` blocks per layer (default `ws_cluster`).

    The padded layout; each block of the cluster owns rows (groups of 4,
    spread evenly) of every region, in this order: the five Newton-Schulz
    matrices [rp, rp], the partial S [rp, rp] (whole in each block, with
    rp floats for the trace's diagonal), the Gram [np, np], Y [np, rp],
    U0 and U1, and HOOI products M_k [op, r1p] / N_k^T [ip, r0p], as many
    k as fit, in groups of equal size. A block takes its rows of each
    region into shared memory in that order while they fit beside two
    stage buffers of one row of X's Gram chunks (`ldc`) at least, and of
    rp x rp where two fit a block; a region that does not fit lies whole
    in the layer's slab (the partial S once per block). The partial S
    shares the scratch region with the stage buffers."""
    c = cluster or ws_cluster(o, i)
    op, ip, r0p, r1p = _up4(o), _up4(i), _up4(r0), _up4(r1)
    npad, rp = max(op, ip), max(r0p, r1p)
    ldc = max(op + 4, ip)
    rbn, rbr = _own_cap(npad, c), _own_cap(rp, c)
    rb0, rb1 = _own_cap(op, c), _own_cap(ip, c)
    per_k = max(rb0 * r1p, rb1 * r0p)
    own = {"ns": 5 * rbr * rp, "sp": rp * rp + rp, "g": rbn * npad,
           "u": rb0 * r0p + rb1 * r1p, "y": rbn * rp}
    whole = {"ns": 5 * rp * rp, "sp": c * rp * rp, "g": npad * npad,
             "u": op * r0p + ip * r1p, "y": npad * rp,
             "m": k * max(op * r1p, ip * r0p)}
    # two stage buffers of a chunk row at least, and of a whole
    # Newton-Schulz matrix where two fit a block
    rr = rp * rp
    persist = 0
    scratch = 2 * (ldc if ldc >= rr or 2 * rr > MAX_SMEM_FLOATS else rr)
    in_ws = []
    kg = k
    for name in WS_REGIONS:
        if name == "m":
            room = MAX_SMEM_FLOATS - persist - scratch
            fit = min(k, room // per_k) if room >= per_k else 0
            kg = -(-k // -(-k // fit)) if fit > 0 else k
            own["m"] = kg * per_k
        if name == "sp":
            fits = persist + max(scratch, own["sp"]) <= MAX_SMEM_FLOATS
            if fits:
                scratch = max(scratch, own["sp"])
        else:
            fits = persist + own[name] + scratch <= MAX_SMEM_FLOATS
            if fits:
                persist += own[name]
        if not fits:
            in_ws.append(name)
            if name == "m":
                kg = k
    want = max(STAGE_LEN * ldc, npad * rp)
    stage = min((MAX_SMEM_FLOATS - persist) // 2, want) & ~3
    total = persist + max(2 * stage, 0 if "sp" in in_ws else rp * rp + rp)
    return WsPlan(c, total, sum(whole[n] for n in in_ws), tuple(in_ws),
                  stage, ldc, kg)


def plan_name(k: int, o: int, i: int, r0: int, r1: int) -> str:
    """'resident' or 'streamed' (block plans) or 'workspace'."""
    if not block_plan_fits(k, o, i, r0, r1):
        return "workspace"
    return "resident" if resident_plan(k, o, i, r0, r1) else "streamed"


# The CUDA source indexes within a layer, and sizes and places its plans'
# regions, in 32-bit int.
INT_MAX = 2 ** 31 - 1


def kernel_supported(shape, r0: int, r1: int) -> bool:
    """True if the kernel takes an [L, K, O, I] bucket (the role of the
    JAX package's `pallas_tk_supported`): a block plan fits, or the
    workspace plan's chunk buffers hold at least one row of X_k (O + 4 and
    I up to about 29,000). A shape whose layer (K O I) or padded regions
    (all of them with every HOOI product, which bounds every offset and
    the per-layer workspace) pass 2**31 - 1 floats is refused, since the
    kernel's int arithmetic would overflow."""
    if len(shape) != 4:
        return False
    _, k, o, i = shape
    r0, r1 = min(r0, o), min(r1, i)
    if r0 < 1 or r1 < 1:
        return False
    op, ip, r0p, r1p = _up4(o), _up4(i), _up4(r0), _up4(r1)
    npad, rp = max(op, ip), max(r0p, r1p)
    regions = (5 * rp * rp + npad * npad + op * r0p + ip * r1p + npad * rp
               + k * max(op * r1p, r0p * ip))
    if max(k * o * i, regions) > INT_MAX:
        return False
    if block_plan_fits(k, o, i, r0, r1):
        return True
    p = ws_plan(k, o, i, r0, r1)
    return p.stage >= p.ldc


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


def bind_ws(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C interface of a loaded `tucker2_factors_ws` library."""
    fn = lib.tucker2_factors_ws_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    for name, restype in (("tucker2_factors_ws_cluster", ctypes.c_int),
                          ("tucker2_factors_ws_smem_bytes", ctypes.c_int),
                          ("tucker2_factors_ws_floats", ctypes.c_longlong),
                          ("tucker2_factors_ws_max_clusters", ctypes.c_int)):
        getattr(lib, name).argtypes = [ctypes.c_int] * 5
        getattr(lib, name).restype = restype
    return lib


def _library() -> ctypes.CDLL:
    return bind(build.load("tucker2_factors"))


def _ws_library() -> ctypes.CDLL:
    return bind_ws(build.load("tucker2_factors_ws"))


def launch(lib: ctypes.CDLL, x: torch.Tensor, r0: int, r1: int, *,
           sweeps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of `lib`'s kernel (a block plan) on x's device and
    current stream: x [L, K, O, I] float32, contiguous, on a CUDA card ->
    (U0, U1); the caller has checked the shape and clamped the ranks."""
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


def launch_ws(lib: ctypes.CDLL, x: torch.Tensor, r0: int, r1: int, *,
              sweeps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`launch` for the workspace plan of a `tucker2_factors_ws` library:
    one thread-block cluster of `ws_cluster(O, I)` blocks per layer, the
    per-layer slabs allocated here. A cluster the card cannot schedule
    makes the launch fail, and this raise."""
    l, k, o, i = x.shape
    u0 = torch.empty((l, o, r0), dtype=torch.float32, device=x.device)
    u1 = torch.empty((l, i, r1), dtype=torch.float32, device=x.device)
    # the library's own slab size (`ws_plan` mirrors it); torch's
    # allocations are 512-byte aligned, and every slab is a multiple of 4
    # floats
    ws = torch.empty(l * lib.tucker2_factors_ws_floats(k, o, i, r0, r1),
                     dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.tucker2_factors_ws_launch(
            x.data_ptr(), u0.data_ptr(), u1.data_ptr(), ws.data_ptr(), l, k,
            o, i, r0, r1, sweeps, stream)
    if err != 0:
        raise RuntimeError("tucker2_factors workspace kernel launch failed: "
                           f"CUDA error {err}")
    return u0, u1


def tucker2_factors_batched(x: torch.Tensor, r0: int, r1: int, *,
                            sweeps: int = 2
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched Tucker-2 factor solve: x [L, K, O, I] float32, contiguous ->
    (U0 [L, O, r0], U1 [L, I, r1]) with r0, r1 clamped to O, I.

    A CUDA tensor goes through the CUDA kernel (or raises); a CPU tensor
    through the plain version. `tucker2_factors_batched.launches` counts
    kernel launches, a captured one at each replay (`launches.py`)."""
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
                         "exceeds the kernel's plans")
    if block_plan_fits(k, o, i, r0, r1):
        u0, u1 = launch(_library(), x, r0, r1, sweeps=sweeps)
    else:
        u0, u1 = launch_ws(_ws_library(), x, r0, r1, sweeps=sweeps)
    count_launch(tucker2_factors_batched)
    return u0, u1


tucker2_factors_batched.launches = 0
tucker2_factors_batched.captured = 0


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
