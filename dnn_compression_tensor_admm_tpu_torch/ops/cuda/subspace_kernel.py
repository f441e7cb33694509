"""Batched dominant left subspace: the TT Z-step's kernel.

Counterpart of the JAX package's Pallas kernel
(`ops/pallas/subspace_kernel.py::dominant_left_subspace_batched`). For
each layer of a t[L, rows, cols] stack it finds the top-r left singular
subspace by orthogonal iteration on the Gram of the smaller side, with
Newton-Schulz orthonormalisation, lifting a right subspace to the left
one in the tall case; the CUDA sources `csrc/subspace.cu` (block plans)
and `csrc/subspace_ws.cu` (workspace plan) say how.

`dominant_left_subspace_batched` launches the CUDA kernel for a CUDA
tensor and runs `dominant_left_subspace_plain`, the same iteration in
batched torch matmuls, for a CPU tensor. A shape whose plan fits one
block's shared memory takes the block plan; any other takes the
workspace plan (a library of its own: one thread-block cluster per
layer), which keeps what does not fit in a per-layer slab of device
memory that `launch_ws` allocates. `tt_project_batched` is the
batched TT-SVD sweep built on it.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Sequence, Tuple

import torch

from ..precision import full_f32
from ..ttd import clamp_tt_ranks
from . import build
from .launches import count_launch
from .tucker_kernel import (MAX_SMEM_BYTES, MAX_SMEM_FLOATS, _eye, _own_cap,
                            _ns_inv_sqrt, _orth_iter, ns_flops, orth_flops)


# Chunk length along the Gram's long side that the plans grow for
# (kStageLen in both CUDA sources).
STAGE_LEN = 64


def _up4(x: int) -> int:
    return (x + 3) & ~3


def _plan(rows: int, cols: int, r: int):
    """(floats, padded) of one block's shared-memory plan, as `make_plan`
    in the CUDA source.

    The unpadded plan holds the Gram of the smaller side, the iterate, Y
    (rows x r, which the tall lift needs) and five Newton-Schulz matrices.
    The padded plan (every size rounded up to 4) and two Gram chunks of
    STAGE_LEN along the long side may grow it, but only up to what a block
    may have: a shape fits if and only if its unpadded plan does, and takes
    the padded plan wherever that fits too."""
    m = min(rows, cols)
    base = m * m + m * r + rows * r + 5 * r * r
    mp, rp, yp = _up4(m), _up4(r), _up4(rows)
    padded = mp * mp + mp * rp + yp * rp + 5 * rp * rp
    want = max(padded, mp * mp + 2 * (mp + 4) * STAGE_LEN)
    total = max(base, min(want, MAX_SMEM_BYTES // 4))
    return total, padded <= total


def smem_bytes(rows: int, cols: int, r: int) -> int:
    """Bytes of one block's shared-memory plan (`subspace_smem_bytes`);
    more than a block may have where the shape takes the workspace plan."""
    return 4 * _plan(rows, cols, r)[0]


def padded_plan(rows: int, cols: int, r: int) -> bool:
    """True if the launch takes the padded block plan (float4 products);
    shapes near a block's limit take the unpadded one (scalar products)."""
    return _plan(rows, cols, r)[1]


def block_plan_fits(rows: int, cols: int, r: int) -> bool:
    """True if the shape takes a block plan, False if the workspace plan."""
    return smem_bytes(rows, cols, r) <= MAX_SMEM_BYTES


# Blocks per layer of the workspace plan, whatever the slice (`kCluster`
# in csrc/subspace_ws.cu): 8, the most a portable cluster has. At
# DeiT-tiny's r = 96 launches 8 blocks split the iteration's products; at
# its 2304 x 32 ones, whose 32 x 32 iteration barely splits, they split the
# Gram and the lift.
WS_CLUSTER = 8

# regions of the workspace plan, in the order they are taken into shared
# memory (`make_ws_plan`): the Newton-Schulz matrices, the partial S, the
# Gram, Y, the iterate
WS_REGIONS = ("ns", "sp", "g", "y", "q")


class WsPlan(NamedTuple):
    cluster: int       # blocks per layer (one thread-block cluster)
    smem_floats: int   # shared memory of each block, the stage buffers included
    ws_floats: int     # device memory per layer
    in_ws: Tuple[str, ...]  # regions in the workspace
    stage: int         # floats of each of the two stage buffers
    ldc: int           # the Gram's chunk row stride


def ws_plan(rows: int, cols: int, r: int, cluster: int = 0) -> WsPlan:
    """The workspace plan of a [rows, cols] slice at rank r, as
    `make_ws_plan` in csrc/subspace_ws.cu, for `cluster` blocks per layer
    (default WS_CLUSTER, the library's).

    The padded layout; each block of the cluster owns rows (groups of 4,
    spread evenly) of every region, in this order: the five Newton-Schulz
    matrices [rp, rp], the partial S [rp, rp] (whole in each block, with
    rp floats for the trace's diagonal), the Gram [mp, mp], Y [yp, rp] and
    the iterate [mp, rp] (m = min(rows, cols); mp, rp, yp = m, r, rows
    rounded up to 4). A block takes its rows of each region into shared
    memory in that order while they fit beside two stage buffers of one
    Gram chunk row (`ldc`) at least, and of rp x rp where two fit a block;
    a region that does not fit lies whole in the layer's slab (the partial
    S once per block). The partial S shares the scratch region with the
    stage buffers, which grow for 64 chunk rows, all of the iterate and,
    tall, all of t's columns of a block's rows with V."""
    c = cluster or WS_CLUSTER
    wide = rows <= cols
    mp, rp, yp = _up4(min(rows, cols)), _up4(r), _up4(rows)
    ldc = mp + 4 if wide else mp
    rbn, rby, rbr = _own_cap(mp, c), _own_cap(yp, c), _own_cap(rp, c)
    rr = rp * rp
    own = {"ns": 5 * rbr * rp, "sp": rr + rp, "g": rbn * mp, "y": rby * rp,
           "q": rbn * rp}
    whole = {"ns": 5 * rr, "sp": c * rr, "g": mp * mp, "y": yp * rp,
             "q": mp * rp}
    persist = 0
    scratch = 2 * (ldc if ldc >= rr or 2 * rr > MAX_SMEM_FLOATS else rr)
    in_ws = []
    for name in WS_REGIONS:
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
    want = max(STAGE_LEN * ldc, mp * rp,
               0 if wide else (rp + rby) * _up4(cols))
    stage = min((MAX_SMEM_FLOATS - persist) // 2, want) & ~3
    total = persist + max(2 * stage, 0 if "sp" in in_ws else rr + rp)
    return WsPlan(c, total, sum(whole[n] for n in in_ws), tuple(in_ws),
                  stage, ldc)


def plan_name(rows: int, cols: int, r: int) -> str:
    """'padded' or 'unpadded' (block plans) or 'workspace'."""
    if not block_plan_fits(rows, cols, r):
        return "workspace"
    return "padded" if padded_plan(rows, cols, r) else "unpadded"


# The CUDA source indexes within a layer, and sizes and places its plans'
# regions, in 32-bit int.
INT_MAX = 2 ** 31 - 1


def subspace_supported(shape, r: int) -> bool:
    """True if the kernel takes a [L, rows, cols] stack at rank r (the
    role of the JAX package's `pallas_subspace_supported`): a block plan
    fits, or the workspace plan's stage buffers hold at least one row of
    the Gram's chunks (min(rows, cols) up to about 29,000). A shape whose
    layer (rows x cols) or padded regions (all five whole, the partial S
    once per block of the cluster, which bounds every offset and the
    per-layer workspace) pass 2**31 - 1 floats is refused, since the
    kernel's int arithmetic would overflow."""
    if len(shape) != 3:
        return False
    _, rows, cols = shape
    r = min(r, rows, cols)
    if r < 1:
        return False
    mp, rp, yp = _up4(min(rows, cols)), _up4(r), _up4(rows)
    regions = mp * mp + mp * rp + yp * rp + (5 + WS_CLUSTER) * rp * rp
    if max(rows * cols, regions) > INT_MAX:
        return False
    if block_plan_fits(rows, cols, r):
        return True
    p = ws_plan(rows, cols, r)
    return p.stage >= p.ldc


def sweep_steps(tt_shapes: Sequence[int], tt_ranks: Sequence[int]):
    """(rows, cols, r) of each step of the TT-SVD sweep, ranks clamped."""
    shapes = list(tt_shapes)
    ranks = clamp_tt_ranks(shapes, tt_ranks)
    return [(ranks[i] * shapes[i], math.prod(shapes[i + 1:]) * ranks[-1],
             ranks[i + 1]) for i in range(len(shapes) - 1)]


def tt_supported(l: int, numel: int, tt_shapes: Sequence[int],
                 tt_ranks: Sequence[int]) -> bool:
    """True if every sweep step that launches fits the kernel (the role of
    the JAX package's `tt_supported_pallas`)."""
    if math.prod(tt_shapes) != numel:
        return False
    return all(r == rows or subspace_supported((l, rows, cols), r)
               for rows, cols, r in sweep_steps(tt_shapes, tt_ranks))


def subspace_flops(shape, r: int, *, iters: int) -> int:
    """Floating-point operations of one launch (2 per multiply-add); 0 for
    a full-rank request, which does not launch."""
    l, rows, cols = shape
    r = min(r, rows, cols)
    if r == rows:
        return 0
    if rows <= cols:
        return l * (2 * rows * rows * cols + orth_flops(rows, r, iters))
    lift = 2 * rows * cols * r + 2 * rows * r * r + ns_flops(r) \
        + 2 * rows * r * r
    return l * (2 * cols * cols * rows + orth_flops(cols, r, iters) + lift)


# ---------------------------------------------------------------------------
# plain version: the same iteration in batched torch matmuls


@full_f32()
def dominant_left_subspace_plain(t: torch.Tensor, r: int, *,
                                 iters: int) -> torch.Tensor:
    """The kernel's iteration in torch: t [L, rows, cols] -> q [L, rows, r],
    in full float32 whatever the process's TF32 setting."""
    l, rows, cols = t.shape
    r = min(r, rows, cols)
    if r == rows:
        return _eye(l, rows, rows, t)
    t = t.float()
    if rows <= cols:
        return _orth_iter(t @ t.mT, _eye(l, rows, r, t), iters).contiguous()
    v = _orth_iter(t.mT @ t, _eye(l, cols, r, t), iters)
    y = t @ v
    return (y @ _ns_inv_sqrt(y.mT @ y)).contiguous()


# ---------------------------------------------------------------------------
# the CUDA kernel


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C interface of a loaded `subspace` library."""
    fn = lib.subspace_launch
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.subspace_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.subspace_smem_bytes.restype = ctypes.c_int
    return lib


def bind_ws(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C interface of a loaded `subspace_ws` library."""
    fn = lib.subspace_ws_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.subspace_ws_cluster.argtypes = []
    lib.subspace_ws_cluster.restype = ctypes.c_int
    for name, restype in (("subspace_ws_smem_bytes", ctypes.c_int),
                          ("subspace_ws_floats", ctypes.c_longlong),
                          ("subspace_ws_max_clusters", ctypes.c_int)):
        getattr(lib, name).argtypes = [ctypes.c_int] * 3
        getattr(lib, name).restype = restype
    return lib


def _library() -> ctypes.CDLL:
    return bind(build.load("subspace"))


def _ws_library() -> ctypes.CDLL:
    return bind_ws(build.load("subspace_ws"))


def launch(lib: ctypes.CDLL, t: torch.Tensor, r: int, *,
           iters: int) -> torch.Tensor:
    """One launch of `lib`'s kernel (a block plan) on t's device and
    current stream: t [L, rows, cols] float32, contiguous, on a CUDA card
    -> q [L, rows, r]; the caller has checked the shape and clamped r."""
    l, rows, cols = t.shape
    q = torch.empty((l, rows, r), dtype=torch.float32, device=t.device)
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        err = lib.subspace_launch(t.data_ptr(), q.data_ptr(), l, rows, cols,
                                  r, iters, stream)
    if err != 0:
        raise RuntimeError(f"subspace kernel launch failed: CUDA error {err}")
    return q


def launch_ws(lib: ctypes.CDLL, t: torch.Tensor, r: int, *,
              iters: int) -> torch.Tensor:
    """`launch` for the workspace plan of a `subspace_ws` library: one
    thread-block cluster of WS_CLUSTER blocks per layer, the per-layer
    slabs allocated here. A cluster the card cannot schedule makes the
    launch fail, and this raise."""
    l, rows, cols = t.shape
    q = torch.empty((l, rows, r), dtype=torch.float32, device=t.device)
    # the library's own slab size (`ws_plan` mirrors it); torch's
    # allocations are 512-byte aligned, and every slab is a multiple of 4
    # floats
    ws = torch.empty(l * lib.subspace_ws_floats(rows, cols, r),
                     dtype=torch.float32, device=t.device)
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        err = lib.subspace_ws_launch(t.data_ptr(), q.data_ptr(),
                                     ws.data_ptr(), l, rows, cols, r, iters,
                                     stream)
    if err != 0:
        raise RuntimeError("subspace workspace kernel launch failed: "
                           f"CUDA error {err}")
    return q


def dominant_left_subspace_batched(t: torch.Tensor, r: int, *,
                                   iters: int = 8) -> torch.Tensor:
    """Batched top-r left singular subspace: t [L, rows, cols] float32,
    contiguous -> q [L, rows, r] with r clamped to min(rows, cols).

    A full-rank request (r == rows) returns the broadcast identity and
    launches nothing. Otherwise a CUDA tensor goes through the CUDA kernel
    (or raises) and a CPU tensor through the plain version.
    `dominant_left_subspace_batched.launches` counts kernel launches, a
    captured one at each replay (`launches.py`)."""
    if t.dim() != 3:
        raise ValueError(f"expected t [L, rows, cols], got shape {tuple(t.shape)}")
    if t.dtype != torch.float32:
        raise TypeError(f"expected float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError("t must be contiguous")
    l, rows, cols = t.shape
    r = min(r, rows, cols)
    if r < 1:
        raise ValueError(f"rank must be >= 1, got {r}")
    if r == rows or t.device.type == "cpu":
        return dominant_left_subspace_plain(t, r, iters=iters)
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    if not subspace_supported(t.shape, r):
        raise ValueError(f"stack {tuple(t.shape)} at rank {r} exceeds the "
                         "kernel's shared-memory plans")
    if block_plan_fits(rows, cols, r):
        q = launch(_library(), t, r, iters=iters)
    else:
        q = launch_ws(_ws_library(), t, r, iters=iters)
    count_launch(dominant_left_subspace_batched)
    return q


dominant_left_subspace_batched.launches = 0
dominant_left_subspace_batched.captured = 0


@full_f32()
def tt_project_batched(x: torch.Tensor, tt_shapes: Sequence[int],
                       tt_ranks: Sequence[int], *, iters: int = 8
                       ) -> torch.Tensor:
    """Batched TT projection: x [L, numel] -> Z [L, numel].

    The TT-SVD sweep over all layers at once: each step finds every
    layer's dominant left subspace with the kernel and carries the
    residual u^T t on; the residual and the reconstruction are batched
    torch products in full float32."""
    l = x.shape[0]
    shapes = list(tt_shapes)
    ranks = clamp_tt_ranks(shapes, tt_ranks)
    d = len(shapes)
    t = x
    cores = []
    for i in range(d - 1):
        t = t.reshape(l, ranks[i] * shapes[i], -1).contiguous()
        u = dominant_left_subspace_batched(t, ranks[i + 1], iters=iters)
        cores.append(u)                                # [L, r_i n_i, r_{i+1}]
        t = torch.einsum("lrc,lrk->lkc", t, u)         # residual
    cores.append(t)                                    # [L, r_{d-1}, n r_d]
    rec = cores[0]
    for i in range(1, d):
        rec = rec.reshape(l, -1, ranks[i]) @ cores[i].reshape(l, ranks[i], -1)
    return rec.reshape(l, -1)
