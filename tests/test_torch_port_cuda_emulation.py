"""The port's CUDA C++ kernels, compiled for the CPU, against their plain versions.

There is no CUDA compiler or card here, so the kernels' sources are
rewritten for g++ and run under a small emulation of the CUDA subset they
use: a block is 256 host threads, `__syncthreads` a std::barrier, shared
memory a buffer of exactly the kernel's planned size (with a guard band
behind it), a cp.async copy a plain copy made either when it is issued or
as late as the kernel's wait allows. A thread-block cluster of C blocks
runs its C x 256 threads at once, each block with its own buffer and
guard band; the cluster barrier is one std::barrier over all of them and
`cluster_map` points into another block's buffer. That runs each kernel's
own indexing, staging, padding and synchronisation, and catches a
misaligned float4 access, a copy never waited for, or a write past any
block's shared-memory plan. It says nothing about speed or about what
nvcc accepts: `chip_smoke.py` builds and checks the kernels on the card.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from dnn_compression_tensor_admm_tpu_torch.ops.cuda import build
from dnn_compression_tensor_admm_tpu_torch.ops.cuda import subspace_kernel as sk
from dnn_compression_tensor_admm_tpu_torch.ops.cuda import tucker_kernel as tk

SHIM = r"""
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <vector>
#include <thread>
struct Dim { unsigned x; };
struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline thread_local Dim threadIdx, blockIdx;
inline Dim blockDim{256};
inline thread_local std::barrier<>* emu_bar;   // this block's
inline thread_local std::barrier<>* emu_cbar;  // this cluster's
inline thread_local float* emu_smem;           // this block's shared memory
inline thread_local float* const* emu_blocks;  // every block's of the cluster
inline thread_local unsigned emu_rank, emu_csize;
inline std::atomic<int> emu_error{0};  // 1 misaligned float4, 2 copy not waited for
inline void __syncthreads() { emu_bar->arrive_and_wait(); }
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(...)
using std::min;
inline float rsqrtf(float x) { return 1.f / std::sqrt(x); }
inline uintptr_t __cvta_generic_to_shared(const void* p) { return (uintptr_t)p; }
template <class T> inline T* emu_aligned(T* p) {
  if (reinterpret_cast<uintptr_t>(p) & 15) emu_error = 1;
  return p;
}
struct EmuCopy { float* d; const float* s; int n; };
inline thread_local std::vector<std::vector<EmuCopy>> emu_groups;
inline thread_local std::vector<EmuCopy> emu_open;
inline int emu_late = 0;  // 0: a copy lands at issue, 1: at the latest wait
inline void emu_copy(float* d, const float* s, int n) {
  if (emu_late) emu_open.push_back({d, s, n}); else std::memcpy(d, s, 4 * n);
}
inline void emu_commit() { emu_groups.push_back(emu_open); emu_open.clear(); }
inline void emu_wait(int n) {
  while (static_cast<int>(emu_groups.size()) > n) {
    for (auto& c : emu_groups.front()) std::memcpy(c.d, c.s, 4 * c.n);
    emu_groups.erase(emu_groups.begin());
  }
}
constexpr int kGuard = 1024;  // floats behind the plan, filled with a sentinel
// `clusters` clusters of c blocks, one cluster at a time, its c x blockDim
// threads at once; block b of cluster l is blockIdx l * c + b.
template <class Kernel>
int emu_launch_clusters(int clusters, int c, int floats, Kernel kernel) {
  std::vector<std::vector<float>> smem(c, std::vector<float>(floats + kGuard));
  std::vector<float*> bases;
  for (auto& s : smem) bases.push_back(s.data());
  emu_error = 0;
  for (int l = 0; l < clusters; ++l) {
    for (auto& s : smem) {
      std::fill(s.begin(), s.end(), NAN);
      std::fill(s.begin() + floats, s.end(), 12345.f);
    }
    std::barrier<> cbar(c * blockDim.x);
    std::vector<std::unique_ptr<std::barrier<>>> bars;
    for (int b = 0; b < c; ++b) bars.emplace_back(new std::barrier<>(blockDim.x));
    std::vector<std::thread> threads;
    for (int b = 0; b < c; ++b)
      for (unsigned i = 0; i < blockDim.x; ++i)
        threads.emplace_back([&, i, b] {
          threadIdx.x = i;
          blockIdx.x = l * c + b;
          emu_rank = b;
          emu_csize = c;
          emu_bar = bars[b].get();
          emu_cbar = &cbar;
          emu_smem = bases[b];
          emu_blocks = bases.data();
          kernel();
          if (!emu_groups.empty() || !emu_open.empty()) emu_error = 2;
        });
    for (auto& t : threads) t.join();
    for (auto& s : smem)
      for (int i = floats; i < floats + kGuard; ++i)
        if (s[i] != 12345.f) return 3;  // written past the plan
  }
  return emu_error;
}
template <class Kernel>
int emu_launch(int blocks, int floats, Kernel kernel) {
  return emu_launch_clusters(blocks, 1, floats, kernel);
}
"""

RUNNERS = {
    "subspace": r"""
extern "C" int emu_run(const float* t, float* q, int l, int rows, int cols,
                       int r, int iters, int late) {
  emu_late = late;
  blockDim.x = kThreads;
  return emu_launch(l, make_plan(rows, cols, r).total, [&] {
    subspace_kernel(t, q, rows, cols, r, iters);
  });
}
""",
    "subspace_ws": r"""
extern "C" int emu_run_ws(const float* t, float* q, float* ws, int l,
                          int rows, int cols, int r, int iters, int late,
                          int c) {
  emu_late = late;
  blockDim.x = kThreads;
  return emu_launch_clusters(l, c, make_ws_plan(rows, cols, r, c).total, [&] {
    subspace_ws_kernel(t, q, ws, rows, cols, r, iters);
  });
}
extern "C" int emu_ws_plan(int rows, int cols, int r, int c, long long* out) {
  const WsPlan p = make_ws_plan(rows, cols, r, c);
  out[0] = p.total;
  out[1] = p.ws;
  out[2] = p.in_ws;
  out[3] = p.stage;
  out[4] = kCluster;  // the library's cluster size, whatever c
  return 0;
}
""",
    "tucker2_factors": r"""
extern "C" int emu_run(const float* x, float* u0, float* u1, int l, int k,
                       int o, int i, int r0, int r1, int sweeps, int late) {
  emu_late = late;
  blockDim.x = kThreads;
  return emu_launch(l, make_plan(k, o, i, r0, r1).total, [&] {
    tucker2_factors_kernel(x, u0, u1, k, o, i, r0, r1, sweeps);
  });
}
""",
    "tucker2_factors_ws": r"""
extern "C" int emu_run_ws(const float* x, float* u0, float* u1, float* ws,
                          int l, int k, int o, int i, int r0, int r1,
                          int sweeps, int late, int c) {
  emu_late = late;
  blockDim.x = kThreads;
  return emu_launch_clusters(l, c, make_ws_plan(k, o, i, r0, r1, c).total, [&] {
    tucker2_factors_ws_kernel(x, u0, u1, ws, k, o, i, r0, r1, sweeps);
  });
}
extern "C" int emu_ws_plan(int k, int o, int i, int r0, int r1, int c,
                           long long* out) {
  const WsPlan p = make_ws_plan(k, o, i, r0, r1, c);
  out[0] = p.total;
  out[1] = p.ws;
  out[2] = p.in_ws;
  out[3] = p.stage;
  out[4] = p.kg;
  out[5] = ws_cluster(o, i);
  return 0;
}
""",
}


def _for_the_cpu(name: str) -> str:
    """The kernel's source, its headers inlined, rewritten for g++."""
    def read(path):
        return path.read_text().replace("#include <cuda_runtime.h>", "")
    src = read(build.SRC_DIR / f"{name}.cu")
    for header in build.SRC_DIR.glob("*.cuh"):
        src = src.replace(f'#include "{header.name}"', read(header))
    src = src.replace("extern __shared__ float smem[];",
                      "float* smem = emu_smem;")
    src = src.replace("#pragma once", "")
    bodies = {"cp_async4": "emu_copy(dst, src, 1);",
              "cp_async16": "emu_copy(dst, src, 4);",
              "cp_async_commit": "emu_commit();",
              "cp_async_wait": "emu_wait(N);",
              # cluster.cuh: the cluster barrier, pointers into and
              # stores to the other blocks' buffers
              "cluster_rank": "return emu_rank;",
              "cluster_size": "return emu_csize;",
              "cluster_sync": "emu_cbar->arrive_and_wait();",
              "cluster_map": "return emu_blocks[rank] + (p - emu_smem);",
              "st4_remote": "*emu_aligned(reinterpret_cast<float4*>("
                            "emu_blocks[rank] + (p - emu_smem))) = v;",
              "ld4_cg": "return *reinterpret_cast<const float4*>(p);",
              "ld_cg": "return *p;"}
    for fn, body in bodies.items():
        src = re.sub(rf"((?:void|unsigned|float\*|float4|float) {fn}"
                     rf"\([^)]*\) \{{).*?\n\}}", rf"\1 {body} }}", src,
                     flags=re.S)
    src = re.sub(r"\*reinterpret_cast<(const )?float4\*>\(([^;=]*?)\)( =|;)",
                 r"*emu_aligned(reinterpret_cast<\1float4*>(\2))\3", src)
    # the C interface launches on a stream; the emulation has its own runner
    src = src[:src.rindex('extern "C" {')]
    return SHIM + src + RUNNERS[name]


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the CPU emulation of the CUDA sources")
    out = {}
    for name in RUNNERS:
        cpp = tmp_path_factory.mktemp("emu") / f"{name}.cpp"
        cpp.write_text(_for_the_cpu(name))
        so = cpp.with_suffix(".so")
        subprocess.run([gxx, "-std=c++20", "-O1", "-fno-strict-aliasing",
                        "-fPIC", "-shared", "-Wno-unknown-pragmas", "-o",
                        str(so), str(cpp), "-pthread"], check=True,
                       capture_output=True, stdin=subprocess.DEVNULL)
        out[name] = ctypes.CDLL(str(so))
    out["subspace"].emu_run.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
    out["subspace_ws"].emu_run_ws.argtypes = ([ctypes.c_void_p] * 3
                                              + [ctypes.c_int] * 7)
    out["subspace_ws"].emu_ws_plan.argtypes = ([ctypes.c_int] * 4
                                               + [ctypes.c_void_p])
    out["tucker2_factors"].emu_run.argtypes = ([ctypes.c_void_p] * 3
                                               + [ctypes.c_int] * 8)
    out["tucker2_factors_ws"].emu_run_ws.argtypes = ([ctypes.c_void_p] * 4
                                                     + [ctypes.c_int] * 9)
    out["tucker2_factors_ws"].emu_ws_plan.argtypes = ([ctypes.c_int] * 6
                                                      + [ctypes.c_void_p])
    return out


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The emulation runs 256 threads; keep torch's pool out of their way."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("late", [0, 1])
@pytest.mark.parametrize("L,rows,cols,r", [
    (2, 32, 72, 8),     # wide, scalar 2x2 Gram, scalar products (rp < 12)
    (1, 40, 150, 13),   # wide, padded: transposed chunks, float4 Gram and products
    (1, 100, 36, 10),   # tall, 36 columns: lift from L2
    (1, 90, 33, 12),    # tall, 33 columns padded to 36: lift from L2
    (1, 100, 64, 10),   # tall: lift staged in row chunks
    (1, 150, 66, 12),   # tall: lift chunks with zero pads (66 -> 68)
    (2, 120, 8, 8),     # tall, full rank in the columns: lift from L2
    (1, 70, 130, 20),   # wide, Gram of 70 rows in two 64 x 64 blocks
    (1, 193, 197, 33),  # near a block's limit: the unpadded plan
    (1, 197, 193, 33),  # the same, tall: scalar products, lift from L2
    # ResNet-50 TT@3x's longest rows: [32, 73728] at r = 30 streams its
    # Gram through 1,152 stages of 64 columns
    (1, 32, 73728, 30),
])
def test_subspace_source_matches_plain(libs, L, rows, cols, r, late):
    t = (np.random.RandomState(rows + cols).standard_normal((L, rows, cols))
         / np.sqrt(cols)).astype(np.float32)
    assert sk.subspace_supported(t.shape, r)
    for iters in (8, 0):
        q = np.full((L, rows, r), np.nan, np.float32)
        err = libs["subspace"].emu_run(t.ctypes.data, q.ctypes.data, L, rows,
                                       cols, r, iters, late)
        assert err == 0, f"emulation fault {err}"
        p = sk.dominant_left_subspace_plain(torch.from_numpy(t), r,
                                            iters=iters).numpy()
        # the same float32 iteration, summed in the same order; only
        # rsqrtf differs (exact here, approximate on the card)
        assert np.abs(q - p).max() < 1e-5
        zq = q @ (q.transpose(0, 2, 1) @ t)
        zp = p @ (p.transpose(0, 2, 1) @ t)
        assert np.linalg.norm(zq - zp) / np.linalg.norm(zp) < 1e-5


GUARD = 1024  # floats behind the workspace, filled with a sentinel


@pytest.mark.parametrize("late", [0, 1])
@pytest.mark.parametrize("L,rows,cols,r,cluster,in_ws", [
    (1, 144, 192, 96, 8, ""),        # DeiT wide r = 96: all in shared memory
    (1, 720, 192, 96, 8, ""),        # DeiT tall r = 96: the lift over 8 blocks
    (2, 2304, 32, 30, 4, ""),        # DeiT 2304 x 32 at C = 4, two layers
    (1, 3600, 64, 16, 8, ""),        # rp = 16: 4 of 8 blocks own no NS rows
    (1, 300, 320, 106, 4, "g"),      # the Gram in the slab, its Y = G Q chunks
                                     # by cp.async
    # DeiT wide at C = 2: Y and the iterate in the slab
    (1, 144, 192, 96, 2, "y q"),
    # DeiT tall at C = 2: the Gram and Y (the lift's too) in the slab
    (1, 720, 192, 96, 2, "g y"),
    # DeiT 2304 x 32 at its C = 8: 288 rows of Y a block, 4 of the Gram
    (1, 2304, 32, 28, 8, ""),
    # rp = 176 (r = 174, not a multiple of 4): no room for all of Y and Z,
    # so Newton-Schulz stages them from their owners and q = Y Z goes
    # through the Gram's rows in pieces; Y and the iterate in the slab
    (1, 260, 176, 174, 8, "y q"),
    # the same at C = 4: the partial S in the slab
    (1, 260, 176, 174, 4, "sp y"),
    # ResNet-50 TT@3x's [2048, 512] at r = 130 (padded to 132) cut to
    # 612 x 284: the same C = 8 with the Gram and Y in the slab
    (1, 612, 284, 130, 8, "g y"),
])
def test_subspace_workspace_plan_matches_plain(libs, L, rows, cols, r,
                                               cluster, in_ws, late):
    assert not sk.block_plan_fits(rows, cols, r)
    assert sk.subspace_supported((L, rows, cols), r)
    assert sk.plan_name(rows, cols, r) == "workspace"
    plan = sk.ws_plan(rows, cols, r, cluster)
    assert plan.in_ws == tuple(in_ws.split())
    got = np.zeros(5, np.int64)
    libs["subspace_ws"].emu_ws_plan(rows, cols, r, cluster, got.ctypes.data)
    bits = {"ns": 1, "g": 2, "q": 4, "y": 8, "sp": 16}
    assert list(got) == [plan.smem_floats, plan.ws_floats,
                         sum(bits[n] for n in plan.in_ws), plan.stage,
                         sk.WS_CLUSTER]
    t = (np.random.RandomState(rows + cols).standard_normal((L, rows, cols))
         / np.sqrt(cols)).astype(np.float32)
    ws = np.full(L * plan.ws_floats + GUARD, np.nan, np.float32)
    ws[-GUARD:] = 12345.0
    assert ws.ctypes.data % 16 == 0
    for iters in (8, 0):
        q = np.full((L, rows, r), np.nan, np.float32)
        err = libs["subspace_ws"].emu_run_ws(t.ctypes.data, q.ctypes.data,
                                             ws.ctypes.data, L, rows, cols,
                                             r, iters, late, cluster)
        assert err == 0, f"emulation fault {err}"
        assert (ws[-GUARD:] == 12345.0).all(), "written past the workspace"
        p = sk.dominant_left_subspace_plain(torch.from_numpy(t), r,
                                            iters=iters).numpy()
        # the same float32 iteration in another summation order (Y^T Y
        # summed over the cluster's blocks, Newton-Schulz's Y W as W Y):
        # at most 6.7e-6 apart here
        assert np.abs(q - p).max() < 1e-5
        zq = q @ (q.transpose(0, 2, 1) @ t)
        zp = p @ (p.transpose(0, 2, 1) @ t)
        assert np.linalg.norm(zq - zp) / np.linalg.norm(zp) < 1e-5


@pytest.mark.parametrize("L,rows,cols,r,in_ws,late", [
    # DeiT-small TT@2x's blocks.0.attn.proj step at r = 320: the five
    # Newton-Schulz matrices and the partial S in the slab
    (1, 352, 384, 320, "ns sp", 0),
    # its fc1 step at r = 256: the partial S, the Gram and Y in the slab
    (1, 800, 384, 256, "sp g y", 1),
    # its fc2 tall step: 10,240 rows at r = 42, Y in the slab
    (1, 10240, 48, 42, "y", 0),
])
def test_subspace_workspace_plan_at_deit_small_shapes(libs, L, rows, cols, r,
                                                      in_ws, late):
    """The workspace plan at DeiT-small's real sizes and the library's
    cluster of 8, over one iteration step (each runs the same code as the
    Z-step's 8: the Gram, Y = G Q, 12 Newton-Schulz steps, the lift; the
    real sizes cost 2 to 4 s a step here)."""
    plan = sk.ws_plan(rows, cols, r)
    assert plan.in_ws == tuple(in_ws.split())
    t = (np.random.RandomState(rows + cols).standard_normal((L, rows, cols))
         / np.sqrt(cols)).astype(np.float32)
    ws = np.full(L * plan.ws_floats + GUARD, np.nan, np.float32)
    ws[-GUARD:] = 12345.0
    q = np.full((L, rows, r), np.nan, np.float32)
    err = libs["subspace_ws"].emu_run_ws(t.ctypes.data, q.ctypes.data,
                                         ws.ctypes.data, L, rows, cols, r, 1,
                                         late, sk.WS_CLUSTER)
    assert err == 0, f"emulation fault {err}"
    assert (ws[-GUARD:] == 12345.0).all(), "written past the workspace"
    p = sk.dominant_left_subspace_plain(torch.from_numpy(t), r,
                                        iters=1).numpy()
    # summation order only (6.4e-6 seen at r = 320)
    assert np.abs(q - p).max() < 1e-5
    zq = q @ (q.transpose(0, 2, 1) @ t)
    zp = p @ (p.transpose(0, 2, 1) @ t)
    assert np.linalg.norm(zq - zp) / np.linalg.norm(zp) < 1e-5


def _tucker2_against_plain(libs, shape, r0, r1, sweeps, late):
    l, k, o, i = shape
    x = (np.random.RandomState(o * i).standard_normal(shape)
         / np.sqrt(k * i)).astype(np.float32)
    u0 = np.full((l, o, r0), np.nan, np.float32)
    u1 = np.full((l, i, r1), np.nan, np.float32)
    err = libs["tucker2_factors"].emu_run(x.ctypes.data, u0.ctypes.data,
                                          u1.ctypes.data, l, k, o, i, r0, r1,
                                          sweeps, late)
    assert err == 0, f"emulation fault {err}"
    xt = torch.from_numpy(x)
    p0, p1 = tk.tucker2_factors_plain(xt, r0, r1, sweeps=sweeps)
    z = tk.tucker2_reconstruct(xt, torch.from_numpy(u0), torch.from_numpy(u1))
    zp = tk.tucker2_reconstruct(xt, p0, p1)
    assert (torch.linalg.vector_norm(z - zp)
            / torch.linalg.vector_norm(zp)).item() < 1e-5


@pytest.mark.parametrize("shape,r0,r1", [
    ((2, 9, 16, 16), 16, 16),   # full rank: the identity
    ((1, 9, 32, 16), 12, 8),
    ((1, 3, 40, 20), 9, 5),
])
def test_tucker2_source_matches_plain(libs, shape, r0, r1):
    _tucker2_against_plain(libs, shape, r0, r1, 2, 0)


@pytest.mark.parametrize("late", [0, 1])
@pytest.mark.parametrize("shape,r0,r1,sweeps,resident", [
    ((1, 9, 32, 32), 20, 20, 2, True),    # resident X, padded iteration
    ((1, 9, 64, 64), 25, 23, 2, True),    # HOOI products in two groups (5 + 4)
    ((1, 9, 64, 64), 25, 23, 0, True),    # sweeps=0: the Grams and HOSVD init
    ((1, 9, 32, 16), 24, 16, 2, True),    # even ranks, mode 1 full rank
    ((1, 9, 30, 18), 7, 5, 2, True),      # odd sizes and ranks: zero pads, scalar
    ((2, 1, 36, 20), 12, 8, 2, True),     # K = 1: padded mode 0, scalar mode 1
    ((1, 4, 8, 24), 8, 5, 2, True),       # mode 0 full rank (identity)
    ((1, 9, 144, 144), 40, 40, 2, False), # X streamed: 64 x 64 Gram blocks
    ((1, 9, 160, 96), 40, 30, 2, False),  # X streamed, O != I
])
def test_tucker2_plans_match_plain(libs, shape, r0, r1, sweeps, resident, late):
    _, k, o, i = shape
    assert tk.kernel_supported(shape, r0, r1)
    assert tk.resident_plan(k, o, i, r0, r1) == resident
    _tucker2_against_plain(libs, shape, r0, r1, sweeps, late)


@pytest.mark.parametrize("shape,r0,r1,cluster,in_ws,sweeps,late", [
    # DeiT fc1, fc2 and qkv at C = 2: the Gram (its chunks of A staged by
    # cp.async), Y, the factors and (fc1, fc2) the Newton-Schulz matrices and
    # the HOOI product in the slab; one copy of Newton-Schulz's Y and Z
    ((1, 1, 768, 192), 128, 72, 2, "ns g y u m", 2, 1),
    ((1, 1, 192, 768), 72, 128, 2, "ns g y u m", 2, 0),
    ((1, 1, 576, 192), 128, 72, 2, "ns g y u", 2, 0),
    # DeiT proj, two layers: two clusters, the factors in the slab
    ((2, 1, 192, 192), 72, 72, 2, "u", 2, 1),
    # C = 4, all in shared memory: two copies of Y and Z
    ((1, 9, 128, 128), 64, 64, 4, "", 2, 1),
    # C = 2, then C = 8, where 3 blocks own no Newton-Schulz rows (rp = 20)
    ((1, 9, 208, 208), 20, 20, 2, "", 2, 0),
    ((1, 9, 208, 208), 20, 20, 8, "", 2, 1),
    # O and I not multiples of 4: scalar HOOI products, zero pads; the 9
    # HOOI products in 5 groups of 2
    ((1, 9, 150, 90), 70, 45, 2, "", 2, 1),
    # mode 0 full rank (the identity); the Gram in the slab; two layers
    ((2, 9, 12, 400), 12, 8, 2, "g", 2, 0),
    # r = 244: the Newton-Schulz matrices and the partial S in the slab,
    # their products staged from the slab (no room for all of Y and Z)
    ((1, 1, 248, 8), 244, 8, 2, "ns sp y u", 0, 1),
    # MobileNetV2-CIFAR SVD's head (1280 x 320 at r = 160, as K = 1 with
    # r0 = r1) cut to 328 x 168: rp = 160 at C = 8 with the same regions in
    # the slab, the Newton-Schulz matrices among them
    ((1, 1, 328, 168), 160, 160, 8, "ns g y u m", 2, 1),
    # its tall 384 x 64 buckets at r = 36, two layers at C = 8: chunk rows
    # of 388 floats (O + 4), 8 rows of U1 a block
    ((2, 1, 384, 64), 36, 36, 8, "", 2, 0),
    # ResNet-50 TK@3x's [3, 9, 512, 512] at 64/96 cut to 476 x 128: K = 9
    # at C = 8 with Y, the factors and the HOOI products in the slab
    ((1, 9, 476, 128), 64, 96, 8, "y u m", 2, 1),
])
def test_tucker2_workspace_plan_matches_plain(libs, shape, r0, r1, cluster,
                                              in_ws, sweeps, late):
    l, k, o, i = shape
    assert not tk.block_plan_fits(k, o, i, r0, r1)
    assert tk.kernel_supported(shape, r0, r1)
    assert tk.plan_name(k, o, i, r0, r1) == "workspace"
    plan = tk.ws_plan(k, o, i, r0, r1, cluster)
    assert plan.in_ws == tuple(in_ws.split())
    got = np.zeros(6, np.int64)
    libs["tucker2_factors_ws"].emu_ws_plan(k, o, i, r0, r1, cluster,
                                           got.ctypes.data)
    bits = {"ns": 1, "g": 2, "u": 4, "y": 8, "m": 16, "sp": 32}
    assert list(got) == [plan.smem_floats, plan.ws_floats,
                         sum(bits[n] for n in plan.in_ws), plan.stage,
                         plan.kg, tk.ws_cluster(o, i)]
    x = (np.random.RandomState(o * i).standard_normal(shape)
         / np.sqrt(k * i)).astype(np.float32)
    ws = np.full(l * plan.ws_floats + GUARD, np.nan, np.float32)
    ws[-GUARD:] = 12345.0
    assert ws.ctypes.data % 16 == 0
    u0 = np.full((l, o, r0), np.nan, np.float32)
    u1 = np.full((l, i, r1), np.nan, np.float32)
    err = libs["tucker2_factors_ws"].emu_run_ws(
        x.ctypes.data, u0.ctypes.data, u1.ctypes.data, ws.ctypes.data, l, k,
        o, i, r0, r1, sweeps, late, cluster)
    assert err == 0, f"emulation fault {err}"
    assert (ws[-GUARD:] == 12345.0).all(), "written past the workspace"
    xt = torch.from_numpy(x)
    p0, p1 = tk.tucker2_factors_plain(xt, r0, r1, sweeps=sweeps)
    # the same float32 iteration in another summation order: Y^T Y summed
    # over the cluster's blocks, Newton-Schulz's Y W as W Y
    z = tk.tucker2_reconstruct(xt, torch.from_numpy(u0), torch.from_numpy(u1))
    zp = tk.tucker2_reconstruct(xt, p0, p1)
    assert (torch.linalg.vector_norm(z - zp)
            / torch.linalg.vector_norm(zp)).item() < 1e-5
