"""The CPU emulation of the port's CUDA C++ kernels, shared by the
`test_torch_port_cuda_emulation_*.py` files (one file per kernel family,
each building only its own library).

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

`for_the_cpu(name)` gives the rewritten source of `csrc/<name>.cu` (its
headers inlined, its emulation runner appended); `build_library(name,
directory)` compiles it with g++ and loads it with its runner's argument
types.
"""

import ctypes
import re
import shutil
import subprocess

import pytest
import torch

from dnn_compression_tensor_admm_tpu_torch.ops.cuda import build

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


def for_the_cpu(name: str) -> str:
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


GUARD = 1024  # floats behind the workspace, filled with a sentinel

ARGTYPES = {
    "subspace": {"emu_run": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6},
    "subspace_ws": {"emu_run_ws": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7,
                    "emu_ws_plan": [ctypes.c_int] * 4 + [ctypes.c_void_p]},
    "tucker2_factors": {"emu_run": [ctypes.c_void_p] * 3
                                   + [ctypes.c_int] * 8},
    "tucker2_factors_ws": {"emu_run_ws": [ctypes.c_void_p] * 4
                                         + [ctypes.c_int] * 9,
                           "emu_ws_plan": [ctypes.c_int] * 6
                                          + [ctypes.c_void_p]},
}


def build_library(name: str, directory) -> ctypes.CDLL:
    """`csrc/<name>.cu` rewritten for the CPU, compiled with g++ in
    `directory` and loaded; skips the test without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the CPU emulation of the CUDA sources")
    cpp = directory / f"{name}.cpp"
    cpp.write_text(for_the_cpu(name))
    so = cpp.with_suffix(".so")
    subprocess.run([gxx, "-std=c++20", "-O1", "-fno-strict-aliasing",
                    "-fPIC", "-shared", "-Wno-unknown-pragmas", "-o",
                    str(so), str(cpp), "-pthread"], check=True,
                   capture_output=True, stdin=subprocess.DEVNULL)
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in ARGTYPES[name].items():
        getattr(lib, fn).argtypes = argtypes
    return lib


def one_torch_thread():
    """The emulation runs 256 threads; keep torch's pool out of their way
    (a module fixture's body: `yield from one_torch_thread()`)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
