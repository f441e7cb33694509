"""The CPU emulation of the port's CUDA C++ kernels, shared by the
`test_torch_port_cuda_emulation_*.py` files (one file per kernel family,
each building only its own library).

There is no CUDA compiler or card here, so the kernels' sources are
rewritten for g++ and run under a small emulation of the CUDA subset they
use. Each emulated thread is a coroutine (`ucontext`) with its own stack,
and one OS thread runs a whole block, or a whole thread-block cluster of
C blocks, round-robin: each thread runs up to its next `__syncthreads`,
cluster barrier or (late copies) cp.async wait, in ascending order of
thread (descending with late copies), and a barrier is released once
every thread it waits for stands at it, at the same source line.
Shared memory is a buffer of exactly the kernel's planned size (with a
guard band behind it) for each block; `cluster_map` points into another
block's buffer. A cp.async copy is a plain copy made either when it is
issued or as late as the kernel's wait allows, after the other threads
have run on to their own next wait or barrier. That runs each kernel's
own indexing, staging, padding and synchronisation, and catches a
misaligned float4 access, a copy never waited for, a write past any
block's shared-memory plan, and a barrier that not every thread reaches
(the launch returns 1 to 4, `emu_error`). A kernel that spins on a flag
would never yield: its wait must call `emu_yield(0, 0)`. The emulation
says nothing about speed or about what nvcc accepts: `chip_smoke.py`
builds and checks the kernels on the card.

`for_the_cpu(name)` gives the rewritten source of `csrc/<name>.cu` (its
headers inlined, its emulation runner appended); `build_library(name,
directory)` compiles it with g++ and loads it with its runner's argument
types. `rewrite(src)` and `compile_source` do the same for any source.
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
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <vector>
#include <sys/mman.h>
#include <ucontext.h>
struct Dim { unsigned x; };
struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct EmuCopy { float* d; const float* s; int n; };
// One emulated CUDA thread: a coroutine with its own stack, its indices
// and its cp.async groups. `wait` says where it stopped: 0 runnable, 1 at
// the block barrier, 2 at the cluster barrier, 3 returned.
struct EmuThread {
  ucontext_t ctx;
  Dim tid, bid;
  unsigned rank;
  int wait, site;
  std::vector<std::vector<EmuCopy>> groups;
  std::vector<EmuCopy> open;
};
// One launch at a time: the thread running now and its cluster's buffers.
inline EmuThread* emu_cur;
inline ucontext_t emu_sched;
inline float* const* emu_blocks;
inline unsigned emu_csize;
inline Dim blockDim{256};
#define threadIdx (emu_cur->tid)
#define blockIdx (emu_cur->bid)
#define emu_rank (emu_cur->rank)
#define emu_smem (emu_blocks[emu_cur->rank])
// 1 misaligned float4, 2 copy not waited for, 3 written past the plan,
// 4 a barrier that not every thread reached (or reached at another line)
inline std::atomic<int> emu_error{0};
// Back to the scheduler, which resumes this thread once `kind`'s barrier
// has been reached by all its threads (kind 0: at once, after the others).
inline void emu_yield(int kind, int site) {
  emu_cur->wait = kind;
  emu_cur->site = site;
  swapcontext(&emu_cur->ctx, &emu_sched);
}
#define __syncthreads() emu_yield(1, __LINE__)
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(...)
using std::min;
inline float rsqrtf(float x) { return 1.f / std::sqrt(x); }
inline uintptr_t __cvta_generic_to_shared(const void* p) { return (uintptr_t)p; }
// A misaligned float4 access is reported and goes to a scratch float4
// (as it is, the aligned vector load or store g++ emits for it would fault).
inline float4 emu_scratch4;
template <class T> inline T* emu_aligned(T* p) {
  if (!(reinterpret_cast<uintptr_t>(p) & 15)) return p;
  emu_error = 1;
  return reinterpret_cast<T*>(&emu_scratch4);
}
inline int emu_late = 0;  // 0: a copy lands at issue, 1: at the latest wait
inline void emu_copy(float* d, const float* s, int n) {
  if (emu_late) emu_cur->open.push_back({d, s, n}); else std::memcpy(d, s, 4 * n);
}
inline void emu_commit() {
  emu_cur->groups.push_back(emu_cur->open);
  emu_cur->open.clear();
}
// A late copy lands only after the other threads have run up to their
// own next wait or barrier, so that one that reads it early sees NaN.
inline void emu_wait(int n) {
  auto& g = emu_cur->groups;
  if (static_cast<int>(g.size()) <= n) return;
  if (emu_late) emu_yield(0, 0);
  while (static_cast<int>(g.size()) > n) {
    for (auto& c : g.front()) std::memcpy(c.d, c.s, 4 * c.n);
    g.erase(g.begin());
  }
}
inline void* emu_kernel;
inline void (*emu_call)(void*);
inline void emu_entry() {
  emu_call(emu_kernel);
  if (!emu_cur->groups.empty() || !emu_cur->open.empty()) emu_error = 2;
  emu_cur->wait = 3;
}  // returns to emu_sched through uc_link
constexpr int kGuard = 1024;  // floats behind the plan, filled with a sentinel
constexpr size_t kStack = 256 << 10;  // bytes of stack an emulated thread
constexpr size_t kPage = 4096;        // below each stack, no access
// Runs one cluster's threads on this OS thread, each up to its next
// barrier (or wait) in turn, in ascending order (descending with late
// copies, so that a read of another thread's write before the barrier
// shows in one of a case's two runs), and releases a barrier once every
// thread it waits for stands at it, at the same line. 0, or 4 if a
// barrier can never be released.
inline int emu_schedule(std::vector<EmuThread>& ts, int c) {
  const int n = static_cast<int>(ts.size()), per = n / c;
  for (;;) {
    for (bool ran = true; ran;) {
      ran = false;
      for (int k = 0; k < n; ++k) {
        EmuThread& t = ts[emu_late ? n - 1 - k : k];
        if (t.wait == 0) {
          emu_cur = &t;
          swapcontext(&emu_sched, &t.ctx);
          ran = true;
        }
      }
    }
    int done = 0, at_cluster = 0;
    bool released = false;
    for (auto& t : ts) done += t.wait == 3, at_cluster += t.wait == 2;
    if (done == n) return 0;
    if (at_cluster == n) {
      for (auto& t : ts)
        if (t.site != ts[0].site) return 4;
      for (auto& t : ts) t.wait = 0;
      continue;
    }
    for (int b = 0; b < c; ++b) {
      EmuThread* bt = ts.data() + b * per;
      int at_block = 0;
      for (int i = 0; i < per; ++i) at_block += bt[i].wait == 1;
      if (at_block == 0) continue;
      if (at_block < per) return 4;
      for (int i = 0; i < per; ++i)
        if (bt[i].site != bt[0].site) return 4;
      for (int i = 0; i < per; ++i) bt[i].wait = 0;
      released = true;
    }
    if (!released) return 4;
  }
}
// `clusters` clusters of c blocks, one cluster at a time on this OS
// thread; block b of cluster l is blockIdx l * c + b.
template <class Kernel>
int emu_launch_clusters(int clusters, int c, int floats, Kernel kernel) {
  std::vector<std::vector<float>> smem(c, std::vector<float>(floats + kGuard));
  std::vector<float*> bases;
  for (auto& s : smem) bases.push_back(s.data());
  const int n = c * static_cast<int>(blockDim.x);
  const size_t each = kStack + kPage;
  char* stacks = static_cast<char*>(mmap(nullptr, n * each,
      PROT_READ | PROT_WRITE, MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE,
      -1, 0));
  if (stacks == MAP_FAILED) return 5;
  for (int i = 0; i < n; ++i) mprotect(stacks + i * each, kPage, PROT_NONE);
  emu_error = 0;
  emu_kernel = &kernel;
  emu_call = [](void* k) { (*static_cast<Kernel*>(k))(); };
  emu_blocks = bases.data();
  emu_csize = c;
  int fault = 0;
  for (int l = 0; l < clusters && !fault; ++l) {
    for (auto& s : smem) {
      std::fill(s.begin(), s.end(), NAN);
      std::fill(s.begin() + floats, s.end(), 12345.f);
    }
    std::vector<EmuThread> ts(n);
    for (int i = 0; i < n; ++i) {
      EmuThread& t = ts[i];
      t.tid.x = i % blockDim.x;
      t.bid.x = l * c + i / blockDim.x;
      t.rank = i / blockDim.x;
      t.wait = 0;
      getcontext(&t.ctx);
      t.ctx.uc_stack.ss_sp = stacks + i * each + kPage;
      t.ctx.uc_stack.ss_size = kStack;
      t.ctx.uc_link = &emu_sched;
      makecontext(&t.ctx, emu_entry, 0);
    }
    fault = emu_schedule(ts, c);
    for (auto& s : smem)
      for (int i = floats; i < floats + kGuard; ++i)
        if (s[i] != 12345.f) fault = fault ? fault : 3;  // past the plan
  }
  munmap(stacks, n * each);
  return fault ? fault : static_cast<int>(emu_error);
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


def rewrite(src: str) -> str:
    """A CUDA source, its `csrc` headers inlined, rewritten for g++ under
    the emulation (its C interface, which launches on a stream, cut)."""
    def read(text):
        return text.replace("#include <cuda_runtime.h>", "")
    src = read(src)
    for header in build.SRC_DIR.glob("*.cuh"):
        src = src.replace(f'#include "{header.name}"', read(header.read_text()))
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
              "cluster_sync": "emu_yield(2, 0);",
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
    if 'extern "C" {' in src:
        src = src[:src.rindex('extern "C" {')]
    return SHIM + src


def for_the_cpu(name: str) -> str:
    """`csrc/<name>.cu` rewritten for g++, its emulation runner appended."""
    return rewrite((build.SRC_DIR / f"{name}.cu").read_text()) + RUNNERS[name]


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


def compile_source(cpp: str, stem: str, directory,
                   argtypes: dict) -> ctypes.CDLL:
    """Rewritten source `cpp` compiled with g++ as `directory/stem.so` and
    loaded, each function of `argtypes` given its argument types; skips
    the test without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the CPU emulation of the CUDA sources")
    path = directory / f"{stem}.cpp"
    path.write_text(cpp)
    so = path.with_suffix(".so")
    # -O3 sums in source order all the same: no -ffast-math, and
    # -ffp-contract=off keeps g++ from fusing a * b + c into an FMA (C++
    # contracts by default, and -march=native may offer FMA)
    subprocess.run([gxx, "-std=c++20", "-O3", "-march=native",
                    "-ffp-contract=off", "-fno-strict-aliasing", "-fPIC",
                    "-shared", "-Wno-unknown-pragmas", "-o", str(so),
                    str(path), "-pthread"], check=True, capture_output=True,
                   stdin=subprocess.DEVNULL)
    lib = ctypes.CDLL(str(so))
    for fn, types in argtypes.items():
        getattr(lib, fn).argtypes = types
    return lib


def build_library(name: str, directory) -> ctypes.CDLL:
    """`csrc/<name>.cu` rewritten for the CPU, compiled with g++ in
    `directory` and loaded with its runner's argument types."""
    return compile_source(for_the_cpu(name), name, directory, ARGTYPES[name])


def one_torch_thread():
    """The emulation takes one core; keep torch's pool to one as well,
    beside the other test workers (a module fixture's body: `yield from
    one_torch_thread()`)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
