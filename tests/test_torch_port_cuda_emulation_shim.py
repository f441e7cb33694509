"""The CUDA emulation of `tests/torch_cuda_emulation.py` itself: a tiny
kernel, rewritten and built as the port's kernels are, once clean and once
with each fault the emulation exists to catch seeded into it. Each launch
runs two clusters of two 64-thread blocks; each block copies its 256
floats of x into shared memory by cp.async, and after the cluster barrier
adds its neighbour block's copy into y."""

import ctypes

import numpy as np
import pytest

from tests.torch_cuda_emulation import compile_source, rewrite

SOURCE = r"""
#include "orth_iter.cuh"
#include "stage.cuh"
#include "cluster.cuh"
namespace {
constexpr int kPlan = 256;  // floats of shared memory a block
__global__ void tiny_kernel(const float* x, float* y) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, t = threadIdx.x;
  copy_contiguous(smem, x + b * kPlan, kPlan);
  cp_async_commit();
  WAIT
  __syncthreads();
  FAULT
  cluster_sync();
  const float* other = cluster_map(smem, (cluster_rank() + 1) % cluster_size());
  for (int i = t; i < kPlan; i += blockDim.x) y[b * kPlan + i] = smem[i] + other[i];
  cluster_sync();
}
}  // namespace
extern "C" int emu_tiny(const float* x, float* y, int late) {
  emu_late = late;
  blockDim.x = 64;
  return emu_launch_clusters(2, 2, kPlan, [&] { tiny_kernel(x, y); });
}
"""

WAIT = "cp_async_wait<0>();"
CASES = {  # name: (the wait, the fault, the launch's return code)
    "clean": (WAIT, "", 0),
    "misaligned float4": (WAIT, "if (t == 0) *reinterpret_cast<float4*>"
                                "(smem + 1) = make_float4(0.f, 0.f, 0.f, 0.f);"
                                " __syncthreads();", 1),
    "copy not waited for": ("", "", 2),
    "write past the plan": (WAIT, "if (t == 3) smem[kPlan + 5] = 0.f;", 3),
    "skipped barrier": (WAIT, "if (t != 5) __syncthreads();", 4),
    "barrier at another line": (WAIT, "if (t == 5) { __syncthreads(); }\n"
                                      "  else { __syncthreads(); }", 4),
    "skipped cluster barrier": (WAIT, "if (b % 2 == 0) cluster_sync();", 4),
}


@pytest.fixture(scope="module")
def build(tmp_path_factory):
    """Builds each case's source once, for both of its launches."""
    directory, libs = tmp_path_factory.mktemp("shim"), {}

    def get(case):
        if case not in libs:
            wait, fault, _ = CASES[case]
            src = SOURCE.replace("WAIT", wait).replace("FAULT", fault)
            libs[case] = compile_source(
                rewrite(src), f"tiny{len(libs)}", directory,
                {"emu_tiny": [ctypes.c_void_p] * 2 + [ctypes.c_int]})
        return libs[case]
    return get


@pytest.mark.parametrize("late", [0, 1])
@pytest.mark.parametrize("case", list(CASES))
def test_emulation_catches_seeded_fault(build, case, late):
    code = CASES[case][2]
    lib = build(case)
    x = np.random.RandomState(0).standard_normal(4 * 256).astype(np.float32)
    y = np.full_like(x, np.nan)
    assert lib.emu_tiny(x.ctypes.data, y.ctypes.data, late) == code
    if code == 0:
        # block b of each cluster adds its neighbour's 256 floats
        blocks = x.reshape(2, 2, 256)
        np.testing.assert_array_equal(
            y.reshape(2, 2, 256), blocks + blocks[:, ::-1])
