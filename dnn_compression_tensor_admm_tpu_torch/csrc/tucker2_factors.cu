// Batched Tucker-2 factor solve for the ADMM Z-step, CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel
// dnn_compression_tensor_admm_tpu/ops/pallas/tucker_kernel.py::tucker2_factors_batched
// (body `_tk_factor_kernel`, helpers `_orth_iter`, `_ns_inv_sqrt`, `_dot`).
//
// What it computes, for each layer l of an x[L, K, O, I] float32 stack
// (X_k = x[l, k] is an O x I matrix; K = kh*kw for a conv):
//   G0 = sum_k X_k X_k^T, G1 = sum_k X_k^T X_k
//   HOSVD init:  U0 = orth_iter(G0, eye(O, r0), kInitIters)
//                U1 = orth_iter(G1, eye(I, r1), kInitIters)
//   `sweeps` warm-started HOOI sweeps:
//                U0 = orth_iter(sum_k (X_k U1)(X_k U1)^T, U0, kSweepIters)
//                U1 = orth_iter(sum_k (U0^T X_k)^T (U0^T X_k), U1, kSweepIters)
//   orth_iter(G, Q): Y = G Q; Q = Y (Y^T Y)^{-1/2}, the inverse square root by
//   kNsIters Newton-Schulz steps on S/tr(S) + 1e-6 I, then scaled by tr(S)^{-1/2}.
//   The iteration counts are the reference kernel's (8, 3, 12); only `sweeps`
//   is an argument.
//   A full-rank mode (r >= n) returns the identity and skips its work.
// Outputs u0[L, O, r0] and u1[L, I, r1], float32.
//
// Bound on the H100 (SXM, 700 W): the main path's 5 buckets of ResNet32-TK@3x
// need 0.84 GFLOP of float32 (`factor_flops` in ops/cuda/tucker_kernel.py) and
// move about 2 MB per Z-step, so the card could take 12.6 us at its 67 TFLOP/s
// non-tensor float32 rate: the work is bound by operations, not bytes.
//
// Why this kernel sits far from that bound: each layer is a chain of about a
// thousand small dependent products (28 orthogonal-iteration steps, each with a
// 12-step Newton-Schulz loop on r x r matrices, r <= 32), separated by block-wide
// barriers, and a bucket gives only 1 to 10 blocks for 132 SMs. The design is
// the simple one: one 256-thread block per layer (grid = L); X stays in device
// memory (a whole bucket is at most 1.3 MB, which L2 holds); the Grams, the
// factors, the iterates and the Newton-Schulz matrices live in dynamic shared
// memory; the HOOI products M_k are made one k at a time and accumulated into
// the Gram, so all K of them are never held at once. Products are plain FMA
// loops in float32: TF32 tensor cores would break exactness on full-rank
// layers and destabilise the Newton-Schulz iteration.

#include <cuda_runtime.h>

#include "orth_iter.cuh"  // matmul, set_eye, orth_iter; kNsIters = 12

namespace {

constexpr int kThreads = 256;
constexpr int kInitIters = 8;   // HOSVD start: orthogonal-iteration steps
constexpr int kSweepIters = 3;  // orthogonal-iteration steps per HOOI sweep

struct Plan {
  int g, u0, u1, y, m, ns;  // float offsets into dynamic shared memory
  int total;                // floats
};

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Shared-memory plan; the Python gate (ops/cuda/tucker_kernel.py) repeats it.
__host__ __device__ inline Plan make_plan(int o, int i, int r0, int r1) {
  const int n = imax(o, i);
  const int r = imax(r0, r1);
  Plan p;
  p.g = 0;                            // Gram [n, n]
  p.u0 = p.g + n * n;                 // U0 [O, r0]
  p.u1 = p.u0 + o * r0;               // U1 [I, r1]
  p.y = p.u1 + i * r1;                // orth-iter Y [n, r]
  p.m = p.y + n * r;                  // HOOI product [O, r1] or [r0, I]
  p.ns = p.m + imax(o * r1, r0 * i);  // 5 Newton-Schulz matrices [r, r]
  p.total = p.ns + 5 * r * r;
  return p;
}

__global__ void __launch_bounds__(kThreads)
tucker2_factors_kernel(const float* __restrict__ x, float* __restrict__ u0_out,
                       float* __restrict__ u1_out, int k, int o, int i, int r0,
                       int r1, int sweeps) {
  extern __shared__ float smem[];
  const Plan p = make_plan(o, i, r0, r1);
  float* g = smem + p.g;
  float* u0 = smem + p.u0;
  float* u1 = smem + p.u1;
  float* y = smem + p.y;
  float* m = smem + p.m;
  float* ns = smem + p.ns;
  const float* xl = x + static_cast<size_t>(blockIdx.x) * k * o * i;
  const bool solve0 = r0 < o;
  const bool solve1 = r1 < i;

  // HOSVD init (a full-rank factor is the identity)
  set_eye(u0, o, r0, r0);
  set_eye(u1, i, r1, r1);
  if (solve0) {
    for (int kk = 0; kk < k; ++kk) {  // G0 = sum_k X_k X_k^T
      const float* xk = xl + kk * o * i;
      matmul(g, o, xk, i, 1, xk, 1, i, o, o, i, kk > 0);
    }
    orth_iter(g, u0, o, r0, kInitIters, y, ns);
  }
  if (solve1) {
    for (int kk = 0; kk < k; ++kk) {  // G1 = sum_k X_k^T X_k
      const float* xk = xl + kk * o * i;
      matmul(g, i, xk, 1, i, xk, i, 1, i, i, o, kk > 0);
    }
    orth_iter(g, u1, i, r1, kInitIters, y, ns);
  }

  // HOOI sweeps, warm-started from the current factors
  for (int s = 0; s < sweeps; ++s) {
    if (solve0) {
      for (int kk = 0; kk < k; ++kk) {  // G0' = sum_k (X_k U1)(X_k U1)^T
        const float* xk = xl + kk * o * i;
        matmul(m, r1, xk, i, 1, u1, r1, 1, o, r1, i, false);
        matmul(g, o, m, r1, 1, m, 1, r1, o, o, r1, kk > 0);
      }
      orth_iter(g, u0, o, r0, kSweepIters, y, ns);
    }
    if (solve1) {
      for (int kk = 0; kk < k; ++kk) {  // G1' = sum_k (U0^T X_k)^T (U0^T X_k)
        const float* xk = xl + kk * o * i;
        matmul(m, i, u0, 1, r0, xk, i, 1, r0, i, o, false);
        matmul(g, i, m, 1, i, m, i, 1, i, i, r0, kk > 0);
      }
      orth_iter(g, u1, i, r1, kSweepIters, y, ns);
    }
  }

  float* u0l = u0_out + static_cast<size_t>(blockIdx.x) * o * r0;
  float* u1l = u1_out + static_cast<size_t>(blockIdx.x) * i * r1;
  for (int idx = threadIdx.x; idx < o * r0; idx += blockDim.x) u0l[idx] = u0[idx];
  for (int idx = threadIdx.x; idx < i * r1; idx += blockDim.x) u1l[idx] = u1[idx];
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs for an [O, I] layer.
int tucker2_factors_smem_bytes(int o, int i, int r0, int r1) {
  return make_plan(o, i, r0, r1).total * static_cast<int>(sizeof(float));
}

// Launches the solve on `stream`; returns cudaGetLastError() (0 on success).
// Requires 1 <= r0 <= O and 1 <= r1 <= I; the caller checks shapes.
int tucker2_factors_launch(const void* x, void* u0, void* u1, int l, int k,
                           int o, int i, int r0, int r1, int sweeps,
                           void* stream) {
  if (l == 0) return 0;
  const int bytes = tucker2_factors_smem_bytes(o, i, r0, r1);
  cudaError_t err = cudaFuncSetAttribute(
      tucker2_factors_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  tucker2_factors_kernel<<<l, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(u0), static_cast<float*>(u1),
      k, o, i, r0, r1, sweeps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
