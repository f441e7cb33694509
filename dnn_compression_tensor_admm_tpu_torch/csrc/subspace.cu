// Batched dominant left subspace for the TT Z-step, CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel
// dnn_compression_tensor_admm_tpu/ops/pallas/subspace_kernel.py::
// dominant_left_subspace_batched (body `_subspace_kernel`), the solve inside
// each step of the batched TT-SVD sweep (`tt_project_batched`).
//
// What it computes, for each layer l of a t[L, rows, cols] float32 stack,
// the top-r left singular subspace q[l] [rows, r], iterating on the Gram of
// the smaller side:
//   rows <= cols:  G = t t^T,  q = orth_iter(G, eye(rows, r), iters)
//   rows >  cols:  G = t^T t,  v = orth_iter(G, eye(cols, r), iters),
//                  y = t v,    q = y ns_inv_sqrt(y^T y)
// with orth_iter and ns_inv_sqrt (12 Newton-Schulz steps on S/tr(S) +
// 1e-6 I) from orth_iter.cuh, the Tucker-2 kernel's own copy. `iters` is
// an argument (max(8, admm_hooi_iters) on the Z-step). The caller returns
// the identity for a full-rank request (r == rows) and never launches.
//
// Bound on the H100 (SXM, 700 W): the 24 launches of one ResNet32-TT@3x
// Z-step need about 0.49 GFLOP of float32 (`subspace_flops` in
// ops/cuda/subspace_kernel.py) and move about 3.3 MB, so the card could
// take about 7 us at its 67 TFLOP/s non-tensor float32 rate: the work is
// bound by operations, not bytes.
//
// Why this kernel sits far from that bound: as in the Tucker-2 kernel, each
// layer is a chain of small dependent products (8 orthogonal-iteration
// steps, each with a 12-step Newton-Schulz loop on r x r matrices, r <= 40)
// separated by block-wide barriers, and a launch gives only 1 to 10 blocks
// for 132 SMs. The design is the simple one: one 256-thread block per layer
// (grid = L); t stays in device memory (a launch reads at most 1.3 MB, which
// L2 holds) and is read by the Gram and, in the tall case, the lift; the
// Gram, the iterate, Y and the five Newton-Schulz matrices live in dynamic
// shared memory (at most 70,904 bytes on this path, so the launcher opts in
// above 48 KB); the tall case writes q = Y S^{-1/2} straight to device
// memory.

#include <cuda_runtime.h>

#include "orth_iter.cuh"  // matmul, set_eye, ns_inv_sqrt, orth_iter

namespace {

constexpr int kThreads = 256;

struct Plan {
  int g, q, y, ns;  // float offsets into dynamic shared memory
  int total;        // floats
};

// Shared-memory plan; the Python gate (ops/cuda/subspace_kernel.py) repeats it.
__host__ __device__ inline Plan make_plan(int rows, int cols, int r) {
  const int m = rows < cols ? rows : cols;
  Plan p;
  p.g = 0;                // Gram of the smaller side [m, m]
  p.q = p.g + m * m;      // iterate Q or V [m, r]
  p.y = p.q + m * r;      // Y = G Q [m, r], or the tall lift t V [rows, r]
  p.ns = p.y + rows * r;  // 5 Newton-Schulz matrices [r, r]
  p.total = p.ns + 5 * r * r;
  return p;
}

__global__ void __launch_bounds__(kThreads)
subspace_kernel(const float* __restrict__ t, float* __restrict__ q_out,
                int rows, int cols, int r, int iters) {
  extern __shared__ float smem[];
  const Plan p = make_plan(rows, cols, r);
  float* g = smem + p.g;
  float* q = smem + p.q;
  float* y = smem + p.y;
  float* ns = smem + p.ns;
  const float* tl = t + static_cast<size_t>(blockIdx.x) * rows * cols;
  float* ql = q_out + static_cast<size_t>(blockIdx.x) * rows * r;

  if (rows <= cols) {
    matmul(g, rows, tl, cols, 1, tl, 1, cols, rows, rows, cols, false);  // t t^T
    set_eye(q, rows, r);
    orth_iter(g, q, rows, r, iters, y, ns);
    for (int idx = threadIdx.x; idx < rows * r; idx += blockDim.x) ql[idx] = q[idx];
  } else {
    matmul(g, cols, tl, 1, cols, tl, cols, 1, cols, cols, rows, false);  // t^T t
    set_eye(q, cols, r);
    orth_iter(g, q, cols, r, iters, y, ns);                              // V
    matmul(y, r, tl, cols, 1, q, r, 1, rows, r, cols, false);            // Y = t V
    matmul(ns, r, y, 1, r, y, r, 1, r, r, rows, false);                  // Y^T Y
    const float* z = ns_inv_sqrt(ns, r);
    matmul(ql, r, y, r, 1, z, r, 1, rows, r, r, false);                  // q = Y Z
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs for a [rows, cols] slice.
int subspace_smem_bytes(int rows, int cols, int r) {
  return make_plan(rows, cols, r).total * static_cast<int>(sizeof(float));
}

// Launches the solve on `stream`; returns cudaGetLastError() (0 on success).
// Requires 1 <= r <= min(rows, cols) and r < rows; the caller checks shapes.
int subspace_launch(const void* t, void* q, int l, int rows, int cols, int r,
                    int iters, void* stream) {
  if (l == 0) return 0;
  const int bytes = subspace_smem_bytes(rows, cols, r);
  cudaError_t err = cudaFuncSetAttribute(
      subspace_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  subspace_kernel<<<l, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(t), static_cast<float*>(q), rows, cols, r,
      iters);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
