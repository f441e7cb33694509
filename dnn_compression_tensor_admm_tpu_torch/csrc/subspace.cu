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
// an argument (max(8, admm_hooi_iters) on the Z-step; 0 leaves the Gram,
// the identity start and, in the tall case, the lift). The caller returns
// the identity for a full-rank request (r == rows) and never launches.
//
// Bound on the H100 (SXM, 700 W): the 24 launches of one ResNet32-TT@3x
// Z-step need about 0.49 GFLOP of float32 (`subspace_flops` in
// ops/cuda/subspace_kernel.py) and move about 3.3 MB, so the card could
// take about 7.4 us at its 67 TFLOP/s non-tensor float32 rate: the work is
// bound by operations, not bytes.
//
// The design: one 256-thread block per layer (grid = L), plain float32 FMA
// (no TF32: full-rank-in-columns steps such as [10, 144, 16] -> 16 must come
// out exact, and Newton-Schulz needs full float32). Staging and tiling do
// not change the order in which any output is summed. For the H100:
// 1. The Gram. Read straight from device memory, t t^T puts a whole row
//    between neighbouring threads. So t streams through shared memory
//    along its long side (columns of a wide slice, rows of a tall one) in
//    chunks, copied with cp.async and double-buffered, so the next chunk's
//    copy overlaps this chunk's FMAs. A chunk is held with the summed index
//    major (chunk[p][i]): t's own rows when tall; when wide, a transpose in
//    which each warp copies 8 columns x 4 rows (32-byte pieces of device
//    memory) onto distinct banks. A 16 x 16 thread grid holds the Gram (or
//    one 64 x 64 block of a larger one) as register micro-tiles (4 x 4 read
//    as float4 in the padded plan) and writes it to shared memory once. The
//    chunks live where the iterate, Y and the Newton-Schulz matrices go
//    later, so the plan grows only where a block has room.
// 2. The tall lift Y = t V. Read from L2 for every output, t costs more
//    than the product; from cols = 64 up it streams again in row chunks
//    through the Gram's region, free once the iteration ends. Narrower
//    slices keep reading L2, as chunks of fewer than 32 rows cost more in
//    barriers than they save. Y^T Y is one shared-memory product of at
//    most 360 x 40 x 40.
// 3. The small products are register-tiled (orth_iter.cuh) and, in the
//    padded plan, read float4 operands; the Newton-Schulz loop keeps two
//    barriers per step.
// 4. The grid gives 1 to 10 blocks to 132 SMs. Once staged, the Gram is a
//    small share of a wide launch (PERF.md, `gram_ms`), so no thread-block
//    cluster splits it. What remains, and why the kernel sits far above its
//    bound, is the iteration: per layer 8 steps of about 28 dependent small
//    products (r <= 40) separated by barriers, which one block runs in
//    order; each phase of a few thousand FMAs is bound by the latency of
//    its loads, FMA chain and barrier, not by the card's rate.
//
// Shared memory: the unpadded plan holds the Gram, the iterate, Y
// (rows x r) and five r x r Newton-Schulz matrices. The padded plan rounds
// each size up to 4; either grows to the Gram plus two chunks of kStageLen
// where that is larger, but never past the 232,448 bytes a block may have.
// The padded plan is used wherever it fits, the unpadded one where only it
// fits (`subspace_kernel`, launched by `subspace_launch`).
//
// Every shape whose unpadded plan does not fit a block takes the workspace
// plan, a library of its own (subspace_ws.cu), so that its code does not
// change how nvcc compiles this one.
// The Python gate (ops/cuda/subspace_kernel.py::smem_bytes) repeats the
// formula.

#include <cuda_runtime.h>

#include "orth_iter.cuh"  // scalar and padded products, orth_iter(4)
#include "stage.cuh"      // cp.async copies, gram_streamed

namespace {

constexpr int kThreads = 256;
constexpr int kStageLen = 64;  // chunk length the plan grows for
// The tall lift stages t from this many columns up; at 32 columns reading
// L2 was the faster on the H100 (PERF.md). -DSUBSPACE_LIFT_MIN_COLS moves it
// (tools/torch_kernel_ab.py).
#ifndef SUBSPACE_LIFT_MIN_COLS
#define SUBSPACE_LIFT_MIN_COLS 64
#endif
constexpr int kLiftMinCols = SUBSPACE_LIFT_MIN_COLS;

// Shared-memory plan (see the header comment).
struct Plan {
  bool padded;
  int mp, rp;       // m and r, rounded up to 4 in the padded plan
  int g, q, y, ns;  // float offsets into dynamic shared memory
  int stage;        // floats of each of the Gram's two chunk buffers, at mp*mp
  int total;        // floats
};

__host__ __device__ inline Plan make_plan(int rows, int cols, int r) {
  const int m = rows < cols ? rows : cols;
  const int base = m * m + m * r + rows * r + 5 * r * r;  // unpadded
  const int mp = up4(m), rp = up4(r), yp = up4(rows);
  const int padded = mp * mp + mp * rp + yp * rp + 5 * rp * rp;
  int want = imax(padded, mp * mp + 2 * (mp + 4) * kStageLen);
  if (want > kMaxSmemFloats) want = kMaxSmemFloats;
  Plan p;
  p.total = imax(base, want);
  p.padded = padded <= p.total;
  p.mp = p.padded ? mp : m;
  p.rp = p.padded ? rp : r;
  p.g = 0;                              // Gram of the smaller side [m, m]
  p.q = p.g + p.mp * p.mp;              // iterate Q or V [m, r]
  p.y = p.q + p.mp * p.rp;              // Y = G Q, or the tall lift t V [rows, r]
  p.ns = p.y + (p.padded ? yp : rows) * p.rp;  // 5 Newton-Schulz matrices [r, r]
  p.stage = (p.total - p.mp * p.mp) / 2;  // >= m + 2 floats
  if (p.padded) p.stage &= ~3;           // >= mp + 4: 16-byte aligned buffers
  return p;
}

// g[mo, mo] (zero past m) = the Gram of the smaller side of
// t [rows, cols] (device memory), streamed through two shared buffers of
// `stage` floats at buf (float4 reads in the padded plan).
__device__ void gram_staged(float* __restrict__ g, int mo,
                            const float* t, int rows, int cols, float* buf,
                            int stage, bool padded) {
  const bool wide = rows <= cols;
  const int m = wide ? rows : cols;
  const int len = wide ? cols : rows;  // the side the Gram sums over
  // chunk row stride: padded, a multiple of 4 for float4 reads, and wide
  // one float4 past the rows, so that the transposing copy's 4 rows x 8
  // columns per warp land on distinct banks (for m = 32 and 64 exactly)
  const int ldc = padded ? (wide ? up4(m) + 4 : up4(m)) : m;
  // (a chunk's pad columns feed only Gram entries past m, which are
  // stored as 0, so they are never cleared)
  gram_streamed(g, mo, t, 0, 1, wide, m, cols, len, ldc, buf, stage, padded);
}

// Padded tall lift: y[rows, rp] = t[rows, cols] v[mp, rp]. From
// kLiftMinCols up, t streams in chunks of mp/2 rows (row stride mp, zero
// pads) through two buffers in buf (the Gram's mp*mp floats of shared
// memory, free now), read as float4; narrower slices read t from device
// memory (L2) with the scalar tiles, as chunks of fewer than 32 rows cost
// more in barriers than they save.
__device__ void lift_padded(float* __restrict__ y, const float* t,
                            const float* v, int rows, int cols, int mp,
                            int rp, float* buf) {
  if (cols < kLiftMinCols) {  // from L2
    matmul(y, rp, t, cols, 1, v, rp, 1, rows, rp, cols, false);
    return;
  }
  const int kr = mp / 2;
  const int half = kr * mp;
  if (mp != cols) {  // zero the pads of both buffers once
    for (int idx = threadIdx.x; idx < 2 * half; idx += blockDim.x)
      if (idx % mp >= cols) buf[idx] = 0.f;
  }
  const int nchunks = cdiv(rows, kr);
  copy_rows(buf, mp, t, cols, 0, min(kr, rows));
  cp_async_commit();
  for (int c = 0; c < nchunks; ++c) {
    const int c0 = c * kr;
    if (c + 1 < nchunks) {
      copy_rows(buf + ((c + 1) & 1) * half, mp, t, cols, c0 + kr,
                min(kr, rows - c0 - kr));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // ends with the barrier that frees this buffer for the copy after next
    matmul4<false>(y + c0 * rp, rp, buf + (c & 1) * half, mp, v, rp,
                   min(kr, rows - c0), rp, mp);
  }
}

__global__ void __launch_bounds__(kThreads)
subspace_kernel(const float* __restrict__ t, float* __restrict__ q_out,
                int rows, int cols, int r, int iters) {
  extern __shared__ float smem[];
  const Plan p = make_plan(rows, cols, r);
  const int m = rows < cols ? rows : cols;
  float* g = smem + p.g;
  float* q = smem + p.q;
  float* y = smem + p.y;
  float* ns = smem + p.ns;
  const float* tl = t + static_cast<size_t>(blockIdx.x) * rows * cols;
  float* ql = q_out + static_cast<size_t>(blockIdx.x) * rows * r;
  const int mp = p.mp, rp = p.rp;

  gram_staged(g, mp, tl, rows, cols, smem + mp * mp, p.stage,
              p.padded);  // t t^T or t^T t
  set_eye(q, mp, r, rp);
  if (p.padded)
    orth_iter4(g, q, mp, r, rp, iters, y, ns);  // Q, or V in the tall case
  else
    orth_iter(g, q, m, r, iters, y, ns);
  if (rows <= cols) {
    for (int idx = threadIdx.x; idx < rows * r; idx += blockDim.x)
      ql[idx] = q[(idx / r) * rp + idx % r];
    return;
  }
  const float* z;
  if (p.padded) {
    const int yp = up4(rows);
    for (int idx = rows * rp + threadIdx.x; idx < yp * rp; idx += blockDim.x)
      y[idx] = 0.f;                                         // pad rows of Y
    lift_padded(y, tl, q, rows, cols, mp, rp, g);           // Y = t V
    z = gram_inv_sqrt4(y, ns, r, rp, yp);                   // (Y^T Y)^{-1/2}
  } else {
    matmul(y, r, tl, cols, 1, q, r, 1, rows, r, cols, false);  // Y = t V
    matmul(ns, r, y, 1, r, y, r, 1, r, r, rows, false);        // Y^T Y
    z = ns_inv_sqrt(ns, r, r);
  }
  // q = Y Z, the first r columns, straight to device memory
  matmul(ql, r, y, rp, 1, z, rp, 1, rows, r, rp, false);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs for a [rows, cols] slice.
int subspace_smem_bytes(int rows, int cols, int r) {
  return make_plan(rows, cols, r).total * static_cast<int>(sizeof(float));
}

// Launches the block plan on `stream`; returns cudaGetLastError() (0 on
// success). Requires 1 <= r <= min(rows, cols), r < rows and a plan that
// fits a block; the caller checks shapes.
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
