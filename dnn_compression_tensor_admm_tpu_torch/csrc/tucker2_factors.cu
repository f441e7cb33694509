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
//   is an argument (0 leaves the Grams of X and the HOSVD init).
//   A full-rank mode (r >= n) returns the identity and skips its work.
// Outputs u0[L, O, r0] and u1[L, I, r1], float32.
//
// Bound on the H100 (SXM, 700 W): the main path's 5 buckets of ResNet32-TK@3x
// need 0.84 GFLOP of float32 (`factor_flops` in ops/cuda/tucker_kernel.py) and
// move about 2 MB per Z-step, so the card could take 12.6 us at its 67 TFLOP/s
// non-tensor float32 rate: the work is bound by operations, not bytes. What
// bounds it in practice is latency: each layer is a chain of about 800 small
// dependent products separated by block-wide barriers (28 orthogonal-iteration
// steps of ~28 phases each), on one 256-thread block per layer (grid = L, 1 to
// 10 blocks for 132 SMs).
//
// The design, for the H100. Every output is summed in the same order as in
// the first version (one product per k, each summed over p in order with one
// fmaf per term, added to the running total in k order; zero pads at the end
// of a sum), so the results are the same bit for bit.
// 1. The resident plan (every main-path bucket). Layer l's X [K, O, I] is
//    copied once into shared memory with cp.async, 16 bytes a piece,
//    neighbouring threads on neighbouring addresses, at a row stride ldx that
//    is an odd number of float4s with zero pads to a multiple of 4. A Gram is
//    one phase for all k: a 16 x 16 thread grid holds it as register
//    micro-tiles (1x1, 2x2, or 4x4 on 64 x 64 blocks), each thread summing
//    each k's terms in registers and adding them to its running total.
//    G0 = sum X_k X_k^T reads rows of X as float4 along the summed index (8
//    neighbouring rows on 8 distinct bank groups, by the odd stride); G1 =
//    sum X_k^T X_k reads X's rows along the output index (contiguous float4s).
//    The HOOI products M_k = X_k U1 (or N_k = U0^T X_k) for a group of k are
//    one padded product phase, their Gram a second; the group holds all K but
//    at [9, 9, 64, 64], where X (156,672 B) leaves room for 5 of the 9 M_k
//    beside the factors: there two groups (5 + 4) cost 2 phases more than
//    one, where reading X from L2 for M would read 9 x 16 KB per product
//    again. The M_k and N_k live where Y and the Newton-Schulz matrices go
//    during the iteration. The factors, Y and the Newton-Schulz matrices are
//    in the padded layout (orth_iter4 in orth_iter.cuh: float4 products from
//    padded rank 12 up, the scalar tiles below).
// 2. The streamed plan, for shapes whose X does not fit beside that (near a
//    block's limit): the first version's unpadded plan, byte for byte, with
//    the two HOSVD Grams streaming X_k through two cp.async chunk buffers
//    where Y, M and the Newton-Schulz matrices go later (G0's chunks are
//    transposed column slices, G1's row slices), accumulated in registers as
//    above (gram_streamed in stage.cuh, the subspace kernel's Gram with a
//    sum over k). The HOOI products read X_k from device memory (L2) one k at a
//    time, and the iteration runs the scalar products, as before.
// 3. Shapes whose streamed plan does not fit a block either take the
//    workspace plan, tucker2_factors_ws.cu, built as a library of its own.
// Products are plain FMA loops in float32: TF32 tensor cores would break
// exactness on full-rank layers and destabilise the Newton-Schulz iteration.

#include <cuda_runtime.h>

#include <cstdint>

#include "orth_iter.cuh"  // products, set_eye, orth_iter(4); kNsIters = 12
#include "stage.cuh"      // cp.async copies, Gram tiles, gram_streamed

namespace {

constexpr int kThreads = 256;
constexpr int kInitIters = 8;   // HOSVD start: orthogonal-iteration steps
constexpr int kSweepIters = 3;  // orthogonal-iteration steps per HOOI sweep
// The least multiple of 4 >= x that is an odd number of float4s: 8
// consecutive rows at this stride start on 8 distinct 16-byte bank groups.
__host__ __device__ inline int odd4(int x) {
  const int s = up4(x);
  return (s & 4) ? s : s + 4;
}

struct Plan {
  bool resident;  // X held in shared memory (else the streamed plan)
  int ldx, ldm;   // resident: row strides of X_k and M_k
  int kg;         // resident: k per HOOI product phase
  int x, g, u0, u1, y, m, ns;  // float offsets into dynamic shared memory
  int total;                   // floats
};

// Shared-memory plan; the Python gate (ops/cuda/tucker_kernel.py::_plan)
// repeats it. Resident, padded (every size rounded up to 4): X [K, op, ldx],
// the Gram [np, np], U0 [op, r0p], U1 [ip, r1p], then either Y [np, rp] and
// five Newton-Schulz matrices [rp, rp], or kg HOOI products, each
// max(M_k [op, ldm], N_k [r0p, ip]). Streamed, unpadded, the first version's
// plan: the Gram [n, n], U0, U1, Y [n, r], the HOOI product, five [r, r].
__host__ __device__ inline Plan make_plan(int k, int o, int i, int r0, int r1) {
  const int op = up4(o), ip = up4(i), r0p = up4(r0), r1p = up4(r1);
  const int np = imax(op, ip), rp = imax(r0p, r1p);
  Plan p;
  p.ldx = odd4(ip);
  p.ldm = odd4(r1p);
  p.x = 0;
  p.g = k * op * p.ldx;
  p.u0 = p.g + np * np;
  p.u1 = p.u0 + op * r0p;
  p.y = p.u1 + ip * r1p;
  p.m = p.y;  // the HOOI products take Y's and the Newton-Schulz matrices' room
  p.ns = p.y + np * rp;
  const int per_k = imax(op * p.ldm, r0p * ip);
  const int room = kMaxSmemFloats - p.y;
  const int fit = room > 0 ? imin(k, room / per_k) : 0;
  const int groups = fit > 0 ? (k + fit - 1) / fit : 1;
  p.kg = fit > 0 ? (k + groups - 1) / groups : 0;  // groups of equal size
  p.total = p.y + imax(np * rp + 5 * rp * rp, p.kg * per_k);
  p.resident = p.kg > 0 && p.total <= kMaxSmemFloats;
  if (p.resident) return p;
  const int n = imax(o, i), r = imax(r0, r1);
  p.ldx = p.ldm = p.kg = 0;
  p.g = 0;
  p.u0 = n * n;
  p.u1 = p.u0 + o * r0;
  p.y = p.u1 + i * r1;
  p.m = p.y + n * r;
  p.ns = p.m + imax(o * r1, r0 * i);
  p.total = p.ns + 5 * r * r;
  return p;
}

#include "tucker2_products.cuh"  // resident Grams, HOOI products, orth_iter_padded

// One compiled copy of the unpadded iteration, as orth_iter_padded.
__device__ __noinline__ void orth_iter_unpadded(const float* g, float* q, int n,
                                                int r, int iters, float* y,
                                                float* ns) {
  orth_iter(g, q, n, r, iters, y, ns);
}

// ---------------------------------------------------------------------------
// The resident plan

// X [k, o, i] (device memory) -> xs [k, op, ldx] with zero pads in columns
// [i, up4(i)) and rows [o, op); cp.async, 16 bytes a piece where i and x
// allow. The copies are committed, not waited for.
__device__ void stage_x(float* xs, int ldx, const float* x, int k, int o,
                        int i, int op) {
  const int ip = up4(i);
  if (ip != i)
    for (int idx = threadIdx.x; idx < k * op * (ip - i); idx += blockDim.x) {
      const int row = idx / (ip - i);
      xs[row * ldx + i + idx - row * (ip - i)] = 0.f;
    }
  if (op != o)
    for (int idx = threadIdx.x; idx < k * (op - o) * ip; idx += blockDim.x) {
      const int row = idx / ip, kk = row / (op - o);
      xs[(kk * op + o + row - kk * (op - o)) * ldx + idx - row * ip] = 0.f;
    }
  if (i % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const int w4 = i / 4;
    for (int idx = threadIdx.x; idx < k * o * w4; idx += blockDim.x) {
      const int row = idx / w4, c4 = idx - row * w4, kk = row / o;
      cp_async16(xs + (row + kk * (op - o)) * ldx + 4 * c4, x + row * i + 4 * c4);
    }
  } else {
    for (int idx = threadIdx.x; idx < k * o * i; idx += blockDim.x) {
      const int row = idx / i, col = idx - row * i, kk = row / o;
      cp_async4(xs + (row + kk * (op - o)) * ldx + col, x + idx);
    }
  }
  cp_async_commit();
}

__device__ void solve_resident(const Plan& p, float* smem, const float* xl,
                               int k, int o, int i, int r0, int r1, int sweeps) {
  const int op = up4(o), ip = up4(i), r0p = up4(r0), r1p = up4(r1);
  const int xk = op * p.ldx;  // floats from X_k to X_{k+1}
  float* xs = smem + p.x;
  float* g = smem + p.g;
  float* u0 = smem + p.u0;
  float* u1 = smem + p.u1;
  float* y = smem + p.y;
  float* mk = smem + p.m;
  float* ns = smem + p.ns;
  const bool solve0 = r0 < o, solve1 = r1 < i;
  if (solve0 || solve1) stage_x(xs, p.ldx, xl, k, o, i, op);
  set_eye(u0, op, r0, r0p);
  set_eye(u1, ip, r1, r1p);
  if (!solve0 && !solve1) return;
  cp_async_wait<0>();
  __syncthreads();

  // HOSVD init (a full-rank factor is the identity)
  if (solve0) {  // G0 = sum_k X_k X_k^T
    gram_nt_any(g, op, xs, p.ldx, xk, k, o, ip, false);
    orth_iter_padded(g, u0, op, r0, r0p, kInitIters, y, ns);
  }
  if (solve1) {  // G1 = sum_k X_k^T X_k
    gram_tn_any(g, ip, xs, p.ldx, xk, k, i, o, false);
    orth_iter_padded(g, u1, ip, r1, r1p, kInitIters, y, ns);
  }

  // HOOI sweeps, warm-started from the current factors
  for (int s = 0; s < sweeps; ++s) {
    if (solve0) {  // G0' = sum_k (X_k U1)(X_k U1)^T
      for (int k0 = 0; k0 < k; k0 += p.kg) {
        const int kn = imin(p.kg, k - k0);
        matmul4_batch<false>(mk, p.ldm, op * p.ldm, xs + k0 * xk, p.ldx, xk,
                             u1, r1p, 0, op, r1p, ip, kn);
        gram_nt_any(g, op, mk, p.ldm, op * p.ldm, kn, o, r1p, k0 > 0);
      }
      orth_iter_padded(g, u0, op, r0, r0p, kSweepIters, y, ns);
    }
    if (solve1) {  // G1' = sum_k (U0^T X_k)^T (U0^T X_k)
      for (int k0 = 0; k0 < k; k0 += p.kg) {
        const int kn = imin(p.kg, k - k0);
        matmul4_batch<true>(mk, ip, r0p * ip, u0, r0p, 0, xs + k0 * xk, p.ldx,
                            xk, r0p, ip, op, kn);
        gram_tn_any(g, ip, mk, ip, r0p * ip, kn, i, r0, k0 > 0);
      }
      orth_iter_padded(g, u1, ip, r1, r1p, kSweepIters, y, ns);
    }
  }
}

// ---------------------------------------------------------------------------
// The streamed plan

// g [m, m] = G0 (mode0: X_k's columns, transposed into chunks) or G1 (X_k's
// rows) of the layer's X (device memory), X_k after X_k through two chunk
// buffers of `stage` floats. A transposed chunk's row stride is an odd
// number of float4s where the buffer has room, so its copy meets no bank
// conflict.
__device__ void gram_of_x(float* g, const float* x, int k, int o, int i,
                          bool mode0, float* buf, int stage) {
  const int m = mode0 ? o : i;
  const int ldc = mode0 && odd4(m) <= stage ? odd4(m) : m;
  gram_streamed(g, m, x, o * i, k, mode0, m, i, mode0 ? i : o, ldc, buf,
                stage, false);
}

__device__ void solve_streamed(const Plan& p, float* smem, const float* xl,
                               int k, int o, int i, int r0, int r1, int sweeps) {
  float* g = smem + p.g;
  float* u0 = smem + p.u0;
  float* u1 = smem + p.u1;
  float* y = smem + p.y;
  float* m = smem + p.m;
  float* ns = smem + p.ns;
  const int stage = (p.total - p.y) / 2;  // two chunk buffers from Y on
  const bool solve0 = r0 < o, solve1 = r1 < i;

  // HOSVD init (a full-rank factor is the identity)
  set_eye(u0, o, r0, r0);
  set_eye(u1, i, r1, r1);
  if (solve0) {
    gram_of_x(g, xl, k, o, i, true, y, stage);
    orth_iter_unpadded(g, u0, o, r0, kInitIters, y, ns);
  }
  if (solve1) {
    gram_of_x(g, xl, k, o, i, false, y, stage);
    orth_iter_unpadded(g, u1, i, r1, kInitIters, y, ns);
  }

  // HOOI sweeps, one k at a time, X_k read from device memory
  for (int s = 0; s < sweeps; ++s) {
    if (solve0) {
      for (int kk = 0; kk < k; ++kk) {  // G0' = sum_k (X_k U1)(X_k U1)^T
        const float* xk = xl + kk * o * i;
        matmul(m, r1, xk, i, 1, u1, r1, 1, o, r1, i, false);
        matmul(g, o, m, r1, 1, m, 1, r1, o, o, r1, kk > 0);
      }
      orth_iter_unpadded(g, u0, o, r0, kSweepIters, y, ns);
    }
    if (solve1) {
      for (int kk = 0; kk < k; ++kk) {  // G1' = sum_k (U0^T X_k)^T (U0^T X_k)
        const float* xk = xl + kk * o * i;
        matmul(m, i, u0, 1, r0, xk, i, 1, r0, i, o, false);
        matmul(g, i, m, 1, i, m, i, 1, i, i, r0, kk > 0);
      }
      orth_iter_unpadded(g, u1, i, r1, kSweepIters, y, ns);
    }
  }
}

// At 1 to 10 blocks for 132 SMs a block has its SM to itself, so one block
// per SM is asked for and ptxas may use up to 255 registers a thread. Given
// the thread count alone, it capped this kernel at 128 registers with 348
// bytes of spill, 5% slower on the H100 (PERF.md).
__global__ void __launch_bounds__(kThreads, 1)
tucker2_factors_kernel(const float* __restrict__ x, float* __restrict__ u0_out,
                       float* __restrict__ u1_out, int k, int o, int i, int r0,
                       int r1, int sweeps) {
  extern __shared__ float smem[];
  const Plan p = make_plan(k, o, i, r0, r1);
  const float* xl = x + static_cast<size_t>(blockIdx.x) * k * o * i;
  if (p.resident)
    solve_resident(p, smem, xl, k, o, i, r0, r1, sweeps);
  else
    solve_streamed(p, smem, xl, k, o, i, r0, r1, sweeps);
  const int ld0 = p.resident ? up4(r0) : r0, ld1 = p.resident ? up4(r1) : r1;
  const float* u0 = smem + p.u0;
  const float* u1 = smem + p.u1;
  float* u0l = u0_out + static_cast<size_t>(blockIdx.x) * o * r0;
  float* u1l = u1_out + static_cast<size_t>(blockIdx.x) * i * r1;
  for (int idx = threadIdx.x; idx < o * r0; idx += blockDim.x)
    u0l[idx] = u0[(idx / r0) * ld0 + idx % r0];
  for (int idx = threadIdx.x; idx < i * r1; idx += blockDim.x)
    u1l[idx] = u1[(idx / r1) * ld1 + idx % r1];
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs for a [K, O, I] layer.
int tucker2_factors_smem_bytes(int k, int o, int i, int r0, int r1) {
  return make_plan(k, o, i, r0, r1).total * static_cast<int>(sizeof(float));
}

// Launches the solve on `stream`; returns cudaGetLastError() (0 on success).
// Requires 1 <= r0 <= O and 1 <= r1 <= I; the caller checks shapes.
int tucker2_factors_launch(const void* x, void* u0, void* u1, int l, int k,
                           int o, int i, int r0, int r1, int sweeps,
                           void* stream) {
  if (l == 0) return 0;
  const int bytes = tucker2_factors_smem_bytes(k, o, i, r0, r1);
  cudaError_t err = cudaFuncSetAttribute(
      tucker2_factors_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  tucker2_factors_kernel<<<l, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(u0), static_cast<float*>(u1),
      k, o, i, r0, r1, sweeps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
