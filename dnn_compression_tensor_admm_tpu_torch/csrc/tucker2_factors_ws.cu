// Batched Tucker-2 factor solve for the ADMM Z-step, the workspace plan:
// CUDA C++ for sm_90a, for layers whose block plans (tucker2_factors.cu) do
// not fit one block's 227 KB of shared memory.
//
// Replaces, with tucker2_factors.cu, the Pallas TPU kernel
// dnn_compression_tensor_admm_tpu/ops/pallas/tucker_kernel.py::tucker2_factors_batched
// (body `_tk_factor_kernel`): the same Grams, HOSVD init (kInitIters steps
// of orthogonal iteration), `sweeps` HOOI sweeps (kSweepIters steps each)
// and Newton-Schulz orthonormalisation (kNsIters) as tucker2_factors.cu,
// whose header says what each computes.
//
// Bound on the H100 (SXM, 700 W): DeiT-tiny TK@2x's 4 buckets of 12 layers
// (192 to 768 x 192 to 768 at ranks 72 and 128) need 214 GFLOP of float32 per
// Z-step (`factor_flops` in ops/cuda/tucker_kernel.py) and move about 40 MB,
// so the card could take 3.20 ms at its 67 TFLOP/s non-tensor float32 rate:
// bound by operations.
//
// The design follows the subspace kernel's workspace plan (subspace.cu). It
// runs the resident block plan's padded iteration (the products of
// tucker2_products.cuh and orth_iter.cuh). Its regions are taken into shared
// memory in the order the iteration reads them most: the five Newton-Schulz
// matrices, the Gram, the factors, Y, then as many HOOI products as fit; the
// rest lie in a per-layer slab of device memory that the wrapper allocates
// (`tucker2_factors_ws_floats` each, 16-byte aligned). The products take
// generic pointers, so they read either memory. X stays in device memory:
// its Grams stream X_k through two shared chunk buffers (gram_streamed in
// stage.cuh; cp.async writes only shared memory) into a Gram in either
// memory, and the HOOI products read X_k from L2 (float4 where O and I are
// multiples of 4, else the scalar tiles). One block per layer (grid = L), as
// in the block plans. On DeiT-tiny the slabs are 0.26 MB (proj) to 3.53 MB
// (fc1, fc2) a layer: 42 MB for a 12-layer bucket, inside the 50 MB L2 but
// not by much. It is a separate library from the block plans, so that its
// calls do not change how nvcc compiles theirs (tucker2_products.cuh).
// Products are plain FMA loops in float32, as in tucker2_factors.cu.

#include <cuda_runtime.h>

#include <cstdint>

#include "orth_iter.cuh"  // products, set_eye, orth_iter4
#include "stage.cuh"      // cp.async copies, gram_streamed

namespace {

constexpr int kThreads = 256;
constexpr int kInitIters = 8;   // HOSVD start: orthogonal-iteration steps
constexpr int kSweepIters = 3;  // orthogonal-iteration steps per HOOI sweep

#include "tucker2_products.cuh"  // resident Grams, HOOI products, orth_iter_padded

// Regions of the workspace plan, in the order they are taken into shared
// memory; a bit of WsPlan::in_ws is set for each that lies in the workspace.
enum : unsigned { kWsNs = 1, kWsG = 2, kWsU = 4, kWsY = 8, kWsM = 16 };
constexpr int kStageLen = 64;  // Gram chunk length the plan grows for

// The workspace plan (see the header comment); the Python gate
// (ops/cuda/tucker_kernel.py::ws_plan) repeats it. The padded layout
// throughout: the five Newton-Schulz matrices [rp, rp], the Gram [np, np],
// the factors U0 [op, r0p] and U1 [ip, r1p], Y [np, rp] and kg HOOI
// products, each max(M_k [op, r1p], N_k [r0p, ip]). Each region is taken
// into shared memory in that order while it fits; the rest lie in the
// layer's slab of the workspace. In shared memory the Gram and the factors
// come first, then the others, which the two chunk buffers of the Grams of
// X cover (they are written only after those Grams); a shared Gram or
// factor leaves room for two chunks of 16 rows.
struct WsPlan {
  int op, ip, r0p, r1p;
  int ldc0, ldc1;             // chunk row strides for G0 and G1
  int kg;                     // k per HOOI product phase
  unsigned in_ws;             // regions in the workspace
  int g, u0, u1, y, m, ns;    // float offsets into shared memory or the slab
  int chunks, stage;          // chunk buffers: offset and floats of each
  int total;                  // floats of shared memory
  int ws;                     // floats of workspace per layer (a multiple of 4)
};

__host__ __device__ inline WsPlan make_ws_plan(int k, int o, int i, int r0,
                                               int r1) {
  WsPlan p;
  p.op = up4(o);
  p.ip = up4(i);
  p.r0p = up4(r0);
  p.r1p = up4(r1);
  const int np = imax(p.op, p.ip), rp = imax(p.r0p, p.r1p);
  p.ldc0 = p.op + 4;  // G0's chunks: X_k's columns, transposed (as subspace.cu)
  p.ldc1 = p.ip;      // G1's chunks: X_k's rows
  const int ldc = imax(p.ldc0, p.ldc1);
  const int chunks_min = 2 * 16 * ldc;
  const int per_k = imax(p.op * p.r1p, p.r0p * p.ip);
  const unsigned bits[5] = {kWsNs, kWsG, kWsU, kWsY, kWsM};
  int sizes[5] = {5 * rp * rp, np * np, p.op * p.r0p + p.ip * p.r1p, np * rp,
                  0};
  int persist = 0, scratch = 0;  // shared floats: Gram and factors, the rest
  p.in_ws = 0;
  for (int j = 0; j < 5; ++j) {
    const bool keeps = bits[j] == kWsG || bits[j] == kWsU;
    if (bits[j] == kWsM) {  // as many HOOI products as fit, in equal groups
      const int room = kMaxSmemFloats - persist - scratch;
      const int fit = room >= per_k ? imin(k, room / per_k) : 0;
      const int groups = fit > 0 ? (k + fit - 1) / fit : 1;
      p.kg = fit > 0 ? (k + groups - 1) / groups : k;
      sizes[j] = p.kg * per_k;
    }
    const int ps = persist + (keeps ? sizes[j] : 0);
    const int sc = scratch + (keeps ? 0 : sizes[j]);
    if (ps + imax(sc, chunks_min) <= kMaxSmemFloats) {
      persist = ps;
      scratch = sc;
    } else {
      p.in_ws |= bits[j];
    }
  }
  // offsets: shared Gram and factors first, then Newton-Schulz, Y, M
  int s_off = 0, w_off = 0;
  int offs[5];
  const int order[5] = {1, 2, 0, 3, 4};
  for (int j = 0; j < 5; ++j) {
    const int r = order[j];
    int& off = (p.in_ws & bits[r]) ? w_off : s_off;
    offs[r] = off;
    off += sizes[r];
  }
  p.ns = offs[0];
  p.g = offs[1];
  p.u0 = offs[2];
  p.u1 = offs[2] + p.op * p.r0p;
  p.y = offs[3];
  p.m = offs[4];
  p.chunks = persist;
  p.total = imax(s_off, imin(persist + 2 * ldc * kStageLen, kMaxSmemFloats));
  p.stage = ((p.total - persist) / 2) & ~3;
  p.ws = w_off;
  return p;
}

// The workspace plan's kernel: the resident plan's padded iteration with
// each region in shared memory or in this layer's slab of ws, and X read
// from device memory: its Grams stream X_k through the chunk buffers
// (gram_streamed), the HOOI products read it from L2.
__global__ void __launch_bounds__(kThreads, 1)
tucker2_factors_ws_kernel(const float* __restrict__ x,
                          float* __restrict__ u0_out,
                          float* __restrict__ u1_out, float* ws, int k, int o,
                          int i, int r0, int r1, int sweeps) {
  extern __shared__ float smem[];
  const WsPlan p = make_ws_plan(k, o, i, r0, r1);
  float* wl = ws + static_cast<size_t>(blockIdx.x) * p.ws;
  const auto at = [&](unsigned bit, int off) {
    return ((p.in_ws & bit) ? wl : smem) + off;
  };
  float* g = at(kWsG, p.g);
  float* u0 = at(kWsU, p.u0);
  float* u1 = at(kWsU, p.u1);
  float* y = at(kWsY, p.y);
  float* mk = at(kWsM, p.m);
  float* ns = at(kWsNs, p.ns);
  float* buf = smem + p.chunks;
  const int op = p.op, ip = p.ip, r0p = p.r0p, r1p = p.r1p;
  const int xk = o * i;  // floats from X_k to X_{k+1}
  const float* xl = x + static_cast<size_t>(blockIdx.x) * k * xk;
  const bool solve0 = r0 < o, solve1 = r1 < i;
  set_eye(u0, op, r0, r0p);
  set_eye(u1, ip, r1, r1p);

  // HOSVD init (a full-rank factor is the identity)
  if (solve0) {  // G0 = sum_k X_k X_k^T
    gram_streamed(g, op, xl, xk, k, true, o, i, i, p.ldc0, buf, p.stage, true);
    orth_iter_padded(g, u0, op, r0, r0p, kInitIters, y, ns);
  }
  if (solve1) {  // G1 = sum_k X_k^T X_k
    gram_streamed(g, ip, xl, xk, k, false, i, i, o, p.ldc1, buf, p.stage, true);
    orth_iter_padded(g, u1, ip, r1, r1p, kInitIters, y, ns);
  }

  // HOOI sweeps: float4 products where X's rows allow, else scalar ones
  const bool vec = o % 4 == 0 && i % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(xl) & 15) == 0;
  for (int s = 0; s < sweeps; ++s) {
    if (solve0) {  // G0' = sum_k (X_k U1)(X_k U1)^T
      for (int k0 = 0; k0 < k; k0 += p.kg) {
        const int kn = imin(p.kg, k - k0);
        if (vec)
          matmul4_batch<false>(mk, r1p, op * r1p, xl + k0 * xk, i, xk, u1, r1p,
                               0, o, r1p, i, kn);
        else
          for (int j = 0; j < kn; ++j)
            matmul(mk + j * op * r1p, r1p, xl + (k0 + j) * xk, i, 1, u1, r1p,
                   1, o, r1p, i, false);
        gram_nt_any(g, op, mk, r1p, op * r1p, kn, o, r1p, k0 > 0);
      }
      orth_iter_padded(g, u0, op, r0, r0p, kSweepIters, y, ns);
    }
    if (solve1) {  // G1' = sum_k (U0^T X_k)^T (U0^T X_k)
      for (int k0 = 0; k0 < k; k0 += p.kg) {
        const int kn = imin(p.kg, k - k0);
        if (vec)
          matmul4_batch<true>(mk, ip, r0p * ip, u0, r0p, 0, xl + k0 * xk, i,
                              xk, r0p, ip, o, kn);
        else
          for (int j = 0; j < kn; ++j)
            matmul(mk + j * r0p * ip, ip, u0, 1, r0p, xl + (k0 + j) * xk, i,
                   1, r0p, i, o, false);
        gram_tn_any(g, ip, mk, ip, r0p * ip, kn, i, r0, k0 > 0);
      }
      orth_iter_padded(g, u1, ip, r1, r1p, kSweepIters, y, ns);
    }
  }
  float* u0l = u0_out + static_cast<size_t>(blockIdx.x) * o * r0;
  float* u1l = u1_out + static_cast<size_t>(blockIdx.x) * i * r1;
  for (int idx = threadIdx.x; idx < o * r0; idx += blockDim.x)
    u0l[idx] = u0[(idx / r0) * r0p + idx % r0];
  for (int idx = threadIdx.x; idx < i * r1; idx += blockDim.x)
    u1l[idx] = u1[(idx / r1) * r1p + idx % r1];
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory, and floats of device memory per layer, of
// the workspace plan for a [K, O, I] layer.
int tucker2_factors_ws_smem_bytes(int k, int o, int i, int r0, int r1) {
  return make_ws_plan(k, o, i, r0, r1).total * static_cast<int>(sizeof(float));
}

int tucker2_factors_ws_floats(int k, int o, int i, int r0, int r1) {
  return make_ws_plan(k, o, i, r0, r1).ws;
}

// Launches the workspace plan on `stream`: ws holds l *
// tucker2_factors_ws_floats floats, 16-byte aligned. Returns
// cudaGetLastError() (0 on success). Requires 1 <= r0 <= O and
// 1 <= r1 <= I; the caller checks shapes.
int tucker2_factors_ws_launch(const void* x, void* u0, void* u1, void* ws,
                              int l, int k, int o, int i, int r0, int r1,
                              int sweeps, void* stream) {
  if (l == 0) return 0;
  const int bytes = tucker2_factors_ws_smem_bytes(k, o, i, r0, r1);
  cudaError_t err = cudaFuncSetAttribute(
      tucker2_factors_ws_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  tucker2_factors_ws_kernel<<<l, kThreads, bytes,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(u0),
      static_cast<float*>(u1), static_cast<float*>(ws), k, o, i, r0, r1,
      sweeps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
