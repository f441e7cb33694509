// Block-wide small dense products and the orthogonal iteration shared by
// the port's Z-step kernels (tucker2_factors.cu, subspace.cu).
//
// Counterpart of the Pallas helpers `_dot`, `_ns_inv_sqrt` and `_orth_iter`
// in dnn_compression_tensor_admm_tpu/ops/pallas/tucker_kernel.py. Every
// function here is called by all threads of a block, works on matrices in
// shared memory (a product may write device memory) and ends with a
// barrier. Products are plain float32 FMA loops: TF32 tensor cores would
// break exactness on full-rank layers and destabilise Newton-Schulz.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kNsIters = 12;  // Newton-Schulz steps per orthonormalisation

// c[m, n] (row stride ldc) = or += a[m, k] b[k, n]; a and b are addressed by
// (row stride, column stride) so transposes cost nothing. c must not alias a
// or b. Ends with a barrier: every thread of the block must call it.
__device__ void matmul(float* __restrict__ c, int ldc, const float* a, int a_rs,
                       int a_cs, const float* b, int b_rs, int b_cs, int m,
                       int n, int k, bool accumulate) {
  for (int idx = threadIdx.x; idx < m * n; idx += blockDim.x) {
    const int row = idx / n;
    const int col = idx - row * n;
    const float* ap = a + row * a_rs;
    const float* bp = b + col * b_cs;
    float acc = 0.f;
    for (int p = 0; p < k; ++p) acc = fmaf(ap[p * a_cs], bp[p * b_rs], acc);
    float* cp = c + row * ldc + col;
    *cp = accumulate ? *cp + acc : acc;
  }
  __syncthreads();
}

__device__ void set_eye(float* q, int n, int r) {
  for (int idx = threadIdx.x; idx < n * r; idx += blockDim.x)
    q[idx] = (idx / r == idx % r) ? 1.f : 0.f;
  __syncthreads();
}

// S^{-1/2} for a symmetric PSD S [r, r] held in ns[0, r*r), by kNsIters
// Newton-Schulz steps on T = S/c + 1e-6 I (c = tr S), scaled by c^{-1/2}.
// ns holds 5 r x r matrices and is overwritten; returns the one that holds
// the result.
__device__ float* ns_inv_sqrt(float* ns, int r) {
  const int rr = r * r;
  float* s = ns;  // S, later reused as W
  float* yy = ns + rr;
  float* zz = ns + 2 * rr;
  float* yy2 = ns + 3 * rr;
  float* zz2 = ns + 4 * rr;
  float c = 1e-30f;
  for (int d = 0; d < r; ++d) c += s[d * r + d];
  for (int idx = threadIdx.x; idx < rr; idx += blockDim.x) {
    const bool diag = idx / r == idx % r;
    yy[idx] = s[idx] / c + (diag ? 1e-6f : 0.f);  // T = S/c + ridge
    zz[idx] = diag ? 1.f : 0.f;
  }
  __syncthreads();
  float* w = s;
  for (int t = 0; t < kNsIters; ++t) {
    // W = 0.5 (3 I - Z Y)
    for (int idx = threadIdx.x; idx < rr; idx += blockDim.x) {
      const int row = idx / r;
      const int col = idx - row * r;
      float acc = 0.f;
      for (int p = 0; p < r; ++p) acc = fmaf(zz[row * r + p], yy[p * r + col], acc);
      w[idx] = 0.5f * ((row == col ? 3.f : 0.f) - acc);
    }
    __syncthreads();
    // Y' = Y W and Z' = W Z, from the same W
    for (int idx = threadIdx.x; idx < rr; idx += blockDim.x) {
      const int row = idx / r;
      const int col = idx - row * r;
      float acc_y = 0.f;
      float acc_z = 0.f;
      for (int p = 0; p < r; ++p) {
        acc_y = fmaf(yy[row * r + p], w[p * r + col], acc_y);
        acc_z = fmaf(w[row * r + p], zz[p * r + col], acc_z);
      }
      yy2[idx] = acc_y;
      zz2[idx] = acc_z;
    }
    __syncthreads();
    float* tmp = yy; yy = yy2; yy2 = tmp;
    tmp = zz; zz = zz2; zz2 = tmp;
  }
  const float scale = rsqrtf(c);
  for (int idx = threadIdx.x; idx < rr; idx += blockDim.x) zz[idx] *= scale;
  __syncthreads();
  return zz;
}

// Q[n, r] <- orth(G Q) = Y (Y^T Y)^{-1/2} with Y = G Q, `iters` times; Q is
// updated in place. y holds n*r floats, ns 5*r*r.
__device__ void orth_iter(const float* g, float* q, int n, int r, int iters,
                          float* y, float* ns) {
  for (int it = 0; it < iters; ++it) {
    matmul(y, r, g, n, 1, q, r, 1, n, r, n, false);  // Y = G Q
    matmul(ns, r, y, 1, r, y, r, 1, r, r, n, false);  // S = Y^T Y
    const float* z = ns_inv_sqrt(ns, r);
    matmul(q, r, y, r, 1, z, r, 1, n, r, r, false);   // Q = Y S^{-1/2}
  }
}

}  // namespace
