// Block-wide small dense products and the orthogonal iteration shared by
// the port's Z-step kernels (tucker2_factors.cu, subspace.cu).
//
// Counterpart of the Pallas helpers `_dot`, `_ns_inv_sqrt` and `_orth_iter`
// in dnn_compression_tensor_admm_tpu/ops/pallas/tucker_kernel.py. Every
// function here is called by all threads of a block, works on matrices in
// shared memory (a product may read or write device memory) and ends with
// a barrier. Products are plain float32 FMA loops: TF32 tensor cores would
// break exactness on full-rank layers and destabilise Newton-Schulz.
//
// Register tiling: a thread computes a micro-tile of a product with one
// independent accumulator per output, so each shared-memory load feeds
// several FMAs and the FMA chains overlap. Each output still sums over
// p = 0 .. k-1 in order with one fmaf per term, so tiling changes no result
// bit. Two families:
// - scalar tiles (matmul, ns_inv_sqrt, orth_iter): TM x TN of 1x1, 2x2, 4x2
//   or 4x4, the smallest the block covers in one round, rows ti + mt * i and
//   columns tj + nt * j interleaved so that neighbouring threads read
//   neighbouring columns of B; any strides.
// - the padded layout (matmul4, ns_inv_sqrt4, orth_iter4): see below.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kNsIters = 12;  // Newton-Schulz steps per orthonormalisation

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// Micro-tile for `parts` products of m x n outputs at once:
// 0 -> 1x1, 1 -> 2x2, 2 -> 4x2, 3 -> 4x4 (the last may take several rounds).
__device__ __forceinline__ int tile_kind(int m, int n, int parts) {
  const int cap = static_cast<int>(blockDim.x);
  if (parts * m * n <= cap) return 0;
  if (parts * cdiv(m, 2) * cdiv(n, 2) <= cap) return 1;
  if (parts * cdiv(m, 4) * cdiv(n, 2) <= cap) return 2;
  return 3;
}

// acc = a[rows, :k] b[:k, cols] for the micro-tile (ti, tj) of an m x n
// product cut into mt x nt tiles; rows and columns past the edge are
// clamped (computed, never stored).
template <int TM, int TN>
__device__ __forceinline__ void tile_dot(float (&acc)[TM][TN], const float* a,
                                         int a_rs, int a_cs, const float* b,
                                         int b_rs, int b_cs, int m, int n,
                                         int k, int ti, int tj, int mt, int nt) {
  const float* ap[TM];
  const float* bp[TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) ap[i] = a + min(ti + mt * i, m - 1) * a_rs;
#pragma unroll
  for (int j = 0; j < TN; ++j) bp[j] = b + min(tj + nt * j, n - 1) * b_cs;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int p = 0; p < k; ++p) {
    float av[TM], bv[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) av[i] = ap[i][p * a_cs];
#pragma unroll
    for (int j = 0; j < TN; ++j) bv[j] = bp[j][p * b_rs];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <int TM, int TN>
__device__ void matmul_tiles(float* __restrict__ c, int ldc, const float* a,
                             int a_rs, int a_cs, const float* b, int b_rs,
                             int b_cs, int m, int n, int k, bool accumulate) {
  const int mt = cdiv(m, TM), nt = cdiv(n, TN);
  for (int t = threadIdx.x; t < mt * nt; t += blockDim.x) {
    const int ti = t / nt, tj = t - ti * nt;
    float acc[TM][TN];
    tile_dot<TM, TN>(acc, a, a_rs, a_cs, b, b_rs, b_cs, m, n, k, ti, tj, mt, nt);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int row = ti + mt * i, col = tj + nt * j;
        if (row < m && col < n) {
          float* cp = c + row * ldc + col;
          *cp = accumulate ? *cp + acc[i][j] : acc[i][j];
        }
      }
  }
}

// c[m, n] (row stride ldc) = or += a[m, k] b[k, n]; a and b are addressed by
// (row stride, column stride) so transposes cost nothing. c must not alias a
// or b. Ends with a barrier: every thread of the block must call it.
__device__ void matmul(float* __restrict__ c, int ldc, const float* a, int a_rs,
                       int a_cs, const float* b, int b_rs, int b_cs, int m,
                       int n, int k, bool accumulate) {
  switch (tile_kind(m, n, 1)) {
    case 0: matmul_tiles<1, 1>(c, ldc, a, a_rs, a_cs, b, b_rs, b_cs, m, n, k, accumulate); break;
    case 1: matmul_tiles<2, 2>(c, ldc, a, a_rs, a_cs, b, b_rs, b_cs, m, n, k, accumulate); break;
    case 2: matmul_tiles<4, 2>(c, ldc, a, a_rs, a_cs, b, b_rs, b_cs, m, n, k, accumulate); break;
    default: matmul_tiles<4, 4>(c, ldc, a, a_rs, a_cs, b, b_rs, b_cs, m, n, k, accumulate);
  }
  __syncthreads();
}

// q[n, ld] = eye(n, r), zero in the columns [r, ld).
__device__ void set_eye(float* q, int n, int r, int ld) {
  for (int idx = threadIdx.x; idx < n * ld; idx += blockDim.x)
    q[idx] = (idx / ld == idx % ld && idx % ld < r) ? 1.f : 0.f;
  __syncthreads();
}

// Newton-Schulz, first half of a step: W = 0.5 (3 I - Z Y), on ld x ld
// matrices whose identity covers the first r indices (ld = r unpadded).
template <int TM, int TN>
__device__ void ns_w(float* __restrict__ w, const float* zz, const float* yy,
                     int r, int ld) {
  const int mt = cdiv(ld, TM), nt = cdiv(ld, TN);
  for (int t = threadIdx.x; t < mt * nt; t += blockDim.x) {
    const int ti = t / nt, tj = t - ti * nt;
    float acc[TM][TN];
    tile_dot<TM, TN>(acc, zz, ld, 1, yy, ld, 1, ld, ld, ld, ti, tj, mt, nt);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int row = ti + mt * i, col = tj + nt * j;
        if (row < ld && col < ld)
          w[row * ld + col] =
              0.5f * ((row == col && row < r ? 3.f : 0.f) - acc[i][j]);
      }
  }
}

// Newton-Schulz, second half of a step: Y' = Y W and Z' = (W Z) zscale,
// both products in one round of tiles.
template <int TM, int TN>
__device__ void ns_yz(float* __restrict__ yy2, float* __restrict__ zz2,
                      const float* yy, const float* w, const float* zz, int ld,
                      float zscale) {
  const int mt = cdiv(ld, TM), nt = cdiv(ld, TN);
  const int tiles = mt * nt;
  for (int t = threadIdx.x; t < 2 * tiles; t += blockDim.x) {
    const bool z_side = t >= tiles;
    const int tt = z_side ? t - tiles : t;
    const int ti = tt / nt, tj = tt - ti * nt;
    float acc[TM][TN];
    if (z_side)
      tile_dot<TM, TN>(acc, w, ld, 1, zz, ld, 1, ld, ld, ld, ti, tj, mt, nt);
    else
      tile_dot<TM, TN>(acc, yy, ld, 1, w, ld, 1, ld, ld, ld, ti, tj, mt, nt);
    float* out = z_side ? zz2 : yy2;
    const float s = z_side ? zscale : 1.f;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int row = ti + mt * i, col = tj + nt * j;
        if (row < ld && col < ld) out[row * ld + col] = acc[i][j] * s;
      }
  }
}

// S^{-1/2} for a symmetric PSD S [r, r] held in ns[0, ld*ld) (row stride
// ld >= r, zero past r), by kNsIters Newton-Schulz steps on
// T = S/c + 1e-6 I (c = tr S), scaled by c^{-1/2} (folded into the last
// step's Z product). ns holds 5 ld x ld matrices and is overwritten;
// returns the one that holds the result (zero past r too). Two barriers per
// step, the least the recurrence allows.
__device__ float* ns_inv_sqrt(float* ns, int r, int ld) {
  const int rr = ld * ld;
  float* s = ns;  // S, later reused as W
  float* yy = ns + rr;
  float* zz = ns + 2 * rr;
  float* yy2 = ns + 3 * rr;
  float* zz2 = ns + 4 * rr;
  float c = 1e-30f;
  for (int d = 0; d < r; ++d) c += s[d * ld + d];
  for (int idx = threadIdx.x; idx < rr; idx += blockDim.x) {
    const int row = idx / ld, col = idx - row * ld;
    const bool diag = row == col && row < r;
    yy[idx] = s[idx] / c + (diag ? 1e-6f : 0.f);  // T = S/c + ridge
    zz[idx] = diag ? 1.f : 0.f;
  }
  __syncthreads();
  float* w = s;
  const int kind_w = tile_kind(ld, ld, 1);
  const int kind_yz = tile_kind(ld, ld, 2);
  const float scale = rsqrtf(c);
  for (int t = 0; t < kNsIters; ++t) {
    switch (kind_w) {
      case 0: ns_w<1, 1>(w, zz, yy, r, ld); break;
      case 1: ns_w<2, 2>(w, zz, yy, r, ld); break;
      case 2: ns_w<4, 2>(w, zz, yy, r, ld); break;
      default: ns_w<4, 4>(w, zz, yy, r, ld);
    }
    __syncthreads();
    const float zscale = t == kNsIters - 1 ? scale : 1.f;
    switch (kind_yz) {
      case 0: ns_yz<1, 1>(yy2, zz2, yy, w, zz, ld, zscale); break;
      case 1: ns_yz<2, 2>(yy2, zz2, yy, w, zz, ld, zscale); break;
      case 2: ns_yz<4, 2>(yy2, zz2, yy, w, zz, ld, zscale); break;
      default: ns_yz<4, 4>(yy2, zz2, yy, w, zz, ld, zscale);
    }
    __syncthreads();
    float* tmp = yy; yy = yy2; yy2 = tmp;
    tmp = zz; zz = zz2; zz2 = tmp;
  }
  return zz;
}

// Q[n, r] <- orth(G Q) = Y (Y^T Y)^{-1/2} with Y = G Q, `iters` times; Q is
// updated in place. y holds n*r floats, ns 5*r*r.
__device__ void orth_iter(const float* g, float* q, int n, int r, int iters,
                          float* y, float* ns) {
  for (int it = 0; it < iters; ++it) {
    matmul(y, r, g, n, 1, q, r, 1, n, r, n, false);  // Y = G Q
    matmul(ns, r, y, 1, r, y, r, 1, r, r, n, false);  // S = Y^T Y
    const float* z = ns_inv_sqrt(ns, r, r);
    matmul(q, r, y, r, 1, z, r, 1, n, r, r, false);   // Q = Y S^{-1/2}
  }
}

// ---------------------------------------------------------------------------
// The padded layout. Every matrix has a row stride that is a multiple of 4
// floats, starts 16-byte aligned and is zero past its logical size, and
// every summed length and column count is padded to a multiple of 4. A
// thread then holds TM (2 or 4) rows x 4 contiguous columns of a product
// and reads both operands as float4: TM + 4 load instructions for 16 TM
// FMAs, where the scalar 4x2 tile issues 24 for 32. The zero pads add
// exact zeros at the end of each sum, so every output is the same as in the
// unpadded products.

__device__ __forceinline__ float f4(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

__device__ __forceinline__ const float4& ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[i][j] = sum over p < k4 of a(rows[i], p) b(p, c0 + j), p in order;
// a(row, p) = a[row * lda + p], or with AT a[p * lda + row] (then the TM = 4
// rows are contiguous from rows[0]).
template <int TM, bool AT>
__device__ __forceinline__ void tile_dot4(float (&acc)[TM][4], const float* a,
                                          int lda, const float* b, int ldb,
                                          int k4, const int (&rows)[TM],
                                          int c0) {
  static_assert(!AT || TM == 4, "a transposed A takes 4 contiguous rows");
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int p = 0; p < k4; p += 4) {
    float4 bv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) bv[q] = ld4(b + (p + q) * ldb + c0);
    if (AT) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 av = ld4(a + (p + q) * lda + rows[0]);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(f4(av, i), f4(bv[q], j), acc[i][j]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 av = ld4(a + rows[i] * lda + p);
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(f4(av, q), f4(bv[q], j), acc[i][j]);
      }
    }
  }
}

// Rows of a tile: interleaved (ti + mt * i, clamped) for a row-major A,
// contiguous (4 ti + i) for a transposed one.
template <int TM, bool AT>
__device__ __forceinline__ void tile_rows(int (&rows)[TM], int ti, int mt,
                                          int m) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
    rows[i] = AT ? 4 * ti + i : min(ti + mt * i, m - 1);
}

template <int TM, bool AT>
__device__ __forceinline__ int tile_row(int ti, int mt, int i) {
  return AT ? 4 * ti + i : ti + mt * i;
}

// Rows per tile of the row-major padded products, 2 or 4. One fixed count
// compiles to less code than a choice made per product, and 2 was the
// faster on the H100 at all but the r = 40 launch (PERF.md);
// -DORTH_TILE_ROWS=4 builds the other (tools/torch_kernel_ab.py).
#ifndef ORTH_TILE_ROWS
#define ORTH_TILE_ROWS 2
#endif
constexpr int kTileRows = ORTH_TILE_ROWS;
static_assert(kTileRows == 2 || kTileRows == 4, "ORTH_TILE_ROWS is 2 or 4");

// c[m, n4] = a b in the padded layout, m rows of A (or, with AT, of A^T's
// columns: m a multiple of 4), k4 summed. epi(row, col, v) takes 4 outputs.
template <int TM, bool AT, class Epi>
__device__ __forceinline__ void mm4_tiles(const float* a, int lda,
                                          const float* b, int ldb, int m,
                                          int n4, int k4, Epi epi) {
  const int nt = n4 >> 2;
  const int mt = AT ? m >> 2 : cdiv(m, TM);
  for (int t = threadIdx.x; t < mt * nt; t += blockDim.x) {
    const int ti = t / nt, tj = t - ti * nt;
    int rows[TM];
    tile_rows<TM, AT>(rows, ti, mt, m);
    float acc[TM][4];
    tile_dot4<TM, AT>(acc, a, lda, b, ldb, k4, rows, 4 * tj);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = tile_row<TM, AT>(ti, mt, i);
      if (row < m) epi(row, 4 * tj, acc[i]);
    }
  }
}

// c[m, n4] (row stride ldc, a multiple of 4) = a b, stored as float4.
template <bool AT>
__device__ void matmul4(float* __restrict__ c, int ldc, const float* a,
                        int lda, const float* b, int ldb, int m, int n4,
                        int k4) {
  const auto store = [&](int row, int col, const float* v) {
    *reinterpret_cast<float4*>(c + row * ldc + col) =
        make_float4(v[0], v[1], v[2], v[3]);
  };
  if (AT)
    mm4_tiles<4, true>(a, lda, b, ldb, m, n4, k4, store);
  else
    mm4_tiles<kTileRows, false>(a, lda, b, ldb, m, n4, k4, store);
  __syncthreads();
}

// Newton-Schulz second half in the padded layout: Y' = Y W and
// Z' = (W Z) zscale, both products in one round of tiles.
template <int TM>
__device__ void ns_yz4(float* __restrict__ yy2, float* __restrict__ zz2,
                       const float* yy, const float* w, const float* zz,
                       int rp, float zscale) {
  const int nt = rp >> 2, mt = cdiv(rp, TM);
  const int tiles = mt * nt;
  for (int t = threadIdx.x; t < 2 * tiles; t += blockDim.x) {
    const bool z_side = t >= tiles;
    const int tt = z_side ? t - tiles : t;
    const int ti = tt / nt, tj = tt - ti * nt;
    int rows[TM];
    tile_rows<TM, false>(rows, ti, mt, rp);
    float acc[TM][4];
    if (z_side)
      tile_dot4<TM, false>(acc, w, rp, zz, rp, rp, rows, 4 * tj);
    else
      tile_dot4<TM, false>(acc, yy, rp, w, rp, rp, rows, 4 * tj);
    float* out = z_side ? zz2 : yy2;
    const float s = z_side ? zscale : 1.f;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = ti + mt * i;
      if (row < rp)
        *reinterpret_cast<float4*>(out + row * rp + 4 * tj) =
            make_float4(acc[i][0] * s, acc[i][1] * s, acc[i][2] * s,
                        acc[i][3] * s);
    }
  }
}

// ns_inv_sqrt in the padded layout: S [r, r] in an rp x rp (rp = round4(r))
// zero-padded matrix at ns[0]; ns holds 5 such matrices. The result is
// zero-padded too.
__device__ float* ns_inv_sqrt4(float* ns, int r, int rp) {
  const int rr = rp * rp;
  float* s = ns;  // S, later reused as W
  float* yy = ns + rr;
  float* zz = ns + 2 * rr;
  float* yy2 = ns + 3 * rr;
  float* zz2 = ns + 4 * rr;
  float c = 1e-30f;
  for (int d = 0; d < r; ++d) c += s[d * rp + d];
  for (int idx = threadIdx.x; idx < rr; idx += blockDim.x) {
    const int row = idx / rp, col = idx - row * rp;
    const bool diag = row == col && row < r;
    yy[idx] = s[idx] / c + (diag ? 1e-6f : 0.f);  // T = S/c + ridge (pads 0)
    zz[idx] = diag ? 1.f : 0.f;
  }
  __syncthreads();
  float* w = s;
  const float scale = rsqrtf(c);
  for (int t = 0; t < kNsIters; ++t) {
    // W = 0.5 (3 I - Z Y), with I the identity of the first r indices
    const auto epi_w = [&](int row, int col, const float* v) {
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[j] = 0.5f * ((row == col + j && row < r ? 3.f : 0.f) - v[j]);
      *reinterpret_cast<float4*>(w + row * rp + col) =
          make_float4(o[0], o[1], o[2], o[3]);
    };
    mm4_tiles<kTileRows, false>(zz, rp, yy, rp, rp, rp, rp, epi_w);
    __syncthreads();
    const float zscale = t == kNsIters - 1 ? scale : 1.f;
    ns_yz4<kTileRows>(yy2, zz2, yy, w, zz, rp, zscale);
    __syncthreads();
    float* tmp = yy; yy = yy2; yy2 = tmp;
    tmp = zz; zz = zz2; zz2 = tmp;
  }
  return zz;
}

// Below this padded rank the scalar tiles run the padded products: with
// few outputs, 4 columns per thread leave too few threads and long chains.
// -DORTH_VEC_MIN_RP moves it (tools/torch_kernel_ab.py measures the choice).
#ifndef ORTH_VEC_MIN_RP
#define ORTH_VEC_MIN_RP 12
#endif
constexpr int kVecMinRp = ORTH_VEC_MIN_RP;

// Y^T Y, then its inverse square root, in the padded layout (y [k4, rp]).
__device__ float* gram_inv_sqrt4(const float* y, float* ns, int r, int rp,
                                 int k4) {
  if (rp < kVecMinRp) {
    matmul(ns, rp, y, 1, rp, y, rp, 1, rp, rp, k4, false);
    return ns_inv_sqrt(ns, r, rp);
  }
  matmul4<true>(ns, rp, y, rp, y, rp, rp, rp, k4);
  return ns_inv_sqrt4(ns, r, rp);
}

// orth_iter in the padded layout: G [mp, mp], Q and y [mp, rp], ns 5 rp x rp,
// all zero-padded (mp = round4(n), rp = round4(r)).
__device__ void orth_iter4(const float* g, float* q, int mp, int r, int rp,
                           int iters, float* y, float* ns) {
  const bool vec = rp >= kVecMinRp;
  for (int it = 0; it < iters; ++it) {
    if (vec)  // Y = G Q
      matmul4<false>(y, rp, g, mp, q, rp, mp, rp, mp);
    else
      matmul(y, rp, g, mp, 1, q, rp, 1, mp, rp, mp, false);
    const float* z = gram_inv_sqrt4(y, ns, r, rp, mp);  // (Y^T Y)^{-1/2}
    if (vec)  // Q = Y Z
      matmul4<false>(q, rp, y, rp, z, rp, mp, rp, rp);
    else
      matmul(q, rp, y, rp, 1, z, rp, 1, mp, rp, rp, false);
  }
}

}  // namespace
