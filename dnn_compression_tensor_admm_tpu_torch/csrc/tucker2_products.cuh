// The Tucker-2 kernel's products on resident operands: the Grams of a
// stack of k matrices summed in one phase, the batched HOOI products and
// the padded orthogonal iteration. Shared by the block plans
// (tucker2_factors.cu) and the workspace plan (tucker2_factors_ws.cu),
// which are compiled as two libraries: in one translation unit the second
// kernel's calls changed how nvcc compiled these into the first (221
// registers instead of 205, 18% slower on the H100; PERF.md). Include it
// inside the anonymous namespace, after orth_iter.cuh and stage.cuh, so
// that tucker2_factors.cu compiles token for token as before; every
// function here is called by all threads of a block.

#pragma once

// ---------------------------------------------------------------------------
// Grams of resident operands, summed over k in one phase (micro-tiles and
// their helpers in stage.cuh).

// tot = the total so far, read back from g (for a group of k after the first).
template <int G, bool V4>
__device__ __forceinline__ void load_tile(float (&tot)[G][G], const float* g,
                                          int ldg, int m, int bi, int bj) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < G; ++i)
#pragma unroll
    for (int j = 0; j < G; ++j)
      tot[i][j] = g[imin(tile_at<G, V4>(bi, ty, i), m - 1) * ldg +
                    imin(tile_at<G, V4>(bj, tx, j), m - 1)];
}

// g[mo, mo] = (accumulate ? g : 0) + sum over k < kn of A_k^T A_k, A_k
// [len, m] at a + k kstride (row stride lda, a multiple of 4 with V4).
template <int G, bool V4>
__device__ void gram_tn(float* __restrict__ g, int mo, const float* a, int lda,
                        int kstride, int kn, int m, int len, bool accumulate) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nb = cdiv(m, 16 * G);
  for (int bi = 0; bi < nb; ++bi)
    for (int bj = bi; bj < nb; ++bj) {
      int ra[G], rb[G];
#pragma unroll
      for (int i = 0; i < G; ++i) {
        ra[i] = V4 ? imin(bi * 64 + 4 * ty, lda - 4) + i
                   : imin(tile_at<G, V4>(bi, ty, i), m - 1);
        rb[i] = V4 ? imin(bj * 64 + 4 * tx, lda - 4) + i
                   : imin(tile_at<G, V4>(bj, tx, i), m - 1);
      }
      float tot[G][G], acc[G][G];
      if (accumulate) load_tile<G, V4>(tot, g, mo, m, bi, bj);
      for (int kk = 0; kk < kn; ++kk) {
        zero_tile<G>(acc);
        tn_terms<G, V4>(acc, a + kk * kstride, lda, len, ra, rb);
        add_k<G>(tot, acc, kk == 0 && !accumulate);
      }
      store_tile<G, V4>(g, mo, m, tot, bi, bj);
    }
  __syncthreads();
}

// g[mo, mo] = (accumulate ? g : 0) + sum over k < kn of A_k A_k^T, A_k
// [m, len4] at a + k kstride (row stride lda, a multiple of 4; zero past the
// logical length), read as float4 along the summed index.
template <int G>
__device__ void gram_nt(float* __restrict__ g, int mo, const float* a, int lda,
                        int kstride, int kn, int m, int len4, bool accumulate) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nb = cdiv(m, 16 * G);
  for (int bi = 0; bi < nb; ++bi)
    for (int bj = bi; bj < nb; ++bj) {
      const float* ra[G];
      const float* rb[G];
#pragma unroll
      for (int i = 0; i < G; ++i) {
        ra[i] = a + imin(tile_at<G, false>(bi, ty, i), m - 1) * lda;
        rb[i] = a + imin(tile_at<G, false>(bj, tx, i), m - 1) * lda;
      }
      float tot[G][G], acc[G][G];
      if (accumulate) load_tile<G, false>(tot, g, mo, m, bi, bj);
      for (int kk = 0; kk < kn; ++kk) {
        const int off = kk * kstride;
        zero_tile<G>(acc);
        for (int p = 0; p < len4; p += 4) {
          float4 av[G], bv[G];
#pragma unroll
          for (int i = 0; i < G; ++i) {
            av[i] = ld4(ra[i] + off + p);
            bv[i] = ld4(rb[i] + off + p);
          }
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int i = 0; i < G; ++i)
#pragma unroll
              for (int j = 0; j < G; ++j)
                acc[i][j] = fmaf(f4(av[i], q), f4(bv[j], q), acc[i][j]);
        }
        add_k<G>(tot, acc, kk == 0 && !accumulate);
      }
      store_tile<G, false>(g, mo, m, tot, bi, bj);
    }
  __syncthreads();
}

// The micro-tile: 1x1 up to m = 16, 2x2 up to 32, else 4x4 on 64 x 64 blocks.
__device__ void gram_nt_any(float* g, int mo, const float* a, int lda,
                            int kstride, int kn, int m, int len4,
                            bool accumulate) {
  if (m <= 16)
    gram_nt<1>(g, mo, a, lda, kstride, kn, m, len4, accumulate);
  else if (m <= 32)
    gram_nt<2>(g, mo, a, lda, kstride, kn, m, len4, accumulate);
  else
    gram_nt<4>(g, mo, a, lda, kstride, kn, m, len4, accumulate);
}

__device__ void gram_tn_any(float* g, int mo, const float* a, int lda,
                            int kstride, int kn, int m, int len,
                            bool accumulate) {
  if (m <= 16)
    gram_tn<1, false>(g, mo, a, lda, kstride, kn, m, len, accumulate);
  else if (m <= 32)
    gram_tn<2, false>(g, mo, a, lda, kstride, kn, m, len, accumulate);
  else
    gram_tn<4, true>(g, mo, a, lda, kstride, kn, m, len, accumulate);
}

// c_b [m, n4] = a_b b_b for b < batch, one round of padded tiles for all
// (as matmul4 in orth_iter.cuh); operand b lies a_bs, b_bs, c_bs floats
// after operand b - 1.
template <bool AT>
__device__ void matmul4_batch(float* __restrict__ c, int ldc, int c_bs,
                              const float* a, int lda, int a_bs,
                              const float* b, int ldb, int b_bs, int m, int n4,
                              int k4, int batch) {
  constexpr int TM = AT ? 4 : kTileRows;
  const int nt = n4 >> 2;
  const int mt = AT ? m >> 2 : cdiv(m, TM);
  const int tiles = mt * nt;
  for (int t = threadIdx.x; t < batch * tiles; t += blockDim.x) {
    const int bb = t / tiles, tt = t - bb * tiles;
    const int ti = tt / nt, tj = tt - ti * nt;
    int rows[TM];
    tile_rows<TM, AT>(rows, ti, mt, m);
    float acc[TM][4];
    tile_dot4<TM, AT>(acc, a + bb * a_bs, lda, b + bb * b_bs, ldb, k4, rows,
                      4 * tj);
    float* cb = c + bb * c_bs;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = tile_row<TM, AT>(ti, mt, i);
      if (row < m)
        *reinterpret_cast<float4*>(cb + row * ldc + 4 * tj) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
  __syncthreads();
}

// One compiled copy of each iteration for all its call sites (an inlined
// copy per site multiplies the build's template instances).
__device__ __noinline__ void orth_iter_padded(const float* g, float* q, int mp,
                                              int r, int rp, int iters,
                                              float* y, float* ns) {
  orth_iter4(g, q, mp, r, rp, iters, y, ns);
}
