// cp.async copies from device memory into shared memory, and the Gram
// streamed through them, shared by the port's Z-step kernels (subspace.cu,
// tucker2_factors.cu). Include after orth_iter.cuh (cdiv, ld4, f4). A copy
// lands only after the issuing thread's cp_async_wait and the block's next
// barrier; every __device__ function here is called by all threads of a
// block, and the copy helpers issue copies without waiting for them.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxSmemFloats = 232448 / 4;  // a block's dynamic shared memory

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int up4(int x) { return (x + 3) & ~3; }

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies n contiguous floats (16 bytes at a time where both ends allow).
__device__ void copy_contiguous(float* dst, const float* src, int n) {
  const bool vec = ((reinterpret_cast<uintptr_t>(dst) |
                     reinterpret_cast<uintptr_t>(src)) & 15) == 0 && n % 4 == 0;
  if (vec) {
    for (int i = 4 * threadIdx.x; i < n; i += 4 * blockDim.x)
      cp_async16(dst + i, src + i);
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) cp_async4(dst + i, src + i);
  }
}

// Copies rows [r0, r0 + n) of a row-major [*, w] matrix to dst with row
// stride ld >= w (the pads [w, ld) of each row are left alone).
__device__ void copy_rows(float* dst, int ld, const float* src, int w, int r0,
                          int n) {
  if (ld == w) {
    copy_contiguous(dst, src + r0 * w, n * w);
    return;
  }
  for (int idx = threadIdx.x; idx < n * w; idx += blockDim.x) {
    const int row = idx / w, col = idx - row * w;
    cp_async4(dst + row * ld + col, src + (r0 + row) * w + col);
  }
}

// The Gram's chunks hold the long side's index p major: chunk[p * ldc + i]
// for i < m. Tall, that is t's own rows. Wide, it is a transpose: a warp
// copies 8 consecutive columns of 4 rows (32-byte pieces of device memory)
// into 4 x 8 distinct banks when ldc = 4 (mod 8).
__device__ void load_gram_chunk(float* dst, int ldc, const float* t, bool wide,
                                int m, int cols, int len, int kc, int c) {
  const int c0 = c * kc;
  const int kk = min(kc, len - c0);
  if (!wide) {
    copy_rows(dst, ldc, t, m, c0, kk);
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int dp = lane & 7, di = lane >> 3;
  const int kp = cdiv(kk, 8);
  const int pieces = cdiv(m, 4) * kp;
  for (int piece = warp; piece < pieces; piece += warps) {
    const int i = (piece / kp) * 4 + di, p = (piece % kp) * 8 + dp;
    if (i < m && p < kk) cp_async4(dst + p * ldc + i, t + i * cols + c0 + p);
  }
}

// ---------------------------------------------------------------------------
// Gram micro-tiles. A thread of a 16 x 16 grid holds a G x G micro-tile of
// the 16G x 16G block (bi, bj) of an m x m Gram, its rows and columns
// interleaved (b 16G + t + 16 i) or, with V4, contiguous (b 64 + 4 t + i,
// read as float4).

template <int G, bool V4>
__device__ __forceinline__ int tile_at(int b, int t, int i) {
  return V4 ? b * 64 + 4 * t + i : b * 16 * G + t + 16 * i;
}

template <int G>
__device__ __forceinline__ void zero_tile(float (&a)[G][G]) {
#pragma unroll
  for (int i = 0; i < G; ++i)
#pragma unroll
    for (int j = 0; j < G; ++j) a[i][j] = 0.f;
}

// The running total in k order: the first k's sum, then total + sum.
template <int G>
__device__ __forceinline__ void add_k(float (&tot)[G][G],
                                      const float (&acc)[G][G], bool first) {
#pragma unroll
  for (int i = 0; i < G; ++i)
#pragma unroll
    for (int j = 0; j < G; ++j) tot[i][j] = first ? acc[i][j] : tot[i][j] + acc[i][j];
}

// Writes the tile to g [mo, mo] (zero past m), mirrored off the diagonal
// blocks (the Gram is symmetric bit for bit: fmaf(a, b, c) == fmaf(b, a, c)).
template <int G, bool V4>
__device__ __forceinline__ void store_tile(float* g, int mo, int m,
                                           const float (&tot)[G][G], int bi,
                                           int bj) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < G; ++i)
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int row = tile_at<G, V4>(bi, ty, i), col = tile_at<G, V4>(bj, tx, j);
      if (row < mo && col < mo) {
        const float v = row < m && col < m ? tot[i][j] : 0.f;
        g[row * mo + col] = v;
        if (bi != bj) g[col * mo + row] = v;
      }
    }
}

// acc += sum over p < len of s[p][ra] s[p][rb] (row stride ld), p in order.
template <int G, bool V4>
__device__ __forceinline__ void tn_terms(float (&acc)[G][G], const float* s,
                                         int ld, int len, const int (&ra)[G],
                                         const int (&rb)[G]) {
#pragma unroll 4
  for (int p = 0; p < len; ++p, s += ld) {
    float av[G], bv[G];
    if (V4) {
      const float4 a4 = ld4(s + ra[0]), b4 = ld4(s + rb[0]);
#pragma unroll
      for (int i = 0; i < G; ++i) {
        av[i] = f4(a4, i);
        bv[i] = f4(b4, i);
      }
    } else {
#pragma unroll
      for (int i = 0; i < G; ++i) {
        av[i] = s[ra[i]];
        bv[i] = s[rb[i]];
      }
    }
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int j = 0; j < G; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// Block (bi, bj) of g [mo, mo] = sum over k < kn of the Grams of the
// smaller side of t_k [rows, cols] (device memory, t_k at t + k kstride):
// wide, t_k t_k^T over the len = cols columns; tall, t_k^T t_k over the len
// = rows rows. Each t_k streams along len in chunks of kc (row stride ldc)
// through two cp.async buffers of `stage` floats at buf, the next chunk's
// copy overlapping this chunk's FMAs. Each k's terms are summed in p order
// in registers and added to the running total in k order.
template <int G, bool V4>
__device__ void gram_block(float* __restrict__ g, int mo, const float* t,
                           int kstride, int kn, bool wide, int m, int cols,
                           int len, int kc, int ldc, float* buf, int stage,
                           int bi, int bj) {
  const int nc = cdiv(len, kc), chunks = kn * nc;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  int ra[G], rb[G];  // rows and columns, clamped inside the chunk
#pragma unroll
  for (int i = 0; i < G; ++i) {
    ra[i] = V4 ? min(bi * 64 + 4 * ty, ldc - 4) + i
               : min(tile_at<G, V4>(bi, ty, i), m - 1);
    rb[i] = V4 ? min(bj * 64 + 4 * tx, ldc - 4) + i
               : min(tile_at<G, V4>(bj, tx, i), m - 1);
  }
  float tot[G][G], acc[G][G];
  load_gram_chunk(buf, ldc, t, wide, m, cols, len, kc, 0);
  cp_async_commit();
  for (int kk = 0; kk < kn; ++kk) {
    zero_tile<G>(acc);
    for (int c = 0; c < nc; ++c) {
      const int s = kk * nc + c;
      if (s + 1 < chunks) {
        const int kq = (s + 1) / nc;
        load_gram_chunk(buf + ((s + 1) & 1) * stage, ldc, t + kq * kstride,
                        wide, m, cols, len, kc, s + 1 - kq * nc);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      tn_terms<G, V4>(acc, buf + (s & 1) * stage, ldc, min(kc, len - c * kc),
                      ra, rb);
      __syncthreads();  // the buffer is refilled by the copy after next
    }
    add_k<G>(tot, acc, kk == 0);
  }
  store_tile<G, V4>(g, mo, m, tot, bi, bj);
}


// g [mo, mo] (zero past m) = the sum over k < kn of the Grams that
// gram_block sums, streamed in chunks of stage / ldc. The micro-tile is 1x1
// up to m = 16, 2x2 up to 32, else 4x4 on 64 x 64 blocks (read as float4
// with v4, ldc a multiple of 4). Ends with a barrier.
__device__ void gram_streamed(float* __restrict__ g, int mo, const float* t,
                              int kstride, int kn, bool wide, int m, int cols,
                              int len, int ldc, float* buf, int stage,
                              bool v4) {
  const int kc = stage / ldc;  // chunk length, >= 1
  if (m <= 16) {
    gram_block<1, false>(g, mo, t, kstride, kn, wide, m, cols, len, kc, ldc,
                         buf, stage, 0, 0);
  } else if (m <= 32) {
    gram_block<2, false>(g, mo, t, kstride, kn, wide, m, cols, len, kc, ldc,
                         buf, stage, 0, 0);
  } else {
    const int nb = cdiv(mo, 64);
    for (int bi = 0; bi < nb; ++bi)  // symmetric: upper blocks, mirrored
      for (int bj = bi; bj < nb; ++bj) {
        if (v4)
          gram_block<4, true>(g, mo, t, kstride, kn, wide, m, cols, len, kc,
                              ldc, buf, stage, bi, bj);
        else
          gram_block<4, false>(g, mo, t, kstride, kn, wide, m, cols, len, kc,
                               ldc, buf, stage, bi, bj);
      }
  }
  __syncthreads();
}

}  // namespace
