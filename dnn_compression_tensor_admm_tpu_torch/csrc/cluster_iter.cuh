// The cluster machinery of the workspace plans (tucker2_factors_ws.cu,
// subspace_ws.cu): matrices split over a thread-block cluster by rows in
// groups of 4, the products that stage a split right operand from its
// owners, the Gram streamed from device memory into a block's rows, and
// one mode's orthogonal iteration over the cluster (Newton-Schulz by
// pushes where its matrices fit). Include it inside the anonymous
// namespace, after orth_iter.cuh, stage.cuh and cluster.cuh, with
// WS_SPAN(slot) defined (empty, or a profile span of the includer's own),
// so that each kernel keeps its own profile slots: 1 the Gram, 2 Y = G Q,
// 3 S = Y^T Y with its reduction and trace, 4 Newton-Schulz's set-up,
// 5 its products, 6 the barrier before its pushes, 7 its pushes and
// barrier, 8 Q = Y Z. Every function here is called by all threads of
// every block of the cluster.

#pragma once

constexpr int kMaxCluster = 8;  // blocks per layer at most (portable)

// Rows of an n-row matrix (n a multiple of 4) owned by block q of c:
// [split_lo(n, q, c), split_lo(n, q + 1, c)), groups of 4 spread evenly.
__host__ __device__ inline int split_lo(int n, int q, int c) {
  return 4 * ((n / 4) * q / c);
}

// The most rows of an n-row matrix one block owns.
__host__ __device__ inline int own_cap(int n, int c) {
  return 4 * ((n / 4 + c - 1) / c);
}

// ---------------------------------------------------------------------------
// Matrices split over the cluster by rows.

struct Split {
  float* p;  // shared memory: this block's rows, at the same offset in every
             // block of the cluster; slab: the whole matrix
  int ld;    // row stride
  int n;     // rows, a multiple of 4
  bool ws;   // in the slab
};

// Block q's first row (its rows follow at stride ld).
__device__ __forceinline__ const float* rows_of(const Split& s, int q, int c) {
  return s.ws ? s.p + static_cast<size_t>(split_lo(s.n, q, c)) * s.ld
              : cluster_map(s.p, q);
}

__device__ __forceinline__ float* own_rows(const Split& s, int rank, int c) {
  return s.ws ? s.p + static_cast<size_t>(split_lo(s.n, rank, c)) * s.ld
              : s.p;
}

// c[m, n4] (row stride ldc) = (first ? 0 : c) + A[m, kc] B[kc, n4]: one
// chunk of the summed index, B (row stride ldb, rows 16-byte aligned) read
// as float4 along its columns. AM says how A(row, p) is read:
// 0: a[row * a_rs + p * a_cs], scalar; 1: a[row * a_rs + p], float4 along
// p; 2: a[p * a_cs + row], float4 over 4 contiguous rows (m a multiple of
// 4). A thread holds TR interleaved rows x 4 columns (AM 0 and 1) or 4
// contiguous rows (AM 2). Each output continues one fmaf chain over the
// chunks in p order, as tile_dot4 in orth_iter.cuh sums it. With c2, also
// c2 = A b2 (ldb too) in the same round of tiles, as ns_yz4 pairs them.
template <int AM, int TR = kTileRows>
__device__ void mm_chunk(float* c, int ldc, const float* a, int a_rs,
                         int a_cs, const float* b, int ldb, int m, int n4,
                         int kc, bool first, float* c2 = nullptr,
                         const float* b2 = nullptr) {
  constexpr bool kRows4 = AM == 2;
  constexpr int TM = kRows4 ? 4 : TR;
  const int nt = n4 >> 2;
  const int mt = kRows4 ? m >> 2 : cdiv(m, TM);
  const int tiles = mt * nt;
  for (int tt = threadIdx.x; tt < (c2 ? 2 : 1) * tiles; tt += blockDim.x) {
    const bool second = tt >= tiles;  // c2 = A b2, in the same round
    const int t = second ? tt - tiles : tt;
    const float* bb = second ? b2 : b;
    float* cc = second ? c2 : c;
    const int ti = t / nt, tj = t - ti * nt, c0 = 4 * tj;
    int rows[TM];
    tile_rows<TM, kRows4>(rows, ti, mt, m);
    float acc[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = tile_row<TM, kRows4>(ti, mt, i);
      const float4 v = first || row >= m ? make_float4(0.f, 0.f, 0.f, 0.f)
                                         : ld4(cc + row * ldc + c0);
      acc[i][0] = v.x;
      acc[i][1] = v.y;
      acc[i][2] = v.z;
      acc[i][3] = v.w;
    }
    int p = 0;
    if (AM == 1) {
      for (; p + 4 <= kc; p += 4) {
        float4 bv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) bv[q] = ld4(bb + (p + q) * ldb + c0);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float4 av = ld4(a + rows[i] * a_rs + p);
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(f4(av, q), f4(bv[q], j), acc[i][j]);
        }
      }
    }
    for (; p < kc; ++p) {
      const float4 bv = ld4(bb + p * ldb + c0);
      float av[TM];
      if (kRows4) {
        const float4 a4 = ld4(a + p * a_cs + rows[0]);
#pragma unroll
        for (int i = 0; i < TM; ++i) av[i] = f4(a4, i);
      } else {
#pragma unroll
        for (int i = 0; i < TM; ++i) av[i] = a[rows[i] * a_rs + p * a_cs];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(av[i], f4(bv, j), acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = tile_row<TM, kRows4>(ti, mt, i);
      if (row < m)
        *reinterpret_cast<float4*>(cc + row * ldc + c0) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

// stage[j * w4 + col] = B(r0 + j, col) for j < nr, col < w4: rows of a split
// matrix, from the blocks that hold them or from the slab. From the slab
// they are cp.async copies, which the caller commits and waits for. From
// the blocks, a warp copies whole rows, a lane a float4 of each, U rows'
// loads issued before their stores so that the remote loads overlap; a
// row's owner is picked from the blocks' first rows without a division.
// The caller's next barrier lands them.
__device__ void stage_rows(float* stage, int w4, const Split& b, int r0,
                           int nr, int c) {
  constexpr int U = 8;
  if (b.ws) {
    const int per = w4 >> 2;
    for (int idx = threadIdx.x; idx < nr * per; idx += blockDim.x) {
      const int j = idx / per, col = 4 * (idx - j * per);
      cp_async16(stage + j * w4 + col,
                 b.p + static_cast<size_t>(r0 + j) * b.ld + col);
    }
    return;
  }
  int first[kMaxCluster];  // block q's first row (n past the cluster)
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q)
    first[q] = q < c ? split_lo(b.n, q, c) : b.n;
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int per = w4 >> 2;
  for (int c4 = lane; c4 < per; c4 += 32) {
    const int col = 4 * c4;
    for (int j0 = threadIdx.x >> 5; j0 < nr; j0 += U * warps) {
      float4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u * warps, row = r0 + j;
        if (j < nr) {
          int q = 0, lo = 0;
#pragma unroll
          for (int k = 1; k < kMaxCluster; ++k)
            if (row >= first[k]) {
              q = k;
              lo = first[k];
            }
          v[u] = ld4(cluster_map(b.p, q) + (row - lo) * b.ld + col);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u * warps;
        if (j < nr) *reinterpret_cast<float4*>(stage + j * w4 + col) = v[u];
      }
    }
  }
}

// c[m, n4] = A[m, klen] B[klen, n4] for this block's m rows, B split over
// the cluster: chunks of B's rows through the two stage buffers (`stage`
// floats each), the next chunk's copy issued before this chunk's products
// (by cp.async, overlapping them, where B lies in the slab). With a_dev
// (AM 1, A in device memory, rows 16-byte aligned), each chunk's columns of
// A come along by cp.async, so A is read from L2 once. Ends with a barrier.
template <int AM>
__device__ void split_mm(float* c, int ldc, const float* a, int a_rs,
                         int a_cs, const Split& b, int klen, int m, int n4,
                         float* buf, int stage, int csize,
                         bool a_dev = false) {
  a_dev = a_dev && AM == 1;
  int kc = stage / (n4 + (a_dev ? m : 0));
  if (kc >= 4) kc &= ~3;
  a_dev = a_dev && kc >= 4;
  if (!a_dev) kc = stage / n4;
  if (kc >= 4) kc &= ~3;
  const int nch = cdiv(klen, kc);
  const bool async = a_dev || b.ws;
  // 4-row tiles where they still give every thread one (Y = G Q)
  const bool tall = AM == 1 && m * n4 >= 64 * static_cast<int>(blockDim.x);
  const auto fill = [&](int ch) {
    const int r0 = ch * kc, len = imin(kc, klen - r0);
    float* bc = buf + (ch & 1) * stage;
    stage_rows(bc, n4, b, r0, len, csize);
    if (a_dev) {  // A's columns [r0, r0 + len): len4 floats a row
      float* ac = bc + kc * n4;
      const int per = cdiv(len, 4);
      for (int idx = threadIdx.x; idx < m * per; idx += blockDim.x) {
        const int row = idx / per, col = 4 * (idx - row * per);
        cp_async16(ac + row * kc + col, a + row * a_rs + r0 + col);
      }
    }
    if (async) cp_async_commit();
  };
  fill(0);
  if (async) cp_async_wait<0>();
  __syncthreads();
  for (int ch = 0; ch < nch; ++ch) {
    const int r0 = ch * kc;
    if (ch + 1 < nch) fill(ch + 1);
    const float* bc = buf + (ch & 1) * stage;
    const int len = imin(kc, klen - r0);
    if (a_dev && tall)
      mm_chunk<1, 4>(c, ldc, bc + kc * n4, kc, 1, bc, n4, m, n4, len, ch == 0);
    else if (a_dev)
      mm_chunk<1>(c, ldc, bc + kc * n4, kc, 1, bc, n4, m, n4, len, ch == 0);
    else if (AM == 1 && (kc & 3))  // chunks off a float4 boundary of A's rows
      mm_chunk<0>(c, ldc, a + r0, a_rs, 1, bc, n4, m, n4, len, ch == 0);
    else if (tall)
      mm_chunk<1, 4>(c, ldc, a + r0, a_rs, 1, bc, n4, m, n4, len, ch == 0);
    else
      mm_chunk<AM>(c, ldc, a + r0 * a_cs, a_rs, a_cs, bc, n4, m, n4, len,
                   ch == 0);
    if (async && ch + 1 < nch) cp_async_wait<0>();
    __syncthreads();
  }
}

// Zeroes rows [m, ...) (global row lo + row) and columns [m, mo) of this
// block's rows of an mo x mo Gram; ends with a barrier.
__device__ void zero_pads(float* g, int lo, int rows, int mo, int m) {
  for (int idx = threadIdx.x; idx < rows * mo; idx += blockDim.x) {
    const int row = idx / mo, col = idx - row * mo;
    if (lo + row >= m || col >= m) g[idx] = 0.f;
  }
  __syncthreads();
}

// This block's rows [lo, lo + rows) of the mo x mo Gram sum_k of X_k's
// smaller-side Grams (load_gram_chunk's chunks: chunk[p * ldc + row]),
// X_k streamed through the stage buffers by cp.async; zero past m.
__device__ __noinline__ void gram_x(float* g, int lo, int rows, int mo,
                                    int m, const float* x, int kstride,
                                    int k, bool wide, int cols, int len,
                                    int ldc, float* buf, int stage) {
  WS_SPAN(1);
  const int kc = stage / ldc;  // >= 1 (the gate)
  const int nc = cdiv(len, kc), chunks = k * nc;
  load_gram_chunk(buf, ldc, x, wide, m, cols, len, kc, 0);
  cp_async_commit();
  for (int s = 0; s < chunks; ++s) {
    if (s + 1 < chunks) {
      const int kq = (s + 1) / nc;
      load_gram_chunk(buf + ((s + 1) & 1) * stage, ldc, x + kq * kstride,
                      wide, m, cols, len, kc, s + 1 - kq * nc);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* chunk = buf + (s & 1) * stage;
    const int ch = s % nc;
    mm_chunk<2>(g, mo, chunk + lo, 1, ldc, chunk, ldc, rows, mo,
                imin(kc, len - ch * kc), s == 0);
    __syncthreads();  // the buffer is refilled by the copy after next
  }
  zero_pads(g, lo, rows, mo, m);
}

// q[n, ld] = eye(n, r) on this block's rows [lo, lo + rows).
__device__ void set_eye_rows(float* q, int lo, int rows, int r, int ld) {
  for (int idx = threadIdx.x; idx < rows * ld; idx += blockDim.x) {
    const int row = lo + idx / ld, col = idx % ld;
    q[idx] = (row == col && col < r) ? 1.f : 0.f;
  }
  __syncthreads();
}

// tr S + 1e-30, S = the sum of the cluster's partial Grams in block order
// (block q's at part(q)): each diagonal entry summed as the reduction sums
// it, so bit for bit the reduced S's, then summed in index order as
// ns_inv_sqrt4 sums it, through diag (rp floats of shared memory).
template <class Part>
__device__ float trace_of_partials(Part part, int r, int rp, float* diag,
                                   int c, bool ws) {
  for (int d = threadIdx.x; d < r; d += blockDim.x) {
    float acc = 0.f;
    for (int b = 0; b < c; ++b) {
      const float* e = part(b) + static_cast<size_t>(d) * rp + d;
      const float v = ws ? ld_cg(e) : *e;
      acc = b == 0 ? v : acc + v;
    }
    diag[d] = acc;
  }
  __syncthreads();
  float t = 1e-30f;
  for (int d = 0; d < r; ++d) t += diag[d];
  return t;
}

// Stores this block's rows [lo, lo + nr) of an rp-column matrix (src, row
// stride rp) into the same rows of dst in every block of the cluster.
__device__ void push_rows(float* dst, const float* src, int lo, int nr, int rp,
                          int c) {
  const int per = rp >> 2;
  for (int idx = threadIdx.x; idx < nr * per; idx += blockDim.x) {
    const int j = idx / per, col = 4 * (idx - j * per);
    const float4 v = ld4(src + j * rp + col);
    for (int q = 0; q < c; ++q) st4_remote(dst + (lo + j) * rp + col, q, v);
  }
}

// S^{-1/2} for S [r, r] (zero-padded to rp) split over the cluster in
// ns[0], tr S given: ns_inv_sqrt4's Newton-Schulz iteration over this
// block's rows. A step is W = 0.5 (3 I - Z Y), Y' = W Y and Z' = (W Z)
// zscale: W, Y and Z are polynomials in S and commute, so Y' = W Y is
// ns_inv_sqrt4's Y W, and W never leaves this block. Where two rp x rp
// matrices fit a stage buffer, every block holds all of Y and Z in its
// scratch (two copies of each where four fit) and pushes its new rows into
// every block's copy: one cluster barrier a step with two copies, two with
// one (all blocks have read Y and Z before any is overwritten). Else each
// product stages its right operand from its owners (split_mm). Returns a
// pointer to all of the result in this block's scratch (push) or, with
// *split, the split matrix that holds it.
__device__ const float* ns_split(const Split* ns, float tr, int r, int rp,
                                 int rank, int c, float* buf, int stage,
                                 Split* split) {
  const int lo = split_lo(rp, rank, c), nr = split_lo(rp, rank + 1, c) - lo;
  const int rr = rp * rp;
  const bool push = rr <= stage, dbl = 2 * rr <= stage;
  Split yy = ns[1], zz = ns[2], yy2 = ns[3], zz2 = ns[4];
  float* wo = own_rows(ns[0], rank, c);  // S, then this block's rows of W
  {
    WS_SPAN(4);
    float* y0 = own_rows(yy, rank, c);
    float* z0 = own_rows(zz, rank, c);
    for (int idx = threadIdx.x; idx < nr * rp; idx += blockDim.x) {
      const int row = lo + idx / rp, col = idx % rp;
      const bool diag = row == col && row < r;
      y0[idx] = wo[idx] / tr + (diag ? 1e-6f : 0.f);  // T = S/c + ridge
      z0[idx] = diag ? 1.f : 0.f;
    }
    if (push) {  // every block has read the partial S and the diagonal
      cluster_sync();
      push_rows(buf, y0, lo, nr, rp, c);
      push_rows(buf + rr, z0, lo, nr, rp, c);
    }
    cluster_sync();
  }
  const float scale = rsqrtf(tr);
  float* y2 = own_rows(yy2, rank, c);
  float* z2 = own_rows(zz2, rank, c);
  for (int t = 0; t < kNsIters; ++t) {
    const float* yf = buf + (dbl && (t & 1) ? 2 * rr : 0);  // all of Y, Z
    float* next = buf + (dbl && !(t & 1) ? 2 * rr : 0);
    {
      WS_SPAN(5);
      if (push && nr * rp <= 4 * static_cast<int>(blockDim.x))
        // W = Z Y, rows of Z from this block's copy; 1-row tiles
        mm_chunk<1, 1>(wo, rp, yf + rr + lo * rp, rp, 1, yf, rp, nr, rp, rp,
                       true);
      else if (push)
        mm_chunk<1>(wo, rp, yf + rr + lo * rp, rp, 1, yf, rp, nr, rp, rp,
                    true);
      else
        split_mm<1>(wo, rp, own_rows(zz, rank, c), rp, 1, yy, rp, nr, rp, buf,
                    stage, c);
      __syncthreads();
      for (int idx = threadIdx.x; idx < nr * rp; idx += blockDim.x) {
        const int row = lo + idx / rp, col = idx % rp;
        wo[idx] = 0.5f * ((row == col && row < r ? 3.f : 0.f) - wo[idx]);
      }
      __syncthreads();
      if (push) {  // Y' = W Y and Z' = W Z in one round of tiles
        mm_chunk<1>(y2, rp, wo, rp, 1, yf, rp, nr, rp, rp, true, z2,
                    yf + rr);
        __syncthreads();
      } else {
        split_mm<1>(y2, rp, wo, rp, 1, yy, rp, nr, rp, buf, stage, c);
        split_mm<1>(z2, rp, wo, rp, 1, zz, rp, nr, rp, buf, stage, c);
      }
      if (t == kNsIters - 1)
        for (int idx = threadIdx.x; idx < nr * rp; idx += blockDim.x)
          z2[idx] *= scale;
      __syncthreads();
    }
    if (push && !dbl) {
      WS_SPAN(6);
      cluster_sync();  // every block has read Y and Z
    }
    {
      WS_SPAN(7);
      if (push) {
        push_rows(next, y2, lo, nr, rp, c);
        push_rows(next + rr, z2, lo, nr, rp, c);
      }
      cluster_sync();
    }
    if (!push) {
      Split tmp = yy;
      yy = yy2;
      yy2 = tmp;
      tmp = zz;
      zz = zz2;
      zz2 = tmp;
      y2 = own_rows(yy2, rank, c);
      z2 = own_rows(zz2, rank, c);
    }
  }
  *split = zz;
  return push ? buf + (dbl && (kNsIters & 1) ? 2 * rr : 0) + rr : nullptr;
}

// One mode's orthogonal iteration over the cluster: Q [mp, rp] (split)
// <- orth(G Q) = Y (Y^T Y)^{-1/2}, `iters` times, as orth_iter4. g and y
// are this block's rows of G (row stride mp; g_dev: in device memory) and
// Y (row stride rp); sp the partial S (in the slab: block q's at sp + q rp
// rp), diag rp floats of shared memory beside it.
__device__ __noinline__ void orth_split(const float* g, bool g_dev,
                                        const Split& q, float* y,
                                        const Split* ns, float* sp,
                                        bool sp_ws, float* diag, int mp,
                                        int r, int rp, int iters, int rank,
                                        int c, float* buf, int stage) {
  const int lo = split_lo(mp, rank, c), m = split_lo(mp, rank + 1, c) - lo;
  const int rlo = split_lo(rp, rank, c), nr = split_lo(rp, rank + 1, c) - rlo;
  const size_t rr = static_cast<size_t>(rp) * rp;
  const auto part = [&](int b) -> const float* {
    return sp_ws ? sp + b * rr : cluster_map(sp, b);
  };
  float* spm = sp_ws ? sp + rank * rr : sp;
  for (int it = 0; it < iters; ++it) {
    {
      WS_SPAN(2);
      split_mm<1>(y, rp, g, mp, 1, q, mp, m, rp, buf, stage, c,
                  g_dev);  // Y = G Q
    }
    float tr;
    {
      WS_SPAN(3);
      mm_chunk<2>(spm, rp, y, 1, rp, y, rp, rp, rp, m, true);  // Y^T Y here
      cluster_sync();
      // this block's rows of S: the partials summed in block order
      float* s = own_rows(ns[0], rank, c);
      const int per = rp >> 2;
      for (int idx = threadIdx.x; idx < nr * per; idx += blockDim.x) {
        const int j = idx / per, col = 4 * (idx - j * per);
        const size_t e = static_cast<size_t>(rlo + j) * rp + col;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int b = 0; b < c; ++b) {
          const float4 v = sp_ws ? ld4_cg(part(b) + e) : ld4(part(b) + e);
          acc = b == 0 ? v
                       : make_float4(acc.x + v.x, acc.y + v.y, acc.z + v.z,
                                     acc.w + v.w);
        }
        *reinterpret_cast<float4*>(s + j * rp + col) = acc;
      }
      tr = trace_of_partials(part, r, rp, diag, c, sp_ws);
    }
    Split zs;
    const float* zf = ns_split(ns, tr, r, rp, rank, c, buf, stage, &zs);
    WS_SPAN(8);
    float* qo = own_rows(q, rank, c);
    if (zf) {  // Q = Y Z, all of Z here
      mm_chunk<1>(qo, rp, y, rp, 1, zf, rp, m, rp, rp, true);
      __syncthreads();
    } else {
      split_mm<1>(qo, rp, y, rp, 1, zs, rp, m, rp, buf, stage, c);
    }
    cluster_sync();
  }
}
