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
// Design: one thread-block cluster of C blocks per layer (grid L x C,
// C = 8 from 192 padded rows down, `ws_cluster`), so a 12-layer bucket
// runs on 96 SMs where one block per layer ran on 12. Each block owns
// row blocks, in groups of 4 rows spread evenly (`split_lo`), of every
// matrix of the iteration: the Gram, the factors, Y, the HOOI products and
// the Newton-Schulz matrices, and computes its own rows of each product.
// A right operand split over the cluster is staged chunk by chunk into the
// block's two stage buffers: from the blocks that own it (distributed
// shared memory, cluster.cuh) or by cp.async from the layer's slab, the
// next chunk's copy issued before this chunk's products (`split_mm`).
// S = Y^T Y is a partial Gram per block, summed over the cluster in block
// order, so runs repeat bit for bit. Newton-Schulz, where its matrices
// fit: every block holds all of Y and Z and pushes its new rows into every
// block's copy (remote stores, no round trip), and W stays in its block
// (`ns_split`); one cluster barrier a step. A cluster barrier separates
// every phase whose data another block reads. Each output sums its
// products in index order with one fmaf per term, as in the one-block
// plan; S's block order, the Grams' k order and Newton-Schulz's W Y for
// Y W (equal in exact arithmetic) move the last bits.
//
// What bounds it (tools/torch_ws_profile.py): at rp = 72 the Newton-Schulz
// products of 8 to 12 rows a block and the pushes and barrier of each step;
// at fc1's r = 128 also Y = G Q, 9.4 M FMA a block and step through 2 x 4
// register tiles.
//
// Memory: a block takes its rows of each region into its shared memory in
// the order the iteration reads them most (the Newton-Schulz matrices, the
// partial S, the Gram, Y, the factors, the HOOI products) while they fit
// beside two stage buffers of one row of X's Gram chunks at least and of
// an rp x rp matrix where two fit; a region that does not fit lies whole in
// a per-layer slab of device memory that the wrapper allocates (16-byte
// aligned), which every block of the cluster reads past L1 after a barrier.
// X stays in device memory: its Grams stream X_k through the stage buffers
// by cp.async (load_gram_chunk in stage.cuh), the HOOI products read it
// from L2. Products are plain FMA loops in float32, as in
// tucker2_factors.cu. It is a separate library from the block plans, so
// that its code does not change how nvcc compiles theirs.

#include <cuda_runtime.h>

#include <cstdint>

#include "orth_iter.cuh"  // cdiv, ld4, f4, kTileRows, tile_rows, kNsIters
#include "stage.cuh"      // cp.async copies, load_gram_chunk, imax, up4
#include "cluster.cuh"    // cluster rank, barrier, remote loads and stores

namespace {

constexpr int kThreads = 256;
constexpr int kInitIters = 8;   // HOSVD start: orthogonal-iteration steps
constexpr int kSweepIters = 3;  // orthogonal-iteration steps per HOOI sweep
constexpr int kStageLen = 64;   // Gram chunk length the stage grows for
constexpr int kMaxCluster = 8;  // blocks per layer at most (portable)

// Optional phase profile (-DTUCKER2_WS_PROFILE, tools/torch_ws_profile.py):
// SM cycles of each phase of block 0 (layer 0, rank 0), summed in
// ws_prof[slot] over launches. Compiled out otherwise.
#ifdef TUCKER2_WS_PROFILE
__device__ unsigned long long ws_prof[16];
__device__ __forceinline__ long long ws_clock() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;\n" : "=l"(t));
  return t;
}
struct WsSpan {
  int slot;
  long long t0;
  __device__ explicit WsSpan(int s) : slot(s), t0(ws_clock()) {}
  __device__ ~WsSpan() {
    if (blockIdx.x == 0 && threadIdx.x == 0) ws_prof[slot] += ws_clock() - t0;
  }
};
#define WS_SPAN(slot) const WsSpan ws_span_##slot(slot)
#else
#define WS_SPAN(slot)
#endif

// Regions of the workspace plan; a bit of WsPlan::in_ws is set for each
// that lies in the slab.
enum : unsigned {
  kWsNs = 1, kWsG = 2, kWsU = 4, kWsY = 8, kWsM = 16, kWsSp = 32
};

// Blocks per layer: 8 (kMaxCluster) from 192 padded rows, fewer below.
__host__ __device__ inline int ws_cluster(int o, int i) {
  const int np = imax(up4(o), up4(i));
  return np >= 192 ? 8 : np >= 96 ? 4 : np >= 48 ? 2 : 1;
}

// Rows of an n-row matrix (n a multiple of 4) owned by block q of c:
// [split_lo(n, q, c), split_lo(n, q + 1, c)), groups of 4 spread evenly.
__host__ __device__ inline int split_lo(int n, int q, int c) {
  return 4 * ((n / 4) * q / c);
}

// The most rows of an n-row matrix one block owns.
__host__ __device__ inline int own_cap(int n, int c) {
  return 4 * ((n / 4 + c - 1) / c);
}

// The workspace plan (see the header comment); the Python gate
// (ops/cuda/tucker_kernel.py::ws_plan) repeats it. The padded layout
// throughout, regions in order: the five Newton-Schulz matrices [rp, rp],
// the partial S [rp, rp], the Gram [np, np], Y [np, rp], the factors U0
// [op, r0p] and U1 [ip, r1p], and kg HOOI products, each max(M_k [op, r1p],
// N_k^T [ip, r0p]).
// In shared memory a block keeps its own rows of each (at most own_cap
// rows; the partial S whole, with rp floats for the trace's diagonal),
// in the slab a region lies whole (the partial S once per block). The
// partial S shares the scratch region with the two stage buffers.
struct WsPlan {
  int op, ip, r0p, r1p;
  int ldc0, ldc1;                     // chunk row strides for G0 and G1
  int kg;                             // k per HOOI product phase
  unsigned in_ws;                     // regions in the slab
  long long ns, sp, g, u0, u1, y, m;  // offsets into shared memory or the slab
  long long per_k;                    // floats from one HOOI product to the next
  int rbr;                            // Newton-Schulz rows one block holds
  int scratch, stage;                 // scratch offset; floats of each buffer
  int total;                          // floats of shared memory
  long long ws;                       // floats of slab per layer (multiple of 4)
};

__host__ __device__ inline WsPlan make_ws_plan(int k, int o, int i, int r0,
                                               int r1, int c) {
  WsPlan p;
  p.op = up4(o);
  p.ip = up4(i);
  p.r0p = up4(r0);
  p.r1p = up4(r1);
  const int np = imax(p.op, p.ip), rp = imax(p.r0p, p.r1p);
  p.ldc0 = p.op + 4;  // G0's chunks: X_k's columns, transposed (as subspace.cu)
  p.ldc1 = p.ip;      // G1's chunks: X_k's rows
  const long long ldc = imax(p.ldc0, p.ldc1);
  const int rbn = own_cap(np, c), rb0 = own_cap(p.op, c),
            rb1 = own_cap(p.ip, c);
  p.rbr = own_cap(rp, c);
  const long long per_k = imax(rb0 * p.r1p, rb1 * p.r0p);
  const long long per_k_ws = imax(p.op * p.r1p, p.ip * p.r0p);
  const unsigned bits[6] = {kWsNs, kWsSp, kWsG, kWsY, kWsU, kWsM};
  long long own[6] = {5LL * p.rbr * rp, 1LL * rp * rp + rp, 1LL * rbn * np,
                      1LL * rbn * rp, 1LL * rb0 * p.r0p + 1LL * rb1 * p.r1p,
                      0};
  const long long whole[6] = {5LL * rp * rp, 1LL * c * rp * rp, 1LL * np * np,
                              1LL * np * rp,
                              1LL * p.op * p.r0p + 1LL * p.ip * p.r1p,
                              k * per_k_ws};
  // two stage buffers of one row of X's Gram chunks at least, and of a
  // whole Newton-Schulz matrix (staged once a step) where two fit a block
  const long long rr = 1LL * rp * rp;
  long long persist = 0,
            scratch = 2 * (ldc >= rr || 2 * rr > kMaxSmemFloats ? ldc : rr);
  p.in_ws = 0;
  p.kg = k;
  for (int j = 0; j < 6; ++j) {
    bool fits;
    if (bits[j] == kWsM) {  // as many HOOI products as fit, in equal groups
      const long long room = kMaxSmemFloats - persist - scratch;
      const int fit = room >= per_k ? static_cast<int>(
                                          room / per_k < k ? room / per_k : k)
                                    : 0;
      const int groups = fit > 0 ? (k + fit - 1) / fit : 1;
      p.kg = fit > 0 ? (k + groups - 1) / groups : k;
      own[j] = p.kg * per_k;
    }
    if (bits[j] == kWsSp) {
      const long long sc = scratch > own[j] ? scratch : own[j];
      fits = persist + sc <= kMaxSmemFloats;
      if (fits) scratch = sc;
    } else {
      fits = persist + own[j] + scratch <= kMaxSmemFloats;
      if (fits) persist += own[j];
    }
    if (!fits) {
      p.in_ws |= bits[j];
      if (bits[j] == kWsM) p.kg = k;
    }
  }
  // offsets: own rows in shared memory in region order, then the scratch
  long long s_off = 0, w_off = 0, offs[6];
  for (int j = 0; j < 6; ++j) {
    if (p.in_ws & bits[j]) {
      offs[j] = w_off;
      w_off += whole[j];
    } else if (bits[j] != kWsSp) {
      offs[j] = s_off;
      s_off += own[j];
    }
  }
  p.scratch = static_cast<int>(s_off);
  offs[1] = (p.in_ws & kWsSp) ? offs[1] : s_off;
  p.ns = offs[0];
  p.sp = offs[1];
  p.g = offs[2];
  p.y = offs[3];
  p.u0 = offs[4];
  p.u1 = offs[4] + ((p.in_ws & kWsU) ? 1LL * p.op * p.r0p : 1LL * rb0 * p.r0p);
  p.m = offs[5];
  p.per_k = (p.in_ws & kWsM) ? per_k_ws : per_k;
  long long want = kStageLen * ldc;
  if (want < 1LL * np * rp) want = 1LL * np * rp;
  const long long half = (kMaxSmemFloats - s_off) / 2;
  p.stage = static_cast<int>((half < want ? half : want) & ~3LL);
  long long sc = 2LL * p.stage;
  if (!(p.in_ws & kWsSp) && sc < 1LL * rp * rp + rp) sc = 1LL * rp * rp + rp;
  p.total = static_cast<int>(s_off + sc);
  p.ws = w_off;
  return p;
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

// chunk[p * ldc + row] = M(row, p0 + p) for every row of a split matrix
// and p < kc.
__device__ void stage_cols(float* chunk, int ldc, const Split& s, int p0,
                           int kc, int c) {
  for (int q = 0; q < c; ++q) {
    const int lo = split_lo(s.n, q, c), n = split_lo(s.n, q + 1, c) - lo;
    const float* src = rows_of(s, q, c) + p0;
    for (int idx = threadIdx.x; idx < n * kc; idx += blockDim.x) {
      const int j = idx / kc, p = idx - j * kc;
      const float* e = src + j * s.ld + p;
      chunk[p * ldc + lo + j] = s.ws ? ld_cg(e) : *e;
    }
  }
}

// This block's rows of the mo x mo Gram (first ? 0 : g) + sum over k < kn
// of M_k M_k^T, M_k [mo, w] split over the cluster (M_k at mk.p + k
// kstride), its columns staged through one stage buffer; zero past m.
__device__ void gram_split(float* g, int lo, int rows, int mo, int m,
                           const Split& mk, long long kstride, int kn, int w,
                           int ldc, float* buf, int stage, bool first,
                           int csize) {
  WS_SPAN(10);
  const int kc = stage / ldc;
  for (int kk = 0; kk < kn; ++kk) {
    Split s = mk;
    s.p += kk * kstride;
    for (int p0 = 0; p0 < w; p0 += kc) {
      const int len = imin(kc, w - p0);
      stage_cols(buf, ldc, s, p0, len, csize);
      __syncthreads();
      mm_chunk<2>(g, mo, buf + lo, 1, ldc, buf, ldc, rows, mo, len,
                  first && kk == 0 && p0 == 0);
      __syncthreads();
    }
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

// This block's rows of a HOOI Gram, sum_k P_k P_k^T, over the cluster:
// mode 0 P_k = X_k U1 [op, r1p] (X_k's rows), mode 1 P_k = X_k^T U0 [ip,
// r0p] (X_k's columns), b the other factor, split. The P_k are this block's
// rows of the split matrices at pk.p + k per_k (rows past O or I zero), kg
// at a time; each group's Gram is added after a cluster barrier.
__device__ __noinline__ void hooi_gram(float* g, const Split& pk,
                                       long long per_k, int kg,
                                       const float* xl, int k, int o, int i,
                                       bool mode1, bool vec, const Split& b,
                                       int ldc, int rank, int c, float* buf,
                                       int stage) {
  const int n = pk.n, w = pk.ld, m = mode1 ? i : o;
  const int lo = split_lo(n, rank, c), rows = split_lo(n, rank + 1, c) - lo;
  const int valid = imax(0, imin(m - lo, rows));
  const int xk = o * i;
  for (int k0 = 0; k0 < k; k0 += kg) {
    const int kn = imin(kg, k - k0);
    {
      WS_SPAN(9);
      for (int j = 0; j < kn; ++j) {
        Split pj = pk;
        pj.p += j * per_k;
        float* out = own_rows(pj, rank, c);
        const float* x = xl + static_cast<size_t>(k0 + j) * xk;
        if (!mode1 && vec)  // X_k's rows, float4 along I
          split_mm<1>(out, w, x + lo * i, i, 1, b, i, valid, w, buf, stage, c);
        else if (!mode1)
          split_mm<0>(out, w, x + lo * i, i, 1, b, i, valid, w, buf, stage, c);
        else if (vec)  // X_k's columns, float4 over 4 of them
          split_mm<2>(out, w, x + lo, 1, i, b, o, valid, w, buf, stage, c);
        else
          split_mm<0>(out, w, x + lo, 1, i, b, o, valid, w, buf, stage, c);
        for (int idx = valid * w + threadIdx.x; idx < rows * w;
             idx += blockDim.x)
          out[idx] = 0.f;  // rows past O or I
      }
      cluster_sync();
    }
    gram_split(g, lo, rows, n, m, pk, per_k, kn, w, ldc, buf, stage,
               k0 == 0, c);
    cluster_sync();  // every block has read P before it is rewritten
  }
}

// The workspace plan's kernel: block `cluster_rank()` of layer blockIdx.x /
// C, the iteration of tucker2_factors_kernel over this block's rows.
__global__ void __launch_bounds__(kThreads, 1)
tucker2_factors_ws_kernel(const float* __restrict__ x,
                          float* __restrict__ u0_out,
                          float* __restrict__ u1_out, float* ws, int k, int o,
                          int i, int r0, int r1, int sweeps) {
  extern __shared__ float smem[];
  WS_SPAN(0);
  const int c = static_cast<int>(cluster_size());
  const int rank = static_cast<int>(cluster_rank());
  const int layer = blockIdx.x / c;
  const WsPlan p = make_ws_plan(k, o, i, r0, r1, c);
  float* wl = ws + static_cast<size_t>(layer) * p.ws;
  const auto at = [&](unsigned bit, long long off) {
    return ((p.in_ws & bit) ? wl : smem) + off;
  };
  const bool g_ws = p.in_ws & kWsG, u_ws = p.in_ws & kWsU,
             y_ws = p.in_ws & kWsY, m_ws = p.in_ws & kWsM,
             ns_ws = p.in_ws & kWsNs, sp_ws = p.in_ws & kWsSp;
  const int op = p.op, ip = p.ip, r0p = p.r0p, r1p = p.r1p;
  const int lo0 = split_lo(op, rank, c), n0 = split_lo(op, rank + 1, c) - lo0;
  const int lo1 = split_lo(ip, rank, c), n1 = split_lo(ip, rank + 1, c) - lo1;
  float* buf = smem + p.scratch;
  float* sp = at(kWsSp, p.sp);
  // the trace's diagonal: after the partial S in the scratch region, or
  // at its start where the partial S lies in the slab
  const int rp = imax(r0p, r1p);
  float* diag = buf + (sp_ws ? 0 : rp * rp);
  const Split u0{at(kWsU, p.u0), r0p, op, u_ws}, u1{at(kWsU, p.u1), r1p, ip, u_ws};
  // this block's rows of G and Y in mode 0 (rows of O) or 1 (rows of I)
  const auto g_rows = [&](int lo, int mp) {
    return at(kWsG, p.g) + (g_ws ? static_cast<size_t>(lo) * mp : 0);
  };
  const auto y_rows = [&](int lo, int rpm) {
    return at(kWsY, p.y) + (y_ws ? static_cast<size_t>(lo) * rpm : 0);
  };
  const auto ns_of = [&](Split* ns, int rpm) {
    for (int j = 0; j < 5; ++j)
      ns[j] = Split{at(kWsNs, p.ns + j * (ns_ws ? 1LL * rpm * rpm
                                                : 1LL * p.rbr * imax(r0p, r1p))),
                    rpm, rpm, ns_ws};
  };
  Split ns0[5], ns1[5];
  ns_of(ns0, r0p);
  ns_of(ns1, r1p);
  const int xk = o * i;  // floats from X_k to X_{k+1}
  const float* xl = x + static_cast<size_t>(layer) * k * xk;
  const bool solve0 = r0 < o, solve1 = r1 < i;
  set_eye_rows(own_rows(u0, rank, c), lo0, n0, r0, r0p);
  set_eye_rows(own_rows(u1, rank, c), lo1, n1, r1, r1p);
  cluster_sync();  // every block has started, and the factors are set

  // HOSVD init (a full-rank factor is the identity)
  if (solve0) {  // G0 = sum_k X_k X_k^T
    float* g = g_rows(lo0, op);
    gram_x(g, lo0, n0, op, o, xl, xk, k, true, i, i, p.ldc0, buf, p.stage);
    orth_split(g, g_ws, u0, y_rows(lo0, r0p), ns0, sp, sp_ws, diag, op, r0,
               r0p, kInitIters, rank, c, buf, p.stage);
  }
  if (solve1) {  // G1 = sum_k X_k^T X_k
    float* g = g_rows(lo1, ip);
    gram_x(g, lo1, n1, ip, i, xl, xk, k, false, i, o, p.ldc1, buf, p.stage);
    orth_split(g, g_ws, u1, y_rows(lo1, r1p), ns1, sp, sp_ws, diag, ip, r1,
               r1p, kInitIters, rank, c, buf, p.stage);
  }

  // HOOI sweeps: float4 products where X's rows allow, else scalar ones
  const bool vec = o % 4 == 0 && i % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(xl) & 15) == 0;
  float* mbase = at(kWsM, p.m);
  for (int s = 0; s < sweeps; ++s) {
    if (solve0) {  // G0' = sum_k (X_k U1)(X_k U1)^T
      float* g = g_rows(lo0, op);
      hooi_gram(g, Split{mbase, r1p, op, m_ws}, p.per_k, p.kg, xl, k, o, i,
                false, vec, u1, p.ldc0, rank, c, buf, p.stage);
      orth_split(g, g_ws, u0, y_rows(lo0, r0p), ns0, sp, sp_ws, diag, op,
                 r0, r0p, kSweepIters, rank, c, buf, p.stage);
    }
    if (solve1) {  // G1' = sum_k (X_k^T U0)(X_k^T U0)^T
      float* g = g_rows(lo1, ip);
      hooi_gram(g, Split{mbase, r0p, ip, m_ws}, p.per_k, p.kg, xl, k, o, i,
                true, vec, u0, p.ldc1, rank, c, buf, p.stage);
      orth_split(g, g_ws, u1, y_rows(lo1, r1p), ns1, sp, sp_ws, diag, ip,
                 r1, r1p, kSweepIters, rank, c, buf, p.stage);
    }
  }
  const float* q0 = own_rows(u0, rank, c);
  const float* q1 = own_rows(u1, rank, c);
  float* u0l = u0_out + static_cast<size_t>(layer) * o * r0;
  float* u1l = u1_out + static_cast<size_t>(layer) * i * r1;
  const int v0 = imax(0, imin(o - lo0, n0)), v1 = imax(0, imin(i - lo1, n1));
  for (int idx = threadIdx.x; idx < v0 * r0; idx += blockDim.x)
    u0l[lo0 * r0 + idx] = q0[(idx / r0) * r0p + idx % r0];
  for (int idx = threadIdx.x; idx < v1 * r1; idx += blockDim.x)
    u1l[lo1 * r1 + idx] = q1[(idx / r1) * r1p + idx % r1];
  cluster_sync();  // no block leaves while another may read its memory
}

}  // namespace

extern "C" {

// Blocks per layer (the cluster's size), bytes of dynamic shared memory a
// block, and floats of device memory per layer, of the workspace plan for
// a [K, O, I] layer.
int tucker2_factors_ws_cluster(int k, int o, int i, int r0, int r1) {
  (void)k, (void)r0, (void)r1;
  return ws_cluster(o, i);
}

int tucker2_factors_ws_smem_bytes(int k, int o, int i, int r0, int r1) {
  return make_ws_plan(k, o, i, r0, r1, ws_cluster(o, i)).total *
         static_cast<int>(sizeof(float));
}

long long tucker2_factors_ws_floats(int k, int o, int i, int r0, int r1) {
  return make_ws_plan(k, o, i, r0, r1, ws_cluster(o, i)).ws;
}

static cudaLaunchConfig_t ws_config(int l, int c, int bytes, void* stream,
                                    cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(l * c, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of the plan's size and shared memory the card can hold at once
// (cudaOccupancyMaxActiveClusters), or minus a CUDA error.
int tucker2_factors_ws_max_clusters(int k, int o, int i, int r0, int r1) {
  const int c = ws_cluster(o, i);
  const int bytes = tucker2_factors_ws_smem_bytes(k, o, i, r0, r1);
  cudaError_t err = cudaFuncSetAttribute(
      tucker2_factors_ws_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = ws_config(1, c, bytes, nullptr, &attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, tucker2_factors_ws_kernel, &cfg);
  return err != cudaSuccess ? -static_cast<int>(err) : n;
}

#ifdef TUCKER2_WS_PROFILE
// Copies the phase profile (16 sums of SM cycles) to `out` and zeroes it.
int tucker2_factors_ws_profile(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, ws_prof, sizeof(ws_prof));
  if (err == cudaSuccess) {
    static const unsigned long long zero[16] = {};
    err = cudaMemcpyToSymbol(ws_prof, zero, sizeof(ws_prof));
  }
  return static_cast<int>(err);
}
#endif

// Launches the workspace plan on `stream`, one cluster per layer: ws holds
// l * tucker2_factors_ws_floats floats, 16-byte aligned. Returns the CUDA
// error of the launch (0 on success); a cluster the card cannot schedule
// is an error, never a smaller one. Requires 1 <= r0 <= O and
// 1 <= r1 <= I; the caller checks shapes.
int tucker2_factors_ws_launch(const void* x, void* u0, void* u1, void* ws,
                              int l, int k, int o, int i, int r0, int r1,
                              int sweeps, void* stream) {
  if (l == 0) return 0;
  const int c = ws_cluster(o, i);
  const int bytes = tucker2_factors_ws_smem_bytes(k, o, i, r0, r1);
  cudaError_t err = cudaFuncSetAttribute(
      tucker2_factors_ws_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = ws_config(l, c, bytes, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, tucker2_factors_ws_kernel,
                           static_cast<const float*>(x),
                           static_cast<float*>(u0), static_cast<float*>(u1),
                           static_cast<float*>(ws), k, o, i, r0, r1, sweeps);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
