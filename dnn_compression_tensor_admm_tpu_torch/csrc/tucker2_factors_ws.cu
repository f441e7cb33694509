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
// from L2. The split matrices, split_mm, gram_x and orth_split live in
// cluster_iter.cuh, shared with the subspace workspace plan. Products are
// plain FMA loops in float32, as in tucker2_factors.cu. It is a separate
// library from the block plans, so that its code does not change how nvcc
// compiles theirs.

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

#include "cluster_iter.cuh"  // split matrices, split_mm, gram_x, orth_split

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
