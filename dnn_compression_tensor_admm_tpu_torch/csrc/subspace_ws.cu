// Batched dominant left subspace for the TT Z-step, the workspace plan:
// CUDA C++ for sm_90a, for slices whose block plans (subspace.cu) do not
// fit one block's 227 KB of shared memory.
//
// Replaces, with subspace.cu, the Pallas TPU kernel
// dnn_compression_tensor_admm_tpu/ops/pallas/subspace_kernel.py::
// dominant_left_subspace_batched (body `_subspace_kernel`): for each layer
// l of a t[L, rows, cols] float32 stack, the top-r left singular subspace
// q[l] [rows, r] by `iters` steps of orthogonal iteration on the Gram of
// the smaller side from the identity and, in the tall case, the lift
// q = Y (Y^T Y)^{-1/2} with Y = t V; each inverse square root is 12
// Newton-Schulz steps on S/tr(S) + 1e-6 I (subspace.cu's header).
//
// Bound on the H100 (SXM, 700 W): DeiT-tiny TT@2x's 13 workspace launches
// (eleven at r = 96, 144 to 720 rows by 192 or 768 columns at L = 1, 10 or
// 11; two 2304 x 32 at r = 28 and 30) need about 33 GFLOP of float32 per
// Z-step (`subspace_flops` in ops/cuda/subspace_kernel.py), so the card
// could take about 0.49 ms at its 67 TFLOP/s non-tensor float32 rate:
// bound by operations.
//
// Design: one thread-block cluster of C = 8 blocks per layer (grid L x C,
// kCluster), so a one-layer r = 96 launch runs on 8 SMs where one
// block per layer ran on 1. It is the Tucker-2 workspace plan's iteration
// (cluster_iter.cuh) on one mode. Each block owns row groups of 4 (`split_lo`) of the Gram G [mp, mp], the
// iterate Q [mp, rp], Y and the five Newton-Schulz matrices [rp, rp], and
// computes its own rows of each product; a right operand split over the
// cluster is staged chunk by chunk from its owners (`split_mm`).
// 1. The Gram, this block's rows (`gram_x` at K = 1): wide, G = t t^T over
//    t's columns (transposed chunks); tall, G = t^T t over t's rows. Every
//    block streams all of t through its two stage buffers by cp.async.
// 2. `orth_split`, `iters` times from the identity: Y = G Q; S = Y^T Y as
//    per-block partials summed in block order; S^{-1/2} by Newton-Schulz
//    (`ns_split`: every block holds all of Y and Z and pushes its new rows
//    into every block's copy, one cluster barrier a step); Q = Y Z.
// 3. Wide: this block's rows of Q, first r columns, go to q. Tall: the
//    lift, over the cluster by t's rows: Y = t V (t's columns of this
//    block's rows by cp.async, V's rows from their owners), S = Y^T Y
//    summed as in 2, its inverse square root by `ns_split`, and q = Y Z,
//    each block writing its own rows of q straight to device memory.
// The same float32 iteration as the one-block plans, summed in another
// order: S over the cluster's blocks, Newton-Schulz's W Y for Y W.
//
// Memory: as in the Tucker-2 workspace plan, a block takes its rows of each
// region into its shared memory in the order the iteration reads them most
// (the Newton-Schulz matrices, the partial S, the Gram, Y, the iterate)
// while they fit beside two stage buffers of one Gram chunk row at least
// and of an rp x rp matrix where two fit; a region that does not fit lies
// whole in a per-layer slab of device memory that the wrapper allocates
// (`subspace_ws_floats`, 16-byte aligned), which every block of the cluster
// reads past L1 after a cluster barrier. At DeiT-tiny's shapes every region
// fits. It is a library of its own, so that its code does not change how
// nvcc compiles the block plans. The Python gate
// (ops/cuda/subspace_kernel.py::ws_plan, WS_CLUSTER) repeats the plan.

#include <cuda_runtime.h>

#include <cstdint>

#include "orth_iter.cuh"  // cdiv, ld4, f4, mm4_tiles, kTileRows, kNsIters
#include "stage.cuh"      // cp.async copies, load_gram_chunk, imax, up4
#include "cluster.cuh"    // cluster rank, barrier, remote loads and stores

namespace {

constexpr int kThreads = 256;
constexpr int kStageLen = 64;  // Gram chunk length the stage grows for

// Optional phase profile (-DSUBSPACE_WS_PROFILE, tools/torch_ws_profile.py
// --kernel subspace): SM cycles of each phase of block 0 (layer 0, rank 0),
// summed in ws_prof[slot] over launches; slot 0 the launch, 9 the tall
// lift, the others cluster_iter.cuh's. Compiled out otherwise.
#ifdef SUBSPACE_WS_PROFILE
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
enum : unsigned { kWsNs = 1, kWsG = 2, kWsQ = 4, kWsY = 8, kWsSp = 16 };

#include "cluster_iter.cuh"  // split matrices, split_mm, gram_x, orth_split

// Blocks per layer, whatever the slice: 8, the most a portable cluster
// has. At DeiT-tiny's r = 96 launches 8 blocks split the iteration's
// products; at its 2304 x 32 ones, whose 32 x 32 iteration barely splits,
// they split the Gram and the lift. make_ws_plan takes any size from 1 to
// kMaxCluster (the emulation tests run 2, 4 and 8).
constexpr int kCluster = 8;
static_assert(kCluster <= kMaxCluster, "a portable cluster");

// The workspace plan (see the header comment); the Python gate
// (ops/cuda/subspace_kernel.py::ws_plan) repeats it. The padded layout
// throughout (m = min(rows, cols), mp, rp and yp = m, r and rows rounded
// up to 4), regions in order: the five Newton-Schulz matrices [rp, rp],
// the partial S [rp, rp], the Gram [mp, mp], Y [yp, rp] (Y = G Q in the
// iteration, the tall lift's t V after it), the iterate [mp, rp]. In
// shared memory a block keeps its own rows of each (at most own_cap rows;
// the partial S whole, with rp floats for the trace's diagonal), in the
// slab a region lies whole (the partial S once per block). The partial S
// shares the scratch region with the two stage buffers.
struct WsPlan {
  int mp, rp, yp;
  int ldc;                        // the Gram's chunk row stride
  unsigned in_ws;                 // regions in the slab
  long long ns, sp, g, y, q;      // offsets into shared memory or the slab
  int rbr;                        // Newton-Schulz rows one block holds
  int scratch, stage;             // scratch offset; floats of each buffer
  int total;                      // floats of shared memory
  long long ws;                   // floats of slab per layer (multiple of 4)
};

__host__ __device__ inline WsPlan make_ws_plan(int rows, int cols, int r,
                                               int c) {
  WsPlan p;
  const bool wide = rows <= cols;
  p.mp = up4(imin(rows, cols));
  p.rp = up4(r);
  p.yp = up4(rows);
  // transposed chunks one float4 past the rows, t's own rows (as subspace.cu)
  p.ldc = wide ? p.mp + 4 : p.mp;
  const int rbn = own_cap(p.mp, c), rby = own_cap(p.yp, c);
  p.rbr = own_cap(p.rp, c);
  const long long rr = 1LL * p.rp * p.rp;
  const unsigned bits[5] = {kWsNs, kWsSp, kWsG, kWsY, kWsQ};
  const long long own[5] = {5LL * p.rbr * p.rp, rr + p.rp, 1LL * rbn * p.mp,
                            1LL * rby * p.rp, 1LL * rbn * p.rp};
  const long long whole[5] = {5 * rr, c * rr, 1LL * p.mp * p.mp,
                              1LL * p.yp * p.rp, 1LL * p.mp * p.rp};
  // two stage buffers of one Gram chunk row at least, and of a whole
  // Newton-Schulz matrix (staged once a step) where two fit a block
  long long persist = 0,
            scratch = 2 * (p.ldc >= rr || 2 * rr > kMaxSmemFloats ? p.ldc : rr);
  p.in_ws = 0;
  for (int j = 0; j < 5; ++j) {
    bool fits;
    if (bits[j] == kWsSp) {
      const long long sc = scratch > own[j] ? scratch : own[j];
      fits = persist + sc <= kMaxSmemFloats;
      if (fits) scratch = sc;
    } else {
      fits = persist + own[j] + scratch <= kMaxSmemFloats;
      if (fits) persist += own[j];
    }
    if (!fits) p.in_ws |= bits[j];
  }
  // offsets: own rows in shared memory in region order, then the scratch
  long long s_off = 0, w_off = 0, offs[5];
  for (int j = 0; j < 5; ++j) {
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
  p.q = offs[4];
  // a stage buffer grows for kStageLen Gram chunk rows, all of Q (Y = G Q
  // in one chunk) and, tall, all of t's columns of this block's rows with
  // V (the lift in one chunk), as far as shared memory allows
  long long want = 1LL * kStageLen * p.ldc;
  if (want < 1LL * p.mp * p.rp) want = 1LL * p.mp * p.rp;
  if (!wide && want < 1LL * (p.rp + rby) * up4(cols))
    want = 1LL * (p.rp + rby) * up4(cols);
  const long long half = (kMaxSmemFloats - s_off) / 2;
  p.stage = static_cast<int>((half < want ? half : want) & ~3LL);
  long long sc = 2LL * p.stage;
  if (!(p.in_ws & kWsSp) && sc < rr + p.rp) sc = rr + p.rp;
  p.total = static_cast<int>(s_off + sc);
  p.ws = w_off;
  return p;
}

// tr S + 1e-30, and this block's rows of S (of the split s) = the sum over
// the cluster's blocks, in block order, of their partial Grams y^T y, this
// block's from its n rows of y [n, rp] into sp (in the slab: block q's at
// sp + q rp rp), with rp floats of shared memory at diag: orth_split's
// reduction (cluster_iter.cuh), for the lift's Y. A copy, not a call that
// orth_split shares: sharing it moved the Tucker-2 kernel's build (8 more
// bytes of stack and 4 of spill, 1.35% slower on the H100; PERF.md).
__device__ float gram_over_cluster(const float* y, int n, const Split& s,
                                   float* sp, bool sp_ws, float* diag, int r,
                                   int rp, int rank, int c) {
  const size_t rr = static_cast<size_t>(rp) * rp;
  const auto part = [&](int b) -> const float* {
    return sp_ws ? sp + b * rr : cluster_map(sp, b);
  };
  mm_chunk<2>(sp_ws ? sp + rank * rr : sp, rp, y, 1, rp, y, rp, rp, rp, n,
              true);  // Y^T Y here
  cluster_sync();
  const int rlo = split_lo(rp, rank, c), nr = split_lo(rp, rank + 1, c) - rlo;
  float* so = own_rows(s, rank, c);
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
    *reinterpret_cast<float4*>(so + j * rp + col) = acc;
  }
  return trace_of_partials(part, r, rp, diag, c, sp_ws);
}

// The tall lift over the cluster: this block's rows [ylo, ylo + yn) of
// q [rows, r] = Y (Y^T Y)^{-1/2}, Y = t V, for tl [rows, cols] and the
// iterate V [mp, rp] split over the cluster; y holds this block's yn rows
// of Y (row stride rp). Where Z stays split over the cluster (rp past
// ~170), q = Y Z goes through tmp (`piece` rows of rp floats at a time).
__device__ __noinline__ void lift_split(float* ql, const float* tl, int rows,
                                        int cols, int r, int rp, int yp,
                                        const Split& v, float* y,
                                        const Split* ns, float* sp,
                                        bool sp_ws, float* diag, float* tmp,
                                        int piece, int rank, int c,
                                        float* buf, int stage) {
  WS_SPAN(9);
  const int ylo = split_lo(yp, rank, c), yn = split_lo(yp, rank + 1, c) - ylo;
  const int yv = imax(0, imin(rows - ylo, yn));  // rows of t
  const float* a = tl + static_cast<size_t>(ylo) * cols;
  if (cols % 4 == 0 && (reinterpret_cast<uintptr_t>(tl) & 15) == 0)
    // t's rows float4 along their columns, chunks by cp.async
    split_mm<1>(y, rp, a, cols, 1, v, cols, yv, rp, buf, stage, c, true);
  else
    split_mm<0>(y, rp, a, cols, 1, v, cols, yv, rp, buf, stage, c);
  for (int idx = yv * rp + threadIdx.x; idx < yn * rp; idx += blockDim.x)
    y[idx] = 0.f;  // pad rows of Y
  __syncthreads();
  const float tr = gram_over_cluster(y, yn, ns[0], sp, sp_ws, diag, r, rp,
                                     rank, c);
  Split zs;
  const float* zf = ns_split(ns, tr, r, rp, rank, c, buf, stage, &zs);
  WS_SPAN(8);
  float* qo = ql + static_cast<size_t>(ylo) * r;
  if (zf) {  // q = Y Z, all of Z here: the first r columns of each row
    const auto store = [&](int row, int col, const float* o) {
      float* out = qo + static_cast<size_t>(row) * r + col;
      if (r % 4 == 0) {
        *reinterpret_cast<float4*>(out) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
        for (int j = 0; j < 4; ++j)
          if (col + j < r) out[j] = o[j];
      }
    };
    mm4_tiles<kTileRows, false>(y, rp, zf, rp, yv, rp, rp, store);
    __syncthreads();
    return;
  }
  for (int j0 = 0; j0 < yv; j0 += piece) {  // Z from its owners
    const int nj = imin(piece, yv - j0);
    split_mm<1>(tmp, rp, y + j0 * rp, rp, 1, zs, rp, nj, rp, buf, stage, c);
    for (int idx = threadIdx.x; idx < nj * r; idx += blockDim.x)
      qo[static_cast<size_t>(j0) * r + idx] = tmp[(idx / r) * rp + idx % r];
    __syncthreads();
  }
}

// The workspace plan's kernel: block `cluster_rank()` of layer
// blockIdx.x / C.
__global__ void __launch_bounds__(kThreads, 1)
subspace_ws_kernel(const float* __restrict__ t, float* __restrict__ q_out,
                   float* ws, int rows, int cols, int r, int iters) {
  extern __shared__ float smem[];
  WS_SPAN(0);
  const int c = static_cast<int>(cluster_size());
  const int rank = static_cast<int>(cluster_rank());
  const int layer = blockIdx.x / c;
  const WsPlan p = make_ws_plan(rows, cols, r, c);
  float* wl = ws + static_cast<size_t>(layer) * p.ws;
  const auto at = [&](unsigned bit, long long off) {
    return ((p.in_ws & bit) ? wl : smem) + off;
  };
  const bool g_ws = p.in_ws & kWsG, y_ws = p.in_ws & kWsY,
             q_ws = p.in_ws & kWsQ, ns_ws = p.in_ws & kWsNs,
             sp_ws = p.in_ws & kWsSp;
  const int mp = p.mp, rp = p.rp;
  const bool wide = rows <= cols;
  const int lo = split_lo(mp, rank, c), n = split_lo(mp, rank + 1, c) - lo;
  float* buf = smem + p.scratch;
  float* sp = at(kWsSp, p.sp);
  // the trace's diagonal: after the partial S in the scratch region, or
  // at its start where the partial S lies in the slab
  float* diag = buf + (sp_ws ? 0 : rp * rp);
  const Split q{at(kWsQ, p.q), rp, mp, q_ws};
  Split ns[5];
  for (int j = 0; j < 5; ++j)
    ns[j] = Split{at(kWsNs, p.ns + j * (ns_ws ? 1LL * rp * rp
                                              : 1LL * p.rbr * rp)),
                  rp, rp, ns_ws};
  float* g = at(kWsG, p.g) + (g_ws ? static_cast<size_t>(lo) * mp : 0);
  float* y = at(kWsY, p.y);
  const float* tl = t + static_cast<size_t>(layer) * rows * cols;
  float* ql = q_out + static_cast<size_t>(layer) * rows * r;

  set_eye_rows(own_rows(q, rank, c), lo, n, r, rp);
  cluster_sync();  // every block has started, and the iterate is set
  // the Gram of the smaller side: t t^T over t's columns, or t^T t over
  // its rows
  gram_x(g, lo, n, mp, wide ? rows : cols, tl, 0, 1, wide, cols,
         wide ? cols : rows, p.ldc, buf, p.stage);
  orth_split(g, g_ws, q, y + (y_ws ? static_cast<size_t>(lo) * rp : 0), ns,
             sp, sp_ws, diag, mp, r, rp, iters, rank, c, buf,
             p.stage);  // Q, or V in the tall case
  if (wide) {  // this block's rows of Q, the first r columns
    const float* qo = own_rows(q, rank, c);
    const int v = imax(0, imin(rows - lo, n));
    for (int idx = threadIdx.x; idx < v * r; idx += blockDim.x)
      ql[lo * r + idx] = qo[(idx / r) * rp + idx % r];
  } else {
    // q = Y Z through the Gram's room where Z stays split: this block's
    // rows in shared memory, or its share of the slab's Gram (free now)
    const long long share = (1LL * mp * mp / c) & ~3LL;
    float* tmp = g_ws ? at(kWsG, p.g) + rank * share : g;
    const long long room = g_ws ? share : 1LL * own_cap(mp, c) * mp;
    const int ylo = split_lo(p.yp, rank, c);
    lift_split(ql, tl, rows, cols, r, rp, p.yp, q,
               y + (y_ws ? static_cast<size_t>(ylo) * rp : 0), ns, sp, sp_ws,
               diag, tmp, static_cast<int>((room / rp) & ~3LL), rank, c, buf,
               p.stage);
  }
  cluster_sync();  // no block leaves while another may read its memory
}

}  // namespace

extern "C" {

// Blocks per layer (the cluster's size) of every launch; then bytes of
// dynamic shared memory a block, and floats of device memory per layer, of
// the workspace plan for a [rows, cols] slice at rank r.
int subspace_ws_cluster() { return kCluster; }

int subspace_ws_smem_bytes(int rows, int cols, int r) {
  return make_ws_plan(rows, cols, r, kCluster).total *
         static_cast<int>(sizeof(float));
}

long long subspace_ws_floats(int rows, int cols, int r) {
  return make_ws_plan(rows, cols, r, kCluster).ws;
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
int subspace_ws_max_clusters(int rows, int cols, int r) {
  const int c = kCluster;
  const int bytes = subspace_ws_smem_bytes(rows, cols, r);
  cudaError_t err = cudaFuncSetAttribute(
      subspace_ws_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = ws_config(1, c, bytes, nullptr, &attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, subspace_ws_kernel, &cfg);
  return err != cudaSuccess ? -static_cast<int>(err) : n;
}

#ifdef SUBSPACE_WS_PROFILE
// Copies the phase profile (16 sums of SM cycles) to `out` and zeroes it.
int subspace_ws_profile(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, ws_prof, sizeof(ws_prof));
  if (err == cudaSuccess) {
    static const unsigned long long zero[16] = {};
    err = cudaMemcpyToSymbol(ws_prof, zero, sizeof(ws_prof));
  }
  return static_cast<int>(err);
}
#endif

// Launches the workspace plan on `stream`, one cluster per layer: ws holds
// l * subspace_ws_floats floats, 16-byte aligned. Returns the CUDA error of
// the launch (0 on success); a cluster the card cannot schedule is an
// error, never a smaller one. Requires 1 <= r <= min(rows, cols) and
// r < rows; the caller checks shapes.
int subspace_ws_launch(const void* t, void* q, void* ws, int l, int rows,
                       int cols, int r, int iters, void* stream) {
  if (l == 0) return 0;
  const int c = kCluster;
  const int bytes = subspace_ws_smem_bytes(rows, cols, r);
  cudaError_t err = cudaFuncSetAttribute(
      subspace_ws_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = ws_config(l, c, bytes, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, subspace_ws_kernel,
                           static_cast<const float*>(t),
                           static_cast<float*>(q), static_cast<float*>(ws),
                           rows, cols, r, iters);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
