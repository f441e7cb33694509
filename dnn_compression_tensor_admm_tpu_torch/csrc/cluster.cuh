// Thread-block cluster primitives of the workspace plans
// (tucker2_factors_ws.cu, subspace_ws.cu, through cluster_iter.cuh): this
// block's rank in its cluster, the cluster's size, the cluster barrier, a
// pointer into and stores to another block's shared memory, and loads that
// bypass L1 for a slab region another block of the cluster wrote. Each is
// a small named function so that the CPU emulation
// (tests/test_torch_port_cuda_emulation.py) can rewrite its body, as it
// rewrites the cp.async copies of stage.cuh. Every block of a cluster
// calls the barrier with all its threads.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_size() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

// The cluster barrier: waits until every thread of the cluster has
// arrived; writes before it, to shared and to device memory, are seen by
// every thread of the cluster after it (arrive releases, wait acquires).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The address of p's shared-memory location in block `rank` of this
// cluster (a generic pointer: plain loads read it).
__device__ __forceinline__ float* cluster_map(float* p, unsigned rank) {
  uint64_t out;
  asm volatile("mapa.u64 %0, %1, %2;\n"
               : "=l"(out)
               : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<float*>(out);
}

// Stores v at p's shared-memory location in block `rank` of this cluster
// (st.shared::cluster; seen there after the next cluster barrier).
__device__ __forceinline__ void st4_remote(float* p, unsigned rank,
                                           float4 v) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned ra;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(ra)
               : "r"(a), "r"(rank));
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n"
               :
               : "r"(ra), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// Loads from L2, past this SM's L1, for device memory that another block
// of the cluster wrote before the last cluster barrier.
__device__ __forceinline__ float4 ld4_cg(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float ld_cg(const float* p) {
  return __ldcg(p);
}

}  // namespace
