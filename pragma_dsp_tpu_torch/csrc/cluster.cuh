// Distributed shared memory and the cluster barrier, for the kernels whose
// blocks run in clusters: K7 (fft_cols.cu) and K2's turned instances
// (fft_rows.cu). A cluster's blocks lie on neighbouring SMs of one GPC and
// read and write each other's shared memory (mapa, ld/st.shared::cluster).
// A block may touch another's shared memory only while both run, so a
// kernel puts a cluster barrier before its first remote access and after
// its last one.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

static __device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// The address of a word of this block's shared memory in block `rank`.
static __device__ __forceinline__ uint32_t map_to_rank(const float* p, uint32_t rank) {
  const uint32_t local = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

static __device__ __forceinline__ void store_to_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(addr), "f"(v) : "memory");
}

static __device__ __forceinline__ float load_from_cluster(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

static __device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

static __device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

static __device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
