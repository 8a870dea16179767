// Thread-block cluster primitives (sm_90), written in PTX: a CTA's rank in
// its cluster, loads from a sibling CTA's shared memory (distributed shared
// memory), and the cluster-wide barrier.  Used by kernel A's split rings
// (csrc/ntt.cu::ntt_cluster_kernel).  An address in a sibling's shared
// memory is a shared::cluster address, carried in 64 bits.
#pragma once

#include <cstdint>

// This CTA's rank in its cluster (%cluster_ctarank).
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  return rank;
}

// The shared::cluster address of the word at local shared-memory pointer p
// in the CTA of cluster rank `rank` (mapa).
__device__ __forceinline__ uint64_t cluster_map(const void* p, uint32_t rank) {
  const uint32_t local = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

__device__ __forceinline__ uint64_t cluster_load(uint64_t addr) {
  uint64_t v;
  asm volatile("ld.shared::cluster.u64 %0, [%1];" : "=l"(v) : "r"(static_cast<uint32_t>(addr))
               : "memory");
  return v;
}

// The cluster barrier, split: every thread of every CTA of the cluster
// arrives (its shared-memory writes, remote ones included, released), and
// a wait returns once all have arrived (their writes acquired).  Every
// thread arrives and waits in turn; arrive early and wait late to overlap
// the barrier with work that touches no other CTA.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
