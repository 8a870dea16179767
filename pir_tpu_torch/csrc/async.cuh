// Asynchronous copies from device memory into shared memory (cp.async),
// shared by the scan kernels (csrc/scan.cu, csrc/scan_wide.cu) and the wide
// contraction (csrc/contract.cuh).  A thread
// commits the copies it issued as one group and waits until at most
// kPending of its groups are still in flight; copies of other threads are
// seen only after a barrier.
#pragma once

#include <cstdint>

// 16 bytes, cached in L2 only
__device__ __forceinline__ void copy_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}
// kBytes = 4, 8 or 16, cached in L1 and L2
template <int kBytes>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "n"(kBytes));
}
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;"); }
template <int kPending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending));
}
