// Modular helpers shared by the scan kernels (csrc/scan.cu, csrc/scan_wide.cu).
#pragma once

#include <cstdint>

// Port of pir_tpu/ops/modular.py::barrett_reduce_128 (q < 2^61): the value
// hi * 2^64 + lo modulo q, with ratio = floor(2^128 / q) as two words.
__device__ __forceinline__ uint64_t barrett_reduce_128(uint64_t hi,
                                                       uint64_t lo, uint64_t q,
                                                       uint64_t ratio_hi,
                                                       uint64_t ratio_lo) {
  const uint64_t carry = __umul64hi(lo, ratio_lo);
  const uint64_t t2_lo = lo * ratio_hi;
  const uint64_t t2_hi = __umul64hi(lo, ratio_hi);
  const uint64_t tmp1 = t2_lo + carry;
  const uint64_t tmp3 = t2_hi + (tmp1 < t2_lo ? 1 : 0);
  const uint64_t t4_lo = hi * ratio_lo;
  const uint64_t t4_hi = __umul64hi(hi, ratio_lo);
  const uint64_t tmp1b = tmp1 + t4_lo;
  const uint64_t carry4 = t4_hi + (tmp1b < t4_lo ? 1 : 0);
  const uint64_t quot = hi * ratio_hi + tmp3 + carry4;
  const uint64_t r = lo - quot * q;
  return r >= q ? r - q : r;
}
