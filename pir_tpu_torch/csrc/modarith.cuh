// Modular helpers shared by the kernels (csrc/ntt.cu, csrc/scan.cu,
// csrc/scan_wide.cu, csrc/scan_shoup.cu, csrc/keyswitch.cu, csrc/upper.cu,
// csrc/contract.cuh).
// Every modulus is below 2^61.
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

// Port of pir_tpu/ops/wide32.py::barrett_reduce96: barrett_reduce_128 with
// hi = x2 < 2^32, so hi's two products are 32 x 64 (two 32 x 32 products
// each); the value x2 * 2^64 + lo modulo q.
__device__ __forceinline__ uint64_t barrett_reduce_96(uint32_t x2, uint64_t lo, uint64_t q,
                                                      uint64_t ratio_hi, uint64_t ratio_lo) {
  const uint64_t carry = __umul64hi(lo, ratio_lo);
  const uint64_t t2_lo = lo * ratio_hi;
  const uint64_t t2_hi = __umul64hi(lo, ratio_hi);
  const uint64_t tmp1 = t2_lo + carry;
  const uint64_t tmp3 = t2_hi + (tmp1 < t2_lo ? 1 : 0);
  // x2 * ratio_lo = (t4_hi : t4_lo), from x2 * (ratio_lo's two halves)
  const uint64_t p0 = static_cast<uint64_t>(x2) * static_cast<uint32_t>(ratio_lo);
  const uint64_t p1 = static_cast<uint64_t>(x2) * static_cast<uint32_t>(ratio_lo >> 32) + (p0 >> 32);
  const uint64_t t4_lo = (p1 << 32) | static_cast<uint32_t>(p0);
  const uint64_t t4_hi = p1 >> 32;
  const uint64_t tmp1b = tmp1 + t4_lo;
  const uint64_t carry4 = t4_hi + (tmp1b < t4_lo ? 1 : 0);
  const uint64_t quot = static_cast<uint64_t>(x2) * ratio_hi + tmp3 + carry4;
  const uint64_t r = lo - quot * q;
  return r >= q ? r - q : r;
}

// The same value x2 * 2^64 + lo (x2 < 2^32) modulo q in (2^32, 2^48] with
// the one-word ratio floor(2^96 / q): the quotient taken from x's top 64
// bits falls short by under 1 for the ratio's rounding, under 2^32 / q < 1
// for the dropped low word and under 1 for its own, so at most 2, and
// x - quot * q < 3q; a 2q subtract (reached only for x near 2^96 with q
// near 2^32) and a q subtract end it.  Half barrett_reduce_96's multiplies.
__device__ __forceinline__ uint64_t barrett_reduce_96_short(uint32_t x2, uint64_t lo, uint64_t q,
                                                            uint64_t ratio96) {
  const uint64_t top = (static_cast<uint64_t>(x2) << 32) | (lo >> 32);
  uint64_t r = lo - __umul64hi(top, ratio96) * q;
  if (r >= 2 * q) r -= 2 * q;
  return r >= q ? r - q : r;
}

// Port of pir_tpu/ops/modular.py::barrett_reduce_64: x mod q with
// ratio_hi = floor(2^64 / q) (the high word of floor(2^128 / q)).
__device__ __forceinline__ uint64_t barrett_reduce_64(uint64_t x, uint64_t q,
                                                      uint64_t ratio_hi) {
  const uint64_t r = x - __umul64hi(x, ratio_hi) * q;
  return r >= q ? r - q : r;
}

// x * w mod q by Shoup's method, w_shoup = floor(w * 2^64 / q), x < 2^64:
// one high product against the companion, two low products, one
// conditional subtract.
__device__ __forceinline__ uint64_t mul_shoup(uint64_t x, uint64_t w,
                                              uint64_t w_shoup, uint64_t q) {
  const uint64_t est = __umul64hi(x, w_shoup);
  const uint64_t r = x * w - est * q;
  return r >= q ? r - q : r;
}

__device__ __forceinline__ uint64_t add_mod(uint64_t a, uint64_t b,
                                            uint64_t q) {
  const uint64_t s = a + b;
  return s >= q ? s - q : s;
}

// a - b mod q for a, b < q.
__device__ __forceinline__ uint64_t sub_mod(uint64_t a, uint64_t b, uint64_t q) {
  return a >= b ? a - b : a + q - b;
}

// The scans' and the wide contraction's exact sums (csrc/scan.cu,
// csrc/scan_wide.cu, csrc/contract.cuh), three 32-bit words with the carry
// chain (mad.cc / madc):
// (a2:a1:a0) += (xh:xl) * (wh:wl), 96-bit wrap; xh, wh < 2^16.  Seven
// multiply-adds: the low product's carry out of a1 enters a2 with xh * wh
// (< 2^32), then the two cross products go into a1:a2.
__device__ __forceinline__ void mac96(uint32_t& a0, uint32_t& a1, uint32_t& a2,
                                      uint32_t xl, uint32_t xh, uint32_t wl,
                                      uint32_t wh) {
  asm("mad.lo.cc.u32 %0, %3, %5, %0;\n\t"
      "madc.hi.cc.u32 %1, %3, %5, %1;\n\t"
      "madc.lo.u32 %2, %4, %6, %2;\n\t"
      "mad.lo.cc.u32 %1, %3, %6, %1;\n\t"
      "madc.hi.u32 %2, %3, %6, %2;\n\t"
      "mad.lo.cc.u32 %1, %4, %5, %1;\n\t"
      "madc.hi.u32 %2, %4, %5, %2;"
      : "+r"(a0), "+r"(a1), "+r"(a2)
      : "r"(xl), "r"(xh), "r"(wl), "r"(wh));
}

// (a3:a2:a1:a0) += (xh:xl) * (wh:wl), 128-bit wrap: the 64 x 64 product
// as four 32 x 32 products on the carry chain, ten instructions: the wide
// contraction's sums above 48-bit moduli (csrc/contract.cuh), faster there
// than a 64-bit low and high product added in (contract_variants.py).
__device__ __forceinline__ void mac128w(uint32_t& a0, uint32_t& a1, uint32_t& a2, uint32_t& a3,
                                        uint32_t xl, uint32_t xh, uint32_t wl, uint32_t wh) {
  asm("mad.lo.cc.u32 %0, %4, %6, %0;\n\t"
      "madc.hi.cc.u32 %1, %4, %6, %1;\n\t"
      "madc.lo.cc.u32 %2, %5, %7, %2;\n\t"
      "madc.hi.u32 %3, %5, %7, %3;\n\t"
      "mad.lo.cc.u32 %1, %4, %7, %1;\n\t"
      "madc.hi.cc.u32 %2, %4, %7, %2;\n\t"
      "addc.u32 %3, %3, 0;\n\t"
      "mad.lo.cc.u32 %1, %5, %6, %1;\n\t"
      "madc.hi.cc.u32 %2, %5, %6, %2;\n\t"
      "addc.u32 %3, %3, 0;"
      : "+r"(a0), "+r"(a1), "+r"(a2), "+r"(a3)
      : "r"(xl), "r"(xh), "r"(wl), "r"(wh));
}

// (a2:a1:a0) += x * w for single words x, w (no hi plane).
__device__ __forceinline__ void mac32(uint32_t& a0, uint32_t& a1, uint32_t& a2,
                                      uint32_t x, uint32_t w) {
  asm("mad.lo.cc.u32 %0, %3, %4, %0;\n\t"
      "madc.hi.cc.u32 %1, %3, %4, %1;\n\t"
      "addc.u32 %2, %2, 0;"
      : "+r"(a0), "+r"(a1), "+r"(a2)
      : "r"(x), "r"(w));
}
