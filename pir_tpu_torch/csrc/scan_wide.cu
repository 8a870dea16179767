// Kernel C: the database scan contraction for a batch of queries, widened to
// S selection-vector columns.
//
// Replaces pir_tpu/ops/pallas_scan.py::_raw_kernel_wide (K4) and, without a
// hi plane, ::_raw_kernel_wide_u32 (K4-u32, the tpu32 profile's moduli below
// 2^32), reached through contract_dim_raw_wide / contract_dim_wide_auto.
// Batched serving folds B queries into S = 2B columns of one inner scan:
//
//   out[p, s, l, n] = sum_j sv[j, s, l, n] * db[p, l, j, n]  mod q_l
//
// for any S >= 1, moduli below 2^48, one reduction per output.
//
// Layout: as kernel B (csrc/scan.cu): sv is u64 [D, S, L, N]; the database
// is a u8/u16 hi plane (none below 2^32) and a u32 lo plane, both
// [P, L, D_total, N], read over rows [j_begin, j_begin + D); the moduli come
// as a u64 [L, 3] table of (q, floor(2^128/q) hi word, lo word).
//
// What it keeps from K4: ONE pass over the database planes serves every
// column of the batch.  A block owns kTP prefixes x kNB coefficients of one
// limb, stages that database slab in shared memory kDC rows at a time, and
// its warps walk the columns in register tiles of kTS (one tile per warp,
// up to kGroups warps = 32 columns), each tile against the staged words.  So
// each database word leaves device memory once per call for S <= 32 (for
// wider S, once per 32 columns); each selection-vector word is read by the
// ceil(P / kTP) blocks of its (coefficient tile, limb), which run side by
// side (prefix tiles are the grid's fastest axis) and share it through L2.
//
// What bounds it on the H100: arithmetic and the selection vector, not
// device memory.  The sum is kept exact in a three-word (96-bit)
// accumulator: with moduli below 2^b and D <= 2^(96-2b) rows
// (pallas_scan.max_raw_chunk) it cannot wrap.  A product of x = xh:xl and
// w = wh:wl (16:32-bit halves) adds in 8 multiply-adds with the carry chain
// (mad.cc / madc), against about 14 for a 64x64->128 product and a 128-bit
// add; without a hi plane it is 3.  At the batched bench shape (P = D = 162,
// S = 32, L = 2, N = 4096: 6.9e9 products) it took 6.40 ms against 15.52 ms
// for 16 calls of kernel B on the same columns, and 5.16 ms against 8.92 ms
// at the tpu32 shape (L = 3), reading the planes at 168 and 250 GB/s
// (NVIDIA H100 80GB HBM3, 700 W).  Each selection-vector word is read by
// ceil(P / kTP) = 41 prefix tiles, from L2.  The tile, 4 prefixes x 4
// columns (48 accumulator registers), fits 128 registers without spills, so
// two blocks share an SM; 8 x 4 and 6 x 4 tiles spilled, and 8 x 2 or
// 12 x 2 tiles over 16 warps were no faster.

#include <cstdint>

#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

constexpr int kNB = 32;      // coefficients per block (one warp's lanes)
constexpr int kGroups = 8;   // column tiles per block pass (one warp each)
constexpr int kTS = 4;       // columns per thread
constexpr int kTP = 4;       // prefixes per block
constexpr int kDC = 16;      // database rows staged per step

template <int kHiBytes>
struct HiWord {
  using type = uint8_t;  // also the placeholder type when there is no plane
};
template <>
struct HiWord<2> {
  using type = uint16_t;
};

// (a2:a1:a0) += (xh:xl) * (wh:wl), 96-bit wrap; xh, wh < 2^16.
__device__ __forceinline__ void mac96(uint32_t& a0, uint32_t& a1, uint32_t& a2,
                                      uint32_t xl, uint32_t xh, uint32_t wl,
                                      uint32_t wh) {
  asm("mad.lo.cc.u32 %0, %3, %5, %0;\n\t"
      "madc.hi.cc.u32 %1, %3, %5, %1;\n\t"
      "addc.u32 %2, %2, 0;\n\t"
      "mad.lo.cc.u32 %1, %3, %6, %1;\n\t"
      "madc.hi.u32 %2, %3, %6, %2;\n\t"
      "mad.lo.cc.u32 %1, %4, %5, %1;\n\t"
      "madc.hi.u32 %2, %4, %5, %2;\n\t"
      "mad.lo.u32 %2, %4, %6, %2;"
      : "+r"(a0), "+r"(a1), "+r"(a2)
      : "r"(xl), "r"(xh), "r"(wl), "r"(wh));
}

// (a2:a1:a0) += x * w for single words x, w (the no-hi-plane variant).
__device__ __forceinline__ void mac32(uint32_t& a0, uint32_t& a1, uint32_t& a2,
                                      uint32_t x, uint32_t w) {
  asm("mad.lo.cc.u32 %0, %3, %4, %0;\n\t"
      "madc.hi.cc.u32 %1, %3, %4, %1;\n\t"
      "addc.u32 %2, %2, 0;"
      : "+r"(a0), "+r"(a1), "+r"(a2)
      : "r"(x), "r"(w));
}

// grid (ceil(P / kTP), ceil(N / kNB), L * passes), block (kNB, groups):
// pass k covers columns [k * groups * kTS, (k + 1) * groups * kTS).
template <int kHiBytes>
__global__ void __launch_bounds__(kNB * kGroups, 2)
scan_wide_kernel(const uint64_t* __restrict__ sv,
                 const typename HiWord<kHiBytes>::type* __restrict__ db_hi,
                 const uint32_t* __restrict__ db_lo,
                 const uint64_t* __restrict__ consts,
                 uint64_t* __restrict__ out, int64_t P, int S, int L,
                 int64_t d_total, int64_t j_begin, int64_t D, int64_t N) {
  using HiT = typename HiWord<kHiBytes>::type;
  constexpr bool kHasHi = kHiBytes > 0;
  __shared__ uint32_t lo_s[kDC][kTP][kNB];
  __shared__ HiT hi_s[kHasHi ? kDC : 1][kTP][kNB];

  const int lane = threadIdx.x;
  const int groups = blockDim.y;
  const int tid = threadIdx.y * kNB + lane;
  const int nthreads = groups * kNB;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kTP;
  const int64_t n0 = static_cast<int64_t>(blockIdx.y) * kNB;
  const int l = blockIdx.z % L;
  const int s0 = (blockIdx.z / L) * groups * kTS + threadIdx.y * kTS;
  const int64_t n = n0 + lane;
  const int64_t n_in = n < N ? n : N - 1;  // loads stay in bounds; no store

  // selection-vector words of this thread's columns (clamped to S - 1; the
  // extra columns are computed and dropped)
  const int64_t sv_row = static_cast<int64_t>(S) * L * N;
  const uint64_t* svp[kTS];
#pragma unroll
  for (int t = 0; t < kTS; ++t) {
    const int s = s0 + t < S ? s0 + t : S - 1;
    svp[t] = sv + (static_cast<int64_t>(s) * L + l) * N + n_in;
  }

  uint32_t acc[kTP][kTS][3];
#pragma unroll
  for (int p = 0; p < kTP; ++p)
#pragma unroll
    for (int t = 0; t < kTS; ++t) acc[p][t][0] = acc[p][t][1] = acc[p][t][2] = 0;

  for (int64_t j0 = 0; j0 < D; j0 += kDC) {
    // stage rows [j0, j0 + kDC) of the block's kTP prefixes; zeros past
    // the ends contribute nothing
    for (int e = tid; e < kDC * kTP * kNB; e += nthreads) {
      const int nn = e % kNB;
      const int tp = (e / kNB) % kTP;
      const int jj = e / (kNB * kTP);
      const int64_t p = p0 + tp;
      const int64_t j = j0 + jj;
      uint32_t w_lo = 0;
      HiT w_hi = 0;
      if (p < P && j < D && n0 + nn < N) {
        const int64_t idx = ((p * L + l) * d_total + j_begin + j) * N + n0 + nn;
        w_lo = db_lo[idx];
        if constexpr (kHasHi) w_hi = db_hi[idx];
      }
      lo_s[jj][tp][nn] = w_lo;
      if constexpr (kHasHi) hi_s[jj][tp][nn] = w_hi;
    }
    __syncthreads();

    const int rows = D - j0 < kDC ? static_cast<int>(D - j0) : kDC;
    for (int jj = 0; jj < rows; ++jj) {
      const int64_t off = (j0 + jj) * sv_row;
      uint32_t xl[kTS], xh[kTS];
#pragma unroll
      for (int t = 0; t < kTS; ++t) {
        const uint64_t x = svp[t][off];
        xl[t] = static_cast<uint32_t>(x);
        xh[t] = static_cast<uint32_t>(x >> 32);
      }
#pragma unroll
      for (int p = 0; p < kTP; ++p) {
        const uint32_t wl = lo_s[jj][p][lane];
        if constexpr (kHasHi) {
          const uint32_t wh = hi_s[jj][p][lane];
#pragma unroll
          for (int t = 0; t < kTS; ++t)
            mac96(acc[p][t][0], acc[p][t][1], acc[p][t][2], xl[t], xh[t], wl, wh);
        } else {
#pragma unroll
          for (int t = 0; t < kTS; ++t)
            mac32(acc[p][t][0], acc[p][t][1], acc[p][t][2], xl[t], wl);
        }
      }
    }
    __syncthreads();
  }

  if (n >= N) return;
  const uint64_t q = consts[3 * l];
  const uint64_t rh = consts[3 * l + 1];
  const uint64_t rl = consts[3 * l + 2];
#pragma unroll
  for (int p = 0; p < kTP; ++p) {
#pragma unroll
    for (int t = 0; t < kTS; ++t) {
      const int64_t pp = p0 + p;
      const int s = s0 + t;
      if (pp < P && s < S) {
        const uint64_t lo = (static_cast<uint64_t>(acc[p][t][1]) << 32) | acc[p][t][0];
        out[((pp * S + s) * L + l) * N + n] =
            barrett_reduce_128(acc[p][t][2], lo, q, rh, rl);
      }
    }
  }
}

}  // namespace

extern "C" {

// out[P, S, L, N] = contraction of sv[D, S, L, N] with planes
// [P, L, d_total, N] over j in [j_begin, j_begin + D).  hi_bytes is the hi
// plane's element size: 1 or 2, or 0 for no hi plane (db_hi unused, moduli
// below 2^32).  D <= 2^(96 - 2 * bits) keeps the 96-bit sums exact (the
// caller chunks).  Returns cudaGetLastError().
int pir_scan_wide(const void* sv, const void* db_hi, const void* db_lo,
                  const void* consts, void* out, int hi_bytes, int64_t P, int S,
                  int L, int64_t d_total, int64_t j_begin, int64_t D, int64_t N,
                  void* stream) {
  if (S < 1 || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (S + kTS - 1) / kTS < kGroups ? (S + kTS - 1) / kTS : kGroups;
  const int passes = (S + groups * kTS - 1) / (groups * kTS);
  const dim3 grid(static_cast<unsigned>((P + kTP - 1) / kTP),
                  static_cast<unsigned>((N + kNB - 1) / kNB),
                  static_cast<unsigned>(L * passes));
  const dim3 block(kNB, groups);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const uint64_t*>(sv);
  const auto* lo = static_cast<const uint32_t*>(db_lo);
  const auto* c = static_cast<const uint64_t*>(consts);
  auto* y = static_cast<uint64_t*>(out);
  if (hi_bytes == 0) {
    scan_wide_kernel<0><<<grid, block, 0, s>>>(
        x, nullptr, lo, c, y, P, S, L, d_total, j_begin, D, N);
  } else if (hi_bytes == 1) {
    scan_wide_kernel<1><<<grid, block, 0, s>>>(
        x, static_cast<const uint8_t*>(db_hi), lo, c, y, P, S, L, d_total,
        j_begin, D, N);
  } else if (hi_bytes == 2) {
    scan_wide_kernel<2><<<grid, block, 0, s>>>(
        x, static_cast<const uint16_t*>(db_hi), lo, c, y, P, S, L, d_total,
        j_begin, D, N);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
