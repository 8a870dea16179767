// Kernel B: the database scan contraction, exact 128-bit accumulation.
//
// Replaces pir_tpu/ops/pallas_scan.py::_raw_kernel (K1) and, without a hi
// plane, ::_raw_kernel_u32 (K5, the tpu32 profile's moduli below 2^32),
// reached through contract_dim_raw / contract_dim_auto, which compute both
// the inner scan over the whole database and every upper-dimension scan:
//
//   out[p, s, l, n] = sum_j sv[j, s, l, n] * db[p, l, j, n]  mod q_l
//
// for s in {0, 1}, moduli below 2^48, with one reduction per output.
//
// Layout: sv is u64 [D, 2, L, N] (the selection vector, NTT form); the
// database is split into a narrow hi plane (u8 for moduli of 33-40 bits, u16
// up to 48; none below 2^32) and a u32 lo plane, both [P, L, D_total, N], as
// pallas_scan.split_planes lays them out; the kernel reads j in
// [j_begin, j_begin + D).  The moduli arrive as a u64 [L, 3] tensor of
// (q, floor(2^128/q) hi word, lo word) rows, not as compile-time constants.
//
// Design: one thread per (n, l) and a tile of kPTile prefixes p.  Each
// thread loads the two selection-vector words of row j once and reuses them
// for every prefix of its tile, so each database word is read exactly once
// and the selection vector kPTile times less often.  Consecutive threads
// take consecutive n, so the lo/hi plane loads of a warp are contiguous.
// Products (< 2^96) accumulate in unsigned __int128 with no reduction; one
// Barrett reduction per output closes the sum.  D <= 2^16 keeps the sum far
// below 2^128.  Without a hi plane (K5) each product is one 32x32 multiply
// into the same accumulator, and the database is 4 bytes per coefficient.
//
// What bounds it on the H100: reading the database planes, 5 bytes per
// coefficient at the 36-bit chain (26,244 x 2 x 4096 x 5 B ~ 1.07 GB per
// request at 2^20 items of 288 B), against about 4 64-bit integer products
// per database word that the CUDA cores build from 32-bit IMADs.  The tile
// keeps selection-vector traffic (L2) below the database stream.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

constexpr int kPTile = 4;
constexpr int kThreads = 128;

// The "no hi plane" case: moduli below 2^32, one u32 word per coefficient.
struct NoHi {};

template <typename HiT>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const uint64_t* __restrict__ sv, const HiT* __restrict__ db_hi,
            const uint32_t* __restrict__ db_lo,
            const uint64_t* __restrict__ consts, uint64_t* __restrict__ out,
            int64_t P, int L, int64_t d_total, int64_t j_begin, int64_t D,
            int64_t N) {
  const int64_t n = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (n >= N) return;
  const int l = blockIdx.y;
  const int64_t p0 = static_cast<int64_t>(blockIdx.z) * kPTile;

  unsigned __int128 acc0[kPTile];
  unsigned __int128 acc1[kPTile];
#pragma unroll
  for (int t = 0; t < kPTile; ++t) acc0[t] = acc1[t] = 0;

  const int64_t sv_row = 2LL * L * N;  // stride of j in sv
  const uint64_t* sv0 = sv + static_cast<int64_t>(l) * N + n;
  const uint64_t* sv1 = sv0 + static_cast<int64_t>(L) * N;
  const int64_t db_p = static_cast<int64_t>(L) * d_total * N;  // stride of p
  const int64_t db_base = (p0 * L + l) * d_total * N + j_begin * N + n;

  for (int64_t j = 0; j < D; ++j) {
    const uint64_t x0 = sv0[j * sv_row];
    const uint64_t x1 = sv1[j * sv_row];
    const int64_t off = db_base + j * N;
#pragma unroll
    for (int t = 0; t < kPTile; ++t) {
      if (p0 + t < P) {
        const int64_t idx = off + t * db_p;
        if constexpr (std::is_same<HiT, NoHi>::value) {
          // K5: x, w < 2^32, so one 32x32 product is the whole of x * w
          const uint32_t w = db_lo[idx];
          acc0[t] += static_cast<uint64_t>(static_cast<uint32_t>(x0)) * w;
          acc1[t] += static_cast<uint64_t>(static_cast<uint32_t>(x1)) * w;
        } else {
          const uint64_t w =
              (static_cast<uint64_t>(db_hi[idx]) << 32) | db_lo[idx];
          acc0[t] += static_cast<unsigned __int128>(x0) * w;
          acc1[t] += static_cast<unsigned __int128>(x1) * w;
        }
      }
    }
  }

  const uint64_t q = consts[3 * l];
  const uint64_t rh = consts[3 * l + 1];
  const uint64_t rl = consts[3 * l + 2];
#pragma unroll
  for (int t = 0; t < kPTile; ++t) {
    const int64_t p = p0 + t;
    if (p < P) {
      uint64_t* o = out + ((p * 2) * L + l) * N + n;
      o[0] = barrett_reduce_128(static_cast<uint64_t>(acc0[t] >> 64),
                                static_cast<uint64_t>(acc0[t]), q, rh, rl);
      o[static_cast<int64_t>(L) * N] =
          barrett_reduce_128(static_cast<uint64_t>(acc1[t] >> 64),
                             static_cast<uint64_t>(acc1[t]), q, rh, rl);
    }
  }
}

}  // namespace

extern "C" {

// out[P, 2, L, N] = contraction of sv[D, 2, L, N] with planes
// [P, L, d_total, N] over j in [j_begin, j_begin + D).  hi_bytes is the hi
// plane's element size: 1 or 2, or 0 for no hi plane (db_hi unused, moduli
// below 2^32).  S must be 2.  Returns cudaGetLastError().
int pir_scan(const void* sv, const void* db_hi, const void* db_lo,
             const void* consts, void* out, int hi_bytes, int64_t P, int S,
             int L, int64_t d_total, int64_t j_begin, int64_t D, int64_t N,
             void* stream) {
  if (S != 2) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((N + kThreads - 1) / kThreads),
                  static_cast<unsigned>(L),
                  static_cast<unsigned>((P + kPTile - 1) / kPTile));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const uint64_t*>(sv);
  const auto* lo = static_cast<const uint32_t*>(db_lo);
  const auto* c = static_cast<const uint64_t*>(consts);
  auto* y = static_cast<uint64_t*>(out);
  if (hi_bytes == 0) {
    scan_kernel<NoHi><<<grid, kThreads, 0, s>>>(
        x, nullptr, lo, c, y, P, L, d_total, j_begin, D, N);
  } else if (hi_bytes == 1) {
    scan_kernel<uint8_t><<<grid, kThreads, 0, s>>>(
        x, static_cast<const uint8_t*>(db_hi), lo, c, y, P, L, d_total,
        j_begin, D, N);
  } else if (hi_bytes == 2) {
    scan_kernel<uint16_t><<<grid, kThreads, 0, s>>>(
        x, static_cast<const uint16_t*>(db_hi), lo, c, y, P, L, d_total,
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
