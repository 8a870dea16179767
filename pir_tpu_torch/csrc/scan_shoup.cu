// Kernel D: the database scan over the Shoup-table database.
//
// Replaces pir_tpu/ops/pallas_scan.py::_scan_kernel (K7), reached through
// contract_dim_pallas, which computes pir_tpu/ops/scan.py::contract_dim
// with Shoup companions — the inner scan of a database held as NTT-form u64
// words plus their Shoup companions (PirDatabase scan_impl="xla", any
// modulus below 2^61):
//
//   out[p, s, l, n] = sum_j sv[j, s, l, n] * db[p, j, l, n]  mod q_l
//
// for s in {0, 1}.  Layout: sv is u64 [D, 2, L, N], db and its companions
// db_shoup = floor(db * 2^64 / q) are u64 [P, D, L, N], out is u64
// [P, 2, L, N].  The moduli arrive as the u64 [L, 3] table kernel B reads
// (q, floor(2^128/q) hi word, lo word).
//
// On the TPU the kernel walked (prefix, N-tile) in order with a u32-pair
// accumulator and never chunked D, so it was exact only while D * q < 2^64.
// Here each product is reduced by Shoup's method against the stored
// companion (one __umul64hi and two low products, one conditional
// subtract), the reduced products go into a u64 sum, and every `chunk` =
// 2^(63 - bits) rows the sum is folded by a Barrett reduction into a reduced
// accumulator with a modular add — pir_tpu's scan.contract_dim chunking — so
// any D is exact and every output is fully reduced.
//
// Design: one thread per (n, l) and a tile of kPTile prefixes, both
// ciphertext halves.  Each thread loads the two selection-vector words of
// row j once and reuses them for every prefix of its tile; each database
// word and its companion are read exactly once.  Consecutive threads take
// consecutive n, so a warp's loads are contiguous.
//
// What bounds it on the H100: bytes.  The companion table doubles the
// database to 16 bytes a coefficient: at the inner scan of 2^20 items of
// 288 B (db and companions [162, 162, 2, 4096]) it reads 3.44 GB, 1.03 ms
// at 3.35 TB/s, against about 16 32-bit multiplies per product (0.4 ms at
// the card's IMAD rate).  The selection vector (21 MB) stays in L2.

#include <cstdint>

#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

constexpr int kPTile = 4;
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
scan_shoup_kernel(const uint64_t* __restrict__ sv,
                  const uint64_t* __restrict__ db,
                  const uint64_t* __restrict__ db_shoup,
                  const uint64_t* __restrict__ consts,
                  uint64_t* __restrict__ out, int64_t P, int64_t D, int L,
                  int64_t N, int64_t chunk) {
  const int64_t n = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (n >= N) return;
  const int l = blockIdx.y;
  const int64_t p0 = static_cast<int64_t>(blockIdx.z) * kPTile;
  const uint64_t q = consts[3 * l];
  const uint64_t ratio_hi = consts[3 * l + 1];

  uint64_t acc0[kPTile], acc1[kPTile], sum0[kPTile], sum1[kPTile];
#pragma unroll
  for (int t = 0; t < kPTile; ++t) acc0[t] = acc1[t] = sum0[t] = sum1[t] = 0;

  const int64_t row = static_cast<int64_t>(L) * N;  // stride of j
  const uint64_t* sv0 = sv + static_cast<int64_t>(l) * N + n;
  const uint64_t* sv1 = sv0 + row;
  const int64_t db_p = D * row;  // stride of p
  const int64_t db_base = p0 * db_p + static_cast<int64_t>(l) * N + n;

  int64_t left = chunk;
  for (int64_t j = 0; j < D; ++j) {
    const uint64_t x0 = sv0[2 * j * row];
    const uint64_t x1 = sv1[2 * j * row];
    const int64_t off = db_base + j * row;
#pragma unroll
    for (int t = 0; t < kPTile; ++t) {
      if (p0 + t < P) {
        const uint64_t w = db[off + t * db_p];
        const uint64_t ws = db_shoup[off + t * db_p];
        sum0[t] += mul_shoup(x0, w, ws, q);
        sum1[t] += mul_shoup(x1, w, ws, q);
      }
    }
    if (--left == 0 || j == D - 1) {
#pragma unroll
      for (int t = 0; t < kPTile; ++t) {
        acc0[t] = add_mod(acc0[t], barrett_reduce_64(sum0[t], q, ratio_hi), q);
        acc1[t] = add_mod(acc1[t], barrett_reduce_64(sum1[t], q, ratio_hi), q);
        sum0[t] = sum1[t] = 0;
      }
      left = chunk;
    }
  }

#pragma unroll
  for (int t = 0; t < kPTile; ++t) {
    const int64_t p = p0 + t;
    if (p < P) {
      uint64_t* o = out + (p * 2 * L + l) * N + n;
      o[0] = acc0[t];
      o[row] = acc1[t];
    }
  }
}

}  // namespace

extern "C" {

// out[P, 2, L, N] = contraction of sv[D, 2, L, N] with db / db_shoup
// [P, D, L, N]; a u64 sum is folded every `chunk` rows (chunk * q < 2^63).
// Returns cudaGetLastError().
int pir_scan_shoup(const void* sv, const void* db, const void* db_shoup,
                   const void* consts, void* out, int64_t P, int64_t D, int L,
                   int64_t N, int64_t chunk, void* stream) {
  if (chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((N + kThreads - 1) / kThreads),
                  static_cast<unsigned>(L),
                  static_cast<unsigned>((P + kPTile - 1) / kPTile));
  scan_shoup_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(sv), static_cast<const uint64_t*>(db),
      static_cast<const uint64_t*>(db_shoup),
      static_cast<const uint64_t*>(consts), static_cast<uint64_t*>(out), P, D,
      L, N, chunk);
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
