// Kernel F: the decomposition-mode scan's upper levels and the reply's mod
// switch.
//
// Replaces code that pir_tpu leaves to XLA, not a Pallas body: the digit
// decomposition and lift of pir_tpu/ops/scan.py::database_scan_decomp's
// upper levels (with pir_tpu/ops/decompose.py::decompose_ct), their
// companion-free contraction (pir_tpu/ops/scan.py::contract_dim without
// items_shoup), the planes layout's transposing split
// (pir_tpu/ops/scan.py::items_to_planes with pallas_scan.split_planes) and
// pir_tpu/ops/modswitch.py::mod_switch_to.  One upper-level step over the
// digit columns [c0, c1) is
//
//   F1 pir_digits_lift   items[.., p, c, d, l] = digit c of lower ct (p, d), every limb l
//   -- kernel A forward over q on the items [.., P, D, L, N]
//   F2 pir_contract      acc[p, k, j] = sum_d sv[d, k, j] * items[p, d, j] mod q_j
//   or F4 pir_split_planes, then kernel B (the planes layout's contraction)
//   -- kernel A inverse over q
//
// and a reply's limbs L' -> keep is one F3 pir_mod_switch.
//
// Every word is a u64 residue below 2^61; tensors are row-major.  The
// moduli arrive as u64 [L, 3] tables of (q, floor(2^128/q) hi word, lo
// word) rows.
//
// F1 gives a thread one digit word of one lower ciphertext: it reads the
// coefficient word its column names in a per-column table (source row =
// poly * L + limb, shift, width: the two polynomials' (limb, digit) pairs in
// decompose_ct's order, widths per limb as ops/decompose.py::digit_widths
// sets them), and writes (word >> shift) & mask into all L limbs of its
// item.  That is the decomposition, the (lower-ct, digit) column
// flattening, the transpose and the broadcast lift in one write, in the
// layout kernel A's forward takes as it is.
//
// F2 is the exact wide contraction of csrc/contract.cuh, kernel E2's, with
// x = the items [P, D, L, N] and w = the selection vector [D, 2, L, N]:
// exact sums of `chunk` rows (ops/scan_kernel.py::contract_chunk), each
// reduced and added mod q, as scan_kernel.sum_row_chunks adds the plain
// version's reduced partials.  A reduced residue is unique, so the words are
// the plain version's.
//
// F3 gives a thread one coefficient column of one ciphertext polynomial:
// it holds the column's L' words in registers and runs pir_tpu's drops in
// its order (the last limb first, down to `keep`), each an add of the
// dropped prime's half, a one-word Barrett reduction mod every remaining
// q_j, two subtractions and a Shoup product by q_last^-1 — the words of the
// plain version's limb-by-limb loop.  The per-stage constants are one table
// for the whole chain (stage s's constants depend only on q_0..q_s).
//
// F4 gives a thread one output word of the planes [P, L, D, N]: it reads
// item [p, d, l, n] and writes its low 32 bits and, with a hi plane, bits
// 32.. as one or two bytes.
//
// What bounds them on the H100: bytes for F1, F2 and F4 (8 bytes read and
// L * 8 written a digit; F2 reads 8-16 bytes a product for 7-12 multiplies; F4
// 8 bytes in, 4-6 out), and multiplies for F3 at the large chains (28 a
// limb update, L'^2 / 2 updates a column).

#include <cstdint>

#include <cuda_runtime.h>

#include "contract.cuh"
#include "modarith.cuh"

namespace {

constexpr int kThreads = 256;  // F1, F3, F4
constexpr int kMaxLimbs = 32;  // F3: the words a thread holds

// F1: in is the lower ciphertexts [lead, prefix * dim, C, 2, L, N];
// cols [er2, 3] the per-column (source row, shift, width); out
// [lead, prefix, k, dim, L, N] for the columns [c0, c0 + k) of C * er2.
__global__ void __launch_bounds__(kThreads)
digits_lift_kernel(const uint64_t* __restrict__ in, const int64_t* __restrict__ cols,
                   uint64_t* __restrict__ out, int64_t lead_prefix, int64_t dim, int64_t C,
                   int L, int64_t N, int64_t c0, int64_t k, int64_t er2) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= lead_prefix * k * dim * N) return;
  const int64_t n = idx % N;
  int64_t t = idx / N;
  const int64_t d = t % dim;
  t /= dim;
  const int64_t kk = t % k;
  const int64_t bp = t / k;  // lead * prefix + p
  const int64_t c = c0 + kk;
  const int64_t* col = cols + 3 * (c % er2);
  const uint64_t* src =
      in + (((bp * dim + d) * C + c / er2) * 2 * L + col[0]) * N + n;
  const uint64_t word = (__ldg(src) >> col[1]) & ((uint64_t{1} << col[2]) - 1);
  uint64_t* o = out + ((bp * k + kk) * dim + d) * L * N + n;
  for (int l = 0; l < L; ++l) o[static_cast<int64_t>(l) * N] = word;
}

// F3's constants for dropping limb s (of s + 1): q_s and its half, then for
// each remaining limb j < s the five words (q_j, floor(2^64 / q_j),
// half mod q_j, q_s^-1 mod q_j, its Shoup companion); stages 1, 2, ... one
// after another.
__host__ __device__ constexpr int64_t stage_offset(int s) {
  return 2 * static_cast<int64_t>(s - 1) + 5 * static_cast<int64_t>(s - 1) * s / 2;
}

// F3: in [R, cur, N], out [R, keep, N].
__global__ void __launch_bounds__(kThreads)
mod_switch_kernel(const uint64_t* __restrict__ in, const uint64_t* __restrict__ consts,
                  uint64_t* __restrict__ out, int64_t R, int cur, int keep, int64_t N) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= R * N) return;
  const int64_t n = idx % N;
  const int64_t r = idx / N;
  uint64_t w[kMaxLimbs];
#pragma unroll
  for (int l = 0; l < kMaxLimbs; ++l)
    w[l] = l < cur ? in[(r * cur + l) * N + n] : 0;
#pragma unroll
  for (int s = kMaxLimbs - 1; s >= 1; --s) {
    if (s < cur && s >= keep) {
      const uint64_t* c = consts + stage_offset(s);
      const uint64_t last_half = add_mod(w[s], __ldg(c + 1), __ldg(c));
#pragma unroll
      for (int j = 0; j < s; ++j) {
        const uint64_t* cj = c + 2 + 5 * j;
        const uint64_t q = __ldg(cj);
        const uint64_t tmp = sub_mod(barrett_reduce_64(last_half, q, __ldg(cj + 1)),
                                     __ldg(cj + 2), q);
        w[j] = mul_shoup(sub_mod(w[j], tmp, q), __ldg(cj + 3), __ldg(cj + 4), q);
      }
    }
  }
#pragma unroll
  for (int l = 0; l < kMaxLimbs; ++l)
    if (l < keep) out[(r * keep + l) * N + n] = w[l];
}

// F4: items [P, D, L, N] -> lo u32 [P, L, D, N] and, where hi_bytes is 1
// or 2, hi (u8 or u16) [P, L, D, N].
__global__ void __launch_bounds__(kThreads)
split_planes_kernel(const uint64_t* __restrict__ items, uint32_t* __restrict__ lo,
                    void* __restrict__ hi, int hi_bytes, int64_t P, int64_t D, int L,
                    int64_t N) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= P * L * D * N) return;
  const int64_t n = idx % N;
  int64_t t = idx / N;
  const int64_t d = t % D;
  t /= D;
  const int64_t l = t % L;
  const int64_t p = t / L;
  const uint64_t w = items[((p * D + d) * L + l) * N + n];
  lo[idx] = static_cast<uint32_t>(w);
  if (hi_bytes == 1)
    static_cast<uint8_t*>(hi)[idx] = static_cast<uint8_t>(w >> 32);
  else if (hi_bytes == 2)
    static_cast<uint16_t*>(hi)[idx] = static_cast<uint16_t>(w >> 32);
}

unsigned blocks_for(int64_t work, int threads) {
  return static_cast<unsigned>((work + threads - 1) / threads);
}

bool bad_grid(int64_t work, int threads) {
  return work < 1 || (work + threads - 1) / threads > 0x7fffffff;
}

}  // namespace

extern "C" {

// F1.  Returns cudaGetLastError(), or cudaErrorInvalidValue for work the
// kernel does not take.
int pir_digits_lift(const void* in, const void* cols, void* out, int64_t lead_prefix,
                    int64_t dim, int64_t C, int L, int64_t N, int64_t c0, int64_t k,
                    int64_t er2, void* stream) {
  const int64_t work = lead_prefix * k * dim * N;
  if (bad_grid(work, kThreads) || L < 1 || er2 < 1 || c0 < 0 || c0 + k > C * er2)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = blocks_for(work, kThreads);
  digits_lift_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(in), static_cast<const int64_t*>(cols),
      static_cast<uint64_t*>(out), lead_prefix, dim, C, L, N, c0, k, er2);
  return static_cast<int>(cudaGetLastError());
}

// F2: the contraction of items [P, D, L, N] with sv [D, 2, L, N] into
// [P, 2, L, N], `chunk` rows a reduction, laid out by
// ops/scan_kernel.py::contract_plan (csrc/contract.cuh::run).
int pir_contract(const void* items, const void* sv, const void* lq, void* out, int64_t P,
                 int64_t D, int L, int64_t N, int64_t chunk, int path, int rows, int terms,
                 int coeff_warps, int splits, int stages, int shared_bytes, int64_t grid_x,
                 int grid_y, void* stream) {
  if (D > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  return contract::run(items, sv, lq, out, P, static_cast<int>(D), L, N, chunk, path, rows, terms,
                       coeff_warps, splits, stages, shared_bytes, grid_x, grid_y, stream);
}

// F3.
int pir_mod_switch(const void* in, const void* consts, void* out, int64_t R, int cur, int keep,
                   int64_t N, void* stream) {
  if (bad_grid(R * N, kThreads) || cur > kMaxLimbs || keep < 1 || keep >= cur)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = blocks_for(R * N, kThreads);
  mod_switch_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(in), static_cast<const uint64_t*>(consts),
      static_cast<uint64_t*>(out), R, cur, keep, N);
  return static_cast<int>(cudaGetLastError());
}

// F4.
int pir_split_planes(const void* items, void* lo, void* hi, int hi_bytes, int64_t P, int64_t D,
                     int L, int64_t N, void* stream) {
  const int64_t work = P * D * L * N;
  if (bad_grid(work, kThreads) || hi_bytes < 0 || hi_bytes > 2 || (hi_bytes > 0) != (hi != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = blocks_for(work, kThreads);
  split_planes_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(items), static_cast<uint32_t*>(lo), hi, hi_bytes, P, D, L, N);
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
