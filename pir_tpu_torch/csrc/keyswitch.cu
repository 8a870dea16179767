// Kernel E: the key switch and the oblivious expansion's combine step.
//
// Replaces code that pir_tpu leaves to XLA, not a Pallas body:
// pir_tpu/ops/keyswitch.py::switch_key, apply_galois and relinearize
// (compiled into one program per Galois element), and the doubling step of
// pir_tpu/ops/expand.py::expand_level.  One key-switch step over R rows
// (polynomials c, coefficient form) is
//
//   E1 pir_ks_decompose   digits[r, i, j] = (±c[r, i] permuted) mod qp_j
//   -- kernel A forward over QP on the digits [R, L, Lp, N]
//   E2 pir_ks_inner       acc[r, k, j] = sum_i digits[r, i, j] * key[i, k, j] mod qp_j
//   -- kernel A inverse over QP on acc [R, 2, Lp, N]
//   E3 pir_ks_moddown     out[r, k, j] = (acc_j - center(acc_P)) * P^-1 mod q_j (+ addend)
//   E4 pir_expand_combine upper = cts + sub, lower = cts x^-2^j + sub x^-(N+2^j)
//
// and an expansion level is E1, A, E2, A, E3, E4: six launches where the
// port's plain-torch key switch made about 270.
//
// Every word is a u64 residue below 2^61; tensors are row-major.  The moduli
// arrive as u64 [L, 3] tables of (q, floor(2^128/q) hi word, lo word) rows.
//
// E2 is the exact wide contraction of csrc/contract.cuh with x = the digits
// [R, L, Lp, N] and w = the key [L, 2, Lp, N]: one scheme for all three of
// pir_tpu's inner-product methods ("u32" for the tpu32 chain, "48-bit" for
// SEAL's 36/37-bit chain, "generic" up to 61 bits), since a reduced residue
// is unique.  The wrapper refuses a chain where L (q - 1)^2 reaches 2^127.
//
// Design: E1, E3 and E4 are element-wise, one thread per output word, a
// warp on 32 consecutive coefficients.  E1 gathers its input word through
// the Galois permutation (src, flip: the word, negated mod q_i where flip)
// and writes it reduced mod every key prime with a one-word Barrett
// reduction (exact for any 64-bit word).  E3 reads the special prime's limb
// and the output limb (limb offset + j of the key basis: a rank of a
// limb-sharded mesh keeps its own limbs), rounds to the centre in u64 and
// multiplies by P^-1 with its Shoup companion; an addend (apply_galois's
// permuted c0, relinearize's c0 and c1) is added mod q_j in the same pass,
// so the key switch writes the finished ciphertext.  E4 computes both
// negacyclic shifts' source index and sign from the shift itself and writes
// the doubled ciphertexts straight into their places (Q trees of B
// ciphertexts each -> [Q, 2B, ...]).
//
// What bounds it on the H100: bytes.  E1, E3 and E4 move 16-40 bytes a word
// for at most 28 32-bit multiplies; E2 moves the digits and the output (8
// bytes each) for 7-12 multiplies a product.

#include <cstdint>

#include <cuda_runtime.h>

#include "contract.cuh"
#include "modarith.cuh"

namespace {

constexpr int kThreads = 256;  // element-wise kernels

__device__ __forceinline__ uint64_t neg_if(uint64_t x, bool neg, uint64_t q) {
  return neg && x != 0 ? q - x : x;
}

// row[k] of x * x^-shift mod (x^N + 1), shift in [0, 2N): the source word
// (k + shift) mod N, negated where (k + shift) / N is odd.
__device__ __forceinline__ uint64_t shifted(const uint64_t* row, int64_t k,
                                            int64_t shift, int64_t N,
                                            uint64_t q) {
  const int64_t t = k + shift;
  return neg_if(row[t % N], (t / N) & 1, q);
}

// E1: in is c's rows, [R, L, N] words with rows in_row_stride apart; out is
// [R, L, Lp, N].  src/flip (or nullptr: the identity) permute each limb.
__global__ void __launch_bounds__(kThreads)
ks_decompose_kernel(const uint64_t* __restrict__ in, int64_t in_row_stride,
                    const int64_t* __restrict__ src,
                    const uint8_t* __restrict__ flip,
                    const uint64_t* __restrict__ q_in,
                    const uint64_t* __restrict__ qp, uint64_t* __restrict__ out,
                    int64_t R, int L, int Lp, int64_t N) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= R * L * N) return;
  const int64_t n = idx % N;
  const int64_t ri = idx / N;  // r * L + i
  const int i = static_cast<int>(ri % L);
  const uint64_t* row = in + (ri / L) * in_row_stride + i * N;
  const uint64_t x =
      src == nullptr ? row[n] : neg_if(row[src[n]], flip[n] != 0, q_in[3 * i]);
  uint64_t* o = out + ri * Lp * N + n;
  for (int j = 0; j < Lp; ++j)
    o[j * N] = barrett_reduce_64(x, qp[3 * j], qp[3 * j + 1]);
}

// E3: acc [R, 2, Lp, N] (coefficient form), out [R, 2, L, N]; output limb j
// is the key basis' limb offset + j.  add0/add1 (or nullptr) are [R, L, N]
// words with rows add_row_stride apart, permuted by src/flip when given.
__global__ void __launch_bounds__(kThreads)
ks_moddown_kernel(const uint64_t* __restrict__ acc,
                  const uint64_t* __restrict__ lq,
                  const uint64_t* __restrict__ p_half_mod_q,
                  const uint64_t* __restrict__ p_inv,
                  const uint64_t* __restrict__ p_inv_shoup,
                  const uint64_t* __restrict__ add0,
                  const uint64_t* __restrict__ add1, int64_t add_row_stride,
                  const int64_t* __restrict__ src,
                  const uint8_t* __restrict__ flip, uint64_t* __restrict__ out,
                  int64_t R, int L, int Lp, int offset, int64_t N, uint64_t P,
                  uint64_t p_half) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= R * 2 * L * N) return;
  const int64_t n = idx % N;
  const int64_t rest = idx / N;
  const int j = static_cast<int>(rest % L);
  const int64_t rk = rest / L;  // r * 2 + k
  const uint64_t* a = acc + rk * Lp * N;
  uint64_t u = a[static_cast<int64_t>(Lp - 1) * N + n] + p_half;
  if (u >= P) u -= P;
  const uint64_t q = lq[3 * j];
  const uint64_t t_bar = sub_mod(barrett_reduce_64(u, q, lq[3 * j + 1]), p_half_mod_q[j], q);
  const uint64_t v = sub_mod(a[static_cast<int64_t>(offset + j) * N + n], t_bar, q);
  uint64_t res = mul_shoup(v, p_inv[j], p_inv_shoup[j], q);
  const uint64_t* add = (rk & 1) == 0 ? add0 : add1;
  if (add != nullptr) {
    const uint64_t* row = add + (rk >> 1) * add_row_stride + static_cast<int64_t>(j) * N;
    res = add_mod(src == nullptr ? row[n] : neg_if(row[src[n]], flip[n] != 0, q), res, q);
  }
  out[idx] = res;
}

// E4: cts and sub [Q, B, polys, L, N], out [Q, 2B, polys, L, N]: out[:, b]
// = cts + sub, out[:, B + b] = cts x^-shift_a + sub x^-shift_b.
__global__ void __launch_bounds__(kThreads)
expand_combine_kernel(const uint64_t* __restrict__ cts,
                      const uint64_t* __restrict__ sub,
                      const uint64_t* __restrict__ lq, uint64_t* __restrict__ out,
                      int64_t Q, int64_t B, int polys, int L, int64_t N,
                      int64_t shift_a, int64_t shift_b) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t ct_words = static_cast<int64_t>(polys) * L * N;
  if (idx >= Q * B * ct_words) return;
  const int64_t n = idx % N;
  const int64_t row = idx / N;  // ((qq * B + b) * polys + s) * L + l
  const uint64_t q = lq[3 * (row % L)];
  const int64_t qb = idx / ct_words;
  const int64_t within = idx % ct_words - n;  // (s * L + l) * N
  const uint64_t* c = cts + row * N;
  const uint64_t* s = sub + row * N;
  const int64_t upper = ((qb / B) * 2 * B + qb % B) * ct_words + within;
  out[upper + n] = add_mod(c[n], s[n], q);
  out[upper + B * ct_words + n] =
      add_mod(shifted(c, n, shift_a, N, q), shifted(s, n, shift_b, N, q), q);
}

unsigned blocks_for(int64_t work, int threads) {
  return static_cast<unsigned>((work + threads - 1) / threads);
}

bool too_many_blocks(int64_t work, int threads) {
  return (work + threads - 1) / threads > 0x7fffffff;
}

}  // namespace

extern "C" {

// E1.  Returns cudaGetLastError(), or cudaErrorInvalidValue for a grid the
// card cannot launch.
int pir_ks_decompose(const void* in, int64_t in_row_stride, const void* src,
                     const void* flip, const void* q_in, const void* qp, void* out,
                     int64_t R, int L, int Lp, int64_t N, void* stream) {
  const int64_t work = R * L * N;
  if (work < 1 || too_many_blocks(work, kThreads)) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = blocks_for(work, kThreads);
  ks_decompose_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(in), in_row_stride, static_cast<const int64_t*>(src),
      static_cast<const uint8_t*>(flip), static_cast<const uint64_t*>(q_in),
      static_cast<const uint64_t*>(qp), static_cast<uint64_t*>(out), R, L, Lp, N);
  return static_cast<int>(cudaGetLastError());
}

// E2: the contraction of digits [R, L, Lp, N] with the key [L, 2, Lp, N]
// into [R, 2, Lp, N], `chunk` digits a reduction, laid out by
// ops/scan_kernel.py::contract_plan (csrc/contract.cuh::run).
int pir_ks_inner(const void* digits, const void* key, const void* qp, void* out, int64_t R,
                 int L, int Lp, int64_t N, int64_t chunk, int path, int rows, int terms,
                 int coeff_warps, int splits, int stages, int shared_bytes, int64_t grid_x,
                 int grid_y, void* stream) {
  return contract::run(digits, key, qp, out, R, L, Lp, N, chunk, path, rows, terms, coeff_warps,
                       splits, stages, shared_bytes, grid_x, grid_y, stream);
}

// E3.
int pir_ks_moddown(const void* acc, const void* lq, const void* p_half_mod_q, const void* p_inv,
                   const void* p_inv_shoup, const void* add0, const void* add1,
                   int64_t add_row_stride, const void* src, const void* flip, void* out,
                   int64_t R, int L, int Lp, int offset, int64_t N, int64_t P, int64_t p_half,
                   void* stream) {
  const int64_t work = R * 2 * L * N;
  if (work < 1 || offset < 0 || offset + L > Lp - 1 || too_many_blocks(work, kThreads))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = blocks_for(work, kThreads);
  ks_moddown_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(acc), static_cast<const uint64_t*>(lq),
      static_cast<const uint64_t*>(p_half_mod_q), static_cast<const uint64_t*>(p_inv),
      static_cast<const uint64_t*>(p_inv_shoup), static_cast<const uint64_t*>(add0),
      static_cast<const uint64_t*>(add1), add_row_stride, static_cast<const int64_t*>(src),
      static_cast<const uint8_t*>(flip), static_cast<uint64_t*>(out), R, L, Lp, offset, N,
      static_cast<uint64_t>(P), static_cast<uint64_t>(p_half));
  return static_cast<int>(cudaGetLastError());
}

// E4.
int pir_expand_combine(const void* cts, const void* sub, const void* lq, void* out, int64_t Q,
                       int64_t B, int polys, int L, int64_t N, int64_t shift_a,
                       int64_t shift_b, void* stream) {
  const int64_t work = Q * B * polys * L * N;
  if (work < 1 || shift_a < 0 || shift_a >= 2 * N || shift_b < 0 || shift_b >= 2 * N ||
      too_many_blocks(work, kThreads))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = blocks_for(work, kThreads);
  expand_combine_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(cts), static_cast<const uint64_t*>(sub),
      static_cast<const uint64_t*>(lq), static_cast<uint64_t*>(out), Q, B, polys, L, N,
      shift_a, shift_b);
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
