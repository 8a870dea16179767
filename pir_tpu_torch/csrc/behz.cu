// Kernel G: the BEHZ multiply's RNS arithmetic (ciphertext-multiplication
// mode).
//
// Replaces code that pir_tpu leaves to XLA, not a Pallas body:
// pir_tpu/core/rns.py::RnsTool.fastbconv_m_tilde_sm_mrq, fast_floor and
// fastbconv_sk, and the dyadic tensor product of
// pir_tpu/bfv/multiply.py::bfv_multiply.  One multiply of size-2
// ciphertexts (k ciphertext primes q_i, the k + 1 primes b_j of the base
// Bsk, b_k = m_sk) is
//
//   G1 pir_behz_lift      x (base q) -> x (base Bsk), exactly (m~ = 2^32
//                         and the small Montgomery reduction), each operand
//   -- kernel A forward over q and over Bsk, each operand
//   G2 pir_behz_tensor    (x0, x1) x (y0, y1) -> (x0 y0, x0 y1 + x1 y0, x1 y1)
//                         over every limb of q and of Bsk in one launch
//   -- kernel A inverse over q and over Bsk
//   G3 pir_behz_floor_sk  t x / q floored in Bsk (fast_floor), then back to
//                         base q (Shenoy-Kumaresan through m_sk)
//
// where the plain version (bfv/multiply.py's *_plain, core/rns.py) runs
// about 20 PyTorch passes over the whole tensor for each modular product.
//
// Every word is a u64 residue below 2^61; tensors are row-major.  The
// constants arrive as one u64 vector (core/rns.py::RnsTool.kernel_table, in
// Table's order below), built once a tool on its device.
//
// Exactness: every sum over source limbs (sum_i y_i (q/q_i) mod b_j and the
// like) is a 128-bit sum of 64 x 64-bit products, at most 15 terms below
// 2^122 each, so under 2^126, and one Barrett reduction (exact below 2^127)
// ends it; every other step is a Shoup or Barrett product or an add or
// subtract mod the limb's prime.  So each output word is the unique reduced
// residue the plain version's chunked sums also reach: the same words.  The
// m~ target is u32 arithmetic, the low words the plain version's wrapping
// u64 products keep.
//
// Design: G1 and G3 give a thread one coefficient column of one polynomial:
// it reads the column's k (G1) or 2k + 1 (G3) words once, keeps the limbs'
// intermediate words in registers (a template on the most limbs, 2, 4, 8 or
// 15, so the register arrays have constant indices) and writes each output
// word once.  G2 gives a thread one coefficient of one limb of one product;
// each operand is read through its own stride between prefixes, so a
// selection vector shared by every prefix is read in place (stride 0), not
// copied.
// Blocks take kThreads coefficients along x and rows along y (G2: limbs
// along y, rows along z), so a thread divides nothing; neighbouring threads
// take neighbouring coefficients, so every access of a warp is one 256-byte
// run.
//
// What bounds it on the H100: bytes for G1 and G2 (8-9 words moved a thread
// for about k (k + 1) or 4 wide products), and about as much arithmetic as
// bytes for G3 at k = 4 (some 2k^2 wide products and 5k Shoup products a
// column); at k = 15 the products dominate.

#include <cstdint>

#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQ = 15;  // ciphertext limbs; Bsk has one more

// The constant table's sections, in order; k ciphertext primes, k + 1 of
// Bsk (m_sk last), B = b_0 ... b_{k-1}.  A pair is (w, floor(w 2^64 / p)):
// a constant that multiplies by Shoup's method.  Two constants that always
// multiply one after the other are one (x m~ (q / q_i)^-1, for example): a
// product of residues is the same residue either way.
struct Table {
  const uint64_t* q;        // [k, 3]: q_i, floor(2^128 / q_i) hi and lo words
  const uint64_t* bsk;      // [k + 1, 3]: the same for b_j
  const uint64_t* mt_ipq;   // [k] pairs: m~ (q / q_i)^-1 mod q_i
  const uint64_t* pq_bsk;   // [k + 1, k]: q / q_i mod b_j, row j
  const uint64_t* pq_mt;    // [k]: q / q_i mod m~
  const uint64_t* q_bsk;    // [k + 1] pairs: q mod b_j
  const uint64_t* qmt_bsk;  // [k + 1]: q m~ mod b_j
  const uint64_t* imt_bsk;  // [k + 1] pairs: m~^-1 mod b_j
  const uint64_t* t_ipq;    // [k] pairs: t (q / q_i)^-1 mod q_i
  const uint64_t* t_bsk;    // [k + 1] pairs: t mod b_j
  const uint64_t* f_bsk;    // [k + 1] pairs: q^-1 (B / b_j)^-1 mod b_j, j < k; q^-1 mod m_sk
  const uint64_t* pb_q;     // [k, k]: B / b_i mod q_l, row l
  const uint64_t* pb_msk;   // [k]: B / b_i mod m_sk
  const uint64_t* b_q;      // [k] pairs: B mod q_l
  const uint64_t* bmsk_q;   // [k]: B m_sk mod q_l
  const uint64_t* ib_msk;   // one pair: B^-1 mod m_sk
  uint32_t neg_inv_q_mt;    // -q^-1 mod m~
  uint64_t msk_half;        // floor(m_sk / 2)
};

__device__ __forceinline__ Table table_of(const uint64_t* t, int k) {
  const int b = k + 1;
  Table s;
  s.q = t;
  t += 3 * k;
  s.bsk = t;
  t += 3 * b;
  s.mt_ipq = t;
  t += 2 * k;
  s.pq_bsk = t;
  t += b * k;
  s.pq_mt = t;
  t += k;
  s.q_bsk = t;
  t += 2 * b;
  s.qmt_bsk = t;
  t += b;
  s.imt_bsk = t;
  t += 2 * b;
  s.t_ipq = t;
  t += 2 * k;
  s.t_bsk = t;
  t += 2 * b;
  s.f_bsk = t;
  t += 2 * b;
  s.pb_q = t;
  t += k * k;
  s.pb_msk = t;
  t += k;
  s.b_q = t;
  t += 2 * k;
  s.bmsk_q = t;
  t += k;
  s.ib_msk = t;
  t += 2;
  s.neg_inv_q_mt = static_cast<uint32_t>(__ldg(t));
  s.msk_half = __ldg(t + 1);
  return s;
}

// (hi:lo) += x * y, 128-bit.
__device__ __forceinline__ void mac_wide(uint64_t& lo, uint64_t& hi, uint64_t x, uint64_t y) {
  const uint64_t p = x * y;
  lo += p;
  hi += __umul64hi(x, y) + (lo < p ? 1 : 0);
}

// (hi:lo) mod the prime of a (p, ratio hi, ratio lo) row; exact below 2^127.
__device__ __forceinline__ uint64_t reduce_wide(uint64_t lo, uint64_t hi, const uint64_t* row) {
  return barrett_reduce_128(hi, lo, __ldg(row), __ldg(row + 1), __ldg(row + 2));
}

__device__ __forceinline__ uint64_t mul_pair(uint64_t x, const uint64_t* pair, uint64_t p) {
  return mul_shoup(x, __ldg(pair), __ldg(pair + 1), p);
}

// x * y mod the prime of `row`, any x, y below 2^64 whose product is under 2^127.
__device__ __forceinline__ uint64_t mul_wide(uint64_t x, uint64_t y, const uint64_t* row) {
  return reduce_wide(x * y, __umul64hi(x, y), row);
}

// G1 on one coefficient column: x -> o, k words N apart in, k + 1 out.
template <int KM>
__device__ __forceinline__ void lift_column(const uint64_t* x, const Table& c, uint64_t* o,
                                            int k, int64_t N) {
  // y_i = x_i m~ (q / q_i)^-1 mod q_i, and the m~ target's sum
  uint64_t y[KM];
  uint32_t conv_mt = 0;
#pragma unroll
  for (int i = 0; i < KM; ++i) {
    if (i < k) {
      y[i] = mul_pair(x[i * N], c.mt_ipq + 2 * i, __ldg(c.q + 3 * i));
      conv_mt += static_cast<uint32_t>(y[i]) * static_cast<uint32_t>(__ldg(c.pq_mt + i));
    }
  }
  // small Montgomery reduction: r = -conv_mt / q mod m~, centred
  const uint32_t r_mt = conv_mt * c.neg_inv_q_mt;
  const bool upper = r_mt >= (1u << 31);
  for (int j = 0; j <= k; ++j) {
    const uint64_t* row = c.bsk + 3 * j;
    const uint64_t b = __ldg(row);
    uint64_t lo = 0, hi = 0;
#pragma unroll
    for (int i = 0; i < KM; ++i)
      if (i < k) mac_wide(lo, hi, y[i], __ldg(c.pq_bsk + j * k + i));
    uint64_t corr = mul_pair(r_mt, c.q_bsk + 2 * j, b);
    if (upper) corr = sub_mod(corr, __ldg(c.qmt_bsk + j), b);
    o[j * N] = mul_pair(add_mod(reduce_wide(lo, hi, row), corr, b), c.imt_bsk + 2 * j, b);
  }
}

// G1: in [R, k, N] rows `in_stride` words apart, out [R, k + 1, N]; blocks
// along x take coefficients, along y rows.
template <int KM>
__global__ void __launch_bounds__(kThreads)
behz_lift_kernel(const uint64_t* __restrict__ in, int64_t in_stride,
                 const uint64_t* __restrict__ table, uint64_t* __restrict__ out, int64_t R, int k,
                 int64_t N) {
  const int64_t n = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (n >= N) return;
  const Table c = table_of(table, k);
  for (int64_t r = blockIdx.y; r < R; r += gridDim.y)
    lift_column<KM>(in + r * in_stride + n, c, out + r * (k + 1) * N + n, k, N);
}

// G2: a = (a_q [.., 2, k, N], a_b [.., 2, k + 1, N]) and b alike, ciphertext
// o * inner + i of the product at ciphertext o * so + i of each operand;
// out_q [outer * inner, 3, k, N], out_b [outer * inner, 3, k + 1, N].
// Blocks along x take coefficients, along y the 2k + 1 limbs, along z rows.
__global__ void __launch_bounds__(kThreads)
behz_tensor_kernel(const uint64_t* __restrict__ a_q, const uint64_t* __restrict__ a_b,
                   const uint64_t* __restrict__ b_q, const uint64_t* __restrict__ b_b,
                   const uint64_t* __restrict__ table, uint64_t* __restrict__ out_q,
                   uint64_t* __restrict__ out_b, int64_t outer, int64_t inner, int64_t a_so,
                   int64_t b_so, int k, int64_t N) {
  const int64_t n = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (n >= N) return;
  const int l = blockIdx.y;
  const bool on_q = l < k;
  const int w = on_q ? k : k + 1;  // the base's limbs
  const int limb = on_q ? l : l - k;
  const uint64_t* row = on_q ? table + 3 * l : table + 3 * k + 3 * limb;
  for (int64_t r = blockIdx.z; r < outer * inner; r += gridDim.z) {
    const int64_t o = r / inner, i = r % inner;
    const uint64_t* x = (on_q ? a_q : a_b) + ((o * a_so + i) * 2 * w + limb) * N + n;
    const uint64_t* y = (on_q ? b_q : b_b) + ((o * b_so + i) * 2 * w + limb) * N + n;
    const uint64_t x0 = x[0], x1 = x[w * N], y0 = y[0], y1 = y[w * N];
    uint64_t* z = (on_q ? out_q : out_b) + (r * 3 * w + limb) * N + n;
    uint64_t lo = 0, hi = 0;
    mac_wide(lo, hi, x0, y1);
    mac_wide(lo, hi, x1, y0);
    z[0] = mul_wide(x0, y0, row);
    z[w * N] = reduce_wide(lo, hi, row);
    z[2 * w * N] = mul_wide(x1, y1, row);
  }
}

// G3 on one coefficient column: the product's k words over q (xq) and k + 1
// over Bsk (xb), N apart, -> o, k words.
template <int KM>
__device__ __forceinline__ void floor_sk_column(const uint64_t* xq, const uint64_t* xb,
                                                const Table& c, uint64_t* o, int k, int64_t N) {
  // fast_floor: y_i = t x_i (q / q_i)^-1 mod q_i ...
  uint64_t y[KM];
#pragma unroll
  for (int i = 0; i < KM; ++i)
    if (i < k) y[i] = mul_pair(xq[i * N], c.t_ipq + 2 * i, __ldg(c.q + 3 * i));
  // ... and f_j = (t x_j mod b_j - sum_i y_i (q / q_i)) q^-1 mod b_j, kept
  // as Shenoy-Kumaresan's z_j = f_j (B / b_j)^-1 mod b_j (one product), and
  // f at m_sk
  uint64_t z[KM];
  uint64_t f_msk = 0;
#pragma unroll
  for (int j = 0; j <= KM; ++j) {
    if (j > k) break;
    const uint64_t* row = c.bsk + 3 * j;
    const uint64_t b = __ldg(row);
    uint64_t lo = 0, hi = 0;
#pragma unroll
    for (int i = 0; i < KM; ++i)
      if (i < k) mac_wide(lo, hi, y[i], __ldg(c.pq_bsk + j * k + i));
    const uint64_t tx = mul_pair(xb[j * N], c.t_bsk + 2 * j, b);
    const uint64_t f = mul_pair(sub_mod(tx, reduce_wide(lo, hi, row), b), c.f_bsk + 2 * j, b);
    if (j < KM && j < k)  // j < k implies j < KM; the first test keeps z's index in range
      z[j] = f;
    else
      f_msk = f;
  }
  // alpha = (sum_i z_i (B / b_i) - f_msk) B^-1 mod m_sk, centred
  const uint64_t* msk_row = c.bsk + 3 * k;
  const uint64_t msk = __ldg(msk_row);
  uint64_t lo = 0, hi = 0;
#pragma unroll
  for (int i = 0; i < KM; ++i)
    if (i < k) mac_wide(lo, hi, z[i], __ldg(c.pb_msk + i));
  const uint64_t alpha = mul_pair(sub_mod(reduce_wide(lo, hi, msk_row), f_msk, msk), c.ib_msk, msk);
  const bool upper = alpha >= c.msk_half;
  for (int l = 0; l < k; ++l) {
    const uint64_t* row = c.q + 3 * l;
    const uint64_t q = __ldg(row);
    lo = hi = 0;
#pragma unroll
    for (int i = 0; i < KM; ++i)
      if (i < k) mac_wide(lo, hi, z[i], __ldg(c.pb_q + l * k + i));
    const uint64_t corr = mul_pair(alpha, c.b_q + 2 * l, q);
    const uint64_t v = sub_mod(reduce_wide(lo, hi, row), corr, q);
    o[l * N] = upper ? add_mod(v, __ldg(c.bmsk_q + l), q) : v;
  }
}

// G3: prod_q [R, k, N] and prod_b [R, k + 1, N] (coefficient form) -> out
// [R, k, N]; blocks along x take coefficients, along y rows.
template <int KM>
__global__ void __launch_bounds__(kThreads)
behz_floor_sk_kernel(const uint64_t* __restrict__ prod_q, const uint64_t* __restrict__ prod_b,
                     const uint64_t* __restrict__ table, uint64_t* __restrict__ out, int64_t R,
                     int k, int64_t N) {
  const int64_t n = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (n >= N) return;
  const Table c = table_of(table, k);
  for (int64_t r = blockIdx.y; r < R; r += gridDim.y)
    floor_sk_column<KM>(prod_q + r * k * N + n, prod_b + r * (k + 1) * N + n, c,
                        out + r * k * N + n, k, N);
}

constexpr int64_t kMaxGridRows = 65535;  // a grid's rows; a block loops over the rest

unsigned coefficient_blocks(int64_t N) {
  return static_cast<unsigned>((N + kThreads - 1) / kThreads);
}

unsigned row_blocks(int64_t rows) {
  return static_cast<unsigned>(rows < kMaxGridRows ? rows : kMaxGridRows);
}

bool bad_grid(int64_t rows, int64_t N) {
  return rows < 1 || N < 1 || (N + kThreads - 1) / kThreads > 0x7fffffff;
}

template <int KM>
int launch_lift(const uint64_t* in, int64_t in_stride, const uint64_t* table, uint64_t* out,
                int64_t R, int k, int64_t N, cudaStream_t stream) {
  const dim3 grid(coefficient_blocks(N), row_blocks(R));
  behz_lift_kernel<KM><<<grid, kThreads, 0, stream>>>(in, in_stride, table, out, R, k, N);
  return static_cast<int>(cudaGetLastError());
}

template <int KM>
int launch_floor_sk(const uint64_t* prod_q, const uint64_t* prod_b, const uint64_t* table,
                    uint64_t* out, int64_t R, int k, int64_t N, cudaStream_t stream) {
  const dim3 grid(coefficient_blocks(N), row_blocks(R));
  behz_floor_sk_kernel<KM><<<grid, kThreads, 0, stream>>>(prod_q, prod_b, table, out, R, k, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// G1.  Returns cudaGetLastError(), or cudaErrorInvalidValue for work the
// kernel does not take.
int pir_behz_lift(const void* in, int64_t in_stride, const void* table, void* out, int64_t R,
                  int k, int64_t N, void* stream) {
  if (bad_grid(R, N) || k < 1 || k > kMaxQ || (R > 1 && in_stride < k * N))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* x = static_cast<const uint64_t*>(in);
  const auto* t = static_cast<const uint64_t*>(table);
  auto* o = static_cast<uint64_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (k <= 2) return launch_lift<2>(x, in_stride, t, o, R, k, N, s);
  if (k <= 4) return launch_lift<4>(x, in_stride, t, o, R, k, N, s);
  if (k <= 8) return launch_lift<8>(x, in_stride, t, o, R, k, N, s);
  return launch_lift<kMaxQ>(x, in_stride, t, o, R, k, N, s);
}

// G2.
int pir_behz_tensor(const void* a_q, const void* a_b, const void* b_q, const void* b_b,
                    const void* table, void* out_q, void* out_b, int64_t outer, int64_t inner,
                    int64_t a_so, int64_t b_so, int k, int64_t N, void* stream) {
  if (outer < 1 || inner < 1 || bad_grid(outer * inner, N) || k < 1 || k > kMaxQ || a_so < 0 ||
      b_so < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(coefficient_blocks(N), 2 * k + 1, row_blocks(outer * inner));
  behz_tensor_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(a_q), static_cast<const uint64_t*>(a_b),
      static_cast<const uint64_t*>(b_q), static_cast<const uint64_t*>(b_b),
      static_cast<const uint64_t*>(table), static_cast<uint64_t*>(out_q),
      static_cast<uint64_t*>(out_b), outer, inner, a_so, b_so, k, N);
  return static_cast<int>(cudaGetLastError());
}

// G3.
int pir_behz_floor_sk(const void* prod_q, const void* prod_b, const void* table, void* out,
                      int64_t R, int k, int64_t N, void* stream) {
  if (bad_grid(R, N) || k < 1 || k > kMaxQ) return static_cast<int>(cudaErrorInvalidValue);
  const auto* pq = static_cast<const uint64_t*>(prod_q);
  const auto* pb = static_cast<const uint64_t*>(prod_b);
  const auto* t = static_cast<const uint64_t*>(table);
  auto* o = static_cast<uint64_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (k <= 2) return launch_floor_sk<2>(pq, pb, t, o, R, k, N, s);
  if (k <= 4) return launch_floor_sk<4>(pq, pb, t, o, R, k, N, s);
  if (k <= 8) return launch_floor_sk<8>(pq, pb, t, o, R, k, N, s);
  return launch_floor_sk<kMaxQ>(pq, pb, t, o, R, k, N, s);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
