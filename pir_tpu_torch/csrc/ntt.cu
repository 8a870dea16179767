// Kernel A: negacyclic NTT / inverse NTT over RNS limbs, register radix.
//
// Replaces pir_tpu/ops/pallas_mxu_ntt.py::_make_kernel (K2, the four-step
// MXU transform that carries every NTT and INTT of the TPU's main path) and
// computes what pir_tpu/ops/pallas_ntt.py::_ntt_kernel (K3) computes:
// NttTables.forward (coefficient order -> bit-reversed evaluations at odd
// powers of psi) and NttTables.inverse (bit-reversed -> coefficients, times
// n^-1).  Every output is fully reduced, so it equals the reference's
// residues bit for bit.
//
// Design.  A polynomial limb of N = 2^log_n words is held by N / R threads,
// each with R = 2^B words in registers (B = 2 or 3; ops/ntt.py::ntt_plan
// takes 8 words a thread, 4 where a polynomial would get fewer than two
// warps, and gives the grid).  The log_n merged-twiddle radix-2 stages
// (Cooley-Tukey forward, Gentleman-Sande inverse) are cut into passes of B
// stages (one pass of the remaining log_n mod B): in a pass a thread's R
// words differ only in the pass's B index bits, so all of its butterflies
// run in registers with no barrier.  Shared memory only carries the
// exchange between passes (one store, one load per word, padded by a word
// every 16 so that neither the strided nor the contiguous access pattern
// conflicts in banks): ceil(log_n / B) - 1 exchanges (3 at N=4096) where
// PR 3's design made log_n round trips.  The first pass reads the input
// straight from device memory and the last one writes the output, each with
// consecutive threads on consecutive words, or with 16-byte accesses where
// a thread's words are contiguous.
//
// A pass's twiddles for one thread are runs of consecutive words of the
// [L, N] table (R - 1 of them and their companions), loaded through the
// read-only path, 16 B at a time, once per pass and before the exchange's
// barrier, so that their latency hides under it.  Butterflies are Harvey's
// lazy ones: the forward keeps words in [0, 4q), the inverse in [0, 2q)
// (q < 2^61 leaves room), and each Shoup product skips its final subtract;
// below 2^50 the words grow instead and each product takes a cheaper
// quotient (mul_shoup_grow).  The last pass reduces each word once, so the
// output is fully reduced.
//
// Rings.  Up to N=8192 a polynomial limb is one block (N=8192: 1,024
// threads and 68 KB of shared memory, above the 48 KB default, so the
// launch raises the kernel's dynamic shared-memory limit first).  At
// N=16384 and 32768 a limb does not fit a block; after the top k = log_n - 12
// forward stages every butterfly pairs words of one contiguous 4,096-word
// sub-block, so the forward runs those k stages as one pass through device
// memory (ntt_top_kernel: each thread holds the 2^k words 4,096 apart that
// the k stages mix, in registers) and then the block kernel on every
// sub-block as if it were a polynomial; the inverse runs the sub-blocks
// first (no n^-1, no reduction), the top stages last, then n^-1.  A
// sub-block's stage on bit b takes psi_rev[(N >> (b + 1)) + (x >> (b + 1))]
// with x the word's index in the whole ring: with the sub-block at offset
// o (a multiple of 4,096 > 2^b) that is ((N + o) >> (b + 1)) + (x_local
// >> (b + 1)), so the block kernel takes tw_top = N + o where a whole
// polynomial takes N.  Growing words stay below 2^64 only while every q is
// below 2^(63 - log_n) (see stage()); ops/ntt.py::grows applies that rule.
//
// What bounds it on the H100: by count, the bytes (16 per coefficient of
// device memory at the request's large shapes; the split rings' top pass
// reads and writes every word once more) ahead of the multiplies (12
// 32-bit multiplies per growing butterfly, 16 per reducing one; N/2 log_n
// butterflies).  The large N=4096 shapes run at 37-40% of that bound; by
// the SASS count, a butterfly also issues ~20 other instructions (adds,
// selects, shared-memory moves) beside its multiplies, and the passes'
// barriers and dependent products run at 32 warps an SM.  Small launches
// (one polynomial per few SMs) take one block's chain of passes.

#include <cstdint>
#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

// x * w mod q by Shoup's method without the final subtract: in [0, 2q) for
// any x < 2^64, w < q, w_shoup = floor(w * 2^64 / q).
__device__ __forceinline__ uint64_t mul_shoup_lazy(uint64_t x, uint64_t w,
                                                   uint64_t w_shoup,
                                                   uint64_t q) {
  return x * w - __umul64hi(x, w_shoup) * q;
}

// The same product for the growing butterflies, with the quotient estimated
// from three of the four 32-bit partial products of x * w_shoup: the
// dropped low x low product and the carries of the two middle ones make
// the estimate at most 2 low, so the result lies in [0, 4q).
__device__ __forceinline__ uint64_t mul_shoup_grow(uint64_t x, uint64_t w,
                                                   uint64_t w_shoup, uint64_t q) {
  const uint32_t xl = static_cast<uint32_t>(x), xh = static_cast<uint32_t>(x >> 32);
  const uint32_t sl = static_cast<uint32_t>(w_shoup), sh = static_cast<uint32_t>(w_shoup >> 32);
  const uint64_t est = static_cast<uint64_t>(xh) * sh + __umulhi(xh, sl) + __umulhi(xl, sh);
  return x * w - est * q;
}

template <int kLogN, int kB>
struct Shape {
  static constexpr int kN = 1 << kLogN;
  static constexpr int kR = 1 << kB;         // words per thread
  static constexpr int kT = kN >> kB;        // threads per polynomial
  static constexpr int kPasses = (kLogN + kB - 1) / kB;
  static constexpr int kRem = kLogN - kB * (kPasses - 1);  // bits of the last
  static constexpr int kWords = kN + (kN >> 4);  // padded shared words
  static constexpr int kMaxThreads = kT > 256 ? kT : 256;
  // at most 64 registers a thread, so that 1,024 threads share an SM
  static constexpr int kMinBlocks = 1024 / kMaxThreads;
};

// The index bits [lo, lo + r) a pass works on.  Forward passes run from the
// top bits down and the short pass (kRem bits) is the last, at bit 0; the
// inverse runs the same windows in the opposite order.
template <bool kInv, int kLogN, int kB>
__host__ __device__ constexpr int window_lo(int pass) {
  using S = Shape<kLogN, kB>;
  const int fwd = kInv ? S::kPasses - 1 - pass : pass;
  return fwd == S::kPasses - 1 ? 0 : kLogN - kB * (fwd + 1);
}

template <bool kInv, int kLogN, int kB>
__host__ __device__ constexpr int window_bits(int pass) {
  using S = Shape<kLogN, kB>;
  const int fwd = kInv ? S::kPasses - 1 - pass : pass;
  return fwd == S::kPasses - 1 ? S::kRem : kB;
}

// The passes' windows, in the order they run, cover every index bit once:
// the forward's from the top bit down (its stages run log_n - 1 .. 0), the
// inverse's from bit 0 up; the top window holds B whole bits and the bottom
// one starts at bit 0, the layouts ntt_kernel's loads and stores are written
// for.  Checked at every instantiation.
template <bool kInv, int kLogN, int kB>
__host__ __device__ constexpr bool windows_cover_every_stage_once() {
  using S = Shape<kLogN, kB>;
  int edge = kInv ? 0 : kLogN;  // where the next window must start (inverse) or end
  for (int pass = 0; pass < S::kPasses; ++pass) {
    const int lo = window_lo<kInv, kLogN, kB>(pass);
    const int bits = window_bits<kInv, kLogN, kB>(pass);
    if (bits < 1 || bits > kB || (kInv ? lo : lo + bits) != edge) return false;
    edge = kInv ? lo + bits : lo;
  }
  return edge == (kInv ? kLogN : 0) &&
         window_bits<kInv, kLogN, kB>(kInv ? S::kPasses - 1 : 0) == kB;
}

// Coefficient index of thread t's register k in window [lo, lo + r): the
// low r bits of k are the window's bits; the other index bits are
// (t << (B - r)) | (k >> r) with the window inserted at bit lo.  The thread
// and register parts never share a bit, so x(t, k) = x(t, 0) + x(0, k).
template <int kB, int kLo, int kBits>
__device__ __forceinline__ uint32_t win_index(uint32_t t, uint32_t k) {
  const uint32_t rest = (t << (kB - kBits)) | (k >> kBits);
  const uint32_t win = k & ((1u << kBits) - 1);
  return ((rest >> kLo) << (kLo + kBits)) | (win << kLo) |
         (rest & ((1u << kLo) - 1));
}

__device__ __forceinline__ uint32_t padded(uint32_t x) { return x + (x >> 4); }

// Where stage kBl's twiddles sit in a pass's twiddle registers: stage kBl
// has R >> (kBl + 1) groups, so offsets R - (R >> kBl) pack the stages of
// a pass into fewer than R words.
template <int kB, int kBl>
__host__ __device__ constexpr int tw_offset() { return (1 << kB) - ((1 << kB) >> kBl); }

// Load every twiddle (and companion) the pass with window [kLo, kLo + kBits)
// needs: for stage bit b, the R >> (bl + 1) consecutive words from
// (tw_top >> (b + 1)) + (x0 >> (b + 1)) (forward: psi_rev[m + group];
// inverse: psi_inv_rev[h + group]), 16 bytes at a time where there are two
// or more.  tw_top is the ring's N for a whole polynomial, N + o for the
// sub-block at offset o of a larger ring (see the top of this file).
template <int kB, int kLo, int kBits, int kBl>
__device__ __forceinline__ void load_twiddles(uint64_t (&w)[1 << kB], uint64_t (&ws)[1 << kB],
                                              uint32_t x0, uint32_t tw_top,
                                              const uint64_t* __restrict__ w_row,
                                              const uint64_t* __restrict__ ws_row) {
  if constexpr (kBl < kBits) {
    constexpr int kBit = kLo + kBl;
    constexpr int kGroups = (1 << kB) >> (kBl + 1);
    constexpr int kOff = tw_offset<kB, kBl>();
    const uint32_t base = (tw_top >> (kBit + 1)) + (x0 >> (kBit + 1));
    if constexpr (kGroups == 1) {
      w[kOff] = __ldg(w_row + base);
      ws[kOff] = __ldg(ws_row + base);
    } else {
#pragma unroll
      for (int g = 0; g < kGroups; g += 2) {
        const ulonglong2 wv = __ldg(reinterpret_cast<const ulonglong2*>(w_row + base + g));
        const ulonglong2 sv = __ldg(reinterpret_cast<const ulonglong2*>(ws_row + base + g));
        w[kOff + g] = wv.x;
        w[kOff + g + 1] = wv.y;
        ws[kOff + g] = sv.x;
        ws[kOff + g + 1] = sv.y;
      }
    }
    load_twiddles<kB, kLo, kBits, kBl + 1>(w, ws, x0, tw_top, w_row, ws_row);
  }
}

// One radix-2 stage on index bit kBit = kLo + kBl of the pass's window.
// Reducing butterflies (any q < 2^61) keep forward words in [0, 4q) and
// inverse words in [0, 2q).  Growing ones (kGrow) skip those conditional
// subtracts and take mul_shoup_grow's products (below 4q for any word
// below 2^64): a forward stage adds under 4q to the words' bound (under
// (1 + 4 log_n) q, 61q at N=32768, after the last), an inverse stage
// doubles it (its inputs at bit b are below 2^(b+1) q, so q << (b + 1)
// keeps x - y positive; below 2^(log_n + 1) q at the end).  That last bound
// is why growing needs q < 2^(63 - log_n): 2^50 at N=8192, 2^49 at 16384,
// 2^48 at 32768.  The last pass reduces once.
template <bool kInv, bool kGrow, int kB, int kBit, int kBl>
__device__ __forceinline__ void stage(uint64_t (&a)[1 << kB], const uint64_t (&w)[1 << kB],
                                      const uint64_t (&ws)[1 << kB], uint64_t q, uint64_t q2) {
  constexpr int kGroups = (1 << kB) >> (kBl + 1);
  constexpr int kSpan = 1 << kBl;
  constexpr int kOff = tw_offset<kB, kBl>();
  [[maybe_unused]] const uint64_t bound = q << (kBit + 1);
  [[maybe_unused]] const uint64_t q4 = q << 2;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
#pragma unroll
    for (int kk = 0; kk < kSpan; ++kk) {
      const int k = (g << (kBl + 1)) | kk;
      const uint64_t x = a[k];
      const uint64_t y = a[k + kSpan];
      if constexpr (kInv && kGrow) {
        a[k] = x + y;
        a[k + kSpan] = mul_shoup_grow(x + bound - y, w[kOff + g], ws[kOff + g], q);
      } else if constexpr (kGrow) {
        const uint64_t v = mul_shoup_grow(y, w[kOff + g], ws[kOff + g], q);
        a[k] = x + v;
        a[k + kSpan] = x + q4 - v;
      } else if constexpr (kInv) {
        // x, y in [0, 2q) -> [0, 2q)
        const uint64_t s = x + y;
        a[k] = s >= q2 ? s - q2 : s;
        a[k + kSpan] = mul_shoup_lazy(x + q2 - y, w[kOff + g], ws[kOff + g], q);
      } else {
        // reducing: x, y in [0, 4q) -> [0, 4q)
        const uint64_t u = x < q2 ? x : x - q2;
        const uint64_t v = mul_shoup_lazy(y, w[kOff + g], ws[kOff + g], q);
        a[k] = u + v;
        a[k + kSpan] = u + q2 - v;
      }
    }
  }
}

template <bool kInv, bool kGrow, int kB, int kLo, int kBits, int kStep>
__device__ __forceinline__ void stages(uint64_t (&a)[1 << kB], const uint64_t (&w)[1 << kB],
                                       const uint64_t (&ws)[1 << kB], uint64_t q, uint64_t q2) {
  if constexpr (kStep < kBits) {
    // forward: the window's top bit first; inverse: its bottom bit first
    constexpr int kBl = kInv ? kStep : kBits - 1 - kStep;
    stage<kInv, kGrow, kB, kLo + kBl, kBl>(a, w, ws, q, q2);
    stages<kInv, kGrow, kB, kLo, kBits, kStep + 1>(a, w, ws, q, q2);
  }
}

template <int kB, int kLo, int kBits>
__device__ __forceinline__ void to_shared(uint64_t* s, const uint64_t (&a)[1 << kB],
                                          uint32_t t) {
  const uint32_t p0 = padded(win_index<kB, kLo, kBits>(t, 0));
#pragma unroll
  for (int k = 0; k < (1 << kB); ++k)
    s[p0 + padded(win_index<kB, kLo, kBits>(0, k))] = a[k];
}

template <int kB, int kLo, int kBits>
__device__ __forceinline__ void from_shared(const uint64_t* s, uint64_t (&a)[1 << kB],
                                            uint32_t t) {
  const uint32_t p0 = padded(win_index<kB, kLo, kBits>(t, 0));
#pragma unroll
  for (int k = 0; k < (1 << kB); ++k)
    a[k] = s[p0 + padded(win_index<kB, kLo, kBits>(0, k))];
}

// Pass kPass and the ones after it; before each pass but the first, the
// words move through shared memory from the last pass's window to this one's.
template <bool kInv, bool kGrow, int kLogN, int kB, int kPass>
__device__ __forceinline__ void passes(uint64_t (&a)[1 << kB], uint64_t* s,
                                       uint32_t t, uint32_t tw_top,
                                       const uint64_t* __restrict__ w_row,
                                       const uint64_t* __restrict__ ws_row,
                                       uint64_t q, uint64_t q2) {
  if constexpr (kPass < Shape<kLogN, kB>::kPasses) {
    constexpr int kLo = window_lo<kInv, kLogN, kB>(kPass);
    constexpr int kBits = window_bits<kInv, kLogN, kB>(kPass);
    // the pass's twiddles first: their loads overlap the exchange
    uint64_t w[1 << kB], ws[1 << kB];
    load_twiddles<kB, kLo, kBits, 0>(w, ws, win_index<kB, kLo, kBits>(t, 0), tw_top, w_row,
                                     ws_row);
    if constexpr (kPass > 0) {
      constexpr int kPrevLo = window_lo<kInv, kLogN, kB>(kPass - 1);
      constexpr int kPrevBits = window_bits<kInv, kLogN, kB>(kPass - 1);
      if constexpr (kPass > 1) __syncthreads();  // the last exchange's reads
      to_shared<kB, kPrevLo, kPrevBits>(s, a, t);
      __syncthreads();
      from_shared<kB, kLo, kBits>(s, a, t);
    }
    stages<kInv, kGrow, kB, kLo, kBits, 0>(a, w, ws, q, q2);
    passes<kInv, kGrow, kLogN, kB, kPass + 1>(a, s, t, tw_top, w_row, ws_row, q, q2);
  }
}

// in/out: [blocks of 2^kLogN words] — whole polynomials (kTopBits = 0,
// polys = batch * limbs) or the 2^kTopBits sub-blocks of each polynomial of
// a ring of 2^(kLogN + kTopBits) words (polys counts sub-blocks); tw/tw_shoup:
// [limbs, ring] bit-reversed powers of psi (forward) or psi^-1 (inverse);
// consts: [limbs, 3] rows (q, floor(2^128 / q) hi word, lo word); n_inv,
// n_inv_shoup: [limbs].  Block: blockDim.x / T polynomials of T threads.
// A sub-block's forward takes the top stages' unreduced words and reduces
// at the end; its inverse leaves its words unreduced and unscaled for
// ntt_top_kernel.
template <bool kInv, bool kGrow, int kLogN, int kB, int kTopBits>
__global__ void __launch_bounds__(Shape<kLogN, kB>::kMaxThreads, Shape<kLogN, kB>::kMinBlocks)
ntt_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
           int64_t polys, int limbs, const uint64_t* __restrict__ tw,
           const uint64_t* __restrict__ tw_shoup,
           const uint64_t* __restrict__ consts,
           const uint64_t* __restrict__ n_inv,
           const uint64_t* __restrict__ n_inv_shoup) {
  using S = Shape<kLogN, kB>;
  static_assert(windows_cover_every_stage_once<kInv, kLogN, kB>(),
                "kernel A's passes must cover each stage once, in order");
  constexpr uint32_t kRing = static_cast<uint32_t>(S::kN) << kTopBits;
  extern __shared__ uint64_t smem[];
  const uint32_t t = threadIdx.x % S::kT;
  const int slot = threadIdx.x / S::kT;
  const int64_t poly = static_cast<int64_t>(blockIdx.x) * (blockDim.x / S::kT) + slot;
  // a thread past the last polynomial computes on zeros in its own shared
  // slot and touches no device memory; it still meets every barrier
  const bool active = poly < polys;
  const int limb = active ? static_cast<int>((poly >> kTopBits) % limbs) : 0;
  const uint32_t sub = active ? static_cast<uint32_t>(poly) & ((1u << kTopBits) - 1) : 0;
  const uint32_t tw_top = kRing + (sub << kLogN);
  const uint64_t q = consts[3 * limb];
  const uint64_t q2 = q << 1;
  const uint64_t* w_row = tw + static_cast<int64_t>(limb) * kRing;
  const uint64_t* ws_row = tw_shoup + static_cast<int64_t>(limb) * kRing;
  uint64_t* s = smem + slot * S::kWords;

  uint64_t a[S::kR];
  if constexpr (kInv) {
    // first window [0, kRem): the thread's words are contiguous
    const uint64_t* src = in + (active ? poly : 0) * S::kN + (t << kB);
#pragma unroll
    for (int k = 0; k < S::kR; k += 2) {
      ulonglong2 v = make_ulonglong2(0, 0);
      if (active) v = *reinterpret_cast<const ulonglong2*>(src + k);
      a[k] = v.x;
      a[k + 1] = v.y;
    }
  } else {
    // first window: the top kB bits; register k sits k * T words on
    const uint64_t* src = in + (active ? poly : 0) * S::kN + t;
#pragma unroll
    for (int k = 0; k < S::kR; ++k) a[k] = active ? src[k * S::kT] : 0;
  }

  passes<kInv, kGrow, kLogN, kB, 0>(a, s, t, tw_top, w_row, ws_row, q, q2);
  if (!active) return;

  if constexpr (kInv) {
    uint64_t* dst = out + poly * S::kN + t;
    if constexpr (kTopBits > 0) {
#pragma unroll
      for (int k = 0; k < S::kR; ++k) dst[k * S::kT] = a[k];
    } else {
      const uint64_t ni = n_inv[limb];
      const uint64_t nis = n_inv_shoup[limb];
#pragma unroll
      for (int k = 0; k < S::kR; ++k) {
        const uint64_t r = mul_shoup_lazy(a[k], ni, nis, q);
        dst[k * S::kT] = r >= q ? r - q : r;
      }
    }
  } else {
    uint64_t* dst = out + poly * S::kN + (t << kB);
    [[maybe_unused]] const uint64_t ratio = consts[3 * limb + 1];
#pragma unroll
    for (int k = 0; k < S::kR; k += 2) {
      uint64_t v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        uint64_t r = a[k + e];
        if constexpr (kGrow) {
          v[e] = barrett_reduce_64(r, q, ratio);  // r < (1 + 4 log_n) q < 2^64
        } else {
          r = r >= q2 ? r - q2 : r;
          v[e] = r >= q ? r - q : r;
        }
      }
      *reinterpret_cast<ulonglong2*>(dst + k) = make_ulonglong2(v[0], v[1]);
    }
  }
}

constexpr int kTopMaxThreads = 256;

// The top kTop stages of a ring of 2^kLogN words (bits kLogN - kTop ..
// kLogN - 1): thread j of a polynomial holds its words j + m 2^(kLogN - kTop),
// m < 2^kTop, and runs the stages in registers with the twiddles every
// thread of the limb shares.  in/out: [polys, 2^kLogN].  The forward comes
// first and leaves its words unreduced for ntt_kernel's sub-blocks; the
// inverse comes last and scales by n^-1.
template <bool kInv, bool kGrow, int kLogN, int kTop>
__global__ void __launch_bounds__(kTopMaxThreads)
ntt_top_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
               int64_t polys, int limbs, const uint64_t* __restrict__ tw,
               const uint64_t* __restrict__ tw_shoup,
               const uint64_t* __restrict__ consts,
               const uint64_t* __restrict__ n_inv,
               const uint64_t* __restrict__ n_inv_shoup) {
  constexpr int kLo = kLogN - kTop;
  constexpr uint32_t kN = 1u << kLogN;
  constexpr uint32_t kSpan = 1u << kLo;
  const int64_t id = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t poly = id >> kLo;
  if (poly >= polys) return;
  const uint32_t j = static_cast<uint32_t>(id) & (kSpan - 1);
  const int limb = static_cast<int>(poly % limbs);
  const uint64_t q = consts[3 * limb];
  const uint64_t q2 = q << 1;
  uint64_t w[1 << kTop], ws[1 << kTop];
  load_twiddles<kTop, kLo, kTop, 0>(w, ws, j, kN, tw + static_cast<int64_t>(limb) * kN,
                                    tw_shoup + static_cast<int64_t>(limb) * kN);
  const uint64_t* src = in + poly * kN + j;
  uint64_t a[1 << kTop];
#pragma unroll
  for (int m = 0; m < (1 << kTop); ++m) a[m] = src[m * kSpan];
  stages<kInv, kGrow, kTop, kLo, kTop, 0>(a, w, ws, q, q2);
  uint64_t* dst = out + poly * kN + j;
  if constexpr (kInv) {
    const uint64_t ni = n_inv[limb];
    const uint64_t nis = n_inv_shoup[limb];
#pragma unroll
    for (int m = 0; m < (1 << kTop); ++m) {
      const uint64_t r = mul_shoup_lazy(a[m], ni, nis, q);
      dst[m * kSpan] = r >= q ? r - q : r;
    }
  } else {
#pragma unroll
    for (int m = 0; m < (1 << kTop); ++m) dst[m * kSpan] = a[m];
  }
}

constexpr size_t kDefaultSharedBytes = 48 * 1024;

struct Args {
  int64_t polys;  // batch * limbs
  int limbs;
  int polys_per_block;
  int64_t blocks;
  int top_threads;
  int64_t top_blocks;
  const uint64_t* tw;
  const uint64_t* tw_shoup;
  const uint64_t* consts;
  const uint64_t* n_inv;
  const uint64_t* n_inv_shoup;
  cudaStream_t stream;
};

// The block kernel over a.polys << kTopBits (sub-)polynomials of 2^kLogN
// words, after raising its shared-memory limit where a block needs more
// than the default.
template <bool kInv, bool kGrow, int kLogN, int kB, int kTopBits>
cudaError_t launch_blocks(const Args& a, const uint64_t* in, uint64_t* out) {
  using S = Shape<kLogN, kB>;
  const size_t smem = static_cast<size_t>(a.polys_per_block) * S::kWords * sizeof(uint64_t);
  if (smem > kDefaultSharedBytes) {
    const cudaError_t err =
        cudaFuncSetAttribute(ntt_kernel<kInv, kGrow, kLogN, kB, kTopBits>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  ntt_kernel<kInv, kGrow, kLogN, kB, kTopBits>
      <<<static_cast<unsigned>(a.blocks), a.polys_per_block * S::kT, smem, a.stream>>>(
          in, out, a.polys << kTopBits, a.limbs, a.tw, a.tw_shoup, a.consts, a.n_inv,
          a.n_inv_shoup);
  return cudaGetLastError();
}

template <bool kInv, bool kGrow, int kLogN, int kTop>
cudaError_t launch_top(const Args& a, const uint64_t* in, uint64_t* out) {
  ntt_top_kernel<kInv, kGrow, kLogN, kTop>
      <<<static_cast<unsigned>(a.top_blocks), a.top_threads, 0, a.stream>>>(
          in, out, a.polys, a.limbs, a.tw, a.tw_shoup, a.consts, a.n_inv, a.n_inv_shoup);
  return cudaGetLastError();
}

// A ring of 2^(12 + kTop) words: forward top stages, then the 4,096-word
// sub-blocks; inverse the other way round.  The words between the two
// launches go through `scratch`.
template <bool kInv, bool kGrow, int kTop>
cudaError_t launch_split(const Args& a, const uint64_t* in, uint64_t* scratch, uint64_t* out) {
  cudaError_t err;
  if constexpr (kInv) {
    err = launch_blocks<true, kGrow, 12, 3, kTop>(a, in, scratch);
    if (err == cudaSuccess) err = launch_top<true, kGrow, 12 + kTop, kTop>(a, scratch, out);
  } else {
    err = launch_top<false, kGrow, 12 + kTop, kTop>(a, in, scratch);
    if (err == cudaSuccess) err = launch_blocks<false, kGrow, 12, 3, kTop>(a, scratch, out);
  }
  return err;
}

template <bool kInv, bool kGrow>
cudaError_t launch_ring(int log_n, int radix_bits, const Args& a, const uint64_t* in,
                        uint64_t* scratch, uint64_t* out) {
  const int key = log_n * 4 + radix_bits;
  switch (key) {
#define PIR_NTT_BLOCKS(LOG_N, B) \
  case LOG_N * 4 + B: return launch_blocks<kInv, kGrow, LOG_N, B, 0>(a, in, out);
    PIR_NTT_BLOCKS(6, 2) PIR_NTT_BLOCKS(6, 3) PIR_NTT_BLOCKS(7, 2) PIR_NTT_BLOCKS(7, 3)
    PIR_NTT_BLOCKS(8, 2) PIR_NTT_BLOCKS(8, 3) PIR_NTT_BLOCKS(9, 2) PIR_NTT_BLOCKS(9, 3)
    PIR_NTT_BLOCKS(10, 2) PIR_NTT_BLOCKS(10, 3) PIR_NTT_BLOCKS(11, 2) PIR_NTT_BLOCKS(11, 3)
    PIR_NTT_BLOCKS(12, 2) PIR_NTT_BLOCKS(12, 3) PIR_NTT_BLOCKS(13, 3)
#undef PIR_NTT_BLOCKS
    case 14 * 4 + 3: return launch_split<kInv, kGrow, 2>(a, in, scratch, out);
    case 15 * 4 + 3: return launch_split<kInv, kGrow, 3>(a, in, scratch, out);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Transform `batch * limbs` polynomials of 2^log_n words (6 <= log_n <= 15)
// as ops/ntt.py::ntt_plan lays them out: blocks of polys_per_block
// (sub-)polynomials of 2^(log_n - top_bits) words, 2^radix_bits words a
// thread (radix_bits 2 or 3; 3 from log_n 13), `blocks` blocks; and where
// top_bits > 0 (log_n 14, 15: top_bits = log_n - 12) the top stages'
// kernel in top_blocks blocks of top_threads threads, the words between the
// two kernels in `scratch` (the input's size).  `grow` (every modulus below
// 2^min(50, 63 - log_n)) selects the butterflies without conditional
// subtracts.  consts: [limbs, 3] (q, floor(2^128/q) hi word, lo word).
// Returns the first launch error, cudaErrorInvalidValue for a layout whose
// grids do not cover the work.
int pir_ntt(const void* in, void* out, void* scratch, int64_t batch, int limbs, int log_n,
            int inverse, int radix_bits, int polys_per_block, int64_t blocks, int top_bits,
            int top_threads, int64_t top_blocks, int grow, const void* tw,
            const void* tw_shoup, const void* consts, const void* n_inv,
            const void* n_inv_shoup, void* stream) {
  const int64_t polys = batch * limbs;
  const int block_log = log_n - top_bits;
  if (polys_per_block < 1 || block_log < 6 || block_log > 13 ||
      (static_cast<int64_t>(polys_per_block) << block_log >> radix_bits) > 1024 ||
      blocks < 1 || blocks > 0x7fffffff || blocks * polys_per_block < (polys << top_bits))
    return static_cast<int>(cudaErrorInvalidValue);
  if (top_bits < 0 || (top_bits != 0) != (log_n >= 14))
    return static_cast<int>(cudaErrorInvalidValue);
  if (top_bits != 0 &&
      (block_log != 12 || scratch == nullptr || top_threads < 32 ||
       top_threads > kTopMaxThreads ||
       top_blocks < 1 || top_blocks > 0x7fffffff ||
       top_blocks * top_threads < (polys << block_log)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{polys, limbs, polys_per_block, blocks, top_threads, top_blocks,
               static_cast<const uint64_t*>(tw), static_cast<const uint64_t*>(tw_shoup),
               static_cast<const uint64_t*>(consts), static_cast<const uint64_t*>(n_inv),
               static_cast<const uint64_t*>(n_inv_shoup), static_cast<cudaStream_t>(stream)};
  const auto* src = static_cast<const uint64_t*>(in);
  auto* mid = static_cast<uint64_t*>(scratch);
  auto* dst = static_cast<uint64_t*>(out);
  cudaError_t err;
  if (inverse != 0)
    err = grow != 0 ? launch_ring<true, true>(log_n, radix_bits, a, src, mid, dst)
                    : launch_ring<true, false>(log_n, radix_bits, a, src, mid, dst);
  else
    err = grow != 0 ? launch_ring<false, true>(log_n, radix_bits, a, src, mid, dst)
                    : launch_ring<false, false>(log_n, radix_bits, a, src, mid, dst);
  return static_cast<int>(err);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
