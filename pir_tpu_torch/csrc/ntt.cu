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
// N=16384 and 32768 a limb does not fit a block, so it is held by a
// thread-block cluster (ntt_cluster_kernel) of 2^k CTAs, k = log_n - 12
// (4 and 8, within the portable cluster size), each holding one 4,096-word
// sub-block in its shared memory (34,816 B with the padding) as the block
// kernel holds an N=4096 limb.  After the top k forward stages every
// butterfly pairs words of one sub-block.  So the forward reads each word
// once from device memory in the top stages' layout (each thread the 2^k
// words 4,096 apart that those stages mix, consecutive threads on
// consecutive words), runs the k stages in registers and leaves the words
// in its CTA's shared memory; after a cluster barrier each thread loads
// the 8 words its sub-block's first pass takes from the CTAs that hold
// them (distributed shared memory, csrc/cluster.cuh), and the passes run
// on and write each word, reduced, once.  The inverse mirrors it: the
// sub-block's passes from device memory, the words left in the CTA's
// shared memory, a cluster barrier, each thread loads its top-stage words
// from the CTAs that hold them, runs the top stages, n^-1 folded into the
// last (last_stage_scaled), and writes each word once.  A second cluster
// barrier keeps a CTA's shared memory as it is until its siblings have read
// it; the forward's completes under the sub-block's first pass.  A CTA
// runs on at most 40 registers, so that 3 share an SM.  A sub-block's
// stage on bit b takes
// psi_rev[(N >> (b + 1)) + (x >> (b + 1))] with x the word's index in the
// whole ring: with the sub-block at offset o (a multiple of 4,096 > 2^b)
// that is ((N + o) >> (b + 1)) + (x_local >> (b + 1)), so its passes take
// tw_top = N + o where a whole polynomial takes N.  The arithmetic is the
// block kernel's: growing words stay below 2^64 only while every q is below
// 2^(63 - log_n) (see stage()); ops/ntt.py::grows applies that rule.
//
// What bounds it on the H100: by count, the bytes (16 per coefficient of
// device memory at the request's large shapes) ahead of the multiplies (12
// 32-bit multiplies per growing butterfly, 16 per reducing one; N/2 log_n
// butterflies) at N=4096; at N=16384 and 32768 the multiplies.  The large
// N=4096 shapes run at 37-40% of that bound; by the SASS count, a butterfly
// also issues ~20 other instructions (adds, selects, shared-memory moves)
// beside its multiplies, and the passes' barriers and dependent products
// run at 32 warps an SM.  Small launches (one polynomial per few SMs) take
// one block's chain of passes.  The split rings run at 36-44%: with its
// butterflies taken out a cluster kernel still takes about half its time
// (its loads, exchanges, barriers and stores overlap little with the
// butterflies), and the exchange between CTAs costs 3-9%
// (pir_tpu_torch/ntt_cluster_variants.py, PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

#include "cluster.cuh"
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

// Passes [kPass, kEnd); before each pass but the first, the words move
// through shared memory from the last pass's window to this one's.
template <bool kInv, bool kGrow, int kLogN, int kB, int kPass,
          int kEnd = Shape<kLogN, kB>::kPasses>
__device__ __forceinline__ void passes(uint64_t (&a)[1 << kB], uint64_t* s,
                                       uint32_t t, uint32_t tw_top,
                                       const uint64_t* __restrict__ w_row,
                                       const uint64_t* __restrict__ ws_row,
                                       uint64_t q, uint64_t q2) {
  if constexpr (kPass < kEnd) {
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
    passes<kInv, kGrow, kLogN, kB, kPass + 1, kEnd>(a, s, t, tw_top, w_row, ws_row, q, q2);
  }
}

// A forward transform's last step: each word reduced once, the thread's
// 2^kB contiguous words written 16 bytes at a time.
template <bool kGrow, int kB>
__device__ __forceinline__ void store_reduced(uint64_t* dst, const uint64_t (&a)[1 << kB],
                                              uint64_t q, uint64_t q2, uint64_t ratio) {
#pragma unroll
  for (int k = 0; k < (1 << kB); k += 2) {
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

// An inverse transform's first step: the thread's 2^kB contiguous words
// (the first window, [0, kRem), holds them), 16 bytes at a time; zeros for
// a thread past the last polynomial.
template <int kB>
__device__ __forceinline__ void load_contiguous(uint64_t (&a)[1 << kB], const uint64_t* src,
                                                bool active) {
#pragma unroll
  for (int k = 0; k < (1 << kB); k += 2) {
    ulonglong2 v = make_ulonglong2(0, 0);
    if (active) v = *reinterpret_cast<const ulonglong2*>(src + k);
    a[k] = v.x;
    a[k + 1] = v.y;
  }
}

// The inverse's last stage, on index bit kBit, whose butterflies all take
// one twiddle w, with n^-1 folded in: x + y times n^-1 and x - y times
// w n^-1, each fully reduced -- the residues of the stage and then the
// scaling, with a third fewer products.  ratio_hi:ratio_lo = floor(2^128 / q)
// gives w n^-1's Shoup companion floor(w n^-1 2^64 / q): Barrett's estimate
// is at most 2 low, and the remainder (below 3q) corrects it.  The lifted
// differences stay below 2^64 under the same bounds as stage()'s.
template <bool kGrow, int kB, int kBit>
__device__ __forceinline__ void last_stage_scaled(uint64_t (&a)[1 << kB], uint64_t w, uint64_t ni,
                                                  uint64_t nis, uint64_t q, uint64_t ratio_hi,
                                                  uint64_t ratio_lo) {
  constexpr int kSpan = 1 << (kB - 1);
  const uint64_t wn = mul_shoup(w, ni, nis, q);
  uint64_t wns = wn * ratio_hi + __umul64hi(wn, ratio_lo);
  uint64_t rem = 0 - wns * q;  // wn 2^64 - wns q, below 3q
  if (rem >= q) {
    ++wns;
    rem -= q;
  }
  if (rem >= q) ++wns;
  const uint64_t lift = kGrow ? q << (kBit + 1) : q << 1;
#pragma unroll
  for (int k = 0; k < kSpan; ++k) {
    const uint64_t x = a[k], y = a[k + kSpan];
    const uint64_t s = mul_shoup_lazy(x + y, ni, nis, q);
    const uint64_t d = mul_shoup_lazy(x + lift - y, wn, wns, q);
    a[k] = s >= q ? s - q : s;
    a[k + kSpan] = d >= q ? d - q : d;
  }
}

// The inverse's top stages kBl.. on a thread's groups, each stage's
// twiddles loaded just before it (fewer words live at once), the last
// with n^-1 folded in.
template <bool kGrow, int kTop, int kSubLog, int kGroups, int kBl>
__device__ __forceinline__ void top_stages_inverse(uint64_t (&top)[kGroups][1 << kTop],
                                                   const uint64_t* __restrict__ w_row,
                                                   const uint64_t* __restrict__ ws_row,
                                                   uint32_t tw_top, uint64_t q, uint64_t ni,
                                                   uint64_t nis, uint64_t ratio_hi,
                                                   uint64_t ratio_lo) {
  uint64_t w[1 << kTop], ws[1 << kTop];
  load_twiddles<kTop, kSubLog, kBl + 1, kBl>(w, ws, 0, tw_top, w_row, ws_row);
  if constexpr (kBl + 1 < kTop) {
#pragma unroll
    for (int h = 0; h < kGroups; ++h)
      stage<true, kGrow, kTop, kSubLog + kBl, kBl>(top[h], w, ws, q, q << 1);
    top_stages_inverse<kGrow, kTop, kSubLog, kGroups, kBl + 1>(top, w_row, ws_row, tw_top, q, ni,
                                                               nis, ratio_hi, ratio_lo);
  } else {
#pragma unroll
    for (int h = 0; h < kGroups; ++h)
      last_stage_scaled<kGrow, kTop, kSubLog + kBl>(top[h], w[(1 << kTop) - 2], ni, nis, q,
                                                    ratio_hi, ratio_lo);
  }
}

// in/out: [polys, 2^kLogN] whole polynomials; tw/tw_shoup: [limbs, N]
// bit-reversed powers of psi (forward) or psi^-1 (inverse); consts:
// [limbs, 3] rows (q, floor(2^128 / q) hi word, lo word); n_inv,
// n_inv_shoup: [limbs].  Block: blockDim.x / T polynomials of T threads.
template <bool kInv, bool kGrow, int kLogN, int kB>
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
  extern __shared__ uint64_t smem[];
  const uint32_t t = threadIdx.x % S::kT;
  const int slot = threadIdx.x / S::kT;
  const int64_t poly = static_cast<int64_t>(blockIdx.x) * (blockDim.x / S::kT) + slot;
  // a thread past the last polynomial computes on zeros in its own shared
  // slot and touches no device memory; it still meets every barrier
  const bool active = poly < polys;
  const int limb = active ? static_cast<int>(poly % limbs) : 0;
  const uint64_t q = consts[3 * limb];
  const uint64_t q2 = q << 1;
  const uint64_t* w_row = tw + static_cast<int64_t>(limb) * S::kN;
  const uint64_t* ws_row = tw_shoup + static_cast<int64_t>(limb) * S::kN;
  uint64_t* s = smem + slot * S::kWords;
  const int64_t base = (active ? poly : 0) * S::kN;

  uint64_t a[S::kR];
  if constexpr (kInv) {
    load_contiguous<kB>(a, in + base + (t << kB), active);
  } else {
    // first window: the top kB bits; register k sits k * T words on
#pragma unroll
    for (int k = 0; k < S::kR; ++k) a[k] = active ? in[base + t + k * S::kT] : 0;
  }

  passes<kInv, kGrow, kLogN, kB, 0>(a, s, t, S::kN, w_row, ws_row, q, q2);
  if (!active) return;

  if constexpr (kInv) {
    // last window: the top kB bits again
    const uint64_t ni = n_inv[limb];
    const uint64_t nis = n_inv_shoup[limb];
#pragma unroll
    for (int k = 0; k < S::kR; ++k) {
      const uint64_t r = mul_shoup_lazy(a[k], ni, nis, q);
      out[base + t + k * S::kT] = r >= q ? r - q : r;
    }
  } else {
    store_reduced<kGrow, kB>(out + base + (t << kB), a, q, q2, consts[3 * limb + 1]);
  }
}

// A split ring of N = 2^(kSubLog + kTop) words: one cluster of 2^kTop CTAs
// a polynomial limb (see the top of this file).  CTA rank r owns the
// sub-block of words [r 2^kSubLog, (r + 1) 2^kSubLog), held as ntt_kernel
// holds a polynomial: T = 2^(kSubLog - 3) threads of 8 words, the
// exchanges in its buffer `xs`.  For the top kTop stages the limb's
// T 2^kTop threads each take the words those stages mix: thread g = r T + t
// holds, for each of its 8 >> kTop groups h, the 2^kTop words m 2^kSubLog + j
// (m < 2^kTop) with j = h T 2^kTop + g, so consecutive threads take
// consecutive words.  Between the top stages and the sub-blocks' passes
// each word crosses from CTA to CTA the same way in both directions: its
// holder stores it into its own shared memory, a cluster barrier, and the
// thread that takes it next loads it from there (distributed shared
// memory).  Word (m, j) sits in the top stages' layout at slot
// (h 2^kTop + m) T + t of CTA r's `xs` (the forward's), or in the
// sub-block's own layout at padded(j) of CTA m's (the inverse's).  A
// second barrier keeps a CTA's `xs` as it is until its siblings have read
// it: the forward's waits before the sub-block's first exchange, after its
// first pass; the inverse's before the CTA leaves.  Same arguments as
// ntt_kernel; a cluster past the last polynomial computes on zeros,
// touches no device memory and meets every barrier.
// 3 CTAs of 512 threads an SM (at most 40 registers; 4 bytes spilled at
// most): 7-19% faster than 2 CTAs for the forward on the H100, and for the
// inverse once its top stages load their twiddles one stage at a time
// (top_stages_inverse), except under one wave of clusters (PERF.md).
template <bool kInv, bool kGrow, int kSubLog, int kTop>
__global__ void __launch_bounds__(Shape<kSubLog, 3>::kMaxThreads,
                                  1536 / Shape<kSubLog, 3>::kMaxThreads)
ntt_cluster_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                   int64_t polys, int limbs, const uint64_t* __restrict__ tw,
                   const uint64_t* __restrict__ tw_shoup,
                   const uint64_t* __restrict__ consts,
                   const uint64_t* __restrict__ n_inv,
                   const uint64_t* __restrict__ n_inv_shoup) {
  using S = Shape<kSubLog, 3>;
  static_assert(windows_cover_every_stage_once<kInv, kSubLog, 3>(),
                "kernel A's passes must cover each stage once, in order");
  static_assert(kTop >= 1 && kTop <= 3, "a thread's 8 words hold whole top-stage groups");
  constexpr int kM = 1 << kTop;                    // words a top-stage group
  constexpr int kGroups = S::kR >> kTop;           // groups a thread
  constexpr uint32_t kSub = 1u << kSubLog;
  constexpr uint32_t kN = kSub << kTop;
  constexpr uint32_t kTopThreads = S::kT << kTop;  // a limb's threads
  // the sub-block's window next to the top stages (the forward's first,
  // the inverse's last): its top 3 bits, register k at word k T + t
  constexpr int kEdge = kSubLog - 3;
  extern __shared__ uint64_t xs[];
  const uint32_t t = threadIdx.x;
  const uint32_t rank = cluster_ctarank();
  const int64_t poly = static_cast<int64_t>(blockIdx.x >> kTop);
  const bool active = poly < polys;
  const int limb = active ? static_cast<int>(poly % limbs) : 0;
  const uint64_t q = consts[3 * limb];
  const uint64_t q2 = q << 1;
  const uint64_t* w_row = tw + static_cast<int64_t>(limb) * kN;
  const uint64_t* ws_row = tw_shoup + static_cast<int64_t>(limb) * kN;
  const int64_t base = (active ? poly : 0) * kN;
  const uint32_t g = rank * S::kT + t;
  // a sub-block's stage on bit b takes psi_rev[((N + o) >> (b + 1)) + ...]
  const uint32_t tw_sub = kN + (rank << kSubLog);
  uint64_t a[S::kR], top[kGroups][kM];
  // the top stages' twiddles are the same in every thread of the limb
  // (j < 2^kSubLog adds nothing to (N + j) >> (b + 1) for b >= kSubLog)

  if constexpr (!kInv) {
    uint64_t w[kM], ws[kM];
    load_twiddles<kTop, kSubLog, kTop, 0>(w, ws, 0, kN, w_row, ws_row);
#pragma unroll
    for (int h = 0; h < kGroups; ++h)
#pragma unroll
      for (int m = 0; m < kM; ++m)
        top[h][m] = active ? in[base + m * kSub + h * kTopThreads + g] : 0;
#pragma unroll
    for (int h = 0; h < kGroups; ++h) {
      stages<false, kGrow, kTop, kSubLog, kTop, 0>(top[h], w, ws, q, q2);
#pragma unroll
      for (int m = 0; m < kM; ++m) xs[(h * kM + m) * S::kT + t] = top[h][m];
    }
    cluster_arrive();
    cluster_wait();  // every CTA's top-stage words are in its shared memory
    // register k: word k T + t of this sub-block, held by thread t of CTA
    // k mod 2^kTop in its group k / 2^kTop
#pragma unroll
    for (int k = 0; k < S::kR; ++k)
      a[k] = cluster_load(cluster_map(xs + (((k >> kTop) * kM + rank) * S::kT + t),
                                      k & (kM - 1)));
    cluster_arrive();  // done with the other CTAs' shared memory
    passes<false, kGrow, kSubLog, 3, 0, 1>(a, xs, t, tw_sub, w_row, ws_row, q, q2);
    cluster_wait();  // and they with this one's, before the first exchange reuses it
    passes<false, kGrow, kSubLog, 3, 1>(a, xs, t, tw_sub, w_row, ws_row, q, q2);
    if (active)
      store_reduced<kGrow, 3>(out + base + (rank << kSubLog) + (t << 3), a, q, q2,
                              consts[3 * limb + 1]);
  } else {
    load_contiguous<3>(a, in + base + (rank << kSubLog) + (t << 3), active);
    passes<true, kGrow, kSubLog, 3, 0>(a, xs, t, tw_sub, w_row, ws_row, q, q2);
    __syncthreads();  // the last exchange's reads
    to_shared<3, kEdge, 3>(xs, a, t);
    cluster_arrive();
    cluster_wait();  // every sub-block is in its CTA's shared memory
#pragma unroll
    for (int h = 0; h < kGroups; ++h)
#pragma unroll
      for (int m = 0; m < kM; ++m)
        top[h][m] = cluster_load(cluster_map(xs + padded(h * kTopThreads + g), m));
    cluster_arrive();  // done with the other CTAs' shared memory
    top_stages_inverse<kGrow, kTop, kSubLog, kGroups, 0>(top, w_row, ws_row, kN, q, n_inv[limb],
                                                         n_inv_shoup[limb], consts[3 * limb + 1],
                                                         consts[3 * limb + 2]);
    if (active) {
#pragma unroll
      for (int h = 0; h < kGroups; ++h)
#pragma unroll
        for (int m = 0; m < kM; ++m) out[base + m * kSub + h * kTopThreads + g] = top[h][m];
    }
    cluster_wait();  // no CTA leaves while another may still read its shared memory
  }
}

constexpr size_t kDefaultSharedBytes = 48 * 1024;
constexpr int kBlockMaxLog = 13;  // one block a limb up to N=8192
constexpr int kSubLog = 12;       // above it, a CTA's sub-block: 4,096 words

struct Args {
  int64_t polys;  // batch * limbs
  int limbs;
  int polys_per_block;
  int64_t blocks;
  const uint64_t* tw;
  const uint64_t* tw_shoup;
  const uint64_t* consts;
  const uint64_t* n_inv;
  const uint64_t* n_inv_shoup;
  cudaStream_t stream;
};

// The block kernel over a.polys polynomials of 2^kLogN words, after raising
// its shared-memory limit where a block needs more than the default.
template <bool kInv, bool kGrow, int kLogN, int kB>
cudaError_t launch_blocks(const Args& a, const uint64_t* in, uint64_t* out) {
  using S = Shape<kLogN, kB>;
  const size_t smem = static_cast<size_t>(a.polys_per_block) * S::kWords * sizeof(uint64_t);
  if (smem > kDefaultSharedBytes) {
    const cudaError_t err =
        cudaFuncSetAttribute(ntt_kernel<kInv, kGrow, kLogN, kB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  ntt_kernel<kInv, kGrow, kLogN, kB>
      <<<static_cast<unsigned>(a.blocks), a.polys_per_block * S::kT, smem, a.stream>>>(
          in, out, a.polys, a.limbs, a.tw, a.tw_shoup, a.consts, a.n_inv, a.n_inv_shoup);
  return cudaGetLastError();
}

// The cluster kernel of a ring of 2^(kSubLog + kTop) words over a.blocks
// CTAs in clusters of 2^kTop; or, where max_clusters is given, only how many
// of those clusters the card holds at once (cudaOccupancyMaxActiveClusters).
template <bool kInv, bool kGrow, int kTop>
cudaError_t launch_cluster(const Args& a, const uint64_t* in, uint64_t* out, int* max_clusters) {
  using S = Shape<kSubLog, 3>;
  auto* kernel = ntt_cluster_kernel<kInv, kGrow, kSubLog, kTop>;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1u << kTop;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  // clusters of 4 (N=16384) ran 5-6% faster placed for load balance, those
  // of 8 up to 2% slower (PERF.md)
  attr[1].id = cudaLaunchAttributeClusterSchedulingPolicyPreference;
  attr[1].val.clusterSchedulingPolicyPreference =
      kTop == 2 ? cudaClusterSchedulingPolicyLoadBalancing : cudaClusterSchedulingPolicyDefault;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.blocks));
  cfg.blockDim = dim3(S::kT);
  cfg.dynamicSmemBytes = S::kWords * sizeof(uint64_t);
  cfg.stream = a.stream;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  if (cfg.dynamicSmemBytes > kDefaultSharedBytes) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(cfg.dynamicSmemBytes));
    if (err != cudaSuccess) return err;
  }
  if (max_clusters != nullptr) return cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, in, out, a.polys, a.limbs, a.tw,
                                             a.tw_shoup, a.consts, a.n_inv, a.n_inv_shoup);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <bool kInv, bool kGrow>
cudaError_t launch_ring(int log_n, int radix_bits, const Args& a, const uint64_t* in,
                        uint64_t* out, int* max_clusters) {
  if (log_n > kBlockMaxLog) {
    switch (log_n - kSubLog) {
      case 2: return launch_cluster<kInv, kGrow, 2>(a, in, out, max_clusters);
      case 3: return launch_cluster<kInv, kGrow, 3>(a, in, out, max_clusters);
      default: return cudaErrorInvalidValue;
    }
  }
  if (max_clusters != nullptr) return cudaErrorInvalidValue;
  switch (log_n * 4 + radix_bits) {
#define PIR_NTT_BLOCKS(LOG_N, B) \
  case LOG_N * 4 + B: return launch_blocks<kInv, kGrow, LOG_N, B>(a, in, out);
    PIR_NTT_BLOCKS(6, 2) PIR_NTT_BLOCKS(6, 3) PIR_NTT_BLOCKS(7, 2) PIR_NTT_BLOCKS(7, 3)
    PIR_NTT_BLOCKS(8, 2) PIR_NTT_BLOCKS(8, 3) PIR_NTT_BLOCKS(9, 2) PIR_NTT_BLOCKS(9, 3)
    PIR_NTT_BLOCKS(10, 2) PIR_NTT_BLOCKS(10, 3) PIR_NTT_BLOCKS(11, 2) PIR_NTT_BLOCKS(11, 3)
    PIR_NTT_BLOCKS(12, 2) PIR_NTT_BLOCKS(12, 3) PIR_NTT_BLOCKS(13, 3)
#undef PIR_NTT_BLOCKS
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(int inverse, int grow, int log_n, int radix_bits, const Args& a,
                     const uint64_t* in, uint64_t* out, int* max_clusters) {
  if (inverse != 0)
    return grow != 0 ? launch_ring<true, true>(log_n, radix_bits, a, in, out, max_clusters)
                     : launch_ring<true, false>(log_n, radix_bits, a, in, out, max_clusters);
  return grow != 0 ? launch_ring<false, true>(log_n, radix_bits, a, in, out, max_clusters)
                   : launch_ring<false, false>(log_n, radix_bits, a, in, out, max_clusters);
}

}  // namespace

extern "C" {

// Transform `batch * limbs` polynomials of 2^log_n words (6 <= log_n <= 15)
// as ops/ntt.py::ntt_plan lays them out: up to log_n 13, blocks of
// polys_per_block polynomials, 2^radix_bits words a thread (radix_bits 2 or
// 3; 3 from log_n 13), `blocks` blocks, cluster_ctas 1; above it (log_n 14,
// 15) one cluster of cluster_ctas = 2^(log_n - 12) CTAs a polynomial
// (radix_bits 3, polys_per_block 1), `blocks` CTAs in all.  `grow` (every
// modulus below 2^min(50, 63 - log_n)) selects the butterflies without
// conditional subtracts.  consts: [limbs, 3] (q, floor(2^128/q) hi word, lo
// word).  Returns the first launch error, cudaErrorInvalidValue for a layout
// whose grid does not cover the work or is not a whole number of clusters.
int pir_ntt(const void* in, void* out, int64_t batch, int limbs, int log_n, int inverse,
            int radix_bits, int polys_per_block, int64_t blocks, int cluster_ctas, int grow,
            const void* tw, const void* tw_shoup, const void* consts, const void* n_inv,
            const void* n_inv_shoup, void* stream) {
  const int64_t polys = batch * limbs;
  const bool split = log_n > kBlockMaxLog;
  const int block_log = split ? kSubLog : log_n;
  if (polys_per_block < 1 || block_log < 6 || log_n > kSubLog + 3 ||
      (static_cast<int64_t>(polys_per_block) << block_log >> radix_bits) > 1024 ||
      blocks < 1 || blocks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if (split ? cluster_ctas != 1 << (log_n - kSubLog) || radix_bits != 3 ||
                  polys_per_block != 1 || blocks % cluster_ctas != 0 ||
                  blocks / cluster_ctas < polys
            : cluster_ctas != 1 || blocks * polys_per_block < polys)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{polys, limbs, polys_per_block, blocks,
               static_cast<const uint64_t*>(tw), static_cast<const uint64_t*>(tw_shoup),
               static_cast<const uint64_t*>(consts), static_cast<const uint64_t*>(n_inv),
               static_cast<const uint64_t*>(n_inv_shoup), static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch(inverse, grow, log_n, radix_bits, a,
                                   static_cast<const uint64_t*>(in),
                                   static_cast<uint64_t*>(out), nullptr));
}

// How many clusters of the split ring 2^log_n (log_n 14, 15) the card holds
// at once, into *clusters (cudaOccupancyMaxActiveClusters); 0 means a
// cluster cannot be resident, a fault of the layout.
int pir_ntt_max_active_clusters(int log_n, int inverse, int grow, int* clusters) {
  if (log_n <= kBlockMaxLog || log_n > kSubLog + 3 || clusters == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{1, 1, 1, int64_t{1} << (log_n - kSubLog), nullptr, nullptr, nullptr, nullptr,
               nullptr, nullptr};
  return static_cast<int>(dispatch(inverse, grow, log_n, 3, a, nullptr, nullptr, clusters));
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
