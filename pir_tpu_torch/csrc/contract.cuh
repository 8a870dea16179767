// The exact wide contraction mod q behind kernel E2 (csrc/keyswitch.cu,
// pir_ks_inner) and kernel F2 (csrc/upper.cu, pir_contract):
//
//   out[r, k, j, n] = sum_i x[r, i, j, n] * w[i, k, j, n]  mod q_j,  k = 0, 1
//
// with x u64 [R, I, J, N], w [I, 2, J, N] and out [R, 2, J, N], every word
// below its limb's q_j < 2^61, and the moduli a u64 [J, 3] table of (q,
// floor(2^128/q) hi word, lo word) rows.  E2 contracts a key switch's digits
// [R, L, Lp, N] with the key [L, 2, Lp, N] (it replaces
// pir_tpu/ops/keyswitch.py:52, _digit_inner_product, in each of its three
// methods); F2 an upper level's digit plaintexts, the items [P, D, L, N],
// with the selection vector [D, 2, L, N] (it replaces
// pir_tpu/ops/scan.py:35, contract_dim without companions).
//
// Arithmetic: a thread sums its products exactly and reduces the sum after
// every `chunk` of its terms and at the end of each step; reduced words are
// added mod q.  A reduced residue is unique, so every split of the sum gives
// the plain versions' words, and so pir_tpu's.  Two word paths, by the
// widest modulus (ops/scan_kernel.py::contract_path):
// * below 2^48: 96-bit sums of three 32-bit words (modarith.cuh::mac96, 7
//   multiply-adds a product; mac32, 3, below 2^32) and one three-word
//   Barrett reduction (barrett_reduce_96, the port of pir_tpu's
//   barrett_reduce96, below 2^32; barrett_reduce_96_short, its one-word
//   ratio form with half the multiplies, above), exact while
//   chunk (q - 1)^2 < 2^96;
// * up to 61 bits: 128-bit sums of four 32-bit words (mac128w, the 64 x 64
//   product as four 32 x 32 products on the carry chain) and the two-word
//   reduction, exact while chunk (q - 1)^2 < 2^127.
// ops/scan_kernel.py::contract_chunk sets chunk to keep it so.
//
// What bounds it on the H100: bytes at every served shape (8 bytes a word
// of x, and of w or out, against 7-12 multiplies a product), but the
// multiply-adds and the reductions take about as long as the bytes, so how
// far they overlap sets the time.  The designs this replaces gave a thread
// one coefficient of 8 rows (E2) or 4 prefixes (F2), issued all its loads,
// then all its multiplies, then all its stores, in 128-bit sums: E2 ran at
// 43-48% of its byte bound, and F2 at N=4096, whose 128 blocks each walked
// 162 rows, at 11% (NVIDIA H100 80GB HBM3, 700 W; contract_variants.py).
//
// Design (ops/scan_kernel.py::contract_plan lays out the launch): a block
// takes one limb j and width = 32 x coeff_warps coefficients, and `splits`
// warps split the summed axis: warp (cw, s) owns the coefficients
// cw * 32 .. cw * 32 + 31 of the block and the terms s, s + splits, ... of
// each i-block of splits x kTerms terms.  A thread loads its terms' two w
// words once into registers and keeps them while the block walks its row
// tiles (tiles g, g + G, ... of kRows rows, G = gridDim.y), so w leaves
// device memory G times.  Each (i-block, row tile) step's x words are
// copied with cp.async (csrc/async.cuh) by the warp that multiplies them,
// 16 bytes a lane, into a ring of `stages` steps in shared memory: right
// after a step's barrier the block issues the step stages - 1 ahead, which
// lands while it multiplies and reduces this one.  With splits > 1 the
// warps' partials meet in shared memory: unreduced where the step's terms
// fit one exact sum (then each word takes one reduction), else reduced and
// added mod q.  An i-block after the first (I above splits x kTerms, the
// kLater instances) adds its words to those the earlier ones stored.  The
// register budget (__launch_bounds__ with kMinBlocks) holds three blocks
// of 8 warps an SM; two rows a tile, two stages and this budget were the
// fastest of pir_tpu_torch/contract_variants.py's layouts.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "async.cuh"
#include "modarith.cuh"

namespace {
namespace contract {

constexpr int kMaxWarps = 8;   // coefficient warps x split warps a block
constexpr int kMinBlocks = 3;  // blocks of kMaxWarps an SM holds at least
constexpr int kMaxShared = 232448;  // a block's dynamic shared memory on the H100
// word paths: every modulus below 2^32, below 2^48, up to 61 bits
constexpr int kWords32 = 32;
constexpr int kWords48 = 48;
constexpr int kWords64 = 64;

// q, floor(2^128 / q) as two words, and for q above 2^32 floor(2^96 / q)
struct Modulus {
  uint64_t q, ratio_hi, ratio_lo, ratio96;
  bool above32;
};

// A thread's exact sum of products, kept as it is or as two words (w[0]
// low, w[1] high) in shared memory: three 32-bit words below 2^48 ...
template <int kPath>
struct Sum {
  uint32_t a0, a1, a2;
  __device__ __forceinline__ void clear() { a0 = a1 = a2 = 0; }
  __device__ __forceinline__ void to_words(uint64_t* w, int stride) const {
    w[0] = (static_cast<uint64_t>(a1) << 32) | a0;
    w[stride] = a2;
  }
  __device__ __forceinline__ void add_words(const uint64_t* w, int stride) {
    const uint64_t lo = (static_cast<uint64_t>(a1) << 32) | a0;
    const uint64_t sum = lo + w[0];
    a2 += static_cast<uint32_t>(w[stride]) + (sum < lo ? 1 : 0);
    a0 = static_cast<uint32_t>(sum);
    a1 = static_cast<uint32_t>(sum >> 32);
  }
  __device__ __forceinline__ void add(uint64_t x, uint64_t w) {
    if constexpr (kPath == kWords32)
      mac32(a0, a1, a2, static_cast<uint32_t>(x), static_cast<uint32_t>(w));
    else
      mac96(a0, a1, a2, static_cast<uint32_t>(x), static_cast<uint32_t>(x >> 32),
            static_cast<uint32_t>(w), static_cast<uint32_t>(w >> 32));
  }
  __device__ __forceinline__ uint64_t reduce(const Modulus& m) const {
    const uint64_t lo = (static_cast<uint64_t>(a1) << 32) | a0;
    if (m.above32) return barrett_reduce_96_short(a2, lo, m.q, m.ratio96);
    return barrett_reduce_96(a2, lo, m.q, m.ratio_hi, m.ratio_lo);
  }
};

// ... and four above
template <>
struct Sum<kWords64> {
  uint32_t a0, a1, a2, a3;
  __device__ __forceinline__ void clear() { a0 = a1 = a2 = a3 = 0; }
  __device__ __forceinline__ uint64_t lo() const { return (static_cast<uint64_t>(a1) << 32) | a0; }
  __device__ __forceinline__ uint64_t hi() const { return (static_cast<uint64_t>(a3) << 32) | a2; }
  __device__ __forceinline__ void to_words(uint64_t* w, int stride) const {
    w[0] = lo();
    w[stride] = hi();
  }
  __device__ __forceinline__ void add_words(const uint64_t* w, int stride) {
    const uint64_t sum = lo() + w[0];
    const uint64_t high = hi() + w[stride] + (sum < w[0] ? 1 : 0);
    a0 = static_cast<uint32_t>(sum);
    a1 = static_cast<uint32_t>(sum >> 32);
    a2 = static_cast<uint32_t>(high);
    a3 = static_cast<uint32_t>(high >> 32);
  }
  __device__ __forceinline__ void add(uint64_t x, uint64_t w) {
    mac128w(a0, a1, a2, a3, static_cast<uint32_t>(x), static_cast<uint32_t>(x >> 32),
            static_cast<uint32_t>(w), static_cast<uint32_t>(w >> 32));
  }
  __device__ __forceinline__ uint64_t reduce(const Modulus& m) const {
    return barrett_reduce_128(hi(), lo(), m.q, m.ratio_hi, m.ratio_lo);
  }
};

struct Args {
  const uint64_t* x;
  const uint64_t* w;
  const uint64_t* table;
  uint64_t* out;
  int64_t R, N, chunk;
  int I, J, coeff_warps, splits, stages;
};

// cp.async.wait_group with a run-time count (stages - 2, at most 2)
__device__ __forceinline__ void copy_wait_upto(int pending) {
  if (pending >= 2)
    copy_wait<2>();
  else if (pending == 1)
    copy_wait<1>();
  else
    copy_wait<0>();
}

// An out word of an earlier i-block, read where the accumulating store
// needs it and nowhere else (volatile: never speculated into the first
// i-block's stores, which read nothing)
__device__ __forceinline__ uint64_t load_word(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.global.cg.u64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}

// A step: i-block ib of the block's k-th row tile (rows from r0), in ring
// slot `slot`; the block's steps take its row tiles in turn for each
// i-block, advanced without divisions
struct Step {
  int ib, slot;
  int64_t k, r0;
};

// grid (J x N / width, G), 32 x coeff_warps x splits threads; kLater: the
// summed axis takes more than one i-block (only with 8 terms a thread)
template <int kPath, int kRows, int kTerms, bool kLater>
__global__ void __launch_bounds__(32 * kMaxWarps, kMinBlocks) contract_kernel(const Args a) {
  extern __shared__ __align__(16) uint64_t smem[];
  const uint64_t* __restrict__ x = a.x;
  const uint64_t* __restrict__ w = a.w;
  const int width = 32 * a.coeff_warps;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cw = warp % a.coeff_warps;
  const int s = warp / a.coeff_warps;
  const int64_t coeff_tiles = a.N / width;
  const int j = static_cast<int>(blockIdx.x / coeff_tiles);
  const int64_t n_blk = static_cast<int64_t>(blockIdx.x % coeff_tiles) * width;
  const int64_t n = n_blk + cw * 32 + lane;  // this thread's coefficient
  const int64_t plane = static_cast<int64_t>(a.J) * a.N;  // from one (r, i), (i, k) or (r, k) row to the next
  const int64_t col = static_cast<int64_t>(j) * a.N;
  const int span = a.splits * kTerms;  // terms an i-block
  const int iblocks = (a.I + span - 1) / span;
  const int64_t row_tiles = (a.R + kRows - 1) / kRows;
  const int64_t tiles = (row_tiles - 1 - blockIdx.y) / gridDim.y + 1;  // this block's
  const int64_t tile_rows = static_cast<int64_t>(gridDim.y) * kRows;  // from one of its tiles to the next
  const int stage_words = kRows * kTerms * a.splits * width;
  uint64_t* partial = smem + a.stages * stage_words;  // [splits][kRows][2][2][width]
  const uint64_t q = a.table[3 * j], ratio_hi = a.table[3 * j + 1], ratio_lo = a.table[3 * j + 2];
  const Modulus mod{q, ratio_hi, ratio_lo, (ratio_hi << 32) | (ratio_lo >> 32), q >> 32 != 0};
  const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0;

  auto advance = [&](Step& st) {
    st.slot = st.slot + 1 == a.stages ? 0 : st.slot + 1;
    st.r0 += tile_rows;
    if (++st.k == tiles) {
      st.k = 0;
      st.r0 = static_cast<int64_t>(blockIdx.y) * kRows;
      ++st.ib;
    }
  };
  // the warp's coefficients of its terms' x rows of step st into its ring
  // slot, laid out [kRows][kTerms][splits][width]: two 256-byte rows a warp
  // instruction, 16 bytes a lane (two 8-byte copies where x is not 16-byte
  // aligned); rows past R and terms past I are not copied
  auto copy_step = [&](const Step& st) {
    if (st.ib >= iblocks) return;
    const int i0 = st.ib * span + s;
    const int piece = 2 * (lane & 15);
    uint64_t* slot = smem + st.slot * stage_words + s * width + cw * 32 + piece;
    const uint64_t* src = x + col + n_blk + cw * 32 + piece;
    for (int tm = lane >> 4; tm < kRows * kTerms; tm += 2) {
      const int64_t r = st.r0 + tm / kTerms;
      const int i = i0 + (tm % kTerms) * a.splits;
      if (r < a.R && i < a.I) {
        const uint64_t* from = src + (r * a.I + i) * plane;
        uint64_t* to = slot + tm * a.splits * width;
        if (aligned) {
          copy_async16(to, from);
        } else {
          copy_async<8>(to, from);
          copy_async<8>(to + 1, from + 1);
        }
      }
    }
  };
  // out word u of this thread's at most 2 kRows a step (nullptr: none):
  // (row t, k) = (u / 2, u % 2) of its own coefficient, or with splits > 1
  // word o = threadIdx.x + u blockDim.x of the step's [kRows][2][width]
  auto out_word = [&](const Step& st, int rows, int u) -> uint64_t* {
    int t, k;
    int64_t nn;
    if (a.splits == 1) {
      t = u >> 1;
      k = u & 1;
      nn = n;
    } else {
      const int o = threadIdx.x + u * blockDim.x;
      t = o / (2 * width);
      k = (o / width) & 1;
      nn = n_blk + o % width;
    }
    return t < rows ? a.out + (2 * (st.r0 + t) + k) * plane + col + nn : nullptr;
  };

  Step cur{0, 0, 0, static_cast<int64_t>(blockIdx.y) * kRows};
  Step ahead = cur;
  for (int c = 0; c < a.stages - 1; ++c) {
    copy_step(ahead);
    copy_commit();
    advance(ahead);
  }
  uint64_t wk[kTerms][2];
  for (; cur.ib < iblocks; advance(cur)) {
    if (a.stages == 1) {
      copy_step(cur);
      copy_commit();
    }
    copy_wait_upto(a.stages - 2);  // this thread's copies of this step have landed
    __syncthreads();               // everyone's have, and the last step is consumed
    if (a.stages > 1) {
      copy_step(ahead);  // into the last step's slot
      copy_commit();
      advance(ahead);
    }
    const int i0 = cur.ib * span + s;
    const int rows = a.R - cur.r0 < kRows ? static_cast<int>(a.R - cur.r0) : kRows;
    if (cur.k == 0) {  // the w words of this i-block's terms, kept across its row tiles
#pragma unroll
      for (int m = 0; m < kTerms; ++m) {
        const int64_t i = i0 + m * a.splits;
        wk[m][0] = i < a.I ? w[2 * i * plane + col + n] : 0;
        wk[m][1] = i < a.I ? w[(2 * i + 1) * plane + col + n] : 0;
      }
    }
    // the earlier i-blocks' words this thread adds to, read now so that the
    // reads overlap the sums
    uint64_t prev[2 * kRows];
    if (kLater && cur.ib > 0) {
#pragma unroll
      for (int u = 0; u < 2 * kRows; ++u) {
        const uint64_t* o = out_word(cur, rows, u);
        prev[u] = o != nullptr ? load_word(o) : 0;
      }
    }
    const uint64_t* slot = smem + cur.slot * stage_words + s * width + cw * 32 + lane;

    Sum<kPath> acc[kRows][2];
    uint64_t res[kRows][2];
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      acc[t][0].clear();
      acc[t][1].clear();
      res[t][0] = res[t][1] = 0;
    }
    auto fold = [&] {
#pragma unroll
      for (int t = 0; t < kRows; ++t) {
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          res[t][k] = add_mod(res[t][k], acc[t][k].reduce(mod), mod.q);
          acc[t][k].clear();
        }
      }
    };
    int64_t terms = 0;
#pragma unroll
    for (int m = 0; m < kTerms; ++m) {
      if (i0 + m * a.splits < a.I) {
#pragma unroll
        for (int t = 0; t < kRows; ++t) {
          if (t < rows) {
            const uint64_t v = slot[(t * kTerms + m) * a.splits * width];
            acc[t][0].add(v, wk[m][0]);
            acc[t][1].add(v, wk[m][1]);
          }
        }
        if (++terms == a.chunk) {
          fold();
          terms = 0;
        }
      }
    }
    // with split warps whose terms together fit one exact sum, each warp's
    // sums meet the others' unreduced and the block reduces each word once
    const bool raw = a.splits > 1 && a.chunk >= span;
    if (!raw && terms > 0) fold();

    // out[r, k, j, nn] = v, added mod q to an earlier i-block's word
    auto store = [&](int u, uint64_t v) {
      uint64_t* o = out_word(cur, rows, u);
      if (o != nullptr) *o = kLater && cur.ib > 0 ? add_mod(prev[u], v, mod.q) : v;
    };
    if (a.splits == 1) {
#pragma unroll
      for (int t = 0; t < kRows; ++t) {
        store(2 * t, res[t][0]);
        store(2 * t + 1, res[t][1]);
      }
      if (a.stages == 1) __syncthreads();  // the slot is read before the next step's copy
    } else {
      // [splits][kRows][2][2 words][width]: a reduced word, or a sum's two words
      const int stride = kRows * 4 * width;
      uint64_t* mine = partial + s * stride + cw * 32 + lane;
#pragma unroll
      for (int t = 0; t < kRows; ++t) {
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          uint64_t* at = mine + (2 * t + k) * 2 * width;
          if (raw)
            acc[t][k].to_words(at, width);
          else
            at[0] = res[t][k];
        }
      }
      __syncthreads();
      const int words = kRows * 2 * width;
#pragma unroll
      for (int u = 0; u < 2 * kRows; ++u) {
        const int o = threadIdx.x + u * blockDim.x;
        if (o < words) {
          const uint64_t* at = partial + (o / width) * 2 * width + o % width;
          uint64_t v;
          if (raw) {
            Sum<kPath> sum;
            sum.clear();
            for (int s2 = 0; s2 < a.splits; ++s2) sum.add_words(at + s2 * stride, width);
            v = sum.reduce(mod);
          } else {
            v = at[0];
            for (int s2 = 1; s2 < a.splits; ++s2) v = add_mod(v, at[s2 * stride], mod.q);
          }
          store(u, v);
        }
      }
    }
  }
}

template <int kPath, int kRows, int kTerms, bool kLater = false>
int launch(const Args& a, int shared_bytes, int64_t grid_x, int grid_y, cudaStream_t stream) {
  const auto kernel = contract_kernel<kPath, kRows, kTerms, kLater>;
  // above 48 KB a block's dynamic shared memory must be asked for
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(grid_x), static_cast<unsigned>(grid_y));
  const dim3 block(static_cast<unsigned>(32 * a.coeff_warps * a.splits));
  kernel<<<grid, block, shared_bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int kPath>
int launch_path(const Args& a, int rows, int terms, int shared_bytes, int64_t grid_x, int grid_y,
                cudaStream_t stream) {
  if (terms == 2) {
    if (rows == 1) return launch<kPath, 1, 2>(a, shared_bytes, grid_x, grid_y, stream);
    return launch<kPath, 2, 2>(a, shared_bytes, grid_x, grid_y, stream);
  }
  if (terms == 4) {
    if (rows == 1) return launch<kPath, 1, 4>(a, shared_bytes, grid_x, grid_y, stream);
    return launch<kPath, 2, 4>(a, shared_bytes, grid_x, grid_y, stream);
  }
  if (a.I > a.splits * 8) return launch<kPath, 1, 8, true>(a, shared_bytes, grid_x, grid_y, stream);
  return launch<kPath, 1, 8>(a, shared_bytes, grid_x, grid_y, stream);
}

// The contraction with ops/scan_kernel.py::contract_plan's launch: word
// path 32, 48 or 64; `rows` rows a tile and `terms` terms a thread an
// i-block, built as (rows, terms) in (1, 2), (2, 2), (1, 4), (2, 4), (1, 8)
// (which bounds the registers); coeff_warps x splits warps (at most kMaxWarps); a ring of
// `stages` (1-4) steps and the partials' buffer in exactly shared_bytes;
// grid_x = J x N / (32 coeff_warps) blocks, grid_y <= ceil(R / rows) row
// groups.  Returns a CUDA error code: cudaErrorInvalidValue, before
// anything runs, for a launch that does not cover the work.
int run(const void* x, const void* w, const void* table, void* out, int64_t R, int I, int J,
        int64_t N, int64_t chunk, int path, int rows, int terms, int coeff_warps, int splits,
        int stages, int shared_bytes, int64_t grid_x, int grid_y, void* stream) {
  const int64_t width = 32 * static_cast<int64_t>(coeff_warps);
  const bool built = (terms == 2 || terms == 4 || terms == 8) && (rows == 1 || rows == 2) &&
                     rows * terms <= 8;
  if (R < 1 || I < 1 || J < 1 || N < 1 || chunk < 1 || coeff_warps < 1 || splits < 1 ||
      coeff_warps * splits > kMaxWarps || N % width != 0 || stages < 1 || stages > 4 ||
      !built || (path != kWords32 && path != kWords48 && path != kWords64))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t row_tiles = (R + rows - 1) / rows;
  const int64_t need = 8 * (static_cast<int64_t>(stages) * rows * terms * splits * width +
                            (splits > 1 ? static_cast<int64_t>(splits) * rows * 4 * width : 0));
  if (grid_x != J * (N / width) || grid_x > 0x7fffffff || grid_y < 1 || grid_y > 65535 ||
      grid_y > row_tiles || shared_bytes != need || shared_bytes > kMaxShared)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const uint64_t*>(x), static_cast<const uint64_t*>(w),
               static_cast<const uint64_t*>(table), static_cast<uint64_t*>(out),
               R, N, chunk, I, J, coeff_warps, splits, stages};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == kWords32) return launch_path<kWords32>(a, rows, terms, shared_bytes, grid_x, grid_y, s);
  if (path == kWords48) return launch_path<kWords48>(a, rows, terms, shared_bytes, grid_x, grid_y, s);
  return launch_path<kWords64>(a, rows, terms, shared_bytes, grid_x, grid_y, s);
}

}  // namespace contract
}  // namespace
