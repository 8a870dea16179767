// Kernel B: the database scan contraction, exact wide accumulation.
//
// Replaces pir_tpu/ops/pallas_scan.py::_raw_kernel (K1) and, without a hi
// plane, ::_raw_kernel_u32 (K5, the tpu32 profile's moduli below 2^32),
// reached through contract_dim_raw / contract_dim_auto, which compute both
// the inner scan over the whole database and every upper-dimension scan; with
// the moduli of one rank of a limb-sharded mesh it is also ::_raw_kernel_dyn
// and ::_raw_kernel_u32_dyn (K6, contract_dim_raw_dyn):
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
// Design: a thread owns kV = 4 consecutive coefficients n of one limb and
// kPT = 2 prefixes.  Per row it needs four 16-byte pieces of the selection
// vector (2 columns x 4 coefficients, shared by both prefixes) and, per
// prefix, one 16-byte lo and one 4- or 8-byte hi piece of the planes.  It
// copies them with cp.async into its own slots of a ring in shared memory,
// 4 rows deep (3 with a u16 hi plane), so three rows of loads are in
// flight while it multiplies the fourth, and registers hold no loads in
// flight; no barrier is needed, as each thread reads only what it copied.
// The warps of a block split into `prefix_groups` (other prefixes, the same
// coefficients and rows: their selection-vector copies meet in L1) times
// `row_splits` (the same outputs over interleaved rows); the caller gives
// both and the grid.  Each term is a
// product of 48-bit words, summed exactly in three 32-bit words with the
// carry chain (mad.cc / madc; 96 bits hold D <= 2^(96 - 2 bits) rows,
// pallas_scan.max_raw_chunk, which the wrapper enforces); without a hi plane
// one 32x32 product and its carry.  Row splits add their partial sums
// exactly in shared memory (over the ring, once every warp is done with it)
// before the one Barrett reduction per output, so the result does not
// depend on the split.  ops/scan_kernel.py::scan_plan lays out the launch:
// it splits the rows until the grid holds 64 warps per SM (2 ways at the
// inner scan, 8 at the upper).
//
// What bounds it on the H100: the database planes, 5 bytes per coefficient
// at the 36-bit chain (26,244 x 2 x 4096 x 5 B ~ 1.07 GB per inner scan),
// read once at 3.35 TB/s, against 2 x 7 multiply-adds per database word on
// the CUDA cores' 32-bit integer pipe, which runs close behind.

#include <cstdint>

#include <cuda_runtime.h>

#include "async.cuh"
#include "modarith.cuh"

namespace {

constexpr int kV = 4;         // consecutive coefficients per thread
constexpr int kPT = 2;        // prefixes per thread
constexpr int kThreads = 256; // threads per block (prefix_groups x row_splits warps)
constexpr int kAcc = kPT * kV * 2 * 3;  // accumulator words per thread

template <int kHiBytes>
struct HiWord {
  using type = uint8_t;  // also the placeholder type when there is no plane
  using vec = uint32_t;  // kV hi words
};
template <>
struct HiWord<2> {
  using type = uint16_t;
  using vec = uint2;
};

// (a2:a1:a0) += (b2:b1:b0)
__device__ __forceinline__ void add96(uint32_t& a0, uint32_t& a1, uint32_t& a2,
                                      uint32_t b0, uint32_t b1, uint32_t b2) {
  asm("add.cc.u32 %0, %0, %3;\n\t"
      "addc.cc.u32 %1, %1, %4;\n\t"
      "addc.u32 %2, %2, %5;"
      : "+r"(a0), "+r"(a1), "+r"(a2)
      : "r"(b0), "r"(b1), "r"(b2));
}

// The ring of rows in flight per thread, in shared memory: per slot the
// selection-vector words (2 columns x kV, as 4 16-byte pieces), then the lo
// and hi plane words of both prefixes.  4 slots (3 with a u16 hi plane), so
// that two blocks of kThreads fit an SM.
template <int kHiBytes>
struct Ring {
  static constexpr int kStages = kHiBytes == 2 ? 3 : 4;
  static constexpr int kSvBytes = kStages * 4 * kThreads * 16;
  static constexpr int kLoBytes = kStages * kPT * kThreads * 16;
  static constexpr int kBytes =
      kSvBytes + kLoBytes + (kHiBytes ? kStages * kPT * kThreads * kHiBytes * kV : 0);
};

__device__ __forceinline__ uint32_t hi_word(uint32_t v, int i) {
  return (v >> (8 * i)) & 0xFFu;
}
__device__ __forceinline__ uint32_t hi_word(uint2 v, int i) {
  const uint32_t h = i < 2 ? v.x : v.y;
  return (h >> (16 * (i & 1))) & 0xFFFFu;
}
__device__ __forceinline__ uint32_t lo_word(uint4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// grid (ceil(P / (kPT * prefix_groups)), ceil(N / (32 * kV)), L); block
// kThreads = 32 * prefix_groups * row_splits threads; warp w takes prefix
// group w % prefix_groups and rows j = w / prefix_groups (mod row_splits).
template <int kHiBytes>
__global__ void __launch_bounds__(kThreads, 2)
scan_kernel(const uint64_t* __restrict__ sv,
            const typename HiWord<kHiBytes>::type* __restrict__ db_hi,
            const uint32_t* __restrict__ db_lo,
            const uint64_t* __restrict__ consts, uint64_t* __restrict__ out,
            int64_t P, int L, int64_t d_total, int64_t j_begin, int64_t D,
            int64_t N, int prefix_groups, int row_splits) {
  constexpr bool kHasHi = kHiBytes > 0;
  using HiVec = typename HiWord<kHiBytes>::vec;
  constexpr int kStages = Ring<kHiBytes>::kStages;
  // the ring: sv_s [kStages][4][kThreads], lo_s, hi_s [kStages][kPT][kThreads];
  // after the
  // rows, the same bytes carry the row splits' partial sums
  extern __shared__ __align__(16) unsigned char smem[];
  ulonglong2* sv_s = reinterpret_cast<ulonglong2*>(smem);
  uint4* lo_s = reinterpret_cast<uint4*>(smem + Ring<kHiBytes>::kSvBytes);
  HiVec* hi_s = reinterpret_cast<HiVec*>(smem + Ring<kHiBytes>::kSvBytes + Ring<kHiBytes>::kLoBytes);
  uint32_t* partial = reinterpret_cast<uint32_t*>(smem);  // [kAcc][(row_splits - 1) * groups * 32]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int group = warp % prefix_groups;
  const int split = warp / prefix_groups;
  const int64_t p0 = (static_cast<int64_t>(blockIdx.x) * prefix_groups + group) * kPT;
  const int64_t n0 = (static_cast<int64_t>(blockIdx.y) * 32 + lane) * kV;
  const int l = blockIdx.z;
  const bool active = p0 < P && n0 < N && split < row_splits;
  const bool has_p1 = p0 + 1 < P;

  uint32_t acc[kPT][kV][2][3];
#pragma unroll
  for (int p = 0; p < kPT; ++p)
#pragma unroll
    for (int v = 0; v < kV; ++v)
#pragma unroll
      for (int c = 0; c < 2; ++c) acc[p][v][c][0] = acc[p][v][c][1] = acc[p][v][c][2] = 0;

  if (active) {
    const int64_t sv_row = 2LL * L * N;  // stride of j in sv
    const uint64_t* sv0 = sv + static_cast<int64_t>(l) * N + n0;
    const int64_t sv_col = static_cast<int64_t>(L) * N;
    const int64_t plane_p = static_cast<int64_t>(L) * d_total * N;  // stride of p
    const int64_t base = (p0 * L + l) * d_total * N + j_begin * N + n0;
    // this thread's rows: split, split + row_splits, ...
    const int count = split < D ? static_cast<int>((D - split + row_splits - 1) / row_splits) : 0;

    // copy row i's selection-vector and plane words into ring slot i % kStages
    auto issue = [&](int i) {
      const int64_t j = split + static_cast<int64_t>(i) * row_splits;
      const int slot = i % kStages;
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int h = 0; h < kV / 2; ++h)
          copy_async<16>(&sv_s[(slot * 4 + c * 2 + h) * kThreads + threadIdx.x],
                         sv0 + j * sv_row + c * sv_col + 2 * h);
#pragma unroll
      for (int p = 0; p < kPT; ++p) {
        if (p == 0 || has_p1) {
          const int64_t idx = base + p * plane_p + j * N;
          copy_async16(&lo_s[(slot * kPT + p) * kThreads + threadIdx.x], db_lo + idx);
          if constexpr (kHasHi)
            copy_async<sizeof(HiVec)>(&hi_s[(slot * kPT + p) * kThreads + threadIdx.x],
                                      db_hi + idx);
        }
      }
    };
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      if (i < count) issue(i);
      copy_commit();
    }
    for (int i = 0; i < count; ++i) {
      if (i + kStages - 1 < count) issue(i + kStages - 1);
      copy_commit();
      copy_wait<kStages - 1>();  // row i has landed
      const int slot = i % kStages;
      ulonglong2 x2[2][kV / 2];
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int h = 0; h < kV / 2; ++h) x2[c][h] = sv_s[(slot * 4 + c * 2 + h) * kThreads + threadIdx.x];
      // (without a second prefix its words are never copied; its sums are
      // never stored)
      uint4 lo[kPT];
      HiVec hi[kPT];
#pragma unroll
      for (int p = 0; p < kPT; ++p) {
        lo[p] = lo_s[(slot * kPT + p) * kThreads + threadIdx.x];
        if constexpr (kHasHi) hi[p] = hi_s[(slot * kPT + p) * kThreads + threadIdx.x];
      }
#pragma unroll
      for (int v = 0; v < kV; ++v) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const ulonglong2 pair = x2[c][v / 2];
          const uint64_t x = (v & 1) ? pair.y : pair.x;
          const uint32_t xl = static_cast<uint32_t>(x);
          const uint32_t xh = static_cast<uint32_t>(x >> 32);
#pragma unroll
          for (int p = 0; p < kPT; ++p) {
            const uint32_t wl = lo_word(lo[p], v);
            uint32_t* a = acc[p][v][c];
            if constexpr (kHasHi)
              mac96(a[0], a[1], a[2], xl, xh, wl, hi_word(hi[p], v));
            else
              mac32(a[0], a[1], a[2], xl, wl);
          }
        }
      }
    }
    copy_wait<0>();
  }

  if (row_splits > 1) {
    // row splits 1.. hand their exact sums to split 0 (element-major, so a
    // warp's 32 lanes write 32 consecutive words), once every warp is done
    // with the ring those words overwrite
    __syncthreads();
    const int slots = (row_splits - 1) * prefix_groups * 32;
    if (split > 0) {
      const int slot = ((split - 1) * prefix_groups + group) * 32 + lane;
      int e = 0;
#pragma unroll
      for (int p = 0; p < kPT; ++p)
#pragma unroll
        for (int v = 0; v < kV; ++v)
#pragma unroll
          for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int w = 0; w < 3; ++w) partial[(e++) * slots + slot] = acc[p][v][c][w];
    }
    __syncthreads();
    if (split > 0) return;
    for (int r = 1; r < row_splits; ++r) {
      const int slot = ((r - 1) * prefix_groups + group) * 32 + lane;
      int e = 0;
#pragma unroll
      for (int p = 0; p < kPT; ++p)
#pragma unroll
        for (int v = 0; v < kV; ++v)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            uint32_t* a = acc[p][v][c];
            add96(a[0], a[1], a[2], partial[e * slots + slot],
                  partial[(e + 1) * slots + slot], partial[(e + 2) * slots + slot]);
            e += 3;
          }
    }
  }
  if (!active) return;

  const uint64_t q = consts[3 * l];
  const uint64_t rh = consts[3 * l + 1];
  const uint64_t rl = consts[3 * l + 2];
#pragma unroll
  for (int p = 0; p < kPT; ++p) {
    if (p > 0 && !has_p1) break;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      uint64_t r[kV];
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        const uint32_t* a = acc[p][v][c];
        r[v] = barrett_reduce_128(a[2], (static_cast<uint64_t>(a[1]) << 32) | a[0], q, rh, rl);
      }
      auto* o = reinterpret_cast<ulonglong2*>(out + (((p0 + p) * 2 + c) * L + l) * N + n0);
      o[0] = make_ulonglong2(r[0], r[1]);
      o[1] = make_ulonglong2(r[2], r[3]);
    }
  }
}

template <int kHiBytes>
void launch(const void* sv, const void* db_hi, const void* db_lo,
            const void* consts, void* out, int64_t P, int L, int64_t d_total,
            int64_t j_begin, int64_t D, int64_t N, int prefix_groups,
            int row_splits, dim3 grid, cudaStream_t s) {
  const size_t partial = static_cast<size_t>(kAcc) * (row_splits - 1) * prefix_groups * 32 *
                         sizeof(uint32_t);
  const size_t smem = partial > Ring<kHiBytes>::kBytes ? partial : Ring<kHiBytes>::kBytes;
  // above 48 KB a block's dynamic shared memory must be asked for
  cudaFuncSetAttribute(scan_kernel<kHiBytes>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  scan_kernel<kHiBytes><<<grid, kThreads, smem, s>>>(
      static_cast<const uint64_t*>(sv),
      static_cast<const typename HiWord<kHiBytes>::type*>(db_hi),
      static_cast<const uint32_t*>(db_lo), static_cast<const uint64_t*>(consts),
      static_cast<uint64_t*>(out), P, L, d_total, j_begin, D, N, prefix_groups,
      row_splits);
}

}  // namespace

extern "C" {

// out[P, 2, L, N] = contraction of sv[D, 2, L, N] with planes
// [P, L, d_total, N] over j in [j_begin, j_begin + D).  hi_bytes is the hi
// plane's element size: 1 or 2, or 0 for no hi plane (db_hi unused, moduli
// below 2^32).  S must be 2, N a multiple of 4 and every pointer 16-byte
// aligned (the hi plane's to 4 * hi_bytes); D <= 2^(96 - 2 * bits) keeps the
// sums exact (the caller chunks).  The launch (ops/scan_kernel.py::
// scan_plan): prefix_groups * row_splits = 8 warps a block, and a grid of
// prefix_tiles x coeff_tiles x L blocks, a block covering 2 * prefix_groups
// prefixes and 128 coefficients.  Returns cudaGetLastError().
int pir_scan(const void* sv, const void* db_hi, const void* db_lo,
             const void* consts, void* out, int hi_bytes, int64_t P, int S,
             int L, int64_t d_total, int64_t j_begin, int64_t D, int64_t N,
             int prefix_groups, int row_splits, int prefix_tiles, int coeff_tiles,
             void* stream) {
  if (S != 2 || N % kV != 0 || prefix_groups < 1 || row_splits < 1 ||
      prefix_groups * row_splits * 32 != kThreads ||
      static_cast<int64_t>(prefix_tiles) * kPT * prefix_groups < P ||
      static_cast<int64_t>(coeff_tiles) * 32 * kV < N)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(prefix_tiles), static_cast<unsigned>(coeff_tiles),
                  static_cast<unsigned>(L));
  if (hi_bytes == 0) {
    launch<0>(sv, nullptr, db_lo, consts, out, P, L, d_total, j_begin, D, N,
              prefix_groups, row_splits, grid, s);
  } else if (hi_bytes == 1) {
    launch<1>(sv, db_hi, db_lo, consts, out, P, L, d_total, j_begin, D, N,
              prefix_groups, row_splits, grid, s);
  } else if (hi_bytes == 2) {
    launch<2>(sv, db_hi, db_lo, consts, out, P, L, d_total, j_begin, D, N,
              prefix_groups, row_splits, grid, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
