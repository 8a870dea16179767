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
// Arithmetic: each product is summed exactly in a three-word (96-bit)
// accumulator with the carry chain (mac96: 7 multiply-adds with a hi plane,
// mac32: 3 without; csrc/modarith.cuh); with moduli below 2^b and
// D <= 2^(96-2b) rows (pallas_scan.max_raw_chunk) it cannot wrap.
//
// What bounds it on the H100: the multiply-adds.  A thread holds a 4 x 4
// tile (4 prefixes x 4 columns of one coefficient, 48 accumulator
// registers), which fits 128 registers without spills.  For each row it
// needs 4 selection-vector words and 4 database words; read from device
// memory (or L2) per thread, the selection vector alone is 2 bytes per
// product, and blocks that share the database but only 4 prefixes re-read
// each sv word from L2 ceil(P / 4) times (41 at the bench shape), which
// without a hi plane set the time.  Staged as below, the kernel runs close
// to its multiply-adds alone: at the bench's batched shape (P = D = 162,
// S = 32, L = 2, N = 4096, u8 hi plane) 5.07 ms as built, 4.69 ms with the
// copies taken out, 0.87 ms with the multiply-adds taken out (NVIDIA H100
// 80GB HBM3, 700 W; pir_tpu_torch/scan_wide_variants.py).
//
// Design: a block of 16 warps covers 32 coefficients (one per lane) of one
// limb, `columns` = 4 x column warps selection-vector columns and
// `prefixes` = 4 x prefix warps database prefixes (16 x 16 from S = 9 on,
// 32 x 8 for S <= 8), and stages `rows` rows of both operands at a time in
// shared memory: sv [rows][columns][32] u64, the lo plane
// [rows][prefixes][32] u32 and the hi plane [rows][prefixes][32].  Every
// thread reads its 4 sv and 4 database words of a row from there, so an sv
// word leaves L2 once per prefix tile (ceil(162 / 16) = 11 times at the
// bench shape) and a database word once per column group (twice at
// S = 32).  Each thread copies one 16-byte piece of each staged row (of sv,
// of the lo plane or of the hi plane) with cp.async (csrc/async.cuh), its
// source and destination advanced by additions only, into a ring of
// `stages` stages: right after a stage's barrier the threads issue the
// whole stage after next, which lands while the block multiplies this one
// and the next (issued a row at a time among the multiply-adds, or with
// per-row address arithmetic, the copies cost more).  Column groups are the
// grid's fastest axis, prefix tiles the next: the blocks that read one
// database slab, and the prefix tiles that read one sv slab, run side by
// side and meet in L2.  Warps whose prefixes or columns all lie past the
// work copy and skip the multiply-adds.  ops/scan_kernel.py::scan_wide_plan
// lays out the launch (3 stages of 8 rows: 159,744 B of shared memory at
// the bench shape with a u8 hi plane, 172,032 B with a u16 one, 147,456 B
// without; rows halved while a ring exceeds 232,448 B), one block an SM.
// A piece that runs past N or is not 16-byte aligned (a ragged or odd N) is
// copied byte by byte.

#include <cstdint>

#include <cuda_runtime.h>

#include "async.cuh"
#include "modarith.cuh"

namespace {

constexpr int kNB = 32;      // coefficients per block, one per lane
constexpr int kPT = 4;       // prefixes of a thread's accumulators
constexpr int kCols = 4;     // columns of a thread's accumulators
constexpr int kWarps = 16;   // prefix warps x column warps
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxShared = 232448;  // a block's dynamic shared memory on the H100

template <int kHiBytes>
struct HiWord {
  using type = uint8_t;  // also the placeholder type when there is no plane
};
template <>
struct HiWord<2> {
  using type = uint16_t;
};

// cp.async.wait_group with a run-time count (stages - 2, stages in 2..4)
__device__ __forceinline__ void copy_wait_upto(int pending) {
  if (pending >= 2)
    copy_wait<2>();
  else if (pending == 1)
    copy_wait<1>();
  else
    copy_wait<0>();
}

// A thread's copies: the same 16-byte piece of every row of a stage (see
// the kernel), from `src` (row j's piece at src + j * stride) into the
// stage at `dst` (a staged row `row` bytes after the previous one).  A piece
// whose `bytes` (of the 16, inside the ring) are all there and whose rows
// are all 16-byte aligned is one cp.async; another (a ragged or odd N) is
// copied byte by byte, which the barrier before the stage's use makes
// visible as well; a piece of no column or prefix has no bytes.
struct Piece {
  const unsigned char* src;
  int64_t stride;
  int dst, row, bytes;
  bool whole;
  __device__ void copy(unsigned char* to, const unsigned char* from) const {
    if (whole) {
      copy_async16(to, from);
    } else {
      for (int i = 0; i < bytes; ++i) to[i] = from[i];
    }
  }
};

// bytes of a piece that lie inside the ring, of the `left` bytes of its
// row from the piece's start
__device__ __forceinline__ int piece_bytes(int64_t left) {
  return left <= 0 ? 0 : left >= 16 ? 16 : static_cast<int>(left);
}

// grid (column groups, prefix tiles, coefficient tiles x L), kThreads
// threads: column warp cx = warp % 2^col_log2, prefix warp py = warp >>
// col_log2.  A thread sums kPT prefixes x kCols columns.
template <int kHiBytes>
__global__ void __launch_bounds__(kThreads, 1)
scan_wide_kernel(const uint64_t* __restrict__ sv,
                 const typename HiWord<kHiBytes>::type* __restrict__ db_hi,
                 const uint32_t* __restrict__ db_lo,
                 const uint64_t* __restrict__ consts,
                 uint64_t* __restrict__ out, int64_t P, int S, int L,
                 int64_t d_total, int64_t j_begin, int64_t D, int64_t N,
                 int col_log2, int rows, int stages) {
  using HiT = typename HiWord<kHiBytes>::type;
  constexpr bool kHasHi = kHiBytes > 0;
  extern __shared__ __align__(16) unsigned char smem[];

  const int ts = kCols << col_log2;           // the block's columns
  const int tp = (kPT * kWarps) >> col_log2;  // the block's prefixes
  const int sv_bytes = rows * ts * kNB * 8;   // a stage: sv, then lo, then hi
  const int lo_bytes = rows * tp * kNB * 4;
  const int slot_bytes = sv_bytes + lo_bytes + (kHasHi ? rows * tp * kNB * kHiBytes : 0);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int cx = (tid >> 5) & ((1 << col_log2) - 1);
  const int py = (tid >> 5) >> col_log2;
  const int s_blk = blockIdx.x * ts;
  const int64_t p_blk = static_cast<int64_t>(blockIdx.y) * tp;
  const int l = blockIdx.z % L;
  const int64_t n0 = static_cast<int64_t>(blockIdx.z / L) * kNB;
  // a warp whose prefixes all lie past P (in the last prefix tile) or whose
  // columns all lie past S copies its pieces and skips the multiply-adds,
  // which leaves the SM to the warps with work
  const bool computes = p_blk + py * kPT < P && s_blk + cx * kCols < S;

  // this thread's piece of each staged row: threads [0, 16 ts) take sv (a
  // column's 32 words are 16 pieces), the next 8 tp the lo plane (8 pieces
  // a prefix), the next 2 hi_bytes tp the hi plane, the rest none (the plan
  // keeps the pieces within kThreads, each operand's a multiple of a warp);
  // columns past S and prefixes past P are not copied (their sums are never
  // stored)
  Piece pc{reinterpret_cast<const unsigned char*>(db_lo), 0, 0, 0, 0, false};
  {
    const int64_t left = N - n0;  // coefficients of this tile inside the ring
    int k = tid;
    if (k < 16 * ts) {
      const int col = k / 16, part = k % 16;
      pc.row = ts * kNB * 8;
      if (s_blk + col < S) {
        pc.src = reinterpret_cast<const unsigned char*>(
                     sv + (static_cast<int64_t>(s_blk + col) * L + l) * N + n0) + 16 * part;
        pc.stride = static_cast<int64_t>(S) * L * N * 8;
        pc.dst = col * kNB * 8 + 16 * part;
        pc.bytes = piece_bytes(left * 8 - 16 * part);
      }
    } else if ((k -= 16 * ts) < 8 * tp) {
      const int pp = k / 8, part = k % 8;
      pc.row = tp * kNB * 4;
      if (p_blk + pp < P) {
        pc.src = reinterpret_cast<const unsigned char*>(
                     db_lo + (((p_blk + pp) * L + l) * d_total + j_begin) * N + n0) + 16 * part;
        pc.stride = N * 4;
        pc.dst = sv_bytes + pp * kNB * 4 + 16 * part;
        pc.bytes = piece_bytes(left * 4 - 16 * part);
      }
    } else if (kHasHi && (k -= 8 * tp) < 2 * kHiBytes * tp) {
      const int pp = k / (2 * kHiBytes), part = k % (2 * kHiBytes);
      pc.row = tp * kNB * kHiBytes;
      if (p_blk + pp < P) {
        pc.src = reinterpret_cast<const unsigned char*>(
                     db_hi + (((p_blk + pp) * L + l) * d_total + j_begin) * N + n0) + 16 * part;
        pc.stride = N * kHiBytes;
        pc.dst = sv_bytes + lo_bytes + pp * kNB * kHiBytes + 16 * part;
        pc.bytes = piece_bytes(left * kHiBytes - 16 * part);
      }
    }
    pc.whole = pc.bytes == 16 && (reinterpret_cast<uintptr_t>(pc.src) & 15) == 0 &&
               (pc.stride & 15) == 0;
  }

  // this thread's piece of each row of stage c (D's rows [c * rows,
  // c * rows + rows)) into ring slot c % stages
  auto copy_stage = [&](int c) {
    const int64_t j0 = static_cast<int64_t>(c) * rows;
    const int n = pc.bytes == 0 || D <= j0 ? 0 : D - j0 < rows ? static_cast<int>(D - j0) : rows;
    const unsigned char* from = pc.src + j0 * pc.stride;
    unsigned char* to = smem + (c % stages) * slot_bytes + pc.dst;
    for (int jj = 0; jj < n; ++jj, from += pc.stride, to += pc.row) pc.copy(to, from);
  };

  uint32_t acc[kPT][kCols][3];
#pragma unroll
  for (int p = 0; p < kPT; ++p)
#pragma unroll
    for (int t = 0; t < kCols; ++t) acc[p][t][0] = acc[p][t][1] = acc[p][t][2] = 0;

  const int chunks = static_cast<int>((D + rows - 1) / rows);
  for (int c = 0; c < stages - 1; ++c) {
    copy_stage(c);
    copy_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    copy_wait_upto(stages - 2);  // this thread's copies of stage c have landed
    __syncthreads();             // everyone's have, and stage c - 1 is consumed
    copy_stage(c + stages - 1);  // into stage c - 1's slot
    copy_commit();

    const unsigned char* slot = smem + (c % stages) * slot_bytes;
    const uint64_t* x_s = reinterpret_cast<const uint64_t*>(slot) + cx * kCols * kNB + lane;
    const uint32_t* wl_s =
        reinterpret_cast<const uint32_t*>(slot + sv_bytes) + py * kPT * kNB + lane;
    const HiT* wh_s = reinterpret_cast<const HiT*>(slot + sv_bytes + lo_bytes) +
                      py * kPT * kNB + lane;
    const int64_t j0 = static_cast<int64_t>(c) * rows;
    const int nrows = !computes ? 0 : D - j0 < rows ? static_cast<int>(D - j0) : rows;
    for (int jj = 0; jj < nrows; ++jj) {
      uint32_t xl[kCols], xh[kCols];
#pragma unroll
      for (int t = 0; t < kCols; ++t) {
        const uint64_t x = x_s[(jj * ts + t) * kNB];
        xl[t] = static_cast<uint32_t>(x);
        xh[t] = static_cast<uint32_t>(x >> 32);
      }
#pragma unroll
      for (int p = 0; p < kPT; ++p) {
        const uint32_t wl = wl_s[(jj * tp + p) * kNB];
        if constexpr (kHasHi) {
          const uint32_t wh = wh_s[(jj * tp + p) * kNB];
#pragma unroll
          for (int t = 0; t < kCols; ++t)
            mac96(acc[p][t][0], acc[p][t][1], acc[p][t][2], xl[t], xh[t], wl, wh);
        } else {
#pragma unroll
          for (int t = 0; t < kCols; ++t)
            mac32(acc[p][t][0], acc[p][t][1], acc[p][t][2], xl[t], wl);
        }
      }
    }
  }

  const int64_t n = n0 + lane;
  if (n >= N) return;
  const uint64_t q = consts[3 * l];
  const uint64_t rh = consts[3 * l + 1];
  const uint64_t rl = consts[3 * l + 2];
#pragma unroll
  for (int p = 0; p < kPT; ++p) {
    const int64_t pp = p_blk + py * kPT + p;
#pragma unroll
    for (int t = 0; t < kCols; ++t) {
      const int s = s_blk + cx * kCols + t;
      if (pp < P && s < S) {
        const uint64_t lo = (static_cast<uint64_t>(acc[p][t][1]) << 32) | acc[p][t][0];
        out[((pp * S + s) * L + l) * N + n] = barrett_reduce_128(acc[p][t][2], lo, q, rh, rl);
      }
    }
  }
}

template <int kHiBytes>
int launch(const void* sv, const void* db_hi, const void* db_lo, const void* consts,
           void* out, int64_t P, int S, int L, int64_t d_total, int64_t j_begin, int64_t D,
           int64_t N, int col_log2, int rows, int stages, int shared_bytes, dim3 grid,
           cudaStream_t s) {
  const auto kernel = scan_wide_kernel<kHiBytes>;
  // above 48 KB a block's dynamic shared memory must be asked for
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kThreads, shared_bytes, s>>>(
      static_cast<const uint64_t*>(sv),
      static_cast<const typename HiWord<kHiBytes>::type*>(db_hi),
      static_cast<const uint32_t*>(db_lo), static_cast<const uint64_t*>(consts),
      static_cast<uint64_t*>(out), P, S, L, d_total, j_begin, D, N, col_log2, rows, stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out[P, S, L, N] = contraction of sv[D, S, L, N] with planes
// [P, L, d_total, N] over j in [j_begin, j_begin + D).  hi_bytes is the hi
// plane's element size: 1 or 2, or 0 for no hi plane (db_hi unused, moduli
// below 2^32).  D <= 2^(96 - 2 * bits) keeps the 96-bit sums exact (the
// caller chunks).  The launch (ops/scan_kernel.py::scan_wide_plan): a
// block of 16 warps of 4 x 4 tiles covers `prefixes` x `columns` (16 x 16
// or 32 x 8), at most one 16-byte piece of a staged row a thread; a ring
// of `stages` (2-4) stages of `rows` rows in shared_bytes
// of dynamic shared memory; and a grid of col_tiles x prefix_tiles x
// coeff_limb_tiles blocks that must cover S, P and ceil(N / 32) * L.
// Returns a CUDA error code.
int pir_scan_wide(const void* sv, const void* db_hi, const void* db_lo,
                  const void* consts, void* out, int hi_bytes, int64_t P, int S,
                  int L, int64_t d_total, int64_t j_begin, int64_t D, int64_t N,
                  int prefixes, int columns, int rows, int stages, int shared_bytes,
                  int col_tiles, int prefix_tiles, int coeff_limb_tiles, void* stream) {
  const int col_log2 = columns == 8 ? 1 : columns == 16 ? 2 : -1;
  if (col_log2 < 0 || prefixes * columns != kWarps * kPT * kCols ||
      16 * columns + (8 + 2 * hi_bytes) * prefixes > kThreads ||  // a piece a thread
      S < 1 || L < 1 || P < 1 || D < 1 || N < 1 || rows < 1 || stages < 2 || stages > 4 ||
      hi_bytes < 0 || hi_bytes > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t stage_bytes =
      static_cast<int64_t>(rows) * kNB * (columns * 8 + prefixes * (4 + hi_bytes));
  if (stage_bytes * stages > shared_bytes || shared_bytes > kMaxShared ||
      static_cast<int64_t>(col_tiles) * columns < S ||
      static_cast<int64_t>(prefix_tiles) * prefixes < P || coeff_limb_tiles < L ||
      coeff_limb_tiles % L != 0 || static_cast<int64_t>(coeff_limb_tiles / L) * kNB < N)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(col_tiles), static_cast<unsigned>(prefix_tiles),
                  static_cast<unsigned>(coeff_limb_tiles));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hi_bytes == 0)
    return launch<0>(sv, nullptr, db_lo, consts, out, P, S, L, d_total, j_begin, D, N, col_log2,
                     rows, stages, shared_bytes, grid, s);
  if (hi_bytes == 1)
    return launch<1>(sv, db_hi, db_lo, consts, out, P, S, L, d_total, j_begin, D, N, col_log2,
                     rows, stages, shared_bytes, grid, s);
  return launch<2>(sv, db_hi, db_lo, consts, out, P, S, L, d_total, j_begin, D, N, col_log2,
                   rows, stages, shared_bytes, grid, s);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
