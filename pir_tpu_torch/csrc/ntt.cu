// Kernel A: negacyclic NTT / inverse NTT over RNS limbs, in shared memory.
//
// Replaces pir_tpu/ops/pallas_mxu_ntt.py::_make_kernel (K2, the four-step
// MXU transform that carries every NTT and INTT of the TPU's main path) and
// computes what pir_tpu/ops/pallas_ntt.py::_ntt_kernel (K3) computes:
// NttTables.forward (coefficient order -> bit-reversed evaluations at odd
// powers of psi) and NttTables.inverse (bit-reversed -> coefficients, times
// n^-1).  Every output is fully reduced, so it equals the reference's
// residues bit for bit.
//
// Design: one thread block per (polynomial, limb).  The limb's N words
// (32 KB at N = 4096) are loaded once into shared memory, go through the
// log2 N merged-twiddle radix-2 stages there (Cooley-Tukey forward,
// Gentleman-Sande inverse, a __syncthreads between stages) and are written
// back once.  A butterfly multiplies by a twiddle with Shoup's method:
// one __umul64hi against the precomputed companion word and two low
// products, then one conditional subtract.
//
// What bounds it on the H100: device memory sees only 16 bytes per
// coefficient (one read, one write; twiddles come from L2).  The limit is
// the 64-bit integer multiplies, which the CUDA cores build from 32-bit
// IMADs (about 3 64-bit products per butterfly, N/2 log2 N butterflies), and
// the stage barriers.  The design keeps every stage on chip; moving the
// products onto tensor cores (K2's four-step form) is a later change.

#include <cstdint>
#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

__device__ __forceinline__ uint64_t sub_mod(uint64_t a, uint64_t b,
                                            uint64_t q) {
  return a >= b ? a - b : a + q - b;
}

// in/out: [batch * limbs, n]; tw/tw_shoup: [limbs, n] bit-reversed powers of
// psi (forward) or psi^-1 (inverse); moduli, n_inv, n_inv_shoup: [limbs].
template <bool kInverse>
__global__ void ntt_kernel(const uint64_t* __restrict__ in,
                           uint64_t* __restrict__ out, int limbs, int log_n,
                           const uint64_t* __restrict__ tw,
                           const uint64_t* __restrict__ tw_shoup,
                           const uint64_t* __restrict__ moduli,
                           const uint64_t* __restrict__ n_inv,
                           const uint64_t* __restrict__ n_inv_shoup) {
  extern __shared__ uint64_t a[];
  const int n = 1 << log_n;
  const int half = n >> 1;
  const int64_t poly = blockIdx.x;
  const int limb = static_cast<int>(poly % limbs);
  const uint64_t q = moduli[limb];
  const uint64_t* w_row = tw + static_cast<int64_t>(limb) * n;
  const uint64_t* ws_row = tw_shoup + static_cast<int64_t>(limb) * n;
  const uint64_t* src = in + poly * n;
  uint64_t* dst = out + poly * n;

  for (int i = threadIdx.x; i < n; i += blockDim.x) a[i] = src[i];
  __syncthreads();

  for (int s = 0; s < log_n; ++s) {
    // forward stage s: m = 2^s groups of span 2t, t = n / 2m;
    // inverse stage s: t = 2^s, h = n / 2t groups
    const int log_t = kInverse ? s : log_n - 1 - s;
    const int t = 1 << log_t;
    const int base = kInverse ? (half >> s) : (1 << s);
    for (int k = threadIdx.x; k < half; k += blockDim.x) {
      const int i = k >> log_t;
      const int u_idx = (i << (log_t + 1)) | (k & (t - 1));
      const int v_idx = u_idx + t;
      const uint64_t w = w_row[base + i];
      const uint64_t ws = ws_row[base + i];
      const uint64_t u = a[u_idx];
      const uint64_t v = a[v_idx];
      if (kInverse) {
        a[u_idx] = add_mod(u, v, q);
        a[v_idx] = mul_shoup(sub_mod(u, v, q), w, ws, q);
      } else {
        const uint64_t vs = mul_shoup(v, w, ws, q);
        a[u_idx] = add_mod(u, vs, q);
        a[v_idx] = sub_mod(u, vs, q);
      }
    }
    __syncthreads();
  }

  if (kInverse) {
    const uint64_t ni = n_inv[limb];
    const uint64_t nis = n_inv_shoup[limb];
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      dst[i] = mul_shoup(a[i], ni, nis, q);
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = a[i];
  }
}

}  // namespace

extern "C" {

// Transform `batch * limbs` polynomials of 2^log_n words (6 <= log_n <= 12).
// Returns cudaGetLastError() after the launch.
int pir_ntt(const void* in, void* out, int64_t batch, int limbs, int log_n,
            int inverse, const void* tw, const void* tw_shoup,
            const void* moduli, const void* n_inv, const void* n_inv_shoup,
            void* stream) {
  const int n = 1 << log_n;
  const int threads = n / 2 < 256 ? n / 2 : 256;
  const size_t smem = static_cast<size_t>(n) * sizeof(uint64_t);
  const dim3 grid(static_cast<unsigned>(batch * limbs));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const uint64_t*>(in);
  auto* y = static_cast<uint64_t*>(out);
  const auto* w = static_cast<const uint64_t*>(tw);
  const auto* ws = static_cast<const uint64_t*>(tw_shoup);
  const auto* q = static_cast<const uint64_t*>(moduli);
  const auto* ni = static_cast<const uint64_t*>(n_inv);
  const auto* nis = static_cast<const uint64_t*>(n_inv_shoup);
  if (inverse) {
    ntt_kernel<true><<<grid, threads, smem, s>>>(x, y, limbs, log_n, w, ws, q,
                                                 ni, nis);
  } else {
    ntt_kernel<false><<<grid, threads, smem, s>>>(x, y, limbs, log_n, w, ws,
                                                  q, ni, nis);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
