"""Kernels A (csrc/ntt.cu) and B (csrc/scan.cu) run on the CPU: the CUDA
sources themselves, compiled by g++ against a small emulation of the CUDA
runtime (one std::thread per CUDA thread, a std::barrier for
__syncthreads, a byte buffer for the block's shared memory; the PTX
carry chains and cp.async copies replaced by C equivalents), held bit for
bit to the plain versions at every radix and row split their plans can
choose.

What this shows is the kernels' index arithmetic, twiddle choice,
exchange layout, lazy-reduction bounds and row-split sums; it says nothing
of speed, and the card's own compiler and the PTX pieces are checked only
by tests/test_torch_cuda.py on the card.  The compile itself checks kernel
A's passes: a static_assert in csrc/ntt.cu holds every instantiation's
windows to cover each stage once, in order.
"""

import ctypes
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from pir_tpu_torch.core import primes
from pir_tpu_torch.ops import modular, scan_kernel
from pir_tpu_torch.ops import ntt as tntt

CSRC = pathlib.Path(__file__).resolve().parents[1] / "pir_tpu_torch" / "csrc"

RUNTIME_H = r"""
#pragma once
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __align__(n) alignas(n)
#define __launch_bounds__(...)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline std::barrier<>* g_bar = nullptr;
inline std::vector<unsigned char> g_smem;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F> cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
struct alignas(16) ulonglong2 { unsigned long long x, y; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
struct alignas(8) uint2 { unsigned x, y; };
inline ulonglong2 make_ulonglong2(unsigned long long a, unsigned long long b) { return {a, b}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
template <class T> T __ldg(const T* p) { return *p; }
template <class T> T __ldcs(const T* p) { return *p; }
inline uint32_t __umulhi(uint32_t a, uint32_t b) { return uint32_t((uint64_t(a) * b) >> 32); }
inline uint64_t __umul64hi(uint64_t a, uint64_t b) {
  return uint64_t(((unsigned __int128)a * b) >> 64);
}
inline void __syncthreads() { g_bar->arrive_and_wait(); }
// blocks one after another, each with all its threads alive at once; shared
// memory starts as garbage, as on the card
inline void emulate_launch(dim3 grid, dim3 block, size_t smem, const std::function<void()>& body) {
  blockDim = block;
  gridDim = grid;
  const unsigned nt = block.x * block.y * block.z;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        g_smem.assign(smem + 16, 0xCD);
        std::barrier<> bar(nt);
        g_bar = &bar;
        std::vector<std::thread> ts;
        for (unsigned t = 0; t < nt; ++t)
          ts.emplace_back([&, t] {
            threadIdx = dim3(t % block.x, (t / block.x) % block.y, t / (block.x * block.y));
            blockIdx = dim3(bx, by, bz);
            body();
            bar.arrive_and_drop();
          });
        for (auto& th : ts) th.join();
      }
}
"""

_WORDS = "unsigned __int128 a = ((unsigned __int128)a2 << 64) | ((uint64_t)a1 << 32) | a0;"
_SPLIT = "a0 = (uint32_t)a; a1 = (uint32_t)(a >> 32); a2 = (uint32_t)(a >> 64);"
REPLACED = {  # device functions written in PTX, and their C equivalents
    "mac96": "{ %s a += (unsigned __int128)(((uint64_t)xh << 32) | xl) * "
             "(((uint64_t)wh << 32) | wl); %s }" % (_WORDS, _SPLIT),
    "mac32": "{ %s a += (uint64_t)x * w; %s }" % (_WORDS, _SPLIT),
    "add96": "{ %s a += ((unsigned __int128)b2 << 64) | ((uint64_t)b1 << 32) | b0; %s }"
             % (_WORDS, _SPLIT),
    "copy_async16": "{ memcpy(dst, src, 16); }",
    "copy_async": "{ memcpy(dst, src, kBytes); }",
    "copy_commit": "{}",
    "copy_wait": "{}",
}


def _replace_body(src: str, fname: str, body: str) -> str:
    i = src.find(f"void {fname}(")
    if i < 0:
        return src
    j = src.index("{", src.index(")", i))
    depth, k = 0, j
    while True:
        depth += {"{": 1, "}": -1}.get(src[k], 0)
        if depth == 0:
            break
        k += 1
    return src[:j] + body + src[k + 1:]


def emulation_source(name: str) -> str:
    """csrc/<name>.cu with its launches, dynamic shared memory and PTX
    turned into the emulation's C++."""
    src = (CSRC / f"{name}.cu").read_text()
    src = src.replace('#include "modarith.cuh"', f'#include "{CSRC / "modarith.cuh"}"')
    src = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?([\w ]+?) (\w+)\[\];",
                 r"\1* \2 = reinterpret_cast<\1*>(g_smem.data());", src)
    for fname, body in REPLACED.items():
        src = _replace_body(src, fname, body)
    out, pos = [], 0
    while (i := src.find("<<<", pos)) >= 0:  # kernel<<<g, b, smem, s>>>(args);
        start = max(src.rfind(c, 0, i) for c in ";{}") + 1
        j = src.index(">>>", i)
        k = src.index(");", j)
        grid, block, smem, _ = src[i + 3:j].split(",")
        out.append(src[pos:start])
        out.append(f"emulate_launch({grid}, {block}, {smem}, [&] {{ {src[start:i].strip()}"
                   f"{src[j + 3:k]}); }});")
        pos = k + 2
    out.append(src[pos:])
    return "".join(out)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    gxx = shutil.which("g++")
    assert gxx, "the emulation needs g++"
    d = tmp_path_factory.mktemp("cuda_emulation")
    (d / "cuda_runtime.h").write_text(RUNTIME_H)
    out = {}
    for name in ("ntt", "scan"):
        (d / f"{name}.cpp").write_text(emulation_source(name))
        so = d / f"lib{name}.so"
        subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-w", f"-I{d}",
                        "-o", str(so), str(d / f"{name}.cpp"), "-lpthread"],
                       check=True, capture_output=True, text=True)
        out[name] = ctypes.CDLL(str(so))
    P, I64, I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    out["ntt"].pir_ntt.argtypes = [P, P, I64, I32, I32, I32, I32, I32, I64, I32, P, P, P, P, P, P]
    out["scan"].pir_scan.argtypes = [P, P, P, P, P, I32, I64, I32, I32, I64, I64, I64, I64,
                                     I32, I32, I32, I32, P]
    return out


def _residues(rng, moduli, shape, axis):
    return torch.from_numpy(np.stack(
        [rng.integers(0, q, shape, dtype=np.uint64) for q in moduli], axis=axis
    ).view(np.int64)).contiguous()


# Kernel A's window of index bits per pass (csrc/ntt.cu::window_lo), and two
# wrong ones: the short pass on top (coverage holds, the top window's
# layout does not), and windows one bit too low (a bit covered twice).
WINDOW_LO = "return fwd == S::kPasses - 1 ? 0 : kLogN - kB * (fwd + 1);"
WRONG_WINDOWS = {
    "short pass on top": ("return fwd == 0 ? kLogN - S::kRem : kLogN - S::kRem - kB * fwd;",
                          "return fwd == 0 ? S::kRem : kB;"),
    "overlapping windows": ("return fwd == S::kPasses - 1 ? 0 : kLogN - kB * (fwd + 1) - 1;", None),
}
WINDOW_BITS = "return fwd == S::kPasses - 1 ? S::kRem : kB;"


@pytest.mark.parametrize("wrong", WRONG_WINDOWS)
def test_kernel_a_windows_cover_every_stage_once(libs, tmp_path, wrong):
    """The real windows compiled (the libs fixture builds every
    instantiation); wrong ones are refused at compile time."""
    src = emulation_source("ntt")
    assert src.count(WINDOW_LO) == 1 and src.count(WINDOW_BITS) == 1
    lo, bits = WRONG_WINDOWS[wrong]
    src = src.replace(WINDOW_LO, lo).replace(WINDOW_BITS, bits or WINDOW_BITS)
    (tmp_path / "cuda_runtime.h").write_text(RUNTIME_H)
    (tmp_path / "ntt.cpp").write_text(src)
    res = subprocess.run([shutil.which("g++"), "-std=c++20", "-fsyntax-only", "-w",
                          f"-I{tmp_path}", str(tmp_path / "ntt.cpp")],
                         capture_output=True, text=True)
    assert res.returncode != 0
    assert "must cover each stage once" in res.stderr


@pytest.mark.parametrize(
    "n,bits",
    [(64, (26, 60)), (128, (36, 37)), (256, (30, 45)), (512, (36, 37)), (1024, (58, 61)),
     (2048, (26, 27)), (4096, (36, 37))],
)
@pytest.mark.parametrize("radix_bits", (2, 3))  # the words a thread pir_ntt takes: 4 or 8
def test_kernel_a_emulated_equals_plain(libs, n, bits, radix_bits):
    """Forward and inverse, three polynomials a limb, at both radices (the
    plan's own choice is 4 words a thread below N=512, 8 from there):
    growing butterflies below 2^50, reducing ones for the 58-61-bit
    chains."""
    tables = tntt.NttTables(primes.coeff_modulus_from_bits(n, list(bits)), n, "cpu")
    L = len(bits)
    batch = 1 if n == 4096 and radix_bits == 2 else 3
    x = _residues(np.random.default_rng(n + radix_bits), tables.moduli, (batch, n), 1)
    per_block = min(max(1, 256 // (n >> radix_bits)), batch * L)
    blocks = -(-batch * L // per_block)
    for inverse in (False, True):
        tw, tws = ((tables.psi_inv_rev, tables.psi_inv_rev_shoup) if inverse
                   else (tables.psi_rev, tables.psi_rev_shoup))
        out = torch.empty_like(x)
        rc = libs["ntt"].pir_ntt(
            x.data_ptr(), out.data_ptr(), batch, L, n.bit_length() - 1, int(inverse), radix_bits,
            per_block, blocks, int(tntt.grows(tables.moduli)), tw.data_ptr(), tws.data_ptr(),
            tables.limbs.table.data_ptr(), tables.n_inv.data_ptr(),
            tables.n_inv_shoup.data_ptr(), None)
        assert rc == 0
        assert torch.equal(out, tntt.ntt_plain(tables, x, inverse)), inverse


@pytest.mark.parametrize(
    "bits,P,D,j_begin,n",
    [((26, 26), 5, 7, 0, 256), ((26, 27), 8, 30, 0, 128), ((34, 36), 17, 7, 3, 256),
     ((34, 36), 8, 21, 0, 128), ((34, 36), 3, 13, 1, 64), ((44, 46), 9, 16, 4, 256),
     ((44, 46), 1, 5, 11, 128), ((47, 48), 4, 1, 2, 128), ((36, 36), 162, 9, 0, 128)],
)
def test_kernel_b_emulated_equals_plain(libs, bits, P, D, j_begin, n):
    """Hi planes of 0, 1 and 2 bytes, ragged prefix tiles and row splits,
    rows from j_begin, N below one warp's 128 coefficients, and the largest
    words: every row split against the plain contraction."""
    moduli = primes.coeff_modulus_from_bits(1024, list(bits))
    limbs = modular.LimbConstants(moduli, "cpu")
    L, d_total = len(moduli), j_begin + D + 2
    rng = np.random.default_rng(P * D + j_begin)
    sv = _residues(rng, moduli, (D, 2, n), 2)
    db = _residues(rng, moduli, (P, d_total, n), 1)
    db[0, 0, j_begin, :3] = sv[0, 0, 0, :3] = int(moduli[0]) - 1
    hi, lo = scan_kernel.split_planes(db, moduli)
    want = scan_kernel.contract_plain(sv, hi, lo, limbs.table, j_begin)
    hi_bytes = 0 if hi is None else hi.element_size()
    for splits in (1, 2, 4, 8):  # scan_plan's choices
        if splits > D:
            continue
        groups = scan_kernel.SCAN_WARPS // splits
        out = torch.zeros((P, 2, L, n), dtype=torch.int64)
        rc = libs["scan"].pir_scan(
            sv.data_ptr(), 0 if hi is None else hi.data_ptr(), lo.data_ptr(),
            limbs.table.data_ptr(), out.data_ptr(), hi_bytes, P, 2, L, d_total, j_begin, D, n,
            groups, splits, -(-P // (2 * groups)), -(-n // 128), None)
        assert rc == 0
        assert torch.equal(out, want), splits
