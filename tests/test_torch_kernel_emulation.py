"""Kernels A (csrc/ntt.cu), B (csrc/scan.cu), C (csrc/scan_wide.cu), E
(csrc/keyswitch.cu), F (csrc/upper.cu) and G (csrc/behz.cu), E, F and G
through their Python wrappers, run on the CPU: the CUDA sources themselves, their csrc/*.cuh headers inlined,
compiled by g++ against a small emulation of the CUDA runtime (one
std::thread per CUDA thread, a std::barrier for __syncthreads, a byte
buffer for the block's shared memory; a thread-block cluster's blocks run
at once, each with its own buffer and barrier, with one std::barrier for
the cluster; the PTX carry chains, cp.async copies and cluster primitives
replaced by C equivalents), held bit for bit to the plain versions at
every radix and row split their plans can choose, kernel A at every ring
up to N=32768 (one cluster of 4 or 8 blocks a limb above N=8192, grids
with clusters past the last polynomial) on growing and reducing chains,
kernel C at every edge of scan_wide_plan's layout, kernel E's four
entries at tiny rings under each of pir_tpu's inner-product methods, and
kernel F's four (the upper level's lift, contraction and plane split, and
the mod switch) on SEAL-like, tpu32-like and 60-bit chains in both
re-encode modes, with every word at q - 1 too, and kernel G's three (the
BEHZ multiply's lift, tensor product and floor) against the plain RnsTool
methods from 1 to 15 ciphertext limbs, whose 128-bit sums pass 2^125.

What this shows is the kernels' index arithmetic, twiddle choice,
exchange layout, lazy-reduction bounds, row-split sums and kernel C's ring
of staged rows; it says nothing
of speed, and the card's own compiler and the PTX pieces are checked only
by tests/test_torch_cuda.py on the card.  The compile itself checks kernel
A's passes: a static_assert in csrc/ntt.cu holds every instantiation's
windows to cover each stage once, in order.
"""

import ctypes
import dataclasses
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from pir_tpu_torch import kernels
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
#include <memory>
#include <optional>
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
inline unsigned g_cluster = 1;                        // blocks a cluster, along x
inline thread_local std::barrier<>* g_bar = nullptr;  // the thread's block's barrier
inline thread_local unsigned char* g_smem = nullptr;  // and its shared memory
inline thread_local std::barrier<>* g_cluster_bar = nullptr;
inline thread_local std::vector<std::vector<unsigned char>>* g_cluster_smem = nullptr;
inline thread_local std::optional<std::barrier<>::arrival_token> g_cluster_token;
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
// clusters of `cluster` blocks along x one after another, a cluster's
// blocks at once with all their threads alive; each block its own shared
// memory (garbage at the start, as on the card) and barrier, and one
// barrier for the whole cluster
inline void emulate_launch(dim3 grid, dim3 block, size_t smem, const std::function<void()>& body,
                           unsigned cluster = 1) {
  blockDim = block;
  gridDim = grid;
  g_cluster = cluster;
  const unsigned nt = block.x * block.y * block.z;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; bx += cluster) {
        std::vector<std::vector<unsigned char>> mem(cluster,
                                                    std::vector<unsigned char>(smem + 16, 0xCD));
        std::vector<std::unique_ptr<std::barrier<>>> bars;
        for (unsigned c = 0; c < cluster; ++c) bars.emplace_back(new std::barrier<>(nt));
        std::barrier<> cluster_bar(nt * cluster);
        std::vector<std::thread> ts;
        for (unsigned c = 0; c < cluster; ++c)
          for (unsigned t = 0; t < nt; ++t)
            ts.emplace_back([&, c, t] {
              threadIdx = dim3(t % block.x, (t / block.x) % block.y, t / (block.x * block.y));
              blockIdx = dim3(bx + c, by, bz);
              g_bar = bars[c].get();
              g_smem = mem[c].data();
              g_cluster_bar = &cluster_bar;
              g_cluster_smem = &mem;
              body();
              g_bar->arrive_and_drop();
              cluster_bar.arrive_and_drop();
            });
        for (auto& th : ts) th.join();
      }
}
enum cudaLaunchAttributeID {
  cudaLaunchAttributeClusterDimension = 4,
  cudaLaunchAttributeClusterSchedulingPolicyPreference = 5
};
enum cudaClusterSchedulingPolicy {
  cudaClusterSchedulingPolicyDefault = 0,
  cudaClusterSchedulingPolicySpread = 1,
  cudaClusterSchedulingPolicyLoadBalancing = 2
};
struct cudaLaunchAttributeValue {
  struct { unsigned x, y, z; } clusterDim;
  cudaClusterSchedulingPolicy clusterSchedulingPolicyPreference;
};
struct cudaLaunchAttribute { cudaLaunchAttributeID id; cudaLaunchAttributeValue val; };
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
template <class... Exp, class... Act>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kernel)(Exp...), Act&&... args) {
  unsigned cluster = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension) cluster = cfg->attrs[i].val.clusterDim.x;
  if (cluster < 1 || cfg->gridDim.x % cluster) return cudaErrorInvalidValue;  // as the card refuses it
  emulate_launch(cfg->gridDim, cfg->blockDim, cfg->dynamicSmemBytes, [&] { kernel(args...); }, cluster);
  return cudaSuccess;
}
template <class F> cudaError_t cudaOccupancyMaxActiveClusters(int* n, F, const cudaLaunchConfig_t*) {
  *n = 1;
  return cudaSuccess;
}
"""

_WORDS = "unsigned __int128 a = ((unsigned __int128)a2 << 64) | ((uint64_t)a1 << 32) | a0;"
_SPLIT = "a0 = (uint32_t)a; a1 = (uint32_t)(a >> 32); a2 = (uint32_t)(a >> 64);"
REPLACED = {  # device functions written in PTX, and their C equivalents
    "mac96": "{ %s a += (unsigned __int128)(((uint64_t)xh << 32) | xl) * "
             "(((uint64_t)wh << 32) | wl); %s }" % (_WORDS, _SPLIT),
    "mac32": "{ %s a += (uint64_t)x * w; %s }" % (_WORDS, _SPLIT),
    "mac128w": "{ unsigned __int128 a = ((unsigned __int128)(((uint64_t)a3 << 32) | a2) << 64) | "
               "(((uint64_t)a1 << 32) | a0); a += (unsigned __int128)(((uint64_t)xh << 32) | xl) * "
               "(((uint64_t)wh << 32) | wl); a0 = (uint32_t)a; a1 = (uint32_t)(a >> 32); "
               "a2 = (uint32_t)(a >> 64); a3 = (uint32_t)(a >> 96); }",
    "add96": "{ %s a += ((unsigned __int128)b2 << 64) | ((uint64_t)b1 << 32) | b0; %s }"
             % (_WORDS, _SPLIT),
    "copy_async16": "{ memcpy(dst, src, 16); }",
    "load_word": "{ return *p; }",
    "copy_async": "{ memcpy(dst, src, kBytes); }",
    "copy_commit": "{}",
    "copy_wait": "{}",
    # clusters: the rank from blockIdx, a sibling's shared memory as a
    # pointer into its buffer, the cluster barrier as a std::barrier
    "cluster_ctarank": "{ return blockIdx.x % g_cluster; }",
    "cluster_map": "{ return (uint64_t)(uintptr_t)((*g_cluster_smem)[rank].data() + "
                   "((const unsigned char*)p - g_smem)); }",
    "cluster_load": "{ return *(const uint64_t*)(uintptr_t)addr; }",
    "cluster_arrive": "{ g_cluster_token.emplace(g_cluster_bar->arrive()); }",
    "cluster_wait": "{ g_cluster_bar->wait(std::move(*g_cluster_token)); g_cluster_token.reset(); }",
}


def _replace_body(src: str, fname: str, body: str) -> str:
    m = re.search(rf"__forceinline__ [\w:]+ {fname}\(", src)
    if m is None:
        return src
    j = src.index("{", src.index(")", m.start()))
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
    seen = set()  # headers inlined, each where it is first included, so REPLACED reaches them
    while (m := re.search(r'#include "(\w+\.cuh)"', src)) is not None:
        text = "" if m[1] in seen else (CSRC / m[1]).read_text().replace("#pragma once", "")
        seen.add(m[1])
        src = src[:m.start()] + text + src[m.end():]
    src = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?([\w ]+?) (\w+)\[\];",
                 r"\1* \2 = reinterpret_cast<\1*>(g_smem);", src)
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


def _compile(d: pathlib.Path, name: str, source: str):
    """The emulation's C++ `source` built with g++ in directory d, loaded."""
    gxx = shutil.which("g++")
    assert gxx, "the emulation needs g++"
    (d / "cuda_runtime.h").write_text(RUNTIME_H)
    (d / f"{name}.cpp").write_text(source)
    so = d / f"lib{name}.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-w", f"-I{d}",
                    "-o", str(so), str(d / f"{name}.cpp"), "-lpthread"],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cuda_emulation")
    out = {name: _compile(d, name, emulation_source(name))
           for name in ("ntt", "scan", "scan_wide", "keyswitch", "upper", "behz")}
    P, I64, I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    out["ntt"].pir_ntt.argtypes = kernels.NTT_ARGS
    out["scan"].pir_scan.argtypes = [P, P, P, P, P, I32, I64, I32, I32, I64, I64, I64, I64,
                                     I32, I32, I32, I32, P]
    out["scan_wide"].pir_scan_wide.argtypes = kernels.SCAN_WIDE._entry_points["pir_scan_wide"]
    for kernel in (kernels.KEYSWITCH, kernels.UPPER, kernels.BEHZ):
        lib = out[kernel.source.stem]
        for fn, argtypes in kernel._entry_points.items():
            getattr(lib, fn).argtypes = argtypes
        lib.cuda_error_string.restype = ctypes.c_char_p
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
            x.data_ptr(), out.data_ptr(), batch, L, n.bit_length() - 1, int(inverse),
            radix_bits, per_block, blocks, 1, int(tntt.grows(tables.moduli, n)),
            tw.data_ptr(), tws.data_ptr(), tables.limbs.table.data_ptr(),
            tables.n_inv.data_ptr(), tables.n_inv_shoup.data_ptr(), None)
        assert rc == 0
        assert torch.equal(out, tntt.ntt_plain(tables, x, inverse)), inverse


def _emulated_ntt(lib, tables, x, inverse, plan, out=None):
    """pir_ntt through the emulation, laid out by `plan`: its return code
    and the output."""
    tw, tws = ((tables.psi_inv_rev, tables.psi_inv_rev_shoup) if inverse
               else (tables.psi_rev, tables.psi_rev_shoup))
    out = torch.empty_like(x) if out is None else out
    L = len(tables.moduli)
    rc = lib.pir_ntt(
        x.data_ptr(), out.data_ptr(), x.numel() // (L * tables.n), L, plan.log_n, int(inverse),
        plan.radix_bits, plan.polys_per_block, plan.blocks, plan.cluster_ctas,
        int(tntt.grows(tables.moduli, tables.n)), tw.data_ptr(), tws.data_ptr(),
        tables.limbs.table.data_ptr(), tables.n_inv.data_ptr(), tables.n_inv_shoup.data_ptr(),
        None)
    return rc, out


# (n, chain bits, batch): every ring above N=4096, with growing chains (the
# tpu32 30-bit primes, SEAL's 43/44 and 48/49-bit ones) and reducing ones
# (the 60-bit BEHZ base, SEAL's 55/56-bit N=32768 primes); each ring has a
# chain at the growing rule's edge, 2^(63 - log2 N) at 16384 and 32768
# (q of 49 and 48 bits) and 2^50 at 8192, and one just past it, which
# reduces; and the BEHZ base of SEAL's N=16384 chain in ciphertext-
# multiplication mode (9 limbs of 60 bits, as RnsTool's Bsk).
LARGE_RINGS = [
    (8192, (44, 50), 1), (8192, (51, 60), 1),
    (16384, (48, 49), 1), (16384, (30, 50), 1), (16384, (60,) * 9, 1),
    (32768, (30, 48), 1), (32768, (55, 56), 1), (32768, (49,), 2),
]


@pytest.mark.parametrize("n,bits,batch", LARGE_RINGS)
def test_kernel_a_emulated_equals_plain_above_4096(libs, n, bits, batch):
    """Forward and inverse at N = 8192 (one 1,024-thread block a limb),
    16384 and 32768 (one cluster of 4 or 8 CTAs a limb, the top stages'
    words exchanged through the CTAs' shared memory), bit-equal to the plain
    version, with the words at the edges of the residue range, on the plan's
    own layout."""
    tables = tntt.NttTables(primes.coeff_modulus_from_bits(n, list(bits)), n, "cpu")
    assert tntt.grows(tables.moduli, n) == (max(bits) <= min(50, 63 - (n.bit_length() - 1)))
    plan = tntt.ntt_plan(n, batch * len(bits))
    x = _residues(np.random.default_rng(n + sum(bits)), tables.moduli, (batch, n), 1)
    x[0, -1, :3] = torch.tensor([tables.moduli[-1] - 1, tables.moduli[-1] - 2, 0])
    for inverse in (False, True):
        rc, out = _emulated_ntt(libs["ntt"], tables, x, inverse, plan)
        assert rc == 0
        assert torch.equal(out, tntt.ntt_plain(tables, x, inverse)), inverse


# (n, chain bits, batch, spare clusters): a grid with clusters past the last
# polynomial, growing and reducing, at both cluster sizes.
SPARE_CLUSTERS = [(16384, (30,), 1, 1), (16384, (55,), 1, 2), (32768, (30, 48), 1, 1),
                  (32768, (55,), 1, 3), (16384, (30, 50), 2, 1), (32768, (49,), 3, 2)]


@pytest.mark.parametrize("n,bits,batch,spare", SPARE_CLUSTERS)
def test_kernel_a_emulated_clusters_past_the_last_polynomial(libs, n, bits, batch, spare):
    """A grid whose last clusters hold no polynomial: their CTAs compute on
    zeros and meet every cluster barrier (the run would hang otherwise),
    write nothing (the words past the output stay as they were), and the
    polynomials come out bit-equal to the plain version."""
    tables = tntt.NttTables(primes.coeff_modulus_from_bits(n, list(bits)), n, "cpu")
    plan = tntt.ntt_plan(n, batch * len(bits))
    wide = dataclasses.replace(plan, blocks=plan.blocks + spare * plan.cluster_ctas)
    assert wide.clusters == batch * len(bits) + spare
    x = _residues(np.random.default_rng(n + spare), tables.moduli, (batch, n), 1)
    for inverse in (False, True):
        buf = torch.full((x.numel() + spare * n,), -7, dtype=torch.int64)
        rc, _ = _emulated_ntt(libs["ntt"], tables, x, inverse, wide, out=buf)
        assert rc == 0
        assert torch.equal(buf[: x.numel()].view_as(x), tntt.ntt_plain(tables, x, inverse))
        assert torch.equal(buf[x.numel():], torch.full((spare * n,), -7, dtype=torch.int64))


def test_kernel_a_refuses_a_grid_of_part_clusters(libs):
    """pir_ntt refuses, before anything runs, a split ring's grid that is
    not a whole number of clusters or has fewer clusters than polynomials,
    clusters of another size than N / 4,096, and clusters below
    N=16384."""
    n = 16384
    tables = tntt.NttTables(primes.coeff_modulus_from_bits(n, [30, 30]), n, "cpu")
    plan = tntt.ntt_plan(n, 2)
    assert (plan.cluster_ctas, plan.blocks) == (4, 8)
    x = _residues(np.random.default_rng(3), tables.moduli, (1, n), 1)
    for bad in ({"blocks": 7}, {"blocks": 9}, {"blocks": 10}, {"blocks": 4}, {"blocks": 0},
                {"cluster_ctas": 8}, {"cluster_ctas": 2, "blocks": 4},
                {"cluster_ctas": 1}, {"radix_bits": 2}):
        assert _emulated_ntt(libs["ntt"], tables, x, False, dataclasses.replace(plan, **bad))[0] != 0, bad
    small = tntt.ntt_plan(4096, 2)
    t4096 = tntt.NttTables(primes.coeff_modulus_from_bits(4096, [30, 30]), 4096, "cpu")
    x4096 = _residues(np.random.default_rng(4), t4096.moduli, (1, 4096), 1)
    assert _emulated_ntt(libs["ntt"], t4096, x4096, False,
                         dataclasses.replace(small, cluster_ctas=2, blocks=4))[0] != 0


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


# (bits, P, D, S, j_begin, n) of kernel C: hi planes of 0, 1 and 2 bytes;
# S at both of scan_wide_plan's column widths (8, 16), over one, two
# and three column groups (the last one of a single column at S = 33); P
# below, at and above the plan's prefix tile (32 or 16 prefixes); D within
# one stage, over two and around the ring of three stages; rows from
# j_begin; N = 64, and N = 70 and 96, whose last coefficient tile is ragged
# (at N = 70 the plane rows are not 16-byte aligned either).
WIDE_CASES = [
    ((26, 26), 5, 3, 1, 0, 64), ((34, 36), 64, 40, 2, 1, 64), ((41, 42), 33, 12, 5, 2, 64),
    ((26, 27), 16, 17, 16, 0, 64), ((36, 36), 17, 9, 32, 3, 64), ((34, 36), 7, 12, 33, 0, 70),
    ((41, 42), 20, 30, 32, 0, 96), ((30, 30), 9, 11, 2, 5, 70), ((26, 26), 40, 9, 32, 2, 64),
]


def _wide_operands(moduli, P, D, S, j_begin, n):
    rng = np.random.default_rng(P * D + S)
    sv = _residues(rng, moduli, (D, S, n), 2)
    db = _residues(rng, moduli, (P, j_begin + D + 2, n), 1)
    db[-1, -1, j_begin, -3:] = sv[-1, -1, -1, -3:] = int(moduli[-1]) - 1  # the largest words
    return sv, *scan_kernel.split_planes(db, moduli)


def _emulated_wide(lib, sv, hi, lo, table, j_begin, plan):
    D, S = sv.shape[0], sv.shape[1]
    P, L, d_total, n = lo.shape
    out = torch.zeros((P, S, L, n), dtype=torch.int64)
    rc = lib.pir_scan_wide(
        sv.data_ptr(), 0 if hi is None else hi.data_ptr(), lo.data_ptr(), table.data_ptr(),
        out.data_ptr(), 0 if hi is None else hi.element_size(), P, S, L, d_total, j_begin, D, n,
        plan.prefixes, plan.columns, plan.rows, plan.stages, plan.shared_bytes, *plan.grid, None)
    return rc, out


@pytest.mark.parametrize("bits,P,D,S,j_begin,n", WIDE_CASES)
def test_kernel_c_emulated_equals_plain(libs, bits, P, D, S, j_begin, n):
    """Kernel C on scan_wide_plan's layout, bit-equal to the plain
    contraction at every edge of the plan."""
    moduli = primes.coeff_modulus_from_bits(1024, list(bits))
    table = modular.LimbConstants(moduli, "cpu").table
    assert D <= scan_kernel.max_raw_chunk(moduli)
    sv, hi, lo = _wide_operands(moduli, P, D, S, j_begin, n)
    assert (0 if hi is None else hi.element_size()) == (0 if max(bits) <= 32 else 1 if max(bits) <= 40 else 2)
    plan = scan_kernel.scan_wide_plan(P, S, len(moduli), n, D,
                                      0 if hi is None else hi.element_size())
    rc, out = _emulated_wide(libs["scan_wide"], sv, hi, lo, table, j_begin, plan)
    assert rc == 0
    assert torch.equal(out, scan_kernel.contract_wide_plain(sv, hi, lo, table, j_begin))


@pytest.mark.parametrize("D", [16, 17])
def test_kernel_c_exact_at_the_largest_words(libs, D):
    """30-bit moduli without a hi plane, every word q - 1: the sum of 16
    rows' products stays below 2^64, that of 17 does not and needs the
    third word."""
    moduli = primes.coeff_modulus_from_bits(1024, [30, 30])
    assert all(q > 2**32 / 17**0.5 + 1 for q in moduli)  # 17 (q - 1)^2 > 2^64
    table = modular.LimbConstants(moduli, "cpu").table
    sv, hi, lo = _wide_operands(moduli, 6, D, 5, 0, 64)
    q = torch.tensor(moduli, dtype=torch.int64)[:, None]
    sv[:] = q - 1
    lo[:] = (((q - 1) ^ 0x80000000) - 0x80000000)[:, :, None]  # [L, 1, 1]: u32 bits in int32
    plan = scan_kernel.scan_wide_plan(6, 5, 2, 64, D, 0)
    assert hi is None
    rc, out = _emulated_wide(libs["scan_wide"], sv, hi, lo, table, 0, plan)
    assert rc == 0
    assert torch.equal(out, scan_kernel.contract_wide_plain(sv, hi, lo, table))
    assert torch.equal(out, torch.full_like(out, D))  # (q - 1)^2 = 1 mod q


def test_kernel_c_refuses_a_launch_that_does_not_cover_the_work(libs):
    """A grid short of S, P or N (or of the limbs), a ring larger than the
    shared memory it is given, a block other than 16 warps of 4 x 4 tiles,
    or one with more staged pieces a row than threads, is refused before
    anything runs."""
    moduli = primes.coeff_modulus_from_bits(1024, [26, 27])
    table = modular.LimbConstants(moduli, "cpu").table
    sv, hi, lo = _wide_operands(moduli, 17, 4, 32, 0, 64)
    plan = scan_kernel.scan_wide_plan(17, 32, 2, 64, 4, 0)
    assert plan.grid == (2, 2, 4) and plan.prefixes == 16
    for bad in ({"grid": (1, 2, 4)}, {"grid": (2, 1, 4)}, {"grid": (2, 2, 2)}, {"grid": (2, 2, 3)},
                {"shared_bytes": plan.shared_bytes - 16}, {"shared_bytes": 232448 + 16},
                {"stages": 5},
                {"prefixes": 32, "grid": (2, 1, 4), "shared_bytes": 232448},
                {"prefixes": 64, "columns": 8, "grid": (4, 1, 4), "shared_bytes": 232448}):
        assert _emulated_wide(libs["scan_wide"], sv, hi, lo, table, 0,
                              dataclasses.replace(plan, **bad))[0] != 0, bad


# ---------------------------------------------------------------------------
# kernel E: the key switch's entries and the expansion's combine step
# ---------------------------------------------------------------------------

# (N, chain bits: ciphertext primes then the special prime) of kernel E's
# cases: the u32 method (tpu32-like 26-28 bits), the 48-bit one (SEAL's
# 36/37-bit chain), the generic one (60/61 bits), and a tpu32 chain of 28
# ciphertext limbs and 29 key primes as at N=32768 (L (q - 1)^2 above 2^64).
KS_CHAINS = [(64, (26, 27, 28)), (128, (34, 36, 37)), (64, (58, 60, 61)), (64, (30,) * 29)]


def _ks_ctx(n, bits, reencode="balanced"):
    from pir_tpu_torch.core.context import PirContext
    from pir_tpu_torch.core.params import EncryptionParams, create_pir_parameters

    ep = EncryptionParams(poly_modulus_degree=n, plain_modulus=primes.get_prime(2 * n, 12),
                          coeff_modulus=tuple(primes.coeff_modulus_from_bits(n, list(bits))))
    return PirContext(create_pir_parameters(40, 8, 2, ep, reencode_digits=reencode), "cpu")


@pytest.fixture
def emulated_e(libs, monkeypatch):
    """Kernel E's wrappers on CPU tensors, launching the emulation."""
    monkeypatch.setattr(kernels.KEYSWITCH, "_lib", libs["keyswitch"])
    monkeypatch.setattr(kernels, "require_cuda", lambda x, name, kernel: None)
    monkeypatch.setattr(kernels, "stream_handle", lambda t: None)
    kernels.KEYSWITCH.variant_launches.clear()
    return kernels.KEYSWITCH.variant_launches


def _ks_words(ctx, shape, seed, moduli=None, top=False):
    """int64[*shape, L, N] residues below each limb's modulus (q - 1 in
    every word where `top`)."""
    moduli = ctx.ct_moduli if moduli is None else moduli
    if top:
        return torch.tensor(moduli, dtype=torch.int64)[:, None].expand(*shape, -1, ctx.n) - 1
    return _residues(np.random.default_rng(seed), moduli, (*shape, ctx.n), -2)


@pytest.mark.parametrize("top", [False, True], ids=["random", "q-1"])
@pytest.mark.parametrize("n,bits", KS_CHAINS)
def test_kernel_e_emulated_equals_plain(emulated_e, n, bits, top):
    """E1 (with and without a Galois permutation, from a ciphertext's
    second polynomial read in place), E2, E3 (no addend, apply_galois's
    permuted c0, relinearize's c0 and c1) and E4 (axis 0 and Q = 2 trees on
    axis 1, the first and the last level) against their plain versions,
    bit for bit."""
    from pir_tpu_torch.ops import expand, keyswitch

    ctx = _ks_ctx(n, bits)
    L, Lp = ctx.L, ctx.Lp
    if top:  # the largest sums: every digit and key word q - 1
        assert L * (max(ctx.key_moduli) - 1) ** 2 < 1 << 127
    ct = _ks_words(ctx, (3, 2), n, top=top)
    perm = ctx.galois_permutation((n >> 1) + 1)
    for p in (None, perm):
        got = keyswitch.decompose_cuda(ctx, ct[:, 1], p)
        assert torch.equal(got, keyswitch.decompose_plain(ctx, ct[:, 1], p))

    digits = _ks_words(ctx, (3, L), n + 1, ctx.key_moduli, top)
    key = _ks_words(ctx, (L, 2), n + 2, ctx.key_moduli, top)
    got = keyswitch.inner_product_cuda(ctx.limbs_qp, digits, key)
    assert torch.equal(got, keyswitch.inner_product_plain(ctx, digits, key))

    acc = _ks_words(ctx, (3, 2), n + 3, ctx.key_moduli, top)
    ct3 = _ks_words(ctx, (3, 3), n + 4, top=top)
    for addends, p in (((None, None), None), ((ct[:, 0], None), perm),
                       ((ct3[:, 0], ct3[:, 1]), None)):
        got = keyswitch.mod_down_cuda(ctx, acc, addends, p)
        assert torch.equal(got, keyswitch.mod_down_plain(ctx, acc, addends, p))

    sub = _ks_words(ctx, (3, 2), n + 5, top=top)
    trees = _ks_words(ctx, (2, 3, 2), n + 6, top=top)
    sub_trees = _ks_words(ctx, (2, 3, 2), n + 7, top=top)
    for j in (0, n.bit_length() - 2):
        assert torch.equal(expand.combine_cuda(ctx, ct, sub, j),
                           expand.combine_plain(ctx, ct, sub, j))
        assert torch.equal(expand.combine_cuda(ctx, trees, sub_trees, j, axis=1),
                           expand.combine_plain(ctx, trees, sub_trees, j, axis=1))
    assert emulated_e == {"pir_ks.decompose": 2, "pir_ks.inner": 1, "pir_ks.moddown": 3,
                          "pir_ks.combine": 4}


def test_kernel_e_emulated_rank_of_a_limb_sharded_mesh(emulated_e):
    """E1-E3 on a rank's view of a limb-sharded mesh (its own ciphertext
    limbs, the whole key basis; E3 keeps limbs offset..offset + L_local of
    the key basis) equal their plain versions."""
    from pir_tpu_torch.ops import keyswitch
    from pir_tpu_torch.parallel.sharded import _LimbShardView

    class Mesh:
        def size(self, axis):
            return 2

        def coord(self, axis):
            return 1

    ctx = _ks_ctx(64, (34, 35, 36, 36, 37))
    view = _LimbShardView(ctx, Mesh())
    assert (view.L, view.ct_limb_offset) == (2, 2)
    ct = _ks_words(view, (3, 2), 5, ctx.ct_moduli[2:])
    perm = ctx.galois_permutation(33)
    for p in (None, perm):
        assert torch.equal(keyswitch.decompose_cuda(view, ct[:, 1], p),
                           keyswitch.decompose_plain(view, ct[:, 1], p))
    digits = _ks_words(ctx, (3, 2), 6, ctx.key_moduli)
    key = _ks_words(ctx, (2, 2), 7, ctx.key_moduli)
    assert torch.equal(keyswitch.inner_product_cuda(view.limbs_qp, digits, key),
                       keyswitch.inner_product_plain(ctx, digits, key))
    acc = _ks_words(ctx, (3, 2), 8, ctx.key_moduli)
    got = keyswitch.mod_down_cuda(view, acc, (ct[:, 0], None), perm)
    assert torch.equal(got, keyswitch.mod_down_plain(view, acc, (ct[:, 0], None), perm))
    assert torch.equal(got[:, 1], keyswitch.mod_down_plain(ctx, acc)[:, 1, 2:])


def test_kernel_e_emulated_switch_steps_write_their_rows(emulated_e, monkeypatch):
    """E3 writes each step's rows into the switch's output in place: one
    row a step gives the words of one step (kernel A's transforms replaced
    by their plain versions)."""
    from pir_tpu_torch.ops import keyswitch

    ctx = _ks_ctx(64, (34, 36, 37))
    monkeypatch.setattr(keyswitch, "decompose", keyswitch.decompose_cuda)
    monkeypatch.setattr(keyswitch, "digit_inner_product",
                        lambda c, d, k: keyswitch.inner_product_cuda(c.limbs_qp, d, k))
    monkeypatch.setattr(keyswitch, "mod_down", keyswitch.mod_down_cuda)
    ct = _ks_words(ctx, (5, 2), 9)
    key = _ks_words(ctx, (ctx.L, 2), 10, ctx.key_moduli)
    whole = keyswitch.apply_galois(ctx, {9: key}, ct, 9)
    monkeypatch.setattr(keyswitch, "SWITCH_CHUNK_BYTES", 1)
    assert torch.equal(keyswitch.apply_galois(ctx, {9: key}, ct, 9), whole)
    assert emulated_e["pir_ks.moddown"] == 6


def test_kernel_e_refuses_what_it_cannot_take(libs, emulated_e):
    """Launches that would not cover their work, or read past the key basis,
    are refused before anything runs; a key switch whose 127-bit sums could
    overflow is refused by the wrapper."""
    from pir_tpu_torch.ops import keyswitch, modular

    lib = libs["keyswitch"]
    assert lib.pir_ks_decompose(None, 0, None, None, None, None, None, 0, 2, 3, 64, None) != 0
    _contract_refused(lib.pir_ks_inner)
    assert lib.pir_ks_moddown(*[None] * 7, 0, None, None, None, 1, 2, 3, 1, 64, 5, 2, None) != 0
    assert lib.pir_expand_combine(None, None, None, None, 1, 1, 2, 2, 64, 128, 0, None) != 0
    qp = modular.LimbConstants(primes.coeff_modulus_from_bits(64, [61, 61]), "cpu")
    with pytest.raises(ValueError, match="127-bit"):
        keyswitch.inner_product_cuda(qp, torch.zeros((1, 64, 2, 64), dtype=torch.int64),
                                     torch.zeros((64, 2, 2, 64), dtype=torch.int64))


# ---------------------------------------------------------------------------
# kernel F: the upper level's lift (F1), contraction (F2) and plane split
# (F4), and the reply's mod switch (F3)
# ---------------------------------------------------------------------------

@pytest.fixture
def emulated_f(libs, monkeypatch):
    """Kernel F's wrappers on CPU tensors, launching the emulation."""
    monkeypatch.setattr(kernels.UPPER, "_lib", libs["upper"])
    monkeypatch.setattr(kernels, "require_cuda", lambda x, name, kernel: None)
    monkeypatch.setattr(kernels, "stream_handle", lambda t: None)
    kernels.UPPER.variant_launches.clear()
    return kernels.UPPER.variant_launches


@pytest.mark.parametrize("top", [False, True], ids=["random", "q-1"])
@pytest.mark.parametrize("reencode", ["balanced", "legacy"])
@pytest.mark.parametrize("n,bits", KS_CHAINS)
def test_kernel_f_emulated_equals_plain(emulated_f, n, bits, reencode, top):
    """On KS_CHAINS (tpu32-like: no hi plane; SEAL-like: a u8 one; 60-bit:
    above the planes' 48 bits, no F4; 28 tpu32 limbs: F3 from 28 down to 1),
    F1 on a second upper level's lower ciphertexts (C = 2, as at d = 3;
    two leading lanes, prefix 2 x dim 3) over column ranges at the start,
    across a lower ciphertext's edge and at a ragged end; F2 on 9 prefixes
    (a ragged third tile of 4) over 5 rows; F3 from L limbs to every keep and from
    fewer limbs; F4 with the chain's plane form: each bit for bit equal to
    its plain version."""
    from pir_tpu_torch.ops import decompose, modswitch, scan

    ctx = _ks_ctx(n, bits, reencode)
    L = ctx.L
    er2 = 2 * decompose.expansion_ratio(ctx)
    result = _ks_words(ctx, (2, 6, 2, 2), n, top=top)  # [lead, prefix * dim, C, 2, L, N]
    ranges = [(0, 3), (er2 - 1, er2 + 2), (2 * er2 - 2, 2 * er2)]
    if er2 <= 24:
        ranges.append((0, 2 * er2))
    for c0, c1 in ranges:
        got = decompose.lift_columns_cuda(ctx, result, 2, 3, c0, c1)
        assert torch.equal(got, decompose.lift_columns_plain(ctx, result, 2, 3, c0, c1))

    sv = _ks_words(ctx, (5, 2), n + 1, top=top)
    items = _ks_words(ctx, (9, 5), n + 2, top=top)
    assert torch.equal(scan.contract_dim_cuda(ctx.limbs_q, sv, items),
                       scan.contract_dim_plain(ctx, sv, items))

    ct = _ks_words(ctx, (3, 2), n + 3, top=top)
    switches = [(L, k) for k in range(1, L + 1)] + [(L - 1, 1)]
    for cur, keep in switches:
        part = ct[..., :cur, :].contiguous()
        assert torch.equal(modswitch.mod_switch_cuda(ctx, part, keep),
                           modswitch.mod_switch_plain(ctx, part, keep))

    bits_q = max(bits[:-1])
    if bits_q <= scan_kernel.PLANES_MAX_BITS:
        hi, lo = scan_kernel.items_to_planes_cuda(items, bits_q)
        want_hi, want_lo = scan_kernel.items_to_planes_plain(items, bits_q)
        assert torch.equal(lo, want_lo)
        assert (hi is None) == (want_hi is None) == (bits_q <= 32)
        assert hi is None or (hi.dtype == want_hi.dtype and torch.equal(hi, want_hi))
    assert emulated_f == {"pir_upper.lift": len(ranges), "pir_upper.contract": 1,
                          "pir_upper.modswitch": sum(keep < cur for cur, keep in switches),
                          **({"pir_upper.split": 1} if bits_q <= 48 else {})}


@pytest.mark.parametrize("entry,extra", [("F2", -1), ("F2", 0), ("F2", 1), ("F2", 33),
                                         ("E2", -1), ("E2", 0), ("E2", 1)])
def test_kernel_f_contraction_exact_at_the_127_bit_edge(emulated_e, emulated_f, entry, extra):
    """The contraction's 128-bit path with every word at q - 1 on a 61-bit
    chain, over terms just under, at, just over and well over what its
    128-bit sums hold (scan_kernel.contract_chunk): F2 over D rows, E2 over
    L digits, each equal to its plain version; past the edge E2's wrapper
    refuses the chain (a key switch never needs it)."""
    from pir_tpu_torch.ops import keyswitch, scan

    probe = _ks_ctx(64, (61, 61, 61))
    chunk = scan_kernel.contract_chunk(probe.ct_moduli)
    m = (max(probe.ct_moduli) - 1) ** 2
    assert chunk * m < 1 << 127 <= (chunk + 1) * m
    if entry == "F2":
        ctx = probe
        sv = _ks_words(ctx, (chunk + extra, 2), 0, top=True)
        items = _ks_words(ctx, (3, chunk + extra), 0, top=True)
        assert torch.equal(scan.contract_dim_cuda(ctx.limbs_q, sv, items),
                           scan.contract_dim_plain(ctx, sv, items))
        return
    ctx = _ks_ctx(64, (61,) * (chunk + extra + 1))
    assert scan_kernel.contract_chunk(ctx.key_moduli) == chunk  # the same widest prime
    digits = _ks_words(ctx, (3, ctx.L), 1, ctx.key_moduli, top=True)
    key = _ks_words(ctx, (ctx.L, 2), 2, ctx.key_moduli, top=True)
    if extra > 0:
        with pytest.raises(ValueError, match="127-bit"):
            keyswitch.inner_product_cuda(ctx.limbs_qp, digits, key)
        return
    assert torch.equal(keyswitch.inner_product_cuda(ctx.limbs_qp, digits, key),
                       keyswitch.inner_product_plain(ctx, digits, key))


def test_kernel_f_refuses_what_it_cannot_take(libs, emulated_f):
    """Launches that would read past their operands are refused before
    anything runs; the wrappers refuse shapes, chains and views the kernels
    do not take."""
    from pir_tpu_torch.ops import decompose, modswitch, scan
    from pir_tpu_torch.parallel.sharded import _LimbShardView

    lib = libs["upper"]
    assert lib.pir_digits_lift(None, None, None, 1, 3, 1, 2, 64, 7, 2, 8, None) != 0
    _contract_refused(lib.pir_contract)
    assert lib.pir_mod_switch(None, None, None, 1, 33, 1, 64, None) != 0
    assert lib.pir_mod_switch(None, None, None, 1, 3, 3, 64, None) != 0
    assert lib.pir_split_planes(None, None, None, 3, 1, 1, 1, 64, None) != 0
    assert lib.pir_split_planes(None, None, None, 1, 1, 1, 1, 64, None) != 0

    ctx = _ks_ctx(64, (34, 36, 37))
    result = _ks_words(ctx, (6, 1, 2), 1)
    with pytest.raises(ValueError, match="result must be"):
        decompose.lift_columns_cuda(ctx, result, 2, 2, 0, 1)
    with pytest.raises(ValueError, match="outside"):
        decompose.lift_columns_cuda(ctx, result, 2, 3, 0, 2 * decompose.expansion_ratio(ctx) + 1)

    class Mesh:
        def size(self, axis):
            return 2

        def coord(self, axis):
            return 0

    view = _LimbShardView(_ks_ctx(64, (34, 35, 36, 37)), Mesh())
    with pytest.raises(ValueError, match="limb shard"):
        decompose.lift_columns_cuda(view, _ks_words(view, (6, 1, 2), 2), 2, 3, 0, 1)
    sv = _ks_words(ctx, (5, 2), 3)
    with pytest.raises(ValueError, match="kernel F2 takes"):
        scan.contract_dim_cuda(ctx.limbs_q, sv, _ks_words(ctx, (2, 4), 4))
    long = _ks_ctx(64, (30,) * 34)
    with pytest.raises(ValueError, match="at most 32"):
        modswitch.mod_switch_cuda(long, _ks_words(long, (1,), 5), 1)
    with pytest.raises(ValueError, match="up to 48 bits"):
        scan_kernel.items_to_planes_cuda(_ks_words(ctx, (1, 2), 6), 60)
    assert emulated_f == {}


# ---------------------------------------------------------------------------
# the exact wide contraction behind E2 and F2 (csrc/contract.cuh)
# ---------------------------------------------------------------------------

def _contract_refused(fn, R=64, I=2, J=3, N=64, bits=37):
    """Launches of the contraction (an E2 or F2 entry) that do not cover
    their work, or that it is not built for, each one field off a plan
    that does: refused before anything runs."""
    plan = scan_kernel.contract_plan(R, I, J, N, bits)
    base = {"R": R, "I": I, "J": J, "N": N, "chunk": I, **dataclasses.asdict(plan)}
    row_tiles = -(-R // plan.rows)
    bad = [{"grid": (plan.grid[0] - 1, plan.grid[1])}, {"grid": (plan.grid[0], row_tiles + 1)},
           {"grid": (plan.grid[0], 0)}, {"rows": 3}, {"rows": 4, "terms": 4}, {"terms": 3},
           {"shared_bytes": plan.shared_bytes - 8}, {"coeff_warps": 4, "splits": 4},
           {"stages": 5}, {"stages": 0}, {"chunk": 0}, {"path": 40}, {"N": 48}, {"R": 0}]
    for change in bad:
        a = {**base, **change}
        assert fn(None, None, None, None, a["R"], a["I"], a["J"], a["N"], a["chunk"], a["path"],
                  a["rows"], a["terms"], a["coeff_warps"], a["splits"], a["stages"],
                  a["shared_bytes"], *a["grid"], None) != 0, change


# (R, I, J, N, bits): the served shapes (kernel_times.keyswitch_cases: E2
# at N=4096 on SEAL's and tpu32's chains, a 16-lane batch's step, N=32768's
# step and relinearization step; upper_cases: F2 at N=4096 and N=32768) and
# small ones at every edge the plan can choose
PLAN_SHAPES = [(1, 2, 3, 4096, 37), (256, 2, 3, 4096, 37), (256, 3, 4, 4096, 30),
               (2730, 2, 3, 4096, 37), (8, 15, 16, 32768, 55), (5, 15, 16, 32768, 55),
               (8, 162, 2, 4096, 36), (4, 57, 15, 32768, 55), (2, 57, 15, 32768, 55),
               (7, 2, 3, 64, 37), (64, 2, 3, 64, 37), (1, 3, 4, 64, 29), (3, 70, 2, 64, 36),
               (5, 13, 2, 128, 60), (1, 20, 3, 64, 36), (9, 5, 2, 64, 27), (3, 600, 2, 32, 61),
               (100000, 1, 1, 32, 20)]


@pytest.mark.parametrize("R,I,J,N,bits", PLAN_SHAPES)
def test_contract_plan_covers_the_work_once(R, I, J, N, bits):
    """contract_plan's launch, walked as csrc/contract.cuh walks it, takes
    every (limb, coefficient) in one block's thread, every row tile in one
    row group and every term of the summed axis in one (i-block, split
    warp, slot), with a kernel instance that is built, within the card's
    threads and shared memory, and the word path of the moduli's width."""
    p = scan_kernel.contract_plan(R, I, J, N, bits)
    width = 32 * p.coeff_warps
    assert p.coeff_warps * p.splits <= scan_kernel.CONTRACT_WARPS
    assert (p.rows, p.terms) in scan_kernel.CONTRACT_BUILT
    assert p.path == (32 if bits <= 32 else 48 if bits <= 48 else 64)
    tiles = N // width
    assert N % width == 0 and p.grid[0] == J * tiles
    coeffs = np.arange(p.grid[0])[:, None] * width + np.arange(width)[None, :]
    assert np.array_equal(np.sort(coeffs // N * N + coeffs % N, axis=None), np.arange(J * N))
    row_tiles = -(-R // p.rows)
    assert 1 <= p.grid[1] <= min(row_tiles, 65535)
    walked = [t for g in range(p.grid[1]) for t in range(g, row_tiles, p.grid[1])]
    assert sorted(walked) == list(range(row_tiles))
    span = p.splits * p.terms
    held = [ib * span + s + m * p.splits for ib in range(-(-I // span))
            for s in range(p.splits) for m in range(p.terms) if ib * span + s + m * p.splits < I]
    assert sorted(held) == list(range(I))
    steps = -(-I // span) * -(-row_tiles // p.grid[1])
    assert 1 <= p.stages <= min(scan_kernel.CONTRACT_STAGES, steps)
    assert p.shared_bytes == scan_kernel.contract_shared_bytes(
        p.rows, p.terms, p.coeff_warps, p.splits, p.stages) <= scan_kernel.SHARED_MAX_BYTES


def _exact_contraction(x, w, moduli):
    """out[r, k, j] = sum_i x[r, i, j] w[i, k, j] mod q_j in Python integers."""
    xs = modular.numpy_u64(x).astype(object)
    ws = modular.numpy_u64(w).astype(object)
    q = np.array([int(m) for m in moduli], dtype=object)[:, None]
    return (xs[:, :, None] * ws[None]).sum(axis=1) % q


# (entry, R, I, chain bits, x offset in words) of the contraction's edges
# under the emulation, and the plan field each one reaches: a ragged row
# tile (7 rows in tiles of 2); row groups (G = 5, 2 stages); one stage (one
# step); 8 split warps over two i-blocks with a ragged split (70 = 64 + 6);
# a ragged split of 2 on the 128-bit path with x not 16-byte aligned; one
# stage with split partials; 4 terms a thread on the one-word path
CONTRACT_EDGES = [
    ("E2", 7, None, (34, 36, 37), 0, {"rows": 2}),
    ("E2", 64, None, (34, 36, 37), 0, {"stages": 2, "grid": (3, 5)}),
    ("E2", 1, None, (26, 27, 28, 29), 0, {"stages": 1, "terms": 4}),
    ("F2", 3, 70, (34, 36, 37), 0, {"splits": 8}),
    ("F2", 5, 13, (58, 60, 61), 1, {"splits": 2, "path": 64}),
    ("F2", 1, 20, (34, 36, 37), 0, {"splits": 4, "stages": 1}),
    ("E2", 9, None, (26, 27, 28, 29), 1, {"terms": 4, "path": 32}),
]


def _offset(t, words):
    """t copied into storage `words` words past an allocation's start."""
    buf = torch.empty(t.numel() + words, dtype=t.dtype)
    out = buf[words:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("top", [False, True], ids=["random", "q-1"])
@pytest.mark.parametrize("entry,R,I,bits,offset,fields", CONTRACT_EDGES)
def test_contraction_emulated_at_every_plan_edge(emulated_e, emulated_f, entry, R, I, bits,
                                                 offset, fields, top):
    """The contraction through E2's and F2's wrappers at each edge
    contract_plan chooses (the plan reaches the fields named), with random
    words and with every word at q - 1: equal to the entry's plain version
    and to the sums in Python integers."""
    from pir_tpu_torch.ops import keyswitch, scan

    ctx = _ks_ctx(64, bits)
    if entry == "E2":
        x = _offset(_ks_words(ctx, (R, ctx.L), R, ctx.key_moduli, top), offset)
        w = _ks_words(ctx, (ctx.L, 2), R + 1, ctx.key_moduli, top)
        moduli, I = ctx.key_moduli, ctx.L
        got = keyswitch.inner_product_cuda(ctx.limbs_qp, x, w)
        assert torch.equal(got, keyswitch.inner_product_plain(ctx, x, w))
    else:
        x = _offset(_ks_words(ctx, (R, I), R, top=top), offset)
        w = _ks_words(ctx, (I, 2), R + 1, top=top)
        moduli = ctx.ct_moduli
        got = scan.contract_dim_cuda(ctx.limbs_q, w, x)
        assert torch.equal(got, scan.contract_dim_plain(ctx, w, x))
    assert (x.data_ptr() % 16 != 0) == (offset % 2 == 1)
    plan = scan_kernel.contract_plan(R, I, len(moduli), 64, max(moduli).bit_length())
    assert {k: getattr(plan, k) for k in fields} == fields
    assert R % plan.rows or fields != {"rows": 2}  # the ragged tile
    assert np.array_equal(modular.numpy_u64(got).astype(object), _exact_contraction(x, w, moduli))
    assert {**emulated_e, **emulated_f} == {"pir_ks.inner" if entry == "E2" else
                                            "pir_upper.contract": 1}


@pytest.mark.parametrize("entry,bits,extra", [(e, 47, x) for e in ("F2", "E2") for x in (-1, 0, 1, 5)]
                         + [("F2", 48, x) for x in (0, 1, 5)])
def test_contraction_exact_at_the_96_bit_chunk_edge(emulated_e, emulated_f, entry, bits, extra):
    """The 96-bit path with every word at q - 1 where (q - 1)^2 is near 2^96
    (scan_kernel.contract_chunk: 4 terms a sum at 47 bits, 1 at 48), over
    terms just under, at, just over and past the chunk: a thread folds its
    sums every chunk terms within a step.  Equal to the sums in Python
    integers, and to the plain version (E2's, pir_tpu's 48-bit method,
    sums its digits in 96 bits unreduced, so it is compared only up to the
    chunk)."""
    from pir_tpu_torch.ops import keyswitch, scan

    probe = _ks_ctx(64, (bits,) * 3)
    chunk = scan_kernel.contract_chunk(probe.ct_moduli)
    m = (max(probe.ct_moduli) - 1) ** 2
    assert chunk * m < 1 << 96 <= (chunk + 1) * m and chunk == (4 if bits == 47 else 1)
    terms = chunk + extra
    if entry == "F2":
        ctx = probe
        w = _ks_words(ctx, (terms, 2), 0, top=True)
        x = _ks_words(ctx, (3, terms), 0, top=True)
        got = scan.contract_dim_cuda(ctx.limbs_q, w, x)
        assert torch.equal(got, scan.contract_dim_plain(ctx, w, x))
        moduli = ctx.ct_moduli
    else:
        ctx = _ks_ctx(64, (bits,) * (terms + 1))
        x = _ks_words(ctx, (3, ctx.L), 1, ctx.key_moduli, top=True)
        w = _ks_words(ctx, (ctx.L, 2), 2, ctx.key_moduli, top=True)
        got = keyswitch.inner_product_cuda(ctx.limbs_qp, x, w)
        if extra <= 0:
            assert torch.equal(got, keyswitch.inner_product_plain(ctx, x, w))
        moduli = ctx.key_moduli
    assert scan_kernel.contract_path(max(moduli).bit_length()) == 48
    assert np.array_equal(modular.numpy_u64(got).astype(object), _exact_contraction(x, w, moduli))


# ---------------------------------------------------------------------------
# kernel G: the BEHZ multiply's lift (G1), tensor product (G2) and floor +
# Shenoy-Kumaresan conversion (G3)
# ---------------------------------------------------------------------------

@pytest.fixture
def emulated_g(libs, monkeypatch):
    """Kernel G's wrappers on CPU tensors, launching the emulation."""
    monkeypatch.setattr(kernels.BEHZ, "_lib", libs["behz"])
    monkeypatch.setattr(kernels, "require_cuda", lambda x, name, kernel: None)
    monkeypatch.setattr(kernels, "stream_handle", lambda t: None)
    kernels.BEHZ.variant_launches.clear()
    return kernels.BEHZ.variant_launches


def _seal_ct_moduli(n: int) -> tuple:
    from pir_tpu_torch.core.params import generate_encryption_params

    return tuple(int(q) for q in generate_encryption_params(n, 24).ct_modulus)


# (ring N of the chain, or None: 61-bit primes; ciphertext limbs k), all
# served at a ring of 64: SEAL's chains at N=4096 (2 x 36 bits), N=8192 (the
# ct-mult cell's 43/44-bit primes), N=16384 (8 limbs) and N=32768 (15 x 55
# bits, Bsk 16 limbs), and 61-bit chains of 1, 5, 9 and 15 limbs (each of
# the kernel's register templates, full and part used; the widest words,
# whose sums pass 2^125)
BEHZ_CHAINS = [(4096, 2), (8192, 4), (16384, 8), (32768, 15), (None, 1), (None, 5), (None, 9),
               (None, 15)]


def _behz_tool(chain, k):
    from pir_tpu_torch.core.rns import RnsTool

    moduli = (_seal_ct_moduli(chain) if chain else
              tuple(primes.coeff_modulus_from_bits(64, [61] * k)))
    assert len(moduli) == k
    return RnsTool(moduli, 64, primes.get_prime(128, 20), device="cpu")


def _behz_words(moduli, shape, seed, fill):
    """int64[*shape, len(moduli), 64]: random residues, or every word at
    q - 1 ("top") or 0 ("zero")."""
    if fill == "random":
        return _residues(np.random.default_rng(seed), moduli, (*shape, 64), -2)
    col = torch.tensor(moduli, dtype=torch.int64)[:, None] - 1
    return (col if fill == "top" else torch.zeros_like(col)).expand(*shape, -1, 64).contiguous()


@pytest.mark.parametrize("fill", ["random", "top", "zero"])
@pytest.mark.parametrize("chain,k", BEHZ_CHAINS)
def test_kernel_g_emulated_equals_plain(emulated_g, chain, k, fill):
    """G1 (on a stack of ciphertexts and on a strided view of their second
    polynomials), G2 (operands of one shape, a selection vector [1, 3]
    broadcast over 2 prefixes, read in place, and a broadcast of both
    operands, copied out) and G3 against the plain RnsTool methods
    they replace, bit for bit, on random words, every word at q - 1 and
    every word 0."""
    from pir_tpu_torch.bfv import multiply

    tool = _behz_tool(chain, k)
    q, bsk = tool.q_moduli, tool.bsk_moduli
    ct = _behz_words(q, (2, 3, 2), k, fill)
    for x in (ct, ct[:, :, 1]):
        assert torch.equal(multiply.lift_cuda(tool, x), multiply.lift_plain(tool, x))

    for a_shape, b_shape in (((2, 3), (2, 3)), ((2, 3), (1, 3)), ((2, 1), (1, 3))):
        a_q = _behz_words(q, (*a_shape, 2), k + 1, fill)
        a_b = _behz_words(bsk, (*a_shape, 2), k + 2, fill)
        b_q = _behz_words(q, (*b_shape, 2), k + 3, fill)
        b_b = _behz_words(bsk, (*b_shape, 2), k + 4, fill)
        got = multiply.tensor_product_cuda(tool, a_q, a_b, b_q, b_b)
        want = multiply.tensor_product_plain(tool, a_q, a_b, b_q, b_b)
        assert got[0].shape == (2, 3, 3, k, 64) and got[1].shape == (2, 3, 3, k + 1, 64)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

    prod_q, prod_b = _behz_words(q, (2, 3), k + 5, fill), _behz_words(bsk, (2, 3), k + 6, fill)
    assert torch.equal(multiply.floor_sk_cuda(tool, prod_q, prod_b),
                       multiply.floor_sk_plain(tool, prod_q, prod_b))
    assert emulated_g == {"pir_behz.lift": 2, "pir_behz.tensor": 3, "pir_behz.floor_sk": 1}


@pytest.mark.parametrize("chain", [8192, 32768])
def test_kernel_g_emulated_bfv_multiply_equals_plain(emulated_g, monkeypatch, chain):
    """The whole multiply with its three steps on kernel G (the NTTs plain):
    the words of the plain bfv_multiply, on the ct-mult scan's shapes
    (blocks [prefix 2, 3 rows] against the selection ciphertexts [1, 3])."""
    from pir_tpu_torch.bfv import multiply
    from pir_tpu_torch.core.context import PirContext
    from pir_tpu_torch.core.params import EncryptionParams, create_pir_parameters

    ep = EncryptionParams(poly_modulus_degree=64, plain_modulus=primes.get_prime(128, 20),
                          coeff_modulus=_seal_ct_moduli(chain) + tuple(
                              primes.coeff_modulus_from_bits(64, [60])))
    ctx = PirContext(create_pir_parameters(40, 8, 2, ep, use_ciphertext_multiplication=True),
                     "cpu")
    blocks = _behz_words(ctx.ct_moduli, (2, 3, 2), 1, "random")
    sel = _behz_words(ctx.ct_moduli, (1, 3, 2), 2, "random")
    want = multiply.bfv_multiply(ctx, blocks, sel)
    for name in ("lift", "tensor_product", "floor_sk"):
        monkeypatch.setattr(multiply, name, getattr(multiply, f"{name}_cuda"))
    assert torch.equal(multiply.bfv_multiply(ctx, blocks, sel), want)
    assert emulated_g == {"pir_behz.lift": 2, "pir_behz.tensor": 1, "pir_behz.floor_sk": 1}


def test_kernel_g_refuses_what_it_cannot_take(libs, emulated_g):
    """Launches with no work, or more limbs than the kernel holds, or rows
    that overlap, are refused before anything runs; the wrappers refuse a
    chain of 16 ciphertext limbs, limbs other than the tool's and operands
    whose bases disagree."""
    from pir_tpu_torch.bfv import multiply

    lib = libs["behz"]
    assert lib.pir_behz_lift(None, 64, None, None, 0, 4, 64, None) != 0
    assert lib.pir_behz_lift(None, 64, None, None, 2, 16, 64, None) != 0
    assert lib.pir_behz_lift(None, 63, None, None, 2, 1, 64, None) != 0
    assert lib.pir_behz_tensor(*[None] * 7, 1, 1, 0, 0, 0, 64, None) != 0
    assert lib.pir_behz_tensor(*[None] * 7, 1, 2, -1, 0, 2, 64, None) != 0
    assert lib.pir_behz_floor_sk(None, None, None, None, 1, 16, 64, None) != 0

    wide = _behz_tool(None, 15)
    long = type(wide)(primes.coeff_modulus_from_bits(64, [61] * 16), 64, wide.t, device="cpu")
    with pytest.raises(ValueError, match="at most 15"):
        multiply.lift_cuda(long, _behz_words(long.q_moduli, (1,), 0, "random"))
    tool = _behz_tool(8192, 4)
    with pytest.raises(ValueError, match="3 limbs"):
        multiply.lift_cuda(tool, _behz_words(tool.q_moduli[:3], (1,), 0, "random"))
    x_q = _behz_words(tool.q_moduli, (1, 2), 0, "random")
    with pytest.raises(ValueError, match="kernel G2 takes"):
        multiply.tensor_product_cuda(tool, x_q, x_q, x_q, x_q)
    with pytest.raises(ValueError, match="prod_b must be"):
        multiply.floor_sk_cuda(tool, x_q, x_q)
    assert emulated_g == {}
