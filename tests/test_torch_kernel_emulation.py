"""Kernels A (csrc/ntt.cu), B (csrc/scan.cu) and C (csrc/scan_wide.cu) run
on the CPU: the CUDA sources themselves, their csrc/*.cuh headers inlined,
compiled by g++ against a small emulation of the CUDA runtime (one
std::thread per CUDA thread, a std::barrier for __syncthreads, a byte
buffer for the block's shared memory; a thread-block cluster's blocks run
at once, each with its own buffer and barrier, with one std::barrier for
the cluster; the PTX carry chains, cp.async copies and cluster primitives
replaced by C equivalents), held bit for bit to the plain versions at
every radix and row split their plans can choose, kernel A at every ring
up to N=32768 (one cluster of 4 or 8 blocks a limb above N=8192, grids
with clusters past the last polynomial) on growing and reducing chains,
and kernel C at every edge of scan_wide_plan's layout.

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
    "add96": "{ %s a += ((unsigned __int128)b2 << 64) | ((uint64_t)b1 << 32) | b0; %s }"
             % (_WORDS, _SPLIT),
    "copy_async16": "{ memcpy(dst, src, 16); }",
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


def emulation_source(name: str, src: "str | None" = None) -> str:
    """csrc/<name>.cu (or `src`, a variant of it) with its launches,
    dynamic shared memory and PTX turned into the emulation's C++."""
    src = (CSRC / f"{name}.cu").read_text() if src is None else src
    for header in sorted(CSRC.glob("*.cuh")):  # inlined, so REPLACED reaches their helpers
        src = src.replace(f'#include "{header.name}"', header.read_text().replace("#pragma once", ""))
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
    out = {name: _compile(d, name, emulation_source(name)) for name in ("ntt", "scan", "scan_wide")}
    P, I64, I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    out["ntt"].pir_ntt.argtypes = kernels.NTT_ARGS
    out["scan"].pir_scan.argtypes = [P, P, P, P, P, I32, I64, I32, I32, I64, I64, I64, I64,
                                     I32, I32, I32, I32, P]
    out["scan_wide"].pir_scan_wide.argtypes = kernels.SCAN_WIDE._entry_points["pir_scan_wide"]
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


def test_scan_wide_variants_edit_the_kernel_as_they_say():
    """pir_tpu_torch/scan_wide_variants.py builds kernel C with parts taken
    out by text edits of csrc/scan_wide.cu: each edit must find its text in
    the source exactly once, so that a change of the kernel cannot leave a
    variant timing something else."""
    from pir_tpu_torch import scan_wide_variants

    src = (CSRC / "scan_wide.cu").read_text()
    for name, edits in scan_wide_variants.EDITS.items():
        out = scan_wide_variants.variant_source(name)
        assert (out == src) == (not edits), name


def test_ntt_cluster_variants_edit_the_kernel_as_they_say():
    """pir_tpu_torch/ntt_cluster_variants.py builds kernel A with parts
    taken out by text edits of csrc/ntt.cu: each edit must find its text
    once, so that a change of the kernel cannot leave a variant timing
    something else."""
    from pir_tpu_torch import ntt_cluster_variants

    src = (CSRC / "ntt.cu").read_text()
    for name, edits in ntt_cluster_variants.EDITS.items():
        assert (ntt_cluster_variants.variant_source(name) == src) == (not edits), name


@pytest.mark.parametrize("n,bits", [(16384, (48, 49)), (32768, (55, 56))])
def test_ntt_cluster_variant_half_the_ctas_equals_plain(tmp_path, n, bits):
    """The variants script's other cluster size, 8,192-word sub-blocks (2
    CTAs of 1,024 threads a cluster at N=16384, 4 at 32768), computes the
    transform too: bit-equal to the plain version, forward and inverse."""
    from pir_tpu_torch import ntt_cluster_variants

    name = "half the CTAs"
    lib = _compile(tmp_path, "ntt", emulation_source(
        "ntt", ntt_cluster_variants.variant_source(name)))
    lib.pir_ntt.argtypes = kernels.NTT_ARGS
    tables = tntt.NttTables(primes.coeff_modulus_from_bits(n, list(bits)), n, "cpu")
    ctas = n >> ntt_cluster_variants.SUB_LOG[name]
    plan = dataclasses.replace(tntt.ntt_plan(n, len(bits)), cluster_ctas=ctas,
                               blocks=len(bits) * ctas)
    x = _residues(np.random.default_rng(n), tables.moduli, (1, n), 1)
    for inverse in (False, True):
        rc, out = _emulated_ntt(lib, tables, x, inverse, plan)
        assert rc == 0
        assert torch.equal(out, tntt.ntt_plain(tables, x, inverse)), inverse
