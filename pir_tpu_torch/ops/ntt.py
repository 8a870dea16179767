"""Negacyclic number-theoretic transform, batched over RNS limbs.

Port of ``pir_tpu/ops/ntt.py``.  The twiddle tables are built with the
original's numpy/Python-int code, so ``psi_rev``, its Shoup companions and
``n_inv`` are bit-equal to ``pir_tpu``'s.  The transform is the merged-
twiddle radix-2 formulation: forward is decimation-in-time producing
bit-reversed evaluations, inverse consumes that order and returns natural
coefficient order, so no permutation is ever materialized.

Layout contract used everywhere in this package:
  * polynomial tensors are int64 ``[..., L, N]`` — limb axis second-to-last;
  * "NTT form" means bit-reversed-order evaluations at odd powers of ψ.

A CUDA tensor goes through kernel A (``csrc/ntt.cu``, :func:`ntt_cuda`); a
CPU tensor through the plain per-stage version (:func:`ntt_plain`), which
is the reference the kernel is tested against.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from pir_tpu_torch import kernels
from pir_tpu_torch.core import primes as primes_mod
from pir_tpu_torch.ops import modular
from pir_tpu_torch.ops.modular import tensor_u64

KERNEL_MIN_N = 64
KERNEL_MAX_N = 32768
BLOCK_MAX_N = 8192  # one limb of 8-byte words (+1/16 padding) in 68 KB of shared memory
SUB_BLOCK_N = 4096  # above BLOCK_MAX_N: a cluster's CTA holds a sub-block of this many words
BLOCK_THREADS = 256  # threads per block where one polynomial takes fewer
MIN_POLY_THREADS = 64  # at least two warps a polynomial
GROW_MAX_BITS = 50  # below 2^50 kernel A's words may grow: reduced once, at the end


@dataclass(frozen=True)
class NttPlan:
    """Kernel A's launch: a grid of ``blocks`` blocks (CTAs), in clusters of
    ``cluster_ctas``.  Up to BLOCK_MAX_N each block holds
    ``polys_per_block`` polynomial limbs, each by ``threads_per_poly``
    threads with 2^radix_bits words in registers (``cluster_ctas`` 1).
    Above it one cluster of ``cluster_ctas`` = N / SUB_BLOCK_N CTAs holds a
    limb, each CTA a SUB_BLOCK_N-word sub-block (one polynomial's worth of
    threads and shared memory), so ``clusters`` is the polynomial count."""

    log_n: int
    radix_bits: int
    polys_per_block: int
    blocks: int
    cluster_ctas: int = 1

    @property
    def clusters(self) -> int:
        return self.blocks // self.cluster_ctas

    @property
    def threads_per_poly(self) -> int:
        """Threads of one block's polynomial (above BLOCK_MAX_N, of one CTA's
        sub-block)."""
        return ((1 << self.log_n) // self.cluster_ctas) >> self.radix_bits

    @property
    def threads_per_block(self) -> int:
        return self.polys_per_block * self.threads_per_poly

    @property
    def shared_bytes(self) -> int:
        """A block's shared memory: its words, one pad word in 16."""
        words = (1 << self.log_n) // self.cluster_ctas
        return self.polys_per_block * (words + words // 16) * 8


def ntt_plan(n: int, polys: int) -> NttPlan:
    """Kernel A's launch for `polys` polynomial limbs of n words: 8 words a
    thread (at N=4096 four passes; 16 words a thread needed over 100
    registers and ran slower on the H100 at all but one request shape),
    unless a polynomial would then get fewer than MIN_POLY_THREADS threads
    (N < 512), where 4 words a thread spread the work over twice the
    threads.  Up to BLOCK_MAX_N a limb is one block's (N=8192: 1,024
    threads); above it one cluster of N / SUB_BLOCK_N CTAs (4 at N=16384, 8
    at 32768) holds a limb, each CTA a SUB_BLOCK_N-word sub-block laid out as
    an N=4096 limb."""
    log_n = n.bit_length() - 1
    if n != 1 << log_n or not (KERNEL_MIN_N <= n <= KERNEL_MAX_N):
        raise ValueError(f"kernel A handles powers of two {KERNEL_MIN_N} <= N <= {KERNEL_MAX_N}, got N={n}")
    if polys < 1:
        raise ValueError(f"no polynomials to transform ({polys})")
    if n > BLOCK_MAX_N:
        ctas = n // SUB_BLOCK_N
        return NttPlan(log_n, 3, 1, polys * ctas, ctas)
    radix_bits = 3 if n >> 3 >= MIN_POLY_THREADS else 2
    per_poly = n >> radix_bits
    per_block = min(max(1, BLOCK_THREADS // per_poly), polys)
    return NttPlan(log_n, radix_bits, per_block, -(-polys // per_block))


def max_active_clusters(n: int, inverse: bool, grow: bool) -> int:
    """How many of kernel A's clusters at ring n (above BLOCK_MAX_N) the
    current card holds at once (cudaOccupancyMaxActiveClusters for the
    kernel's launch); raises where a cluster cannot be resident."""
    lib = kernels.NTT.lib()
    count = ctypes.c_int(0)
    rc = lib.pir_ntt_max_active_clusters(n.bit_length() - 1, int(inverse), int(grow),
                                         ctypes.byref(count))
    if rc != 0:
        raise RuntimeError(f"kernel A's occupancy query failed: {lib.cuda_error_string(rc).decode()}")
    if count.value < 1:
        raise RuntimeError(f"kernel A's cluster at N={n} cannot be resident on this card")
    return count.value


def grow_max_bits(n: int) -> int:
    """The widest modulus kernel A's growing butterflies take at ring n: an
    inverse's words reach 2^(log2 n + 1) q before the last reduction, so
    q < 2^(63 - log2 n) keeps them in 64 bits (2^50 up to N=8192, 2^49 at
    16384, 2^48 at 32768)."""
    return min(GROW_MAX_BITS, 63 - (n.bit_length() - 1))


def grows(moduli, n: int) -> bool:
    """Whether kernel A runs its growing butterflies on these moduli at
    ring n (every one below 2^grow_max_bits(n))."""
    return max(int(q) for q in moduli).bit_length() <= grow_max_bits(n)


def _bit_reverse_indices(n: int) -> np.ndarray:
    logn = n.bit_length() - 1
    idx = np.arange(n, dtype=np.uint64)
    out = np.zeros(n, dtype=np.uint64)
    for b in range(logn):
        out |= ((idx >> b) & 1) << (logn - 1 - b)
    return out


class NttTables:
    """Precomputed twiddle tables for a list of NTT-friendly primes.

    Host tables (numpy u64, as in ``pir_tpu``) have shape [L, N]; the device
    copies are int64 tensors on ``device``, scalar companions shaped [L, 1]
    so they broadcast over ``[..., L, N]`` operands.
    """

    def __init__(self, moduli, n: int, device=None):
        self.n = n
        self.moduli = tuple(int(m) for m in moduli)
        self.limbs = modular.LimbConstants(self.moduli, device)
        self.device = self.limbs.device
        L = len(self.moduli)
        brv = _bit_reverse_indices(n)

        psi_rev = np.zeros((L, n), dtype=np.uint64)
        psi_inv_rev = np.zeros((L, n), dtype=np.uint64)
        n_inv = np.zeros((L, 1), dtype=np.uint64)
        for li, q in enumerate(self.moduli):
            psi = primes_mod.primitive_root_2n(q, 2 * n)
            psi_inv = pow(psi, -1, q)
            powers = np.zeros(n, dtype=object)
            inv_powers = np.zeros(n, dtype=object)
            acc = 1
            acc_inv = 1
            for i in range(n):
                powers[i] = acc
                inv_powers[i] = acc_inv
                acc = acc * psi % q
                acc_inv = acc_inv * psi_inv % q
            psi_rev[li] = powers[brv.astype(np.int64)].astype(np.uint64)
            psi_inv_rev[li] = inv_powers[brv.astype(np.int64)].astype(np.uint64)
            n_inv[li, 0] = pow(n, -1, q)

        q_col = np.array(self.moduli, dtype=np.uint64).reshape(L, 1)
        self.host = {
            "psi_rev": psi_rev,
            "psi_rev_shoup": modular.shoup_precompute(psi_rev, q_col),
            "psi_inv_rev": psi_inv_rev,
            "psi_inv_rev_shoup": modular.shoup_precompute(psi_inv_rev, q_col),
            "n_inv": n_inv,
            "n_inv_shoup": modular.shoup_precompute(n_inv, q_col),
        }
        for name, arr in self.host.items():
            setattr(self, name, tensor_u64(arr, self.device))

    def slice(self, count: int) -> "NttTables":
        """Tables restricted to the first `count` limbs (shares storage)."""
        return self.limb_range(0, count)

    def limb_range(self, start: int, stop: int) -> "NttTables":
        """Tables restricted to limbs [start, stop): one rank's moduli on a
        limb-sharded mesh.  The twiddle tensors are contiguous row slices,
        so kernel A reads them in place."""
        out = object.__new__(NttTables)
        out.n = self.n
        out.moduli = self.moduli[start:stop]
        out.limbs = self.limbs.limb_range(start, stop)
        out.device = self.device
        out.host = {k: v[start:stop] for k, v in self.host.items()}
        for name in self.host:
            setattr(out, name, getattr(self, name)[start:stop])
        return out

    # ------------------------------------------------------------------
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Coefficient order -> bit-reversed NTT order.  x: int64[..., L, N]."""
        if x.is_cuda:
            return ntt_cuda(self, x.contiguous(), inverse=False)
        return ntt_plain(self, x, inverse=False)

    def inverse(self, x: torch.Tensor) -> torch.Tensor:
        """Bit-reversed NTT order -> coefficient order.  x: int64[..., L, N]."""
        if x.is_cuda:
            return ntt_cuda(self, x.contiguous(), inverse=True)
        return ntt_plain(self, x, inverse=True)

    # ------------------------------------------------------------------
    def pointwise_mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Product of two NTT-form polynomials (any broadcastable shapes)."""
        return self.limbs.mul(a, b)

    def negacyclic_polymul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Full coefficient-domain negacyclic product a*b mod (x^N + 1): the
        transforms are kernel A on a CUDA tensor, the plain version on a
        CPU one."""
        return self.inverse(self.pointwise_mul(self.forward(a), self.forward(b)))


def ntt_plain(tables: NttTables, x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """The transform as log2 N vectorized butterfly stages over
    ``[..., L, N]`` (the plain PyTorch version of kernel A)."""
    n = tables.n
    L = len(tables.moduli)
    q3 = tables.limbs.q[:, :, None]  # [L, 1, 1]
    batch = x.shape[:-2]
    if not inverse:
        m = 1
        while m < n:
            t = n // (2 * m)
            xr = x.reshape(*batch, L, m, 2, t)
            u = xr[..., 0, :]
            v = xr[..., 1, :]
            s = tables.psi_rev[:, m : 2 * m, None]  # [L, m, 1]
            s_sh = tables.psi_rev_shoup[:, m : 2 * m, None]
            vs = modular.mul_mod_shoup(v, s, s_sh, q3)
            nu = modular.add_mod(u, vs, q3)
            nv = modular.sub_mod(u, vs, q3)
            x = torch.stack([nu, nv], dim=-2).reshape(*batch, L, n)
            m *= 2
        return x
    t = 1
    m = n
    while m > 1:
        h = m // 2
        xr = x.reshape(*batch, L, h, 2, t)
        u = xr[..., 0, :]
        v = xr[..., 1, :]
        s = tables.psi_inv_rev[:, h : 2 * h, None]
        s_sh = tables.psi_inv_rev_shoup[:, h : 2 * h, None]
        nu = modular.add_mod(u, v, q3)
        nv = modular.mul_mod_shoup(modular.sub_mod(u, v, q3), s, s_sh, q3)
        x = torch.stack([nu, nv], dim=-2).reshape(*batch, L, n)
        t *= 2
        m = h
    return modular.mul_mod_shoup(
        x, tables.n_inv, tables.n_inv_shoup, tables.limbs.q
    )


def ntt_cuda(tables: NttTables, x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """Kernel A on a contiguous int64 CUDA tensor ``[..., L, N]``, laid out
    by :func:`ntt_plan`."""
    n = tables.n
    L = len(tables.moduli)
    if not x.is_cuda or x.dtype != torch.int64:
        raise ValueError(f"ntt_cuda needs an int64 CUDA tensor, got {x.dtype} on {x.device}")
    if x.shape[-2:] != (L, n):
        raise ValueError(f"ntt_cuda expects [..., {L}, {n}], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("ntt_cuda needs a contiguous tensor")
    if x.device != tables.device:
        raise ValueError(f"tables live on {tables.device}, tensor on {x.device}")
    if n & (n - 1) or not (KERNEL_MIN_N <= n <= KERNEL_MAX_N):
        raise ValueError(
            f"kernel A handles powers of two {KERNEL_MIN_N} <= N <= {KERNEL_MAX_N}, got N={n}"
        )
    out = torch.empty_like(x)
    batch = x.numel() // (L * n)
    if batch == 0:
        return out
    plan = ntt_plan(n, batch * L)
    if inverse:
        tw, tw_sh = tables.psi_inv_rev, tables.psi_inv_rev_shoup
    else:
        tw, tw_sh = tables.psi_rev, tables.psi_rev_shoup
    grow = grows(tables.moduli, n)
    kernels.NTT.launch(
        "pir_ntt",
        x.data_ptr(), out.data_ptr(), batch, L, plan.log_n, int(inverse), plan.radix_bits,
        plan.polys_per_block, plan.blocks, plan.cluster_ctas, int(grow),
        tw.data_ptr(), tw_sh.data_ptr(), tables.limbs.table.data_ptr(),
        tables.n_inv.data_ptr(), tables.n_inv_shoup.data_ptr(),
        kernels.stream_handle(x),
        variant="grow" if grow else "reduce",
    )
    return out
