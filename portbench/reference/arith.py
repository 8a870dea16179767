"""Modular arithmetic and the negacyclic NTT on int64 tensors (u64 bits).

Frozen from ``pir_tpu_torch/ops/modular.py``, ``ops/ntt.py`` (the plain
per-stage transform only) and ``core/primes.py`` (the twiddle root), with
imports rewritten.  Plain PyTorch on any device; no kernel of the program.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF


def to_i64(v: int) -> int:
    """A u64 Python int as the int64 with the same bits."""
    v = int(v) & 0xFFFFFFFFFFFFFFFF
    return v - (1 << 64) if v >> 63 else v


def tensor_u64(x, device=None) -> torch.Tensor:
    """u64 array-like -> int64 tensor with the same bits."""
    arr = np.ascontiguousarray(np.asarray(x, dtype=np.uint64))
    return torch.from_numpy(arr.view(np.int64).copy()).to(device)


def numpy_u64(x: torch.Tensor) -> np.ndarray:
    """int64 tensor -> u64 numpy array with the same bits (host copy)."""
    return x.detach().cpu().contiguous().numpy().view(np.uint64)


def shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of u64 bit patterns by 0 < k < 64."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned a < b on u64 bit patterns."""
    sign = -(1 << 63)
    return (a ^ sign) < (b ^ sign)


def mul64_wide(x, y):
    """Full 128-bit product of two u64 tensors, as a (hi, lo) pair."""
    x0 = x & M32
    x1 = shr(x, 32)
    y0 = y & M32
    y1 = shr(y, 32)
    lolo = x0 * y0
    hilo = x1 * y0
    lohi = x0 * y1
    hihi = x1 * y1
    mid = shr(lolo, 32) + (hilo & M32) + (lohi & M32)
    lo = (mid << 32) | (lolo & M32)
    hi = hihi + shr(hilo, 32) + shr(lohi, 32) + shr(mid, 32)
    return hi, lo


def mulhi64(x, y):
    return mul64_wide(x, y)[0]


def barrett_ratio(q: int) -> tuple[int, int]:
    """floor(2^128 / q) split into (hi, lo) u64 words."""
    r = (1 << 128) // q
    return (r >> 64) & 0xFFFFFFFFFFFFFFFF, r & 0xFFFFFFFFFFFFFFFF


def barrett_reduce_128(hi, lo, q, ratio_hi, ratio_lo):
    """A 128-bit value (hi, lo) modulo q (q < 2^61)."""
    carry = mulhi64(lo, ratio_lo)
    t2_hi, t2_lo = mul64_wide(lo, ratio_hi)
    tmp1 = t2_lo + carry
    tmp3 = t2_hi + ult(tmp1, t2_lo).to(torch.int64)
    t4_hi, t4_lo = mul64_wide(hi, ratio_lo)
    tmp1b = tmp1 + t4_lo
    carry4 = t4_hi + ult(tmp1b, t4_lo).to(torch.int64)
    quot = hi * ratio_hi + tmp3 + carry4
    r = lo - quot * q
    return torch.where(r >= q, r - q, r)


def add_mod(x, y, q):
    s = x + y
    return torch.where(s >= q, s - q, s)


def sub_mod(x, y, q):
    return torch.where(x >= y, x - y, x + q - y)


def neg_mod(x, q):
    return torch.where(x == 0, x, q - x)


def mul_mod(x, y, q, ratio_hi, ratio_lo):
    hi, lo = mul64_wide(x, y)
    return barrett_reduce_128(hi, lo, q, ratio_hi, ratio_lo)


def shoup_precompute(w, q) -> np.ndarray:
    """floor(w * 2^64 / q) on the host (object ints)."""
    res = (np.asarray(w, dtype=object) * (1 << 64)) // np.asarray(q, dtype=object)
    return np.asarray(res, dtype=np.uint64)


def mul_mod_shoup(x, w, w_shoup, q):
    """x*w mod q with the Shoup companion of the constant w (x < q)."""
    r = x * w - mulhi64(x, w_shoup) * q
    return torch.where(r >= q, r - q, r)


class Limbs:
    """Per-limb moduli and Barrett constants shaped [L, 1]."""

    def __init__(self, moduli, device):
        self.moduli = tuple(int(m) for m in moduli)
        rows = [[m, to_i64(barrett_ratio(m)[0]), to_i64(barrett_ratio(m)[1])] for m in self.moduli]
        table = torch.tensor(rows, dtype=torch.int64, device=device)
        self.q = table[:, 0:1]
        self.ratio_hi = table[:, 1:2]
        self.ratio_lo = table[:, 2:3]

    def add(self, x, y):
        return add_mod(x, y, self.q)

    def neg(self, x):
        return neg_mod(x, self.q)

    def mul(self, x, y):
        return mul_mod(x, y, self.q, self.ratio_hi, self.ratio_lo)


def primitive_root_2n(modulus: int, two_n: int) -> int:
    """The minimal primitive 2N-th root of unity mod a prime = 1 (mod 2N)."""
    if (modulus - 1) % two_n != 0:
        raise ValueError(f"{modulus} is not 1 mod {two_n}")
    exp = (modulus - 1) // two_n
    half = two_n // 2
    g = 2
    while pow(pow(g, exp, modulus), half, modulus) != modulus - 1:
        g += 1
    root = pow(g, exp, modulus)
    minimal = cur = root
    sq = root * root % modulus
    for _ in range(half - 1):
        cur = cur * sq % modulus
        minimal = min(minimal, cur)
    return minimal


def _bit_reverse_indices(n: int) -> np.ndarray:
    logn = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    out = np.zeros(n, dtype=np.int64)
    for b in range(logn):
        out |= ((idx >> b) & 1) << (logn - 1 - b)
    return out


class Ntt:
    """Twiddle tables of a list of primes at ring degree n, and the merged-
    twiddle radix-2 transform: forward gives bit-reversed evaluations,
    inverse takes them back to coefficient order."""

    def __init__(self, moduli, n: int, device):
        self.n = n
        self.moduli = tuple(int(m) for m in moduli)
        self.limbs = Limbs(self.moduli, device)
        brv = _bit_reverse_indices(n)
        L = len(self.moduli)
        psi_rev = np.zeros((L, n), dtype=np.uint64)
        psi_inv_rev = np.zeros((L, n), dtype=np.uint64)
        n_inv = np.zeros((L, 1), dtype=np.uint64)
        for li, q in enumerate(self.moduli):
            psi = primitive_root_2n(q, 2 * n)
            psi_inv = pow(psi, -1, q)
            powers = np.zeros(n, dtype=object)
            inv_powers = np.zeros(n, dtype=object)
            acc = acc_inv = 1
            for i in range(n):
                powers[i] = acc
                inv_powers[i] = acc_inv
                acc = acc * psi % q
                acc_inv = acc_inv * psi_inv % q
            psi_rev[li] = powers[brv].astype(np.uint64)
            psi_inv_rev[li] = inv_powers[brv].astype(np.uint64)
            n_inv[li, 0] = pow(n, -1, q)
        q_col = np.array(self.moduli, dtype=np.uint64).reshape(L, 1)
        self.psi_rev = tensor_u64(psi_rev, device)
        self.psi_rev_shoup = tensor_u64(shoup_precompute(psi_rev, q_col), device)
        self.psi_inv_rev = tensor_u64(psi_inv_rev, device)
        self.psi_inv_rev_shoup = tensor_u64(shoup_precompute(psi_inv_rev, q_col), device)
        self.n_inv = tensor_u64(n_inv, device)
        self.n_inv_shoup = tensor_u64(shoup_precompute(n_inv, q_col), device)

    def slice(self, count: int) -> "Ntt":
        """The tables of the first `count` primes."""
        out = object.__new__(Ntt)
        out.n = self.n
        out.moduli = self.moduli[:count]
        out.limbs = Limbs(out.moduli, self.psi_rev.device)
        for name in ("psi_rev", "psi_rev_shoup", "psi_inv_rev", "psi_inv_rev_shoup", "n_inv",
                     "n_inv_shoup"):
            setattr(out, name, getattr(self, name)[:count])
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Coefficient order -> bit-reversed NTT order; x int64[..., L, N]."""
        n, L = self.n, len(self.moduli)
        q3 = self.limbs.q[:, :, None]
        batch = x.shape[:-2]
        m = 1
        while m < n:
            t = n // (2 * m)
            xr = x.reshape(*batch, L, m, 2, t)
            u, v = xr[..., 0, :], xr[..., 1, :]
            vs = mul_mod_shoup(v, self.psi_rev[:, m:2 * m, None],
                               self.psi_rev_shoup[:, m:2 * m, None], q3)
            x = torch.stack([add_mod(u, vs, q3), sub_mod(u, vs, q3)], dim=-2).reshape(*batch, L, n)
            m *= 2
        return x

    def inverse(self, x: torch.Tensor) -> torch.Tensor:
        """Bit-reversed NTT order -> coefficient order."""
        n, L = self.n, len(self.moduli)
        q3 = self.limbs.q[:, :, None]
        batch = x.shape[:-2]
        t, m = 1, n
        while m > 1:
            h = m // 2
            xr = x.reshape(*batch, L, h, 2, t)
            u, v = xr[..., 0, :], xr[..., 1, :]
            nv = mul_mod_shoup(sub_mod(u, v, q3), self.psi_inv_rev[:, h:2 * h, None],
                               self.psi_inv_rev_shoup[:, h:2 * h, None], q3)
            x = torch.stack([add_mod(u, v, q3), nv], dim=-2).reshape(*batch, L, n)
            t *= 2
            m = h
        return mul_mod_shoup(x, self.n_inv, self.n_inv_shoup, self.limbs.q)
