"""Vectorized modular arithmetic on int64 tensors holding u64 bit patterns.

Port of ``pir_tpu/ops/modular.py``.  PyTorch has no usable unsigned 64-bit
tensor arithmetic, so a residue is a ``torch.int64`` tensor whose bits are
the u64 value.  Every modulus is below 2^61, so reduced values are
non-negative and compare correctly as signed integers; add, sub and the low
word of a product wrap the same way in two's complement as in u64.  Three
places need care, and have helpers here:

* ``>>`` is arithmetic, so a logical shift masks the high bits (:func:`shr`);
* a compare of two full 64-bit words flips the sign bit first (:func:`ult`);
* a 64x64 product is built from 32-bit halves (:func:`mul64_wide`).

Host u64 arrays cross with ``np.ndarray.view(np.int64)`` (:func:`tensor_u64`).
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
_SIGN = -(1 << 63)


def to_i64(v: int) -> int:
    """A u64 Python int as the int64 with the same bits."""
    v = int(v) & 0xFFFFFFFFFFFFFFFF
    return v - (1 << 64) if v >> 63 else v


def resolve_device(device=None) -> torch.device:
    """A concrete torch.device: the current CUDA card by default ("cuda"
    gets its index).  Without a card the default raises: the port never
    carries on on the CPU unless the caller asks for it (device="cpu")."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "pir_tpu_torch computes on a CUDA card by default and none is "
                'available; pass device="cpu" to compute on the host'
            )
        device = "cuda"
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


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
    return (a ^ _SIGN) < (b ^ _SIGN)


# ---------------------------------------------------------------------------
# 64x64 -> 128 bit products
# ---------------------------------------------------------------------------


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
    """High 64 bits of the 128-bit product."""
    return mul64_wide(x, y)[0]


# ---------------------------------------------------------------------------
# Barrett reduction
# ---------------------------------------------------------------------------


def barrett_ratio(q: int) -> tuple[int, int]:
    """floor(2^128 / q) split into (hi, lo) u64 words.  Host-side."""
    r = (1 << 128) // q
    return (r >> 64) & 0xFFFFFFFFFFFFFFFF, r & 0xFFFFFFFFFFFFFFFF


def barrett_reduce_128(hi, lo, q, ratio_hi, ratio_lo):
    """Reduce a 128-bit value (hi, lo) modulo q (q < 2^61).

    Base-2^64 Barrett reduction: estimate the quotient as the top word of
    (value * floor(2^128/q)) >> 128, then correct with a single conditional
    subtract.  All intermediates wrap mod 2^64 by construction.
    """
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


def barrett_reduce_64(x, q, ratio_hi):
    """Reduce a u64 value modulo q using the high ratio word only."""
    quot = mulhi64(x, ratio_hi)
    r = x - quot * q
    return torch.where(r >= q, r - q, r)


# ---------------------------------------------------------------------------
# Reduced-operand primitives (inputs in [0, q))
# ---------------------------------------------------------------------------


def add_mod(x, y, q):
    s = x + y  # < 2^62, no wrap
    return torch.where(s >= q, s - q, s)


def sub_mod(x, y, q):
    return torch.where(x >= y, x - y, x + q - y)


def neg_mod(x, q):
    return torch.where(x == 0, x, q - x)


def mul_mod(x, y, q, ratio_hi, ratio_lo):
    hi, lo = mul64_wide(x, y)
    return barrett_reduce_128(hi, lo, q, ratio_hi, ratio_lo)


def shoup_precompute(w, q) -> np.ndarray:
    """Companion word floor(w * 2^64 / q) for Shoup multiplication.

    Host-side numpy (object ints) — w and q may be arrays.
    """
    w_obj = np.asarray(w, dtype=object)
    q_obj = np.asarray(q, dtype=object)
    res = (w_obj * (1 << 64)) // q_obj
    return np.asarray(res, dtype=np.uint64)


def shoup_precompute_device(w, q, ratio_hi, ratio_lo):
    """floor(w·2^64/q) computed on the tensor's device.  Estimate via the
    Barrett ratio, then correct: the estimate is within 2 below the true
    value.
    """
    c = w * ratio_hi + mulhi64(w, ratio_lo)
    for _ in range(2):
        hi, lo = mul64_wide(c + 1, q)
        fits = ult(hi, w) | ((hi == w) & (lo == 0))  # (c+1)·q <= w·2^64
        c = c + fits.to(torch.int64)
    hi, lo = mul64_wide(c, q)
    over = ult(w, hi) | ((hi == w) & (lo != 0))
    return c - over.to(torch.int64)


def mul_mod_shoup(x, w, w_shoup, q):
    """x*w mod q with precomputed Shoup companion for the constant w.

    Requires x < q (any w < q).  One mulhi + two mullo.
    """
    q_est = mulhi64(x, w_shoup)
    r = x * w - q_est * q
    return torch.where(r >= q, r - q, r)


# ---------------------------------------------------------------------------
# Per-limb modulus constants
# ---------------------------------------------------------------------------


class LimbConstants:
    """Per-RNS-limb constants on one device, shaped to broadcast over
    [..., L, N].

    ``q``/``ratio_hi``/``ratio_lo`` are int64 tensors of shape [L, 1];
    ``table`` packs the same words as [L, 3] rows (q, ratio_hi, ratio_lo),
    the modulus argument of the CUDA kernels.
    """

    def __init__(self, moduli, device=None):
        self.moduli = tuple(int(m) for m in moduli)
        self.device = resolve_device(device)
        rows = []
        for m in self.moduli:
            hi, lo = barrett_ratio(m)
            rows.append([m, to_i64(hi), to_i64(lo)])
        table = torch.tensor(rows, dtype=torch.int64).reshape(len(rows), 3)
        self.table = table.to(self.device)
        self.q = self.table[:, 0:1]
        self.ratio_hi = self.table[:, 1:2]
        self.ratio_lo = self.table[:, 2:3]

    def __len__(self) -> int:
        return len(self.moduli)

    def slice(self, count: int) -> "LimbConstants":
        """Constants for the first `count` limbs (e.g. drop the special prime)."""
        return self.limb_range(0, count)

    def limb_range(self, start: int, stop: int) -> "LimbConstants":
        """Constants for limbs [start, stop) — e.g. one rank's slice of a
        limb-sharded mesh."""
        return LimbConstants(self.moduli[start:stop], self.device)

    # Elementwise ops over [..., L, N] tensors ------------------------------
    def add(self, x, y):
        return add_mod(x, y, self.q)

    def sub(self, x, y):
        return sub_mod(x, y, self.q)

    def neg(self, x):
        return neg_mod(x, self.q)

    def mul(self, x, y):
        return mul_mod(x, y, self.q, self.ratio_hi, self.ratio_lo)

    def reduce(self, x):
        return barrett_reduce_64(x, self.q, self.ratio_hi)
