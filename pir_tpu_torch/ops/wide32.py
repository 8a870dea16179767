"""Exact multi-word sums for the contractions (port of the raw-accumulation
helpers of ``pir_tpu/ops/wide32.py``).

A "word" here is a 32-bit value held in an int64 tensor (range [0, 2^32)),
so a 32x32 product is one int64 multiply whose bits are the u64 product.
With moduli below 2^48 a product fits three words; a contraction of fewer
than 2^16 terms sums each word exactly in int64 and is reduced once with a
96-bit Barrett reduction.
"""

from __future__ import annotations

from pir_tpu_torch.ops import modular
from pir_tpu_torch.ops.modular import M32, shr


def split_u64(x):
    """u64 bit patterns -> (hi word, lo word)."""
    return shr(x, 32), x & M32


def join_u64(hi, lo):
    return (hi << 32) | lo


def mul32_wide(a, b):
    """Full 64-bit product of two words -> (hi32, lo32)."""
    p = a * b
    return shr(p, 32), p & M32


def mul_u48_3w(xh, xl, wh, wl):
    """(x * w) for x, w < 2^48 -> three words (p2, p1, p0).

    Requires xh, wh < 2^16 (i.e. both operands below 2^48).
    """
    ll_hi, ll_lo = mul32_wide(xl, wl)
    mid = xl * wh + xh * wl  # < 2^49
    t = ll_hi + (mid & M32)  # < 2^33
    p1 = t & M32
    p2 = (t >> 32) + (mid >> 32) + xh * wh  # < 2^32 (2b - 64 <= 32)
    return p2, p1, ll_lo


def sum64_over_axis(p1, p0, axis):
    """Exact sum of 2-word products along `axis` (< 2^16 terms): the
    single-word (moduli below 2^32) twin of :func:`sum96_over_axis`.
    Returns (s2, s1, s0) words of the 96-bit total."""
    s0 = p0.sum(dim=axis)
    s1 = p1.sum(dim=axis) + (s0 >> 32)
    return s1 >> 32, s1 & M32, s0 & M32


def sum96_over_axis(p2, p1, p0, axis):
    """Exact sum of 3-word products along `axis` (< 2^16 terms).

    Each word sums exactly in int64 (< 2^48); carries then ripple upward.
    Returns (s2, s1, s0) words of the 96-bit total (wraps mod 2^96).
    """
    s0 = p0.sum(dim=axis)
    s1 = p1.sum(dim=axis) + (s0 >> 32)
    s2 = (p2.sum(dim=axis) + (s1 >> 32)) & M32
    return s2, s1 & M32, s0 & M32


def barrett_reduce96(x2, x1, x0, q, ratio_hi, ratio_lo):
    """x mod q for a 96-bit x = (x2, x1, x0) words; q < 2^61.

    q/ratio_* are int64 tensors (or Python ints) broadcastable over x;
    ratio words carry u64 bits (:func:`modular.to_i64`).  Returns the
    reduced value as (hi32, lo32) words, like the original.
    """
    r = modular.barrett_reduce_128(x2, join_u64(x1, x0), q, ratio_hi, ratio_lo)
    return split_u64(r)

