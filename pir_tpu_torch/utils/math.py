"""Scalar integer helpers shared by every layer.

Capability parity with the reference's ``pir/cpp/utils.{h,cpp}``
(``next_power_two``, ``ceil_log2``, ``log2``, ``ipow``,
``generate_galois_elts``) and the client-side modular inverse
(``pir/cpp/client.cpp:69-78``).  All host-side Python — nothing here is
traced or hot.
"""

from __future__ import annotations


def next_power_two(n: int) -> int:
    """Smallest power of two >= n, with next_power_two(0) == 1.

    The zero case matters: the last query ciphertext of a request whose
    dim_sum is an exact multiple of the polynomial degree carries zero
    items, and its (unused) scaling factor is defined as 1
    (reference semantics: pir/cpp/utils.h:29-37).
    """
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def ceil_log2(v: int) -> int:
    """log2(v) rounded up; ceil_log2(0) == 0 (degenerate empty expansion)."""
    if v <= 1:
        return 0
    return (v - 1).bit_length()


def floor_log2(v: int) -> int:
    """log2(v) rounded down (v >= 1)."""
    if v < 1:
        raise ValueError("floor_log2 requires v >= 1")
    return v.bit_length() - 1


def ipow(base: int, exp: int) -> int:
    return base**exp


def invert_mod(m: int, mod: int) -> int:
    """Modular inverse of m modulo mod; raises ValueError if not invertible."""
    try:
        return pow(m, -1, mod)
    except ValueError as e:
        raise ValueError(f"{m} is not invertible mod {mod}") from e


def generate_galois_elts(n: int) -> list[int]:
    """Galois elements needed for oblivious expansion: {N/2^i + 1, i < log2 N}.

    Parity with pir/cpp/utils.cpp:7-14.
    """
    return [(n >> i) + 1 for i in range(ceil_log2(n))]
