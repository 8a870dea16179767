"""Ciphertext digit decomposition — the SealPIR "ciphertext re-encoding".

Port of ``pir_tpu/ops/decompose.py``: each RNS coefficient word of a
ciphertext is split into ceil(log2(q_i) / pt_bits) digits, each digit
polynomial becoming an ordinary plaintext that the next recursion level
multiplies against the next dimension's selection vector.

Digit widths follow ``params.reencode_mode``: legacy (0) uses
``floor(log2 t)`` bits for every digit, as the reference does; balanced (1)
keeps the digit counts but uses ``ceil(bitlen(q_i) / r_i)`` bits per limb.

Digit order contract: polynomial-major, then RNS limb, then digit (low
digit first).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pir_tpu_torch.core.context import PirContext
from pir_tpu_torch.utils.math import floor_log2


def pt_bits_per_coeff(ctx: PirContext) -> int:
    return floor_log2(ctx.t)


def local_expansion_ratios(ctx: PirContext) -> list[int]:
    """Digits per limb: ceil(log2(q_i)/pt_bits), float log2 like the
    reference.  Identical in both modes."""
    bits = pt_bits_per_coeff(ctx)
    return [int(math.ceil(math.log2(q) / bits)) for q in ctx.ct_moduli]


def digit_widths(ctx: PirContext) -> list[int]:
    """Per-limb digit width in bits (legacy: pt_bits; balanced:
    ceil(bitlen(q_i)/r_i), never more than pt_bits)."""
    bits = pt_bits_per_coeff(ctx)
    if ctx.params.reencode_mode == 0:
        return [bits] * len(ctx.ct_moduli)
    ratios = local_expansion_ratios(ctx)
    return [-(-int(q).bit_length() // r) for q, r in zip(ctx.ct_moduli, ratios)]


def expansion_ratio(ctx: PirContext) -> int:
    """Plaintexts per ciphertext polynomial."""
    return sum(local_expansion_ratios(ctx))


def decompose_ct(ctx: PirContext, ct: torch.Tensor) -> torch.Tensor:
    """int64[..., size, L, N] coeff-form -> digit plaintexts
    int64[..., size*ER, N], index order (poly, limb, digit) C-style."""
    ratios = local_expansion_ratios(ctx)
    widths = digit_widths(ctx)
    pieces = []
    for limb, (r, w) in enumerate(zip(ratios, widths)):
        word = ct[..., :, limb, :]  # [..., size, N]; reduced, so >= 0
        mask = (1 << w) - 1
        for d in range(r):
            pieces.append((word >> (d * w)) & mask)
    stacked = torch.stack(pieces, dim=-2)  # [..., size, ER, N]
    shape = stacked.shape
    return stacked.reshape(*shape[:-3], shape[-3] * shape[-2], shape[-1])


def compose_ct(ctx: PirContext, pts: np.ndarray, ct_size: int = 2) -> np.ndarray:
    """Inverse of decompose_ct: digit plaintexts -> u64[ct_size, L, N].

    Host-side numpy (client response path).
    """
    ratios = local_expansion_ratios(ctx)
    widths = digit_widths(ctx)
    er = sum(ratios)
    pts = np.asarray(pts, dtype=np.uint64).reshape(ct_size, er, ctx.n)
    out = np.zeros((ct_size, ctx.L, ctx.n), dtype=np.uint64)
    for poly in range(ct_size):
        k = 0
        for limb, (r, w) in enumerate(zip(ratios, widths)):
            acc = np.zeros(ctx.n, dtype=np.uint64)
            for d in range(r):
                acc += pts[poly, k] << np.uint64(d * w)
                k += 1
            out[poly, limb] = acc
    return out
