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

An upper level of the scan takes the digits a step of columns at a time,
lifted to every limb (:func:`lift_columns`): kernel F1 (``csrc/upper.cu``)
on a CUDA tensor, :func:`decompose_ct` and a broadcast on a CPU one.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pir_tpu_torch import kernels
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


def lift_columns(ctx: PirContext, result: torch.Tensor, prefix: int, dim: int, c0: int,
                 c1: int) -> torch.Tensor:
    """Digit columns [c0, c1) of the lower ciphertexts, lifted to every limb.

    result: int64[..., prefix·dim, C, 2, L, N] coefficient form; its
    (lower-ct, digit) columns are the C·2·ER digit plaintexts of each row,
    flattened C-order (:func:`decompose_ct`'s order within a ciphertext).
    Returns int64[..., prefix·k, dim, L, N] (k = c1 - c0): item (p, c, d)
    is digit column c0 + c of row p·dim + d, the same words in every limb.
    Kernel F1 on a CUDA tensor, the plain version on a CPU one."""
    if result.is_cuda:
        return lift_columns_cuda(ctx, result, prefix, dim, c0, c1)
    return lift_columns_plain(ctx, result, prefix, dim, c0, c1)


def lift_columns_plain(ctx: PirContext, result: torch.Tensor, prefix: int, dim: int, c0: int,
                       c1: int) -> torch.Tensor:
    """The plain PyTorch version of :func:`lift_columns`: decompose_ct of
    the lower ciphertexts that hold the columns, then the columns'
    transpose and broadcast."""
    L, n = ctx.L, ctx.n
    lead = result.shape[:-5]
    er2 = 2 * expansion_ratio(ctx)
    first = c0 // er2
    pts = decompose_ct(ctx, result[..., first : -(-c1 // er2), :, :, :])
    pts = pts.reshape(*lead, prefix, dim, -1, n)[..., c0 - first * er2 : c1 - first * er2, :]
    digits = pts.transpose(-3, -2)  # [..., prefix, k, dim, N]
    lifted = digits[..., None, :].expand(*digits.shape[:-1], L, n)
    return lifted.reshape(*lead, prefix * (c1 - c0), dim, L, n)


def lift_table(ctx: PirContext) -> torch.Tensor:
    """Kernel F1's column table, cached on the context: int64 [2·ER, 3]
    rows (source row poly·L + limb, shift, width) of the two polynomials'
    (limb, digit) columns in decompose_ct's order."""
    key = ("decompose", "lift_table")
    hit = ctx.derived.get(key)
    if hit is None:
        rows = [(poly * ctx.L + limb, d * w, w)
                for poly in range(2)
                for limb, (r, w) in enumerate(zip(local_expansion_ratios(ctx), digit_widths(ctx)))
                for d in range(r)]
        hit = ctx.derived[key] = torch.tensor(rows, dtype=torch.int64).to(ctx.device)
    return hit


def lift_columns_cuda(ctx: PirContext, result: torch.Tensor, prefix: int, dim: int, c0: int,
                      c1: int) -> torch.Tensor:
    """Kernel F1 (``pir_digits_lift``): the decomposition, the column
    flattening, the transpose and the lift in one write, into the contiguous
    layout kernel A's forward takes."""
    kernels.require_cuda(result, "result", "F")
    if getattr(ctx, "limb_axis_name", None) is not None:
        raise ValueError("kernel F1 lifts a whole chain's digits, not a limb shard's")
    L, n = ctx.L, ctx.n
    lead = result.shape[:-5]
    rows, C, polys = result.shape[-5:-2]
    er2 = 2 * expansion_ratio(ctx)
    if (rows, polys) != (prefix * dim, 2) or result.shape[-2:] != (L, n):
        raise ValueError(f"result must be [..., {prefix * dim}, C, 2, {L}, {n}], "
                         f"got {tuple(result.shape)}")
    if not 0 <= c0 <= c1 <= C * er2:
        raise ValueError(f"columns [{c0}, {c1}) outside the {C * er2} of the lower ciphertexts")
    table = lift_table(ctx)
    if table.device != result.device:
        raise ValueError(f"the context's tables live on {table.device}, result on {result.device}")
    result = result.contiguous()
    out = torch.empty((*lead, prefix * (c1 - c0), dim, L, n), dtype=torch.int64,
                      device=result.device)
    if out.numel() == 0:
        return out
    kernels.UPPER.launch("pir_digits_lift", result.data_ptr(), table.data_ptr(), out.data_ptr(),
                         math.prod(lead) * prefix, dim, C, L, n, c0, c1 - c0, er2,
                         kernels.stream_handle(result))
    return out


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
