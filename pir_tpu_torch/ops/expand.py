"""Oblivious query expansion (Angel et al., SealPIR).

Port of ``expand_level``, ``expand_single`` and ``expand_query`` of
``pir_tpu/ops/expand.py``.  Turns one ciphertext encrypting a packed
one-hot polynomial into m ciphertexts, the k-th encrypting coefficient k
(scaled by next_power_two(m) — the client pre-cancels this with an m⁻¹
factor).  The 2^j ciphertexts at level j are one batched tensor
[2^j, 2, L, N]; each level is one batched apply_galois plus two
sign-permutation gathers and two adds.
"""

from __future__ import annotations

import torch

from pir_tpu_torch.core.context import PirContext
from pir_tpu_torch.ops import keyswitch, modular, poly
from pir_tpu_torch.utils.math import ceil_log2, next_power_two


def expand_level(
    ctx: PirContext, galois_keys, cts: torch.Tensor, j: int, axis: int = 0
) -> torch.Tensor:
    """One doubling level: int64[B, 2, L, N] -> [2B, 2, L, N] (level j uses
    Galois element N/2^j + 1).

    axis: which axis doubles — batched serving runs Q trees as
    int64[Q, B, 2, L, N] with axis=1 (every step is batched over leading
    axes)."""
    n = ctx.n
    q = ctx.limbs_q.q
    galois_elt = (n >> j) + 1
    sub = keyswitch.apply_galois(ctx, galois_keys, cts, galois_elt)
    # new upper half: c·x^{-2^j} + Sub(c)·x^{-(N+2^j)}
    lower = modular.add_mod(
        poly.multiply_inverse_power_of_x(ctx, cts, 1 << j),
        poly.multiply_inverse_power_of_x(ctx, sub, n + (1 << j)),
        q,
    )
    upper = modular.add_mod(cts, sub, q)
    return torch.cat([upper, lower], dim=axis)


def expand_single(
    ctx: PirContext, galois_keys, ct: torch.Tensor, num_items: int
) -> torch.Tensor:
    """Expand one ciphertext int64[2, L, N] into int64[num_items, 2, L, N].

    num_items == 0 yields an empty batch (the degenerate last query
    ciphertext when dim_sum is an exact multiple of N).
    """
    if num_items > ctx.n:
        raise ValueError("cannot expand more items from a CT than poly degree")
    cts = ct[None]
    if num_items == 0:
        return cts[:0]
    for j in range(ceil_log2(num_items)):
        cts = expand_level(ctx, galois_keys, cts, j)
    assert cts.shape[0] == next_power_two(num_items)
    return cts[:num_items]


def expand_query(
    ctx: PirContext, galois_keys, cts: torch.Tensor, total_items: int
) -> torch.Tensor:
    """Expand a multi-ciphertext query into total_items selection ciphertexts.

    cts: int64[num_cts, 2, L, N] with num_cts == total_items // N + 1
    (including the degenerate extra ciphertext when total_items is an exact
    multiple of N).
    """
    n = ctx.n
    if cts.shape[0] != total_items // n + 1:
        raise ValueError(
            "number of ciphertexts doesn't match number of items for "
            "oblivious expansion"
        )
    outs = []
    remaining = total_items
    for i in range(cts.shape[0]):
        count = min(n, remaining)
        outs.append(expand_single(ctx, galois_keys, cts[i], count))
        remaining -= n
    return torch.cat(outs, dim=0) if len(outs) > 1 else outs[0]
