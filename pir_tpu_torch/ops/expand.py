"""Oblivious query expansion (Angel et al., SealPIR).

Port of ``expand_level``, ``expand_single``, ``expand_query``, their
batched forms ``expand_single_batch`` / ``expand_query_batch`` and their
mesh forms ``expand_single_sharded`` / ``expand_query_sharded`` of
``pir_tpu/ops/expand.py``.  Turns one ciphertext encrypting a packed
one-hot polynomial into m ciphertexts, the k-th encrypting coefficient k
(scaled by next_power_two(m) — the client pre-cancels this with an m⁻¹
factor).  The 2^j ciphertexts at level j are one batched tensor
[2^j, 2, L, N]; each level is one batched apply_galois and one
:func:`combine` (two negacyclic shifts and two adds: kernel E4 on a card).
"""

from __future__ import annotations

import math

import torch

from pir_tpu_torch import kernels
from pir_tpu_torch.core.context import PirContext
from pir_tpu_torch.ops import keyswitch, modular, poly
from pir_tpu_torch.utils import profiling
from pir_tpu_torch.utils.math import ceil_log2, next_power_two


def expand_level(
    ctx: PirContext, galois_keys, cts: torch.Tensor, j: int, axis: int = 0
) -> torch.Tensor:
    """One doubling level: int64[B, 2, L, N] -> [2B, 2, L, N] (level j uses
    Galois element N/2^j + 1).

    axis: which axis doubles — batched serving runs Q trees as
    int64[Q, B, 2, L, N] with axis=1 (every step is batched over leading
    axes)."""
    with profiling.span("pir.expand.level"):
        sub = keyswitch.apply_galois(ctx, galois_keys, cts, (ctx.n >> j) + 1)
        return combine(ctx, cts, sub, j, axis)


def combine(ctx, cts: torch.Tensor, sub: torch.Tensor, j: int, axis: int = 0) -> torch.Tensor:
    """Level j's doubling of cts and their substitutions sub (both
    [..., B, 2, L, N], B on `axis`): [..., 2B, 2, L, N] holding
    upper = cts + sub, then lower = cts·x^{-2^j} + sub·x^{-(N+2^j)}.  Kernel
    E4 on a CUDA tensor, the plain version on a CPU one."""
    if cts.is_cuda:
        return combine_cuda(ctx, cts, sub, j, axis)
    return combine_plain(ctx, cts, sub, j, axis)


def combine_plain(ctx, cts: torch.Tensor, sub: torch.Tensor, j: int, axis: int = 0) -> torch.Tensor:
    """The plain PyTorch version of :func:`combine`."""
    q = ctx.limbs_q.q
    lower = modular.add_mod(
        poly.multiply_inverse_power_of_x(ctx, cts, 1 << j),
        poly.multiply_inverse_power_of_x(ctx, sub, ctx.n + (1 << j)),
        q,
    )
    upper = modular.add_mod(cts, sub, q)
    return torch.cat([upper, lower], dim=axis)


def combine_cuda(ctx, cts: torch.Tensor, sub: torch.Tensor, j: int, axis: int = 0) -> torch.Tensor:
    """Kernel E4 (``pir_expand_combine``): both halves written straight into
    the doubled output, the Q = prod(shape[:axis]) trees interleaved as
    [Q, 2B, ...]."""
    kernels.require_cuda(cts, "cts", "E")
    kernels.require_cuda(sub, "sub", "E")
    if cts.shape != sub.shape:
        raise ValueError(f"combine needs two tensors of one shape, got {tuple(cts.shape)} "
                         f"and {tuple(sub.shape)}")
    L, n = cts.shape[-2:]
    if L != len(ctx.limbs_q.moduli) or not 0 <= j < n.bit_length() - 1:
        raise ValueError(f"combine at level {j} of [..., {L}, {n}] under "
                         f"{len(ctx.limbs_q.moduli)} limbs")
    axis %= cts.dim()
    B = cts.shape[axis]
    out = torch.empty((*cts.shape[:axis], 2 * B, *cts.shape[axis + 1:]), dtype=torch.int64,
                      device=cts.device)
    if out.numel() == 0:
        return out
    cts, sub = cts.contiguous(), sub.contiguous()
    kernels.KEYSWITCH.launch(
        "pir_expand_combine", cts.data_ptr(), sub.data_ptr(), ctx.limbs_q.table.data_ptr(),
        out.data_ptr(), math.prod(cts.shape[:axis]), B, math.prod(cts.shape[axis + 1:-2]), L,
        n, 1 << j, n + (1 << j), kernels.stream_handle(cts))
    return out


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
    with profiling.span("pir.expand"):
        outs = []
        remaining = total_items
        for i in range(cts.shape[0]):
            count = min(n, remaining)
            outs.append(expand_single(ctx, galois_keys, cts[i], count))
            remaining -= n
        return torch.cat(outs, dim=0) if len(outs) > 1 else outs[0]


def expand_single_batch(
    ctx: PirContext, galois_keys, cts: torch.Tensor, num_items: int
) -> torch.Tensor:
    """Expand Q independent ciphertexts int64[Q, 2, L, N] into
    int64[Q, num_items, 2, L, N]: one doubling tree per query, all queries
    sharing each level's key switch.  Each lane equals expand_single on its
    ciphertext bit for bit (the same ops; the doubling axis carries a
    leading query axis)."""
    if num_items > ctx.n:
        raise ValueError("cannot expand more items from a CT than poly degree")
    x = cts[:, None]  # [Q, 1, 2, L, N]
    if num_items == 0:
        return x[:, :0]
    for j in range(ceil_log2(num_items)):
        x = expand_level(ctx, galois_keys, x, j, axis=1)
    assert x.shape[1] == next_power_two(num_items)
    return x[:, :num_items]


def expand_query_batch(
    ctx: PirContext, galois_keys, cts: torch.Tensor, total_items: int
) -> torch.Tensor:
    """Expand Q same-shape queries int64[Q, num_cts, 2, L, N] into
    int64[Q, total_items, 2, L, N] (the batched twin of expand_query)."""
    n = ctx.n
    if cts.shape[1] != total_items // n + 1:
        raise ValueError(
            "number of ciphertexts doesn't match number of items for "
            "oblivious expansion"
        )
    with profiling.span("pir.expand"):
        outs = []
        remaining = total_items
        for i in range(cts.shape[1]):
            count = min(n, remaining)
            if count > 0:
                outs.append(expand_single_batch(ctx, galois_keys, cts[:, i], count))
            remaining -= n
        return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def expand_single_sharded(
    ctx: PirContext, galois_keys, ct: torch.Tensor, num_items: int, mesh, axis_name: str
) -> torch.Tensor:
    """expand_single with the doubling tree sharded over a mesh axis.

    Level j maps ciphertext k to outputs (k, k + 2^j) using only ciphertext
    k, so after log2(S) levels run on every rank each of the S ranks of the
    axis expands its own subtree — rank s's local output m is global output
    s + m·S — with no traffic until one all_gather and a stride unshuffle.
    Equal to expand_single bit for bit.  A non-power-of-two axis, or a tree
    of at most S leaves, is expanded whole on every rank.
    """
    n_shards = mesh.size(axis_name)
    if num_items > ctx.n:
        raise ValueError("cannot expand more items from a CT than poly degree")
    logm = ceil_log2(num_items)
    if n_shards <= 1 or n_shards & (n_shards - 1) or (1 << logm) <= n_shards:
        return expand_single(ctx, galois_keys, ct, num_items)
    j0 = n_shards.bit_length() - 1  # log2(S)
    cts = ct[None]
    for j in range(j0):
        cts = expand_level(ctx, galois_keys, cts, j)  # every rank: S cts
    me = mesh.coord(axis_name)
    mine = cts[me : me + 1]
    for j in range(j0, logm):
        mine = expand_level(ctx, galois_keys, mine, j)
    # mine[m] is global output s + m*S: gather [S, M, 2, L, N], unshuffle
    full = mesh.all_gather(mine[None], axis_name, dim=0)
    out = full.transpose(0, 1).reshape(n_shards * mine.shape[0], *mine.shape[1:])
    assert out.shape[0] == next_power_two(num_items)
    return out[:num_items]


def expand_query_sharded(
    ctx: PirContext, galois_keys, cts: torch.Tensor, total_items: int, mesh, axis_name: str
) -> torch.Tensor:
    """expand_query with each ciphertext's tree sharded (see above)."""
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
        if count > 0:
            outs.append(
                expand_single_sharded(ctx, galois_keys, cts[i], count, mesh, axis_name)
            )
        remaining -= n
    return torch.cat(outs, dim=0) if len(outs) > 1 else outs[0]
