"""The ciphertext×database scan over split database planes.

Port of the planes path of ``pir_tpu/ops/scan.py``
(``database_scan_decomp`` with ``db_planes``, ``items_to_planes``,
``contract_dim_planes_wide`` and ``database_scan_decomp_batched``): the
recursive hypercube dot product of SealPIR's decomposition mode.  The
database is a zero-padded hypercube of NTT-form plaintexts held as
[prefix, L, inner, N] planes; the innermost dimension is one contraction
over all prefixes at once, and each upper dimension decomposes the
intermediate ciphertexts into digit plaintexts and contracts again.  Every
single-query contraction is :func:`scan_kernel.contract_dim_auto` (kernel B
on the card); a batch's inner contraction is
:func:`scan_kernel.contract_dim_wide_auto` (kernel C), one pass over the
database for all its queries.
"""

from __future__ import annotations

import torch

from pir_tpu_torch.core.context import PirContext
from pir_tpu_torch.ops import decompose, scan_kernel


def _ct_moduli_bits(ctx: PirContext) -> int:
    return max(int(q).bit_length() for q in ctx.ct_moduli)


def contract_dim_planes(ctx: PirContext, sv_ntt, db_hi, db_lo) -> torch.Tensor:
    """sv int64[D, 2, L, N] against [P, L, D, N] planes -> [P, 2, L, N]."""
    return scan_kernel.contract_dim_auto(sv_ntt, db_hi, db_lo, ctx.limbs_q)


def contract_dim_planes_wide(ctx: PirContext, sv_wide, db_hi, db_lo) -> torch.Tensor:
    """sv int64[D, S, L, N] (S folded (query, size) columns) against
    [P, L, D, N] planes -> [P, S, L, N], one pass over the planes."""
    return scan_kernel.contract_dim_wide_auto(sv_wide, db_hi, db_lo, ctx.limbs_q)


def items_to_planes(ctx: PirContext, items_ntt: torch.Tensor):
    """[P, D, L, N] int64 items -> transposed (hi, lo) planes [P, L, D, N]."""
    t = items_ntt.transpose(1, 2).contiguous()
    return scan_kernel.split_planes(t, bits=_ct_moduli_bits(ctx))


def database_scan_decomp(
    ctx: PirContext, dims: tuple, sv_ntt: torch.Tensor, db_planes
) -> torch.Tensor:
    """Full d-dimensional decomposition-mode scan.

    dims:   hypercube dimensions (D_0, ..., D_{d-1}); DB index is row-major
            with D_0 outermost.
    sv_ntt: int64[sum(dims), 2, L, N] — expanded selection vector, NTT
            form, dimension blocks concatenated in order.
    db_planes: (hi, lo) planes of the inner-grouped DB, [prefix, L, inner, N].
    Returns int64[(2·ER)^(d-1), 2, L, N] reply ciphertexts, coefficient form.
    """
    d = len(dims)
    offsets = []
    off = 0
    for dim in dims:
        offsets.append(off)
        off += dim
    total = 1
    for dim in dims:
        total *= dim
    db_hi, db_lo = db_planes
    if db_lo.shape[0] * db_lo.shape[2] != total:
        raise ValueError("db planes must cover the zero-padded hypercube")

    # Innermost dimension: plain DB plaintexts, one ct per prefix.
    inner = dims[-1]
    prefix = total // inner
    sv_last = sv_ntt[offsets[-1] : offsets[-1] + inner]
    result = contract_dim_planes(ctx, sv_last, db_hi, db_lo)
    result = ctx.ntt_q.inverse(result)  # coefficient form

    # Upper dimensions, bottom-up: decompose, re-NTT, contract.
    for level in range(d - 2, -1, -1):
        dim = dims[level]
        prefix //= dim
        sv_lvl = sv_ntt[offsets[level] : offsets[level] + dim]
        # result: [prefix*dim, C, 2, L, N] (C=1 at the first upper level)
        if result.dim() == 4:
            result = result[:, None]
        C = result.shape[1]
        pts = decompose.decompose_ct(ctx, result)  # [prefix*dim, C, 2*ER, N]
        pts_ntt = ctx.ntt_q.forward(
            pts[..., None, :].expand(*pts.shape[:-1], ctx.L, ctx.n)
        )  # [prefix*dim, C, 2*ER, L, N]
        # flatten (lower-ct, digit) C-order, like the reference's
        # `for ct in lower_result: for pt in Encode(ct)`
        newC = C * pts_ntt.shape[2]
        items = pts_ntt.reshape(prefix, dim, newC, ctx.L, ctx.n)
        # contract over `dim` for each of the newC digit plaintexts:
        # (prefix, newC) jointly form the prefix axis.
        items_flat = items.transpose(1, 2).reshape(prefix * newC, dim, ctx.L, ctx.n)
        ih, il = items_to_planes(ctx, items_flat)
        res = ctx.ntt_q.inverse(contract_dim_planes(ctx, sv_lvl, ih, il))
        result = res.reshape(prefix, newC, 2, ctx.L, ctx.n)

    # top level: prefix == 1; C axis may be absent for d == 1
    if result.dim() == 4:
        result = result[:, None]
    return result.reshape(-1, 2, ctx.L, ctx.n)


def database_scan_decomp_batched(
    ctx: PirContext, dims: tuple, sv_ntt_b: torch.Tensor, db_planes
) -> torch.Tensor:
    """Multi-query decomposition-mode scan over shared database planes.

    sv_ntt_b: int64[B, sum(dims), 2, L, N] — B expanded selection vectors.
    Returns int64[B, (2·ER)^(d-1), 2, L, N], equal per query to
    :func:`database_scan_decomp`.  The innermost (whole-database)
    contraction folds the B queries into the size axis, [inner, B·2, L, N],
    so the planes are read once for the whole batch; the upper levels work
    on per-query intermediates and loop over the lanes.
    """
    B = sv_ntt_b.shape[0]
    offsets = []
    off = 0
    for dim in dims:
        offsets.append(off)
        off += dim
    total = 1
    for dim in dims:
        total *= dim
    db_hi, db_lo = db_planes
    if db_lo.shape[0] * db_lo.shape[2] != total:
        raise ValueError("db planes must cover the zero-padded hypercube")

    inner = dims[-1]
    prefix = total // inner
    n, L = ctx.n, ctx.L
    sv_last = sv_ntt_b[:, offsets[-1] : offsets[-1] + inner]  # [B, inner, 2, L, N]
    sv_wide = sv_last.transpose(0, 1).reshape(inner, B * 2, L, n)
    res = contract_dim_planes_wide(ctx, sv_wide, db_hi, db_lo)  # [prefix, B*2, L, N]
    result = ctx.ntt_q.inverse(res.reshape(prefix, B, 2, L, n).transpose(0, 1))

    for level in range(len(dims) - 2, -1, -1):
        dim = dims[level]
        prefix //= dim
        if result.dim() == 5:
            result = result[:, :, None]  # [B, prefix*dim, C, 2, L, N]
        C = result.shape[2]
        pts = decompose.decompose_ct(ctx, result)
        pts_ntt = ctx.ntt_q.forward(
            pts[..., None, :].expand(*pts.shape[:-1], L, n)
        )  # [B, prefix*dim, C, 2*ER, L, N]
        newC = C * pts_ntt.shape[3]
        items = pts_ntt.reshape(B, prefix, dim, newC, L, n)
        items_flat = items.transpose(2, 3).reshape(B, prefix * newC, dim, L, n)
        outs = []
        for b in range(B):
            sv_lvl = sv_ntt_b[b, offsets[level] : offsets[level] + dim]
            ih, il = items_to_planes(ctx, items_flat[b])
            outs.append(contract_dim_planes(ctx, sv_lvl, ih, il))
        res = ctx.ntt_q.inverse(torch.stack(outs))  # [B, prefix*newC, 2, L, N]
        result = res.reshape(B, prefix, newC, 2, L, n)

    if result.dim() == 5:
        result = result[:, :, None]
    return result.reshape(B, -1, 2, L, n)
