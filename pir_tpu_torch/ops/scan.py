"""The ciphertext×database scan.

Port of ``pir_tpu/ops/scan.py`` (``contract_dim``, ``contract_dim_planes``,
``items_to_planes``, ``database_scan_decomp``, ``contract_dim_planes_wide``
and ``database_scan_decomp_batched``): the recursive hypercube dot product
of SealPIR's decomposition mode.  The database is a zero-padded hypercube
of NTT-form plaintexts; the innermost dimension is one contraction over all
prefixes at once, and each upper dimension decomposes the intermediate
ciphertexts into digit plaintexts and contracts again.

The database comes in one of two layouts (``PirDatabase.scan_impl``):

* [prefix, L, inner, N] planes: every single-query contraction is
  :func:`scan_kernel.contract_dim_auto` (kernel B on the card) — or, on a
  rank of a limb-sharded mesh, its runtime-moduli entry
  :func:`scan_kernel.contract_dim_auto_dyn` (K6); a batch's inner
  contraction is :func:`scan_kernel.contract_dim_wide_auto` (kernel C), one
  pass over the database for all its queries;
* ``db_ntt`` + ``db_shoup`` [padded, L, N]: the inner contraction is
  :func:`scan_kernel.contract_dim_shoup` (kernel D, K7); the upper levels
  contract digit plaintexts with no companions, in plain torch
  (:func:`contract_dim`), as ``pir_tpu`` does outside Pallas.
"""

from __future__ import annotations

import torch

from pir_tpu_torch.core.context import PirContext
from pir_tpu_torch.ops import decompose, modular, scan_kernel


def _ct_moduli_bits(ctx: PirContext) -> int:
    """Max bit width of the ciphertext moduli.  Uses the full chain
    (ctx.ct_moduli delegates through limb-shard views), so the bound holds
    on every rank of a limb-sharded mesh."""
    return max(int(q).bit_length() for q in ctx.ct_moduli)


def _max_chunk(ctx: PirContext) -> int:
    """How many reduced products fit in u64 before a reduction is needed."""
    return max(1, 1 << (63 - _ct_moduli_bits(ctx)))


def contract_dim(ctx: PirContext, sv_ntt, items_ntt, items_shoup=None) -> torch.Tensor:
    """acc[p, ...] = Σ_j sv[j] ⊙ items[p, j, ...]  (NTT domain, mod q).

    sv_ntt: int64[D, 2, L, N]; items_ntt: int64[P, D, L, N]; items_shoup:
    their Shoup companions (the database's, precomputed at setup), which
    route the contraction to :func:`scan_kernel.contract_dim_shoup` (kernel
    D on the card).  Without companions (the upper levels' digit
    plaintexts) each product is a Barrett multiply, in plain torch.
    Returns int64[P, 2, L, N].
    """
    lq = ctx.limbs_q
    if items_shoup is not None:
        return scan_kernel.contract_dim_shoup(sv_ntt, items_ntt, items_shoup, lq)

    def part(start, end):
        prod = modular.mul_mod(
            sv_ntt[None, start:end],  # [1, c, 2, L, N]
            items_ntt[:, start:end, None],  # [P, c, 1, L, N]
            lq.q, lq.ratio_hi, lq.ratio_lo,
        )
        return modular.barrett_reduce_64(prod.sum(dim=1), lq.q, lq.ratio_hi)

    D = items_ntt.shape[1]
    return scan_kernel.sum_row_chunks(part, D, min(_max_chunk(ctx), max(D, 1)), lq.q)


def contract_dim_planes(ctx: PirContext, sv_ntt, db_hi, db_lo) -> torch.Tensor:
    """sv int64[D, 2, L, N] against [P, L, D, N] planes -> [P, 2, L, N].

    On a rank of a limb-sharded mesh (ctx is a limb-shard view) the moduli
    are the rank's own, so the runtime-table entry (K6) is used, with the
    whole chain's width."""
    lq = ctx.limbs_q
    if getattr(ctx, "limb_axis_name", None) is not None:
        consts = scan_kernel.limb_consts(lq.q, lq.ratio_hi, lq.ratio_lo)
        return scan_kernel.contract_dim_auto_dyn(
            sv_ntt, db_hi, db_lo, consts, lq.q, _ct_moduli_bits(ctx)
        )
    return scan_kernel.contract_dim_auto(sv_ntt, db_hi, db_lo, lq)


def contract_dim_planes_wide(ctx: PirContext, sv_wide, db_hi, db_lo) -> torch.Tensor:
    """sv int64[D, S, L, N] (S folded (query, size) columns) against
    [P, L, D, N] planes -> [P, S, L, N], one pass over the planes."""
    return scan_kernel.contract_dim_wide_auto(sv_wide, db_hi, db_lo, ctx.limbs_q)


def items_to_planes(ctx: PirContext, items_ntt: torch.Tensor):
    """[P, D, L, N] int64 items -> transposed (hi, lo) planes [P, L, D, N]."""
    t = items_ntt.transpose(1, 2).contiguous()
    return scan_kernel.split_planes(t, bits=_ct_moduli_bits(ctx))


def database_scan_decomp(
    ctx: PirContext,
    dims: tuple,
    sv_ntt: torch.Tensor,
    db_planes=None,
    db_ntt: "torch.Tensor | None" = None,
    db_shoup: "torch.Tensor | None" = None,
) -> torch.Tensor:
    """Full d-dimensional decomposition-mode scan.

    dims:   hypercube dimensions (D_0, ..., D_{d-1}); DB index is row-major
            with D_0 outermost.
    sv_ntt: int64[sum(dims), 2, L, N] — expanded selection vector, NTT
            form, dimension blocks concatenated in order.
    db_planes: (hi, lo) planes of the inner-grouped DB, [prefix, L, inner, N]
            — every contraction then reads planes; or
    db_ntt, db_shoup: int64[prod(dims), L, N] NTT-form database and its
            Shoup companions (the inner contraction is kernel D's).
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
    if db_planes is not None:
        if db_planes[1].shape[0] * db_planes[1].shape[2] != total:
            raise ValueError("db planes must cover the zero-padded hypercube")
    elif db_ntt is None or db_ntt.shape[0] != total:
        raise ValueError("database must be zero-padded to the hypercube")

    # Innermost dimension: plain DB plaintexts, one ct per prefix.
    inner = dims[-1]
    prefix = total // inner
    sv_last = sv_ntt[offsets[-1] : offsets[-1] + inner]
    if db_planes is not None:
        result = contract_dim_planes(ctx, sv_last, db_planes[0], db_planes[1])
    else:
        items = db_ntt.reshape(prefix, inner, *db_ntt.shape[1:])
        shoup = db_shoup.reshape(items.shape) if db_shoup is not None else None
        result = contract_dim(ctx, sv_last, items, shoup)  # [prefix, 2, L, N]
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
        # a limb-shard view swaps in the all-gathering decomposition
        # (parallel/sharded.py): digits live per limb, but every digit
        # plaintext must reach every limb for the next contraction
        decompose_fn = getattr(ctx, "decompose_fn", None)
        if decompose_fn is not None:
            pts = decompose_fn(result)
        else:
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
        if db_planes is not None:
            ih, il = items_to_planes(ctx, items_flat)
            res = contract_dim_planes(ctx, sv_lvl, ih, il)
        else:
            res = contract_dim(ctx, sv_lvl, items_flat)  # [prefix*newC, 2, L, N]
        res = ctx.ntt_q.inverse(res)
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
