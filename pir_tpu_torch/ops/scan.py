"""The ciphertext×database scan.

Port of ``pir_tpu/ops/scan.py`` (``contract_dim``, ``contract_dim_planes``,
``items_to_planes``, ``database_scan_decomp``, ``contract_dim_planes_wide``,
``database_scan_decomp_batched`` and ``database_scan_ctmult``): the
recursive hypercube dot product of SealPIR's two modes.  The database is a
zero-padded hypercube of NTT-form plaintexts; the innermost dimension is one
contraction over all prefixes at once.  In decomposition mode each upper
dimension decomposes the intermediate ciphertexts into digit plaintexts and
contracts again; in ciphertext-multiplication mode it multiplies them by the
dimension's selection ciphertexts (BEHZ), relinearizes and sums.

The database comes in one of two layouts (``PirDatabase.scan_impl``):

* [prefix, L, inner, N] planes: every single-query contraction is
  :func:`scan_kernel.contract_dim_auto` (kernel B on the card) — or, on a
  rank of a limb-sharded mesh, its runtime-moduli entry
  :func:`scan_kernel.contract_dim_auto_dyn` (K6); a batch's inner
  contraction is :func:`scan_kernel.contract_dim_wide_auto` (kernel C), one
  pass over the database for all its queries;
* ``db_ntt`` + ``db_shoup`` [padded, L, N]: the inner contraction is
  :func:`scan_kernel.contract_dim_shoup` (kernel D, K7); the upper levels
  contract digit plaintexts with no companions (:func:`contract_dim`), as
  ``pir_tpu`` does outside Pallas: kernel F2 on the card.

Each upper-level step lifts its digit columns with kernel F1
(:func:`decompose.lift_columns`) and, on the planes layout, splits the
transformed items into planes with kernel F4 (:func:`items_to_planes`); on
the CPU their plain versions run.
"""

from __future__ import annotations

import torch

from pir_tpu_torch import kernels
from pir_tpu_torch.bfv.multiply import bfv_multiply
from pir_tpu_torch.core.context import PirContext
from pir_tpu_torch.ops import decompose, modular, scan_kernel
from pir_tpu_torch.ops.keyswitch import relinearize
from pir_tpu_torch.utils import profiling

# Lifted NTT-form digit plaintexts of one query an upper-level step holds.
# A whole level's are 2·ER·L times its lower ciphertexts (20.2 GB at
# N=32768 on SEAL's chain).  On the card a step (kernels F1, A, F2, A)
# holds 2.0 times its lifted digits (the lift and its transform), 1.80 GB
# at this size; the whole level took 67.96 ms in 1 GiB steps (23 of them)
# against 67.13 ms in 4 GiB steps (5) (``memory_peaks.py`` on an NVIDIA
# H100 80GB HBM3, 700 W): fewer steps save ~1%, so the step stays 1 GiB.
# The plain contraction's temporaries are 36 times a step's.
UPPER_STEP_BYTES = 1 << 30


# The widest BEHZ products a ciphertext-multiplication upper-level step
# holds: ``core/rns.py::RnsTool._sum_conv`` materializes [rows, 3, L + 1, L,
# N] int64 products (fast_floor's q -> Bsk conversion of the size-3 tensor
# product).  One row's multiply and relinearization at N=32768 on SEAL's
# chain hold 3.49 GB of plain-torch transients, 18.5 times that product
# (``memory_peaks.py`` on an NVIDIA H100 80GB HBM3): a step of 1 GiB of
# products (5 rows) holds ~17.5 GB, about a key-switch step's 18.7 GB, where
# the whole dimension's 57 rows would hold ~199 GB.
CTMULT_STEP_BYTES = 1 << 30


def upper_step_columns(rows: int, L: int, n: int) -> int:
    """(lower-ct, digit) columns an upper-level step takes: each is `rows`
    (prefix·dim) digit plaintexts lifted to L limbs of n words."""
    return max(1, UPPER_STEP_BYTES // (rows * L * n * 8))


def ctmult_step_rows(prefix: int, L: int, n: int) -> int:
    """Rows of a dimension a ciphertext-multiplication step multiplies: each
    brings `prefix` products, each a [3, L + 1, L, n] BEHZ sum product."""
    return max(1, CTMULT_STEP_BYTES // (prefix * 3 * (L + 1) * L * n * 8))


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
    plaintexts): kernel F2 (:func:`contract_dim_cuda`) on the card,
    :func:`contract_dim_plain` on the CPU.  Returns int64[P, 2, L, N].
    """
    lq = ctx.limbs_q
    if items_shoup is not None:
        return scan_kernel.contract_dim_shoup(sv_ntt, items_ntt, items_shoup, lq)
    if items_ntt.is_cuda:
        return contract_dim_cuda(lq, sv_ntt, items_ntt)
    return contract_dim_plain(ctx, sv_ntt, items_ntt)


def contract_dim_plain(ctx: PirContext, sv_ntt, items_ntt) -> torch.Tensor:
    """The plain PyTorch version of the companion-free contraction: a
    Barrett multiply a product, u64 sums of _max_chunk rows, each reduced,
    combined mod q."""
    lq = ctx.limbs_q

    def part(start, end):
        prod = modular.mul_mod(
            sv_ntt[None, start:end],  # [1, c, 2, L, N]
            items_ntt[:, start:end, None],  # [P, c, 1, L, N]
            lq.q, lq.ratio_hi, lq.ratio_lo,
        )
        return modular.barrett_reduce_64(prod.sum(dim=1), lq.q, lq.ratio_hi)

    D = items_ntt.shape[1]
    return scan_kernel.sum_row_chunks(part, D, min(_max_chunk(ctx), max(D, 1)), lq.q)


def contract_dim_cuda(limbs, sv_ntt, items_ntt) -> torch.Tensor:
    """Kernel F2 (``csrc/upper.cu``, ``pir_contract``: the exact wide
    contraction of ``csrc/contract.cuh``): sv int64[D, 2, L, N] against items
    int64[P, D, L, N] over the limbs' moduli, in exact sums of
    ``scan_kernel.contract_chunk`` rows, each reduced and added mod q ->
    int64[P, 2, L, N]."""
    kernels.require_cuda(sv_ntt, "sv", "F")
    kernels.require_cuda(items_ntt, "items", "F")
    D, S, L, N = sv_ntt.shape
    P = items_ntt.shape[0]
    if S != 2 or items_ntt.shape != (P, D, L, N) or len(limbs) != L:
        raise ValueError(f"kernel F2 takes sv [D, 2, L, N] and items [P, D, L, N] over L moduli, "
                         f"got {tuple(sv_ntt.shape)}, {tuple(items_ntt.shape)}, {len(limbs)}")
    if max(limbs.moduli).bit_length() > 61:
        raise ValueError("kernel F2 takes moduli below 2^61")
    sv_ntt, items_ntt = sv_ntt.contiguous(), items_ntt.contiguous()
    out = torch.empty((P, 2, L, N), dtype=torch.int64, device=sv_ntt.device)
    if out.numel() == 0:
        return out
    if D == 0:
        return out.zero_()
    scan_kernel.launch_contract(kernels.UPPER, "pir_contract", items_ntt, sv_ntt, out, limbs,
                                min(D, scan_kernel.contract_chunk(limbs.moduli)))
    return out


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
    """[P, D, L, N] int64 items -> transposed (hi, lo) planes [P, L, D, N]
    of the whole chain's width: kernel F4 on the card."""
    if items_ntt.is_cuda:
        return scan_kernel.items_to_planes_cuda(items_ntt, _ct_moduli_bits(ctx))
    return scan_kernel.items_to_planes_plain(items_ntt, _ct_moduli_bits(ctx))


def _upper_level(ctx: PirContext, result, prefix: int, dim: int, contract) -> torch.Tensor:
    """One upper dimension of the decomposition-mode scan.

    result: int64[..., prefix·dim, C, 2, L, N] coefficient form (any
    leading batch axes).  Each lower ciphertext is decomposed into digit
    plaintexts; the (lower-ct, digit) columns, flattened C-order like the
    reference's ``for ct in lower_result: for pt in Encode(ct)``, form the
    newC axis.  upper_step_columns() columns at a time are lifted to L
    limbs (:func:`decompose.lift_columns`), NTT'd and handed to ``contract``
    as int64[..., prefix·k, dim, L, N] NTT-form
    items, which returns their NTT-form contraction [..., prefix·k, 2, L,
    N] over `dim`.  The contraction is linear in those columns, so the
    steps give the same words as one pass.  Returns int64[..., prefix,
    newC, 2, L, N] coefficient form.
    """
    L, n = ctx.L, ctx.n
    lead = result.shape[:-5]
    # a limb-shard view swaps in the all-gathering decomposition
    # (parallel/sharded.py): digits live per limb, but every digit
    # plaintext must reach every limb for the next contraction
    decompose_fn = getattr(ctx, "decompose_fn", None)
    if decompose_fn is None:
        new_c = result.shape[-4] * 2 * decompose.expansion_ratio(ctx)

        def lift(c0, c1):
            return decompose.lift_columns(ctx, result, prefix, dim, c0, c1)
    else:
        pts = decompose_fn(result)  # [..., prefix·dim, C, 2·ER, N]
        pts = pts.reshape(*lead, prefix, dim, -1, n)  # [..., prefix, dim, newC, N]
        new_c = pts.shape[-2]

        def lift(c0, c1):
            digits = pts[..., c0:c1, :].transpose(-3, -2)  # [..., prefix, k, dim, N]
            lifted = digits[..., None, :].expand(*digits.shape[:-1], L, n)
            return lifted.reshape(*lead, prefix * (c1 - c0), dim, L, n)
    step = upper_step_columns(prefix * dim, L, n)
    out = torch.empty((*lead, prefix, new_c, 2, L, n), dtype=torch.int64, device=result.device)
    for c0 in range(0, new_c, step):
        c1 = min(new_c, c0 + step)
        res = contract(ctx.ntt_q.forward(lift(c0, c1)))
        out[..., c0:c1, :, :, :] = ctx.ntt_q.inverse(res).reshape(*lead, prefix, c1 - c0, 2, L, n)
    return out


def database_scan_decomp(
    ctx: PirContext,
    dims: tuple,
    sv_ntt: torch.Tensor,
    db_planes=None,
    db_ntt: "torch.Tensor | None" = None,
    db_shoup: "torch.Tensor | None" = None,
    probe=None,
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
    probe:  optional callable(desc, cts) run on the coefficient-form
            ciphertexts after the inner contraction and after each upper
            level (the reference's noise-budget probe, database.cpp:260-270).
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
    with profiling.span("pir.scan.inner"):
        if db_planes is not None:
            result = contract_dim_planes(ctx, sv_last, db_planes[0], db_planes[1])
        else:
            items = db_ntt.reshape(prefix, inner, *db_ntt.shape[1:])
            shoup = db_shoup.reshape(items.shape) if db_shoup is not None else None
            result = contract_dim(ctx, sv_last, items, shoup)  # [prefix, 2, L, N]
        result = ctx.ntt_q.inverse(result)  # coefficient form
    if probe is not None:
        probe(f"dim {d - 1} (inner contraction)", result)

    # Upper dimensions, bottom-up: decompose, re-NTT, contract.
    for level in range(d - 2, -1, -1):
        dim = dims[level]
        prefix //= dim
        sv_lvl = sv_ntt[offsets[level] : offsets[level] + dim]
        # result: [prefix*dim, C, 2, L, N] (C=1 at the first upper level)
        if result.dim() == 4:
            result = result[:, None]

        def contract(items, sv_lvl=sv_lvl):  # [prefix*k, dim, L, N]
            if db_planes is not None:
                return contract_dim_planes(ctx, sv_lvl, *items_to_planes(ctx, items))
            return contract_dim(ctx, sv_lvl, items)

        with profiling.span("pir.scan.upper"):
            result = _upper_level(ctx, result, prefix, dim, contract)
        if probe is not None:
            probe(f"dim {level} (digit contraction)", result.reshape(-1, 2, ctx.L, ctx.n))

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
    with profiling.span("pir.scan.inner"):
        sv_last = sv_ntt_b[:, offsets[-1] : offsets[-1] + inner]  # [B, inner, 2, L, N]
        sv_wide = sv_last.transpose(0, 1).reshape(inner, B * 2, L, n)
        res = contract_dim_planes_wide(ctx, sv_wide, db_hi, db_lo)  # [prefix, B*2, L, N]
        result = ctx.ntt_q.inverse(res.reshape(prefix, B, 2, L, n).transpose(0, 1))

    for level in range(len(dims) - 2, -1, -1):
        dim = dims[level]
        prefix //= dim
        if result.dim() == 5:
            result = result[:, :, None]  # [B, prefix*dim, C, 2, L, N]
        sv_lvl = sv_ntt_b[:, offsets[level] : offsets[level] + dim]

        def contract(items, sv_lvl=sv_lvl):  # [B, prefix*k, dim, L, N]
            return torch.stack([contract_dim_planes(ctx, sv_lvl[b], *items_to_planes(ctx, items[b]))
                                for b in range(B)])

        with profiling.span("pir.scan.upper"):
            result = _upper_level(ctx, result, prefix, dim, contract)

    if result.dim() == 5:
        result = result[:, :, None]
    return result.reshape(B, -1, 2, L, n)


def database_scan_ctmult(
    ctx: PirContext,
    db_ntt: torch.Tensor,
    db_shoup: torch.Tensor,
    dims: tuple,
    sv: torch.Tensor,
    relin_key: "torch.Tensor | None",
) -> torch.Tensor:
    """Ciphertext-multiplication-mode scan (the reference's
    database.cpp:202-211 recursion).

    sv: int64[sum(dims), 2, L, N] selection vector in **coefficient** form —
    the upper dimensions consume it through the full BFV ct×ct multiply,
    relinearizing after each product with relin_key (int64[L, 2, Lp, N];
    None only for d = 1).  db_ntt and its Shoup companions db_shoup (which
    send the inner contraction to kernel D on the card): int64[prod(dims),
    L, N].  Each upper dimension multiplies, relinearizes and sums
    ctmult_step_rows() of its rows at a time, the steps' reduced sums added
    mod q, so every step count gives the same words.  Returns one
    int64[1, 2, L, N] reply.
    """
    offsets = []
    off = 0
    for dim in dims:
        offsets.append(off)
        off += dim

    # Innermost dimension: the same NTT-domain ct×pt contraction as
    # decomposition mode (SEAL's multiply_plain does this NTT round trip).
    inner = dims[-1]
    prefix = db_ntt.shape[0] // inner
    with profiling.span("pir.scan.inner"):
        sv_last_ntt = ctx.ntt_q.forward(sv[offsets[-1] : offsets[-1] + inner])
        items = db_ntt.reshape(prefix, inner, *db_ntt.shape[1:])
        result = ctx.ntt_q.inverse(
            contract_dim(ctx, sv_last_ntt, items, db_shoup.reshape(items.shape)))

    lq = ctx.limbs_q
    for level in range(len(dims) - 2, -1, -1):
        dim = dims[level]
        prefix //= dim
        sv_lvl = sv[offsets[level] : offsets[level] + dim]  # [dim, 2, L, N]
        blocks = result.reshape(prefix, dim, 2, ctx.L, ctx.n)

        def step(s, e, blocks=blocks, sv_lvl=sv_lvl):
            with profiling.span("pir.ctmult.multiply"):
                prod3 = bfv_multiply(ctx, blocks[:, s:e], sv_lvl[None, s:e])  # [prefix, e-s, 3, L, N]
            with profiling.span("pir.ctmult.relin"):
                prod2 = relinearize(ctx, relin_key, prod3)  # [prefix, e-s, 2, L, N]
            return modular.barrett_reduce_64(prod2.sum(dim=1), lq.q, lq.ratio_hi)

        # sum over the dimension: reduced summands, a step per u64 headroom
        # or per CTMULT_STEP_BYTES, whichever is fewer rows
        rows = min(_max_chunk(ctx), ctmult_step_rows(prefix, ctx.L, ctx.n), dim)
        with profiling.span("pir.scan.upper"):
            result = scan_kernel.sum_row_chunks(step, dim, rows, lq.q)

    return result.reshape(1, 2, ctx.L, ctx.n)
