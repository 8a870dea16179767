"""The database-scan contractions: over split database planes, and over
the Shoup-table database.

Port of ``pir_tpu/ops/pallas_scan.py``: the raw-accumulation path
(``split_planes``, ``max_raw_chunk``, ``contract_dim_raw``,
``contract_dim_auto``, ``contract_dim_raw_wide``, ``contract_dim_wide_auto``,
and the runtime-moduli ``limb_consts``, ``contract_dim_raw_dyn``,
``contract_dim_auto_dyn`` of limb-sharded meshes, K6):

    out[p, s, l, n] = Σ_j sv[j, s, l, n] · db[p, l, j, n]  mod q_l

with moduli below 2^48.  The database is held as two planes of layout
[P, L, D, N]: a narrow hi plane (``torch.uint8`` for moduli of 33-40 bits,
``torch.uint16`` up to 48) and a ``torch.int32`` lo plane holding u32 bits —
5 bytes per coefficient at SEAL's 36-bit chain.  Moduli of at most 32 bits
(the tpu32 profile) have no hi plane: ``db_hi`` is None.  An upper
level's NTT-form items become planes through :func:`items_to_planes_cuda`
(kernel F4, ``csrc/upper.cu``) on the card and
:func:`items_to_planes_plain` on the CPU.

A CUDA tensor goes through a kernel: B (``csrc/scan.cu``,
:func:`contract_cuda`) for the single query's S = 2 columns, C
(``csrc/scan_wide.cu``, :func:`contract_wide_cuda`) for S folded
(query, size) columns of a batch.  A CPU tensor goes through
:func:`contract_wide_plain`, the same exact sum written with the multi-word
products of :mod:`pir_tpu_torch.ops.wide32`.

The Shoup-table database (``scan_impl="xla"``) is contracted by
:func:`contract_dim_shoup`, the counterpart of ``contract_dim_pallas``
(K7): kernel D (``csrc/scan_shoup.cu``) on the card, the plain
:func:`contract_shoup_plain` on the CPU.

:func:`contract_plan` lays out the exact wide contraction of
``csrc/contract.cuh`` that kernels E2 (the key switch's digit inner product)
and F2 (the Shoup layout's upper-level contraction) launch through
:func:`launch_contract`.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from pir_tpu_torch import kernels
from pir_tpu_torch.ops import modular, wide32
from pir_tpu_torch.ops.modular import M32

KERNEL_MAX_D = 1 << 16
PLANES_MAX_BITS = 48  # the planes hold moduli below 2^48
_PLAIN_P_CHUNK = 8  # prefixes per step of the plain version (bounds memory)


def hi_plane_dtype(moduli=None, bits: "int | None" = None) -> torch.dtype:
    """Narrowest dtype that holds bits 32.. of values below max(q)."""
    if bits is None:
        bits = max(int(q).bit_length() for q in moduli)
    hi_bits = bits - 32
    if hi_bits <= 8:
        return torch.uint8
    if hi_bits <= 16:
        return torch.uint16
    raise ValueError(f"the raw scan takes moduli up to 48 bits, got {bits}")


def split_planes(x: torch.Tensor, moduli=None, bits: "int | None" = None):
    """u64 bit patterns -> (hi narrow, lo int32 holding u32 bits) planes.

    Moduli of at most 32 bits have no high bits at all: the hi plane is
    None.
    """
    if bits is None:
        bits = max(int(q).bit_length() for q in moduli)
    lo32 = x & M32
    lo = ((lo32 ^ 0x80000000) - 0x80000000).to(torch.int32)
    if bits <= 32:
        return None, lo
    return modular.shr(x, 32).to(hi_plane_dtype(bits=bits)), lo


def items_to_planes_plain(items: torch.Tensor, bits: int):
    """[P, D, L, N] int64 items -> (hi, lo) planes [P, L, D, N] of a
    `bits`-bit chain: the transpose, then :func:`split_planes` (the plain
    version of :func:`items_to_planes_cuda`)."""
    return split_planes(items.transpose(1, 2).contiguous(), bits=bits)


def items_to_planes_cuda(items: torch.Tensor, bits: int):
    """Kernel F4 (``csrc/upper.cu``, ``pir_split_planes``): the transpose
    and the split in one pass, each item word read once and its planes'
    words written once."""
    kernels.require_cuda(items, "items", "F")
    if items.dim() != 4:
        raise ValueError(f"items must be [P, D, L, N], got {tuple(items.shape)}")
    hi_dtype = None if bits <= 32 else hi_plane_dtype(bits=bits)
    items = items.contiguous()
    P, D, L, N = items.shape
    lo = torch.empty((P, L, D, N), dtype=torch.int32, device=items.device)
    hi = None if hi_dtype is None else torch.empty(lo.shape, dtype=hi_dtype, device=items.device)
    if lo.numel():
        kernels.UPPER.launch(
            "pir_split_planes", items.data_ptr(), lo.data_ptr(),
            0 if hi is None else hi.data_ptr(), 0 if hi is None else hi.element_size(),
            P, D, L, N, kernels.stream_handle(items))
    return hi, lo


def join_planes(db_hi, db_lo) -> torch.Tensor:
    """Planes -> int64 values (the inverse of split_planes)."""
    w = db_lo.to(torch.int64) & M32
    if db_hi is not None:
        w = w | (db_hi.to(torch.int64) << 32)
    return w


def max_raw_chunk(moduli=None, bits: "int | None" = None) -> int:
    """Longest unreduced contraction: D <= 2^(96 - 2b), and D <= 2^16."""
    b = bits if bits is not None else max(int(q).bit_length() for q in moduli)
    return max(1, min(1 << 16, 1 << max(0, 96 - 2 * b)))


def contract_wide_plain(sv, db_hi, db_lo, table, j_begin: int = 0) -> torch.Tensor:
    """The plain PyTorch version of kernels B and C (the arguments of
    :func:`contract_wide_cuda`, with the int64 [L, 3] modulus table —
    ``LimbConstants.table`` or :func:`limb_consts` — for the limbs):
    three-word products summed exactly with :mod:`wide32` — or, without a
    hi plane (moduli below 2^32), two-word products — and one 96-bit
    Barrett reduction per output.  Prefixes go a few at a time, fewer as S
    grows, to bound the temporaries."""
    D, S = sv.shape[0], sv.shape[1]
    P, L, _, N = db_lo.shape
    p_chunk = max(1, 2 * _PLAIN_P_CHUNK // max(S, 1))
    out = torch.empty((P, S, L, N), dtype=torch.int64, device=sv.device)
    for li in range(L):
        x = sv[:, :, li, :][None]  # [1, D, S, N]
        if db_hi is not None:
            xh, xl = wide32.split_u64(x)
        cols = (table[li, 0:1], table[li, 1:2], table[li, 2:3])
        for p0 in range(0, P, p_chunk):
            p1 = min(P, p0 + p_chunk)
            lo = db_lo[p0:p1, li, j_begin : j_begin + D, None, :]  # [Pc, D, 1, N]
            if db_hi is None:
                words = wide32.sum64_over_axis(
                    *wide32.mul32_wide(x, lo.to(torch.int64) & M32), axis=1
                )
            else:
                hi = db_hi[p0:p1, li, j_begin : j_begin + D, None, :]
                wh, wl = wide32.split_u64(join_planes(hi, lo))
                words = wide32.sum96_over_axis(
                    *wide32.mul_u48_3w(xh, xl, wh, wl), axis=1
                )
            out[p0:p1, :, li, :] = wide32.join_u64(
                *wide32.barrett_reduce96(*words, *cols)
            )
    return out


# Kernel B's plain version is the same sum at S = 2.
contract_plain = contract_wide_plain


def _kernel_operands(sv, db_hi, db_lo, table, bits: int, j_begin: int) -> int:
    """Check what kernels B and C take; returns the hi plane's byte width
    (0 without a hi plane).  table: int64 [L, 3] rows (q, ratio_hi,
    ratio_lo); bits: the chain's modulus width, which sets the plane form."""
    D, S = sv.shape[0], sv.shape[1]
    P, L, d_total, N = db_lo.shape
    for name, t in (("sv", sv), ("db_lo", db_lo), ("db_hi", db_hi), ("moduli", table)):
        if t is None:
            continue
        if not t.is_cuda or t.device != sv.device:
            raise ValueError(f"{name} must be on {sv.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if sv.dtype != torch.int64 or db_lo.dtype != torch.int32:
        raise ValueError(f"dtypes: sv {sv.dtype} (int64), db_lo {db_lo.dtype} (int32)")
    if sv.shape != (D, S, L, N):
        raise ValueError(f"shapes: sv {tuple(sv.shape)}, planes {tuple(db_lo.shape)}")
    if not (0 <= j_begin and j_begin + D <= d_total):
        raise ValueError(f"rows [{j_begin}, {j_begin + D}) outside D={d_total}")
    if D > KERNEL_MAX_D:
        raise ValueError(f"the scan kernels contract at most {KERNEL_MAX_D} rows, got {D}")
    if table.shape != (L, 3) or table.dtype != torch.int64:
        raise ValueError(f"modulus table must be int64 [{L}, 3], got {tuple(table.shape)}")
    if db_hi is None:
        if bits > 32:
            raise ValueError(f"{bits}-bit moduli need a hi plane (lo planes hold 32 bits)")
        return 0
    if bits > PLANES_MAX_BITS:
        raise ValueError("the scan kernels take moduli below 2^48")
    if db_hi.shape != db_lo.shape:
        raise ValueError(f"planes differ: {tuple(db_hi.shape)} / {tuple(db_lo.shape)}")
    hi_bytes = {torch.uint8: 1, torch.uint16: 2}.get(db_hi.dtype)
    if hi_bytes is None:
        raise ValueError(f"hi plane must be uint8 or uint16, got {db_hi.dtype}")
    return hi_bytes


def _launch(kernel, fn_name, sv, db_hi, db_lo, table, bits, j_begin, dyn=False, plan=None):
    """Kernel B or C over rows [j_begin, j_begin + D) -> reduced int64
    [P, S, L, N]; ``dyn`` counts the launch as a runtime-moduli (K6) one;
    ``plan(P, L, N, D)`` gives launch arguments passed before the stream."""
    hi_bytes = _kernel_operands(sv, db_hi, db_lo, table, bits, j_begin)
    D, S = sv.shape[0], sv.shape[1]
    P, L, d_total, N = db_lo.shape
    out = torch.empty((P, S, L, N), dtype=torch.int64, device=sv.device)
    if out.numel() == 0:
        return out
    if D == 0:
        return out.zero_()
    variant = "hi" if hi_bytes else "u32"
    kernel.launch(
        fn_name,
        sv.data_ptr(), 0 if db_hi is None else db_hi.data_ptr(), db_lo.data_ptr(),
        table.data_ptr(), out.data_ptr(), hi_bytes, P, S, L, d_total,
        j_begin, D, N, *(plan(P, L, N, D) if plan else ()), kernels.stream_handle(sv),
        variant=variant + ".dyn" if dyn else variant,
    )
    return out


def _limbs_bits(limbs) -> int:
    return max(limbs.moduli).bit_length()


# Kernel B's launch (csrc/scan.cu): a thread owns SCAN_VEC consecutive
# coefficients and SCAN_PREFIXES prefixes; a block's SCAN_WARPS warps split
# into prefix groups x row splits.
SCAN_VEC = 4
SCAN_PREFIXES = 2
SCAN_WARPS = 8
SCAN_FILL_WARPS = 132 * 64  # four rounds of two resident blocks on each SM of an H100


@dataclass(frozen=True)
class ScanPlan:
    """Kernel B's launch: block warps = prefix_groups x row_splits (row
    split r sums rows r, r + row_splits, ... of the chunk); the grid of
    (prefix tiles, coefficient tiles, limbs) blocks it launches."""

    prefix_groups: int
    row_splits: int
    grid: "tuple[int, int, int]"


def scan_plan(P: int, L: int, N: int, D: int) -> ScanPlan:
    """Split the rows over a block's warps (1, 2, 4 or 8 ways, never more
    than there are rows) until the grid holds SCAN_FILL_WARPS warps: the
    inner scan (5,184 warps unsplit at the bench shape) splits 2 ways, a
    small contraction (the upper scan, P = 8) 8 ways."""
    if min(P, L, N, D) < 1:
        raise ValueError(f"empty contraction P={P} L={L} N={N} D={D}")
    pairs = -(-P // SCAN_PREFIXES)
    n_tiles = -(-N // (32 * SCAN_VEC))
    splits = 1
    while splits * 2 <= min(SCAN_WARPS, D) and n_tiles * L * pairs * splits < SCAN_FILL_WARPS:
        splits *= 2
    groups = SCAN_WARPS // splits
    return ScanPlan(groups, splits, (-(-pairs // groups), n_tiles, L))


def _scan_b(sv, db_hi, db_lo, table, bits: int, j_begin: int, dyn: bool) -> torch.Tensor:
    """Kernel B with the modulus table `table` and the chain width `bits`,
    laid out by :func:`scan_plan`."""
    if sv.dim() != 4 or sv.shape[1] != 2:
        raise ValueError(f"kernel B takes sv [D, 2, L, N], got {tuple(sv.shape)}")
    if sv.shape[0] > max_raw_chunk(bits=bits):
        # kernel B's three-word sums are exact only up to this many rows
        raise ValueError(f"{sv.shape[0]} rows exceed the exact bound {max_raw_chunk(bits=bits)}")

    def plan(P, L, N, D):
        if N % SCAN_VEC:
            raise ValueError(f"kernel B takes N a multiple of {SCAN_VEC}, got {N}")
        for name, t in (("sv", sv), ("db_hi", db_hi), ("db_lo", db_lo)):
            if t is not None and t.data_ptr() % 16:
                raise ValueError(f"kernel B needs 16-byte aligned operands; {name} is not")
        p = scan_plan(P, L, N, D)
        return p.prefix_groups, p.row_splits, p.grid[0], p.grid[1]

    return _launch(kernels.SCAN, "pir_scan", sv, db_hi, db_lo, table, bits, j_begin, dyn, plan)


def contract_cuda(sv, db_hi, db_lo, limbs, j_begin: int = 0) -> torch.Tensor:
    """Kernel B: sv int64 [D, 2, L, N] against planes [P, L, D_total, N]
    over rows [j_begin, j_begin + D) -> reduced int64 [P, 2, L, N].
    Without a hi plane (db_hi None, moduli below 2^32) it runs its
    single-word variant, which replaces K5."""
    return _scan_b(sv, db_hi, db_lo, limbs.table, _limbs_bits(limbs), j_begin, False)


# Kernel C's launch (csrc/scan_wide.cu): SCAN_WIDE_WARPS warps a block, each
# thread a SCAN_WIDE_TILE x SCAN_WIDE_TILE tile of (prefix, column) sums of
# one of the block's SCAN_WIDE_COEFFS coefficients; the block stages
# SCAN_WIDE_ROWS rows of both operands a stage in a ring of
# SCAN_WIDE_STAGES stages, each thread copying at most one 16-byte piece
# of a staged row.
SCAN_WIDE_WARPS = 16
SCAN_WIDE_TILE = 4
SCAN_WIDE_COEFFS = 32
SCAN_WIDE_ROWS = 8
SCAN_WIDE_STAGES = 3
SHARED_MAX_BYTES = 232448  # a block's dynamic shared memory on the H100


@dataclass(frozen=True)
class ScanWidePlan:
    """Kernel C's launch: a block covers `prefixes` prefixes, `columns`
    selection-vector columns and `coeffs` coefficients of one limb, and
    stages `rows` rows of both operands at a time in a ring of `stages`
    stages (`shared_bytes` of dynamic shared memory); the grid of (column
    groups, prefix tiles, coefficient tiles x limbs) blocks it launches."""

    prefixes: int
    columns: int
    coeffs: int
    rows: int
    stages: int
    shared_bytes: int
    grid: "tuple[int, int, int]"


def scan_wide_plan(P: int, S: int, L: int, N: int, D: int, hi_bytes: int) -> ScanWidePlan:
    """Give the columns 4 warps (16 columns) from S = 9 on and 2 for
    S <= 8, the prefixes the other warps of 16 (16 or 32 prefixes), so a
    ragged batch's few columns still share each staged selection-vector
    word with more prefixes (64 x 4 would need more 16-byte pieces a staged
    row than the block has threads).  Stage 8 rows (fewer where D is
    smaller), halved while the ring would exceed SHARED_MAX_BYTES."""
    if min(P, S, L, N, D) < 1:
        raise ValueError(f"empty contraction P={P} S={S} L={L} N={N} D={D}")
    if hi_bytes not in (0, 1, 2):
        raise ValueError(f"hi plane of {hi_bytes} bytes")
    col_warps = 2 if S <= 8 else 4
    columns = SCAN_WIDE_TILE * col_warps
    prefixes = SCAN_WIDE_TILE * SCAN_WIDE_WARPS // col_warps
    row_bytes = SCAN_WIDE_COEFFS * (columns * 8 + prefixes * (4 + hi_bytes))
    rows = min(SCAN_WIDE_ROWS, 1 << (D - 1).bit_length())
    while SCAN_WIDE_STAGES * rows * row_bytes > SHARED_MAX_BYTES:
        rows //= 2
    grid = (-(-S // columns), -(-P // prefixes), -(-N // SCAN_WIDE_COEFFS) * L)
    return ScanWidePlan(prefixes, columns, SCAN_WIDE_COEFFS, rows, SCAN_WIDE_STAGES,
                        SCAN_WIDE_STAGES * rows * row_bytes, grid)


def contract_wide_cuda(sv, db_hi, db_lo, limbs, j_begin: int = 0) -> torch.Tensor:
    """Kernel C: sv int64 [D, S, L, N] (any S >= 1) against planes
    [P, L, D_total, N] over rows [j_begin, j_begin + D) -> reduced int64
    [P, S, L, N], laid out by :func:`scan_wide_plan`: each selection-vector
    word staged once for a block's 16 or 32 prefixes, each database word
    once for its 8 or 16 columns.  db_hi None (moduli below 2^32) runs the
    single-word variant (K4-u32)."""
    if sv.dim() != 4 or sv.shape[1] < 1:
        raise ValueError(f"kernel C takes sv [D, S, L, N], got {tuple(sv.shape)}")
    if sv.shape[0] > max_raw_chunk(limbs.moduli):
        # kernel C's three-word sums are exact only up to this many rows
        raise ValueError(
            f"{sv.shape[0]} rows exceed the exact bound {max_raw_chunk(limbs.moduli)}"
        )
    S = sv.shape[1]

    def plan(P, L, N, D):
        p = scan_wide_plan(P, S, L, N, D, 0 if db_hi is None else db_hi.element_size())
        return (p.prefixes, p.columns, p.rows, p.stages, p.shared_bytes, *p.grid)

    return _launch(kernels.SCAN_WIDE, "pir_scan_wide", sv, db_hi, db_lo, limbs.table,
                   _limbs_bits(limbs), j_begin, plan=plan)


# The exact wide contraction (csrc/contract.cuh, kernels E2 and F2):
# CONTRACT_WARPS warps a block, split between coefficients and the summed
# axis; a thread holds the w words of 2, 4 or 8 terms (CONTRACT_TERMS) and
# sums row tiles of up to CONTRACT_ROWS rows, rows x terms at most 8
# (CONTRACT_BUILT, the instances csrc/contract.cuh::run is built for; 4
# rows of 2 terms spill at the register budget); a ring of up to
# CONTRACT_STAGES steps in at most CONTRACT_RING_BYTES, so
# CONTRACT_MIN_BLOCKS blocks share an SM.  Rows, stages and the budget were
# timed against their alternatives on the H100 (PERF.md §6, the contraction's
# build): 2 rows and 2 stages were the fastest at the served shapes, and 80
# registers a thread (3 blocks) beat 128 (2) and 64 (4).
SM_COUNT = 132  # the H100's streaming multiprocessors
SHARED_SM_BYTES = 233472  # shared memory an SM holds (228 KB)
SHARED_BLOCK_RESERVE = 1024  # the part of it the card keeps for each resident block
CONTRACT_WARPS = 8
CONTRACT_TERMS = (2, 4, 8)
CONTRACT_ROWS = 2
CONTRACT_STAGES = 2
CONTRACT_MIN_BLOCKS = 3
CONTRACT_RING_BYTES = SHARED_SM_BYTES // CONTRACT_MIN_BLOCKS - SHARED_BLOCK_RESERVE
CONTRACT_BUILT = ((1, 2), (2, 2), (1, 4), (2, 4), (1, 8))


def contract_path(bits: int) -> int:
    """The contraction's word path for moduli below 2^bits: 32 (one-word
    products into 96-bit sums), 48 (three-word products into 96-bit sums)
    or 64 (128-bit sums)."""
    return 32 if bits <= 32 else 48 if bits <= 48 else 64


def contract_chunk(moduli) -> int:
    """Terms whose products the contraction sums exactly on its word path
    for these moduli: the most c with c (q - 1)^2 < 2^96 (paths 32 and 48)
    or < 2^127 (path 64) for the widest q."""
    q = max(int(m) for m in moduli)
    sums = 127 if contract_path(q.bit_length()) == 64 else 96
    return max(1, ((1 << sums) - 1) // (q - 1) ** 2)


@dataclass(frozen=True)
class ContractPlan:
    """The contraction's launch: word `path`; `rows` rows a row tile and
    `terms` terms a thread an i-block; a block of `coeff_warps` x `splits`
    warps (32 coefficients a coefficient warp, the summed axis split
    `splits` ways); a ring of `stages` steps and the split partials in
    `shared_bytes`; the grid of (limbs x coefficient tiles, row groups)
    blocks, each walking every row_groups-th row tile."""

    path: int
    rows: int
    terms: int
    coeff_warps: int
    splits: int
    stages: int
    shared_bytes: int
    grid: "tuple[int, int]"


def contract_shared_bytes(rows: int, terms: int, coeff_warps: int, splits: int,
                          stages: int) -> int:
    """The ring of `stages` steps of [rows, terms, splits, 32 x coeff_warps]
    words and, with splits > 1, the partials [splits, rows, 2, 2 words,
    32 x coeff_warps]."""
    width = 32 * coeff_warps
    return 8 * (stages * rows * terms * splits * width
                + (splits * rows * 4 * width if splits > 1 else 0))


@functools.lru_cache(maxsize=None)
def contract_plan(R: int, I: int, J: int, N: int, bits: int) -> ContractPlan:
    """Lay out x [R, I, J, N] against w [I, 2, J, N] over moduli below
    2^bits: split the summed axis over 1, 2, 4 or 8 warps until each holds
    at most 8 terms (F2's 162 rows at N=4096 take 8 warps and three
    i-blocks), a thread the w words of the fewest of 2, 4 or 8 terms that
    hold its share, give the other warps to coefficients (at most N / 32),
    take 2 rows a tile (E2), fewer where R is smaller, the kernel is not
    built for them or the ring would pass CONTRACT_RING_BYTES (1 with 8
    terms), and split the row tiles over as many row groups as
    fill the card's blocks once, while the extra reads of w stay below an
    eighth of x's bytes (none where w is large: F2, and E2 at N=32768)."""
    if min(R, I, J, N, bits) < 1:
        raise ValueError(f"empty contraction R={R} I={I} J={J} N={N} bits={bits}")
    if N % 32:
        raise ValueError(f"the contraction takes N a multiple of 32, got {N}")
    splits = 1
    while splits < CONTRACT_WARPS and splits * CONTRACT_TERMS[-1] < I:
        splits *= 2
    terms = next(t for t in CONTRACT_TERMS if t * splits >= I or t == CONTRACT_TERMS[-1])
    coeff_warps = 1
    while coeff_warps * splits < CONTRACT_WARPS and (N // 32) % (2 * coeff_warps) == 0:
        coeff_warps *= 2
    rows = CONTRACT_ROWS
    while rows > 1 and ((rows, terms) not in CONTRACT_BUILT or rows >= 2 * R or contract_shared_bytes(
            rows, terms, coeff_warps, splits, CONTRACT_STAGES) > CONTRACT_RING_BYTES):
        rows //= 2
    width = 32 * coeff_warps
    shared = contract_shared_bytes(rows, terms, coeff_warps, splits, CONTRACT_STAGES)
    tiles = J * (N // width)
    row_tiles = -(-R // rows)
    # blocks an SM holds: the registers of CONTRACT_MIN_BLOCKS full blocks, and
    # the shared memory
    resident = SM_COUNT * min(CONTRACT_MIN_BLOCKS * CONTRACT_WARPS * 32 // (width * splits),
                              SHARED_SM_BYTES // (shared + SHARED_BLOCK_RESERVE))
    x_words, w_words = R * I, I * 2
    groups = max(1, min(row_tiles, resident // tiles, 65535, 1 + x_words // (8 * w_words)))
    steps = -(-I // (splits * terms)) * -(-row_tiles // groups)
    stages = min(CONTRACT_STAGES, steps)
    return ContractPlan(contract_path(bits), rows, terms, coeff_warps, splits, stages,
                        contract_shared_bytes(rows, terms, coeff_warps, splits, stages),
                        (tiles, groups))


def launch_contract(kernel, entry: str, x, w, out, limbs, chunk: int) -> None:
    """The exact wide contraction x [R, I, J, N] (leading axes folded) against
    w [I, 2, J, N] into out [R, 2, J, N] over `limbs`' moduli, `chunk`
    terms a reduction: kernel's C entry `entry` (E2's or F2's), laid out by
    :func:`contract_plan`.  Operands contiguous int64 on one card."""
    I, J, N = w.shape[0], w.shape[2], w.shape[3]
    R = x.numel() // (I * J * N)
    p = contract_plan(R, I, J, N, _limbs_bits(limbs))
    kernel.launch(entry, x.data_ptr(), w.data_ptr(), limbs.table.data_ptr(), out.data_ptr(),
                  R, I, J, N, chunk, p.path, p.rows, p.terms, p.coeff_warps, p.splits, p.stages,
                  p.shared_bytes, *p.grid, kernels.stream_handle(x))


def contract_dim_raw(sv, db_hi, db_lo, limbs, j_begin: int = 0) -> torch.Tensor:
    """One unreduced contraction (D <= max_raw_chunk): kernel B for CUDA
    tensors, the plain version for CPU tensors."""
    if sv.is_cuda:
        return contract_cuda(sv.contiguous(), db_hi, db_lo, limbs, j_begin)
    return contract_plain(sv, db_hi, db_lo, limbs.table, j_begin)


def contract_dim_raw_wide(sv, db_hi, db_lo, limbs, j_begin: int = 0) -> torch.Tensor:
    """The S-wide contraction (D <= max_raw_chunk): kernel C for CUDA
    tensors, the plain version for CPU tensors."""
    if sv.is_cuda:
        return contract_wide_cuda(sv.contiguous(), db_hi, db_lo, limbs, j_begin)
    return contract_wide_plain(sv, db_hi, db_lo, limbs.table, j_begin)


def sum_row_chunks(part, rows: int, chunk: int, q) -> torch.Tensor:
    """part(start, end) — a reduced partial sum over rows [start, end) —
    over chunks of `chunk` rows, the parts combined with modular adds mod
    q (int64 [L, 1])."""
    acc = None
    for start in range(0, max(rows, 1), chunk):
        part_sum = part(start, min(start + chunk, rows))
        acc = part_sum if acc is None else modular.add_mod(acc, part_sum, q)
    return acc


def _chunked(raw, sv, db_lo, q, bits: int) -> torch.Tensor:
    """raw(sv rows, j_begin) over row chunks of the exactness bound of
    `bits`-bit moduli (max_raw_chunk), combined mod q."""
    D = db_lo.shape[2]
    if sv.shape[0] != D:
        raise ValueError(f"selection vector has {sv.shape[0]} rows, planes {D}")
    chunk = min(max_raw_chunk(bits=bits), max(D, 1))
    return sum_row_chunks(lambda s, e: raw(sv[s:e], s), D, chunk, q)


def contract_dim_auto(sv, db_hi, db_lo, limbs) -> torch.Tensor:
    """contract_dim_raw chunked by the exactness bound.

    sv: int64 [D, 2, L, N]; db_hi/db_lo: [P, L, D, N] planes (db_hi None
    for moduli of at most 32 bits).  Returns int64 [P, 2, L, N].
    """
    return _chunked(
        lambda x, j: contract_dim_raw(x, db_hi, db_lo, limbs, j),
        sv, db_lo, limbs.q, _limbs_bits(limbs),
    )


def contract_dim_wide_auto(sv, db_hi, db_lo, limbs) -> torch.Tensor:
    """contract_dim_raw_wide chunked by the exactness bound (the card needs
    none of the TPU's VMEM chunking).

    sv: int64 [D, S, L, N]; db_hi/db_lo: [P, L, D, N] planes.  Returns
    int64 [P, S, L, N].
    """
    return _chunked(
        lambda x, j: contract_dim_raw_wide(x, db_hi, db_lo, limbs, j),
        sv, db_lo, limbs.q, _limbs_bits(limbs),
    )


# ---------------------------------------------------------------------------
# K6: the contraction with the moduli as a runtime table (limb-sharded
# meshes, where every rank owns other moduli)
# ---------------------------------------------------------------------------


def limb_consts(q, ratio_hi, ratio_lo) -> torch.Tensor:
    """(q, ratio_hi, ratio_lo) int64 [L, 1] columns -> the int64 [L, 3]
    modulus table kernel B reads at run time (the counterpart of
    pallas_scan.limb_consts' u32 [L, 6] word table)."""
    return torch.cat([q, ratio_hi, ratio_lo], dim=1).contiguous()


def contract_dim_raw_dyn(sv, db_hi, db_lo, consts, max_bits: int, j_begin: int = 0):
    """contract_dim_raw with the moduli as the runtime table ``consts``
    (:func:`limb_consts`): kernel B for CUDA tensors, counted as the
    variants ``pir_scan.hi.dyn`` / ``pir_scan.u32.dyn``; the plain version
    for CPU tensors.

    max_bits: the whole chain's modulus width (not this rank's), which
    fixes the plane form and the exactness bound as in pallas_scan.py —
    a rank holding a 26-bit limb of a 34-bit chain still reads a hi plane.
    """
    if max_bits > PLANES_MAX_BITS:
        raise ValueError("the raw contraction takes moduli below 2^48")
    if sv.shape[0] > max_raw_chunk(bits=max_bits):
        raise ValueError(
            f"{sv.shape[0]} rows exceed the exact bound {max_raw_chunk(bits=max_bits)}"
        )
    if sv.is_cuda:
        return _scan_b(sv.contiguous(), db_hi, db_lo, consts, max_bits, j_begin, dyn=True)
    return contract_plain(sv, db_hi, db_lo, consts, j_begin)


def contract_dim_auto_dyn(sv, db_hi, db_lo, consts, q_col, max_bits: int) -> torch.Tensor:
    """contract_dim_raw_dyn chunked by the exactness bound of the whole
    chain's width; q_col int64 [L, 1] combines the chunks' reduced sums."""
    return _chunked(
        lambda x, j: contract_dim_raw_dyn(x, db_hi, db_lo, consts, max_bits, j),
        sv, db_lo, q_col, max_bits,
    )


# ---------------------------------------------------------------------------
# K7: the contraction of the Shoup-table database
# ---------------------------------------------------------------------------


def shoup_chunk(limbs) -> int:
    """Reduced products a u64 sum holds before a reduction: 2^(63 - bits)
    for the limbs' widest modulus (< 2^bits), the bound of pir_tpu's
    scan._max_chunk."""
    return max(1, 1 << (63 - _limbs_bits(limbs)))


def contract_shoup_plain(sv, db, db_shoup, limbs) -> torch.Tensor:
    """The plain PyTorch version of kernel D, pir_tpu's scan.contract_dim
    with Shoup companions: each product reduced by Shoup's method, u64
    sums of shoup_chunk(limbs) rows reduced by Barrett and combined with
    modular adds.  sv int64 [D, 2, L, N]; db, db_shoup int64 [P, D, L, N]
    -> reduced int64 [P, 2, L, N].  Prefixes go a few at a time to bound
    the temporaries."""
    P, D = db.shape[0], db.shape[1]
    chunk = min(shoup_chunk(limbs), max(D, 1))
    out = torch.empty((P, 2, *db.shape[2:]), dtype=torch.int64, device=sv.device)
    for p0 in range(0, P, _PLAIN_P_CHUNK):
        p1 = min(P, p0 + _PLAIN_P_CHUNK)

        def part(start, end):
            prod = modular.mul_mod_shoup(
                sv[None, start:end],  # [1, c, 2, L, N]
                db[p0:p1, start:end, None],  # [Pc, c, 1, L, N]
                db_shoup[p0:p1, start:end, None],
                limbs.q,
            )
            return modular.barrett_reduce_64(prod.sum(dim=1), limbs.q, limbs.ratio_hi)

        out[p0:p1] = sum_row_chunks(part, D, chunk, limbs.q)
    return out


def contract_shoup_cuda(sv, db, db_shoup, limbs) -> torch.Tensor:
    """Kernel D: the same contraction on the card, each database word and
    its companion read once."""
    D, S, L, N = sv.shape
    P = db.shape[0]
    for name, t in (("sv", sv), ("db", db), ("db_shoup", db_shoup), ("moduli", limbs.table)):
        if not t.is_cuda or t.device != sv.device:
            raise ValueError(f"{name} must be on {sv.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype != torch.int64:
            raise ValueError(f"{name} must be int64, got {t.dtype}")
    if S != 2 or db.shape != (P, D, L, N) or db_shoup.shape != db.shape:
        raise ValueError(
            f"kernel D takes sv [D, 2, L, N] and db [P, D, L, N], got "
            f"{tuple(sv.shape)}, {tuple(db.shape)}, {tuple(db_shoup.shape)}"
        )
    if len(limbs) != L:
        raise ValueError(f"modulus table has {len(limbs)} limbs, operands {L}")
    if _limbs_bits(limbs) > 61:
        raise ValueError("kernel D takes moduli below 2^61")
    out = torch.empty((P, 2, L, N), dtype=torch.int64, device=sv.device)
    if out.numel() == 0:
        return out
    if D == 0:
        return out.zero_()
    kernels.SCAN_SHOUP.launch(
        "pir_scan_shoup",
        sv.data_ptr(), db.data_ptr(), db_shoup.data_ptr(), limbs.table.data_ptr(),
        out.data_ptr(), P, D, L, N, shoup_chunk(limbs), kernels.stream_handle(sv),
    )
    return out


def contract_dim_shoup(sv, db, db_shoup, limbs) -> torch.Tensor:
    """acc[p] = Σ_j sv[j] ⊙ db[p, j] mod q over the Shoup-table database —
    the counterpart of pallas_scan.contract_dim_pallas (K7): kernel D for
    CUDA tensors, the plain version for CPU tensors."""
    if sv.is_cuda:
        return contract_shoup_cuda(sv.contiguous(), db.contiguous(), db_shoup.contiguous(), limbs)
    return contract_shoup_plain(sv, db, db_shoup, limbs)
