"""The database-scan contraction over split database planes.

Port of the raw-accumulation path of ``pir_tpu/ops/pallas_scan.py``
(``split_planes``, ``max_raw_chunk``, ``contract_dim_raw``,
``contract_dim_auto``, ``contract_dim_raw_wide``, ``contract_dim_wide_auto``):

    out[p, s, l, n] = Σ_j sv[j, s, l, n] · db[p, l, j, n]  mod q_l

with moduli below 2^48.  The database is held as two planes of layout
[P, L, D, N]: a narrow hi plane (``torch.uint8`` for moduli of 33-40 bits,
``torch.uint16`` up to 48) and a ``torch.int32`` lo plane holding u32 bits —
5 bytes per coefficient at SEAL's 36-bit chain.  Moduli of at most 32 bits
(the tpu32 profile) have no hi plane: ``db_hi`` is None.

A CUDA tensor goes through a kernel: B (``csrc/scan.cu``,
:func:`contract_cuda`) for the single query's S = 2 columns, C
(``csrc/scan_wide.cu``, :func:`contract_wide_cuda`) for S folded
(query, size) columns of a batch.  A CPU tensor goes through
:func:`contract_wide_plain`, the same exact sum written with the multi-word
products of :mod:`pir_tpu_torch.ops.wide32`.
"""

from __future__ import annotations

import torch

from pir_tpu_torch import kernels
from pir_tpu_torch.ops import modular, wide32
from pir_tpu_torch.ops.modular import M32

KERNEL_MAX_D = 1 << 16
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


def contract_wide_plain(sv, db_hi, db_lo, limbs, j_begin: int = 0) -> torch.Tensor:
    """The plain PyTorch version of kernels B and C (same arguments as
    :func:`contract_wide_cuda`): three-word products summed exactly with
    :mod:`wide32` — or, without a hi plane (moduli below 2^32), two-word
    products — and one 96-bit Barrett reduction per output.  Prefixes go a
    few at a time, fewer as S grows, to bound the temporaries."""
    D, S = sv.shape[0], sv.shape[1]
    P, L, _, N = db_lo.shape
    p_chunk = max(1, 2 * _PLAIN_P_CHUNK // max(S, 1))
    out = torch.empty((P, S, L, N), dtype=torch.int64, device=sv.device)
    for li in range(L):
        x = sv[:, :, li, :][None]  # [1, D, S, N]
        if db_hi is not None:
            xh, xl = wide32.split_u64(x)
        cols = (limbs.q[li], limbs.ratio_hi[li], limbs.ratio_lo[li])
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


def _kernel_operands(sv, db_hi, db_lo, limbs, j_begin: int) -> int:
    """Check what kernels B and C take; returns the hi plane's byte width
    (0 without a hi plane)."""
    D, S = sv.shape[0], sv.shape[1]
    P, L, d_total, N = db_lo.shape
    for name, t in (("sv", sv), ("db_lo", db_lo), ("db_hi", db_hi)):
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
    if limbs.device != sv.device or len(limbs) != L:
        raise ValueError("modulus table must match the limbs and device of sv")
    bits = max(limbs.moduli).bit_length()
    if db_hi is None:
        if bits > 32:
            raise ValueError(f"{bits}-bit moduli need a hi plane (lo planes hold 32 bits)")
        return 0
    if bits > 48:
        raise ValueError("the scan kernels take moduli below 2^48")
    if db_hi.shape != db_lo.shape:
        raise ValueError(f"planes differ: {tuple(db_hi.shape)} / {tuple(db_lo.shape)}")
    hi_bytes = {torch.uint8: 1, torch.uint16: 2}.get(db_hi.dtype)
    if hi_bytes is None:
        raise ValueError(f"hi plane must be uint8 or uint16, got {db_hi.dtype}")
    return hi_bytes


def _launch(kernel, fn_name, sv, db_hi, db_lo, limbs, j_begin, out) -> torch.Tensor:
    hi_bytes = _kernel_operands(sv, db_hi, db_lo, limbs, j_begin)
    D, S = sv.shape[0], sv.shape[1]
    P, L, d_total, N = db_lo.shape
    if out.numel() == 0:
        return out
    if D == 0:
        return out.zero_()
    kernel.launch(
        fn_name,
        sv.data_ptr(), 0 if db_hi is None else db_hi.data_ptr(), db_lo.data_ptr(),
        limbs.table.data_ptr(), out.data_ptr(), hi_bytes, P, S, L, d_total,
        j_begin, D, N, kernels.stream_handle(sv),
        variant="hi" if hi_bytes else "u32",
    )
    return out


def contract_cuda(sv, db_hi, db_lo, limbs, j_begin: int = 0) -> torch.Tensor:
    """Kernel B: sv int64 [D, 2, L, N] against planes [P, L, D_total, N]
    over rows [j_begin, j_begin + D) -> reduced int64 [P, 2, L, N].
    Without a hi plane (db_hi None, moduli below 2^32) it runs its
    single-word variant, which replaces K5."""
    if sv.dim() != 4 or sv.shape[1] != 2:
        raise ValueError(f"kernel B takes sv [D, 2, L, N], got {tuple(sv.shape)}")
    P, L, _, N = db_lo.shape
    out = torch.empty((P, 2, L, N), dtype=torch.int64, device=sv.device)
    return _launch(kernels.SCAN, "pir_scan", sv, db_hi, db_lo, limbs, j_begin, out)


def contract_wide_cuda(sv, db_hi, db_lo, limbs, j_begin: int = 0) -> torch.Tensor:
    """Kernel C: sv int64 [D, S, L, N] (any S >= 1) against planes
    [P, L, D_total, N] over rows [j_begin, j_begin + D) -> reduced int64
    [P, S, L, N], reading each database word once for up to 32 columns.
    db_hi None (moduli below 2^32) runs the single-word variant (K4-u32)."""
    if sv.dim() != 4 or sv.shape[1] < 1:
        raise ValueError(f"kernel C takes sv [D, S, L, N], got {tuple(sv.shape)}")
    if sv.shape[0] > max_raw_chunk(limbs.moduli):
        # kernel C's three-word sums are exact only up to this many rows
        raise ValueError(
            f"{sv.shape[0]} rows exceed the exact bound {max_raw_chunk(limbs.moduli)}"
        )
    P, L, _, N = db_lo.shape
    out = torch.empty((P, sv.shape[1], L, N), dtype=torch.int64, device=sv.device)
    return _launch(kernels.SCAN_WIDE, "pir_scan_wide", sv, db_hi, db_lo, limbs, j_begin, out)


def contract_dim_raw(sv, db_hi, db_lo, limbs, j_begin: int = 0) -> torch.Tensor:
    """One unreduced contraction (D <= max_raw_chunk): kernel B for CUDA
    tensors, the plain version for CPU tensors."""
    if sv.is_cuda:
        return contract_cuda(sv.contiguous(), db_hi, db_lo, limbs, j_begin)
    return contract_plain(sv, db_hi, db_lo, limbs, j_begin)


def contract_dim_raw_wide(sv, db_hi, db_lo, limbs, j_begin: int = 0) -> torch.Tensor:
    """The S-wide contraction (D <= max_raw_chunk): kernel C for CUDA
    tensors, the plain version for CPU tensors."""
    if sv.is_cuda:
        return contract_wide_cuda(sv.contiguous(), db_hi, db_lo, limbs, j_begin)
    return contract_wide_plain(sv, db_hi, db_lo, limbs, j_begin)


def _chunked(raw, sv, db_hi, db_lo, limbs) -> torch.Tensor:
    """raw() over row chunks of the exactness bound (max_raw_chunk), the
    chunks' reduced sums combined with modular adds."""
    D = db_lo.shape[2]
    if sv.shape[0] != D:
        raise ValueError(f"selection vector has {sv.shape[0]} rows, planes {D}")
    chunk = min(max_raw_chunk(limbs.moduli), max(D, 1))
    acc = None
    for start in range(0, max(D, 1), chunk):
        end = min(start + chunk, D)
        part = raw(sv[start:end], db_hi, db_lo, limbs, j_begin=start)
        acc = part if acc is None else modular.add_mod(acc, part, limbs.q)
    return acc


def contract_dim_auto(sv, db_hi, db_lo, limbs) -> torch.Tensor:
    """contract_dim_raw chunked by the exactness bound.

    sv: int64 [D, 2, L, N]; db_hi/db_lo: [P, L, D, N] planes (db_hi None
    for moduli of at most 32 bits).  Returns int64 [P, 2, L, N].
    """
    return _chunked(contract_dim_raw, sv, db_hi, db_lo, limbs)


def contract_dim_wide_auto(sv, db_hi, db_lo, limbs) -> torch.Tensor:
    """contract_dim_raw_wide chunked by the exactness bound (the card needs
    none of the TPU's VMEM chunking).

    sv: int64 [D, S, L, N]; db_hi/db_lo: [P, L, D, N] planes.  Returns
    int64 [P, S, L, N].
    """
    return _chunked(contract_dim_raw_wide, sv, db_hi, db_lo, limbs)
