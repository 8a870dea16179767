"""The database-scan contraction over split database planes.

Port of the raw-accumulation path of ``pir_tpu/ops/pallas_scan.py``
(``split_planes``, ``max_raw_chunk``, ``contract_dim_raw``,
``contract_dim_auto``):

    out[p, s, l, n] = Σ_j sv[j, s, l, n] · db[p, l, j, n]  mod q_l

with moduli below 2^48.  The database is held as two planes of layout
[P, L, D, N]: a narrow hi plane (``torch.uint8`` for moduli of 33-40 bits,
``torch.uint16`` up to 48) and a ``torch.int32`` lo plane holding u32 bits —
5 bytes per coefficient at SEAL's 36-bit chain.

A CUDA tensor goes through kernel B (``csrc/scan.cu``, :func:`contract_cuda`);
a CPU tensor through :func:`contract_plain`, the same exact sum written
with the three-word products of :mod:`pir_tpu_torch.ops.wide32`.
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


def contract_plain(sv, db_hi, db_lo, limbs, j_begin: int = 0) -> torch.Tensor:
    """The plain PyTorch version of kernel B (same arguments as
    :func:`contract_cuda`)."""
    D = sv.shape[0]
    P, L, _, N = db_lo.shape
    out = torch.empty((P, 2, L, N), dtype=torch.int64, device=sv.device)
    for li in range(L):
        xh, xl = wide32.split_u64(sv[:, :, li, :][None])  # [1, D, 2, N]
        cols = (limbs.q[li], limbs.ratio_hi[li], limbs.ratio_lo[li])
        for p0 in range(0, P, _PLAIN_P_CHUNK):
            p1 = min(P, p0 + _PLAIN_P_CHUNK)
            hi = None if db_hi is None else db_hi[p0:p1, li, j_begin : j_begin + D]
            w = join_planes(hi, db_lo[p0:p1, li, j_begin : j_begin + D])
            wh, wl = wide32.split_u64(w[:, :, None, :])  # [Pc, D, 1, N]
            p2, p1w, p0w = wide32.mul_u48_3w(xh, xl, wh, wl)
            s2, s1, s0 = wide32.sum96_over_axis(p2, p1w, p0w, axis=1)
            out[p0:p1, :, li, :] = wide32.join_u64(
                *wide32.barrett_reduce96(s2, s1, s0, *cols)
            )
    return out


def contract_cuda(sv, db_hi, db_lo, limbs, j_begin: int = 0) -> torch.Tensor:
    """Kernel B: sv int64 [D, 2, L, N] against planes [P, L, D_total, N]
    over rows [j_begin, j_begin + D) -> reduced int64 [P, 2, L, N]."""
    D = sv.shape[0]
    P, L, d_total, N = db_lo.shape
    for name, t in (("sv", sv), ("db_lo", db_lo), ("db_hi", db_hi)):
        if t is None:
            raise ValueError(
                "kernel B needs a hi plane: moduli of at most 32 bits are the "
                "tpu32 profile, which the port does not serve yet"
            )
        if not t.is_cuda or t.device != sv.device:
            raise ValueError(f"{name} must be on {sv.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if sv.dtype != torch.int64 or db_lo.dtype != torch.int32:
        raise ValueError(f"dtypes: sv {sv.dtype} (int64), db_lo {db_lo.dtype} (int32)")
    hi_bytes = {torch.uint8: 1, torch.uint16: 2}.get(db_hi.dtype)
    if hi_bytes is None:
        raise ValueError(f"hi plane must be uint8 or uint16, got {db_hi.dtype}")
    if sv.shape != (D, 2, L, N) or db_hi.shape != db_lo.shape:
        raise ValueError(
            f"shapes: sv {tuple(sv.shape)}, planes {tuple(db_hi.shape)} / "
            f"{tuple(db_lo.shape)}"
        )
    if not (0 <= j_begin and j_begin + D <= d_total):
        raise ValueError(f"rows [{j_begin}, {j_begin + D}) outside D={d_total}")
    if D > KERNEL_MAX_D:
        raise ValueError(f"kernel B contracts at most {KERNEL_MAX_D} rows, got {D}")
    if limbs.device != sv.device or len(limbs) != L:
        raise ValueError("modulus table must match the limbs and device of sv")
    if max(limbs.moduli).bit_length() > 48:
        raise ValueError("kernel B takes moduli below 2^48")
    out = torch.empty((P, 2, L, N), dtype=torch.int64, device=sv.device)
    if out.numel() == 0:
        return out
    if D == 0:
        return out.zero_()
    kernels.SCAN.launch(
        "pir_scan",
        sv.data_ptr(), db_hi.data_ptr(), db_lo.data_ptr(), limbs.table.data_ptr(),
        out.data_ptr(), hi_bytes, P, L, d_total, j_begin, D, N,
        kernels.stream_handle(sv),
    )
    return out


def contract_dim_raw(sv, db_hi, db_lo, limbs, j_begin: int = 0) -> torch.Tensor:
    """One unreduced contraction (D <= max_raw_chunk): kernel B for CUDA
    tensors, the plain version for CPU tensors."""
    if sv.is_cuda:
        return contract_cuda(sv.contiguous(), db_hi, db_lo, limbs, j_begin)
    return contract_plain(sv, db_hi, db_lo, limbs, j_begin)


def contract_dim_auto(sv, db_hi, db_lo, limbs) -> torch.Tensor:
    """contract_dim_raw chunked by the exactness bound (max_raw_chunk); the
    chunks' reduced sums are combined with modular adds.

    sv: int64 [D, 2, L, N]; db_hi/db_lo: [P, L, D, N] planes (db_hi may be
    None for moduli of at most 32 bits).  Returns int64 [P, 2, L, N].
    """
    D = db_lo.shape[2]
    if sv.shape[0] != D:
        raise ValueError(f"selection vector has {sv.shape[0]} rows, planes {D}")
    chunk = min(max_raw_chunk(limbs.moduli), max(D, 1))
    acc = None
    for start in range(0, max(D, 1), chunk):
        end = min(start + chunk, D)
        part = contract_dim_raw(sv[start:end], db_hi, db_lo, limbs, j_begin=start)
        acc = part if acc is None else modular.add_mod(acc, part, limbs.q)
    return acc
