"""Packed host<->device transfer of RNS polynomial arrays.

Port of ``pir_tpu/ops/packing.py``.  Every coefficient is below its
modulus, and at most chains that is well under 2^48, yet a u64 word moves
8 bytes a coefficient across the host link.  Split into a u32 low word and
a u8/u16 high word it moves 5 or 6.  Values are bit-identical after the
join.

The host functions (:func:`hi_dtype_for`, :func:`split_host`,
:func:`join_host`) are copies of the original's, held textually equal by
``tests/test_torch_copies.py``.  The device functions work on int64
tensors with u64 bits; torch has no shift or add on uint32 and uint16 CPU
tensors, so a low word travels as int32 storage and a u16 high word as
int16 storage (u8 as uint8), the same bits, and is masked after widening.
"""

from __future__ import annotations

import numpy as np
import torch

from pir_tpu_torch.ops.modular import M32, shr

# a word's numpy dtype -> the dtypes (numpy, torch) that store its bits
_STORAGE = {
    np.dtype(np.uint64): (np.int64, torch.int64),
    np.dtype(np.uint32): (np.int32, torch.int32),
    np.dtype(np.uint16): (np.int16, torch.int16),
    np.dtype(np.uint8): (np.uint8, torch.uint8),
}
_UNSIGNED = {t: u for u, (_, t) in _STORAGE.items()}


def hi_dtype_for(moduli) -> "np.dtype | None":
    """Smallest dtype holding bits 32.. of any value < max(moduli).

    None means some modulus exceeds 48 bits and packing is not worth it
    (callers fall back to plain u64 transfers).
    """
    bits = max(int(m).bit_length() for m in moduli)
    if bits <= 32:
        # still need a hi word of zeros to keep one code path; u8 is free
        return np.dtype(np.uint8)
    if bits <= 40:
        return np.dtype(np.uint8)
    if bits <= 48:
        return np.dtype(np.uint16)
    return None


def split_host(a: np.ndarray, hi_dtype) -> tuple[np.ndarray, np.ndarray]:
    """u64 array -> (u32 lo, hi_dtype hi) for upload."""
    a = np.ascontiguousarray(a, dtype=np.uint64)
    lo = (a & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (a >> np.uint64(32)).astype(hi_dtype)
    return lo, hi


def join_host(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """(u32 lo, any-uint hi) -> u64, after download."""
    return np.asarray(lo, dtype=np.uint64) | (
        np.asarray(hi, dtype=np.uint64) << np.uint64(32)
    )


def storage_dtype(dtype) -> torch.dtype:
    """The torch dtype that holds a word's bits (u64 -> int64, u32 ->
    int32, u16 -> int16, u8 -> uint8)."""
    return _STORAGE[np.dtype(dtype)][1]


def to_storage(a: np.ndarray) -> torch.Tensor:
    """A host u64/u32/u16/u8 array as a tensor of its storage dtype (no copy)."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(_STORAGE[a.dtype][0]))


def from_storage(t: torch.Tensor) -> np.ndarray:
    """A host storage tensor as its unsigned numpy words (no copy)."""
    return t.numpy().view(_UNSIGNED[t.dtype])


def split_device(x: torch.Tensor, hi_dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """int64 words (below 2^48) -> (lo int32 storage, hi uint8/int16
    storage) on x's device.  The low word is sign-extended from bit 31 and
    a u16 high word from bit 47, so every cast is in range."""
    lo = ((x << 32) >> 32).to(torch.int32)
    if np.dtype(hi_dtype) == np.uint8:
        return lo, shr(x, 32).to(torch.uint8)
    return lo, ((x << 16) >> 48).to(torch.int16)


def join_device(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(lo int32 storage, hi uint8/int16 storage) -> int64 words."""
    mask = 0xFF if hi.dtype == torch.uint8 else 0xFFFF
    return (lo.to(torch.int64) & M32) | ((hi.to(torch.int64) & mask) << 32)
