"""PirDatabase: encode the items and hold the scan's database planes.

Port of the planes path of ``pir_tpu/pir/database.py``: populate from
byte-strings (``StringEncoder`` packing, items_per_plaintext per plaintext),
zero-pad to the hypercube, transform every plaintext to NTT form and keep it
on the device as inner-dimension-grouped [prefix, L, inner, N] (hi, lo)
planes — the only database form the scan reads.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from pir_tpu_torch.bfv import evaluator
from pir_tpu_torch.core.context import PirContext
from pir_tpu_torch.core.params import PirParams
from pir_tpu_torch.ops import scan_kernel
from pir_tpu_torch.ops.modular import tensor_u64
from pir_tpu_torch.pir.encoders import StringEncoder

_PACK_ROWS = 2048  # plaintexts per step of the vectorized packer
_NTT_PREFIXES = 16  # prefix rows per NTT/plane-split step in _finalize


def pack_items(
    buffer: bytes, num_pt: int, bytes_per_pt: int, bits_per_coeff: int, n: int
) -> np.ndarray:
    """Pack a contiguous item buffer into u64[num_pt, n], MSB-first
    (``StringEncoder.encode_many`` semantics, vectorized over plaintexts).

    Coefficient k of a plaintext holds bits [k·b, (k+1)·b) of its byte
    stream: an 8-byte big-endian window at byte k·b // 8 plus the next byte
    covers them for any b <= 64.  The trailing partial coefficient is
    left-justified and the rest are zero, as in the reference.
    """
    if not 0 < bits_per_coeff <= 62:
        raise ValueError(f"bits_per_coeff must be in [1, 62], got {bits_per_coeff}")
    if len(buffer) != num_pt * bytes_per_pt:
        raise ValueError("buffer size does not match num_pt * bytes_per_pt")
    num_coeff = -(-bytes_per_pt * 8 // bits_per_coeff)
    if num_coeff > n:
        raise ValueError(
            "number of coefficients needed greater than poly modulus degree"
        )
    data = np.frombuffer(buffer, dtype=np.uint8).reshape(num_pt, bytes_per_pt)
    start = np.arange(num_coeff, dtype=np.int64) * bits_per_coeff
    byte0 = start // 8
    off = (start % 8).astype(np.uint64)
    out = np.zeros((num_pt, n), dtype=np.uint64)
    for r0 in range(0, num_pt, _PACK_ROWS):
        r1 = min(num_pt, r0 + _PACK_ROWS)
        padded = np.zeros((r1 - r0, bytes_per_pt + 9), dtype=np.uint8)
        padded[:, :bytes_per_pt] = data[r0:r1]
        win = np.zeros((r1 - r0, num_coeff), dtype=np.uint64)
        for i in range(8):
            win = (win << np.uint64(8)) | padded[:, byte0 + i]
        nxt = padded[:, byte0 + 8].astype(np.uint64)
        bits = (win << off) | (nxt >> (np.uint64(8) - off))
        out[r0:r1, :num_coeff] = bits >> np.uint64(64 - bits_per_coeff)
    return out


class PirDatabase:
    def __init__(self, params: PirParams, device=None):
        if params.use_ciphertext_multiplication:
            raise ValueError(
                "ciphertext-multiplication mode is not ported yet "
                "(ROADMAP queue 1, ct-mult mode)"
            )
        self.params = params
        self.ctx = PirContext(params, device)
        self.device = self.ctx.device
        self.db_pts: Optional[np.ndarray] = None  # u64[num_pt, N] mod t (host)
        # (hi, lo) planes of the NTT-form hypercube, [prefix, L, inner, N]
        self.db_planes = None

    @classmethod
    def create(cls, rawdb, params: PirParams, device=None) -> "PirDatabase":
        db = cls(params, device)
        db.populate_strings(rawdb)
        return db

    @property
    def size(self) -> int:
        return self.params.num_pt

    @property
    def padded_size(self) -> int:
        total = 1
        for d in self.params.dimensions:
            total *= d
        return total

    # ------------------------------------------------------------------
    def populate_strings(self, rawdb: Sequence[bytes]) -> None:
        p = self.params
        if len(rawdb) != p.num_items:
            raise ValueError(
                f"database size {len(rawdb)} does not match params value "
                f"{p.num_items}"
            )
        enc = StringEncoder(self.ctx.n, self.ctx.t, p.bits_per_coeff)
        if all(len(item) == p.bytes_per_item for item in rawdb):
            # zero-padding the final partial plaintext's bytes yields the same
            # coefficients as the reference's shorter encode
            bytes_per_pt = p.items_per_plaintext * p.bytes_per_item
            buffer = b"".join(bytes(item) for item in rawdb)
            buffer += b"\0" * (p.num_pt * bytes_per_pt - len(buffer))
            pts = pack_items(
                buffer, p.num_pt, bytes_per_pt, enc.bits_per_coeff, self.ctx.n
            )
        else:
            pts = np.zeros((p.num_pt, self.ctx.n), dtype=np.uint64)
            for i in range(p.num_pt):
                chunk = rawdb[
                    i * p.items_per_plaintext : (i + 1) * p.items_per_plaintext
                ]
                pts[i] = enc.encode_many(chunk)
        self._finalize(pts)

    def _finalize(self, pts: np.ndarray) -> None:
        """Plaintexts u64[num_pt, N] -> NTT-form planes on the device,
        a few prefix rows at a time (the full NTT-form database is never
        held at once)."""
        ctx = self.ctx
        self.db_pts = pts
        inner = self.params.dimensions[-1]
        prefix = self.padded_size // inner
        bits = max(int(q).bit_length() for q in ctx.ct_moduli)
        shape = (prefix, ctx.L, inner, ctx.n)
        hi = None
        if bits > 32:
            hi = torch.empty(
                shape, dtype=scan_kernel.hi_plane_dtype(bits=bits), device=self.device
            )
        lo = torch.empty(shape, dtype=torch.int32, device=self.device)
        for p0 in range(0, prefix, _NTT_PREFIXES):
            p1 = min(prefix, p0 + _NTT_PREFIXES)
            rows = np.zeros(((p1 - p0) * inner, ctx.n), dtype=np.uint64)
            have = pts[p0 * inner : p1 * inner]
            rows[: have.shape[0]] = have
            ntt = evaluator.plaintext_to_ntt(ctx, tensor_u64(rows, self.device))
            grouped = ntt.reshape(p1 - p0, inner, ctx.L, ctx.n).transpose(1, 2)
            h, l = scan_kernel.split_planes(grouped, bits=bits)
            lo[p0:p1] = l
            if hi is not None:
                hi[p0:p1] = h
        self.db_planes = (hi, lo)


# index math — parity with database.cpp:318-342; the client needs it without
# a database
def calculate_indices(params: PirParams, index: int) -> list[int]:
    pt_index = index // params.items_per_plaintext
    out = []
    for d in reversed(params.dimensions):
        out.append(pt_index % d)
        pt_index //= d
    return list(reversed(out))


def calculate_item_offset(params: PirParams, index: int) -> int:
    pt_index = index // params.items_per_plaintext
    return (index - pt_index * params.items_per_plaintext) * params.bytes_per_item
