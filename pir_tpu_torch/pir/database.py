"""PirDatabase: encode the items and hold the scan's database operands.

Port of ``pir_tpu/pir/database.py``: populate from byte-strings
(``StringEncoder`` packing, items_per_plaintext per plaintext), zero-pad to
the hypercube, transform every plaintext to NTT form and keep it on the
device in one of ``pir_tpu``'s two layouts:

* ``scan_impl="pallas"`` — inner-dimension-grouped [prefix, L, inner, N]
  (hi, lo) planes, 5 bytes a coefficient at SEAL's chain, read by kernels B
  and C (moduli below 2^48);
* ``scan_impl="xla"`` — ``db_ntt`` and its Shoup companions
  ``db_ntt_shoup``, int64 [padded, L, N] each, 16 bytes a coefficient,
  read by kernel D (any modulus below 2^61);
* ``"auto"`` — planes while every ciphertext modulus is at most 48 bits,
  else the Shoup table.

A ciphertext-multiplication database is always held in the Shoup-table
layout, as ``pir_tpu`` holds it (its inner scan is kernel D's; its upper
dimensions multiply ciphertexts, not digit plaintexts).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from pir_tpu_torch.bfv import evaluator
from pir_tpu_torch.core.context import PirContext
from pir_tpu_torch.core.params import PirParams
from pir_tpu_torch.ops import modular, scan, scan_kernel
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


def default_scan_impl(moduli) -> str:
    """'pallas' (planes) while every modulus is below 2^48, else 'xla'
    (the Shoup table) — pir_tpu's rule without its TPU condition: the card
    runs the planes kernels."""
    if max(int(q).bit_length() for q in moduli) > scan_kernel.PLANES_MAX_BITS:
        return "xla"
    return "pallas"


class PirDatabase:
    def __init__(self, params: PirParams, scan_impl: str = "auto", device=None):
        self.params = params
        self.ctx = PirContext(params, device)
        self.device = self.ctx.device
        self.db_pts: Optional[np.ndarray] = None  # u64[num_pt, N] mod t (host)
        # scan_impl "pallas": (hi, lo) planes of the NTT-form hypercube,
        # [prefix, L, inner, N]
        self.db_planes = None
        # scan_impl "xla": int64 [padded, L, N] NTT form + Shoup companions
        self.db_ntt: Optional[torch.Tensor] = None
        self.db_ntt_shoup: Optional[torch.Tensor] = None
        if scan_impl == "auto":
            scan_impl = default_scan_impl(self.ctx.ct_moduli)
        if scan_impl not in ("pallas", "xla"):
            raise ValueError(f"unknown scan_impl {scan_impl!r}")
        self.scan_impl = scan_impl
        if self._use_planes:
            scan_kernel.hi_plane_dtype(self.ctx.ct_moduli)  # raises above 48 bits

    @classmethod
    def create(
        cls, rawdb, params: PirParams, scan_impl: str = "auto", device=None
    ) -> "PirDatabase":
        db = cls(params, scan_impl=scan_impl, device=device)
        db.populate_strings(rawdb)
        return db

    @property
    def _use_planes(self) -> bool:
        return self.scan_impl == "pallas" and not self.params.use_ciphertext_multiplication

    def scan_operands(self) -> dict:
        """The database in its layout, as the scans take it."""
        if self._use_planes:
            return {"db_planes": self.db_planes}
        return {"db_ntt": self.db_ntt, "db_shoup": self.db_ntt_shoup}

    def multiply(self, selection_vector: torch.Tensor, relin_key=None) -> torch.Tensor:
        """Scan: selection vector ciphertexts (coefficient form, int64
        [dim_sum, 2, L, N]) -> reply ciphertexts (coefficient form).  Parity
        with pir_tpu's PirDatabase.multiply (the reference's
        PIRDatabase::multiply, database.cpp:290-316).  Ciphertext-
        multiplication mode with d > 1 needs the relinearization key."""
        p = self.params
        if selection_vector.shape[0] != p.dimensions_sum:
            raise ValueError("selection vector size does not match dimensions")
        if self.db_planes is None and self.db_ntt is None:
            raise ValueError("database not populated")
        if p.use_ciphertext_multiplication:
            if relin_key is None and len(p.dimensions) > 1:
                raise ValueError(
                    "ciphertext-multiplication mode with d > 1 requires "
                    "relinearization keys"
                )
            return scan.database_scan_ctmult(
                self.ctx, self.db_ntt, self.db_ntt_shoup, p.dimensions, selection_vector,
                relin_key,
            )
        return scan.database_scan_decomp(
            self.ctx, p.dimensions, self.ctx.ntt_q.forward(selection_vector),
            **self.scan_operands(),
        )

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

    def _ntt_rows(self, pts: np.ndarray):
        """(row0, int64 NTT form [rows, L, N]) for the zero-padded hypercube,
        _NTT_PREFIXES prefix rows at a time (the whole NTT-form database is
        never a temporary)."""
        ctx = self.ctx
        step = _NTT_PREFIXES * self.params.dimensions[-1]
        for r0 in range(0, self.padded_size, step):
            r1 = min(self.padded_size, r0 + step)
            rows = np.zeros((r1 - r0, ctx.n), dtype=np.uint64)
            have = pts[r0:r1]
            rows[: have.shape[0]] = have
            yield r0, evaluator.plaintext_to_ntt(ctx, tensor_u64(rows, self.device))

    def _finalize(self, pts: np.ndarray) -> None:
        """Plaintexts u64[num_pt, N] -> the layout's NTT-form operands on
        the device."""
        ctx = self.ctx
        self.db_pts = pts
        shape = (self.padded_size, ctx.L, ctx.n)
        if not self._use_planes:
            lq = ctx.limbs_q
            self.db_ntt = torch.empty(shape, dtype=torch.int64, device=self.device)
            self.db_ntt_shoup = torch.empty_like(self.db_ntt)
            for r0, ntt in self._ntt_rows(pts):
                r1 = r0 + ntt.shape[0]
                self.db_ntt[r0:r1] = ntt
                self.db_ntt_shoup[r0:r1] = modular.shoup_precompute_device(
                    ntt, lq.q, lq.ratio_hi, lq.ratio_lo
                )
            return
        inner = self.params.dimensions[-1]
        bits = max(int(q).bit_length() for q in ctx.ct_moduli)
        shape = (self.padded_size // inner, ctx.L, inner, ctx.n)
        hi = None
        if bits > 32:
            hi = torch.empty(
                shape, dtype=scan_kernel.hi_plane_dtype(bits=bits), device=self.device
            )
        lo = torch.empty(shape, dtype=torch.int32, device=self.device)
        for r0, ntt in self._ntt_rows(pts):
            p0, p1 = r0 // inner, (r0 + ntt.shape[0]) // inner
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
