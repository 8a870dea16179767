"""PirDatabase: encode the items and hold the scan's database operands.

Port of ``pir_tpu/pir/database.py``: populate from byte-strings
(``StringEncoder`` packing, items_per_plaintext per plaintext) or integers
(``IntegerEncoder``, one per plaintext), zero-pad to the hypercube,
transform every plaintext to NTT form and keep it on the device in one of
``pir_tpu``'s two layouts:

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

Uniform items are packed into plaintexts by the native bulk encoder
(``pir_tpu_torch/native``, built with g++ at first use), as ``pir_tpu``
packs them, except at the widths it cannot pack exactly (:func:`pack_rows`).

Persistence is ``pir_tpu``'s, file for file: :meth:`PirDatabase.save` /
:meth:`PirDatabase.load` write and read the same ``.npz`` checkpoint
(``db_pts``, the NTT form ``db_ntt`` u64 [padded, L, N], ``num_items``), and
:meth:`PirDatabase.ingest_shards` streams items into the same per-shard
``shard_NNN.npy`` plaintext files and ``meta.json``, which
:meth:`PirDatabase.load_shard_rows` (one mesh rank's rows) and
:meth:`PirDatabase.load_shards` (the whole database) read back.
"""

from __future__ import annotations

import json
import os
import pathlib
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch

from pir_tpu_torch import native
from pir_tpu_torch.bfv import evaluator
from pir_tpu_torch.core.context import PirContext
from pir_tpu_torch.core.params import PirParams
from pir_tpu_torch.ops import modular, scan, scan_kernel
from pir_tpu_torch.ops.modular import numpy_u64, tensor_u64
from pir_tpu_torch.pir.encoders import IntegerEncoder, StringEncoder
from pir_tpu_torch.utils import profiling

_PACK_ROWS = 2048  # plaintexts per step of the vectorized packer
PACK_CHUNK = 2048  # plaintexts a chunk of the database's packer, on a thread each
NTT_PREFIXES = 16  # prefix rows a step of the NTT / plane split and of its undoing
SHOUP_STEP_BYTES = 256 << 20  # NTT words a step of the companions' computation


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


def pack_rows(
    buffer: bytes, num_pt: int, bytes_per_pt: int, bits_per_coeff: int, n: int,
    out: "np.ndarray | None" = None,
) -> np.ndarray:
    """The database's packer: the native encoder, or :func:`pack_items` at
    a width the native encoder cannot pack exactly (``native.exact``).
    Both give the reference's plaintexts, in a new array or in `out`
    (u64 [num_pt, n])."""
    if native.exact(bits_per_coeff):
        return native.pack_db(buffer, num_pt, bytes_per_pt, bits_per_coeff, n, out=out)
    packed = pack_items(buffer, num_pt, bytes_per_pt, bits_per_coeff, n)
    if out is None:
        return packed
    out[...] = packed
    return out


def pack_uniform(
    rawdb: Sequence[bytes], items_per_pt: int, item_bytes: int, num_pt: int,
    bits_per_coeff: int, n: int,
) -> np.ndarray:
    """Items of `item_bytes` bytes each, `items_per_pt` a plaintext, packed
    into u64[num_pt, n] by :func:`pack_rows`, PACK_CHUNK plaintexts a chunk
    and the chunks spread over the host's cores (the native packer runs
    without the GIL): the items are never joined whole.  Zero-padding the
    final partial plaintext's bytes yields the same coefficients as the
    reference's shorter encode."""
    bytes_per_pt = items_per_pt * item_bytes
    pts = np.empty((num_pt, n), dtype=np.uint64)

    def pack(r0: int) -> None:
        r1 = min(num_pt, r0 + PACK_CHUNK)
        buffer = b"".join(rawdb[r0 * items_per_pt : r1 * items_per_pt])
        if len(buffer) < (r1 - r0) * bytes_per_pt:
            buffer += bytes((r1 - r0) * bytes_per_pt - len(buffer))
        pack_rows(buffer, r1 - r0, bytes_per_pt, bits_per_coeff, n, out=pts[r0:r1])

    chunks = range(0, num_pt, PACK_CHUNK)
    with ThreadPoolExecutor(max(1, min(len(chunks), len(os.sched_getaffinity(0))))) as ex:
        list(ex.map(pack, chunks))
    return pts


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
        self.ctx = PirContext.for_params(params, device)
        self.device = self.ctx.device
        self.db_pts: Optional[np.ndarray] = None  # u64[num_pt, N] mod t (host)
        # scan_impl "pallas": (hi, lo) planes of the NTT-form hypercube,
        # [prefix, L, inner, N]
        self.db_planes = None
        # scan_impl "xla": int64 [padded, L, N] NTT form + Shoup companions
        self.db_ntt: Optional[torch.Tensor] = None
        self.db_ntt_shoup: Optional[torch.Tensor] = None
        # db_planes hold one mesh rank's block only (set_rank_planes)
        self.rank_local = False
        # what the last build made: plaintexts, NTT steps, the layout's bytes
        # on the device and db_pts' on the host, the host encode's seconds
        self.build_stats: dict = {}
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
        """A database of byte-strings, or of integers when the first item
        is an int (``pir_tpu``'s dispatch)."""
        db = cls(params, scan_impl=scan_impl, device=device)
        if len(rawdb) and isinstance(rawdb[0], (int, np.integer)):
            db.populate_ints(rawdb)
        else:
            db.populate_strings(rawdb)
        return db

    @property
    def _use_planes(self) -> bool:
        return self.scan_impl == "pallas" and not self.params.use_ciphertext_multiplication

    def set_rank_planes(self, planes) -> None:
        """Hold only one mesh rank's block of the (hi, lo) planes
        (``parallel.distributed.planes_from_shard_rows``): a database that
        only a mesh server (``PirServer(mesh=...)``) serves."""
        if not self._use_planes:
            raise ValueError("rank planes need the planes layout (scan_impl='pallas')")
        self.db_planes = tuple(planes)
        self.rank_local = True

    def scan_operands(self) -> dict:
        """The database in its layout, as the scans take it."""
        if self._use_planes:
            return {"db_planes": self.db_planes}
        return {"db_ntt": self.db_ntt, "db_shoup": self.db_ntt_shoup}

    def multiply(
        self, selection_vector: torch.Tensor, relin_key=None, decryptor=None
    ) -> torch.Tensor:
        """Scan: selection vector ciphertexts (coefficient form, int64
        [dim_sum, 2, L, N]) -> reply ciphertexts (coefficient form).  Parity
        with pir_tpu's PirDatabase.multiply (the reference's
        PIRDatabase::multiply, database.cpp:290-316).  Ciphertext-
        multiplication mode with d > 1 needs the relinearization key.

        decryptor: optional callable(ct) -> noise-budget int, given each of
        the first two ciphertexts (coefficient form, on this database's
        device) after the inner contraction and after each upper level; the
        budgets are printed — the reference's server-side debug probe
        (database.h:127, database.cpp:260-270).  Ciphertext-multiplication
        mode ignores it, as pir_tpu does.  The returned words do not change.
        """
        p = self.params
        if selection_vector.shape[0] != p.dimensions_sum:
            raise ValueError("selection vector size does not match dimensions")
        if self.db_planes is None and self.db_ntt is None:
            raise ValueError("database not populated")
        if self.rank_local:
            raise ValueError("a mesh rank's block of the database is served by its mesh")
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
        probe = None
        if decryptor is not None:
            def probe(desc, cts):
                budgets = [decryptor(cts[i]) for i in range(min(2, cts.shape[0]))]
                print(f"noise budget after {desc}: {budgets}")

        with profiling.span("pir.scan.inner"):  # the contraction follows in a span of its own
            sv_ntt = self.ctx.ntt_q.forward(selection_vector)
        return scan.database_scan_decomp(
            self.ctx, p.dimensions, sv_ntt, **self.scan_operands(), probe=probe,
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
        t0 = time.perf_counter()
        with profiling.span("pir.db.pack"):
            if all(len(item) == p.bytes_per_item for item in rawdb):
                pts = pack_uniform(rawdb, p.items_per_plaintext, p.bytes_per_item, p.num_pt,
                                   enc.bits_per_coeff, self.ctx.n)
            else:
                pts = np.zeros((p.num_pt, self.ctx.n), dtype=np.uint64)
                for i in range(p.num_pt):
                    chunk = rawdb[
                        i * p.items_per_plaintext : (i + 1) * p.items_per_plaintext
                    ]
                    pts[i] = enc.encode_many(chunk)
        self._finalize(pts, time.perf_counter() - t0)

    def populate_ints(self, rawdb: Sequence[int]) -> None:
        """One integer a plaintext, SEAL's base-2 ``IntegerEncoder``."""
        p = self.params
        if len(rawdb) != p.num_items:
            raise ValueError(
                f"database size {len(rawdb)} does not match params value "
                f"{p.num_items}"
            )
        enc = IntegerEncoder(self.ctx.n, self.ctx.t)
        t0 = time.perf_counter()
        with profiling.span("pir.db.pack"):
            pts = np.zeros((p.num_pt, self.ctx.n), dtype=np.uint64)
            for i, v in enumerate(rawdb):
                pts[i] = enc.encode(int(v))
        self._finalize(pts, time.perf_counter() - t0)

    def _row_step(self) -> int:
        return NTT_PREFIXES * self.params.dimensions[-1]

    def _ntt_rows(self, pts: np.ndarray):
        """(row0, int64 NTT form [rows, L, N]) for the zero-padded hypercube,
        NTT_PREFIXES prefix rows at a time (the whole NTT-form database is
        never a temporary); each step's upload and transform is one
        ``pir.db.ntt`` span.  A whole step is uploaded straight from its
        rows of ``pts``: no host copy, so no fresh host pages a step."""
        ctx = self.ctx
        step = self._row_step()
        for r0 in range(0, self.padded_size, step):
            r1 = min(self.padded_size, r0 + step)
            with profiling.span("pir.db.ntt"):
                rows = have = pts[r0:r1]
                if have.shape[0] < r1 - r0:  # the hypercube's zero padding
                    rows = np.zeros((r1 - r0, ctx.n), dtype=np.uint64)
                    rows[: have.shape[0]] = have
                words = torch.from_numpy(np.ascontiguousarray(rows, np.uint64).view(np.int64))
                ntt = evaluator.plaintext_to_ntt(ctx, words.to(self.device, copy=True))
            yield r0, ntt

    def _stored_rows(self, db_ntt: np.ndarray):
        """The same steps read from a stored NTT form u64 [padded, L, N]."""
        step = self._row_step()
        for r0 in range(0, self.padded_size, step):
            yield r0, tensor_u64(db_ntt[r0 : r0 + step], self.device)

    def _finalize(self, pts: np.ndarray, pack_s: float = 0.0) -> None:
        """Plaintexts u64[num_pt, N], encoded in `pack_s` seconds -> the
        layout's NTT-form operands on the device."""
        self.db_pts = pts
        self._fill(self._ntt_rows(pts), pack_s)

    def _fill(self, ntt_steps, pack_s: float = 0.0) -> None:
        """The layout's device operands from (row0, NTT rows) steps that
        cover the padded hypercube in order, in one ``pir.db.layout`` span
        (the steps' ``pir.db.ntt`` spans inside it); then ``build_stats``."""
        ctx = self.ctx
        shape = (self.padded_size, ctx.L, ctx.n)
        with profiling.span("pir.db.layout"):
            if self._use_planes:
                self.db_planes = rows_to_planes(
                    ctx, ctx.L, self.params.dimensions[-1], self.padded_size, ntt_steps
                )
                operands = self.db_planes
            else:
                lq = ctx.limbs_q
                self.db_ntt = torch.empty(shape, dtype=torch.int64, device=self.device)
                self.db_ntt_shoup = torch.empty_like(self.db_ntt)
                # the companions' temporaries are several times their input:
                # SHOUP_STEP_BYTES of NTT words at a time
                sub = max(1, SHOUP_STEP_BYTES // (ctx.L * ctx.n * 8))
                for r0, ntt in ntt_steps:
                    self.db_ntt[r0 : r0 + ntt.shape[0]] = ntt
                    for s0 in range(0, ntt.shape[0], sub):
                        s1 = min(ntt.shape[0], s0 + sub)
                        self.db_ntt_shoup[r0 + s0 : r0 + s1] = modular.shoup_precompute_device(
                            ntt[s0:s1], lq.q, lq.ratio_hi, lq.ratio_lo
                        )
                operands = (self.db_ntt, self.db_ntt_shoup)
        self.build_stats = {
            "plaintexts": self.params.num_pt,
            "ntt_steps": len(range(0, self.padded_size, self._row_step())),
            "device_bytes": sum(t.numel() * t.element_size() for t in operands if t is not None),
            "host_bytes": self.db_pts.nbytes,
            "pack_s": pack_s,
        }

    def _host_ntt(self) -> np.ndarray:
        """The NTT form u64 [padded, L, N] on the host; the planes layout
        rejoins it a few prefixes at a time (never a second whole copy on
        the device)."""
        if not self._use_planes:
            return numpy_u64(self.db_ntt)
        ctx = self.ctx
        inner = self.params.dimensions[-1]
        hi, lo = self.db_planes
        out = np.empty((self.padded_size, ctx.L, ctx.n), dtype=np.uint64)
        for p0 in range(0, lo.shape[0], NTT_PREFIXES):
            p1 = min(lo.shape[0], p0 + NTT_PREFIXES)
            words = scan_kernel.join_planes(None if hi is None else hi[p0:p1], lo[p0:p1])
            out[p0 * inner : p1 * inner] = numpy_u64(words.transpose(1, 2)).reshape(
                -1, ctx.L, ctx.n
            )
        return out

    # ------------------------------------------------------------------
    # persistence: pir_tpu's checkpoint format, both ways
    def save(self, path) -> None:
        """Write ``db_pts``, ``db_ntt`` u64 [padded, L, N] and ``num_items``
        with ``numpy.savez_compressed`` (``pir_tpu``'s keys and dtypes)."""
        if self.db_pts is None:
            raise ValueError("database not populated")
        np.savez_compressed(
            path,
            db_pts=self.db_pts,
            db_ntt=self._host_ntt(),
            num_items=self.params.num_items,
        )

    @classmethod
    def load(
        cls, path, params: PirParams, scan_impl: str = "auto", device=None
    ) -> "PirDatabase":
        """A checkpoint written by :meth:`save` or by ``pir_tpu``'s, into
        either layout, from the stored NTT form (no NTT is run)."""
        data = np.load(path)
        if int(data["num_items"]) != params.num_items:
            raise ValueError("checkpoint does not match parameters")
        db = cls(params, scan_impl=scan_impl, device=device)
        db_ntt = data["db_ntt"]
        if db_ntt.shape != (db.padded_size, db.ctx.L, db.ctx.n):
            raise ValueError(
                f"checkpoint does not match parameters: db_ntt {db_ntt.shape}, "
                f"expected {(db.padded_size, db.ctx.L, db.ctx.n)}"
            )
        db.db_pts = data["db_pts"]
        db._fill(db._stored_rows(db_ntt))
        return db

    # ------------------------------------------------------------------
    # sharded ingest: per-shard plaintext files, pir_tpu's byte for byte
    def shard_row_ranges(self, n_shards: int) -> "list[tuple[int, int]]":
        return shard_row_ranges(self.params, n_shards)

    @classmethod
    def ingest_shards(
        cls, raw_iter, params: PirParams, out_dir, n_shards: int, chunk_pts: int = 2048
    ) -> "list[str]":
        """Stream ``params.num_items`` items of ``params.bytes_per_item``
        bytes from any iterable into one ``shard_NNN.npy`` u64 [rows, N]
        plaintext file per db shard (:func:`shard_row_ranges`) and a
        ``meta.json``, ``chunk_pts`` plaintexts at a time through
        :func:`pack_rows`: the whole database is never in memory.  Returns
        the shard paths (a shard with no rows gets no file).  The files are
        ``pir_tpu``'s byte for byte."""
        out_dir = pathlib.Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        p = params
        n = p.encryption_params.poly_modulus_degree
        bits = StringEncoder(n, p.encryption_params.plain_modulus, p.bits_per_coeff).bits_per_coeff
        ranges = shard_row_ranges(p, n_shards)
        paths, maps = [], []
        for s, (r0, r1) in enumerate(ranges):
            path = out_dir / f"shard_{s:03d}.npy"
            paths.append(str(path))
            maps.append(
                np.lib.format.open_memmap(path, mode="w+", dtype=np.uint64, shape=(r1 - r0, n))
                if r1 > r0 else None
            )
        bytes_per_pt = p.items_per_plaintext * p.bytes_per_item
        it = iter(raw_iter)
        row = taken = 0
        while row < p.num_pt:
            n_rows = min(chunk_pts, p.num_pt - row)
            want = n_rows * p.items_per_plaintext
            items = []
            while len(items) < want and taken < p.num_items:
                try:
                    item = next(it)
                except StopIteration:
                    raise ValueError(
                        f"iterator exhausted after {taken} items, params "
                        f"say {p.num_items}"
                    ) from None
                if len(item) != p.bytes_per_item:
                    raise ValueError(
                        f"item {taken} has {len(item)} bytes, expected "
                        f"{p.bytes_per_item}"
                    )
                items.append(bytes(item))
                taken += 1
            buffer = b"".join(items)
            buffer += b"\0" * (n_rows * bytes_per_pt - len(buffer))
            pts = pack_rows(buffer, n_rows, bytes_per_pt, bits, n)
            for s, (r0, r1) in enumerate(ranges):  # scatter into the shard files
                lo, hi = max(row, r0), min(row + n_rows, r1)
                if lo < hi:
                    maps[s][lo - r0 : hi - r0] = pts[lo - row : hi - row]
            row += n_rows
        for m in maps:
            if m is not None:
                m.flush()
        (out_dir / "meta.json").write_text(
            json.dumps(
                {
                    "num_items": p.num_items,
                    "num_pt": p.num_pt,
                    "n_shards": n_shards,
                    "dimensions": list(p.dimensions),
                    "row_ranges": ranges,
                }
            )
        )
        return paths

    @classmethod
    def load_shard_rows(cls, out_dir, shard: int) -> np.ndarray:
        """One shard's plaintext rows, u64 [rows, N], memory-mapped: what a
        mesh rank loads (``parallel.distributed.planes_from_shard_rows``)."""
        return np.load(pathlib.Path(out_dir) / f"shard_{shard:03d}.npy", mmap_mode="r")

    @classmethod
    def load_shards(
        cls, out_dir, params: PirParams, scan_impl: str = "auto", device=None
    ) -> "PirDatabase":
        """The whole database from its shard files (equal to a direct
        :meth:`create` of the same items)."""
        out_dir = pathlib.Path(out_dir)
        meta = json.loads((out_dir / "meta.json").read_text())
        if meta["num_items"] != params.num_items or tuple(meta["dimensions"]) != tuple(
            params.dimensions
        ):
            raise ValueError("shard checkpoint does not match parameters")
        db = cls(params, scan_impl=scan_impl, device=device)
        pts = np.zeros((params.num_pt, db.ctx.n), dtype=np.uint64)
        for s, (r0, r1) in enumerate(meta["row_ranges"]):
            if r1 > r0:
                pts[r0:r1] = cls.load_shard_rows(out_dir, s)[: r1 - r0]
        db._finalize(pts)
        return db

    # ------------------------------------------------------------------
    def calculate_indices(self, index: int) -> list[int]:
        return calculate_indices(self.params, index)

    def calculate_item_offset(self, index: int) -> int:
        return calculate_item_offset(self.params, index)


def rows_to_planes(ctx: PirContext, limbs: int, inner: int, rows: int, ntt_steps):
    """(hi, lo) planes [rows / inner, limbs, inner, N] on ctx's device of
    `rows` NTT-form rows, filled from (row0, int64 [r, limbs, N]) steps of
    whole inner groups; the chain's widest modulus sets the planes' form
    (for every limb, so a rank's limb slice has the whole database's)."""
    bits = max(int(q).bit_length() for q in ctx.ct_moduli)
    n = ctx.n
    shape = (rows // inner, limbs, inner, n)
    hi = None
    if bits > 32:
        hi = torch.empty(shape, dtype=scan_kernel.hi_plane_dtype(bits=bits), device=ctx.device)
    lo = torch.empty(shape, dtype=torch.int32, device=ctx.device)
    for r0, ntt in ntt_steps:
        p0, p1 = r0 // inner, (r0 + ntt.shape[0]) // inner
        grouped = ntt.reshape(p1 - p0, inner, limbs, n).transpose(1, 2)
        h, l = scan_kernel.split_planes(grouped, bits=bits)
        lo[p0:p1] = l
        if hi is not None:
            hi[p0:p1] = h
    return hi, lo


def shard_rows(params: PirParams, n_shards: int) -> int:
    """Plaintext rows of each of `n_shards` db shards (before the last
    ones are cut at num_pt): the first hypercube dimension zero-padded to a
    multiple of the shard count and split evenly — the split
    ``parallel.sharded`` applies on its "db" axis."""
    block = 1
    for d in params.dimensions[1:]:
        block *= d
    return -(-params.dimensions[0] // n_shards) * block


def shard_row_ranges(params: PirParams, n_shards: int) -> "list[tuple[int, int]]":
    """The plaintext rows [start, end) of each db shard, cut at num_pt:
    shard s holds exactly db rank s's rows."""
    rows = shard_rows(params, n_shards)
    return [
        (min(s * rows, params.num_pt), min((s + 1) * rows, params.num_pt))
        for s in range(n_shards)
    ]


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
