"""PirServer: request processing — oblivious expansion + database scan.

Port of the serving path of ``pir_tpu/pir/server.py`` (decomposition mode on
either database layout, and ciphertext-multiplication mode).  The
array-level cores are :meth:`PirServer.process_query` (one query) and
:meth:`PirServer.process_batch` (B queries sharing one pass over the
database planes): query ciphertexts and evaluation keys on the device in,
reply ciphertexts on the device out.
``process_request_async``, ``finalize_response``, ``process_request`` and
``process_request_batched`` wrap them with the wire format; replies are
byte-identical to ``pir_tpu``'s for the same request.  On the planes layout
a multi-query request whose query stacks share one shape goes through the
batched path, in chunks of :meth:`PirServer.batch_lanes` queries; on the
Shoup-table layout and in ciphertext-multiplication mode it goes query by
query (the same replies as ``pir_tpu``'s vmapped fallback).
``process_stream`` serves an iterable of requests with up to ``depth`` in
flight, each on a CUDA stream of its own (see its docstring).  ``create``
and ``oblivious_expansion`` are ``pir_tpu``'s constructor and component
surface.

Query and reply arrays cross the host link as (u32 lo, u8/u16 hi) pairs
(``packed_transfer``, ``pir_tpu``'s default; ops/packing.py) wherever every
ciphertext modulus is at most 48 bits, else as u64 words.  Requests and
replies cross the wire in the native codec or as SEAL 3.5
streams (``wire_format``; by default a reply echoes the format its
request's queries came in, so a reference client gets SEAL streams back).
A SEAL key set's seeded c1 polynomials are expanded on the host once, when
the key set enters the device key cache.

With ``mesh=`` every request is served by the multi-rank pipeline
(parallel/sharded.py): every rank of the mesh calls ``process_request``
with the same request and gets the same Response.
"""

from __future__ import annotations

import itertools
import os
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Optional

import numpy as np

import torch

from pir_tpu_torch.core.params import PirParams
from pir_tpu_torch.ops import expand, modswitch, packing, scan
from pir_tpu_torch.ops.modular import pinned, resolve_device, tensor_u64
from pir_tpu_torch.pir import seal_compat, wire
from pir_tpu_torch.pir.database import PirDatabase
from pir_tpu_torch.proto import payload_pb2 as pb
from pir_tpu_torch.utils import hostmem, profiling
from pir_tpu_torch.utils.math import generate_galois_elts

_KEY_CACHE_ENTRIES = 8
_KEY_COUNTS = ("key_hits", "key_misses", "key_evictions")
_REPLY_MARGIN_BITS = 12


def reply_limbs_for(params: PirParams) -> int:
    """Fewest leading ciphertext limbs whose bits total at least
    t_bits + 12 — the reply mod-switch target the benchmark uses
    (at SEAL's N=4096 chain and a 24-bit t: one 36-bit limb)."""
    t_bits = params.encryption_params.plain_modulus.bit_length()
    bits = 0
    limbs = 0
    for q in params.encryption_params.ct_modulus:
        bits += q.bit_length()
        limbs += 1
        if bits >= t_bits + _REPLY_MARGIN_BITS:
            break
    return limbs


class DeviceReplies(NamedTuple):
    """A request's pending replies, still on the device: pieces int64[count,
    R, 2, L', N] in query order (a query's reply, a batched chunk's real
    lanes, or a mesh batch's real queries; views, the padding lanes left
    out), and `seal_ep`: the encryption parameters the replies are
    serialized as SEAL streams with, or None for the native codec."""

    pieces: list
    seal_ep: "object | None" = None


class _CachedKeys(NamedTuple):
    """A key-cache entry: the blobs a request carried and their keys on the
    device, with the event recorded after their upload (None off a card)."""

    galois_blob: bytes
    relin_blob: bytes
    keys: dict
    relin: Optional[torch.Tensor]
    uploaded: Optional[torch.cuda.Event]


class HostReplies(NamedTuple):
    """A request's replies on their way to the host: per piece [count, R,
    2, L', N] the host tensors of its words (:func:`_host_words`; pinned on
    a CUDA server), valid once `done` (a CUDA event, None on the CPU) has
    completed.  `request`: the id its spans carry (utils/profiling.py)."""

    done: "torch.cuda.Event | None"
    replies: list
    seal_ep: "object | None" = None
    request: "int | None" = None


# Query and reply arrays cross the host link as a tuple of parts: (u32 lo,
# u8/u16 hi) with packed transfer, else (u64 words,); on the host numpy
# arrays, on the device their storage tensors (ops/packing.py).


def _host_parts(arr, hi_dtype) -> tuple:
    """A host u64 array as the parts that cross the link (always copies)."""
    if hi_dtype is None:
        return (np.array(arr, dtype=np.uint64),)
    return packing.split_host(arr, hi_dtype)


def _device_words(parts) -> torch.Tensor:
    """Parts on the device -> int64 words."""
    return parts[0] if len(parts) == 1 else packing.join_device(*parts)


def _host_words(parts) -> np.ndarray:
    """Parts on the host -> u64 words."""
    words = [packing.from_storage(t) for t in parts]
    return words[0] if len(words) == 1 else packing.join_host(*words)


def _host_upload(device, hi_dtype):
    """upload(array, key): a host u64 array -> int64 words on `device` (a
    blocking copy)."""

    def upload(arr, key):
        del key
        return _device_words([packing.to_storage(p).to(device) for p in _host_parts(arr, hi_dtype)])

    return upload


_END = object()


def _complete(pend: deque, stats: dict) -> pb.Response:
    """The oldest in-flight request's Response, once its worker and its
    device work are done (also when the worker failed, which `stats`
    counts)."""
    future, host = pend.popleft()
    try:
        with profiling.span("pir.stream.wait", host.request):
            try:
                return future.result()
            finally:
                if host.done is not None:
                    host.done.synchronize()
    except Exception:
        stats["requests_failed"] += 1
        raise


class _StreamSlot:
    """One in-flight request of :meth:`PirServer.process_stream` on a CUDA
    server: its stream, the event recorded after its reply copies, and its
    pinned host buffers (reused by the slot's next request, which starts
    only after this one was completed), one for each part that crosses the
    link."""

    def __init__(self, device: torch.device, hi_dtype=None):
        self.device = device
        self.hi_dtype = hi_dtype
        self.stream = torch.cuda.Stream(device)
        # the database and the context's tables were built on the stream
        # that was current until now: this stream waits for that work once
        self.stream.wait_stream(torch.cuda.current_stream(device))
        self.done = torch.cuda.Event()
        self._pinned: dict = {}

    def _buffer(self, key, shape, dtype=torch.int64) -> torch.Tensor:
        buf = self._pinned.get(key)
        if buf is None or tuple(buf.shape) != tuple(shape) or buf.dtype != dtype:
            buf = self._pinned[key] = pinned(shape, dtype)
        return buf

    def upload(self, arr, key) -> torch.Tensor:
        """Host u64 query array -> the card, non-blocking on this stream."""
        parts = []
        for i, part in enumerate(_host_parts(arr, self.hi_dtype)):
            buf = self._buffer(("up", key, i), part.shape, packing.storage_dtype(part.dtype))
            packing.from_storage(buf)[...] = part
            parts.append(buf.to(self.device, non_blocking=True))
        return _device_words(parts)

    def download(self, pieces, seal_ep, request=None) -> HostReplies:
        """Enqueue the copies of the reply pieces' parts (a tuple of device
        tensors each, :meth:`PirServer._packed`) to pinned memory, then the
        event the worker waits on."""
        out = [tuple(self._buffer(("down", i, k), t.shape, t.dtype).copy_(t, non_blocking=True)
                     for k, t in enumerate(parts))
               for i, parts in enumerate(pieces)]
        self.done.record(self.stream)
        return HostReplies(self.done, out, seal_ep, request)


class PirServer:
    def __init__(
        self,
        db: PirDatabase,
        params: PirParams,
        reply_limbs: Optional[int] = None,
        packed_transfer: bool = True,
        device=None,
        mesh=None,
        wire_format: str = "auto",
    ):
        """reply_limbs: if set, mod-switch reply ciphertexts down to this
        many RNS limbs before serialization (ops/modswitch.py).  The caller
        must leave enough noise budget (see :func:`reply_limbs_for`).

        packed_transfer: move query and reply arrays across the host link
        as (u32 lo, u8/u16 hi) pairs instead of u64 words (ops/packing.py),
        on every path: single, batched, streamed and mesh requests.  Above
        48-bit moduli the words move as u64 either way.  The Responses are
        the same bytes.

        wire_format: the replies' codec — "native" (PTP1), "seal" (SEAL 3.5
        Ciphertext streams, each at the chain level of its limb count), or
        "auto" (the default): the format the request's query ciphertexts
        came in.

        device: where the server computes; the database's device by
        default, and it must hold the database.

        mesh: a parallel.sharded.Mesh — serve every request through the
        multi-rank pipeline: database rows over "db", the request's queries
        over "batch", RNS limbs over "limb" (ciphertext-multiplication mode:
        "db" and "batch" only).  Every rank builds its server
        from the same database and calls it with the same requests; the
        replies equal single-device serving's bit for bit.  The server
        keeps only this rank's shard (``self.db`` is None): the whole
        database is freed when the caller drops its own reference.  A
        database that holds only this rank's block of the planes
        (``PirDatabase.set_rank_planes``, fed by
        ``parallel.distributed.planes_from_shard_rows``) is served as it
        is, so no rank ever holds the whole database."""
        if wire_format not in ("auto", "native", "seal"):
            raise ValueError(f"unknown wire format {wire_format!r}")
        if params.num_pt != db.size:
            raise ValueError("database size mismatch")
        if reply_limbs is not None and not (
            1 <= reply_limbs <= len(params.encryption_params.ct_modulus)
        ):
            raise ValueError("reply_limbs out of range for the modulus chain")
        if device is not None and resolve_device(device) != db.device:
            raise ValueError(f"database lives on {db.device}, server asked for {device}")
        if (
            mesh is not None
            and params.use_ciphertext_multiplication
            and "limb" in mesh.axis_names
        ):
            raise ValueError(
                "ciphertext-multiplication mode cannot shard the limb "
                "axis (BEHZ base extension crosses limbs); use db/batch"
            )
        self.wire_format = wire_format
        self.params = params
        self.db = db if mesh is None else None
        self.ctx = db.ctx
        self.device = db.device
        self.reply_limbs = reply_limbs
        self._hi_dtype = (
            packing.hi_dtype_for(self.ctx.ct_moduli) if packed_transfer else None
        )
        self._upload = _host_upload(self.device, self._hi_dtype)
        self._expansion_elts = tuple(generate_galois_elts(self.ctx.n))
        # Device-resident keys with the host blobs they were loaded from,
        # oldest first (clients resend identical keys with every request).
        self._key_cache: list[_CachedKeys] = []
        # the key cache's counts since the server was made (stream_stats
        # holds a stream's share)
        self._key_counts = dict.fromkeys(_KEY_COUNTS, 0)
        self._request_ids = itertools.count()  # the ids the spans carry
        self._stream_slots: list = []
        self.stream_stats: dict = {}
        self.mesh = mesh
        self._mesh_pipeline = None
        if mesh is not None:
            from pir_tpu_torch.parallel import sharded

            self._mesh_pipeline = sharded.make_sharded_pipeline(
                self.ctx, params.dimensions, db.db_ntt, mesh,
                db_shoup=db.db_ntt_shoup, reply_limbs=reply_limbs,
                use_ct_mult=params.use_ciphertext_multiplication,
                db_planes=db.db_planes if db._use_planes else None,
                local_planes=db.rank_local,
            )
        elif db.rank_local:
            raise ValueError("a database that holds one mesh rank's block needs mesh=")

    @classmethod
    def create(cls, db: PirDatabase, params: PirParams) -> "PirServer":
        return cls(db, params)

    # ------------------------------------------------------------------
    def _single_device(self) -> None:
        if self.mesh is not None:
            raise ValueError("a mesh server serves requests through process_request")

    def process_query(
        self, query_cts: torch.Tensor, galois_keys, relin_key=None
    ) -> torch.Tensor:
        """One query: int64[k, 2, L, N] ciphertexts (on the server's device),
        {galois_elt: int64[L, 2, Lp, N]} and, in ciphertext-multiplication
        mode with d > 1, the relinearization key int64[L, 2, Lp, N] ->
        reply int64[R, 2, L', N] (R = 1 in ciphertext-multiplication mode)."""
        self._single_device()
        sv = expand.expand_query(
            self.ctx, galois_keys, query_cts, self.params.dimensions_sum
        )
        reply = self.db.multiply(sv, relin_key)
        if self.reply_limbs is not None:
            reply = modswitch.mod_switch_to(self.ctx, reply, self.reply_limbs)
        return reply

    def process_batch(self, query_cts: torch.Tensor, galois_keys) -> torch.Tensor:
        """B queries at once: int64[B, k, 2, L, N] ciphertexts ->
        replies int64[B, R, 2, L', N], each equal to process_query's.  The
        expansion trees run side by side (levels double axis 1) and the
        inner scan reads the database planes once for the whole batch."""
        self._single_device()
        if not self.db._use_planes:
            raise ValueError("the batched scan reads the planes layout (scan_impl='pallas')")
        ctx = self.ctx
        sv = expand.expand_query_batch(ctx, galois_keys, query_cts, self.params.dimensions_sum)
        with profiling.span("pir.scan.inner"):  # the contraction follows in a span of its own
            sv_ntt = ctx.ntt_q.forward(sv)
        reply = scan.database_scan_decomp_batched(
            ctx, self.params.dimensions, sv_ntt, self.db.db_planes
        )
        if self.reply_limbs is not None:
            reply = modswitch.mod_switch_to(ctx, reply, self.reply_limbs)
        return reply

    def batch_lanes(self) -> int:
        """Queries per batched pass (pir_tpu's rule): per-lane transients are
        about one selection vector and expansion tree, 3·dim_sum·2·L·N·8
        bytes, within a 4 GiB budget, at most 16.  PIR_BATCH_LANES sets the
        width and PIR_BATCH_MEM_BUDGET the budget, in both packages."""
        cap = os.environ.get("PIR_BATCH_LANES")
        if cap:
            return max(1, int(cap))
        lane_bytes = 3 * self.params.dimensions_sum * 2 * self.ctx.L * self.ctx.n * 8
        budget = int(os.environ.get("PIR_BATCH_MEM_BUDGET", 4 << 30))
        return max(1, min(16, budget // max(1, lane_bytes)))

    def _batched_wide_async(
        self, stacks: list, galois_keys, upload=None, seal_ep=None
    ) -> DeviceReplies:
        """Enqueue Q host query stacks of one shape [k, 2, L, N] in chunks
        of batch_lanes() queries, the ragged tail padded with the chunk's
        first query.  upload(array, key) moves a chunk to the device."""
        upload = upload or self._upload
        lanes = min(self.batch_lanes(), len(stacks))
        pieces = []
        for start in range(0, len(stacks), lanes):
            part = stacks[start : start + lanes]
            count = len(part)
            with profiling.span("pir.query.upload"):
                queries = upload(np.stack(part + part[:1] * (lanes - count)), start)
            pieces.append(self.process_batch(queries, galois_keys)[:count])
        return DeviceReplies(pieces, seal_ep)

    # ------------------------------------------------------------------
    def _device_keys(self, request: pb.Request) -> tuple:
        """(Galois keys {elt: int64[L, 2, Lp, N]}, relinearization key
        int64[L, 2, Lp, N] or None) on the device, cached by both whole
        blobs: a request hits the entry whose blobs equal its own byte for
        byte.  Only ciphertext-multiplication mode reads the relin key, so
        only that mode uploads it.

        On a card the keys are uploaded on whichever stream first sees them
        and read on others (process_stream): the current stream waits for
        the upload's event, and each key tensor records the stream, so an
        eviction cannot free memory that a stream still reads."""
        with profiling.span("pir.keys.digest"):
            gal, rel = request.galois_keys, request.relin_keys  # each read copies
            cached = self._lookup_keys(gal, rel)
        if cached is None:
            self._key_counts["key_misses"] += 1
            cached = self._key_cache_entry(gal, rel)
        else:
            self._key_counts["key_hits"] += 1
        _, _, keys, relin, uploaded = cached
        if uploaded is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(uploaded)
            for t in [*keys.values(), *([relin] if relin is not None else [])]:
                t.record_stream(stream)
        return keys, relin

    def _lookup_keys(self, gal: bytes, rel: bytes) -> "_CachedKeys | None":
        """The entry whose blobs equal gal and rel byte for byte, or None.
        bytes == compares the lengths, then memcmp stops at the first byte
        that differs: a hit costs one pass over each blob, and another
        client's key set, whose random words differ from the start, almost
        nothing."""
        for entry in self._key_cache:
            if entry.galois_blob == gal and entry.relin_blob == rel:
                return entry
        return None

    def _key_cache_entry(self, gal: bytes, rel: bytes) -> "_CachedKeys":
        """Load a request's key blobs on the host (a SEAL key set's seeded c1
        polynomials are expanded here, once per key set), upload them, and
        cache them, the oldest entry evicted when the cache is full.  A key
        set with a blob above glibc's mmap ceiling switches the process to
        keeping large host buffers in its heap (utils/hostmem.py): each of
        its requests is parsed and read into buffers that size."""
        ep = self.params.encryption_params
        with profiling.span("pir.keys.load"):
            galois = wire.deserialize_galois_keys(gal, "cpu", ep)
            keys = {e: k.data for e, k in galois.keys.items()}
            missing = [e for e in self._expansion_elts if e not in keys]
            if missing:
                raise ValueError(f"request missing galois keys for elements {missing}")
            relin = None
            if self.params.use_ciphertext_multiplication and rel:
                relin = wire.deserialize_relin_keys(rel, "cpu", ep).key.data
            with profiling.span("pir.keys.upload"):
                keys = {e: t.to(self.device) for e, t in keys.items()}
                if relin is not None:
                    relin = relin.to(self.device)
                uploaded = None
                if self.device.type == "cuda":
                    uploaded = torch.cuda.Event()
                    uploaded.record(torch.cuda.current_stream(self.device))
            if len(self._key_cache) >= _KEY_CACHE_ENTRIES:
                self._key_cache.pop(0)
                self._key_counts["key_evictions"] += 1
            entry = _CachedKeys(gal, rel, keys, relin, uploaded)
            self._key_cache.append(entry)
        if max(len(gal), len(rel)) > hostmem.MMAP_CEILING:
            hostmem.keep_large_buffers(len(gal) + len(rel))
        return entry

    def _reply_seal_ep(self, request: pb.Request):
        """The replies' codec for this request: the encryption parameters to
        write SEAL streams with, or None for the native codec.  In "auto"
        mode SEAL iff the request's query ciphertexts are SEAL streams.  A
        SEAL request against balanced re-encode digits (d > 1, decomposition
        mode) is refused: a reference client cannot recompose them."""
        mode = self.wire_format
        if mode == "auto":
            is_seal = any(
                seal_compat.looks_like_seal_stream(q.ct[0]) for q in request.query if len(q.ct)
            )
            mode = "seal" if is_seal else "native"
        if (
            mode == "seal"
            and len(self.params.dimensions) > 1
            and not self.params.use_ciphertext_multiplication
            and self.params.reencode_mode != 0
        ):
            raise ValueError(
                "SEAL-wire request against balanced re-encode params: a "
                "reference client cannot recompose balanced-width reply "
                'digits — build the deployment with reencode_digits="legacy"'
            )
        return self.params.encryption_params if mode == "seal" else None

    def _query_stacks(self, request: pb.Request) -> list:
        return [wire.load_ciphertexts(query, self.ctx) for query in request.query]

    def _process_request_async_mesh(self, galois_keys, relin_key, stacks, upload, seal_ep):
        from pir_tpu_torch.parallel import sharded

        if not stacks:
            return DeviceReplies([], seal_ep)
        if len({s.shape for s in stacks}) != 1:
            raise ValueError(
                "mesh serving requires equal query shapes per request "
                "(always true for same-params clients)"
            )
        queries = sharded.pad_axis(np.stack(stacks), 0, self.mesh.size("batch"))
        replies = self._mesh_pipeline(upload(queries, 0), galois_keys, relin_key)
        return DeviceReplies([replies[: len(stacks)]], seal_ep)

    def process_request_async(self, request: pb.Request, upload=None) -> DeviceReplies:
        """Enqueue a request's device work and return its pending replies,
        still on the device, for :meth:`finalize_response`.
        On the planes layout a multi-query request whose query stacks share
        one shape takes the batched path (pir_tpu's reroute); its replies
        are byte-identical to the per-query path's.  With a mesh, the
        request goes through the mesh pipeline.  upload(array, key) moves a
        host query array to the device (a blocking copy by default).  The
        replies' codec (:meth:`_reply_seal_ep`) is settled, or the request
        refused, and the queries are parsed, before any device work."""
        upload = upload or self._upload
        with profiling.span("pir.query.load"):
            seal_ep = self._reply_seal_ep(request)
            stacks = self._query_stacks(request)
        galois_keys, relin_key = self._device_keys(request)
        if (
            self.params.use_ciphertext_multiplication
            and relin_key is None
            and len(self.params.dimensions) > 1
        ):
            raise ValueError(
                "ciphertext-multiplication mode with d > 1 requires "
                "relinearization keys in the request"
            )
        if self.mesh is not None:
            return self._process_request_async_mesh(
                galois_keys, relin_key, stacks, upload, seal_ep
            )
        if (
            self.db._use_planes
            and len(stacks) > 1
            and len({s.shape for s in stacks}) == 1
        ):
            return self._batched_wide_async(stacks, galois_keys, upload, seal_ep)
        pieces = []
        for qi, stack in enumerate(stacks):
            with profiling.span("pir.query.upload"):
                cts = upload(stack, qi)
            pieces.append(self.process_query(cts, galois_keys, relin_key)[None])
        return DeviceReplies(pieces, seal_ep)

    def _packed(self, x: torch.Tensor) -> tuple:
        """A reply piece's parts as they cross to the host: its packed (lo,
        hi) storage pair, or its int64 words."""
        if self._hi_dtype is None:
            return (x.contiguous(),)
        return packing.split_device(x, self._hi_dtype)

    def finalize_response(self, pending: "DeviceReplies | HostReplies") -> pb.Response:
        """Copy a request's pending replies to the host and serialize them
        into a Response, in the codec the handle carries: a
        :class:`DeviceReplies` from process_request_async, or a
        :class:`HostReplies` (whose event this waits for; no device work is
        launched)."""
        if isinstance(pending, HostReplies):
            rid, parts = pending.request, pending.replies
            if pending.done is not None:
                with profiling.span("pir.reply.wait", rid):
                    pending.done.synchronize()
        else:
            rid = None
            with profiling.span("pir.reply.wait"):  # the copies wait for the device
                parts = [[t.cpu() for t in self._packed(r)] for r in pending.pieces]
        with profiling.span("pir.reply.serialize", rid):
            response = pb.Response()
            for part in parts:
                for reply in _host_words(part):
                    wire.save_ciphertexts(reply, response.reply.add(), seal_ep=pending.seal_ep)
            return response

    def process_request(self, request: pb.Request) -> pb.Response:
        with profiling.request_scope(next(self._request_ids)):
            return self.finalize_response(self.process_request_async(request))

    # ------------------------------------------------------------------
    def process_stream(self, requests, depth: int = 6):
        """Serve an iterable of Requests with up to `depth` in flight,
        yielding their Responses in request order, each byte-equal to
        :meth:`process_request`'s.

        The caller's thread submits each request (:meth:`process_request_async`)
        and one worker thread completes it (:meth:`finalize_response`); the
        worker launches nothing, so the kernels' launch counts stay exact.
        On a card each in-flight request runs on a CUDA stream of its own
        (a pool of min(depth, requests) streams, kept by the server), its
        queries uploaded from and its replies copied to pinned host buffers
        without blocking, and the worker waits on the event recorded after
        the reply copies, not on the device.  On the CPU the same threads
        run with no streams.  ``stream_stats`` holds the run's counts:
        ``max_in_flight`` (the most requests submitted and not yet yielded),
        ``max_device_pending`` (the most whose reply copy had not yet
        completed when another was submitted), ``requests_failed`` (on
        submission or completion), the device key cache's
        ``key_hits``, ``key_misses`` and ``key_evictions`` in the run,
        ``caller_minor_faults`` (the minor page faults of the thread that
        drives the stream, from its start to its end; None where the
        platform does not count them, or the stream changed threads) and
        ``host_heap_keep_bytes`` (the heap the allocator keeps for large
        buffers, 0 while it maps them afresh; utils/hostmem.py).

        Failure: the Responses of every request before the failing one are
        yielded in order, then the error is raised, whether the request
        failed on submission (e.g. missing Galois keys) or on completion.
        Requests after it that are already in flight are waited for and
        their Responses dropped; closing the generator early waits the same
        way, so no stream work or worker thread outlives it.  (``pir_tpu``'s
        loop drops the computed Responses when a submission fails.)
        """
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        return self._stream(requests, depth)

    def _stream_slot(self, n: int, depth: int) -> "_StreamSlot | None":
        if self.device.type != "cuda":
            return None
        while len(self._stream_slots) <= min(n, depth - 1):
            self._stream_slots.append(_StreamSlot(self.device, self._hi_dtype))
        return self._stream_slots[n % depth]

    def _submit(self, request: pb.Request, slot) -> HostReplies:
        rid = next(self._request_ids)
        with profiling.request_scope(rid):
            if slot is None:
                pending = self.process_request_async(request)
                with profiling.span("pir.reply.enqueue"):
                    pieces = [self._packed(x) for x in pending.pieces]
                return HostReplies(None, pieces, pending.seal_ep, rid)
            with torch.cuda.stream(slot.stream):
                try:
                    pending = self.process_request_async(request, upload=slot.upload)
                    with profiling.span("pir.reply.enqueue"):
                        pieces = [self._packed(x) for x in pending.pieces]
                        return slot.download(pieces, pending.seal_ep, rid)
                except BaseException:
                    slot.stream.synchronize()  # nothing it enqueued outlives the error
                    raise

    def _stream(self, requests, depth: int):
        stats = self.stream_stats = {
            "depth": depth, "requests": 0, "max_in_flight": 0, "max_device_pending": 0,
            "requests_failed": 0, **dict.fromkeys(_KEY_COUNTS, 0),
            "caller_minor_faults": None, "host_heap_keep_bytes": hostmem.kept_bytes(),
        }
        keys_before = dict(self._key_counts)
        caller, faults_before = threading.get_ident(), hostmem.thread_minor_faults()
        pend: deque = deque()  # (future of the Response, HostReplies), in order
        failure = None
        with ThreadPoolExecutor(1, thread_name_prefix="pir-stream") as worker:
            try:
                it = iter(requests)
                while True:
                    try:
                        request = next(it, _END)
                        if request is _END:
                            break
                        host = self._submit(request, self._stream_slot(stats["requests"], depth))
                    except Exception as e:  # a submission failed: finish the earlier ones
                        stats["requests_failed"] += 1
                        failure = e
                        break
                    finally:
                        stats.update((k, n - keys_before[k]) for k, n in self._key_counts.items())
                    copying = 0
                    if host.done is not None:  # reply copies not yet completed
                        copying = 1 + sum(1 for _, h in pend if not h.done.query())
                    pend.append((worker.submit(self.finalize_response, host), host))
                    stats["requests"] += 1
                    stats["max_in_flight"] = max(stats["max_in_flight"], len(pend))
                    stats["max_device_pending"] = max(stats["max_device_pending"], copying)
                    while len(pend) >= depth:
                        yield _complete(pend, stats)
                while pend:
                    yield _complete(pend, stats)
                if failure is not None:
                    raise failure
            finally:
                while pend:  # after an error or an early close: wait, drop
                    try:
                        _complete(pend, stats)
                    except Exception:
                        pass
                if faults_before is not None and threading.get_ident() == caller:
                    stats["caller_minor_faults"] = hostmem.thread_minor_faults() - faults_before
                stats["host_heap_keep_bytes"] = hostmem.kept_bytes()

    def process_request_batched(self, request: pb.Request) -> pb.Response:
        """Like process_request, with every query (one included) on the
        batched path: chunks of batch_lanes() queries, one pass over the
        database planes each.  Query stacks of unequal shapes, the
        Shoup-table layout (query by query, as in pir_tpu) and a mesh (whose
        pipeline is batched over its "batch" axis) go to process_request."""
        if self.mesh is not None or not self.db._use_planes:
            return self.process_request(request)
        with profiling.request_scope(next(self._request_ids)):
            with profiling.span("pir.query.load"):
                seal_ep = self._reply_seal_ep(request)
                stacks = self._query_stacks(request)
            if len({s.shape for s in stacks}) != 1:
                return self.process_request(request)
            galois_keys, _ = self._device_keys(request)
            return self.finalize_response(
                self._batched_wide_async(stacks, galois_keys, seal_ep=seal_ep)
            )

    # ------------------------------------------------------------------
    def oblivious_expansion(self, cts, total_items: int, galois_keys) -> torch.Tensor:
        """pir_tpu's component surface: expand one ciphertext [2, L, N]
        (expand_single) or a query [k, 2, L, N] (expand_query) into
        total_items selection ciphertexts with a GaloisKeys object."""
        gk = {e: k.data.to(self.device) for e, k in galois_keys.keys.items()}
        if not isinstance(cts, torch.Tensor):
            cts = tensor_u64(cts, self.device)
        cts = cts.to(self.device)
        if cts.dim() == 3:
            return expand.expand_single(self.ctx, gk, cts, total_items)
        return expand.expand_query(self.ctx, gk, cts, total_items)
