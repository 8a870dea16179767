"""PirServer: request processing — oblivious expansion + database scan.

Port of the serving path of ``pir_tpu/pir/server.py`` (decomposition mode,
either database layout).  The array-level cores are
:meth:`PirServer.process_query` (one query) and :meth:`PirServer.process_batch`
(B queries sharing one pass over the database planes): query ciphertexts
and Galois keys on the device in, reply ciphertexts on the device out.
``process_request_async``, ``finalize_response``, ``process_request`` and
``process_request_batched`` wrap them with the wire format; replies are
byte-identical to ``pir_tpu``'s for the same request.  On the planes layout
a multi-query request whose query stacks share one shape goes through the
batched path, in chunks of :meth:`PirServer.batch_lanes` queries; on the
Shoup-table layout it goes query by query, as in ``pir_tpu``.

With ``mesh=`` every request is served by the multi-rank pipeline
(parallel/sharded.py): every rank of the mesh calls ``process_request``
with the same request and gets the same Response.
"""

from __future__ import annotations

import hashlib
import os
from typing import NamedTuple, Optional

import numpy as np

import torch

from pir_tpu_torch.core.params import PirParams
from pir_tpu_torch.ops import expand, modswitch, scan
from pir_tpu_torch.ops.modular import numpy_u64, resolve_device, tensor_u64
from pir_tpu_torch.pir import wire
from pir_tpu_torch.pir.database import PirDatabase
from pir_tpu_torch.proto import payload_pb2 as pb
from pir_tpu_torch.utils.math import ceil_log2, generate_galois_elts

_KEY_CACHE_ENTRIES = 8
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


class BatchedReplies(NamedTuple):
    """A batched request's pending replies: per chunk, the device replies
    int64[lanes, R, 2, L', N] and how many of its lanes are real queries
    (the ragged tail's padding lanes are dropped)."""

    chunks: list


class MeshReplies(NamedTuple):
    """A mesh request's pending replies: int64[Qp, R, 2, L', N] on the
    device, of which the first `count` are real queries (the rest pad the
    batch axis)."""

    replies: torch.Tensor
    count: int


class PirServer:
    def __init__(
        self,
        db: PirDatabase,
        params: PirParams,
        reply_limbs: Optional[int] = None,
        device=None,
        mesh=None,
    ):
        """reply_limbs: if set, mod-switch reply ciphertexts down to this
        many RNS limbs before serialization (ops/modswitch.py).  The caller
        must leave enough noise budget (see :func:`reply_limbs_for`).

        device: where the server computes; the database's device by
        default, and it must hold the database.

        mesh: a parallel.sharded.Mesh — serve every request through the
        multi-rank pipeline: database rows over "db", the request's queries
        over "batch", RNS limbs over "limb".  Every rank builds its server
        from the same database and calls it with the same requests; the
        replies equal single-device serving's bit for bit.  The server
        keeps only this rank's shard (``self.db`` is None): the whole
        database is freed when the caller drops its own reference."""
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
        self.params = params
        self.db = db if mesh is None else None
        self.ctx = db.ctx
        self.device = db.device
        self.reply_limbs = reply_limbs
        self._expansion_elts = tuple(generate_galois_elts(self.ctx.n))
        # Device-resident Galois keys, keyed by a digest of the whole key
        # blobs (clients resend identical keys with every request).
        self._key_cache: dict = {}
        self.mesh = mesh
        self._mesh_pipeline = None
        if mesh is not None:
            from pir_tpu_torch.parallel import sharded

            self._mesh_pipeline = sharded.make_sharded_pipeline(
                self.ctx, params.dimensions, db.db_ntt, mesh,
                db_shoup=db.db_ntt_shoup, reply_limbs=reply_limbs,
                db_planes=db.db_planes if db._use_planes else None,
            )

    def _db_operands(self) -> dict:
        """The database in its layout, as database_scan_decomp takes it."""
        if self.db._use_planes:
            return {"db_planes": self.db.db_planes}
        return {"db_ntt": self.db.db_ntt, "db_shoup": self.db.db_ntt_shoup}

    # ------------------------------------------------------------------
    def _single_device(self) -> None:
        if self.mesh is not None:
            raise ValueError("a mesh server serves requests through process_request")

    def process_query(self, query_cts: torch.Tensor, galois_keys) -> torch.Tensor:
        """One query: int64[k, 2, L, N] ciphertexts (on the server's device)
        and {galois_elt: int64[L, 2, Lp, N]} -> reply int64[R, 2, L', N]."""
        self._single_device()
        ctx = self.ctx
        sv = expand.expand_query(
            ctx, galois_keys, query_cts, self.params.dimensions_sum
        )
        sv_ntt = ctx.ntt_q.forward(sv)
        reply = scan.database_scan_decomp(
            ctx, self.params.dimensions, sv_ntt, **self._db_operands()
        )
        if self.reply_limbs is not None:
            reply = modswitch.mod_switch_to(ctx, reply, self.reply_limbs)
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
        n = ctx.n
        outs = []
        remaining = self.params.dimensions_sum
        for i in range(query_cts.shape[1]):
            count = min(n, remaining)
            remaining -= n
            if count == 0:
                continue
            x = query_cts[:, i][:, None]
            for j in range(ceil_log2(count)):
                x = expand.expand_level(ctx, galois_keys, x, j, axis=1)
            outs.append(x[:, :count])
        sv = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
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

    def _batched_wide_async(self, all_queries: np.ndarray, galois_keys) -> BatchedReplies:
        """Enqueue a host [Q, k, 2, L, N] query stack in chunks of
        batch_lanes() queries, the ragged tail padded with the chunk's first
        query."""
        lanes = min(self.batch_lanes(), all_queries.shape[0])
        chunks = []
        for start in range(0, all_queries.shape[0], lanes):
            chunk = all_queries[start : start + lanes]
            count = chunk.shape[0]
            if count != lanes:
                chunk = np.concatenate([chunk, chunk[:1].repeat(lanes - count, 0)])
            replies = self.process_batch(tensor_u64(chunk, self.device), galois_keys)
            chunks.append((replies, count))
        return BatchedReplies(chunks)

    # ------------------------------------------------------------------
    @staticmethod
    def _key_digest(gal: bytes, rel: bytes) -> bytes:
        """Cache key for a request's evaluation-key blobs: blake2b over the
        whole of both blobs, each prefixed by its length."""
        h = hashlib.blake2b(digest_size=16)
        for blob in (gal, rel):
            h.update(len(blob).to_bytes(8, "little"))
            h.update(blob)
        return h.digest()

    def _device_keys(self, request: pb.Request) -> dict:
        digest = self._key_digest(request.galois_keys, request.relin_keys)
        cached = self._key_cache.get(digest)
        if cached is not None:
            return cached
        galois = wire.deserialize_galois_keys(request.galois_keys, self.device)
        keys = {e: k.data for e, k in galois.keys.items()}
        missing = [e for e in self._expansion_elts if e not in keys]
        if missing:
            raise ValueError(f"request missing galois keys for elements {missing}")
        if len(self._key_cache) >= _KEY_CACHE_ENTRIES:
            self._key_cache.pop(next(iter(self._key_cache)))
        self._key_cache[digest] = keys
        return keys

    def _query_stacks(self, request: pb.Request) -> list:
        return [wire.load_ciphertexts(query, self.ctx) for query in request.query]

    def _process_request_async_mesh(self, galois_keys, stacks):
        from pir_tpu_torch.parallel import sharded

        if not stacks:
            return MeshReplies(None, 0)
        if len({s.shape for s in stacks}) != 1:
            raise ValueError(
                "mesh serving requires equal query shapes per request "
                "(always true for same-params clients)"
            )
        queries = sharded.pad_axis(np.stack(stacks), 0, self.mesh.size("batch"))
        replies = self._mesh_pipeline(tensor_u64(queries, self.device), galois_keys)
        return MeshReplies(replies, len(stacks))

    def process_request_async(self, request: pb.Request):
        """Enqueue a request's device work and return a pending handle
        (the replies, still on the device) for :meth:`finalize_response`.
        On the planes layout a multi-query request whose query stacks share
        one shape takes the batched path (pir_tpu's reroute); its replies
        are byte-identical to the per-query path's.  With a mesh, the
        request goes through the mesh pipeline."""
        galois_keys = self._device_keys(request)
        stacks = self._query_stacks(request)
        if self.mesh is not None:
            return self._process_request_async_mesh(galois_keys, stacks)
        if (
            self.db._use_planes
            and len(stacks) > 1
            and len({s.shape for s in stacks}) == 1
        ):
            return self._batched_wide_async(np.stack(stacks), galois_keys)
        return [
            self.process_query(tensor_u64(stack, self.device), galois_keys)
            for stack in stacks
        ]

    def finalize_response(self, pending) -> pb.Response:
        """Copy a process_request_async handle's replies to the host and
        serialize them into a Response.  The handle is a list of per-query
        replies, a :class:`BatchedReplies` or a :class:`MeshReplies`."""
        response = pb.Response()
        if isinstance(pending, MeshReplies):
            if pending.count:
                host = numpy_u64(pending.replies[: pending.count])
                for qi in range(pending.count):
                    wire.save_ciphertexts(host[qi], response.reply.add())
            return response
        if isinstance(pending, BatchedReplies):
            for replies, count in pending.chunks:
                host = numpy_u64(replies)
                for qi in range(count):
                    wire.save_ciphertexts(host[qi], response.reply.add())
            return response
        for reply in pending:
            wire.save_ciphertexts(numpy_u64(reply), response.reply.add())
        return response

    def process_request(self, request: pb.Request) -> pb.Response:
        return self.finalize_response(self.process_request_async(request))

    def process_request_batched(self, request: pb.Request) -> pb.Response:
        """Like process_request, with every query (one included) on the
        batched path: chunks of batch_lanes() queries, one pass over the
        database planes each.  Query stacks of unequal shapes, the
        Shoup-table layout (query by query, as in pir_tpu) and a mesh (whose
        pipeline is batched over its "batch" axis) go to process_request."""
        if self.mesh is not None or not self.db._use_planes:
            return self.process_request(request)
        galois_keys = self._device_keys(request)
        stacks = self._query_stacks(request)
        if len({s.shape for s in stacks}) != 1:
            return self.process_request(request)
        return self.finalize_response(self._batched_wide_async(np.stack(stacks), galois_keys))
