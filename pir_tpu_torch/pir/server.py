"""PirServer: request processing — oblivious expansion + database scan.

Port of the single-query serving path of ``pir_tpu/pir/server.py``
(decomposition mode, planes scan).  The array-level core is
:meth:`PirServer.process_query`: query ciphertexts and Galois keys on the
device in, reply ciphertexts on the device out.  ``process_request_async``,
``finalize_response`` and ``process_request`` wrap it with the wire format;
replies are byte-identical to ``pir_tpu``'s for the same request.  A
multi-query request runs its queries one after another.
"""

from __future__ import annotations

import hashlib
from typing import Optional

import torch

from pir_tpu_torch.core.params import PirParams
from pir_tpu_torch.ops import expand, modswitch, scan
from pir_tpu_torch.ops.modular import numpy_u64, resolve_device, tensor_u64
from pir_tpu_torch.pir import wire
from pir_tpu_torch.pir.database import PirDatabase
from pir_tpu_torch.proto import payload_pb2 as pb
from pir_tpu_torch.utils.math import generate_galois_elts

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


class PirServer:
    def __init__(
        self,
        db: PirDatabase,
        params: PirParams,
        reply_limbs: Optional[int] = None,
        device=None,
    ):
        """reply_limbs: if set, mod-switch reply ciphertexts down to this
        many RNS limbs before serialization (ops/modswitch.py).  The caller
        must leave enough noise budget (see :func:`reply_limbs_for`).

        device: where the server computes; the database's device by
        default, and it must hold the database."""
        if params.num_pt != db.size:
            raise ValueError("database size mismatch")
        if reply_limbs is not None and not (
            1 <= reply_limbs <= len(params.encryption_params.ct_modulus)
        ):
            raise ValueError("reply_limbs out of range for the modulus chain")
        if device is not None and resolve_device(device) != db.device:
            raise ValueError(f"database lives on {db.device}, server asked for {device}")
        self.params = params
        self.db = db
        self.ctx = db.ctx
        self.device = db.device
        self.reply_limbs = reply_limbs
        self._expansion_elts = tuple(generate_galois_elts(self.ctx.n))
        # Device-resident Galois keys, keyed by a digest of the whole key
        # blobs (clients resend identical keys with every request).
        self._key_cache: dict = {}

    # ------------------------------------------------------------------
    def process_query(self, query_cts: torch.Tensor, galois_keys) -> torch.Tensor:
        """One query: int64[k, 2, L, N] ciphertexts (on the server's device)
        and {galois_elt: int64[L, 2, Lp, N]} -> reply int64[R, 2, L', N]."""
        ctx = self.ctx
        sv = expand.expand_query(
            ctx, galois_keys, query_cts, self.params.dimensions_sum
        )
        sv_ntt = ctx.ntt_q.forward(sv)
        reply = scan.database_scan_decomp(
            ctx, self.params.dimensions, sv_ntt, self.db.db_planes
        )
        if self.reply_limbs is not None:
            reply = modswitch.mod_switch_to(ctx, reply, self.reply_limbs)
        return reply

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

    def process_request_async(self, request: pb.Request):
        """Enqueue a request's device work and return a pending handle
        (the replies, still on the device) for :meth:`finalize_response`."""
        galois_keys = self._device_keys(request)
        return [
            self.process_query(
                tensor_u64(wire.load_ciphertexts(query, self.ctx), self.device),
                galois_keys,
            )
            for query in request.query
        ]

    def finalize_response(self, pending) -> pb.Response:
        """Copy a process_request_async handle's replies to the host and
        serialize them into a Response."""
        response = pb.Response()
        for reply in pending:
            wire.save_ciphertexts(numpy_u64(reply), response.reply.add())
        return response

    def process_request(self, request: pb.Request) -> pb.Response:
        return self.finalize_response(self.process_request_async(request))
