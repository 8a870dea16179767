"""PirClient: key generation, query construction, response decoding.

Port of the client of ``pir_tpu/pir/client.py``.  It owns the
secret/public/Galois/relinearization keys, serializes the evaluation keys
once, packs per-dimension one-hot indices into ⌈dim_sum/N⌉ plaintexts with
each hot coefficient set to m⁻¹ mod t, and decodes replies: by repeated
decrypt → digit-recompose rounds in decomposition mode, by one decrypt of
the single reply ciphertext in ciphertext-multiplication mode.  It computes
on its context's device (the card by default; ``device="cpu"`` keeps it on
the host).  Keys and queries are drawn from the seeded numpy Generator in
``pir_tpu``'s order, so the same seed gives the same request bytes.  With
``wire_format="seal"`` every bytes field it emits is a SEAL 3.5 stream,
as the reference's client sends them (pir/cpp/client.cpp:50-54, 136-140).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from pir_tpu_torch.bfv import encrypt as enc_mod
from pir_tpu_torch.bfv import keys as keys_mod
from pir_tpu_torch.core.context import PirContext
from pir_tpu_torch.core.params import PirParams
from pir_tpu_torch.ops import decompose
from pir_tpu_torch.ops.modular import numpy_u64, tensor_u64
from pir_tpu_torch.pir import database, wire
from pir_tpu_torch.pir.encoders import IntegerEncoder, StringEncoder
from pir_tpu_torch.proto import payload_pb2 as pb
from pir_tpu_torch.utils.math import generate_galois_elts, invert_mod, next_power_two


class PirClient:
    def __init__(
        self,
        params: PirParams,
        seed: Optional[int] = None,
        compress_queries: bool = False,
        device=None,
        wire_format: str = "native",
    ):
        """compress_queries: serialize query ciphertexts in seeded symmetric
        form (c0 + 16-byte PRG seed, PTS1 codec) — half the upload bytes.

        device: where the client's encryption and decryption run (the card
        by default).

        wire_format: "native" (PTP1) or "seal": the query ciphertexts, the
        Galois and relinearization keys (generated with seeded a-polys, so
        they go out in SEAL's seeded form) and, through
        ``wire.pir_params_to_proto(params, "seal")``, the parameters are
        SEAL 3.5 streams.  SEAL mode sends full ciphertexts: it refuses
        compress_queries, and, for d > 1 in decomposition mode, balanced
        re-encode digits, which a reference client cannot recompose."""
        if wire_format not in ("native", "seal"):
            raise ValueError(f"unknown wire format {wire_format!r}")
        if wire_format == "seal" and compress_queries:
            raise ValueError(
                "seeded query compression is a native-codec extension; "
                "SEAL wire mode sends full ciphertexts"
            )
        if (
            wire_format == "seal"
            and len(params.dimensions) > 1
            and not params.use_ciphertext_multiplication
            and params.reencode_mode != 0
        ):
            raise ValueError(
                "SEAL wire mode requires legacy re-encode digits (the "
                "reference's CiphertextReencoder cannot decode balanced-"
                'width replies) — create params with reencode_digits="legacy"'
            )
        self.compress_queries = compress_queries
        self.params = params
        self.ctx = PirContext.for_params(params, device)
        self._rng = np.random.default_rng(seed)
        seeded_wire = wire_format == "seal"
        self.sk = keys_mod.gen_secret_key(self.ctx, self._rng)
        self.pk = keys_mod.gen_public_key(self.ctx, self.sk, self._rng)
        self.galois_keys = keys_mod.gen_galois_keys(
            self.ctx, self.sk, generate_galois_elts(self.ctx.n), self._rng,
            seeded_wire=seeded_wire,
        )
        self.relin_keys = keys_mod.gen_relin_key(
            self.ctx, self.sk, self._rng, seeded_wire=seeded_wire
        )
        self._seal_ep = params.encryption_params if seeded_wire else None
        self._galois_bytes = wire.serialize_galois_keys(
            self.galois_keys, seal_ep=self._seal_ep, n=self.ctx.n
        )
        self._relin_bytes = wire.serialize_relin_keys(self.relin_keys, seal_ep=self._seal_ep)

    @classmethod
    def create(
        cls, params: PirParams, seed: Optional[int] = None, device=None
    ) -> "PirClient":
        return cls(params, seed, device=device)

    # ------------------------------------------------------------------
    def create_request(self, indexes: Sequence[int]) -> pb.Request:
        if self.compress_queries:
            req = pb.Request()
            for i in indexes:
                c0s, seeds = self._create_query_seeded(i)
                wire.save_seeded_ciphertexts(c0s, seeds, req.query.add())
            req.galois_keys = self._galois_bytes
            req.relin_keys = self._relin_bytes
            return req
        queries = [self._create_query(i) for i in indexes]
        return wire.save_request(queries, self._galois_bytes, self._relin_bytes, self._seal_ep)

    def _query_plaintexts(self, desired_index: int) -> list[np.ndarray]:
        """One-hot query plaintexts, hot slots scaled by m⁻¹ mod t, one per
        ⌈dim_sum/N⌉ ciphertext."""
        p = self.params
        if desired_index >= p.num_items:
            raise ValueError(f"invalid index {desired_index}")
        n = self.ctx.n
        t = self.ctx.t
        dims = list(p.dimensions)
        indices = database.calculate_indices(p, desired_index)
        dim_sum = p.dimensions_sum

        num_cts = dim_sum // n + 1
        offset = 0
        pts = []
        for c in range(num_cts):
            pt = np.zeros(n, dtype=np.uint64)
            while indices:
                if indices[0] + offset >= n:
                    # this dimension's hot slot spills into the next ct
                    indices[0] -= n - offset
                    dims[0] -= n - offset
                    offset = 0
                    break
                m = n if c < num_cts - 1 else next_power_two(dim_sum % n)
                pt[indices[0] + offset] = invert_mod(m, t)
                offset += dims[0]
                indices.pop(0)
                dims.pop(0)
                if offset >= n:
                    offset -= n
                    break
            pts.append(pt)
        return pts

    def _create_query(self, desired_index: int) -> np.ndarray:
        """One query: u64[num_cts, 2, L, N]."""
        return np.stack(
            [
                numpy_u64(enc_mod.encrypt(self.ctx, self.pk, pt, self._rng))
                for pt in self._query_plaintexts(desired_index)
            ]
        )

    def _create_query_seeded(
        self, desired_index: int
    ) -> tuple[np.ndarray, list[bytes]]:
        """Seeded-symmetric query: (c0 stack u64[num_cts, L, N], seeds)."""
        c0s, seeds = [], []
        for pt in self._query_plaintexts(desired_index):
            c0, seed = enc_mod.encrypt_symmetric_seeded(
                self.ctx, self.sk, pt, self._rng
            )
            c0s.append(c0)
            seeds.append(seed)
        return np.stack(c0s), seeds

    # ------------------------------------------------------------------
    def process_response(
        self, indexes: Sequence[int], response: pb.Response
    ) -> list[bytes]:
        if len(indexes) != len(response.reply):
            raise ValueError("number of indexes must match number of replies")
        enc = StringEncoder(self.ctx.n, self.ctx.t, self.params.bits_per_coeff)
        return [
            enc.decode(
                self._process_reply(reply),
                self.params.bytes_per_item,
                database.calculate_item_offset(self.params, idx),
            )
            for idx, reply in zip(indexes, response.reply)
        ]

    def process_response_ints(self, response: pb.Response) -> list[int]:
        """Each reply decoded as an integer of an integer database
        (``IntegerEncoder.decode_int64``)."""
        enc = IntegerEncoder(self.ctx.n, self.ctx.t)
        return [enc.decode_int64(self._process_reply(r)) for r in response.reply]

    def _process_reply(self, reply: pb.Ciphertexts) -> np.ndarray:
        if self.params.use_ciphertext_multiplication:
            return self._process_reply_ct_mult(reply)
        return self._process_reply_decomp(reply)

    def _process_reply_ct_mult(self, reply: pb.Ciphertexts) -> np.ndarray:
        cts = wire.load_ciphertexts(reply, self.ctx)
        if cts.shape[0] != 1:
            raise ValueError(
                "number of ciphertexts in reply must be 1 when using CT "
                "multiplication"
            )
        return enc_mod.decrypt(self.ctx, self.sk, tensor_u64(cts[0], self.ctx.device))

    def reply_noise_budgets(self, reply: pb.Ciphertexts) -> list[int]:
        """The least invariant noise budget, in bits, of the ciphertexts
        each decryption round of a reply decrypts: in decomposition mode the
        reply's own ciphertexts, then each level recomposed from their
        digits (one entry per dimension); in ciphertext-multiplication mode
        the one reply ciphertext.  A round at 0 bits may not decrypt."""
        budgets: list = []
        if self.params.use_ciphertext_multiplication:
            cts = wire.load_ciphertexts(reply, self.ctx)
            budgets.append(self._least_budget(cts))
        else:
            self._process_reply_decomp(reply, budgets)
        return budgets

    def _least_budget(self, cts: np.ndarray) -> int:
        return min(
            enc_mod.invariant_noise_budget(self.ctx, self.sk, tensor_u64(ct, self.ctx.device))
            for ct in cts
        )

    def _process_reply_decomp(self, reply: pb.Ciphertexts, budgets=None) -> np.ndarray:
        """d rounds of decrypt → digit-recompose; each round's least noise
        budget is appended to `budgets` when it is a list."""
        exp_ratio = decompose.expansion_ratio(self.ctx) * 2
        num_dims = len(self.params.dimensions)
        expected = exp_ratio ** (num_dims - 1)
        cts = wire.load_ciphertexts(reply, self.ctx)
        if cts.shape[0] != expected:
            raise ValueError("number of ciphertexts in reply does not match expected")
        pts = None
        for _ in range(num_dims):
            if budgets is not None:
                budgets.append(self._least_budget(cts))
            pts = np.stack(
                [
                    enc_mod.decrypt(self.ctx, self.sk, tensor_u64(cts[i], self.ctx.device))
                    for i in range(cts.shape[0])
                ]
            )
            if pts.shape[0] <= 1:
                break
            cts = np.stack(
                [
                    decompose.compose_ct(
                        self.ctx, pts[i * exp_ratio : (i + 1) * exp_ratio], 2
                    )
                    for i in range(pts.shape[0] // exp_ratio)
                ]
            )
        return pts[0]
