"""The benchmark's PIR client: keys, queries, and the judge of replies.

Frozen from ``pir_tpu_torch/pir/client.py`` (query plaintexts, request
assembly, decomposition-mode recomposition, ciphertext-multiplication
decryption) and ``pir/encoders.py`` (``StringEncoder.decode``), with
imports rewritten; queries are encrypted and replies decrypted a stack at
a time (:mod:`portbench.reference.bfv`).  It imports nothing of the
program: a Request leaves it as bytes and a Response comes back as bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import bfv, wire
from portbench.reference.arith import numpy_u64, tensor_u64
from portbench.reference.params import Params, galois_elts, next_power_two


def decode_item(pt: np.ndarray, bits: int, length: int, byte_offset: int) -> bytes:
    """`length` bytes at `byte_offset` of a plaintext's MSB-first bitstream
    of `bits` bits a coefficient."""
    start_bit = byte_offset * 8
    start_coeff = start_bit // bits
    end_coeff = -(-(start_bit + length * 8) // bits)
    if end_coeff > pt.size:
        raise ValueError("requested decode beyond end of data in polynomial")
    seg = np.asarray(pt[start_coeff:end_coeff], dtype=np.uint64)
    shifts = np.arange(bits - 1, -1, -1, dtype=np.uint64)
    flat = ((seg[:, None] >> shifts[None, :]) & np.uint64(1)).astype(np.uint8).reshape(-1)
    lo = start_bit - start_coeff * bits
    return np.packbits(flat[lo: lo + length * 8]).tobytes()


class Client:
    """One client: its secret key and evaluation keys, drawn from `rng`."""

    def __init__(self, ctx: bfv.Context, rng: np.random.Generator):
        self.ctx = ctx
        self.params: Params = ctx.params
        self.rng = rng
        self.keys = bfv.keygen(ctx, galois_elts(ctx.n), rng)
        self.galois = wire.galois_blob({e: numpy_u64(k) for e, k in self.keys.galois.items()})
        self.relin = wire.pack_array(numpy_u64(self.keys.relin))

    def query_plaintexts(self, index: int) -> list:
        """One-hot query plaintexts u64[N], hot slots at m^-1 mod t, one per
        ceil(dim_sum / N) ciphertext."""
        p = self.params
        if not 0 <= index < p.num_items:
            raise ValueError(f"invalid index {index}")
        n, t = p.n, p.t
        dims = list(p.dimensions)
        indices = p.indices(index)
        dim_sum = p.dimensions_sum
        num_cts = dim_sum // n + 1
        offset = 0
        pts = []
        for c in range(num_cts):
            pt = np.zeros(n, dtype=np.uint64)
            while indices:
                if indices[0] + offset >= n:
                    indices[0] -= n - offset
                    dims[0] -= n - offset
                    offset = 0
                    break
                m = n if c < num_cts - 1 else next_power_two(dim_sum % n)
                pt[indices[0] + offset] = pow(m, -1, t)
                offset += dims[0]
                indices.pop(0)
                dims.pop(0)
                if offset >= n:
                    offset -= n
                    break
            pts.append(pt)
        return pts

    def requests(self, index_lists) -> list:
        """Serialized Requests, one for each list of indexes (a query each),
        every query of them encrypted in one stack."""
        pts = np.stack([np.stack(self.query_plaintexts(i)) for ix in index_lists for i in ix])
        cts = bfv.encrypt(self.ctx, self.keys, pts.reshape(-1, self.params.n), self.rng)
        cts = numpy_u64(cts).reshape(*pts.shape[:2], *cts.shape[1:])  # [queries, k, 2, L, N]
        out, q0 = [], 0
        for ix in index_lists:
            out.append(wire.request_bytes(list(cts[q0: q0 + len(ix)]), self.galois, self.relin))
            q0 += len(ix)
        return out

    def expected_reply_shape(self) -> tuple:
        """(ciphertexts a reply carries, their polynomials) in this mode."""
        p = self.params
        if p.ct_mult:
            return 1, 2
        return (2 * p.expansion_ratio()) ** (len(p.dimensions) - 1), 2

    def plaintexts(self, replies: np.ndarray) -> torch.Tensor:
        """Replies u64[B, k, 2, l, N] (one shape) -> the plaintexts int64[B,
        N] they decrypt to: ct-mult mode one decryption; decomposition mode
        rounds of decrypt and recompose until one plaintext is left."""
        ctx = self.ctx
        cts = tensor_u64(replies, ctx.device)
        er2 = 2 * self.params.expansion_ratio()
        while True:
            pts = bfv.decrypt(ctx, self.keys, cts)  # [B, k, N]
            if pts.shape[1] <= 1:
                return pts[:, 0]
            b, k = pts.shape[:2]
            cts = bfv.compose(ctx, pts.reshape(b, k // er2, er2, ctx.n))

    def items(self, replies: np.ndarray, indexes) -> list:
        """The item bytes replies u64[B, k, 2, l, N] carry for `indexes`."""
        p = self.params
        pts = self.plaintexts(replies).cpu().numpy()
        return [decode_item(pts[j], p.pt_bits, p.bytes_per_item, p.item_offset(i))
                for j, i in enumerate(indexes)]
