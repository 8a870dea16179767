"""Plaintext encoders: byte-string bit-packing and legacy integer encoding.

Parity with the reference's encoding layer:

* :class:`StringEncoder` — MSB-first bitstream packing of raw bytes into
  polynomial coefficients, ``bits_per_coeff`` data bits per coefficient
  (default floor(log2 t)); semantics of pir/cpp/string_encoder.cpp:58-80
  (encode) and :124-158 (offset decode).  Implemented vectorized over numpy
  bit arrays rather than per-bit loops — DB ingestion packs millions of
  items.
* :class:`IntegerEncoder` — SEAL 3.5's legacy base-2 signed integer
  encoder, needed for the integer-database test path
  (pir/cpp/context.cpp:33, database.cpp:72, client.cpp:153).
"""

from __future__ import annotations

import numpy as np

from pir_tpu_torch.utils.math import floor_log2


class StringEncoder:
    def __init__(self, poly_modulus_degree: int, plain_modulus: int,
                 bits_per_coeff: int = 0):
        self.n = poly_modulus_degree
        self.t = plain_modulus
        self.bits_per_coeff = (
            bits_per_coeff if bits_per_coeff > 0 else floor_log2(plain_modulus)
        )
        if self.bits_per_coeff > floor_log2(plain_modulus):
            raise ValueError("bits per coefficient greater than max")

    # capacity math — parity with string_encoder.cpp:25-31
    def num_items_per_plaintext(self, item_size: int) -> int:
        return self.n * self.bits_per_coeff // item_size // 8

    def max_bytes_per_plaintext(self) -> int:
        return self.n * self.bits_per_coeff // 8

    def _calc_num_coeff(self, num_bytes: int) -> int:
        num_coeff = -(-(num_bytes * 8) // self.bits_per_coeff)
        if num_coeff > self.n:
            raise ValueError(
                "number of coefficients needed greater than poly modulus degree"
            )
        return num_coeff

    def encode(self, value: bytes) -> np.ndarray:
        """Pack bytes into coefficients, MSB-first; result u64[N] (zero-padded)."""
        return self.encode_many([value])

    def encode_many(self, values) -> np.ndarray:
        """Pack the concatenation of several items into one plaintext.

        Parity with the iterator overload (string_encoder.cpp:108-122):
        items are packed back-to-back in the shared bitstream.
        """
        data = b"".join(bytes(v) for v in values)
        num_coeff = self._calc_num_coeff(len(data))
        bpc = self.bits_per_coeff
        bits = np.unpackbits(np.frombuffer(data, dtype=np.uint8))
        pad = num_coeff * bpc - bits.size
        if pad:
            bits = np.concatenate([bits, np.zeros(pad, dtype=np.uint8)])
        weights = (1 << np.arange(bpc - 1, -1, -1, dtype=np.uint64)).astype(
            np.uint64
        )
        coeffs = (bits.reshape(num_coeff, bpc).astype(np.uint64) * weights).sum(
            axis=1, dtype=np.uint64
        )
        out = np.zeros(self.n, dtype=np.uint64)
        out[:num_coeff] = coeffs
        return out

    def decode(self, pt: np.ndarray, length: int, byte_offset: int = 0) -> bytes:
        """Extract `length` bytes starting at `byte_offset` of the bitstream.

        Parity with string_encoder.cpp:124-158 — the reference's bit loop is
        equivalent to slicing the global MSB-first bitstream at bit position
        byte_offset*8.
        """
        pt = np.asarray(pt, dtype=np.uint64)
        bpc = self.bits_per_coeff
        if (byte_offset + length) > (pt.size * bpc // 8):
            raise ValueError("requested decode beyond end of data in polynomial")
        start_bit = byte_offset * 8
        end_bit = start_bit + length * 8
        start_coeff = start_bit // bpc
        end_coeff = -(-end_bit // bpc)
        # expand the needed coefficients into an MSB-first bit matrix
        seg = pt[start_coeff:end_coeff]
        shifts = np.arange(bpc - 1, -1, -1, dtype=np.uint64)
        bits = ((seg[:, None] >> shifts[None, :]) & np.uint64(1)).astype(np.uint8)
        flat = bits.reshape(-1)
        lo = start_bit - start_coeff * bpc
        return np.packbits(flat[lo : lo + length * 8]).tobytes()


class IntegerEncoder:
    """SEAL 3.5 legacy base-2 integer encoder (b_i ∈ {1, t-1} digits)."""

    def __init__(self, poly_modulus_degree: int, plain_modulus: int):
        self.n = poly_modulus_degree
        self.t = plain_modulus

    def encode(self, value: int) -> np.ndarray:
        out = np.zeros(self.n, dtype=np.uint64)
        v = int(value)
        neg = v < 0
        v = abs(v)
        if v.bit_length() > self.n:
            raise ValueError("value too large to encode")
        digit = self.t - 1 if neg else 1
        i = 0
        while v:
            if v & 1:
                out[i] = digit
            v >>= 1
            i += 1
        return out

    def decode_int64(self, pt: np.ndarray) -> int:
        """Evaluate at x=2 with coefficients centered mod t, wrapping to int64."""
        acc = 0
        t = self.t
        for i in range(len(pt) - 1, -1, -1):
            c = int(pt[i])
            if c > t // 2:
                c -= t
            acc = acc * 2 + c
        # wrap to int64 like the C++ implementation
        acc &= (1 << 64) - 1
        if acc >= 1 << 63:
            acc -= 1 << 64
        return acc
