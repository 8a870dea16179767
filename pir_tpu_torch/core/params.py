"""Parameter objects: the single source of truth shared by client and server.

Mirrors the capability of the reference's L1 layer
(``pir/cpp/parameters.{h,cpp}``): build encryption parameters (ring degree,
plain modulus, RNS coefficient-modulus chain), validate them, and derive the
PIR packing/shape parameters (items per plaintext, number of plaintexts,
hypercube dimensions).  Like the reference, the serialized ``PirParams`` is
the only thing the two parties must agree on (``payload.proto:45-69``
semantics; see pir_tpu/proto/payload.proto).

Everything here is host-side configuration; device-side precomputed tables
live in :mod:`pir_tpu_torch.core.context`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

from pir_tpu_torch.core import primes as primes_mod
from pir_tpu_torch.utils.math import floor_log2

DEFAULT_POLY_MODULUS_DEGREE = 4096  # parity: pir/cpp/parameters.h:40
DEFAULT_PLAIN_MOD_BITS = 20  # parity: pir/cpp/parameters.cpp:45


@dataclasses.dataclass(frozen=True)
class EncryptionParams:
    """BFV encryption parameters.

    ``coeff_modulus`` lists the full RNS chain *including* the final
    key-switching ("special") prime.  When the chain has more than one prime,
    ciphertexts live modulo q = prod(coeff_modulus[:-1]) and keys modulo
    q·P with P = coeff_modulus[-1] — the same convention as SEAL 3.5's
    first/key context split that the reference relies on.
    """

    poly_modulus_degree: int
    plain_modulus: int
    coeff_modulus: tuple[int, ...]

    @property
    def ct_modulus(self) -> tuple[int, ...]:
        """RNS primes of the ciphertext modulus q (special prime dropped)."""
        if len(self.coeff_modulus) == 1:
            return self.coeff_modulus
        return self.coeff_modulus[:-1]

    @property
    def special_modulus(self) -> Optional[int]:
        """The key-switching prime P, or None if the chain has one prime."""
        if len(self.coeff_modulus) == 1:
            return None
        return self.coeff_modulus[-1]

    @property
    def q(self) -> int:
        """Ciphertext modulus q as a big integer."""
        out = 1
        for p in self.ct_modulus:
            out *= p
        return out

    @property
    def bits_per_coeff_max(self) -> int:
        """Default data bits per plaintext coefficient: floor(log2(t)).

        Parity with StringEncoder's default (pir/cpp/string_encoder.cpp:85,
        which floors the log since t is never a power of two).
        """
        return floor_log2(self.plain_modulus)

    def validate(self) -> None:
        n = self.poly_modulus_degree
        if n < 4 or n & (n - 1):
            raise ValueError(f"poly_modulus_degree must be a power of 2, got {n}")
        if len(set(self.coeff_modulus)) != len(self.coeff_modulus):
            raise ValueError("coeff_modulus primes must be distinct")
        for p in self.coeff_modulus:
            if p.bit_length() > 61:
                raise ValueError(f"coeff modulus prime {p} exceeds 61 bits")
            if (p - 1) % (2 * n) != 0:
                raise ValueError(f"coeff modulus prime {p} is not ≡ 1 mod 2N")
            if not primes_mod.is_prime(p):
                raise ValueError(f"coeff modulus {p} is not prime")
        t = self.plain_modulus
        if t.bit_length() > 60:
            raise ValueError(f"plain modulus {t} exceeds 60 bits")
        if t >= min(self.ct_modulus):
            raise ValueError("plain modulus must be smaller than every q_i")
        total_bits = sum(p.bit_length() for p in self.coeff_modulus)
        max_bits = primes_mod.MAX_COEFF_MODULUS_BITS_128.get(n)
        if max_bits is not None and total_bits > max_bits:
            raise ValueError(
                f"coeff modulus ({total_bits} bits) exceeds the 128-bit "
                f"security bound ({max_bits} bits) for N={n}"
            )

    # -- serialization (framework-native byte format; see pir_tpu/pir/wire.py
    #    for how this rides inside the PIRParameters proto) -----------------
    def to_dict(self) -> dict:
        return {
            "poly_modulus_degree": self.poly_modulus_degree,
            "plain_modulus": self.plain_modulus,
            "coeff_modulus": list(self.coeff_modulus),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "EncryptionParams":
        return cls(
            poly_modulus_degree=int(d["poly_modulus_degree"]),
            plain_modulus=int(d["plain_modulus"]),
            coeff_modulus=tuple(int(x) for x in d["coeff_modulus"]),
        )


def generate_encryption_params(
    poly_modulus_degree: int = DEFAULT_POLY_MODULUS_DEGREE,
    plain_mod_bit_size: int = DEFAULT_PLAIN_MOD_BITS,
    plain_modulus: Optional[int] = None,
    coeff_modulus: Optional[Sequence[int]] = None,
    profile: str = "seal",
) -> EncryptionParams:
    """Build BFV params with SEAL-3.5-compatible defaults.

    Parity with GenerateEncryptionParams (pir/cpp/parameters.cpp:33-54):
    batching plain modulus of the requested bit size, BFVDefault 128-bit
    coefficient chain for the ring degree.

    profile: "seal" (default) uses the SEAL-compatible BFVDefault chain;
    "tpu32" uses the TPU-native sub-32-bit chain (single-u32 residues;
    primes_mod.tpu_coeff_modulus) — same 128-bit security and at least
    the default's noise capacity, ~2x faster on the scan and NTT hot
    kernels.  Both parties just share the serialized params, as always.
    """
    if profile not in ("seal", "tpu32"):
        raise ValueError(f"unknown parameter profile {profile!r}")
    if plain_modulus is None:
        plain_modulus = primes_mod.batching_prime(
            poly_modulus_degree, plain_mod_bit_size
        )
    if coeff_modulus is None:
        if profile == "tpu32":
            coeff_modulus = primes_mod.tpu_coeff_modulus(poly_modulus_degree)
        else:
            coeff_modulus = primes_mod.default_coeff_modulus(
                poly_modulus_degree
            )
    params = EncryptionParams(
        poly_modulus_degree=poly_modulus_degree,
        plain_modulus=plain_modulus,
        coeff_modulus=tuple(coeff_modulus),
    )
    params.validate()
    return params


@dataclasses.dataclass(frozen=True)
class PirParams:
    """PIR protocol parameters (the PIRParameters proto, as a dataclass).

    Field-for-field parity with payload.proto:45-69; ``bits_per_coeff == 0``
    means "use the encryption-params default", exactly as in the reference.
    """

    num_items: int
    num_pt: int
    dimensions: tuple[int, ...]
    encryption_params: EncryptionParams
    bytes_per_item: int
    items_per_plaintext: int
    bits_per_coeff: int = 0
    use_ciphertext_multiplication: bool = False
    # Digit-width policy for the recursion's ciphertext re-encoding
    # (payload.proto field 9): 0 = legacy (reference-exact, every digit
    # floor(log2 t) bits, ct_reencoder.cpp:29-38), 1 = balanced (same digit
    # counts — so ExpansionRatio and reply shapes are identical — but
    # per-limb balanced widths, giving several extra bits of noise margin).
    reencode_mode: int = 0

    @property
    def effective_bits_per_coeff(self) -> int:
        if self.bits_per_coeff > 0:
            return self.bits_per_coeff
        return self.encryption_params.bits_per_coeff_max

    @property
    def dimensions_sum(self) -> int:
        return sum(self.dimensions)


def calculate_dimensions(db_size: int, num_dimensions: int) -> list[int]:
    """Shape `db_size` plaintexts into a d-dimensional hypercube.

    d-th-root shaping, parity with PIRDatabase::calculate_dimensions
    (pir/cpp/database.cpp:334-342): each dimension is the ceiling of the
    i-th root of what remains.
    """
    results = []
    for i in range(num_dimensions, 0, -1):
        dim = math.ceil(db_size ** (1.0 / i))
        results.append(dim)
        db_size = math.ceil(db_size / dim)
    return results


def num_items_per_plaintext(
    poly_modulus_degree: int, bits_per_coeff: int, item_size: int
) -> int:
    """How many item_size-byte items pack into one plaintext.

    Parity with StringEncoder::num_items_per_plaintext
    (pir/cpp/string_encoder.cpp:25-27): N * bits_per_coeff / item_size / 8
    with C integer division order.
    """
    return poly_modulus_degree * bits_per_coeff // item_size // 8


def create_pir_parameters(
    dbsize: int,
    bytes_per_item: int,
    dimensions: int = 1,
    enc_params: Optional[EncryptionParams] = None,
    use_ciphertext_multiplication: bool = False,
    bits_per_coeff: int = 0,
    reencode_digits: str = "balanced",
) -> PirParams:
    """Derive the full PIR parameter set from a database description.

    Parity with CreatePIRParameters (pir/cpp/parameters.cpp:56-107),
    including the bytes_per_item == 0 degenerate mode (one whole plaintext
    per item, used by the integer-database test path).

    reencode_digits: "balanced" (default — per-limb balanced digit widths
    for the d>=2 ciphertext re-encoding; same digit counts and reply
    shapes as the reference, several extra bits of noise margin) or
    "legacy" (byte-identical digits to the reference's
    CiphertextReencoder; required when a reference binary must decode the
    replies — SEAL wire mode enforces it).
    """
    if reencode_digits not in ("balanced", "legacy"):
        raise ValueError(f"unknown reencode_digits policy {reencode_digits!r}")
    if enc_params is None:
        enc_params = generate_encryption_params()
    enc_params.validate()

    n = enc_params.poly_modulus_degree
    effective_bits = enc_params.bits_per_coeff_max
    if bits_per_coeff > 0:
        if bits_per_coeff > effective_bits:
            raise ValueError("bits per coefficient greater than max")
        effective_bits = bits_per_coeff

    if bytes_per_item > 0:
        items_per_pt = num_items_per_plaintext(n, effective_bits, bytes_per_item)
        if items_per_pt <= 0:
            raise ValueError("cannot fit an item within one plaintext")
        num_pt = -(-dbsize // items_per_pt)
    else:
        bytes_per_item = n * effective_bits // 8
        items_per_pt = 1
        num_pt = dbsize

    return PirParams(
        num_items=dbsize,
        num_pt=num_pt,
        dimensions=tuple(calculate_dimensions(num_pt, dimensions)),
        encryption_params=enc_params,
        bytes_per_item=bytes_per_item,
        items_per_plaintext=items_per_pt,
        bits_per_coeff=bits_per_coeff,
        use_ciphertext_multiplication=use_ciphertext_multiplication,
        reencode_mode=1 if reencode_digits == "balanced" else 0,
    )
