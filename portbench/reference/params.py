"""The PIR parameter set a configuration file states, derived as the
protocol derives it.

Frozen from ``pir_tpu_torch/core/params.py`` (``create_pir_parameters``,
``calculate_dimensions``, ``num_items_per_plaintext``),
``pir/database.py`` (``calculate_indices``, ``calculate_item_offset``),
``ops/decompose.py`` (the digit counts and widths) and ``utils/math.py``,
with imports rewritten.  The chain is taken as the configuration states
it, so nothing here generates primes.
"""

from __future__ import annotations

import dataclasses
import math


def floor_log2(v: int) -> int:
    if v < 1:
        raise ValueError("floor_log2 requires v >= 1")
    return v.bit_length() - 1


def ceil_log2(v: int) -> int:
    return 0 if v <= 1 else (v - 1).bit_length()


def next_power_two(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def galois_elts(n: int) -> list[int]:
    """{N/2^i + 1 : i < log2 N}, the oblivious expansion's elements."""
    return [(n >> i) + 1 for i in range(ceil_log2(n))]


def calculate_dimensions(db_size: int, num_dimensions: int) -> list[int]:
    out = []
    for i in range(num_dimensions, 0, -1):
        dim = math.ceil(db_size ** (1.0 / i))
        out.append(dim)
        db_size = math.ceil(db_size / dim)
    return out


@dataclasses.dataclass(frozen=True)
class Params:
    n: int
    t: int
    chain: tuple  # every prime, the special (key-switching) prime last
    num_items: int
    bytes_per_item: int
    items_per_plaintext: int
    num_pt: int
    dimensions: tuple
    ct_mult: bool
    reencode_mode: int  # 0 legacy digits, 1 balanced

    @property
    def ct_moduli(self) -> tuple:
        return self.chain[:-1] if len(self.chain) > 1 else self.chain

    @property
    def L(self) -> int:
        return len(self.ct_moduli)

    @property
    def pt_bits(self) -> int:
        return floor_log2(self.t)

    @property
    def dimensions_sum(self) -> int:
        return sum(self.dimensions)

    def digit_counts(self) -> list[int]:
        """Digits per limb: ceil(log2(q_i) / floor(log2 t)), float log2."""
        return [int(math.ceil(math.log2(q) / self.pt_bits)) for q in self.ct_moduli]

    def digit_widths(self) -> list[int]:
        if self.reencode_mode == 0:
            return [self.pt_bits] * self.L
        return [-(-int(q).bit_length() // r) for q, r in zip(self.ct_moduli, self.digit_counts())]

    def expansion_ratio(self) -> int:
        return sum(self.digit_counts())

    def indices(self, index: int) -> list[int]:
        pt_index = index // self.items_per_plaintext
        out = []
        for d in reversed(self.dimensions):
            out.append(pt_index % d)
            pt_index //= d
        return list(reversed(out))

    def item_offset(self, index: int) -> int:
        pt_index = index // self.items_per_plaintext
        return (index - pt_index * self.items_per_plaintext) * self.bytes_per_item


def from_config(cfg: dict) -> Params:
    """The parameter set of a configuration file's numbers."""
    n = int(cfg["poly_modulus_degree"])
    t = int(cfg["plain_modulus"])
    chain = tuple(int(q) for q in cfg["coeff_modulus"])
    for q in chain:
        if (q - 1) % (2 * n):
            raise ValueError(f"coefficient modulus {q} is not 1 mod 2N")
    if t.bit_length() != int(cfg["plain_modulus_bits"]) or t >= min(chain[:-1] or chain):
        raise ValueError("plain modulus does not fit the stated chain")
    bits = floor_log2(t)
    item = int(cfg["item_bytes"])
    per_pt = n * bits // item // 8
    if per_pt <= 0:
        raise ValueError("an item does not fit one plaintext")
    num_pt = -(-int(cfg["items"]) // per_pt)
    return Params(
        n=n, t=t, chain=chain, num_items=int(cfg["items"]), bytes_per_item=item,
        items_per_plaintext=per_pt, num_pt=num_pt,
        dimensions=tuple(calculate_dimensions(num_pt, int(cfg["dimensions"]))),
        ct_mult=cfg["mode"] == "ciphertext_multiplication",
        reencode_mode={"legacy": 0, "balanced": 1}[cfg["reencode_digits"]],
    )
