"""NTT-friendly prime generation, compatible with SEAL 3.5 parameter defaults.

The reference delegates prime selection to SEAL
(``seal::CoeffModulus::BFVDefault`` and ``seal::PlainModulus::Batching``,
called from ``pir/cpp/parameters.cpp:37,45-47``).  Those helpers pick, for a
requested bit size b and ring degree N, the *largest* primes p with exactly b
bits satisfying p ≡ 1 (mod 2N), scanning downward in steps of 2N.  We
reimplement that generator so that the parameters this framework produces are
value-compatible with the reference's defaults.

All host-side Python (arbitrary-precision ints); nothing here is traced.
"""

from __future__ import annotations

from pir_tpu_torch.utils.math import invert_mod  # noqa: F401  (re-exported for callers)

# Deterministic Miller-Rabin witnesses, sufficient for all n < 3.3e24 (> 2^64).
_MR_WITNESSES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in _MR_WITNESSES:
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_WITNESSES:
        x = pow(a, d, n)
        if x == 1 or x == n - 1:
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def get_primes(factor: int, bit_size: int, count: int) -> list[int]:
    """The `count` largest primes with exactly `bit_size` bits, ≡ 1 mod factor.

    Scans downward from the largest candidate, like SEAL's generator, so the
    resulting values match SEAL 3.5's hard-coded default tables when called
    with factor = 2N and the default bit-size schedules below.
    """
    if not 2 <= bit_size <= 62:
        raise ValueError(f"bit_size must be in [2, 62], got {bit_size}")
    results: list[int] = []
    # Largest value < 2^bit_size congruent to 1 mod factor.
    value = ((1 << bit_size) - 1) // factor * factor + 1
    lower = 1 << (bit_size - 1)
    while value > lower:
        if is_prime(value):
            results.append(value)
            if len(results) == count:
                return results
        value -= factor
    raise ValueError(
        f"could not find {count} primes of {bit_size} bits ≡ 1 mod {factor}"
    )


def get_prime(factor: int, bit_size: int) -> int:
    return get_primes(factor, bit_size, 1)[0]


def batching_prime(poly_degree: int, bit_size: int) -> int:
    """Plain modulus supporting batching: prime ≡ 1 mod 2N with `bit_size` bits.

    Parity with seal::PlainModulus::Batching as used by
    pir/cpp/parameters.cpp:37,45.
    """
    return get_prime(2 * poly_degree, bit_size)


# Default coefficient-modulus bit-size schedules at 128-bit classical security,
# matching seal::CoeffModulus::BFVDefault for SEAL 3.5 (the reference's
# pinned version).  The last prime in each chain is the key-switching
# ("special") prime; ciphertexts live modulo the product of the others.
_BFV_DEFAULT_BITS_128 = {
    1024: [27],
    2048: [54],
    4096: [36, 36, 37],
    8192: [43, 43, 44, 44, 44],
    16384: [48, 48, 48, 49, 49, 49, 49, 49, 49],
    32768: [55, 55, 55, 55, 55, 55, 55, 55, 55, 55, 55, 55, 55, 55, 55, 56],
}

# HE-standard maximum total coeff-modulus bits at 128-bit security; used to
# validate user-supplied chains the same way SEALContext does.
MAX_COEFF_MODULUS_BITS_128 = {
    1024: 27,
    2048: 54,
    4096: 109,
    8192: 218,
    16384: 438,
    32768: 881,
}


def default_coeff_modulus(poly_degree: int) -> list[int]:
    """128-bit-secure default RNS prime chain for the given ring degree."""
    try:
        bit_sizes = _BFV_DEFAULT_BITS_128[poly_degree]
    except KeyError:
        raise ValueError(
            f"no default coefficient modulus for poly degree {poly_degree}"
        ) from None
    return coeff_modulus_from_bits(poly_degree, bit_sizes)


def tpu_coeff_modulus(poly_degree: int) -> list[int]:
    """TPU-native sub-32-bit RNS chain at 128-bit security.

    Every prime fits one u32 lane, so a residue is a single word: the
    DB-scan MAC drops from 9 u32 multiplies (48-bit operands, three-word
    products — ops/pallas_scan._raw_kernel) to 4 (one 32x32->64), the DB
    plane shrinks from 5-6 bytes/coefficient to 4, and 30-bit values need
    only 4 balanced base-256 digits in the MXU NTT (36-bit needs 5).
    Trade: one more ct limb than SEAL's default chain for at least the
    same noise capacity (ct-modulus bits >= the default chain's), sized
    inside the same HE-standard total-bits bound the default obeys.

    Opt-in profile — generate_encryption_params(profile="tpu32"); the
    SEAL-compatible default chain stays the wire/interop default.
    """
    bits = _BFV_DEFAULT_BITS_128.get(poly_degree)
    bound = MAX_COEFF_MODULUS_BITS_128.get(poly_degree)
    if bits is None or bound is None or len(bits) < 2:
        raise ValueError(
            f"tpu32 profile needs a multi-prime default chain "
            f"(poly degree >= 4096), got {poly_degree}"
        )
    special = 30  # 30-bit cap: value + digit bias stays under 2^32
    ct_bits_needed = sum(bits[:-1])
    n_ct = -(-ct_bits_needed // special)
    each = min(special, (bound - special) // n_ct)
    return coeff_modulus_from_bits(poly_degree, [each] * n_ct + [special])


def coeff_modulus_from_bits(poly_degree: int, bit_sizes: list[int]) -> list[int]:
    """Distinct primes ≡ 1 mod 2N with the given bit sizes (descending scan).

    Bit sizes may repeat; repeated sizes yield consecutive primes from the
    same downward scan (largest first), as SEAL does.
    """
    counts: dict[int, int] = {}
    for b in bit_sizes:
        counts[b] = counts.get(b, 0) + 1
    pools = {b: get_primes(2 * poly_degree, b, c) for b, c in counts.items()}
    taken = {b: 0 for b in counts}
    out = []
    for b in bit_sizes:
        out.append(pools[b][taken[b]])
        taken[b] += 1
    return out


def primitive_root_2n(modulus: int, two_n: int) -> int:
    """Minimal primitive 2N-th root of unity mod a prime ≡ 1 (mod 2N).

    Used to build negacyclic NTT twiddle tables.  Deterministic (minimal
    root) so tables are reproducible across hosts.
    """
    if (modulus - 1) % two_n != 0:
        raise ValueError(f"{modulus} is not ≡ 1 mod {two_n}")
    exp = (modulus - 1) // two_n
    half = two_n // 2
    best = None
    g = 2
    while best is None and g < modulus:
        cand = pow(g, exp, modulus)
        # cand has order dividing 2N; it is a primitive 2N-th root iff
        # cand^(N) == -1.
        if pow(cand, half, modulus) == modulus - 1:
            best = cand
        g += 1
    if best is None:
        raise ValueError(f"no primitive {two_n}-th root mod {modulus}")
    # Minimize over the odd powers (all primitive 2N-th roots) for determinism.
    root = best
    minimal = root
    cur = root
    sq = pow(root, 2, modulus)
    for _ in range(half - 1):
        cur = cur * sq % modulus
        if cur < minimal:
            minimal = cur
    return minimal
