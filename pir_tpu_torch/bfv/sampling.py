"""Randomness for BFV: ternary secrets, error polynomials, uniform ring elements.

Replaces the SEAL sampling surface the reference consumes implicitly through
``KeyGenerator``/``Encryptor`` (SURVEY §2b).  Distribution shapes follow the
standard RLWE recipe (uniform ternary secret, centered-binomial error with
σ≈3.2 matching SEAL's noise width, uniform-per-limb ring elements, which are
exactly uniform over R_q by CRT).  The exact PRNG need not match SEAL's
Blake2 generator — only our own reproducibility matters (SURVEY §2b last row).

Sampling is host-side numpy; the arrays feed jitted device math.
"""

from __future__ import annotations

import numpy as np

# Centered binomial with 2k trials has variance k/2; k=21 gives σ≈3.24,
# matching SEAL's σ=3.2 noise standard deviation.
_CBD_K = 21


def ternary_poly(rng: np.random.Generator, n: int) -> np.ndarray:
    """Uniform ternary secret coefficients in {-1, 0, 1} (int64)."""
    return rng.integers(-1, 2, size=n, dtype=np.int64)


def error_poly(rng: np.random.Generator, n: int) -> np.ndarray:
    """Centered-binomial error, σ≈3.2 (int64)."""
    a = rng.binomial(_CBD_K, 0.5, size=n).astype(np.int64)
    b = rng.binomial(_CBD_K, 0.5, size=n).astype(np.int64)
    return a - b


def uniform_rns(rng: np.random.Generator, moduli, n: int) -> np.ndarray:
    """Uniform element of R_q as independent uniform residues u64[L, N]."""
    out = np.zeros((len(moduli), n), dtype=np.uint64)
    for i, q in enumerate(moduli):
        out[i] = rng.integers(0, q, size=n, dtype=np.uint64)
    return out


def signed_to_rns(x: np.ndarray, moduli) -> np.ndarray:
    """Signed int64 coefficients -> residues u64[L, N] (negatives wrap to q-|x|)."""
    out = np.zeros((len(moduli), len(x)), dtype=np.uint64)
    for i, q in enumerate(moduli):
        out[i] = np.mod(x.astype(np.int64), np.int64(q)).astype(np.uint64)
    return out
