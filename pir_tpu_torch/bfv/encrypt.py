"""BFV encryption and decryption (port of ``pir_tpu/bfv/encrypt.py``).

Ciphertext layout: int64 ``[size, L, N]`` coefficient form.  Encryption math
runs on the context's device; the final scale-and-round of decryption is
exact host-side CRT.  Randomness is drawn from a numpy Generator in the
original's order, so one seed gives bit-identical ciphertexts.
"""

from __future__ import annotations

import numpy as np
import torch

from pir_tpu_torch.bfv import sampling
from pir_tpu_torch.bfv.keys import PublicKey, SecretKey
from pir_tpu_torch.core.context import PirContext
from pir_tpu_torch.ops.modular import numpy_u64, tensor_u64


def lift_plaintext(ctx: PirContext, m: np.ndarray) -> torch.Tensor:
    """round(q·m/t) per coefficient, as an RNS poly int64[L, N].

    The exact-rational "scaling variant" SEAL uses for BFV encryption —
    not Δ·m = floor(q/t)·m.  Host-side big-int math.
    """
    m_obj = np.asarray(m, dtype=np.uint64).astype(object)
    q = ctx.q_big
    t = ctx.t
    scaled = (m_obj * q + t // 2) // t  # round(q*m/t), exact
    out = np.zeros((ctx.L, ctx.n), dtype=np.uint64)
    for li, qi in enumerate(ctx.ct_moduli):
        out[li] = np.asarray(scaled % qi, dtype=np.uint64)
    return tensor_u64(out, ctx.device)


def _rns(ctx: PirContext, signed: np.ndarray) -> torch.Tensor:
    return tensor_u64(sampling.signed_to_rns(signed, ctx.ct_moduli), ctx.device)


def encrypt(
    ctx: PirContext, pk: PublicKey, m: np.ndarray, rng: np.random.Generator
) -> torch.Tensor:
    """Fresh encryption of plaintext m (u64[N], mod t) -> int64[2, L, N]."""
    u = _rns(ctx, sampling.ternary_poly(rng, ctx.n))
    e0 = _rns(ctx, sampling.error_poly(rng, ctx.n))
    e1 = _rns(ctx, sampling.error_poly(rng, ctx.n))
    lq = ctx.limbs_q
    u_ntt = ctx.ntt_q.forward(u)
    c0 = lq.add(
        lq.add(ctx.ntt_q.inverse(lq.mul(pk.data[0], u_ntt)), e0),
        lift_plaintext(ctx, m),
    )
    c1 = lq.add(ctx.ntt_q.inverse(lq.mul(pk.data[1], u_ntt)), e1)
    return torch.stack([c0, c1])


def encrypt_zero(
    ctx: PirContext, pk: PublicKey, rng: np.random.Generator
) -> torch.Tensor:
    return encrypt(ctx, pk, np.zeros(ctx.n, dtype=np.uint64), rng)


def expand_a_from_seed(ctx: PirContext, seed: bytes) -> np.ndarray:
    """Deterministic uniform ring element u64[L, N] (coeff form) from a
    16-byte seed.  Shared by the encryptor and anyone re-expanding a seeded
    ciphertext (the server, pir/wire.py)."""
    gen = np.random.Generator(np.random.Philox(key=int.from_bytes(seed, "little")))
    return sampling.uniform_rns(gen, ctx.ct_moduli, ctx.n)


def encrypt_symmetric_seeded(
    ctx: PirContext,
    sk: SecretKey,
    m: np.ndarray,
    rng: np.random.Generator,
    seed: "bytes | None" = None,
) -> tuple[np.ndarray, bytes]:
    """Symmetric seeded encryption: returns (c0 u64[L, N], seed).

    The full ciphertext is (c0, a) with a = expand_a_from_seed(seed), so
    only c0 + 16 bytes cross the wire:  c0 = Δm + e - a·s.
    """
    if seed is None:
        seed = rng.bytes(16)
    a = tensor_u64(expand_a_from_seed(ctx, seed), ctx.device)
    e = _rns(ctx, sampling.error_poly(rng, ctx.n))
    lq = ctx.limbs_q
    a_s = ctx.ntt_q.inverse(lq.mul(ctx.ntt_q.forward(a), sk.ntt_q))
    c0 = lq.sub(lq.add(lift_plaintext(ctx, m), e), a_s)
    return numpy_u64(c0), seed


def _phase(ctx: PirContext, sk: SecretKey, ct: torch.Tensor) -> np.ndarray:
    """c0 + c1·s (+ c2·s² ...) mod q', coefficient form — Horner over s.

    The modulus level is read off the limb axis, so mod-switched
    ciphertexts decrypt at their reduced q'.
    """
    size = ct.shape[-3]
    level = ct.shape[-2]
    ntt = ctx.ntt_q if level == ctx.L else ctx.ntt_qp.slice(level)
    lq = ntt.limbs
    s_ntt = sk.ntt_q[:level]
    acc = ct[..., size - 1, :, :]
    for k in range(size - 2, -1, -1):
        acc = lq.add(ntt.inverse(lq.mul(ntt.forward(acc), s_ntt)), ct[..., k, :, :])
    return numpy_u64(acc)


def decrypt(ctx: PirContext, sk: SecretKey, ct: torch.Tensor) -> np.ndarray:
    """Decrypt to a plaintext u64[N] mod t: m = round(t·phase/q') mod t."""
    phase = _phase(ctx, sk, ct)
    coeffs = np.array(ctx.crt_lift(phase), dtype=object)
    q = ctx.q_prod(ct.shape[-2])
    t = ctx.t
    return np.asarray(((t * coeffs + (q >> 1)) // q) % t, dtype=np.uint64)


def invariant_noise_budget(ctx: PirContext, sk: SecretKey, ct: torch.Tensor) -> int:
    """Bits of noise budget left: floor(log2(q / (2·|t·phase mod q|_∞))).

    Semantics of seal::Decryptor::invariant_noise_budget as used by the
    reference's noise probe (pir/cpp/database.cpp:260-270), at the
    ciphertext's own level (a mod-switched reply at its reduced q').  0
    means the ciphertext no longer decrypts reliably.
    """
    phase = _phase(ctx, sk, ct)
    q = ctx.q_prod(ct.shape[-2])
    r = (ctx.t * np.array(ctx.crt_lift(phase), dtype=object)) % q
    vmax = int(np.minimum(r, q - r).max())
    if vmax == 0:
        return q.bit_length()
    ratio = q // (2 * vmax)
    if ratio == 0:
        return 0
    return ratio.bit_length() - 1
