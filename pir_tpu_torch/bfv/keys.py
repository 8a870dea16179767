"""BFV key material and key generation (port of ``pir_tpu/bfv/keys.py``).

Key-switching keys use the single-special-prime construction: ciphertexts
live mod q = q_0···q_{L-1}; keys live mod q·P with P the last ("special")
prime.  For a target key t (s(x^g) for Galois, s² for relin), component i of
the switch key is a fresh RLWE encryption of zero under s over QP with P·t
folded into its i-th limb:

    ksk[i] = ( -(a_i·s + e_i) + P·t·δ_i ,  a_i )   (NTT form, [2, Lp, N])

Randomness is drawn from a numpy Generator in exactly the order
``pir_tpu``'s keygen draws it, so one seed gives bit-identical keys.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pir_tpu_torch.bfv import sampling
from pir_tpu_torch.core.context import PirContext
from pir_tpu_torch.ops import modular
from pir_tpu_torch.ops.modular import tensor_u64
from pir_tpu_torch.pir import seal_compat


@dataclasses.dataclass
class SecretKey:
    """Ternary secret; cached in NTT form at both modulus levels."""

    coeffs: np.ndarray  # int64[N] in {-1, 0, 1}
    ntt_q: torch.Tensor  # int64[L, N]   (ciphertext level)
    ntt_qp: torch.Tensor  # int64[Lp, N] (key level)


@dataclasses.dataclass
class PublicKey:
    data: torch.Tensor  # int64[2, L, N], NTT form at ciphertext level


@dataclasses.dataclass
class KSwitchKey:
    data: torch.Tensor  # int64[L, 2, Lp, N], NTT form at key level
    # SEAL stream-PRNG seeds (8 u64 words per component) when the a-polys
    # were derived from seeds: the key then serializes in SEAL's seeded
    # form (pir/seal_compat.py).  None otherwise.
    seeds: "list | None" = None


@dataclasses.dataclass
class GaloisKeys:
    keys: dict  # galois_elt -> KSwitchKey

    def __contains__(self, elt: int) -> bool:
        return elt in self.keys

    def __getitem__(self, elt: int) -> KSwitchKey:
        return self.keys[elt]


@dataclasses.dataclass
class RelinKeys:
    key: KSwitchKey  # target s^2


def gen_secret_key(ctx: PirContext, rng: np.random.Generator) -> SecretKey:
    s = sampling.ternary_poly(rng, ctx.n)
    s_q = tensor_u64(sampling.signed_to_rns(s, ctx.ct_moduli), ctx.device)
    s_qp = tensor_u64(sampling.signed_to_rns(s, ctx.key_moduli), ctx.device)
    return SecretKey(
        coeffs=s, ntt_q=ctx.ntt_q.forward(s_q), ntt_qp=ctx.ntt_qp.forward(s_qp)
    )


def gen_public_key(
    ctx: PirContext, sk: SecretKey, rng: np.random.Generator
) -> PublicKey:
    a = tensor_u64(sampling.uniform_rns(rng, ctx.ct_moduli, ctx.n), ctx.device)
    e = tensor_u64(
        sampling.signed_to_rns(sampling.error_poly(rng, ctx.n), ctx.ct_moduli),
        ctx.device,
    )
    lq = ctx.limbs_q
    pk0 = lq.neg(lq.add(lq.mul(a, sk.ntt_q), ctx.ntt_q.forward(e)))
    return PublicKey(data=torch.stack([pk0, a]))


def gen_kswitch_key(
    ctx: PirContext,
    sk: SecretKey,
    target_ntt_qp: torch.Tensor,
    rng: np.random.Generator,
    seeded_wire: bool = False,
) -> KSwitchKey:
    """Key-switching key for a target key given in NTT form over QP.

    seeded_wire: derive each component's uniform a-poly from a fresh SEAL
    stream-PRNG seed (seal_compat.sample_poly_uniform, on the host) instead
    of the rng, and keep the seeds, so that the key serializes in SEAL's
    seeded form with c1 replaced by its seed.  The L seeds are drawn before
    the error polynomials, as in ``pir_tpu``."""
    if ctx.special is None:
        raise ValueError(
            "key switching requires a special prime (>=2 coeff moduli)"
        )
    seeds = None
    if seeded_wire:
        seeds = [seal_compat.random_prng_seed(rng) for _ in range(ctx.L)]
        a_host = [seal_compat.sample_poly_uniform(s, ctx.key_moduli, ctx.n) for s in seeds]
    else:
        a_host = [sampling.uniform_rns(rng, ctx.key_moduli, ctx.n) for _ in range(ctx.L)]
    a_all = tensor_u64(np.stack(a_host), ctx.device)
    e_all = tensor_u64(
        np.stack(
            [
                sampling.signed_to_rns(sampling.error_poly(rng, ctx.n), ctx.key_moduli)
                for _ in range(ctx.L)
            ]
        ),
        ctx.device,
    )
    lqp = ctx.limbs_qp
    b = lqp.neg(lqp.add(lqp.mul(a_all, sk.ntt_qp), ctx.ntt_qp.forward(e_all)))
    # Fold P·target into limb i of component i (NTT domain).
    comps = []
    for i in range(ctx.L):
        qi = int(ctx.ct_moduli[i])
        rhi, rlo = modular.barrett_ratio(qi)
        folded = modular.mul_mod(
            target_ntt_qp[i], int(ctx.special) % qi, qi,
            modular.to_i64(rhi), modular.to_i64(rlo),
        )
        bi = b[i].clone()
        bi[i] = modular.add_mod(b[i, i], folded, qi)
        comps.append(torch.stack([bi, a_all[i]]))
    return KSwitchKey(data=torch.stack(comps), seeds=seeds)


def _automorph_signed(coeffs: np.ndarray, galois_elt: int) -> np.ndarray:
    """x -> x^g on signed host-side coefficients (for s(x^g) targets)."""
    n = len(coeffs)
    j = (np.arange(n, dtype=np.int64) * galois_elt) % (2 * n)
    out = np.zeros_like(coeffs)
    out[j % n] = np.where(j < n, coeffs, -coeffs)
    return out


def gen_galois_keys(
    ctx: PirContext,
    sk: SecretKey,
    elts,
    rng: np.random.Generator,
    seeded_wire: bool = False,
) -> GaloisKeys:
    keys = {}
    for elt in elts:
        s_g = _automorph_signed(sk.coeffs, int(elt))
        target = ctx.ntt_qp.forward(
            tensor_u64(sampling.signed_to_rns(s_g, ctx.key_moduli), ctx.device)
        )
        keys[int(elt)] = gen_kswitch_key(ctx, sk, target, rng, seeded_wire=seeded_wire)
    return GaloisKeys(keys=keys)


def gen_relin_key(
    ctx: PirContext,
    sk: SecretKey,
    rng: np.random.Generator,
    seeded_wire: bool = False,
) -> RelinKeys:
    target = ctx.limbs_qp.mul(sk.ntt_qp, sk.ntt_qp)  # s^2 in NTT form
    return RelinKeys(key=gen_kswitch_key(ctx, sk, target, rng, seeded_wire=seeded_wire))
