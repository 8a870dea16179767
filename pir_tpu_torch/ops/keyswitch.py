"""Key switching: the kernel behind Galois automorphisms.

Port of ``switch_key`` and ``apply_galois`` of ``pir_tpu/ops/keyswitch.py``.
Pipeline for input polynomial c (coefficient form, ciphertext level q):

1. RNS-decompose: digit i is just limb i of c, viewed in [0, q_i) and
   re-reduced modulo every key-level prime — [..., L, Lp, N].
2. Forward NTT over the key chain QP.
3. Inner product with the switch key: acc_k = Σ_i digit_i ⊙ ksk[i, k].
4. Inverse NTT, then exact scale-down by the special prime P with centered
   rounding: out_j = (acc_j - center(acc mod P)) · P⁻¹ mod q_j.

The whole pipeline is batched over arbitrary leading axes — oblivious
expansion feeds it 2^j ciphertexts at level j in one call.

Limb sharding (parallel/sharded.py): when ``ctx`` is a rank's limb-shard
view (``limb_axis_name`` set), the input carries only this rank's RNS limbs
and the key only the matching decomposition rows; the digit inner
product's sum becomes a local partial plus one ``all_reduce`` over the limb
axis, and the full-basis tail (INTT over QP + P scale-down) runs on every
rank before each keeps its own limbs (``ctx.take_ct_limbs``).
"""

from __future__ import annotations

import torch

from pir_tpu_torch.core.context import PirContext
from pir_tpu_torch.ops import modular, poly, wide32


def inner_product_method(ctx, qp) -> str:
    """Which arithmetic :func:`_digit_inner_product` uses for key chain qp:
    "u32", "48-bit" or "generic" (the same static choice as pir_tpu's).
    The decomposition count is the whole chain's, on a limb-shard view too."""
    L_total = len(ctx.ct_moduli)
    moduli = tuple(int(m) for m in qp.moduli)
    bits = max(m.bit_length() for m in moduli)
    if bits <= 31 and L_total * (max(moduli) - 1) ** 2 < (1 << 64):
        return "u32"
    if bits <= 48 and L_total < (1 << 16):
        return "48-bit"
    return "generic"


def _digit_inner_product(ctx, digits, data, qp):
    """acc[k] = Σ_i digits[i] ⊙ ksk[i, k] over the decomposition axis,
    reduced mod every key prime — the key switch's hot contraction.

    digits: int64[..., L, Lp, N] NTT form; data: int64[L, 2, Lp, N].
    Returns reduced int64[..., 2, Lp, N], including the all_reduce over
    the limb axis on a limb-shard view (placed as in pir_tpu: after the sum
    in the u32 and generic branches, after the 96-bit reduction in the
    48-bit branch).

    * **u32** — key primes below 2^31 with the whole digit sum below 2^64
      (L·q² < 2^64; the tpu32 profile): one 32×32 product per term, summed
      as plain int64 (u64 bits), one Barrett reduction per output.
    * **48-bit raw** — primes below 2^48 (the SEAL default chain's 36/37-bit
      primes): three-word raw products summed exactly over the digit axis,
      one 96-bit Barrett reduction per output.
    * **generic** — any chain up to 61 bits: a Barrett reduction per
      product, reduced summands summed in u64.
    """
    method = inner_product_method(ctx, qp)
    limb_axis = getattr(ctx, "limb_axis_name", None)
    x = digits[..., :, None, :, :]  # [..., L, 1, Lp, N]

    if method == "u32":
        # both factors are reduced residues below 2^31: the int64 product is
        # the exact 32x32 product; the whole sum (all shards) fits u64 bits
        tot = (x * data).sum(dim=-4)
        if limb_axis is not None:
            tot = ctx.mesh.all_reduce(tot, limb_axis)
        return modular.barrett_reduce_64(tot, qp.q, qp.ratio_hi)

    if method == "48-bit":
        xh, xl = wide32.split_u64(x)
        wh, wl = wide32.split_u64(data)
        p2, p1, p0 = wide32.mul_u48_3w(xh, xl, wh, wl)
        s2, s1, s0 = wide32.sum96_over_axis(p2, p1, p0, axis=-4)
        tot = wide32.join_u64(
            *wide32.barrett_reduce96(s2, s1, s0, qp.q, qp.ratio_hi, qp.ratio_lo)
        )
        if limb_axis is not None:
            # the shards' totals are reduced (< q < 2^48): their sum stays
            # exact in u64 and one more reduction closes it
            tot = ctx.mesh.all_reduce(tot, limb_axis)
            tot = modular.barrett_reduce_64(tot, qp.q, qp.ratio_hi)
        return tot

    prod = modular.mul_mod(x, data, qp.q, qp.ratio_hi, qp.ratio_lo)
    # Reduced summands (< q_j < 2^61); L terms fit u64 without wrap.
    tot = prod.sum(dim=-4)
    if limb_axis is not None:
        tot = ctx.mesh.all_reduce(tot, limb_axis)
    return modular.barrett_reduce_64(tot, qp.q, qp.ratio_hi)


def switch_key(ctx: PirContext, ksk: torch.Tensor, c: torch.Tensor):
    """Key-switch c (int64[..., L, N] coeff form) with the switch key
    ksk (int64[L, 2, Lp, N]) -> (out0, out1), each shaped like c.

    Adding (out0, out1) to a ciphertext replaces a term c·t_key with its
    encryption under s, where t_key is the switch key's target.
    """
    qp = ctx.limbs_qp

    # 1. decompose: limb i of c broadcast to all Lp key primes.  The input
    # limbs are reduced (< q_i), so when every ct modulus is within a few
    # bits of every key prime the re-reduction is a couple of
    # shift-compare-subtract steps instead of a Barrett multiply.
    ct_bits = max(int(m).bit_length() for m in ctx.ct_moduli)
    k_max = ((1 << ct_bits) - 1) // min(int(m) for m in qp.moduli)
    x = c[..., :, None, :]  # [..., L, 1, N] vs q_col [Lp, 1]
    if k_max <= 4:
        digits = x.expand(*x.shape[:-2], len(qp.moduli), x.shape[-1])
        for i in range(k_max.bit_length() - 1, -1, -1):
            s = qp.q << i
            digits = torch.where(digits >= s, digits - s, digits)
    else:
        digits = modular.barrett_reduce_64(x, qp.q, qp.ratio_hi)
    # digits: [..., L, Lp, N]

    # 2. NTT over QP (limb axis is second-to-last).
    digits = ctx.ntt_qp.forward(digits)

    # 3. inner product with the key: [..., L, 1, Lp, N] x [L, 2, Lp, N].
    acc = _digit_inner_product(ctx, digits, ksk, qp)  # [..., 2, Lp, N]

    # 4. INTT and scale down by P with centered rounding.
    acc = ctx.ntt_qp.inverse(acc)
    t_last = acc[..., ctx.Lp - 1 : ctx.Lp, :]  # [..., 2, 1, N], mod P
    p = int(ctx.special)
    u = t_last + ctx.p_half
    u = torch.where(u >= p, u - p, u)
    lq = ctx.limbs_q
    u_mod_q = modular.barrett_reduce_64(u, lq.q, lq.ratio_hi)  # [..., 2, L, N]
    t_bar = modular.sub_mod(u_mod_q, ctx.p_half_mod_q, lq.q)
    out = modular.mul_mod_shoup(
        modular.sub_mod(ctx.take_ct_limbs(acc), t_bar, lq.q),
        ctx.p_inv_mod_q,
        ctx.p_inv_mod_q_shoup,
        lq.q,
    )
    return out[..., 0, :, :], out[..., 1, :, :]


def apply_galois(ctx: PirContext, galois_keys, ct: torch.Tensor, galois_elt: int):
    """Substitution operator x -> x^galois_elt on a ciphertext.

    ct: int64[..., 2, L, N] coefficient form; galois_keys maps an element to
    its switch key, an int64[L, 2, Lp, N] tensor.
    """
    c0 = poly.galois_transform(ctx, ct[..., 0, :, :], galois_elt)
    c1 = poly.galois_transform(ctx, ct[..., 1, :, :], galois_elt)
    k0, k1 = switch_key(ctx, galois_keys[galois_elt], c1)
    return torch.stack([modular.add_mod(c0, k0, ctx.limbs_q.q), k1], dim=-3)
