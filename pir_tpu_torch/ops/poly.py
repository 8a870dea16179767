"""Coefficient-domain polynomial permutations: Galois automorphisms and
negacyclic monomial shifts (port of ``pir_tpu/ops/poly.py``).

Both are sign-flipping permutations of the coefficient axis: an
``index_select`` plus a conditional modular negation.
"""

from __future__ import annotations

import torch

from pir_tpu_torch.ops import modular


def apply_signed_permutation(x: torch.Tensor, src, flip, q) -> torch.Tensor:
    """out[..., k] = ±x[..., src[k]], negating (mod q) where flip[k].

    x: int64[..., L, N]; src: int64[N]; flip: bool[N]; q broadcastable [L, 1].
    """
    gathered = x.index_select(x.dim() - 1, src)
    return torch.where(flip, modular.neg_mod(gathered, q), gathered)


def galois_transform(ctx, x: torch.Tensor, galois_elt: int) -> torch.Tensor:
    """x(x^galois_elt) mod (x^N+1) on coefficient-form limbs [..., L, N]."""
    src, flip = ctx.galois_permutation(galois_elt)
    return apply_signed_permutation(x, src, flip, ctx.limbs_q.q)


def monomial_shift(ctx, x: torch.Tensor, index: int) -> torch.Tensor:
    """x * x^index mod (x^N+1), index in [0, 2N)."""
    src, flip = ctx.monomial_shift_permutation(index)
    return apply_signed_permutation(x, src, flip, ctx.limbs_q.q)


def multiply_inverse_power_of_x(ctx, ct: torch.Tensor, k: int) -> torch.Tensor:
    """ct * x^{-k}: the negacyclic shift by index (2N - k) mod 2N, applied
    to every polynomial and limb of the ciphertext."""
    index = (2 * ctx.n - k) % (2 * ctx.n)
    return monomial_shift(ctx, ct, index)
