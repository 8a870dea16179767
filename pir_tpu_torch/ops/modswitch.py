"""BFV modulus switching: divide-and-round by the last RNS prime.

Port of ``pir_tpu/ops/modswitch.py``.  Given a ciphertext over
q = q_0···q_{L-1}, produce one over q/q_{L-1} whose coefficients are
round(c / q_{L-1}), computed purely in RNS:

    c' mod q_j = (c_j + h_j - [(c_last + h) mod q_last]_j) · q_last⁻¹ mod q_j

with h = floor(q_last / 2).  Switching the final reply ciphertexts down
before serialization shrinks the reply by L/keep; the client reads the limb
count from the array shape.
"""

from __future__ import annotations

import numpy as np
import torch

from pir_tpu_torch.core.context import PirContext
from pir_tpu_torch.ops import modular
from pir_tpu_torch.ops.modular import tensor_u64


def _drop_consts(ctx: PirContext, level: int):
    """Constants for dropping the last prime of ctx.ct_moduli[:level],
    cached on the context."""
    key = ("modswitch", level)
    hit = ctx.derived.get(key)
    if hit is None:
        moduli = ctx.ct_moduli[:level]
        rest = modular.LimbConstants(moduli[:-1], ctx.device)
        q_last = int(moduli[-1])
        half = q_last >> 1
        q_col = np.array(moduli[:-1], dtype=np.uint64).reshape(-1, 1)
        inv = np.array(
            [[pow(q_last % m, -1, m)] for m in moduli[:-1]], dtype=np.uint64
        )
        hit = (
            rest,
            q_last,
            half,
            tensor_u64([[half % m] for m in moduli[:-1]], ctx.device),
            tensor_u64(inv, ctx.device),
            tensor_u64(modular.shoup_precompute(inv, q_col), ctx.device),
        )
        ctx.derived[key] = hit
    return hit


def mod_switch_drop_last(ctx: PirContext, ct: torch.Tensor) -> torch.Tensor:
    """int64[..., L', N] coeff form mod q_0..q_{L'-1} -> [..., L'-1, N]."""
    cur = ct.shape[-2]
    if cur < 2:
        raise ValueError("cannot drop the last remaining modulus")
    rest, q_last, half, half_mod, inv, inv_shoup = _drop_consts(ctx, cur)
    last = ct[..., cur - 1 : cur, :]  # [..., 1, N]
    last_half = modular.add_mod(last, half, q_last)
    tmp = modular.barrett_reduce_64(last_half, rest.q, rest.ratio_hi)
    tmp = modular.sub_mod(tmp, half_mod, rest.q)
    diff = modular.sub_mod(ct[..., : cur - 1, :], tmp, rest.q)
    return modular.mul_mod_shoup(diff, inv, inv_shoup, rest.q)


def mod_switch_to(ctx: PirContext, ct: torch.Tensor, keep: int) -> torch.Tensor:
    """Drop trailing RNS limbs until `keep` remain (no-op if already there)."""
    if keep < 1:
        raise ValueError("must keep at least one modulus")
    while ct.shape[-2] > keep:
        ct = mod_switch_drop_last(ctx, ct)
    return ct
