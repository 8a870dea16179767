"""Homomorphic evaluator primitives over raw ciphertext tensors.

Port of ``pir_tpu/bfv/evaluator.py``: coefficient-wise add, NTT-domain
ciphertext×plaintext multiply (the database scan's per-element op), the NTT
form conversions and plaintext lifting.  Every function is batched over
arbitrary leading axes.

Ciphertexts: int64 ``[..., size, L, N]``; plaintexts: int64 ``[..., N]``
(mod t) or lifted RNS polys ``[..., L, N]``.
"""

from __future__ import annotations

import numpy as np
import torch

from pir_tpu_torch.core.context import PirContext
from pir_tpu_torch.ops import modular


def add_ct(ctx: PirContext, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Homomorphic addition (both operands in the same domain/form)."""
    return modular.add_mod(a, b, ctx.limbs_q.q)


def plaintext_to_rns(ctx: PirContext, pt: torch.Tensor) -> torch.Tensor:
    """Plaintext int64[..., N] (mod t) -> RNS poly int64[..., L, N], un-scaled.

    Coefficients are taken as-is (t < every q_i), matching SEAL's
    non-centered plaintext lift for multiply_plain.
    """
    return pt[..., None, :].expand(*pt.shape[:-1], ctx.L, pt.shape[-1])


def plaintext_to_ntt(ctx: PirContext, pt: torch.Tensor) -> torch.Tensor:
    """Plaintext mod t -> NTT form at ciphertext level (DB precompute path)."""
    return ctx.ntt_q.forward(plaintext_to_rns(ctx, pt))


def ct_to_ntt(ctx: PirContext, ct: torch.Tensor) -> torch.Tensor:
    return ctx.ntt_q.forward(ct)


def ct_from_ntt(ctx: PirContext, ct: torch.Tensor) -> torch.Tensor:
    return ctx.ntt_q.inverse(ct)


def multiply_plain_ntt(
    ctx: PirContext, ct_ntt: torch.Tensor, pt_ntt: torch.Tensor
) -> torch.Tensor:
    """NTT-domain ct×pt product: ct_ntt int64[..., size, L, N] times pt_ntt
    int64[..., L, N], broadcast over the size axis."""
    lq = ctx.limbs_q
    return modular.mul_mod(ct_ntt, pt_ntt[..., None, :, :], lq.q, lq.ratio_hi, lq.ratio_lo)


def multiply_scalar_mod_t(ctx: PirContext, pt, scalar: int):
    """Plaintext scalar multiply mod t (host/test helper)."""
    pt = np.asarray(pt, dtype=np.uint64)
    return (pt.astype(object) * (scalar % ctx.t) % ctx.t).astype(np.uint64)
