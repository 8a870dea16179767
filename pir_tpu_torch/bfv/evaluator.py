"""Plaintext lifting into the RNS/NTT domain (port of the database-side
helpers of ``pir_tpu/bfv/evaluator.py``).

Plaintexts are int64 ``[..., N]`` (mod t); lifted RNS polys ``[..., L, N]``.
"""

from __future__ import annotations

import torch

from pir_tpu_torch.core.context import PirContext


def plaintext_to_rns(ctx: PirContext, pt: torch.Tensor) -> torch.Tensor:
    """Plaintext int64[..., N] (mod t) -> RNS poly int64[..., L, N], un-scaled.

    Coefficients are taken as-is (t < every q_i), matching SEAL's
    non-centered plaintext lift for multiply_plain.
    """
    return pt[..., None, :].expand(*pt.shape[:-1], ctx.L, pt.shape[-1])


def plaintext_to_ntt(ctx: PirContext, pt: torch.Tensor) -> torch.Tensor:
    """Plaintext mod t -> NTT form at ciphertext level (DB precompute path)."""
    return ctx.ntt_q.forward(plaintext_to_rns(ctx, pt))
