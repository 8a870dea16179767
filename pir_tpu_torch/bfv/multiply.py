"""BFV ciphertext×ciphertext multiplication (BEHZ full-RNS variant).

Port of ``pir_tpu/bfv/multiply.py``, the multiply behind the reference's
ciphertext-multiplication recursion mode.  For size-2 inputs (output size
3, relinearized separately):

1. lift both ciphertexts exactly into the auxiliary base Bsk (m_tilde trick
   + small Montgomery reduction);
2. negacyclic tensor product in NTT form over q and over Bsk;
3. scale by t/q: multiply by t in both bases, fast_floor into Bsk;
4. exact conversion back to base q (Shenoy–Kumaresan).

The NTTs over q and over the 60-bit Bsk base are kernel A on the card (its
reducing butterflies: Bsk's primes are above the growing rule's bound).
"""

from __future__ import annotations

import functools

import torch

from pir_tpu_torch.core.context import PirContext
from pir_tpu_torch.core.rns import RnsTool


@functools.lru_cache(maxsize=8)
def _rns_tool(ct_moduli: tuple, n: int, t: int, device: torch.device) -> RnsTool:
    return RnsTool(ct_moduli, n, t, device=device)


def rns_tool_for(ctx: PirContext) -> RnsTool:
    """The context's BEHZ tool, built once per (chain, ring, t, device)."""
    return _rns_tool(tuple(ctx.ct_moduli), ctx.n, ctx.t, ctx.device)


def bfv_multiply(ctx: PirContext, ct1: torch.Tensor, ct2: torch.Tensor) -> torch.Tensor:
    """int64[..., 2, L, N] × int64[..., 2, L, N] -> int64[..., 3, L, N]
    (coefficient form; the leading axes broadcast)."""
    tool = rns_tool_for(ctx)
    lq = ctx.limbs_q
    lb = tool.limbs_bsk

    # 1. lift to Bsk (exact) and forward NTT in both bases
    def lift(ct):
        return ctx.ntt_q.forward(ct), tool.ntt_bsk.forward(tool.fastbconv_m_tilde_sm_mrq(ct))

    a_q, a_b = lift(ct1)
    b_q, b_b = lift(ct2)

    # 2. tensor product (dyadic, both bases): [..., 3, limbs, N]
    def tensor(x, y, limbs):
        x0, x1 = x[..., 0, :, :], x[..., 1, :, :]
        y0, y1 = y[..., 0, :, :], y[..., 1, :, :]
        c1 = limbs.add(limbs.mul(x0, y1), limbs.mul(x1, y0))
        return torch.stack([limbs.mul(x0, y0), c1, limbs.mul(x1, y1)], dim=-3)

    prod_q = ctx.ntt_q.inverse(tensor(a_q, b_q, lq))
    prod_b = tool.ntt_bsk.inverse(tensor(a_b, b_b, lb))

    # 3. ×t then floor(t·v/q) in Bsk
    floored = tool.fast_floor(tool.t_mod_q.mul(prod_q, lq.q), tool.t_mod_bsk.mul(prod_b, lb.q))

    # 4. back to base q
    return tool.fastbconv_sk(floored)
