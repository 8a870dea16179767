"""BFV modulus switching: divide-and-round by the last RNS prime.

Port of ``pir_tpu/ops/modswitch.py``.  Given a ciphertext over
q = q_0···q_{L-1}, produce one over q/q_{L-1} whose coefficients are
round(c / q_{L-1}), computed purely in RNS:

    c' mod q_j = (c_j + h_j - [(c_last + h) mod q_last]_j) · q_last⁻¹ mod q_j

with h = floor(q_last / 2).  Switching the final reply ciphertexts down
before serialization shrinks the reply by L/keep; the client reads the limb
count from the array shape.

:func:`mod_switch_to` drops the limbs of a CUDA tensor in one launch of
kernel F3 (``csrc/upper.cu``, :func:`mod_switch_cuda`: every drop in
registers, in pir_tpu's order), and of a CPU tensor one limb at a time
(:func:`mod_switch_plain`, the plain version).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pir_tpu_torch import kernels
from pir_tpu_torch.core.context import PirContext
from pir_tpu_torch.ops import modular
from pir_tpu_torch.ops.modular import tensor_u64
from pir_tpu_torch.utils import profiling

MAX_LIMBS = 32  # the words one thread of kernel F3 holds (csrc/upper.cu::kMaxLimbs)


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
    """Drop trailing RNS limbs until `keep` remain (no-op if already there):
    kernel F3 on a CUDA tensor, the plain version on a CPU one."""
    if keep < 1:
        raise ValueError("must keep at least one modulus")
    with profiling.span("pir.modswitch"):
        if ct.is_cuda:
            return mod_switch_cuda(ctx, ct, keep)
        return mod_switch_plain(ctx, ct, keep)


def mod_switch_plain(ctx: PirContext, ct: torch.Tensor, keep: int) -> torch.Tensor:
    """The plain PyTorch version of :func:`mod_switch_to`: one
    :func:`mod_switch_drop_last` a limb."""
    while ct.shape[-2] > keep:
        ct = mod_switch_drop_last(ctx, ct)
    return ct


def switch_table(ctx: PirContext) -> torch.Tensor:
    """Kernel F3's constants for every drop of the chain, cached on the
    context: for each stage s = 1 .. L-1 (dropping q_s from q_0..q_s), q_s
    and floor(q_s / 2), then for every j < s (q_j, floor(2^64 / q_j),
    floor(q_s / 2) mod q_j, q_s^-1 mod q_j, its Shoup companion) — the
    words of :func:`_drop_consts` — as one int64 vector (u64 bits)."""
    key = ("modswitch", "table")
    hit = ctx.derived.get(key)
    if hit is None:
        words = []
        moduli = [int(m) for m in ctx.ct_moduli]
        for s, q_last in enumerate(moduli[1:], start=1):
            half = q_last >> 1
            words += [q_last, half]
            for m in moduli[:s]:
                inv = pow(q_last % m, -1, m)
                words += [m, modular.barrett_ratio(m)[0], half % m, inv, (inv << 64) // m]
        hit = ctx.derived[key] = tensor_u64(np.array(words, dtype=np.uint64), ctx.device)
    return hit


def mod_switch_cuda(ctx: PirContext, ct: torch.Tensor, keep: int) -> torch.Tensor:
    """Kernel F3 (``pir_mod_switch``): ct int64[..., L', N] mod
    q_0..q_{L'-1} -> int64[..., keep, N], every drop in one launch."""
    kernels.require_cuda(ct, "ct", "F")
    cur, n = ct.shape[-2:]
    if keep < 1:
        raise ValueError("must keep at least one modulus")
    if cur <= keep:
        return ct
    if cur > len(ctx.ct_moduli) or cur > MAX_LIMBS:
        raise ValueError(f"kernel F3 drops from at most {min(len(ctx.ct_moduli), MAX_LIMBS)} "
                         f"limbs, got {cur}")
    table = switch_table(ctx)
    if table.device != ct.device:
        raise ValueError(f"the context's tables live on {table.device}, ct on {ct.device}")
    ct = ct.contiguous()
    out = torch.empty((*ct.shape[:-2], keep, n), dtype=torch.int64, device=ct.device)
    rows = math.prod(ct.shape[:-2])
    if rows == 0 or n == 0:
        return out
    kernels.UPPER.launch("pir_mod_switch", ct.data_ptr(), table.data_ptr(), out.data_ptr(),
                         rows, cur, keep, n, kernels.stream_handle(ct))
    return out
