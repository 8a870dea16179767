"""BFV ciphertext×ciphertext multiplication (BEHZ full-RNS variant).

Port of ``pir_tpu/bfv/multiply.py``, the multiply behind the reference's
ciphertext-multiplication recursion mode.  For size-2 inputs (output size
3, relinearized separately):

1. lift both ciphertexts exactly into the auxiliary base Bsk (m_tilde trick
   + small Montgomery reduction): :func:`lift`;
2. negacyclic tensor product in NTT form over q and over Bsk:
   :func:`tensor_product`;
3. scale by t/q: multiply by t in both bases, fast_floor into Bsk, then
4. exact conversion back to base q (Shenoy–Kumaresan): :func:`floor_sk`.

Steps 1, 2 and 3-4 are kernel G's entries (``csrc/behz.cu``: G1, G2, G3)
on a CUDA tensor and their plain PyTorch versions (``*_plain``, the
``RnsTool`` methods, the reference the kernel is tested against) on a CPU
tensor.  The NTTs over q and over the 60-bit Bsk base are kernel A on the
card (its reducing butterflies: Bsk's primes are above the growing rule's
bound).
"""

from __future__ import annotations

import functools
import math

import torch

from pir_tpu_torch import kernels
from pir_tpu_torch.core.context import PirContext
from pir_tpu_torch.core.rns import RnsTool

MAX_Q_LIMBS = 15  # ciphertext limbs kernel G takes (csrc/behz.cu::kMaxQ)


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
    a_q, a_b = ctx.ntt_q.forward(ct1), tool.ntt_bsk.forward(lift(tool, ct1))
    b_q, b_b = ctx.ntt_q.forward(ct2), tool.ntt_bsk.forward(lift(tool, ct2))
    prod_q, prod_b = tensor_product(tool, a_q, a_b, b_q, b_b)
    return floor_sk(tool, ctx.ntt_q.inverse(prod_q), tool.ntt_bsk.inverse(prod_b))


def _check_limbs(tool: RnsTool, k: int, table: torch.Tensor, x: torch.Tensor) -> None:
    if k != len(tool.q_moduli):
        raise ValueError(f"the tensor has {k} limbs, the tool's chain {len(tool.q_moduli)}")
    if k > MAX_Q_LIMBS:
        raise ValueError(f"kernel G takes at most {MAX_Q_LIMBS} ciphertext limbs, got {k}")
    if table.device != x.device:
        raise ValueError(f"the tool's tables live on {table.device}, the tensor on {x.device}")


# ---------------------------------------------------------------------------
# 1. the lift into Bsk (kernel G1)
# ---------------------------------------------------------------------------


def lift(tool: RnsTool, x: torch.Tensor) -> torch.Tensor:
    """x int64[..., k, N] (base q) -> int64[..., k + 1, N], exactly x in
    base Bsk."""
    if x.is_cuda:
        return lift_cuda(tool, x)
    return lift_plain(tool, x)


def lift_plain(tool: RnsTool, x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`lift`."""
    return tool.fastbconv_m_tilde_sm_mrq(x)


def lift_cuda(tool: RnsTool, x: torch.Tensor) -> torch.Tensor:
    """Kernel G1 (``pir_behz_lift``): rows of x read in place where their
    limbs lie contiguously."""
    kernels.require_cuda(x, "x", "G")
    k, n = x.shape[-2:]
    table = tool.kernel_table
    _check_limbs(tool, k, table, x)
    out = torch.empty((*x.shape[:-2], k + 1, n), dtype=torch.int64, device=x.device)
    rows = x.reshape(-1, k, n)
    if rows.shape[0] == 0 or n == 0:
        return out
    if rows.stride(-1) != 1 or rows.stride(-2) != n:
        rows = rows.contiguous()
    kernels.BEHZ.launch("pir_behz_lift", rows.data_ptr(), rows.stride(0), table.data_ptr(),
                        out.data_ptr(), rows.shape[0], k, n, kernels.stream_handle(x))
    return out


# ---------------------------------------------------------------------------
# 2. the tensor product (kernel G2)
# ---------------------------------------------------------------------------


def tensor_product(tool: RnsTool, a_q, a_b, b_q, b_b):
    """Size-2 × size-2 -> size-3 dyadic products in NTT form: a_q, b_q
    int64[..., 2, k, N] over q, a_b, b_b int64[..., 2, k + 1, N] over Bsk
    (a's and b's leading axes broadcast) -> (int64[..., 3, k, N],
    int64[..., 3, k + 1, N])."""
    if a_q.is_cuda:
        return tensor_product_cuda(tool, a_q, a_b, b_q, b_b)
    return tensor_product_plain(tool, a_q, a_b, b_q, b_b)


def _dyadic(x, y, limbs):
    x0, x1 = x[..., 0, :, :], x[..., 1, :, :]
    y0, y1 = y[..., 0, :, :], y[..., 1, :, :]
    c1 = limbs.add(limbs.mul(x0, y1), limbs.mul(x1, y0))
    return torch.stack([limbs.mul(x0, y0), c1, limbs.mul(x1, y1)], dim=-3)


def tensor_product_plain(tool: RnsTool, a_q, a_b, b_q, b_b):
    """The plain PyTorch version of :func:`tensor_product`."""
    return _dyadic(a_q, b_q, tool.limbs_q), _dyadic(a_b, b_b, tool.limbs_bsk)


def _row_strides(a_lead, b_lead):
    """The product's leading shape, and its ciphertexts as outer × inner
    rows: ciphertext o · inner + i of the product is ciphertext o · s + i of
    an operand, s = inner where the operand has the outer axes and 0 where
    it is broadcast over them (the selection ciphertexts every prefix
    shares).  (lead, None) for a broadcast of another form."""
    lead = tuple(torch.broadcast_shapes(a_lead, b_lead))
    shapes = [(1,) * (len(lead) - len(s)) + tuple(s) for s in (a_lead, b_lead)]
    split = len(lead)
    while split > 0 and all(s[split - 1] == lead[split - 1] for s in shapes):
        split -= 1
    inner = math.prod(lead[split:])
    strides = []
    for s in shapes:
        if s[:split] == lead[:split]:
            strides.append(inner)
        elif set(s[:split]) == {1}:
            strides.append(0)
        else:
            return lead, None
    return lead, (math.prod(lead[:split]), inner, *strides)


def tensor_product_cuda(tool: RnsTool, a_q, a_b, b_q, b_b):
    """Kernel G2 (``pir_behz_tensor``): every limb of both bases in one
    launch; an operand broadcast over leading axes is read through stride 0,
    not copied."""
    for name, x in (("a_q", a_q), ("a_b", a_b), ("b_q", b_q), ("b_b", b_b)):
        kernels.require_cuda(x, name, "G")
    k, n = a_q.shape[-2:]
    table = tool.kernel_table
    _check_limbs(tool, k, table, a_q)
    for x_q, x_b in ((a_q, a_b), (b_q, b_b)):
        if (x_q.shape[-3:] != (2, k, n) or x_b.shape[-3:] != (2, k + 1, n)
                or x_q.shape[:-3] != x_b.shape[:-3]):
            raise ValueError(f"kernel G2 takes [..., 2, {k}, {n}] over q and [..., 2, {k + 1}, "
                             f"{n}] over Bsk, got {tuple(x_q.shape)} and {tuple(x_b.shape)}")
    lead, rows = _row_strides(a_q.shape[:-3], b_q.shape[:-3])
    ops = [x.contiguous() for x in (a_q, a_b, b_q, b_b)]
    if rows is None:  # a broadcast two strides do not express: copy it out
        ops = [x.expand(*lead, *x.shape[-3:]).contiguous() for x in ops]
        rows = (1, math.prod(lead), 0, 0)
    out_q = torch.empty((*lead, 3, k, n), dtype=torch.int64, device=a_q.device)
    out_b = torch.empty((*lead, 3, k + 1, n), dtype=torch.int64, device=a_q.device)
    if out_q.numel() == 0:
        return out_q, out_b
    kernels.BEHZ.launch("pir_behz_tensor", *(x.data_ptr() for x in ops), table.data_ptr(),
                        out_q.data_ptr(), out_b.data_ptr(), *rows, k, n,
                        kernels.stream_handle(a_q))
    return out_q, out_b


# ---------------------------------------------------------------------------
# 3-4. ×t, floor into Bsk and back to base q (kernel G3)
# ---------------------------------------------------------------------------


def floor_sk(tool: RnsTool, prod_q: torch.Tensor, prod_b: torch.Tensor) -> torch.Tensor:
    """floor(t·v/q) of the product v, given in base q (int64[..., k, N])
    and in Bsk (int64[..., k + 1, N]), coefficient form, -> int64[..., k,
    N] in base q."""
    if prod_q.is_cuda:
        return floor_sk_cuda(tool, prod_q, prod_b)
    return floor_sk_plain(tool, prod_q, prod_b)


def floor_sk_plain(tool: RnsTool, prod_q: torch.Tensor, prod_b: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`floor_sk`."""
    lq, lb = tool.limbs_q, tool.limbs_bsk
    floored = tool.fast_floor(tool.t_mod_q.mul(prod_q, lq.q), tool.t_mod_bsk.mul(prod_b, lb.q))
    return tool.fastbconv_sk(floored)


def floor_sk_cuda(tool: RnsTool, prod_q: torch.Tensor, prod_b: torch.Tensor) -> torch.Tensor:
    """Kernel G3 (``pir_behz_floor_sk``)."""
    kernels.require_cuda(prod_q, "prod_q", "G")
    kernels.require_cuda(prod_b, "prod_b", "G")
    k, n = prod_q.shape[-2:]
    table = tool.kernel_table
    _check_limbs(tool, k, table, prod_q)
    if prod_b.shape != (*prod_q.shape[:-2], k + 1, n):
        raise ValueError(f"prod_b must be [..., {k + 1}, {n}] beside prod_q "
                         f"{tuple(prod_q.shape)}, got {tuple(prod_b.shape)}")
    prod_q, prod_b = prod_q.contiguous(), prod_b.contiguous()
    out = torch.empty_like(prod_q)
    rows = math.prod(prod_q.shape[:-2])
    if rows == 0 or n == 0:
        return out
    kernels.BEHZ.launch("pir_behz_floor_sk", prod_q.data_ptr(), prod_b.data_ptr(),
                        table.data_ptr(), out.data_ptr(), rows, k, n,
                        kernels.stream_handle(prod_q))
    return out
