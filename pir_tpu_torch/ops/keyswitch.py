"""Key switching: the kernel behind Galois automorphisms and relinearization.

Port of ``switch_key``, ``apply_galois`` and ``relinearize`` of
``pir_tpu/ops/keyswitch.py``.
Pipeline for input polynomial c (coefficient form, ciphertext level q):

1. RNS-decompose (:func:`decompose`): digit i is just limb i of c, viewed
   in [0, q_i) and re-reduced modulo every key-level prime — [..., L, Lp,
   N]; apply_galois first applies the Galois permutation to c.
2. Forward NTT over the key chain QP.
3. Inner product with the switch key (:func:`digit_inner_product`):
   acc_k = Σ_i digit_i ⊙ ksk[i, k].
4. Inverse NTT, then exact scale-down by the special prime P with centered
   rounding (:func:`mod_down`): out_j = (acc_j - center(acc mod P)) · P⁻¹
   mod q_j, plus the ciphertext's other polynomials where apply_galois and
   relinearize add them.

Steps 1, 3 and 4 are kernel E's entries (``csrc/keyswitch.cu``) on a CUDA
tensor and their plain PyTorch versions (``*_plain``, the reference the
kernel is tested against) on a CPU tensor; the NTTs are kernel A's.

The whole pipeline is batched over arbitrary leading axes — oblivious
expansion feeds it 2^j ciphertexts at level j in one call.  It runs over
the leading rows a step at a time, each step's digit products at most
SWITCH_CHUNK_BYTES: an unchunked plain-torch switch of 32 ciphertexts at
N=32768 on SEAL's chain holds 74.7 GB of transients, 18.6 times its
products (``memory_peaks.py`` on an NVIDIA H100 80GB HBM3).  Each row is
switched alone, so the steps change no bit of the result.

Limb sharding (parallel/sharded.py): when ``ctx`` is a rank's limb-shard
view (``limb_axis_name`` set), the input carries only this rank's RNS limbs
and the key only the matching decomposition rows; the digit inner
product's sum becomes a local partial plus one ``all_reduce`` over the limb
axis, and the full-basis tail (INTT over QP + P scale-down) runs on every
rank before each keeps its own limbs (``ctx.ct_limb_offset``).
"""

from __future__ import annotations

import math

import torch

from pir_tpu_torch import kernels
from pir_tpu_torch.core.context import PirContext
from pir_tpu_torch.ops import modular, poly, scan_kernel, wide32

SWITCH_CHUNK_BYTES = 1 << 30  # a step's [rows, L, 2, Lp, N] digit products


def inner_product_method(ctx, qp) -> str:
    """Which arithmetic :func:`inner_product_plain` uses for key chain qp:
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


# ---------------------------------------------------------------------------
# 1. decomposition (kernel E1)
# ---------------------------------------------------------------------------


def decompose(ctx, c: torch.Tensor, perm=None) -> torch.Tensor:
    """Digits of c (int64[..., L, N], coefficient form): int64[..., L, Lp,
    N], limb i of c (first permuted by ``perm`` = (src, flip) of
    ``ctx.galois_permutation`` where given) reduced mod every key prime."""
    if c.is_cuda:
        return decompose_cuda(ctx, c, perm)
    return decompose_plain(ctx, c, perm)


def decompose_plain(ctx, c: torch.Tensor, perm=None) -> torch.Tensor:
    """The plain PyTorch version of :func:`decompose`."""
    if perm is not None:
        c = poly.apply_signed_permutation(c, *perm, ctx.limbs_q.q)
    qp = ctx.limbs_qp
    # The input limbs are reduced (< q_i), so when every ct modulus is
    # within a few bits of every key prime the re-reduction is a couple of
    # shift-compare-subtract steps instead of a Barrett multiply.
    ct_bits = max(int(m).bit_length() for m in ctx.ct_moduli)
    k_max = ((1 << ct_bits) - 1) // min(int(m) for m in qp.moduli)
    x = c[..., :, None, :]  # [..., L, 1, N] vs q_col [Lp, 1]
    if k_max <= 4:
        digits = x.expand(*x.shape[:-2], len(qp.moduli), x.shape[-1])
        for i in range(k_max.bit_length() - 1, -1, -1):
            s = qp.q << i
            digits = torch.where(digits >= s, digits - s, digits)
        return digits
    return modular.barrett_reduce_64(x, qp.q, qp.ratio_hi)


def _rows(x: torch.Tensor, L: int, n: int) -> torch.Tensor:
    """x [..., L, N] as [R, L, N] rows whose limbs lie contiguously (rows
    any distance apart, so a polynomial of a ciphertext is read in place)."""
    rows = x.reshape(-1, L, n)
    if rows.stride(-1) != 1 or rows.stride(-2) != n:
        rows = rows.contiguous()
    return rows


def _perm_ptrs(perm, device) -> "tuple[int, int]":
    if perm is None:
        return 0, 0
    src, flip = perm
    if src.device != device or src.dtype != torch.int64 or flip.dtype != torch.bool:
        raise ValueError("the permutation must be int64 src and bool flip on the tensor's device")
    return src.data_ptr(), flip.data_ptr()


def decompose_cuda(ctx, c: torch.Tensor, perm=None) -> torch.Tensor:
    """Kernel E1 (``pir_ks_decompose``) on a CUDA tensor: the output is
    contiguous [..., L, Lp, N], the layout kernel A's forward takes."""
    kernels.require_cuda(c, "c", "E")
    L, n = c.shape[-2:]
    Lp = len(ctx.limbs_qp.moduli)
    if L != len(ctx.limbs_q.moduli):
        raise ValueError(f"c has {L} limbs, the context {len(ctx.limbs_q.moduli)}")
    out = torch.empty((*c.shape[:-2], L, Lp, n), dtype=torch.int64, device=c.device)
    rows = _rows(c, L, n)
    if rows.shape[0] == 0:
        return out
    src, flip = _perm_ptrs(perm, c.device)
    kernels.KEYSWITCH.launch(
        "pir_ks_decompose", rows.data_ptr(), rows.stride(0), src, flip,
        ctx.limbs_q.table.data_ptr(), ctx.limbs_qp.table.data_ptr(), out.data_ptr(),
        rows.shape[0], L, Lp, n, kernels.stream_handle(c))
    return out


# ---------------------------------------------------------------------------
# 3. the digit inner product (kernel E2)
# ---------------------------------------------------------------------------


def digit_inner_product(ctx, digits: torch.Tensor, ksk: torch.Tensor) -> torch.Tensor:
    """acc[k] = Σ_i digits[i] ⊙ ksk[i, k] over the decomposition axis,
    reduced mod every key prime — the key switch's hot contraction.

    digits: int64[..., L, Lp, N] NTT form; ksk: int64[L, 2, Lp, N].
    Returns reduced int64[..., 2, Lp, N], summed over the limb axis on a
    limb-shard view: kernel E2 gives this rank's reduced partial, then one
    ``all_reduce`` and one more reduction (the same words as pir_tpu's
    placement of its psum, since a reduced residue is unique)."""
    if not digits.is_cuda:
        return inner_product_plain(ctx, digits, ksk)
    acc = inner_product_cuda(ctx.limbs_qp, digits, ksk)
    if ctx.limb_axis_name is not None:
        acc = ctx.limbs_qp.reduce(ctx.mesh.all_reduce(acc, ctx.limb_axis_name))
    return acc


def inner_product_plain(ctx, digits: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`digit_inner_product`, in
    pir_tpu's three methods (including the all_reduce over the limb axis on
    a limb-shard view, placed as in pir_tpu: after the sum in the u32 and
    generic branches, after the 96-bit reduction in the 48-bit branch).

    * **u32** — key primes below 2^31 with the whole digit sum below 2^64
      (L·q² < 2^64; the tpu32 profile): one 32×32 product per term, summed
      as plain int64 (u64 bits), one Barrett reduction per output.
    * **48-bit raw** — primes below 2^48 (the SEAL default chain's 36/37-bit
      primes): three-word raw products summed exactly over the digit axis,
      one 96-bit Barrett reduction per output.
    * **generic** — any chain up to 61 bits: a Barrett reduction per
      product, reduced summands summed in u64.
    """
    qp = ctx.limbs_qp
    method = inner_product_method(ctx, qp)
    limb_axis = ctx.limb_axis_name
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


def inner_product_cuda(qp, digits: torch.Tensor, ksk: torch.Tensor) -> torch.Tensor:
    """Kernel E2 (``pir_ks_inner``, the exact wide contraction of
    ``csrc/contract.cuh``): digits [..., L, Lp, N] against ksk [L, 2, Lp, N]
    over key chain qp (LimbConstants), reduced [..., 2, Lp, N], with no
    collective; L digits a reduction where the word path's sums hold them
    (``scan_kernel.contract_chunk``)."""
    kernels.require_cuda(digits, "digits", "E")
    kernels.require_cuda(ksk, "ksk", "E")
    L, Lp, n = digits.shape[-3:]
    if ksk.shape != (L, 2, Lp, n) or len(qp.moduli) != Lp:
        raise ValueError(f"digits [..., {L}, {Lp}, {n}] need a key [{L}, 2, {Lp}, {n}] "
                         f"over {Lp} primes, got {tuple(ksk.shape)} over {len(qp.moduli)}")
    if L * (max(qp.moduli) - 1) ** 2 >= 1 << 127:
        raise ValueError(f"{L} digit products of {max(qp.moduli).bit_length()}-bit primes "
                         "overflow kernel E2's 127-bit sums")
    digits = digits.contiguous()
    ksk = ksk.contiguous()
    out = torch.empty((*digits.shape[:-3], 2, Lp, n), dtype=torch.int64, device=digits.device)
    if out.numel() == 0:
        return out
    scan_kernel.launch_contract(kernels.KEYSWITCH, "pir_ks_inner", digits, ksk, out, qp,
                                min(L, scan_kernel.contract_chunk(qp.moduli)))
    return out


# ---------------------------------------------------------------------------
# 4. scale-down by P (kernel E3)
# ---------------------------------------------------------------------------


def mod_down(ctx, acc: torch.Tensor, addends=(None, None), perm=None,
             out: "torch.Tensor | None" = None) -> torch.Tensor:
    """(acc_j - center(acc mod P)) · P⁻¹ mod q_j for this context's limbs j,
    plus addends[k] (int64[..., L, N], each permuted by ``perm`` where
    given) on output polynomial k: acc int64[..., 2, Lp, N] coefficient
    form -> int64[..., 2, L, N], written into ``out`` when given."""
    if acc.is_cuda:
        return mod_down_cuda(ctx, acc, addends, perm, out)
    res = mod_down_plain(ctx, acc, addends, perm)
    if out is None:
        return res
    out.copy_(res)
    return out


def mod_down_plain(ctx, acc: torch.Tensor, addends=(None, None), perm=None) -> torch.Tensor:
    """The plain PyTorch version of :func:`mod_down`."""
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
    polys = []
    for k, add in enumerate(addends):
        if add is not None and perm is not None:
            add = poly.apply_signed_permutation(add, *perm, lq.q)
        polys.append(out[..., k, :, :] if add is None else modular.add_mod(add, out[..., k, :, :], lq.q))
    return torch.stack(polys, dim=-3)


def mod_down_cuda(ctx, acc: torch.Tensor, addends=(None, None), perm=None,
                  out: "torch.Tensor | None" = None) -> torch.Tensor:
    """Kernel E3 (``pir_ks_moddown``) on a CUDA tensor; ``out``, where
    given, must be a contiguous int64[..., 2, L, N] of acc's rows."""
    kernels.require_cuda(acc, "acc", "E")
    Lp, n = acc.shape[-2:]
    lq = ctx.limbs_q
    L = len(lq.moduli)
    lead = acc.shape[:-3]
    if acc.shape[-3] != 2 or Lp != ctx.Lp:
        raise ValueError(f"acc must be [..., 2, {ctx.Lp}, N], got {tuple(acc.shape)}")
    if out is None:
        out = torch.empty((*lead, 2, L, n), dtype=torch.int64, device=acc.device)
    elif out.shape != (*lead, 2, L, n) or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous [..., 2, {L}, {n}], got {tuple(out.shape)}")
    acc = acc.contiguous()
    R = math.prod(lead)
    if R == 0:
        return out
    rows = []
    for add in addends:
        if add is not None:
            kernels.require_cuda(add, "an addend", "E")
            if add.shape != (*lead, L, n):
                raise ValueError(f"an addend must be [..., {L}, {n}], got {tuple(add.shape)}")
            add = _rows(add, L, n)
        rows.append(add)
    if len({a.stride(0) for a in rows if a is not None}) > 1:  # the kernel takes one stride
        rows = [None if a is None else a.contiguous() for a in rows]
    stride = next((a.stride(0) for a in rows if a is not None), 0)
    src, flip = _perm_ptrs(perm, acc.device)
    kernels.KEYSWITCH.launch(
        "pir_ks_moddown", acc.data_ptr(), lq.table.data_ptr(), ctx.p_half_mod_q.data_ptr(),
        ctx.p_inv_mod_q.data_ptr(), ctx.p_inv_mod_q_shoup.data_ptr(),
        *[0 if a is None else a.data_ptr() for a in rows], stride, src, flip, out.data_ptr(),
        R, L, Lp, ctx.ct_limb_offset, n, int(ctx.special), ctx.p_half,
        kernels.stream_handle(acc))
    return out


# ---------------------------------------------------------------------------
# the switch
# ---------------------------------------------------------------------------


def _switch(ctx: PirContext, ksk: torch.Tensor, c: torch.Tensor, addends=(None, None),
            perm=None) -> torch.Tensor:
    """Key-switch c (int64[..., L, N] coeff form, permuted by ``perm`` where
    given) with ksk, adding addends[k] (shaped like c, permuted alike) to
    output polynomial k: int64[..., 2, L, N].  The leading rows go
    SWITCH_CHUNK_BYTES of digit products at a time, each step writing its
    rows of the output."""
    lead = c.shape[:-2]
    L, n = c.shape[-2:]
    rows = math.prod(lead)
    step = max(1, SWITCH_CHUNK_BYTES // (L * 2 * ksk.shape[-2] * n * 8))
    c = c.reshape(rows, L, n)
    addends = [None if a is None else a.reshape(rows, L, n) for a in addends]
    out = torch.empty((rows, 2, L, n), dtype=torch.int64, device=c.device)
    for r0 in range(0, rows, step):
        part = slice(r0, r0 + step)
        digits = ctx.ntt_qp.forward(decompose(ctx, c[part], perm))
        acc = ctx.ntt_qp.inverse(digit_inner_product(ctx, digits, ksk))
        del digits
        mod_down(ctx, acc, [None if a is None else a[part] for a in addends], perm,
                 out=out[part])
    return out.reshape(*lead, 2, L, n)


def switch_key(ctx: PirContext, ksk: torch.Tensor, c: torch.Tensor):
    """Key-switch c (int64[..., L, N] coeff form) with the switch key
    ksk (int64[L, 2, Lp, N]) -> (out0, out1), each shaped like c.

    Adding (out0, out1) to a ciphertext replaces a term c·t_key with its
    encryption under s, where t_key is the switch key's target.  The
    leading rows go SWITCH_CHUNK_BYTES of digit products at a time.
    """
    out = _switch(ctx, ksk, c)
    return out[..., 0, :, :], out[..., 1, :, :]


def apply_galois(ctx: PirContext, galois_keys, ct: torch.Tensor, galois_elt: int):
    """Substitution operator x -> x^galois_elt on a ciphertext.

    ct: int64[..., 2, L, N] coefficient form; galois_keys maps an element to
    its switch key, an int64[L, 2, Lp, N] tensor.  The permuted c1 is
    switched and the permuted c0 added to the first output polynomial.
    """
    return _switch(ctx, galois_keys[galois_elt], ct[..., 1, :, :], (ct[..., 0, :, :], None),
                   ctx.galois_permutation(galois_elt))


def relinearize(ctx: PirContext, relin_key: torch.Tensor, ct3: torch.Tensor) -> torch.Tensor:
    """Size-3 -> size-2 ciphertext with the s² switch key.

    ct3: int64[..., 3, L, N] coefficient form (a ct×ct product);
    relin_key: the key's int64[L, 2, Lp, N] tensor (``RelinKeys.key.data``)."""
    return _switch(ctx, relin_key, ct3[..., 2, :, :], (ct3[..., 0, :, :], ct3[..., 1, :, :]))
