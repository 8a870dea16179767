"""RNS base conversion for BFV ciphertext multiplication (BEHZ).

Port of ``pir_tpu/core/rns.py``: the BEHZ16 full-RNS BFV multiply (the one
SEAL 3.5 implements) needs

* an auxiliary base **Bsk** = {b_1..b_k, m_sk} of 60-bit NTT-friendly
  primes, large enough that prod(B) exceeds the tensor product's magnitude;
* **m_tilde = 2^32**, the Montgomery factor that makes the q -> Bsk fast
  base conversion exact (the "small Montgomery reduction" removes the α·q
  overshoot);
* **fast_floor**: floor(t·x/q) in Bsk, additive error at most k;
* **fastbconv_sk** (Shenoy–Kumaresan): the exact conversion back to base q
  through the redundant m_sk limb.

Every per-limb constant is computed on the host with the original's numpy
and Python-int code, so it is bit-equal to ``pir_tpu``'s, and lives on the
tool's device as an int64 column [k, 1] (u64 bits) beside its Shoup
companion.  The conversions are plain PyTorch on int64 tensors; their
forward and inverse NTTs over Bsk are kernel A on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from pir_tpu_torch.core import primes as primes_mod
from pir_tpu_torch.ops import modular, scan_kernel
from pir_tpu_torch.ops.modular import tensor_u64, to_i64
from pir_tpu_torch.ops.ntt import NttTables

_M_TILDE_BITS = 32
_M_TILDE = 1 << _M_TILDE_BITS
_M_TILDE_MASK = _M_TILDE - 1


def _reduced_sum(prod, q, ratio_hi, bits: int):
    """Σ over axis -2 of reduced products below 2^bits, mod q: 2^(63 - bits)
    summands at a time stay below 2^63 (16 60-bit words would already wrap
    u64), each chunk reduced by Barrett and the chunks added mod q."""
    rows = prod.shape[-2]
    return scan_kernel.sum_row_chunks(
        lambda s, e: modular.barrett_reduce_64(prod[..., s:e, :].sum(dim=-2), q, ratio_hi),
        rows, 1 << (63 - bits), q,
    )


def _mod_cols(value: int, moduli) -> np.ndarray:
    """Big int reduced mod each modulus -> u64[L, 1] broadcast column."""
    return np.array([[value % int(m)] for m in moduli], dtype=np.uint64)


class _Const:
    """A constant column u64[k, 1] on the device, with its Shoup companion
    for the moduli it multiplies under."""

    def __init__(self, w: np.ndarray, moduli, device):
        q_col = np.array(moduli, dtype=np.uint64).reshape(-1, 1)
        self.w = tensor_u64(w, device)
        self.shoup = tensor_u64(modular.shoup_precompute(w, q_col), device)

    def mul(self, x, q):
        """x * w mod q, x reduced."""
        return modular.mul_mod_shoup(x, self.w, self.shoup, q)


class RnsTool:
    def __init__(self, ct_moduli, n: int, t: int, aux_bits: int = 60, device=None):
        self.q_moduli = tuple(int(m) for m in ct_moduli)
        self.n = n
        self.t = t
        k = len(self.q_moduli)
        self.q = 1
        for m in self.q_moduli:
            self.q *= m

        # Auxiliary primes, as pir_tpu picks them: k primes of aux_bits for B
        # plus one m_sk, none of them a ciphertext prime.
        need = k + 1
        pool = primes_mod.get_primes(2 * n, aux_bits, need + k)
        taken = [p for p in pool if p not in self.q_moduli][:need]
        self.b_moduli = tuple(taken[:k])
        self.m_sk = taken[k]
        self.bsk_moduli = self.b_moduli + (self.m_sk,)
        self.prod_b = 1
        for m in self.b_moduli:
            self.prod_b *= m

        self.limbs_q = modular.LimbConstants(self.q_moduli, device)
        self.device = self.limbs_q.device
        self.limbs_bsk = modular.LimbConstants(self.bsk_moduli, self.device)
        self.limbs_b = self.limbs_bsk.slice(k)
        self.ntt_bsk = NttTables(self.bsk_moduli, n, self.device)
        dev = self.device

        # ---- FastBConv q -> Bsk and -> m_tilde constants --------------
        punct_q = [self.q // m for m in self.q_moduli]
        self.inv_punct_q = _Const(
            np.array([[pow(punct_q[i] % m, -1, m)] for i, m in enumerate(self.q_moduli)],
                     dtype=np.uint64),
            self.q_moduli, dev,
        )  # [k, 1]
        # punct_q[i] mod each modulus of Bsk: [k_bsk, k]
        self.punct_q_mod_bsk = tensor_u64(
            np.array([[p % m for p in punct_q] for m in self.bsk_moduli], dtype=np.uint64), dev
        )
        self.punct_q_mod_mtilde = tensor_u64(
            np.array([[p % _M_TILDE] for p in punct_q], dtype=np.uint64), dev
        )  # [k, 1]
        self.m_tilde_mod_q = _Const(_mod_cols(_M_TILDE, self.q_moduli), self.q_moduli, dev)

        # ---- sm_mrq constants -----------------------------------------
        self.neg_inv_q_mod_mtilde = (-pow(self.q % _M_TILDE, -1, _M_TILDE)) % _M_TILDE
        self.prod_q_mod_bsk = tensor_u64(_mod_cols(self.q, self.bsk_moduli), dev)
        self.prod_q_mtilde_mod_bsk = tensor_u64(_mod_cols(self.q * _M_TILDE, self.bsk_moduli), dev)
        self.inv_mtilde_mod_bsk = _Const(
            np.array([[pow(_M_TILDE % m, -1, m)] for m in self.bsk_moduli], dtype=np.uint64),
            self.bsk_moduli, dev,
        )
        self.m_tilde_half = _M_TILDE // 2

        # ---- fast_floor constants -------------------------------------
        self.inv_q_mod_bsk = _Const(
            np.array([[pow(self.q % m, -1, m)] for m in self.bsk_moduli], dtype=np.uint64),
            self.bsk_moduli, dev,
        )

        # ---- fastbconv_sk constants -----------------------------------
        punct_b = [self.prod_b // m for m in self.b_moduli]
        self.inv_punct_b = _Const(
            np.array([[pow(punct_b[i] % m, -1, m)] for i, m in enumerate(self.b_moduli)],
                     dtype=np.uint64),
            self.b_moduli, dev,
        )
        self.punct_b_mod_q = tensor_u64(
            np.array([[p % m for p in punct_b] for m in self.q_moduli], dtype=np.uint64), dev
        )  # [k_q, k_b]
        self.punct_b_mod_msk = tensor_u64(
            np.array([[p % self.m_sk] for p in punct_b], dtype=np.uint64), dev
        )  # [k_b, 1]
        self.inv_prod_b_mod_msk = pow(self.prod_b % self.m_sk, -1, self.m_sk)
        self.prod_b_mod_q = tensor_u64(_mod_cols(self.prod_b, self.q_moduli), dev)
        self.prod_b_msk_mod_q = tensor_u64(_mod_cols(self.prod_b * self.m_sk, self.q_moduli), dev)
        self.m_sk_half = self.m_sk // 2
        hi, lo = modular.barrett_ratio(self.m_sk)
        self.msk_ratio = (to_i64(hi), to_i64(lo))

        # plain-scaling constants (t mod each modulus)
        self.t_mod_q = _Const(_mod_cols(t, self.q_moduli), self.q_moduli, dev)
        self.t_mod_bsk = _Const(_mod_cols(t, self.bsk_moduli), self.bsk_moduli, dev)

    # ------------------------------------------------------------------
    @staticmethod
    def _sum_conv(y, punct_mod_tgt, tgt):
        """Σ_i y_i · punct_i mod each target modulus: y [..., k_src, N]
        (already times inv_punct), punct_mod_tgt [k_tgt, k_src] ->
        [..., k_tgt, N] == (x + α·prod_src) mod target, α ≤ k_src."""
        prod = modular.mul_mod(
            y[..., None, :, :],
            punct_mod_tgt[:, :, None],
            tgt.q[..., None],
            tgt.ratio_hi[..., None],
            tgt.ratio_lo[..., None],
        )  # [..., k_tgt, k_src, N]
        bits = max(int(q).bit_length() for q in tgt.moduli)
        return _reduced_sum(prod, tgt.q, tgt.ratio_hi, bits)

    # ------------------------------------------------------------------
    def fastbconv_m_tilde_sm_mrq(self, x_q: torch.Tensor) -> torch.Tensor:
        """Exact conversion x (base q) -> base Bsk via the m_tilde trick.

        x_q: int64[..., k_q, N] -> int64[..., k_bsk, N], exactly ≡ x mod
        each b."""
        lq, lb = self.limbs_q, self.limbs_bsk
        xm = self.m_tilde_mod_q.mul(x_q, lq.q)  # x · m_tilde mod q
        y = self.inv_punct_q.mul(xm, lq.q)
        conv_bsk = self._sum_conv(y, self.punct_q_mod_bsk, lb)
        # m_tilde target: a power-of-two modulus, plain masked arithmetic
        # (the products' low words wrap as u64 products do)
        conv_mt = (y * self.punct_q_mod_mtilde & _M_TILDE_MASK).sum(dim=-2) & _M_TILDE_MASK
        # small Montgomery reduction: r = -conv_mt / q mod m_tilde, centered
        r = (conv_mt * self.neg_inv_q_mod_mtilde) & _M_TILDE_MASK
        r_b = r[..., None, :].expand(conv_bsk.shape)
        corr = modular.mul_mod(r_b, self.prod_q_mod_bsk, lb.q, lb.ratio_hi, lb.ratio_lo)
        # center r: subtract q·m_tilde where r >= m_tilde/2
        corr = torch.where(
            r_b >= self.m_tilde_half,
            modular.sub_mod(corr, self.prod_q_mtilde_mod_bsk, lb.q),
            corr,
        )
        return self.inv_mtilde_mod_bsk.mul(modular.add_mod(conv_bsk, corr, lb.q), lb.q)

    # ------------------------------------------------------------------
    def fast_floor(self, tx_q: torch.Tensor, tx_bsk: torch.Tensor) -> torch.Tensor:
        """floor(x·t/q) in base Bsk (error ≤ k_q), inputs already ×t."""
        lb = self.limbs_bsk
        conv = self._sum_conv(self.inv_punct_q.mul(tx_q, self.limbs_q.q), self.punct_q_mod_bsk, lb)
        return self.inv_q_mod_bsk.mul(modular.sub_mod(tx_bsk, conv, lb.q), lb.q)

    # ------------------------------------------------------------------
    def fastbconv_sk(self, x_bsk: torch.Tensor) -> torch.Tensor:
        """Exact conversion base Bsk -> base q (Shenoy–Kumaresan)."""
        kb = len(self.b_moduli)
        x_b = x_bsk[..., :kb, :]
        x_msk = x_bsk[..., kb, :]
        lq = self.limbs_q
        y = self.inv_punct_b.mul(x_b, self.limbs_b.q)
        conv_q = self._sum_conv(y, self.punct_b_mod_q, lq)
        # α = (conv_msk - x_msk) / prod_B mod m_sk, centered
        msk = self.m_sk
        msk_hi, msk_lo = self.msk_ratio
        prod = modular.mul_mod(y, self.punct_b_mod_msk, msk, msk_hi, msk_lo)
        conv_msk = _reduced_sum(prod, msk, msk_hi, msk.bit_length())
        alpha = modular.mul_mod(
            modular.sub_mod(conv_msk, x_msk, msk), self.inv_prod_b_mod_msk, msk, msk_hi, msk_lo
        )  # [..., N]
        alpha_q = alpha[..., None, :].expand(conv_q.shape)
        corr = modular.mul_mod(
            modular.barrett_reduce_64(alpha_q, lq.q, lq.ratio_hi),
            self.prod_b_mod_q, lq.q, lq.ratio_hi, lq.ratio_lo,
        )
        out = modular.sub_mod(conv_q, corr, lq.q)
        # centering: where α >= m_sk/2 the subtraction above used α where
        # α - m_sk was meant; add prod_B·m_sk back on those lanes
        return torch.where(
            alpha_q >= self.m_sk_half, modular.add_mod(out, self.prod_b_msk_mod_q, lq.q), out
        )
