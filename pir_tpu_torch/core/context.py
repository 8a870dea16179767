"""PirContext: precomputed tables for one parameter set on one device.

Port of ``pir_tpu/core/context.py``: NTT twiddle tables per RNS limb,
Barrett/Shoup constants, Galois automorphism and monomial-shift
permutations, key-switching scale-down constants and the plaintext-lift
constants.  A client and a database take their context from
:meth:`PirContext.for_params`, one per (``PirParams``, device) in a process,
as ``pir_tpu``'s do; a server computes with its database's.
"""

from __future__ import annotations

import numpy as np
import torch

from pir_tpu_torch.core.params import EncryptionParams, PirParams
from pir_tpu_torch.ops import modular
from pir_tpu_torch.ops.modular import tensor_u64
from pir_tpu_torch.ops.ntt import NttTables


class PirContext:
    # Set on the per-rank views of a limb-sharded mesh
    # (parallel/sharded.py); the base context is always limb-dense.
    limb_axis_name: "str | None" = None
    ct_limb_offset = 0  # the first ciphertext limb this context owns

    @classmethod
    def for_params(cls, params: PirParams, device=None) -> "PirContext":
        """The shared context of a parameter set on a device (a process-wide
        memo keyed by the params and the resolved device).  A context is
        precomputation only: its tables never change after it is built, and
        what it derives later (``derived``) is a function of the params and
        the device alone, so every client, database and server holding equal
        params on one device can share it."""
        key = (params, modular.resolve_device(device))
        ctx = _CONTEXT_CACHE.get(key)
        if ctx is None:
            ctx = _CONTEXT_CACHE[key] = cls(params, key[1])
        return ctx

    def __init__(self, params: PirParams, device=None):
        self.params = params
        self.device = modular.resolve_device(device)
        self.enc: EncryptionParams = params.encryption_params
        self.enc.validate()

        n = self.enc.poly_modulus_degree
        self.n = n
        self.t = self.enc.plain_modulus

        # RNS chains: key level (QP) and ciphertext level (q).
        self.key_moduli = self.enc.coeff_modulus
        self.ct_moduli = self.enc.ct_modulus
        self.L = len(self.ct_moduli)
        self.Lp = len(self.key_moduli)

        self.ntt_qp = NttTables(self.key_moduli, n, self.device)
        self.ntt_q = self.ntt_qp.slice(self.L)
        self.limbs_qp = self.ntt_qp.limbs
        self.limbs_q = self.ntt_q.limbs

        # q, for plaintext lifting (BFV encrypt).
        self.q_big = self.enc.q

        # Key-switching scale-down constants (only with a special prime).
        self.special = self.enc.special_modulus
        if self.special is not None:
            p = self.special
            p_half = p >> 1
            self.p_half = p_half
            q_col = np.array(self.ct_moduli, dtype=np.uint64).reshape(self.L, 1)
            p_inv = np.array(
                [[pow(p % m, -1, m)] for m in self.ct_moduli], dtype=np.uint64
            )
            self.p_half_mod_q = tensor_u64(
                [[p_half % m] for m in self.ct_moduli], self.device
            )
            self.p_inv_mod_q = tensor_u64(p_inv, self.device)
            self.p_inv_mod_q_shoup = tensor_u64(
                modular.shoup_precompute(p_inv, q_col), self.device
            )

        # tables derived lazily from this context, keyed by the deriving
        # code's own names (permutations here, ops/modswitch.py's constants)
        self.derived: dict = {}

    def take_ct_limbs(self, x: torch.Tensor) -> torch.Tensor:
        """The ciphertext-level limbs this context owns out of a
        key-basis tensor [..., Lp, N]: L of them from ct_limb_offset (a
        limb-shard view's rank slice; 0 and all of them here)."""
        return x[..., self.ct_limb_offset : self.ct_limb_offset + self.L, :]

    # ------------------------------------------------------------------
    # Permutation tables (Galois automorphisms, negacyclic monomial shifts)
    # ------------------------------------------------------------------
    def _signed_permutation(self, key, step) -> "tuple[torch.Tensor, torch.Tensor]":
        hit = self.derived.get(key)
        if hit is None:
            n = self.n
            i = np.arange(n, dtype=np.int64)
            j = step(i) % (2 * n)
            src = np.zeros(n, dtype=np.int64)
            flip = np.zeros(n, dtype=bool)
            dst = j % n
            src[dst] = i
            flip[dst] = j >= n
            hit = (
                torch.from_numpy(src).to(self.device),
                torch.from_numpy(flip).to(self.device),
            )
            self.derived[key] = hit
        return hit

    def galois_permutation(self, galois_elt: int):
        """(src_index[N] int64, flip_sign[N] bool) for x -> x^galois_elt:
        out[dst] = ±in[src] (seal::util::apply_galois semantics)."""
        if galois_elt % 2 == 0:
            raise ValueError("galois element must be odd")
        return self._signed_permutation(
            ("galois", galois_elt), lambda i: i * galois_elt
        )

    def monomial_shift_permutation(self, index: int):
        """(src_index[N], flip_sign[N]) for multiplication by x^index,
        index in [0, 2N) (negacyclic_shift_poly_coeffmod semantics)."""
        index = index % (2 * self.n)
        return self._signed_permutation(("shift", index), lambda i: i + index)

    # ------------------------------------------------------------------
    # Host-side exact CRT (any modulus level — mod-switched cts decrypt
    # at fewer limbs than the context's full L)
    # ------------------------------------------------------------------
    def q_prod(self, level: int) -> int:
        """Product of the first `level` ciphertext moduli."""
        p = 1
        for m in self.ct_moduli[:level]:
            p *= m
        return p

    def _crt_consts(self, level: int):
        hit = self.derived.get(("crt", level))
        if hit is None:
            qbig = self.q_prod(level)
            punctured = [qbig // m for m in self.ct_moduli[:level]]
            inv = [
                pow(punctured[i] % m, -1, m)
                for i, m in enumerate(self.ct_moduli[:level])
            ]
            hit = (qbig, punctured, inv)
            self.derived[("crt", level)] = hit
        return hit

    def crt_lift(self, residues: np.ndarray) -> list[int]:
        """u64[L', N] RNS residues -> per-coefficient big ints in [0, q').

        The modulus level is inferred from the limb axis, so reduced
        (mod-switched) polynomials lift at their own q'.
        """
        residues = np.asarray(residues, dtype=np.uint64)
        level = residues.shape[0]
        qbig, punctured, inv = self._crt_consts(level)
        out = np.zeros(residues.shape[-1], dtype=object)
        for i, m in enumerate(self.ct_moduli[:level]):
            row = residues[i].astype(object)
            out = (out + (row * inv[i]) % m * punctured[i]) % qbig
        return [int(c) for c in out]


# process-wide context memo (see PirContext.for_params)
_CONTEXT_CACHE: "dict[tuple[PirParams, torch.device], PirContext]" = {}
