"""BFV keys, encryption and decryption for the benchmark's own client.

Frozen from ``pir_tpu_torch/bfv/sampling.py``, ``bfv/keys.py`` and
``bfv/encrypt.py`` (native keys only: no SEAL seeds), with imports
rewritten and two changes that keep the arithmetic and make it batched:
encryption takes a stack of plaintexts at once (the plaintext lift from a
table of its distinct values), and decryption's scale-and-round works on a
whole stack of ciphertexts — sum_i y_i * t / q_i in float64 with
y_i = x_i * (q/q_i)^-1 mod q_i, which differs from round(t * x / q) by a
multiple of t, every coefficient within 2^-20 of a rounding edge done
again exactly in Python integers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.reference.arith import Ntt, barrett_ratio, mul_mod, tensor_u64, to_i64
from portbench.reference.params import Params

_CBD_K = 21  # centered binomial error, sigma ~ 3.2
_EDGE = 2.0 ** -20  # distance from a rounding edge below which decryption recomputes exactly


def ternary(rng: np.random.Generator, shape) -> np.ndarray:
    return rng.integers(-1, 2, size=shape, dtype=np.int64)


def error(rng: np.random.Generator, shape) -> np.ndarray:
    a = rng.binomial(_CBD_K, 0.5, size=shape).astype(np.int64)
    return a - rng.binomial(_CBD_K, 0.5, size=shape).astype(np.int64)


def uniform(rng: np.random.Generator, moduli, shape) -> np.ndarray:
    """Uniform residues u64[..., L, N] (shape excludes the limb axis)."""
    return np.stack([rng.integers(0, q, size=shape, dtype=np.uint64) for q in moduli], axis=-2)


def signed_to_rns(x: np.ndarray, moduli) -> np.ndarray:
    """Signed coefficients [..., N] -> residues u64[..., L, N]."""
    return np.stack([np.mod(x, np.int64(q)).astype(np.uint64) for q in moduli], axis=-2)


class Context:
    """Tables of one parameter set on one device."""

    def __init__(self, params: Params, device):
        self.params = params
        self.device = torch.device(device)
        self.n = params.n
        self.t = params.t
        self.ct_moduli = params.ct_moduli
        self.key_moduli = params.chain
        self.L = params.L
        self.ntt_qp = Ntt(self.key_moduli, self.n, self.device)
        self.ntt_q = self.ntt_qp.slice(self.L)
        self.special = params.chain[-1] if len(params.chain) > 1 else None
        self._ntt_levels = {self.L: self.ntt_q}

    def ntt_level(self, level: int) -> Ntt:
        """Tables of the first `level` ciphertext primes (a mod-switched
        reply decrypts at its own level)."""
        if level not in self._ntt_levels:
            self._ntt_levels[level] = self.ntt_qp.slice(level)
        return self._ntt_levels[level]

    def rns(self, signed: np.ndarray, moduli) -> torch.Tensor:
        return tensor_u64(signed_to_rns(signed, moduli), self.device)


@dataclasses.dataclass
class Keys:
    s: np.ndarray  # int64[N] in {-1, 0, 1}
    s_ntt_qp: torch.Tensor  # int64[Lp, N]
    pk: torch.Tensor  # int64[2, L, N], NTT form
    galois: dict  # galois_elt -> int64[L, 2, Lp, N], NTT form
    relin: torch.Tensor  # int64[L, 2, Lp, N]


def _kswitch_key(ctx: Context, keys_s_qp: torch.Tensor, target_qp: torch.Tensor,
                 rng: np.random.Generator) -> torch.Tensor:
    """ksk[i] = (-(a_i s + e_i) + P target delta_i, a_i), NTT form over QP."""
    L = ctx.L
    lqp = ctx.ntt_qp.limbs
    a = tensor_u64(uniform(rng, ctx.key_moduli, (L, ctx.n)), ctx.device)
    e = ctx.rns(error(rng, (L, ctx.n)), ctx.key_moduli)
    b = lqp.neg(lqp.add(lqp.mul(a, keys_s_qp), ctx.ntt_qp.forward(e)))
    comps = []
    for i in range(L):
        qi = int(ctx.ct_moduli[i])
        rhi, rlo = barrett_ratio(qi)
        folded = mul_mod(target_qp[i], int(ctx.special) % qi, qi, to_i64(rhi), to_i64(rlo))
        bi = b[i].clone()
        bi[i] = (b[i, i] + folded) % qi
        comps.append(torch.stack([bi, a[i]]))
    return torch.stack(comps)


def automorph_signed(coeffs: np.ndarray, galois_elt: int) -> np.ndarray:
    """x -> x^g on signed coefficients."""
    n = len(coeffs)
    j = (np.arange(n, dtype=np.int64) * galois_elt) % (2 * n)
    out = np.zeros_like(coeffs)
    out[j % n] = np.where(j < n, coeffs, -coeffs)
    return out


def keygen(ctx: Context, elts, rng: np.random.Generator) -> Keys:
    if ctx.special is None:
        raise ValueError("key switching needs a special prime")
    s = ternary(rng, ctx.n)
    s_qp = ctx.ntt_qp.forward(ctx.rns(s, ctx.key_moduli))
    s_q = s_qp[: ctx.L]
    lq = ctx.ntt_q.limbs
    a = tensor_u64(uniform(rng, ctx.ct_moduli, ctx.n), ctx.device)
    e = ctx.rns(error(rng, ctx.n), ctx.ct_moduli)
    pk = torch.stack([lq.neg(lq.add(lq.mul(a, s_q), ctx.ntt_q.forward(e))), a])
    galois = {}
    for elt in elts:
        target = ctx.ntt_qp.forward(ctx.rns(automorph_signed(s, int(elt)), ctx.key_moduli))
        galois[int(elt)] = _kswitch_key(ctx, s_qp, target, rng)
    relin = _kswitch_key(ctx, s_qp, ctx.ntt_qp.limbs.mul(s_qp, s_qp), rng)
    return Keys(s=s, s_ntt_qp=s_qp, pk=pk, galois=galois, relin=relin)


def lift_plaintexts(ctx: Context, m: np.ndarray) -> torch.Tensor:
    """round(q m / t) per coefficient as RNS words int64[..., L, N], from
    a table of the distinct values of m (u64[..., N], mod t)."""
    q = 1
    for p in ctx.ct_moduli:
        q *= p
    values, inverse = np.unique(np.asarray(m, dtype=np.uint64), return_inverse=True)
    table = np.array([[((int(v) * q + ctx.t // 2) // ctx.t) % p for p in ctx.ct_moduli]
                      for v in values], dtype=np.uint64)  # [U, L]
    words = table[inverse.reshape(m.shape)]  # [..., N, L]
    return tensor_u64(np.moveaxis(words, -1, -2), ctx.device)


def encrypt(ctx: Context, keys: Keys, m: np.ndarray, rng: np.random.Generator) -> torch.Tensor:
    """Public-key encryptions of plaintexts u64[B, N] -> int64[B, 2, L, N]."""
    b = m.shape[0]
    lq = ctx.ntt_q.limbs
    u = ctx.ntt_q.forward(ctx.rns(ternary(rng, (b, ctx.n)), ctx.ct_moduli))
    e0 = ctx.rns(error(rng, (b, ctx.n)), ctx.ct_moduli)
    e1 = ctx.rns(error(rng, (b, ctx.n)), ctx.ct_moduli)
    c0 = lq.add(lq.add(ctx.ntt_q.inverse(lq.mul(keys.pk[0], u)), e0), lift_plaintexts(ctx, m))
    c1 = lq.add(ctx.ntt_q.inverse(lq.mul(keys.pk[1], u)), e1)
    return torch.stack([c0, c1], dim=-3)


def phase(ctx: Context, keys: Keys, ct: torch.Tensor) -> torch.Tensor:
    """c0 + c1 s (+ c2 s^2 ...) mod q' of ciphertexts int64[..., size, l, N]
    at their own level l, coefficient form -> int64[..., l, N]."""
    size, level = ct.shape[-3], ct.shape[-2]
    ntt = ctx.ntt_level(level)
    lq = ntt.limbs
    s = keys.s_ntt_qp[:level]
    acc = ct[..., size - 1, :, :]
    for k in range(size - 2, -1, -1):
        acc = lq.add(ntt.inverse(lq.mul(ntt.forward(acc), s)), ct[..., k, :, :])
    return acc


def scale_round(ctx: Context, x: torch.Tensor) -> torch.Tensor:
    """round(t x / q') mod t of phases int64[..., l, N] -> int64[..., N]."""
    level = x.shape[-2]
    moduli = ctx.ct_moduli[:level]
    q = 1
    for p in moduli:
        q *= p
    v = torch.zeros(x.shape[:-2] + x.shape[-1:], dtype=torch.float64, device=x.device)
    for i, qi in enumerate(moduli):
        inv = pow((q // qi) % qi, -1, qi)
        rhi, rlo = barrett_ratio(qi)
        y = mul_mod(x[..., i, :], inv, qi, to_i64(rhi), to_i64(rlo))
        v += y.to(torch.float64) * (ctx.t / qi)
    m = torch.floor(v + 0.5)
    edge = (v - torch.floor(v) - 0.5).abs() < _EDGE
    out = torch.remainder(m.to(torch.int64), ctx.t)
    if bool(edge.any()):
        where = edge.nonzero()
        words = x.movedim(-2, -1)[edge].cpu().tolist()  # [E, l]
        exact = []
        for limbs in words:
            xv = 0
            for i, qi in enumerate(moduli):
                xv += (int(limbs[i]) % qi) * pow((q // qi) % qi, -1, qi) % qi * (q // qi)
            xv %= q
            exact.append(((ctx.t * xv + (q >> 1)) // q) % ctx.t)
        out[tuple(where.t())] = torch.tensor(exact, dtype=torch.int64, device=out.device)
    return out


def decrypt(ctx: Context, keys: Keys, ct: torch.Tensor) -> torch.Tensor:
    """Plaintexts int64[..., N] mod t of ciphertexts int64[..., size, l, N]."""
    return scale_round(ctx, phase(ctx, keys, ct))


def compose(ctx: Context, pts: torch.Tensor) -> torch.Tensor:
    """Digit plaintexts int64[..., 2 * ER, N] -> ciphertexts int64[..., 2,
    L, N]: each limb's word is its digits shifted together (low digit
    first), reduced mod its prime."""
    counts = ctx.params.digit_counts()
    widths = ctx.params.digit_widths()
    er = sum(counts)
    pts = pts.reshape(*pts.shape[:-2], 2, er, ctx.n)
    limbs = []
    k = 0
    for (r, w), q in zip(zip(counts, widths), ctx.ct_moduli):
        acc = torch.zeros_like(pts[..., 0, :])
        for d in range(r):
            acc = acc + (pts[..., k, :] << (d * w))
            k += 1
        limbs.append(torch.remainder(acc, q))
    return torch.stack(limbs, dim=-2)
