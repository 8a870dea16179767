"""pir_tpu_torch.ops.modular and .wide32 against pir_tpu's originals: the
same numpy inputs, made from a seed, give equal u64 results (tolerance 0 —
all of this is integer arithmetic), at moduli of 20 to 61 bits."""

import numpy as np
import jax.numpy as jnp
import pytest

from pir_tpu.core import primes
from pir_tpu.ops import modular as jm
from pir_tpu.ops import wide32 as jw
from pir_tpu_torch.ops import modular as tm
from pir_tpu_torch.ops import wide32 as tw

BITS = [20, 31, 36, 48, 61]
SIZE = 4096


def prime(bits):
    return primes.get_prime(128, bits)


def rand(rng, hi, size=SIZE):
    return rng.integers(0, hi, size=size, dtype=np.uint64)


def full64(rng, size=SIZE):
    return rng.integers(0, np.iinfo(np.uint64).max, size=size, dtype=np.uint64,
                        endpoint=True)


def T(x):
    return tm.tensor_u64(x)


def same(port, ref):
    return np.array_equal(tm.numpy_u64(port), np.asarray(ref, dtype=np.uint64))


def test_tensor_round_trip_keeps_bits():
    rng = np.random.default_rng(0)
    x = full64(rng)
    assert np.array_equal(tm.numpy_u64(T(x)), x)
    assert tm.to_i64((1 << 64) - 1) == -1 and tm.to_i64(5) == 5


def test_mul64_wide_and_shifts():
    rng = np.random.default_rng(1)
    x, y = full64(rng), full64(rng)
    jh, jl = jm.mul64_wide(jnp.asarray(x), jnp.asarray(y))
    th, tl = tm.mul64_wide(T(x), T(y))
    assert same(th, jh) and same(tl, jl)
    assert same(tm.shr(T(x), 7), x >> np.uint64(7))
    assert np.array_equal(tm.ult(T(x), T(y)).numpy(), x < y)


@pytest.mark.parametrize("bits", BITS)
def test_barrett_reductions(bits):
    q = prime(bits)
    rng = np.random.default_rng(bits)
    hi, lo = rand(rng, q), full64(rng)
    rh, rl = jm.barrett_ratio(q)
    ref = jm.barrett_reduce_128(
        jnp.asarray(hi), jnp.asarray(lo), np.uint64(q), np.uint64(rh), np.uint64(rl)
    )
    got = tm.barrett_reduce_128(T(hi), T(lo), q, tm.to_i64(rh), tm.to_i64(rl))
    assert same(got, ref)
    truth = [((int(h) << 64) + int(l)) % q for h, l in zip(hi[:64], lo[:64])]
    assert tm.numpy_u64(got)[:64].tolist() == truth
    x = full64(rng)
    ref64 = jm.barrett_reduce_64(jnp.asarray(x), np.uint64(q), np.uint64(rh))
    assert same(tm.barrett_reduce_64(T(x), q, tm.to_i64(rh)), ref64)


@pytest.mark.parametrize("bits", BITS)
def test_reduced_operand_ops(bits):
    q = prime(bits)
    rng = np.random.default_rng(100 + bits)
    x, y = rand(rng, q), rand(rng, q)
    x[:8] = 0
    jx, jy, qq = jnp.asarray(x), jnp.asarray(y), np.uint64(q)
    assert same(tm.add_mod(T(x), T(y), q), jm.add_mod(jx, jy, qq))
    assert same(tm.sub_mod(T(x), T(y), q), jm.sub_mod(jx, jy, qq))
    assert same(tm.neg_mod(T(x), q), jm.neg_mod(jx, qq))
    rh, rl = jm.barrett_ratio(q)
    ref = jm.mul_mod(jx, jy, qq, np.uint64(rh), np.uint64(rl))
    assert same(tm.mul_mod(T(x), T(y), q, tm.to_i64(rh), tm.to_i64(rl)), ref)


@pytest.mark.parametrize("bits", BITS)
def test_shoup(bits):
    q = prime(bits)
    rng = np.random.default_rng(200 + bits)
    x, w = rand(rng, q), rand(rng, q)
    ws = jm.shoup_precompute(w, q)
    assert np.array_equal(tm.shoup_precompute(w, q), ws)
    ref = jm.mul_mod_shoup(jnp.asarray(x), jnp.asarray(w), jnp.asarray(ws), np.uint64(q))
    assert same(tm.mul_mod_shoup(T(x), T(w), T(ws), q), ref)
    rh, rl = jm.barrett_ratio(q)
    dev = tm.shoup_precompute_device(T(w), q, tm.to_i64(rh), tm.to_i64(rl))
    assert np.array_equal(tm.numpy_u64(dev), ws)


def test_limb_constants():
    moduli = [prime(b) for b in (20, 36, 48, 61)]
    jl = jm.LimbConstants(moduli)
    tl = tm.LimbConstants(moduli)
    assert same(tl.q, jl.q) and same(tl.ratio_hi, jl.ratio_hi)
    assert same(tl.ratio_lo, jl.ratio_lo)
    assert tl.slice(2).moduli == jl.slice(2).moduli
    rng = np.random.default_rng(3)
    x = np.stack([rand(rng, q, 256) for q in moduli])
    y = np.stack([rand(rng, q, 256) for q in moduli])
    for op in ("add", "sub", "mul"):
        ref = getattr(jl, op)(jnp.asarray(x), jnp.asarray(y))
        assert same(getattr(tl, op)(T(x), T(y)), ref), op
    assert same(tl.neg(T(x)), jl.neg(jnp.asarray(x)))
    z = full64(rng, (4, 256))
    assert same(tl.reduce(T(z)), jl.reduce(jnp.asarray(z)))


@pytest.mark.parametrize("bits", [20, 36, 40, 46])
def test_wide32_raw_products_and_sums(bits):
    q = prime(bits)
    rng = np.random.default_rng(300 + bits)
    D = min(300, 1 << (96 - 2 * bits))  # the exactness bound of the raw sum
    x, w = rand(rng, q, (D, 64)), rand(rng, q, (D, 64))
    xh, xl = jw.split_u64(jnp.asarray(x))
    wh, wl = jw.split_u64(jnp.asarray(w))
    jp = jw.mul_u48_3w(xh, xl, wh, wl)
    txh, txl = tw.split_u64(T(x))
    twh, twl = tw.split_u64(T(w))
    tp = tw.mul_u48_3w(txh, txl, twh, twl)
    for a, b in zip(tp, jp):
        assert np.array_equal(a.numpy(), np.asarray(b).astype(np.int64))
    js = jw.sum96_over_axis(*jp, axis=0, p2_max_bits=max(0, 2 * bits - 64))
    ts = tw.sum96_over_axis(*tp, axis=0)
    for a, b in zip(ts, js):
        assert np.array_equal(a.numpy(), np.asarray(b).astype(np.int64))
    rh, rl = jm.barrett_ratio(q)
    jr = jw.join_u64(*jw.barrett_reduce96(*js, q, rh, rl))
    tr = tw.join_u64(*tw.barrett_reduce96(*ts, q, tm.to_i64(rh), tm.to_i64(rl)))
    assert same(tr, jr)
    truth = [sum(int(a) * int(b) for a, b in zip(x[:, c], w[:, c])) % q for c in range(8)]
    assert tm.numpy_u64(tr)[:8].tolist() == truth


def test_wide32_word_helpers():
    rng = np.random.default_rng(4)
    a = rng.integers(0, 1 << 32, 512, dtype=np.uint64)
    b = rng.integers(0, 1 << 32, 512, dtype=np.uint64)
    jh, jl = jw.mul32_wide(jnp.asarray(a.astype(np.uint32)), jnp.asarray(b.astype(np.uint32)))
    th, tl = tw.mul32_wide(T(a), T(b))
    assert np.array_equal(th.numpy(), np.asarray(jh).astype(np.int64))
    assert np.array_equal(tl.numpy(), np.asarray(jl).astype(np.int64))
    x = full64(rng, 512)
    assert same(tw.join_u64(*tw.split_u64(T(x))), x)
