"""pir_tpu's public evaluator and expansion helpers in the port, against
pir_tpu on the same numpy inputs: bfv/evaluator.py's add_ct, ct_to_ntt,
ct_from_ntt, multiply_plain_ntt and multiply_scalar_mod_t;
bfv/encrypt.py's encrypt_zero (the same numpy generator, the same words);
ops/expand.py's expand_single_batch and expand_query_batch (each lane also
equal to the port's expand_single / expand_query).  Tolerance 0."""

import numpy as np
import jax.numpy as jnp
import pytest

from pir_tpu.bfv import encrypt as jenc
from pir_tpu.bfv import evaluator as jev
from pir_tpu.ops import expand as jexpand
from pir_tpu.testing.fixtures import make_toolkit
from pir_tpu.testing.params import tiny_pir_params
from pir_tpu_torch import convert
from pir_tpu_torch.bfv import encrypt as tenc
from pir_tpu_torch.bfv import evaluator as tev
from pir_tpu_torch.bfv import keys as keys_mod
from pir_tpu_torch.core.context import PirContext as TCtx
from pir_tpu_torch.ops import expand as texpand
from pir_tpu_torch.ops.modular import numpy_u64, tensor_u64

# the key switch's three inner-product branches, as in test_torch_expand.py
CHAINS = [(26, 27, 28), (34, 36, 37), (50, 52, 54)]


@pytest.fixture(scope="module", params=CHAINS, ids=lambda b: "q" + "-".join(map(str, b)))
def setup(request):
    params = tiny_pir_params(dbsize=40, bytes_per_item=8, dimensions=2, n=64,
                             q_bits=request.param)
    tk = make_toolkit(params, seed=23)
    keys = {e: np.asarray(k.data) for e, k in tk.galois.keys.items()}
    return tk, TCtx(params, "cpu"), keys, convert.galois_keys_from_numpy(keys)


def residues(rng, moduli, shape_before, n):
    """u64[*shape_before, L, n] uniform below each limb's modulus."""
    out = np.zeros((*shape_before, len(moduli), n), dtype=np.uint64)
    for li, q in enumerate(moduli):
        out[..., li, :] = rng.integers(0, q, size=(*shape_before, n), dtype=np.uint64)
    return out


def same(got, want):
    return np.array_equal(numpy_u64(got), np.asarray(want))


def test_add_ct(setup):
    tk, tctx, _, _ = setup
    rng = np.random.default_rng(1)
    a, b = (residues(rng, tk.ctx.ct_moduli, (3, 2), tk.ctx.n) for _ in range(2))
    assert same(tev.add_ct(tctx, tensor_u64(a), tensor_u64(b)),
                jev.add_ct(tk.ctx, jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("name", ["ct_to_ntt", "ct_from_ntt"])
def test_ntt_form_conversions(setup, name):
    tk, tctx, _, _ = setup
    ct = residues(np.random.default_rng(2), tk.ctx.ct_moduli, (4, 2), tk.ctx.n)
    got = getattr(tev, name)(tctx, tensor_u64(ct))
    assert same(got, getattr(jev, name)(tk.ctx, jnp.asarray(ct)))
    back = tev.ct_from_ntt if name == "ct_to_ntt" else tev.ct_to_ntt
    assert np.array_equal(numpy_u64(back(tctx, got)), ct)


def test_multiply_plain_ntt_broadcasts_over_size(setup):
    tk, tctx, _, _ = setup
    rng = np.random.default_rng(3)
    ct = residues(rng, tk.ctx.ct_moduli, (5, 2), tk.ctx.n)  # [5, size 2, L, N]
    pt = residues(rng, tk.ctx.ct_moduli, (5,), tk.ctx.n)  # [5, L, N]
    assert same(tev.multiply_plain_ntt(tctx, tensor_u64(ct), tensor_u64(pt)),
                jev.multiply_plain_ntt(tk.ctx, jnp.asarray(ct), jnp.asarray(pt)))


@pytest.mark.parametrize("scalar", [0, 1, 12345, -7, 1 << 40])
def test_multiply_scalar_mod_t(setup, scalar):
    tk, tctx, _, _ = setup
    pt = np.random.default_rng(4).integers(0, tk.ctx.t, size=(3, tk.ctx.n), dtype=np.uint64)
    got = tev.multiply_scalar_mod_t(tctx, pt, scalar)
    assert got.dtype == np.uint64
    assert np.array_equal(got, jev.multiply_scalar_mod_t(tk.ctx, pt, scalar))


def test_encrypt_zero_same_generator_same_words(setup):
    """The port's keys from make_toolkit's seed are pir_tpu's; encrypt_zero
    from one generator state gives pir_tpu's words, which decrypt to 0."""
    tk, tctx, _, _ = setup
    rng = np.random.default_rng(23)
    sk = keys_mod.gen_secret_key(tctx, rng)
    pk = keys_mod.gen_public_key(tctx, sk, rng)
    assert same(pk.data, tk.pk.data)
    got = tenc.encrypt_zero(tctx, pk, np.random.default_rng(77))
    assert same(got, jenc.encrypt_zero(tk.ctx, tk.pk, np.random.default_rng(77)))
    assert not tenc.decrypt(tctx, sk, got).any()


@pytest.mark.parametrize("num_items", [0, 1, 5, 64])
def test_expand_single_batch(setup, num_items):
    tk, tctx, keys, tkeys = setup
    cts = residues(np.random.default_rng(num_items), tk.ctx.ct_moduli, (3, 2), tk.ctx.n)
    got = texpand.expand_single_batch(tctx, tkeys, tensor_u64(cts), num_items)
    want = jexpand.expand_single_batch(
        tk.ctx, {e: jnp.asarray(v) for e, v in keys.items()}, jnp.asarray(cts), num_items)
    assert tuple(got.shape) == (3, num_items, 2, tk.ctx.L, tk.ctx.n)
    assert same(got, want)
    for q in range(3):
        lane = texpand.expand_single(tctx, tkeys, tensor_u64(cts[q]), num_items)
        assert np.array_equal(numpy_u64(got[q]), numpy_u64(lane))


@pytest.mark.parametrize("total", [70, 128, 130])
def test_expand_query_batch(setup, total):
    """Queries of 2 and 3 ciphertexts (130 = 2·64 + 2; 128 has the
    degenerate empty last ciphertext)."""
    tk, tctx, keys, tkeys = setup
    k = total // tk.ctx.n + 1
    cts = residues(np.random.default_rng(total), tk.ctx.ct_moduli, (2, k, 2), tk.ctx.n)
    got = texpand.expand_query_batch(tctx, tkeys, tensor_u64(cts), total)
    want = jexpand.expand_query_batch(
        tk.ctx, {e: jnp.asarray(v) for e, v in keys.items()}, jnp.asarray(cts), total)
    assert same(got, want)
    for q in range(2):
        lane = texpand.expand_query(tctx, tkeys, tensor_u64(cts[q]), total)
        assert np.array_equal(numpy_u64(got[q]), numpy_u64(lane))
    with pytest.raises(ValueError, match="number of ciphertexts"):
        texpand.expand_query_batch(tctx, tkeys, tensor_u64(cts[:, :1]), total + tk.ctx.n)
