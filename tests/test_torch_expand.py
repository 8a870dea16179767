"""pir_tpu_torch.ops.keyswitch and .expand against pir_tpu, with Galois keys
from pir_tpu.testing.fixtures.make_toolkit carried over by
pir_tpu_torch.convert.  Tolerance 0."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pir_tpu.bfv import encrypt as jenc
from pir_tpu.ops import expand as jexpand
from pir_tpu.ops import keyswitch as jks
from pir_tpu.testing.fixtures import make_toolkit
from pir_tpu.testing.params import tiny_pir_params
from pir_tpu_torch import convert
from pir_tpu_torch.core.context import PirContext as TCtx
from pir_tpu_torch.ops import expand as texpand
from pir_tpu_torch.ops import keyswitch as tks
from pir_tpu_torch.ops.modular import numpy_u64, tensor_u64
from pir_tpu_torch.utils.math import next_power_two

# key-switch digit inner product: (26, 27, 28) u32 branch in both packages;
# (34, 36, 37) 48-bit raw; (50, 52, 54) generic (Barrett per product)
CHAINS = [(26, 27, 28), (34, 36, 37), (50, 52, 54)]


@pytest.fixture(scope="module", params=CHAINS, ids=lambda b: "q" + "-".join(map(str, b)))
def setup(request):
    params = tiny_pir_params(dbsize=40, bytes_per_item=8, dimensions=2, n=64,
                             q_bits=request.param)
    tk = make_toolkit(params, seed=31)
    keys = {e: np.asarray(k.data) for e, k in tk.galois.keys.items()}
    return tk, TCtx(params), keys, convert.galois_keys_from_numpy(keys)


def rand_ct(rng, ctx, batch):
    out = np.zeros(batch + (2, ctx.L, ctx.n), dtype=np.uint64)
    for li, q in enumerate(ctx.ct_moduli):
        out[..., li, :] = rng.integers(0, q, size=batch + (2, ctx.n), dtype=np.uint64)
    return out


def test_switch_key(setup):
    tk, tctx, keys, tkeys = setup
    c = rand_ct(np.random.default_rng(1), tk.ctx, (3,))[:, 0]  # [3, L, N]
    k = keys[tk.ctx.n + 1]
    ref = jax.jit(lambda v, kk: jks.switch_key(tk.ctx, kk, v))(jnp.asarray(c), jnp.asarray(k))
    got = tks.switch_key(tctx, tkeys[tk.ctx.n + 1], tensor_u64(c))
    for a, b in zip(got, ref):
        assert np.array_equal(numpy_u64(a), np.asarray(b))


@pytest.mark.parametrize("level", [0, 2, 5])
def test_apply_galois(setup, level):
    tk, tctx, keys, tkeys = setup
    elt = (tk.ctx.n >> level) + 1
    ct = rand_ct(np.random.default_rng(level), tk.ctx, (2,))
    jk = {e: jnp.asarray(v) for e, v in keys.items()}
    ref = jks.apply_galois(tk.ctx, jk, jnp.asarray(ct), elt)
    got = tks.apply_galois(tctx, tkeys, tensor_u64(ct), elt)
    assert np.array_equal(numpy_u64(got), np.asarray(ref))


@pytest.mark.parametrize("num_items", [1, 5, 64])
def test_expand_single(setup, num_items):
    tk, tctx, keys, tkeys = setup
    ctx = tk.ctx
    m = np.zeros(ctx.n, dtype=np.uint64)
    m[num_items - 1] = pow(next_power_two(num_items), -1, ctx.t)
    ct = np.asarray(jenc.encrypt(ctx, tk.pk, m, np.random.default_rng(num_items)))
    jk = {e: jnp.asarray(v) for e, v in keys.items()}
    ref = np.asarray(jexpand.expand_single(ctx, jk, jnp.asarray(ct), num_items))
    got = texpand.expand_single(tctx, tkeys, tensor_u64(ct), num_items)
    assert got.shape == ref.shape
    assert np.array_equal(numpy_u64(got), ref)


def test_expand_query_multi_ct(setup):
    """total_items > N: two query ciphertexts, the second partly used."""
    tk, tctx, keys, tkeys = setup
    ctx = tk.ctx
    cts = rand_ct(np.random.default_rng(5), ctx, (2,))
    jk = {e: jnp.asarray(v) for e, v in keys.items()}
    total = ctx.n + 6
    ref = np.asarray(jexpand.expand_query(ctx, jk, jnp.asarray(cts), total))
    got = texpand.expand_query(tctx, tkeys, tensor_u64(cts), total)
    assert np.array_equal(numpy_u64(got), ref)
    with pytest.raises(ValueError, match="number of ciphertexts"):
        texpand.expand_query(tctx, tkeys, tensor_u64(cts), 3)


@pytest.mark.parametrize("level", [0, 3])
def test_expand_level_axis1_two_trees(setup, level):
    """Batched serving's expansion: Q=2 trees as [Q, B, 2, L, N], axis 1
    doubling, equal to pir_tpu's and to each tree expanded alone."""
    tk, tctx, keys, tkeys = setup
    cts = rand_ct(np.random.default_rng(10 + level), tk.ctx, (2, 3))
    jk = {e: jnp.asarray(v) for e, v in keys.items()}
    ref = np.asarray(jexpand.expand_level(tk.ctx, jk, jnp.asarray(cts), level, axis=1))
    got = texpand.expand_level(tctx, tkeys, tensor_u64(cts), level, axis=1)
    assert got.shape == (2, 6, 2, tctx.L, tctx.n)
    assert np.array_equal(numpy_u64(got), ref)
    for q in range(2):
        alone = texpand.expand_level(tctx, tkeys, tensor_u64(cts[q]), level)
        assert np.array_equal(numpy_u64(alone), ref[q])


def test_digit_inner_product_branch(setup):
    """The key switch's inner product against pir_tpu's on NTT-form digits,
    and the branch each chain takes (u32 at the ≤31-bit chain)."""
    tk, tctx, keys, tkeys = setup
    bits = max(int(q).bit_length() for q in tctx.key_moduli)
    want = "u32" if bits <= 31 else "48-bit" if bits <= 48 else "generic"
    assert tks.inner_product_method(tctx, tctx.limbs_qp) == want
    rng = np.random.default_rng(bits)
    digits = np.zeros((2, tctx.L, tctx.Lp, tctx.n), dtype=np.uint64)
    for k, q in enumerate(tctx.key_moduli):
        digits[..., k, :] = rng.integers(0, q, size=(2, tctx.L, tctx.n), dtype=np.uint64)
    jc = tk.ctx
    ksk = keys[tk.ctx.n + 1]
    ref = jks._digit_inner_product(jc, jnp.asarray(digits), jnp.asarray(ksk), jc.limbs_qp)
    got = tks._digit_inner_product(
        tctx, tensor_u64(digits), tkeys[tk.ctx.n + 1], tctx.limbs_qp
    )
    assert np.array_equal(numpy_u64(got), np.asarray(ref))
