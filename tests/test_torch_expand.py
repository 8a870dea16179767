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

# (26, 27, 28): pir_tpu's u32 key-switch branch vs the port's 48-bit branch;
# (34, 36, 37): both 48-bit; (50, 52, 54): both generic (Barrett per product)
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
