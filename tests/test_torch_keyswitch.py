"""The key switch's plain pieces — decompose (kernel E1's function),
inner_product_plain (E2's), mod_down_plain (E3's) and expand.combine_plain
(E4's) — against pir_tpu's code on the same numpy inputs, under each of
pir_tpu's inner-product methods ("u32" at a tpu32-like chain, "48-bit" at
SEAL's 36/37-bit one, "generic" at a 60-bit one); and switch_key,
apply_galois, relinearize and expand_level with the key switch forced to
one row a step.  pir_tpu has no function of its own for E1, E3 and E4: their
expected words come from its switch_key's steps (its galois_transform and
the decomposition of its step 1; its digit inner product and transforms;
its apply_galois, relinearize and expand_level).  Tolerance 0."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pir_tpu.ops import expand as jexpand
from pir_tpu.ops import keyswitch as jks
from pir_tpu.ops import modular as jmod
from pir_tpu.ops import poly as jpoly
from pir_tpu.testing.fixtures import make_toolkit
from pir_tpu.testing.params import tiny_pir_params
from pir_tpu_torch import convert, kernels
from pir_tpu_torch.core.context import PirContext as TCtx
from pir_tpu_torch.ops import expand as texpand
from pir_tpu_torch.ops import keyswitch as tks
from pir_tpu_torch.ops.modular import numpy_u64, tensor_u64

# (chain bits, the method pir_tpu's inner product takes there)
CHAINS = [((26, 27, 28), "u32"), ((34, 36, 37), "48-bit"), ((58, 60, 61), "generic")]


@pytest.fixture(scope="module", params=CHAINS, ids=lambda c: c[1])
def setup(request):
    bits, method = request.param
    params = tiny_pir_params(dbsize=40, bytes_per_item=8, dimensions=2, n=64, q_bits=bits)
    tk = make_toolkit(params, seed=31)
    keys = {e: np.asarray(k.data) for e, k in tk.galois.keys.items()}
    tctx = TCtx(params, "cpu")
    assert tks.inner_product_method(tctx, tctx.limbs_qp) == method
    return tk, tctx, keys, np.asarray(tk.relin.key.data)


def rand_words(rng, moduli, shape, n):
    """u64[*shape, len(moduli), n], each limb below its modulus."""
    return np.stack([rng.integers(0, q, size=(*shape, n), dtype=np.uint64) for q in moduli],
                    axis=-2)


def pir_tpu_digits(jctx, c, elt=None):
    """pir_tpu's switch_key step 1 (after apply_galois's galois_transform)."""
    x = jnp.asarray(c)
    if elt is not None:
        x = jpoly.galois_transform(jctx, x, elt)
    qp = jctx.limbs_qp
    return np.asarray(jmod.barrett_reduce_64(x[..., :, None, :], qp.q, qp.ratio_hi))


def pir_tpu_acc(jctx, c, key, elt=None):
    """pir_tpu's switch_key steps 1-3 and the INTT: acc [..., 2, Lp, N]."""
    digits = jctx.ntt_qp.forward(jnp.asarray(pir_tpu_digits(jctx, c, elt)))
    acc = jks._digit_inner_product(jctx, digits, jnp.asarray(key), jctx.limbs_qp)
    return np.asarray(jctx.ntt_qp.inverse(acc))


@pytest.mark.parametrize("galois", [False, True], ids=["identity", "galois"])
def test_decompose_equals_pir_tpu(setup, galois):
    """E1's function: limb i of c, permuted where a Galois element is
    given, reduced mod every key prime."""
    tk, tctx, _, _ = setup
    c = rand_words(np.random.default_rng(1), tctx.ct_moduli, (3,), tctx.n)
    c[0, :, :2] = np.array(tctx.ct_moduli, dtype=np.uint64)[:, None] - 1
    elt = (tctx.n >> 2) + 1 if galois else None
    perm = tctx.galois_permutation(elt) if galois else None
    got = tks.decompose(tctx, tensor_u64(c), perm)
    assert got.shape == (3, tctx.L, tctx.Lp, tctx.n)
    assert np.array_equal(numpy_u64(got), pir_tpu_digits(tk.ctx, c, elt))


def test_inner_product_equals_pir_tpu(setup):
    """E2's function under the chain's method, with the largest words."""
    tk, tctx, keys, _ = setup
    rng = np.random.default_rng(2)
    digits = rand_words(rng, tctx.key_moduli, (4, tctx.L), tctx.n)
    digits[0] = np.array(tctx.key_moduli, dtype=np.uint64)[:, None] - 1
    key = keys[tctx.n + 1]
    want = jks._digit_inner_product(tk.ctx, jnp.asarray(digits), jnp.asarray(key),
                                    tk.ctx.limbs_qp)
    got = tks.inner_product_plain(tctx, tensor_u64(digits), tensor_u64(key))
    assert np.array_equal(numpy_u64(got), np.asarray(want))
    assert np.array_equal(numpy_u64(tks.digit_inner_product(tctx, tensor_u64(digits),
                                                            tensor_u64(key))), np.asarray(want))


@pytest.mark.parametrize("addend", ["none", "galois", "relinearize"])
def test_mod_down_equals_pir_tpu(setup, addend):
    """E3's function on pir_tpu's own acc: without an addend it gives
    switch_key's two polynomials; with apply_galois's permuted c0, its
    ciphertext; with a product's c0 and c1, relinearize's."""
    tk, tctx, keys, relin = setup
    jctx = tk.ctx
    rng = np.random.default_rng(3)
    if addend == "relinearize":
        ct3 = rand_words(rng, tctx.ct_moduli, (2, 3), tctx.n)
        acc = pir_tpu_acc(jctx, ct3[:, 2], relin)
        want = np.asarray(jks.relinearize(jctx, jnp.asarray(relin), jnp.asarray(ct3)))
        got = tks.mod_down(tctx, tensor_u64(acc), (tensor_u64(ct3[:, 0]), tensor_u64(ct3[:, 1])))
    elif addend == "galois":
        elt = (tctx.n >> 3) + 1
        ct = rand_words(rng, tctx.ct_moduli, (2, 2), tctx.n)
        acc = pir_tpu_acc(jctx, ct[:, 1], keys[elt], elt)
        want = np.asarray(jks.apply_galois(jctx, {elt: jnp.asarray(keys[elt])},
                                           jnp.asarray(ct), elt))
        got = tks.mod_down(tctx, tensor_u64(acc), (tensor_u64(ct[:, 0]), None),
                           tctx.galois_permutation(elt))
    else:
        c = rand_words(rng, tctx.ct_moduli, (2,), tctx.n)
        key = keys[tctx.n + 1]
        acc = pir_tpu_acc(jctx, c, key)
        want = np.stack([np.asarray(x) for x in jks.switch_key(jctx, jnp.asarray(key),
                                                                jnp.asarray(c))], axis=-3)
        got = tks.mod_down(tctx, tensor_u64(acc))
    assert np.array_equal(numpy_u64(got), want)


@pytest.mark.parametrize("axis,level", [(0, 0), (0, 5), (1, 0), (1, 4)])
def test_combine_equals_pir_tpu(setup, axis, level):
    """E4's function: pir_tpu's expand_level from its own apply_galois
    output, on one tree (axis 0) and on Q = 2 trees (axis 1)."""
    tk, tctx, keys, _ = setup
    jctx = tk.ctx
    shape = (3,) if axis == 0 else (2, 3)
    cts = rand_words(np.random.default_rng(4 + level), tctx.ct_moduli, (*shape, 2), tctx.n)
    jk = {e: jnp.asarray(v) for e, v in keys.items()}
    elt = (tctx.n >> level) + 1
    sub = np.asarray(jks.apply_galois(jctx, jk, jnp.asarray(cts), elt))
    want = np.asarray(jexpand.expand_level(jctx, jk, jnp.asarray(cts), level, axis=axis))
    got = texpand.combine(tctx, tensor_u64(cts), tensor_u64(sub), level, axis)
    assert got.shape == want.shape
    assert np.array_equal(numpy_u64(got), want)


@pytest.mark.parametrize("op", ["switch_key", "apply_galois", "relinearize", "expand_level"])
def test_one_row_steps_equal_pir_tpu(setup, monkeypatch, op):
    """The whole switch in steps of one row (SWITCH_CHUNK_BYTES forced
    down) against pir_tpu's one pass."""
    tk, tctx, keys, relin = setup
    jctx = tk.ctx
    monkeypatch.setattr(tks, "SWITCH_CHUNK_BYTES", 1)
    rng = np.random.default_rng(5)
    jk = {e: jnp.asarray(v) for e, v in keys.items()}
    tkeys = convert.galois_keys_from_numpy(keys)
    if op == "switch_key":
        c = rand_words(rng, tctx.ct_moduli, (2, 2), tctx.n)
        want = np.stack([np.asarray(x) for x in jks.switch_key(
            jctx, jnp.asarray(keys[tctx.n + 1]), jnp.asarray(c))], axis=-3)
        got = np.stack([numpy_u64(x) for x in tks.switch_key(
            tctx, tkeys[tctx.n + 1], tensor_u64(c))], axis=-3)
    elif op == "apply_galois":
        ct = rand_words(rng, tctx.ct_moduli, (3, 2), tctx.n)
        want = np.asarray(jks.apply_galois(jctx, jk, jnp.asarray(ct), 9))
        got = numpy_u64(tks.apply_galois(tctx, tkeys, tensor_u64(ct), 9))
    elif op == "relinearize":
        ct3 = rand_words(rng, tctx.ct_moduli, (3, 3), tctx.n)
        want = np.asarray(jks.relinearize(jctx, jnp.asarray(relin), jnp.asarray(ct3)))
        got = numpy_u64(tks.relinearize(tctx, tensor_u64(relin), tensor_u64(ct3)))
    else:
        cts = rand_words(rng, tctx.ct_moduli, (2, 4, 2), tctx.n)
        want = np.asarray(jexpand.expand_level(jctx, jk, jnp.asarray(cts), 2, axis=1))
        got = numpy_u64(texpand.expand_level(tctx, tkeys, tensor_u64(cts), 2, axis=1))
    assert np.array_equal(got, want)


def test_failed_kernel_e_build_raises(tmp_path, monkeypatch):
    """A kernel E build that nvcc refuses raises with the compiler's
    output; nothing is loaded and nothing falls back."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'keyswitch.cu: error: refused' >&2\nexit 1\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(kernels, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(kernels, "BUILD", tmp_path / "build")
    monkeypatch.setattr(kernels.KEYSWITCH, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc failed to build keyswitch.cu(.|\n)*refused"):
        kernels.KEYSWITCH.lib()
    assert kernels.KEYSWITCH._lib is None
