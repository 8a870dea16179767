"""pir_tpu_torch.ops.ntt and core.context against pir_tpu: twiddle tables
bit-equal, and the plain transform (kernel A's CPU counterpart) equal to
pir_tpu's XLA path, to K2 (pallas_mxu_ntt, interpret mode, N >= 1024) and to
K3 (pallas_ntt, interpret mode).  Tolerance 0."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pir_tpu.core import primes
from pir_tpu.core.context import PirContext as JCtx
from pir_tpu.ops import ntt as jntt
from pir_tpu.ops import pallas_mxu_ntt, pallas_ntt
from pir_tpu.ops import poly as jpoly
from pir_tpu.testing.params import tiny_pir_params
from pir_tpu_torch.core.context import PirContext as TCtx
from pir_tpu_torch.ops import ntt as tntt
from pir_tpu_torch.ops import poly as tpoly
from pir_tpu_torch.ops.modular import numpy_u64, tensor_u64


def tables(n, bits):
    moduli = primes.coeff_modulus_from_bits(n, list(bits))
    return jntt.NttTables(moduli, n), tntt.NttTables(moduli, n, "cpu")


def rand_poly(rng, moduli, n, batch=()):
    out = np.zeros(batch + (len(moduli), n), dtype=np.uint64)
    for li, q in enumerate(moduli):
        out[..., li, :] = rng.integers(0, q, size=batch + (n,), dtype=np.uint64)
    return out


@pytest.mark.parametrize("n,bits", [(64, (26, 27, 28)), (256, (36, 36, 37)), (4096, (36, 36, 37))])
def test_tables_bit_equal(n, bits):
    jt, tt = tables(n, bits)
    for name in ("psi_rev", "psi_rev_shoup", "psi_inv_rev", "psi_inv_rev_shoup",
                 "n_inv", "n_inv_shoup"):
        assert np.array_equal(tt.host[name], getattr(jt, name)), name
        assert np.array_equal(numpy_u64(getattr(tt, name)), getattr(jt, name)), name
    js, ts = jt.slice(2), tt.slice(2)
    assert ts.moduli == js.moduli
    assert np.array_equal(numpy_u64(ts.psi_rev), js.psi_rev)


@pytest.mark.parametrize(
    "n,bits,batch",
    [(64, (20, 21), (3,)), (128, (26, 27, 28), (2, 2)), (256, (45, 44), (2,)),
     (1024, (36, 37), (1,)), (64, (58, 60), (2,))],
)
def test_matches_xla_path(n, bits, batch):
    jt, tt = tables(n, bits)
    x = rand_poly(np.random.default_rng(n + bits[0]), jt.moduli, n, batch)
    ref_f = np.asarray(jax.jit(jt.forward)(jnp.asarray(x)))
    got_f = tt.forward(tensor_u64(x))
    assert np.array_equal(numpy_u64(got_f), ref_f)
    ref_i = np.asarray(jax.jit(jt.inverse)(jnp.asarray(ref_f)))
    got_i = tt.inverse(got_f)
    assert np.array_equal(numpy_u64(got_i), ref_i)
    assert np.array_equal(numpy_u64(got_i), x)


@pytest.mark.parametrize("inverse", [False, True])
def test_matches_k2_mxu_interpret(inverse):
    """K2 (the TPU main path's NTT) under the Pallas interpreter, N=1024."""
    jt, tt = tables(1024, (36, 37))
    x = rand_poly(np.random.default_rng(7), jt.moduli, 1024, (1,))
    ref = pallas_mxu_ntt.ntt(jt, jnp.asarray(x), inverse=inverse, interpret=True)
    got = tntt.ntt_plain(tt, tensor_u64(x), inverse)
    assert np.array_equal(numpy_u64(got), np.asarray(ref))


@pytest.mark.parametrize("inverse", [False, True])
def test_matches_k3_butterfly_interpret(inverse):
    """K3 (the VMEM butterfly kernel) under the Pallas interpreter, N=256."""
    jt, tt = tables(256, (36, 37))
    x = rand_poly(np.random.default_rng(8), jt.moduli, 256, (2,))
    ref = pallas_ntt.ntt(jt, jnp.asarray(x), inverse=inverse, interpret=True)
    got = tntt.ntt_plain(tt, tensor_u64(x), inverse)
    assert np.array_equal(numpy_u64(got), np.asarray(ref))


def test_cpu_tensor_never_reaches_the_kernel():
    _, tt = tables(64, (26, 27))
    with pytest.raises(ValueError, match="CUDA"):
        tntt.ntt_cuda(tt, tensor_u64(np.zeros((2, 64), np.uint64)), False)


@pytest.fixture(scope="module")
def contexts():
    params = tiny_pir_params(n=64, q_bits=(26, 27, 28))
    return JCtx(params), TCtx(params, "cpu")


def test_context_constants(contexts):
    jc, tc = contexts
    assert (tc.n, tc.t, tc.L, tc.Lp) == (jc.n, jc.t, jc.L, jc.Lp)
    assert tc.ct_moduli == jc.ct_moduli and tc.key_moduli == jc.key_moduli
    assert tc.p_half == int(jc.p_half_u64)
    for name in ("p_half_mod_q", "p_inv_mod_q", "p_inv_mod_q_shoup"):
        assert np.array_equal(numpy_u64(getattr(tc, name)), getattr(jc, name)), name
    assert tc.crt_lift(np.array([[5, 7], [5, 9]], np.uint64)) == jc.crt_lift(
        np.array([[5, 7], [5, 9]], np.uint64)
    )


@pytest.mark.parametrize("elt", [3, 9, 33, 65, 127])
def test_galois_permutation_and_transform(contexts, elt):
    jc, tc = contexts
    src, flip = tc.galois_permutation(elt)
    jsrc, jflip = jc.galois_permutation(elt)
    assert np.array_equal(src.numpy(), jsrc) and np.array_equal(flip.numpy(), jflip)
    x = rand_poly(np.random.default_rng(elt), jc.ct_moduli, 64, (2,))
    ref = jax.jit(lambda v: jpoly.galois_transform(jc, v, elt))(jnp.asarray(x))
    assert np.array_equal(numpy_u64(tpoly.galois_transform(tc, tensor_u64(x), elt)),
                          np.asarray(ref))


@pytest.mark.parametrize("k", [1, 8, 63, 64, 65, 127])
def test_monomial_shift(contexts, k):
    jc, tc = contexts
    src, flip = tc.monomial_shift_permutation(k)
    jsrc, jflip = jc.monomial_shift_permutation(k)
    assert np.array_equal(src.numpy(), jsrc) and np.array_equal(flip.numpy(), jflip)
    x = rand_poly(np.random.default_rng(k), jc.ct_moduli, 64, (2,))
    ref = jax.jit(lambda v: jpoly.multiply_inverse_power_of_x(jc, v, k))(jnp.asarray(x))
    got = tpoly.multiply_inverse_power_of_x(tc, tensor_u64(x), k)
    assert np.array_equal(numpy_u64(got), np.asarray(ref))
