"""The port's client side (keys, encryption, wire codecs) against pir_tpu:
under one seed the port's PirClient draws the same keys and writes the same
request bytes as pir_tpu.PirClient, seeded queries and full ones alike."""

import numpy as np
import jax.numpy as jnp
import pytest

from pir_tpu.bfv import encrypt as jenc
from pir_tpu.pir import wire as jwire
from pir_tpu.pir.client import PirClient as JClient
from pir_tpu.testing.params import tiny_pir_params
from pir_tpu_torch.bfv import encrypt as tenc
from pir_tpu_torch.ops.modular import numpy_u64, tensor_u64
from pir_tpu_torch.pir import wire as twire
from pir_tpu_torch.pir.client import PirClient as TClient
from pir_tpu_torch.proto import payload_pb2 as pb


@pytest.fixture(scope="module")
def params():
    return tiny_pir_params(dbsize=200, bytes_per_item=8, dimensions=2, n=64)


@pytest.fixture(scope="module")
def clients(params):
    return JClient(params, seed=17), TClient(params, seed=17)


def test_keys_bit_identical(clients):
    jc, tc = clients
    assert np.array_equal(tc.sk.coeffs, jc.sk.coeffs)
    assert np.array_equal(numpy_u64(tc.sk.ntt_q), np.asarray(jc.sk.ntt_q))
    assert np.array_equal(numpy_u64(tc.sk.ntt_qp), np.asarray(jc.sk.ntt_qp))
    assert np.array_equal(numpy_u64(tc.pk.data), np.asarray(jc.pk.data))
    assert sorted(tc.galois_keys.keys) == sorted(jc.galois_keys.keys)
    for e, k in jc.galois_keys.keys.items():
        assert np.array_equal(numpy_u64(tc.galois_keys[e].data), np.asarray(k.data)), e
    assert np.array_equal(
        numpy_u64(tc.relin_keys.key.data), np.asarray(jc.relin_keys.key.data)
    )
    assert tc._galois_bytes == jc._galois_bytes
    assert tc._relin_bytes == jc._relin_bytes


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("indexes", [[0], [13, 199]])
def test_request_bytes_identical(params, compress, indexes):
    jc = JClient(params, seed=23, compress_queries=compress)
    tc = TClient(params, seed=23, compress_queries=compress)
    for _ in range(2):  # the rng keeps step after the first request
        want = jc.create_request(indexes).SerializeToString()
        assert tc.create_request(indexes).SerializeToString() == want


def test_query_plaintexts_equal(clients, params):
    jc, tc = clients
    for idx in (0, 57, 199):
        for a, b in zip(tc._query_plaintexts(idx), jc._query_plaintexts(idx)):
            assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="invalid index"):
        tc._query_plaintexts(params.num_items)


def test_decrypt_matches(clients):
    jc, tc = clients
    rng = np.random.default_rng(3)
    m = rng.integers(0, tc.ctx.t, tc.ctx.n, dtype=np.uint64)
    ct = np.asarray(jenc.encrypt(jc.ctx, jc.pk, m, rng))
    assert np.array_equal(tenc.decrypt(tc.ctx, tc.sk, tensor_u64(ct)), m)
    # a mod-switched (one-limb) ciphertext decrypts at its own level
    from pir_tpu_torch.ops import modswitch

    one = modswitch.mod_switch_to(tc.ctx, tensor_u64(ct), 1)
    assert np.array_equal(tenc.decrypt(tc.ctx, tc.sk, one), m)
    assert np.array_equal(
        tenc.decrypt(tc.ctx, tc.sk, one),
        jenc.decrypt(jc.ctx, jc.sk, jnp.asarray(numpy_u64(one))),
    )


def test_seeded_encryption_matches(clients):
    jc, tc = clients
    m = np.arange(tc.ctx.n, dtype=np.uint64) % tc.ctx.t
    seed = bytes(range(16))
    jc0, _ = jenc.encrypt_symmetric_seeded(jc.ctx, jc.sk, m, np.random.default_rng(1), seed)
    tc0, _ = tenc.encrypt_symmetric_seeded(tc.ctx, tc.sk, m, np.random.default_rng(1), seed)
    assert np.array_equal(tc0, jc0)
    assert np.array_equal(
        tenc.expand_a_from_seed(tc.ctx, seed), jenc.expand_a_from_seed(jc.ctx, seed)
    )


def test_wire_codecs_match(clients, params):
    jc, tc = clients
    req = jc.create_request([5])
    for q in req.query:
        assert np.array_equal(
            twire.load_ciphertexts(q, tc.ctx), jwire.load_ciphertexts(q, jc.ctx)
        )
    seeded = JClient(params, seed=2, compress_queries=True).create_request([5])
    assert np.array_equal(
        twire.load_ciphertexts(seeded.query[0], tc.ctx),
        jwire.load_ciphertexts(seeded.query[0], jc.ctx),
    )
    with pytest.raises(ValueError, match="context"):
        twire.load_ciphertexts(seeded.query[0])
    msg = twire.pir_params_to_proto(params)
    assert msg.SerializeToString() == jwire.pir_params_to_proto(params).SerializeToString()
    back = twire.pir_params_from_proto(pb.PIRParameters.FromString(msg.SerializeToString()))
    assert twire.pir_params_to_proto(back).SerializeToString() == msg.SerializeToString()
    assert back.encryption_params.to_dict() == params.encryption_params.to_dict()
    gk = twire.deserialize_galois_keys(jc._galois_bytes)
    assert twire.serialize_galois_keys(gk) == jc._galois_bytes
    rk = twire.deserialize_relin_keys(jc._relin_bytes)
    assert twire.serialize_relin_keys(rk) == jc._relin_bytes
    arr = np.arange(24, dtype=np.uint64).reshape(2, 3, 4)
    assert twire.pack_array(arr) == jwire.pack_array(arr)
    assert np.array_equal(twire.unpack_array(twire.pack_array(arr)), arr)
    with pytest.raises(ValueError, match="u64"):
        twire.pack_array(arr.astype(np.int32))


def test_seal_streams_are_refused(clients):
    from pir_tpu.pir import seal_compat

    jc, tc = clients
    blob = seal_compat.save_ciphertext(
        np.zeros((2, tc.ctx.L, tc.ctx.n), np.uint64), jc.params.encryption_params
    )
    msg = pb.Ciphertexts()
    msg.ct.append(blob)
    with pytest.raises(ValueError, match="ROADMAP"):
        twire.load_ciphertexts(msg, tc.ctx)
    with pytest.raises(ValueError, match="ROADMAP"):
        twire.deserialize_galois_keys(blob)
