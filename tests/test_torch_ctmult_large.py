"""Ciphertext-multiplication mode at the large rings, and the size of its
Request.

The Request's bytes are counted from the parameters
(:func:`native_request_bytes`, held to the serialized Request of the port's
client at tiny rings): at N=32768 on SEAL's chain, chip_smoke.py's phase 22
configuration, a single-query request is under protobuf's 2 GiB message
limit on the native wire.

``slow`` (the pattern of test_torch_n32768.py): N=16384 and N=32768 on
SEAL's chains (8 and 15 ciphertext primes of 49 and 55 bits, below the 16
at which pir_tpu's one-reduction BEHZ sums would wrap), a database of a few
plaintexts, d=2, on the CPU: a request of the port's client (its keys made
on the CPU, the Request serialized and counted) served by pir_tpu.PirServer
and by pir_tpu_torch.PirServer; the Response bytes must be equal and every
item must decode.  The card serves both rings in chip_smoke.py (phase 22 at
2^20 items)."""

import pytest

from pir_tpu.pir.database import PirDatabase as JDB
from pir_tpu.pir.server import PirServer as JServer
from pir_tpu.testing.fixtures import generate_test_db
from pir_tpu.testing.params import tiny_pir_params

import pir_tpu_torch as pt
from pir_tpu_torch.core.params import create_pir_parameters, generate_encryption_params
from pir_tpu_torch.proto import payload_pb2 as pb
from pir_tpu_torch.utils.math import ceil_log2

PROTOBUF_LIMIT = 2**31 - 1  # bytes of one protobuf message


def _field(payload: int) -> int:
    """Bytes of a length-delimited protobuf field with a one-byte tag."""
    return 1 + max(1, -(-payload.bit_length() // 7)) + payload


def native_request_bytes(params, queries: int = 1, seeded: bool = True) -> int:
    """The serialized native-wire Request of `queries` single-index queries
    (pir/wire.py's codec): Galois keys for every expansion element and the
    relinearization key, each [L, 2, Lp, N] u64 words behind a 38-byte array
    header; a query's dim_sum // N + 1 ciphertexts, seeded (c0 [L, N] with a
    16-byte seed and a 4-byte tag) or whole ([2, L, N])."""
    ep = params.encryption_params
    n, L, Lp = ep.poly_modulus_degree, len(ep.ct_modulus), len(ep.coeff_modulus)
    key = 6 + 4 * 8 + L * 2 * Lp * n * 8
    galois = 4 + ceil_log2(n) * (12 + key)
    ct = 4 + 16 + 6 + 2 * 8 + L * n * 8 if seeded else 6 + 3 * 8 + 2 * L * n * 8
    query = (params.dimensions_sum // n + 1) * _field(ct)
    return queries * _field(query) + _field(galois) + _field(key)


@pytest.mark.parametrize("seeded", [True, False], ids=["seeded", "whole"])
@pytest.mark.parametrize("dims,queries", [(1, 1), (2, 1), (2, 3), (3, 2)])
def test_native_request_bytes_counted(dims, queries, seeded):
    params = tiny_pir_params(dbsize=30, bytes_per_item=8, dimensions=dims, n=64,
                             use_ciphertext_multiplication=True)
    client = pt.PirClient(params, seed=1, compress_queries=seeded, device="cpu")
    request = client.create_request(list(range(queries)))
    assert len(request.SerializeToString()) == native_request_bytes(params, queries, seeded)


def test_n32768_ct_mult_request_fits_protobuf():
    """chip_smoke.py's phase 22 Request, counted: 2,017,198,935 bytes, of
    which 1,887,437,554 are Galois keys (15 keys of 15 x 2 x 16 x 32768
    words) and 125,829,158 the relinearization key."""
    params = create_pir_parameters(1 << 20, 288, 2, generate_encryption_params(32768, 24),
                                   use_ciphertext_multiplication=True)
    assert params.dimensions == (57, 57)
    assert native_request_bytes(params) == 2_017_198_935 < PROTOBUF_LIMIT


@pytest.mark.slow
@pytest.mark.parametrize("n", [16384, 32768])
def test_large_ring_ct_mult_response_bytes_equal_pir_tpu(n):
    params = create_pir_parameters(1000, 288, 2, generate_encryption_params(n, 24),
                                   use_ciphertext_multiplication=True)
    assert params.num_pt > 1 and len(params.encryption_params.ct_modulus) == {16384: 8,
                                                                            32768: 15}[n]
    raw = generate_test_db(params.num_items, params.bytes_per_item, 42)
    client = pt.PirClient(params, seed=7, compress_queries=True, device="cpu")
    indexes = [5, params.num_items - 1]
    blob = client.create_request(indexes[:1]).SerializeToString()
    assert len(blob) == native_request_bytes(params) < PROTOBUF_LIMIT
    del blob
    req = client.create_request(indexes)
    reply_limbs = pt.reply_limbs_for(params)
    want = JServer(JDB.create(raw, params), params, reply_limbs=reply_limbs).process_request(req)
    tdb = pt.PirDatabase.create(raw, params, device="cpu")
    got = pt.PirServer(tdb, params, reply_limbs=reply_limbs).process_request(
        pb.Request.FromString(req.SerializeToString()))
    assert got.SerializeToString() == want.SerializeToString()
    assert client.process_response(indexes, got) == [raw[i] for i in indexes]
