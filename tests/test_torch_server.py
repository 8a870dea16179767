"""The slice as a whole: a request built by pir_tpu.PirClient gets a Response
from pir_tpu_torch.PirServer whose bytes equal pir_tpu.PirServer's, and the
port's own client retrieves the right items from the port's server."""

import numpy as np
import pytest

from pir_tpu.pir.client import PirClient as JClient
from pir_tpu.pir.database import PirDatabase as JDB
from pir_tpu.pir.server import PirServer as JServer
from pir_tpu.testing.fixtures import generate_test_db
from pir_tpu.testing.params import tiny_pir_params
import pir_tpu_torch as pt
from pir_tpu_torch import convert
from pir_tpu_torch.proto import payload_pb2 as pb

Q_BITS = (30, 30, 32)  # room in the noise budget for a one-limb reply


def _params(dims, q_bits=Q_BITS, n=64, dbsize=40, item=8):
    return tiny_pir_params(dbsize=dbsize, bytes_per_item=item, dimensions=dims,
                           n=n, q_bits=q_bits)


@pytest.fixture(scope="module", params=[1, 2], ids=["d1", "d2"])
def stack(request):
    params = _params(request.param)
    raw = generate_test_db(params.num_items, params.bytes_per_item, seed=8)
    jdb = JDB.create(raw, params)
    tdb = pt.PirDatabase.create(raw, params)
    return params, raw, jdb, tdb


@pytest.mark.parametrize("reply_limbs", [None, 1])
@pytest.mark.parametrize("compress", [False, True], ids=["full", "seeded"])
def test_response_bytes_equal_pir_tpu(stack, reply_limbs, compress):
    params, raw, jdb, tdb = stack
    client = JClient(params, seed=41, compress_queries=compress)
    req = client.create_request([3, params.num_items - 1])
    want = JServer(jdb, params, reply_limbs=reply_limbs).process_request(req)
    server = pt.PirServer(tdb, params, reply_limbs=reply_limbs)
    got = server.process_request(pb.Request.FromString(req.SerializeToString()))
    assert got.SerializeToString() == want.SerializeToString()
    assert client.process_response([3, params.num_items - 1], got) == [
        raw[3], raw[params.num_items - 1]
    ]


@pytest.mark.parametrize("compress", [False, True], ids=["full", "seeded"])
def test_port_client_against_port_server(stack, compress):
    params, raw, _, tdb = stack
    client = pt.PirClient(params, seed=3, compress_queries=compress)
    server = pt.PirServer(tdb, params, reply_limbs=pt.reply_limbs_for(params))
    indexes = [0, 17, params.num_items - 1]
    resp = server.process_request(client.create_request(indexes))
    assert len(resp.reply) == 3
    assert client.process_response(indexes, resp) == [raw[i] for i in indexes]


def test_process_query_core_and_async(stack):
    """The array-level core returns what process_request serializes."""
    params, raw, _, tdb = stack
    client = pt.PirClient(params, seed=9)
    server = pt.PirServer(tdb, params)
    req = client.create_request([11])
    pending = server.process_request_async(req)
    keys = convert.galois_keys_from_numpy(
        {e: convert.to_numpy(k.data) for e, k in client.galois_keys.keys.items()}
    )
    query = convert.to_tensor(pt.pir.wire.load_ciphertexts(req.query[0], server.ctx))
    reply = server.process_query(query, keys)
    assert np.array_equal(convert.to_numpy(reply), convert.to_numpy(pending[0]))
    resp = server.finalize_response(pending)
    assert client.process_response([11], resp) == [raw[11]]


def test_database_from_pir_tpu_plaintexts(stack):
    params, raw, jdb, tdb = stack
    db = convert.database_from_plaintexts(params, jdb.db_pts)
    for a, b in zip(db.db_planes, tdb.db_planes):
        assert (a is None and b is None) or bool((a == b).all())


def test_key_cache_hashes_whole_blobs(stack):
    params, raw, _, tdb = stack
    server = pt.PirServer(tdb, params)
    client = pt.PirClient(params, seed=12)
    req = client.create_request([4])
    server.process_request(req)
    server.process_request(req)
    assert len(server._key_cache) == 1
    # blobs that differ only outside sampled windows must not collide
    d = pt.PirServer._key_digest
    big = bytearray(1_000_000)
    other = bytearray(big)
    other[300_000] = 1
    assert d(bytes(big), b"") != d(bytes(other), b"")
    assert d(b"ab", b"") != d(b"a", b"b")
    client2 = pt.PirClient(params, seed=13)
    assert client2.process_response([4], server.process_request(
        client2.create_request([4]))) == [raw[4]]
    assert len(server._key_cache) == 2


def test_request_errors(stack):
    params, raw, _, tdb = stack
    server = pt.PirServer(tdb, params)
    client = pt.PirClient(params, seed=14)
    req = client.create_request([1])
    req.galois_keys = b""
    with pytest.raises(ValueError, match="no galois keys"):
        server.process_request(req)
    with pytest.raises(ValueError, match="reply_limbs"):
        pt.PirServer(tdb, params, reply_limbs=5)
    other = _params(2, dbsize=300)
    with pytest.raises(ValueError, match="size mismatch"):
        pt.PirServer(tdb, other)
    assert len(server.process_request(pb.Request(galois_keys=client._galois_bytes)).reply) == 0


@pytest.mark.parametrize("reply_limbs", [None, 1])
def test_staged_profile_request_equals_process_request(stack, reply_limbs):
    """profile_request's stage-by-stage run is process_request, byte for byte."""
    from pir_tpu_torch import profile_request
    from pir_tpu_torch.utils.math import ceil_log2

    params, _, _, tdb = stack
    client = pt.PirClient(params, seed=13, compress_queries=True)
    server = pt.PirServer(tdb, params, reply_limbs=reply_limbs)
    req = client.create_request([5])
    n = params.encryption_params.poly_modulus_degree
    stages, levels = {}, [0.0] * ceil_log2(min(params.dimensions_sum, n))
    got = profile_request.staged_request(server, req, stages, levels)
    assert got.SerializeToString() == server.process_request(req).SerializeToString()
    assert list(stages) == [
        "load query + keys", "oblivious expansion", "selection-vector NTT",
        "database scan (all dimensions)", "mod switch",
        "reply copy to host + serialize",
    ]
    assert levels and all(ms > 0 for ms in levels)


def test_reply_limbs_for_matches_bench_rule():
    from pir_tpu.core.params import create_pir_parameters, generate_encryption_params

    for t_bits, expect in ((24, 1), (20, 1), (30, 2)):
        params = create_pir_parameters(1 << 16, 288, 2, generate_encryption_params(4096, t_bits))
        assert pt.reply_limbs_for(params) == expect


@pytest.mark.slow
def test_n4096_response_bytes_equal_pir_tpu():
    """SEAL's N=4096 chain on a small database (the benchmark's ring)."""
    from pir_tpu.core.params import create_pir_parameters, generate_encryption_params

    params = create_pir_parameters(600, 288, 2, generate_encryption_params(4096, 24))
    raw = generate_test_db(600, 288, seed=42)
    client = JClient(params, seed=7, compress_queries=True)
    req = client.create_request([200])
    want = JServer(JDB.create(raw, params), params, reply_limbs=1).process_request(req)
    server = pt.PirServer(pt.PirDatabase.create(raw, params), params, reply_limbs=1)
    got = server.process_request(req)
    assert got.SerializeToString() == want.SerializeToString()
    assert client.process_response([200], got) == [raw[200]]
