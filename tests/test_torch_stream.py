"""PirServer.process_stream of the port against pir_tpu's and against the
port's own process_request: the same requests (built by pir_tpu's client
from a seed) give the same Response bytes, in order, at depths 1, 3 and 6,
for single-query requests and for multi-query ones (the batched reroute).
Also: the failure path at both sites (submission and completion), an early
close, the in-flight count, and pir_tpu's API surface (create, integer
databases, process_response_ints, oblivious_expansion, the reply noise
budget).  Tolerance 0 throughout."""

import threading

import numpy as np
import pytest

from pir_tpu.bfv import encrypt as j_enc
from pir_tpu.pir.client import PirClient as JClient
from pir_tpu.pir.database import PirDatabase as JDB
from pir_tpu.pir.server import PirServer as JServer
from pir_tpu.testing.fixtures import generate_int_db, generate_test_db
from pir_tpu.testing.params import tiny_pir_params
import pir_tpu_torch as pt
from pir_tpu_torch import convert
from pir_tpu_torch.bfv import encrypt as t_enc
from pir_tpu_torch.bfv.keys import GaloisKeys, KSwitchKey
from pir_tpu_torch.proto import payload_pb2 as pb
from test_reference_goldens import EXPANSION_TABLE, parse_hex_poly

SINGLE = [[5], [0], [29], [12], [7], [21], [3]]
MULTI = [[2, 17, 29], [1, 4, 9], [28, 0, 13]]


@pytest.fixture(scope="module")
def stack():
    params = tiny_pir_params(dbsize=30, bytes_per_item=8, dimensions=2, n=64)
    raw = generate_test_db(30, 8)
    jserver = JServer(JDB.create(raw, params), params)
    server = pt.PirServer.create(pt.PirDatabase.create(raw, params, device="cpu"), params)
    client = JClient.create(params, seed=4)
    requests = {
        "single": [client.create_request(ix) for ix in SINGLE],
        "multi": [client.create_request(ix) for ix in MULTI],
    }
    return params, raw, jserver, server, client, requests


def _bytes(responses):
    return [r.SerializeToString() for r in responses]


def _stream_threads():
    return [t for t in threading.enumerate() if t.name.startswith("pir-stream")]


@pytest.fixture(scope="module")
def pir_tpu_streams(stack):
    _, _, jserver, _, _, requests = stack
    return {kind: _bytes(jserver.process_stream(iter(reqs), depth=3))
            for kind, reqs in requests.items()}


@pytest.mark.parametrize("kind", ["single", "multi"])
@pytest.mark.parametrize("depth", [1, 3, 6])
def test_stream_equals_pir_tpu_and_sequential(stack, pir_tpu_streams, kind, depth):
    params, raw, _, server, client, requests = stack
    reqs = requests[kind]
    got = _bytes(server.process_stream(iter(reqs), depth=depth))
    assert got == pir_tpu_streams[kind]
    assert got == _bytes(server.process_request(r) for r in reqs)
    indexes = SINGLE if kind == "single" else MULTI
    for ix, resp in zip(indexes, got):
        assert client.process_response(ix, pb.Response.FromString(resp)) == [raw[i] for i in ix]
    assert server.stream_stats["requests"] == len(reqs)
    assert server.stream_stats["max_in_flight"] == min(depth, len(reqs))
    assert not _stream_threads()


def test_depth_below_one_raises(stack):
    _, _, _, server, _, requests = stack
    with pytest.raises(ValueError, match="depth"):
        list(server.process_stream(iter(requests["single"]), depth=0))


def _without_keys(request):
    bad = pb.Request()
    bad.CopyFrom(request)
    bad.galois_keys = b""
    return bad


def test_submission_failure_yields_earlier_responses_then_raises(stack):
    """A third request without Galois keys fails on the caller's side: the
    two before it are yielded (pir_tpu's loop drops them), then the error."""
    _, _, _, server, _, requests = stack
    reqs = requests["single"]
    stream = [reqs[0], reqs[1], _without_keys(reqs[2]), reqs[3]]
    got = []
    with pytest.raises(ValueError, match="galois keys"):
        for resp in server.process_stream(iter(stream), depth=3):
            got.append(resp.SerializeToString())
    assert got == _bytes(server.process_request(r) for r in reqs[:2])
    assert not _stream_threads()
    # the server serves a new stream as before
    assert _bytes(server.process_stream(iter(reqs[:4]), depth=3)) == _bytes(
        server.process_request(r) for r in reqs[:4])


def test_completion_failure_yields_earlier_responses_then_raises(stack, monkeypatch):
    """The worker fails on the third request: the two before it are
    yielded, the error is raised, and the requests already in flight after
    it are waited for (every submitted request was completed)."""
    _, _, _, server, _, requests = stack
    reqs = requests["single"]
    want = _bytes(server.process_request(r) for r in reqs[:2])
    finalize = server.finalize_response
    calls = []

    def failing(pending):
        calls.append(len(calls))
        if len(calls) == 3:
            raise RuntimeError("reply copy failed")
        return finalize(pending)

    monkeypatch.setattr(server, "finalize_response", failing)
    got = []
    with pytest.raises(RuntimeError, match="reply copy failed"):
        for resp in server.process_stream(iter(reqs), depth=3):
            got.append(resp.SerializeToString())
    assert got == want
    assert len(calls) == server.stream_stats["requests"] == 5  # 3 + the 2 in flight
    assert not _stream_threads()


def test_early_close_leaves_no_worker(stack):
    _, _, _, server, _, requests = stack
    reqs = requests["single"]
    stream = server.process_stream(iter(reqs), depth=3)
    first = next(stream)
    assert first.SerializeToString() == server.process_request(reqs[0]).SerializeToString()
    stream.close()
    assert not _stream_threads()
    assert server.stream_stats["requests"] == 3  # nothing submitted after the close


# -- pir_tpu's API surface ------------------------------------------------


def test_create_and_integer_database(stack):
    """PirClient.create / PirServer.create, populate_ints (create's int
    dispatch) and process_response_ints, each equal to pir_tpu's."""
    params = tiny_pir_params(dbsize=8, bytes_per_item=0, dimensions=1, n=64, t_bits=12)
    ints = [int(v % (1 << 40)) for v in generate_int_db(8)]
    jdb = JDB.create(ints, params)
    tdb = pt.PirDatabase.create(ints, params, device="cpu")
    assert np.array_equal(jdb.db_pts, tdb.db_pts)
    assert tdb.calculate_indices(5) == jdb.calculate_indices(5)
    assert tdb.calculate_item_offset(5) == jdb.calculate_item_offset(5)
    jclient = JClient.create(params, seed=9)
    tclient = pt.PirClient.create(params, seed=9, device="cpu")
    req = jclient.create_request([5, 2])
    assert tclient.create_request([5, 2]).SerializeToString() == req.SerializeToString()
    want = JServer.create(jdb, params).process_request(req)
    got = pt.PirServer.create(tdb, params).process_request(req)
    assert got.SerializeToString() == want.SerializeToString()
    assert tclient.process_response_ints(got) == jclient.process_response_ints(want) == [
        ints[5], ints[2]]


def test_oblivious_expansion_equals_pir_tpu(stack):
    params, _, jserver, server, client, _ = stack
    rng = np.random.default_rng(3)
    pt_ = rng.integers(0, params.encryption_params.plain_modulus, 64, dtype=np.uint64)
    with client.ctx.on_host():
        ct = np.asarray(j_enc.encrypt(client.ctx, client.pk, pt_, rng))
    query = np.stack([ct, ct])
    keys = GaloisKeys({e: KSwitchKey(t) for e, t in convert.galois_keys_from_numpy(
        {e: np.asarray(k.data) for e, k in client.galois_keys.keys.items()}).items()})
    for cts, total in ((ct, 6), (ct[None], params.dimensions_sum), (query, 69)):
        want = np.asarray(jserver.oblivious_expansion(cts, total, client.galois_keys))
        got = convert.to_numpy(server.oblivious_expansion(cts, total, keys))
        assert np.array_equal(got, want)


def _expansion_golden(params, input_s, expected_list):
    n = params.encryption_params.poly_modulus_degree
    client = pt.PirClient(params, seed=21, device="cpu")
    server = pt.PirServer(pt.PirDatabase(params, device="cpu"), params)
    ct = t_enc.encrypt(client.ctx, client.pk, parse_hex_poly(input_s, n), np.random.default_rng(2))
    outs = server.oblivious_expansion(ct, len(expected_list), client.galois_keys)
    assert outs.shape[0] == len(expected_list)
    for i, exp_s in enumerate(expected_list):
        got = t_enc.decrypt(client.ctx, client.sk, outs[i])
        assert np.array_equal(got, parse_hex_poly(exp_s, n)), f"i={i}"


@pytest.mark.parametrize("input_s,expected_list", EXPANSION_TABLE)
def test_oblivious_expansion_golden_tiny_ring(input_s, expected_list):
    """server_test.cpp's expansion literals (tests/test_reference_goldens.py)
    at N=64: the outputs are small multiples of the inputs, so they hold at
    any ring and plain modulus above them."""
    _expansion_golden(tiny_pir_params(dbsize=10, bytes_per_item=0, n=64, t_bits=12),
                      input_s, expected_list)


@pytest.mark.slow
@pytest.mark.parametrize("input_s,expected_list", EXPANSION_TABLE)
def test_oblivious_expansion_golden(input_s, expected_list):
    """The same literals at the reference's own parameters (N=4096, 20-bit t)."""
    params = pt.create_pir_parameters(10, 0, 1, pt.generate_encryption_params(4096, 20))
    _expansion_golden(params, input_s, expected_list)


@pytest.mark.parametrize("dims", [1, 2])
def test_decomposition_reply_noise_budget(dims):
    """Each decryption round of a reply mod-switched to reply_limbs_for
    (the reply's ciphertexts, then the recomposed inner ones) keeps a
    positive noise budget."""
    params = tiny_pir_params(dbsize=40, bytes_per_item=8, dimensions=dims, n=64,
                             q_bits=(30, 30, 32))
    raw = generate_test_db(40, 8, seed=8)
    client = pt.PirClient(params, seed=3, compress_queries=True, device="cpu")
    server = pt.PirServer(pt.PirDatabase.create(raw, params, device="cpu"), params,
                          reply_limbs=pt.reply_limbs_for(params))
    response = server.process_request(client.create_request([0, 39]))
    assert client.process_response([0, 39], response) == [raw[0], raw[39]]
    for reply in response.reply:
        budgets = client.reply_noise_budgets(reply)
        assert len(budgets) == dims
        assert min(budgets) > 0, budgets
