"""process_stream's CUDA graphs (pir/server.py: one graph a stream slot and
query shape, captured on the slot's second query of the shape and replayed
for every later one).

On the card (marker ``cuda``; skips without one): every streamed Response,
graphs engaged, byte-equal to eager ``process_request``'s, for
decomposition at N=4096 on the planes layout and ciphertext multiplication
at N=8192 on the Shoup table, with 3 clients at depth 4 (so every slot
serves every client), 2-query requests on the Shoup layout, 9 clients
over the key cache's 8 entries, and a request without Galois keys in the
middle of a stream; the capture and replay counts; the kernels' launch
counts equal to the eager path's; batched requests and shapes whose
graphs do not fit stay eager.  On the CPU: the rule that sends a streamed
request to the graphs, the fit rule, the launch record a capture keeps,
and the counts in ``stream_stats``.  Tolerance 0 throughout.  This file
imports no JAX:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_stream_graphs.py -q
"""

import numpy as np
import pytest
import torch

import pir_tpu_torch as pt
from pir_tpu_torch import kernels
from pir_tpu_torch.core import primes
from pir_tpu_torch.pir.server import graph_fits, graphs_serve
from pir_tpu_torch.proto import payload_pb2 as pb

CARD, CPU = torch.device("cuda", 0), torch.device("cpu")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _deployment(dev, kind, clients):
    """(server, clients, raw items) of a small database at a served ring."""
    if kind == "ctmult-n8192":
        ep = pt.generate_encryption_params(8192, 24)
        params = pt.create_pir_parameters(300, 288, 2, ep, use_ciphertext_multiplication=True)
        scan_impl = "auto"
    else:
        ep = pt.generate_encryption_params(4096, 20)
        params = pt.create_pir_parameters(300, 288, 2, ep)
        scan_impl = "xla" if kind == "shoup-n4096" else "pallas"
    rng = np.random.default_rng(len(kind))
    raw = [rng.integers(0, 256, 288, dtype=np.uint8).tobytes() for _ in range(300)]
    db = pt.PirDatabase.create(raw, params, scan_impl=scan_impl, device=dev)
    server = pt.PirServer(db, params, reply_limbs=pt.reply_limbs_for(params))
    return server, [pt.PirClient(params, seed=40 + c, device=dev) for c in range(clients)], raw


def _indexes(count, per_request, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 300, per_request).tolist() for _ in range(count)]


def _eager(server, requests):
    """Each request's eager Response bytes, and one request's launches."""
    want = [server.process_request(r).SerializeToString() for r in requests]
    kernels.reset_launch_counts()
    server.process_request(requests[0])
    return want, kernels.variant_launch_counts()


def _stream(server, requests, depth):
    kernels.reset_launch_counts()
    got = [r.SerializeToString() for r in server.process_stream(iter(requests), depth=depth)]
    return got, kernels.variant_launch_counts(), dict(server.stream_stats)


def _times(counts, k):
    return {v: k * c for v, c in counts.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["planes-n4096", "ctmult-n8192"])
def test_streamed_replays_equal_eager_responses(dev, kind):
    """3 clients at depth 4: a slot's first query runs eager, its second
    captures, every later one replays; each Response byte-equal to eager
    process_request's, each request's launches the eager path's."""
    server, clients, raw = _deployment(dev, kind, 3)
    indexes = _indexes(12, 1, 1)
    requests = [clients[i % 3].create_request(ix) for i, ix in enumerate(indexes)]
    want, per_request = _eager(server, requests)
    got, counts, stats = _stream(server, requests, 4)
    assert got == want
    assert (stats["graph_captures"], stats["graph_replays"]) == (4, 12 - 4)
    assert counts == _times(per_request, 12)
    got, counts, stats = _stream(server, requests, 4)  # the slots keep their graphs
    assert got == want
    assert (stats["graph_captures"], stats["graph_replays"]) == (0, 12)
    assert counts == _times(per_request, 12)
    assert stats["key_hits"] == 12 and stats["key_misses"] == 0
    for i in (0, 7, 11):
        reply = pb.Response.FromString(got[i])
        assert clients[i % 3].process_response(indexes[i], reply) == [raw[k] for k in indexes[i]]


@pytest.mark.cuda
def test_two_query_requests_replay_each_query(dev):
    """On the Shoup layout a 2-query request goes query by query: the
    slot's first query runs eager, its second captures the graph, and the
    second query's replay does not overwrite the first's reply."""
    server, clients, raw = _deployment(dev, "shoup-n4096", 2)
    indexes = _indexes(6, 2, 2)
    requests = [clients[i % 2].create_request(ix) for i, ix in enumerate(indexes)]
    want, per_request = _eager(server, requests)
    got, counts, stats = _stream(server, requests, 2)
    assert got == want
    assert (stats["graph_captures"], stats["graph_replays"]) == (2, 12 - 2)
    assert counts == _times(per_request, 6)
    assert counts["pir_scan_shoup"] == 12
    for ix, resp, i in zip(indexes, got, range(6)):
        assert clients[i % 2].process_response(ix, pb.Response.FromString(resp)) == [
            raw[k] for k in ix]


@pytest.mark.cuda
def test_nine_clients_evict_keys_mid_stream(dev):
    """9 clients in turn over the key cache's 8 entries, full from the
    start: every miss evicts an entry, and each request's keys, loaded or
    hit, are the ones the slots' graphs copy in."""
    server, clients, _ = _deployment(dev, "planes-n4096", 9)
    indexes = _indexes(18, 1, 3)
    requests = [clients[i % 9].create_request(ix) for i, ix in enumerate(indexes)]
    want, _ = _eager(server, requests)
    got, _, stats = _stream(server, requests, 4)
    assert got == want
    assert stats["key_misses"] >= 9 and stats["key_evictions"] == stats["key_misses"]
    assert stats["graph_replays"] == 18 - 4


@pytest.mark.cuda
def test_a_request_without_keys_fails_after_the_earlier_responses(dev):
    """The 5th request of a stream whose slots replay lacks its Galois
    keys: the 4 Responses before it, then the error; the next stream still
    equals eager."""
    server, clients, _ = _deployment(dev, "planes-n4096", 2)
    requests = [clients[i % 2].create_request(ix) for i, ix in enumerate(_indexes(8, 1, 4))]
    want, _ = _eager(server, requests)
    assert [r.SerializeToString() for r in server.process_stream(iter(requests), depth=4)] == want
    bad = type(requests[4])()
    bad.CopyFrom(requests[4])
    bad.galois_keys = b""
    got = []
    with pytest.raises(ValueError):
        for resp in server.process_stream(iter(requests[:4] + [bad] + requests[5:]), depth=4):
            got.append(resp.SerializeToString())
    assert got == want[:4]
    assert server.stream_stats["requests_failed"] == 1
    assert server.stream_stats["graph_replays"] == 4
    got, _, stats = _stream(server, requests, 4)
    assert got == want and stats["graph_replays"] == 8


@pytest.mark.cuda
def test_batched_requests_and_shapes_that_do_not_fit_stay_eager(dev, monkeypatch):
    """Requests of 3 queries on the planes layout take the batched path,
    which no graph replays; and where a shape's graphs would not fit in
    the card's free memory, its queries stay eager."""
    server, clients, _ = _deployment(dev, "planes-n4096", 2)
    batched = [clients[i % 2].create_request(ix) for i, ix in enumerate(_indexes(6, 3, 5))]
    want, per_request = _eager(server, batched)
    got, counts, stats = _stream(server, batched, 4)
    assert got == want and counts == _times(per_request, 6)
    assert (stats["graph_captures"], stats["graph_replays"]) == (0, 0)

    server, clients, _ = _deployment(dev, "planes-n4096", 2)
    single = [clients[i % 2].create_request(ix) for i, ix in enumerate(_indexes(8, 1, 6))]
    want, per_request = _eager(server, single)
    free, total = torch.cuda.mem_get_info(dev)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (1 << 20, total))
    got, counts, stats = _stream(server, single, 4)
    assert got == want and counts == _times(per_request, 8)
    assert (stats["graph_captures"], stats["graph_replays"]) == (0, 0)
    assert all(fits is False for slot in server._stream_slots for fits in slot.fits.values())


SHAPE, OTHER = (1, 2, 2, 4096), (2, 2, 2, 4096)


@pytest.mark.parametrize(
    "device,mesh,planes,shapes,serves",
    [(CARD, None, True, [SHAPE], True),  # one query on the planes layout
     (CARD, None, True, [SHAPE, SHAPE], False),  # the batched path
     (CARD, None, True, [SHAPE, OTHER], True),  # unequal shapes go query by query
     (CARD, None, False, [SHAPE, SHAPE], True),  # the Shoup table / ct-mult
     (CARD, None, True, [], True),  # no query: nothing to replay, nothing batched
     (CARD, "mesh", True, [SHAPE], False),
     (CARD, "mesh", False, [SHAPE], False),
     (CPU, None, True, [SHAPE], False),
     (CPU, None, False, [SHAPE, SHAPE], False)],
    ids=["single", "batched", "unequal", "shoup", "empty", "mesh", "mesh-shoup", "cpu",
         "cpu-shoup"])
def test_which_streamed_requests_replay_graphs(device, mesh, planes, shapes, serves):
    assert graphs_serve(device, mesh, planes, shapes) is serves


@pytest.mark.parametrize("depth,need,free,fits",
                         [(4, 1 << 30, 4 << 30, True), (4, (1 << 30) + 1, 4 << 30, False),
                          (1, 5 << 30, 4 << 30, False), (6, 0, 0, True)])
def test_graphs_fit_depth_times_what_a_query_kept(depth, need, free, fits):
    assert graph_fits(depth, need, free) is fits


def test_a_capture_records_launches_that_each_replay_counts():
    kernels.reset_launch_counts()
    kernels.NTT.launches, kernels.NTT.variant_launches["pir_ntt.grow"] = 1, 1
    with kernels.recorded_launches() as recorded:
        kernels.NTT.launches += 3
        kernels.NTT.variant_launches["pir_ntt.grow"] += 2
        kernels.NTT.variant_launches["pir_ntt.reduce"] = 1
        kernels.SCAN.launches += 1
        kernels.SCAN.variant_launches["pir_scan.hi"] = 1
    assert recorded == {"ntt": (3, {"pir_ntt.grow": 2, "pir_ntt.reduce": 1}),
                        "scan": (1, {"pir_scan.hi": 1})}
    assert kernels.variant_launch_counts() == {"pir_ntt.grow": 1}  # nothing ran
    for _ in range(2):
        kernels.add_launches(recorded)
    assert kernels.launch_counts()["ntt"] == 7 and kernels.launch_counts()["scan"] == 2
    assert kernels.variant_launch_counts() == {"pir_ntt.grow": 5, "pir_ntt.reduce": 2,
                                               "pir_scan.hi": 2}
    kernels.reset_launch_counts()


def test_stream_stats_count_no_graph_on_the_cpu():
    n = 64
    ep = pt.EncryptionParams(
        poly_modulus_degree=n, plain_modulus=primes.get_prime(2 * n, 12),
        coeff_modulus=tuple(primes.coeff_modulus_from_bits(n, [30, 30, 32])))
    params = pt.create_pir_parameters(20, 8, 2, ep)
    raw = [bytes([i] * 8) for i in range(20)]
    server = pt.PirServer(pt.PirDatabase.create(raw, params, device="cpu"), params)
    client = pt.PirClient(params, seed=3, device="cpu")
    requests = [client.create_request([i]) for i in (1, 7, 19)]
    got = list(server.process_stream(iter(requests), depth=2))
    assert [client.process_response([i], r) for i, r in zip((1, 7, 19), got)] == [
        [raw[1]], [raw[7]], [raw[19]]]
    stats = server.stream_stats
    assert (stats["graph_captures"], stats["graph_replays"]) == (0, 0)
    assert stats["requests"] == 3 and not server._stream_slots
