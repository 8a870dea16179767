"""The port's SEAL 3.5 wire against pir_tpu's: under one seed a SEAL-mode
client of either package writes the same Request bytes (SEAL query streams,
seeded Galois and relinearization keys) and the same PIRParameters bytes,
and the port's server answers a request with the same Response bytes as
pir_tpu.PirServer in every wire format — single-query, batched, streamed
and on a 2-rank gloo mesh — each reply decoding to its item.  The refusals
match pir_tpu's.  Tiny rings (N=64), tolerance 0 throughout."""

import numpy as np
import pytest

from pir_tpu.bfv import keys as j_keys
from pir_tpu.core.context import PirContext as JContext
from pir_tpu.pir import seal_compat as j_seal
from pir_tpu.pir import wire as jwire
from pir_tpu.pir.client import PirClient as JClient
from pir_tpu.pir.database import PirDatabase as JDB
from pir_tpu.pir.server import PirServer as JServer
from pir_tpu.testing.fixtures import generate_test_db
from pir_tpu.testing.params import tiny_pir_params
import pir_tpu_torch as pt
from pir_tpu_torch.bfv import keys as t_keys
from pir_tpu_torch.core.context import PirContext as TContext
from pir_tpu_torch.ops.modular import numpy_u64
from pir_tpu_torch.parallel import mesh_worker
from pir_tpu_torch.pir import seal_compat as t_seal
from pir_tpu_torch.pir import wire as twire

MESH_TIMEOUT_S = 300

# name: (tiny_pir_params keywords, indexes)
PARAMS = {
    "d1": (dict(dbsize=10, dimensions=1), [3, 9]),
    "d2": (dict(dbsize=30, dimensions=2, reencode_digits="legacy"), [1, 25]),
    "ct_mult": (dict(dbsize=30, dimensions=2, use_ciphertext_multiplication=True), [29, 4]),
}
# (server wire_format, client wire_format, SEAL replies expected)
FORMATS = [
    ("auto", "seal", True),
    ("seal", "seal", True),
    ("seal", "native", True),
    ("native", "seal", False),
    ("auto", "native", False),
]


def _params(name):
    return tiny_pir_params(bytes_per_item=8, n=64, **PARAMS[name][0])


@pytest.fixture(scope="module")
def deployments():
    """name -> (params, items, pir_tpu database, the port's database)."""
    out = {}
    for name in PARAMS:
        params = _params(name)
        raw = generate_test_db(params.num_items, params.bytes_per_item, 42)
        out[name] = (params, raw, JDB.create(raw, params),
                     pt.PirDatabase.create(raw, params, device="cpu"))
    return out


def _is_seal(response) -> bool:
    flags = {t_seal.looks_like_seal_stream(ct) for r in response.reply for ct in r.ct}
    assert len(flags) == 1
    return flags.pop()


@pytest.mark.parametrize("name", list(PARAMS))
def test_seal_request_and_params_bytes_equal_pir_tpu(name):
    params = _params(name)
    indexes = PARAMS[name][1]
    jc = JClient(params, seed=7, wire_format="seal")
    tc = pt.PirClient(params, seed=7, device="cpu", wire_format="seal")
    for _ in range(2):  # the rng keeps step after the first request
        want = jc.create_request(indexes)
        got = tc.create_request(indexes)
        assert got.SerializeToString() == want.SerializeToString()
    for blob in (got.galois_keys, got.relin_keys, *got.query[0].ct):
        assert t_seal.looks_like_seal_stream(blob)
    msg = twire.pir_params_to_proto(params, wire_format="seal")
    assert msg.SerializeToString() == jwire.pir_params_to_proto(
        params, wire_format="seal").SerializeToString()
    assert t_seal.looks_like_seal_stream(msg.encryption_parameters)
    back = twire.pir_params_from_proto(msg)
    assert back.encryption_params.to_dict() == params.encryption_params.to_dict()
    assert twire.pir_params_to_proto(back, "seal").SerializeToString() == msg.SerializeToString()


def test_seeded_kswitch_keys_equal_pir_tpu():
    """gen_kswitch_key(seeded_wire=True) draws the seeds, expands the a-polys
    with SEAL's PRNG and then draws the errors, as pir_tpu does: equal key
    data and seeds, and the loaded SEAL blob expands c1 back to the key."""
    params = _params("ct_mult")
    jctx, tctx = JContext.for_params(params), TContext(params, "cpu")
    rj, rt = np.random.default_rng(3), np.random.default_rng(3)
    with jctx.on_host():
        jsk = j_keys.gen_secret_key(jctx, rj)
        jrk = j_keys.gen_relin_key(jctx, jsk, rj, seeded_wire=True)
    tsk = t_keys.gen_secret_key(tctx, rt)
    trk = t_keys.gen_relin_key(tctx, tsk, rt, seeded_wire=True)
    assert trk.key.seeds == jrk.key.seeds and len(trk.key.seeds) == tctx.L
    assert np.array_equal(numpy_u64(trk.key.data), np.asarray(jrk.key.data))
    blob = twire.serialize_relin_keys(trk, seal_ep=params.encryption_params)
    assert blob == jwire.serialize_relin_keys(jrk, seal_ep=params.encryption_params)
    loaded = twire.deserialize_relin_keys(blob, "cpu", params.encryption_params)
    assert np.array_equal(numpy_u64(loaded.key.data), numpy_u64(trk.key.data))
    assert rt.integers(1 << 62) == rj.integers(1 << 62)  # the same draws consumed


@pytest.mark.parametrize("server_format,client_format,seal_replies", FORMATS)
@pytest.mark.parametrize("name", list(PARAMS))
def test_response_bytes_equal_pir_tpu(deployments, name, server_format, client_format,
                                      seal_replies):
    params, raw, jdb, tdb = deployments[name]
    indexes = PARAMS[name][1]
    client = pt.PirClient(params, seed=11, device="cpu", wire_format=client_format)
    request = client.create_request(indexes)
    want = JServer(jdb, params, wire_format=server_format).process_request(request)
    got = pt.PirServer(tdb, params, wire_format=server_format).process_request(request)
    assert got.SerializeToString() == want.SerializeToString()
    assert _is_seal(got) == seal_replies
    assert client.process_response(indexes, got) == [raw[i] for i in indexes]


def test_seal_reply_carries_its_level_parms_id(deployments):
    """A reply mod-switched to one limb is a SEAL stream at that chain
    level, not the key level."""
    params, raw, jdb, tdb = deployments["d2"]
    client = pt.PirClient(params, seed=11, device="cpu", wire_format="seal")
    request = client.create_request([25])
    got = pt.PirServer(tdb, params, reply_limbs=1).process_request(request)
    want = JServer(jdb, params, reply_limbs=1).process_request(request)
    assert got.SerializeToString() == want.SerializeToString()
    ep = params.encryption_params
    assert t_seal.parms_id_for(ep, 1) != t_seal.parms_id_for(ep)
    for ct in got.reply[0].ct:  # load_ciphertext checks the parms_id of its level
        assert t_seal.load_ciphertext(ct, ep).shape[1] == 1
    assert client.process_response([25], got) == [raw[25]]


def test_batched_and_streamed_seal_requests_equal_process_request(deployments, monkeypatch):
    """A multi-query SEAL request through the batched path (lanes of 2, a
    ragged tail) and a stream of SEAL requests give process_request's
    bytes, SEAL streams all."""
    monkeypatch.setenv("PIR_BATCH_LANES", "2")
    params, raw, jdb, tdb = deployments["d2"]
    client = pt.PirClient(params, seed=13, device="cpu", wire_format="seal")
    server = pt.PirServer(tdb, params)
    multi = client.create_request([0, 17, 29])
    want = JServer(jdb, params).process_request(multi).SerializeToString()
    assert server.process_request(multi).SerializeToString() == want
    batched = server.process_request_batched(multi)
    assert batched.SerializeToString() == want
    assert _is_seal(batched)
    requests = [client.create_request([i]) for i in (5, 0, 29, 12)] + [multi]
    sequential = [server.process_request(r).SerializeToString() for r in requests]
    streamed = [r.SerializeToString() for r in server.process_stream(iter(requests), depth=3)]
    assert streamed == sequential
    got = client.process_response([0, 17, 29], batched)
    assert got == [raw[0], raw[17], raw[29]]


def test_seal_request_on_a_gloo_mesh(deployments, tmp_path):
    """A SEAL request (d=2, legacy digits) and a ct-mult SEAL request on 2
    gloo CPU ranks (mesh_worker.run_job, db=2): every rank's Response
    equals pir_tpu's single-device server's."""
    cases, wants = [], {}
    for name, impl in (("d2", "pallas"), ("ct_mult", "auto")):
        params, raw, jdb, _ = deployments[name]
        indexes = PARAMS[name][1]
        request = pt.PirClient(params, seed=17, device="cpu",
                               wire_format="seal").create_request(indexes)
        wants[name] = JServer(jdb, params).process_request(request).SerializeToString()
        cases.append({"name": name, "params": twire.pir_params_to_proto(params, "seal")
                      .SerializeToString(), "items": b"".join(raw), "scan_impl": impl,
                      "batch": 1, "limb": 1, "requests": [request.SerializeToString()],
                      "batched": True})
    job = {"world": 2, "backend": "gloo", "devices": ["cpu"] * 2, "timeout_s": 120,
           "cases": cases}
    for rank, results in enumerate(mesh_worker.run_job(job, tmp_path, MESH_TIMEOUT_S)):
        for name, want in wants.items():
            assert results[name]["responses"] == [want], f"rank {rank} {name}"
            assert results[name]["batched"] == [want], f"rank {rank} {name} (batched)"


def _seal_request_for(params, indexes):
    """A SEAL request on `params`' ring from a client on legacy digits (a
    SEAL client refuses balanced ones)."""
    legacy = tiny_pir_params(bytes_per_item=8, n=64, dbsize=params.num_items,
                             dimensions=len(params.dimensions), reencode_digits="legacy")
    return pt.PirClient(legacy, seed=19, device="cpu", wire_format="seal").create_request(indexes)


def test_refusals_match_pir_tpu():
    balanced = tiny_pir_params(dbsize=30, bytes_per_item=8, dimensions=2, n=64)
    assert balanced.reencode_mode == 1
    for client in (JClient, lambda p, **kw: pt.PirClient(p, device="cpu", **kw)):
        with pytest.raises(ValueError, match="legacy"):
            client(balanced, seed=7, wire_format="seal")
        with pytest.raises(ValueError, match="native-codec extension"):
            client(_params("d1"), seed=7, compress_queries=True, wire_format="seal")
        with pytest.raises(ValueError, match="unknown wire format"):
            client(_params("d1"), seed=7, wire_format="proto")
    raw = generate_test_db(30, 8)
    tdb = pt.PirDatabase.create(raw, balanced, device="cpu")
    with pytest.raises(ValueError, match="unknown wire format"):
        pt.PirServer(tdb, balanced, wire_format="proto")
    with pytest.raises(ValueError, match="unknown wire format"):
        JServer(JDB.create(raw, balanced), balanced, wire_format="proto")
    with pytest.raises(ValueError, match="unknown wire format"):
        twire.pir_params_to_proto(balanced, wire_format="proto")
    request = _seal_request_for(balanced, [4])
    for server in (JServer(JDB.create(raw, balanced), balanced),
                   pt.PirServer(tdb, balanced)):
        with pytest.raises(ValueError, match="legacy"):
            server.process_request(request)
    server = pt.PirServer(tdb, balanced)
    with pytest.raises(ValueError, match="legacy"):
        server.process_request_batched(request)
    assert not server._key_cache  # refused before its keys were loaded


def test_refused_seal_request_in_a_stream():
    """A SEAL request against balanced digits fails at its turn: the
    Responses before it are yielded, then the error is raised, and the
    server serves the next stream as before."""
    params = tiny_pir_params(dbsize=30, bytes_per_item=8, dimensions=2, n=64)
    server = pt.PirServer(pt.PirDatabase.create(generate_test_db(30, 8), params,
                                                device="cpu"), params)
    client = pt.PirClient(params, seed=23, device="cpu")
    native = [client.create_request([i]) for i in (3, 11, 27)]
    want = [server.process_request(r).SerializeToString() for r in native]
    stream = [native[0], native[1], _seal_request_for(params, [5]), native[2]]
    got = []
    with pytest.raises(ValueError, match="legacy"):
        for resp in server.process_stream(iter(stream), depth=2):
            got.append(resp.SerializeToString())
    assert got == want[:2]
    again = [r.SerializeToString() for r in server.process_stream(iter(native), depth=2)]
    assert again == want


def test_seal_key_loaders_need_parameters():
    params = _params("d1")
    client = pt.PirClient(params, seed=7, device="cpu", wire_format="seal")
    request = client.create_request([2])
    with pytest.raises(ValueError, match="encryption parameters"):
        twire.deserialize_galois_keys(request.galois_keys, "cpu")
    with pytest.raises(ValueError, match="encryption parameters"):
        twire.deserialize_relin_keys(request.relin_keys, "cpu")
    with pytest.raises(ValueError, match="context"):
        twire.load_ciphertexts(request.query[0])
    gk = twire.deserialize_galois_keys(request.galois_keys, "cpu", params.encryption_params)
    assert sorted(gk.keys) == sorted(client.galois_keys.keys)
    for e, k in gk.keys.items():
        assert np.array_equal(numpy_u64(k.data), numpy_u64(client.galois_keys[e].data))
    jgk = jwire.deserialize_galois_keys(request.galois_keys, params.encryption_params)
    for e, k in jgk.keys.items():
        assert np.array_equal(numpy_u64(gk[e].data), np.asarray(k.data))
    assert j_seal.looks_like_seal_stream(request.galois_keys)
