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
from pir_tpu_torch.pir.server import _CachedKeys
from pir_tpu_torch.proto import payload_pb2 as pb
from pir_tpu_torch.utils import hostmem

Q_BITS = (30, 30, 32)  # room in the noise budget for a one-limb reply


def _params(dims, q_bits=Q_BITS, n=64, dbsize=40, item=8):
    return tiny_pir_params(dbsize=dbsize, bytes_per_item=item, dimensions=dims,
                           n=n, q_bits=q_bits)


@pytest.fixture(scope="module", params=[1, 2], ids=["d1", "d2"])
def stack(request):
    params = _params(request.param)
    raw = generate_test_db(params.num_items, params.bytes_per_item, seed=8)
    jdb = JDB.create(raw, params)
    tdb = pt.PirDatabase.create(raw, params, device="cpu")
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
    client = pt.PirClient(params, seed=3, compress_queries=compress, device="cpu")
    server = pt.PirServer(tdb, params, reply_limbs=pt.reply_limbs_for(params))
    indexes = [0, 17, params.num_items - 1]
    resp = server.process_request(client.create_request(indexes))
    assert len(resp.reply) == 3
    assert client.process_response(indexes, resp) == [raw[i] for i in indexes]


def test_process_query_core_and_async(stack):
    """The array-level core returns what process_request serializes."""
    params, raw, _, tdb = stack
    client = pt.PirClient(params, seed=9, device="cpu")
    server = pt.PirServer(tdb, params)
    req = client.create_request([11])
    pending = server.process_request_async(req)
    keys = convert.galois_keys_from_numpy(
        {e: convert.to_numpy(k.data) for e, k in client.galois_keys.keys.items()}
    )
    query = convert.to_tensor(pt.pir.wire.load_ciphertexts(req.query[0], server.ctx))
    reply = server.process_query(query, keys)
    assert [tuple(p.shape) for p in pending.pieces] == [(1, *reply.shape)]
    assert np.array_equal(convert.to_numpy(reply), convert.to_numpy(pending.pieces[0][0]))
    resp = server.finalize_response(pending)
    assert client.process_response([11], resp) == [raw[11]]


def test_database_from_pir_tpu_plaintexts(stack):
    params, raw, jdb, tdb = stack
    db = convert.database_from_plaintexts(params, jdb.db_pts, device="cpu")
    for a, b in zip(db.db_planes, tdb.db_planes):
        assert (a is None and b is None) or bool((a == b).all())


def _entry(gal, rel):
    return _CachedKeys(gal, rel, {}, None, None)


def test_key_cache_matches_whole_blobs(stack):
    params, raw, _, tdb = stack
    server = pt.PirServer(tdb, params)
    client = pt.PirClient(params, seed=12, device="cpu")
    req = client.create_request([4])
    server.process_request(req)
    server.process_request(req)
    assert len(server._key_cache) == 1
    client2 = pt.PirClient(params, seed=13, device="cpu")
    assert client2.process_response([4], server.process_request(
        client2.create_request([4]))) == [raw[4]]
    assert len(server._key_cache) == 2
    # a one-byte difference anywhere is a miss, and so is a shifted boundary
    big = bytearray(1_000_000)
    other = bytearray(big)
    other[300_000] = 1
    server._key_cache[:] = [_entry(bytes(big), b""), _entry(b"ab", b"")]
    assert server._lookup_keys(bytes(other), b"") is None
    assert server._lookup_keys(b"a", b"b") is None
    assert server._lookup_keys(bytes(big), b"") is server._key_cache[0]


@pytest.mark.parametrize("at", ["first", "middle", "last"])
@pytest.mark.parametrize("blob", ["galois_keys", "relin_keys"])
def test_key_cache_misses_a_one_byte_edit(stack, blob, at):
    """No entry matches a key set with one byte of either blob edited; the
    same bytes in a freshly parsed Request (other bytes objects) hit."""
    params, raw, _, tdb = stack
    server = pt.PirServer(tdb, params)
    client = pt.PirClient(params, seed=15, device="cpu")
    req = client.create_request([6])
    assert client.process_response([6], server.process_request(req)) == [raw[6]]
    again = pb.Request.FromString(req.SerializeToString())
    server.process_request(again)
    assert (server._key_counts["key_hits"], server._key_counts["key_misses"]) == (1, 1)
    edited = bytearray(getattr(req, blob))
    i = {"first": 0, "middle": len(edited) // 2, "last": len(edited) - 1}[at]
    edited[i] ^= 1
    blobs = {"galois_keys": req.galois_keys, "relin_keys": req.relin_keys, blob: bytes(edited)}
    assert server._lookup_keys(blobs["galois_keys"], blobs["relin_keys"]) is None
    assert server._lookup_keys(again.galois_keys, again.relin_keys) is server._key_cache[0]


@pytest.mark.parametrize(
    "order,hits,evictions,cached",
    [([0, 1, 0, 2, 1, 0], 3, 0, [0, 1, 2]),
     ([*range(8), 0, 8, 0], 1, 2, [*range(2, 9), 0])],
    ids=["repeats", "ninth-evicts-oldest"],
)
def test_key_cache_counts_over_a_stream(stack, order, hits, evictions, cached):
    """process_stream's key counts, which key sets stay cached (first in,
    first out at 8 entries; a hit does not refresh an entry), and every
    client's reply decrypting to its item."""
    params, raw, _, tdb = stack
    server = pt.PirServer(tdb, params, reply_limbs=pt.reply_limbs_for(params))
    clients = [pt.PirClient(params, seed=40 + c, device="cpu") for c in range(max(order) + 1)]
    indexes = [(7 * i + 3) % params.num_items for i in range(len(order))]
    reqs = [clients[c].create_request([ix]) for c, ix in zip(order, indexes)]
    got = list(server.process_stream(iter(reqs), depth=3))
    assert [clients[c].process_response([ix], r) for c, ix, r in zip(order, indexes, got)] == [
        [raw[ix]] for ix in indexes
    ]
    stats = server.stream_stats
    assert (stats["key_hits"], stats["key_misses"], stats["key_evictions"]) == (
        hits, len(order) - hits, evictions)
    held = [c._galois_bytes for c in clients]
    assert [held.index(e.galois_blob) for e in server._key_cache] == cached


@pytest.mark.parametrize("large", [False, True], ids=["small-key-set", "large-key-set"])
def test_large_key_sets_keep_host_buffers(stack, monkeypatch, large):
    """A key-cache miss on a key set with a blob above hostmem.MMAP_CEILING
    asks, once, for large host buffers to stay in the heap, with the key
    set's bytes; smaller key sets never ask.  The stream's stats carry the
    caller's page faults and the heap kept."""
    params, raw, _, tdb = stack
    server = pt.PirServer(tdb, params, reply_limbs=pt.reply_limbs_for(params))
    client = pt.PirClient(params, seed=44, device="cpu")
    reqs = [client.create_request([i]) for i in (2, 9, 2)]
    gal, rel = reqs[0].galois_keys, reqs[0].relin_keys
    asked = []
    monkeypatch.setattr(hostmem, "keep_large_buffers", asked.append)
    if large:  # the ceiling just under the key set's larger blob
        monkeypatch.setattr(hostmem, "MMAP_CEILING", max(len(gal), len(rel)) - 1)
    got = list(server.process_stream(iter(reqs), depth=2))
    assert [client.process_response([i], r) for i, r in zip((2, 9, 2), got)] == [
        [raw[i]] for i in (2, 9, 2)]
    assert asked == ([len(gal) + len(rel)] if large else [])
    stats = server.stream_stats
    assert (stats["key_hits"], stats["key_misses"]) == (2, 1)
    assert stats["host_heap_keep_bytes"] == hostmem.kept_bytes()
    faults = stats["caller_minor_faults"]
    if hostmem.thread_minor_faults() is None:  # no RUSAGE_THREAD, or a kernel that counts none
        assert faults is None
    else:
        assert isinstance(faults, int) and faults >= 0


def test_request_errors(stack):
    params, raw, _, tdb = stack
    server = pt.PirServer(tdb, params)
    client = pt.PirClient(params, seed=14, device="cpu")
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
def test_stage_profile_names_every_span_of_process_request(stack, reply_limbs):
    """profile_request's stage profile runs process_request itself under the
    profiler: every stage span the request opens, in the order first
    opened, one pir.expand.level a doubling level, host self time in each,
    and no device time on the CPU; the Response is process_request's."""
    from pir_tpu_torch import profile_request
    from pir_tpu_torch.utils.math import ceil_log2

    params, raw, _, tdb = stack
    client = pt.PirClient(params, seed=13, compress_queries=True, device="cpu")
    server = pt.PirServer(tdb, params, reply_limbs=reply_limbs)
    req = client.create_request([5])
    want = server.process_request(req).SerializeToString()  # the key set in the cache
    got = []
    prof = profile_request.stage_profile(lambda r: got.append(server.process_request(r)), [req])
    assert [r.SerializeToString() for r in got] == [want]
    assert client.process_response([5], got[0]) == [raw[5]]
    d = len(params.dimensions)
    n = params.encryption_params.poly_modulus_degree
    counts = {"pir.query.load": 1, "pir.keys.digest": 1, "pir.query.upload": 1, "pir.expand": 1,
              "pir.expand.level": ceil_log2(min(params.dimensions_sum, n)), "pir.scan.inner": 2,
              **({"pir.scan.upper": d - 1} if d > 1 else {}),
              **({"pir.modswitch": 1} if reply_limbs else {}),
              "pir.reply.wait": 1, "pir.reply.serialize": 1}
    assert {k: st["count"] for k, st in prof["stages"].items()} == counts
    assert list(prof["stages"]) == list(counts)
    assert all(st["host_self_ms"] > 0 for st in prof["stages"].values())
    assert all(st["device_ms"] == 0 and not st["kernels"] for st in prof["stages"].values())
    assert prof["outside"] == {"device_ms": 0.0, "kernels": {}}
    assert prof["device_ms_total"] == 0 and prof["requests"] == 1


def test_stage_profile_puts_device_time_down_to_the_innermost_span():
    """The attribution on a hand-built event list: a device operation counts
    in the innermost span open when it was launched, so a child span's
    kernels are not in its parent's device time; operations launched
    outside every span land on the outside line, and one whose launch was
    not recorded in neither."""
    from pir_tpu_torch.profile_request import attribute_device_time

    spans = [("pir.expand", 0, 100), ("pir.expand.level", 10, 40), ("pir.expand.level", 50, 90),
             ("pir.reply.wait", 200, 300)]
    work = [(20, "ntt_kernel", 125_000), (40, "add_kernel", 250_000),  # in the first level
            (60, "ntt_kernel", 125_000),  # the second level
            (45, "cat_kernel", 500_000), (100, "cat_kernel", 250_000),  # the expansion's own
            (150, "Memcpy DtoH", 250_000),  # outside every span
            (None, "unknown_kernel", 1_000_000)]  # its launch not recorded
    stages, outside = attribute_device_time(spans, work)
    assert stages == {
        "pir.expand.level": {"device_ms": 0.5, "kernels": {"ntt_kernel": 2, "add_kernel": 1}},
        "pir.expand": {"device_ms": 0.75, "kernels": {"cat_kernel": 2}},
    }
    assert outside == {"device_ms": 0.25, "kernels": {"Memcpy DtoH": 1}}


@pytest.mark.parametrize(
    "name,kernel",
    [("void (anonymous namespace)::scan_wide_kernel<1>(unsigned long const*, unsigned char", "C"),
     ("void (anonymous namespace)::scan_kernel<0>(unsigned long const*, unsigned char const*", "B"),
     ("void (anonymous namespace)::ntt_kernel<12, 3, true>(unsigned long const*", "A"),
     ("void (anonymous namespace)::ntt_top_kernel<2>(unsigned long const*", "A"),
     ("void (anonymous namespace)::ntt_cluster_kernel<false, false, 12, 3>(unsigned long const*",
      "A"),
     ("void (anonymous namespace)::scan_shoup_kernel(unsigned long const*", "D"),
     ("(anonymous namespace)::ks_decompose_kernel(unsigned long const*, long, long const*", "E"),
     ("(anonymous namespace)::ks_inner_kernel(unsigned long const*, unsigned long const*", "E"),
     ("(anonymous namespace)::ks_moddown_kernel(unsigned long const*, unsigned long const*", "E"),
     ("(anonymous namespace)::expand_combine_kernel(unsigned long const*, unsigned long", "E"),
     ("void (anonymous namespace)::behz_lift_kernel<4>(unsigned long const*, long", "G"),
     ("(anonymous namespace)::behz_tensor_kernel(unsigned long const*, unsigned long const*", "G"),
     ("void (anonymous namespace)::behz_floor_sk_kernel<4>(unsigned long const*", "G"),
     ("void at::native::vectorized_elementwise_kernel<4, at::native::BitwiseAndFunctor", None)],
)
def test_profile_names_each_hand_written_kernel(name, kernel):
    """The device profile sums a request's time in kernels A-G by their
    device functions' names, and in nothing else."""
    from pir_tpu_torch import profile_request

    m = profile_request._HAND_KERNEL.search(name)
    assert (m and profile_request.HAND_KERNELS[m[1]]) == kernel


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
    server = pt.PirServer(pt.PirDatabase.create(raw, params, device="cpu"), params, reply_limbs=1)
    got = server.process_request(req)
    assert got.SerializeToString() == want.SerializeToString()
    assert client.process_response([200], got) == [raw[200]]
