"""ops/packing.py and PirServer(packed_transfer=...) against pir_tpu.

The host functions (hi_dtype_for, split_host, join_host) give pir_tpu's
arrays; split_device / join_device round-trip int64 words at 26- to 48-bit
moduli through int32 and uint8/int16 storage; and the server's Responses
are pir_tpu.PirServer's bytes with packed transfer on and off, for single,
multi-query (the batched reroute), process_request_batched and streamed
requests.  Tolerance 0.  The 2-rank mesh's packed and unpacked Responses
are in test_torch_parallel.py."""

import numpy as np
import pytest
import torch

from pir_tpu.ops import packing as jpacking
from pir_tpu.pir.client import PirClient as JClient
from pir_tpu.pir.database import PirDatabase as JDB
from pir_tpu.pir.server import PirServer as JServer
from pir_tpu.testing.fixtures import generate_test_db
from pir_tpu.testing.params import tiny_pir_params
import pir_tpu_torch as pt
from pir_tpu_torch.ops import packing
from pir_tpu_torch.ops.modular import numpy_u64, tensor_u64
from pir_tpu_torch.proto import payload_pb2 as pb

BITS = [26, 32, 36, 40, 44, 48, 52]


def words(bits, shape=(3, 2, 5, 64), seed=0):
    a = np.random.default_rng(seed + bits).integers(0, 1 << bits, size=shape, dtype=np.uint64)
    a.flat[0] = (1 << bits) - 1  # every bit of the widest word
    return a


@pytest.mark.parametrize("bits", BITS)
def test_host_functions_equal_pir_tpu(bits):
    moduli = [(1 << (bits - 1)) + 1, (1 << bits) - 1]
    dt = packing.hi_dtype_for(moduli)
    assert dt == jpacking.hi_dtype_for(moduli)
    if dt is None:
        assert bits > 48
        return
    a = words(bits)
    lo, hi = packing.split_host(a, dt)
    jlo, jhi = jpacking.split_host(a, dt)
    assert lo.dtype == jlo.dtype and hi.dtype == jhi.dtype
    assert np.array_equal(lo, jlo) and np.array_equal(hi, jhi)
    assert np.array_equal(packing.join_host(lo, hi), a)
    assert np.array_equal(jpacking.join_host(lo, hi), a)


@pytest.mark.parametrize("bits", [bits for bits in BITS if bits <= 48])
def test_device_split_join_round_trip(bits):
    """split_device gives split_host's words in their storage dtypes, and
    join_device undoes both."""
    a = words(bits)
    dt = packing.hi_dtype_for([(1 << bits) - 1])
    lo, hi = packing.split_device(tensor_u64(a), dt)
    assert lo.dtype == torch.int32 and hi.dtype == packing.storage_dtype(dt)
    hlo, hhi = packing.split_host(a, dt)
    assert np.array_equal(packing.from_storage(lo), hlo)
    assert np.array_equal(packing.from_storage(hi), hhi)
    assert np.array_equal(numpy_u64(packing.join_device(lo, hi)), a)
    up = packing.join_device(packing.to_storage(hlo), packing.to_storage(hhi))
    assert np.array_equal(numpy_u64(up), a)


# q_bits -> the hi word the server moves: u8 (zeros at 32 bits), u16, none
CHAINS = {(30, 30, 32): np.uint8, (34, 36, 37): np.uint8, (42, 44, 46): np.uint16,
          (50, 52, 54): None}


@pytest.fixture(scope="module", params=list(CHAINS), ids=lambda b: "q" + "-".join(map(str, b)))
def stack(request):
    params = tiny_pir_params(dbsize=40, bytes_per_item=8, dimensions=2, n=64,
                             q_bits=request.param)
    raw = generate_test_db(params.num_items, params.bytes_per_item, seed=12)
    jdb = JDB.create(raw, params)
    tdb = pt.PirDatabase.create(raw, params, device="cpu")
    return request.param, params, raw, jdb, tdb


INDEXES = {"single": [[7]], "multi": [[3, 39, 11]], "stream": [[5], [0, 22], [39]]}


@pytest.mark.parametrize("kind", list(INDEXES))
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
def test_response_bytes_equal_pir_tpu(stack, kind, packed):
    bits, params, raw, jdb, tdb = stack
    client = JClient(params, seed=6)
    requests = [client.create_request(ix) for ix in INDEXES[kind]]
    jserver = JServer(jdb, params, reply_limbs=1, packed_transfer=packed)
    want = [jserver.process_request(r).SerializeToString() for r in requests]
    server = pt.PirServer(tdb, params, reply_limbs=1, packed_transfer=packed)
    want_dt = CHAINS[bits] if packed else None
    assert server._hi_dtype == (None if want_dt is None else np.dtype(want_dt))
    if kind == "stream":
        got = [r.SerializeToString() for r in server.process_stream(iter(requests), depth=2)]
    else:
        got = [server.process_request(r).SerializeToString() for r in requests]
        got_b = [server.process_request_batched(r).SerializeToString() for r in requests]
        assert got_b == want
    assert got == want
    for ix, resp in zip(INDEXES[kind], got):
        assert client.process_response(ix, pb.Response.FromString(resp)) == [raw[i] for i in ix]


def test_stream_moves_packed_pairs(stack):
    """A packing server's streamed replies reach the host as (lo, hi)
    storage pairs; an unpacked one's as their int64 words alone."""
    bits, params, raw, _, tdb = stack
    request = pt.PirClient(params, seed=4, device="cpu").create_request([9])
    for packed in (True, False):
        server = pt.PirServer(tdb, params, packed_transfer=packed)
        host = server._submit(request, None)
        parts = host.replies[0]
        if server._hi_dtype is None:
            assert [t.dtype for t in parts] == [torch.int64]
        else:
            assert [t.dtype for t in parts] == [torch.int32,
                                                 packing.storage_dtype(CHAINS[bits])]
        assert server.finalize_response(host).SerializeToString() == (
            server.process_request(request).SerializeToString())
