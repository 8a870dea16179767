"""Batched serving in the port against pir_tpu: the S-wide contraction
(kernel C's CPU counterpart) against K4 and K4-u32 under the Pallas
interpreter, the batched scan, PirServer.process_request_batched and the
multi-query reroute of process_request, at a chain of at most 32 bits (the
tpu32 case: no hi plane) and one above.  Tolerance 0."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pir_tpu.core.context import PirContext as JCtx
from pir_tpu.ops import pallas_scan
from pir_tpu.ops import scan as jscan
from pir_tpu.pir.client import PirClient as JClient
from pir_tpu.pir.database import PirDatabase as JDB
from pir_tpu.pir.server import PirServer as JServer
from pir_tpu.testing.fixtures import generate_test_db
from pir_tpu.testing.params import tiny_pir_params
import pir_tpu_torch as pt
from pir_tpu_torch.core.context import PirContext as TCtx
from pir_tpu_torch.ops import scan as tscan
from pir_tpu_torch.ops import scan_kernel
from pir_tpu_torch.ops.modular import numpy_u64, tensor_u64
from pir_tpu_torch.proto import payload_pb2 as pb

CHAINS = [(26, 27, 28), (26, 34, 36)]  # no hi plane (K4-u32); u8 hi plane (K4)


def contexts(q_bits, n=128):
    params = tiny_pir_params(n=n, q_bits=q_bits)
    return JCtx(params), TCtx(params)


def residues(rng, moduli, shape_before, n):
    out = np.zeros(shape_before + (len(moduli), n), dtype=np.uint64)
    for li, q in enumerate(moduli):
        out[..., li, :] = rng.integers(0, q, size=shape_before + (n,), dtype=np.uint64)
    return out


@pytest.mark.parametrize("S", [2, 6])
@pytest.mark.parametrize("q_bits", CHAINS)
def test_contract_wide_matches_pallas_interpret(q_bits, S):
    """K4 ((26, 34, 36)) and K4-u32 ((26, 27, 28)) under the interpreter."""
    jc, tc = contexts(q_bits)
    P, D, N = 3, 7, 128
    rng = np.random.default_rng(S)
    sv = residues(rng, jc.ct_moduli, (D, S), N)
    db = residues(rng, jc.ct_moduli, (P, D), N).transpose(0, 2, 1, 3).copy()
    jh, jl = pallas_scan.split_planes(jnp.asarray(db), jc.ct_moduli)
    lq = jc.limbs_q
    ref = pallas_scan.contract_dim_raw_wide(
        jnp.asarray(sv), jh, jl, lq.moduli,
        tuple(int(x) for x in lq.ratio_hi[:, 0]),
        tuple(int(x) for x in lq.ratio_lo[:, 0]),
        block_n=128, interpret=True,
    )
    th, tl = scan_kernel.split_planes(tensor_u64(db), tc.ct_moduli)
    assert (th is None) == (max(q_bits) <= 32)
    got = scan_kernel.contract_dim_wide_auto(tensor_u64(sv), th, tl, tc.limbs_q)
    assert got.shape == (P, S, jc.L, N)
    assert np.array_equal(numpy_u64(got), np.asarray(ref))


@pytest.mark.parametrize("q_bits", CHAINS + [(44, 46, 47)])
def test_contract_wide_columns_equal_single_query_scan(q_bits):
    """Each column pair of an odd-width S=5 contraction (the last pair one
    column) equals the S=2 contraction of that pair; 46-bit moduli take
    three row chunks."""
    jc, tc = contexts(q_bits, n=64)
    P, D, N = 4, 40, 64
    rng = np.random.default_rng(7)
    sv = tensor_u64(residues(rng, jc.ct_moduli, (D, 6), N))
    db = residues(rng, jc.ct_moduli, (P, D), N).transpose(0, 2, 1, 3).copy()
    th, tl = scan_kernel.split_planes(tensor_u64(db), tc.ct_moduli)
    wide = scan_kernel.contract_dim_wide_auto(sv[:, :5], th, tl, tc.limbs_q)
    assert wide.shape == (P, 5, jc.L, N)
    for s0 in (0, 2, 4):
        pair = scan_kernel.contract_dim_auto(sv[:, s0 : s0 + 2], th, tl, tc.limbs_q)
        assert torch.equal(wide[:, s0 : s0 + 2], pair[:, : min(2, 5 - s0)])


def test_kernel_wrappers_take_no_cpu_tensors():
    """The CUDA wrappers never fall back to the plain version."""
    _, tc = contexts((26, 27, 28), n=64)
    sv = torch.zeros((3, 2, 3, 64), dtype=torch.int64)
    lo = torch.zeros((2, 3, 3, 64), dtype=torch.int32)
    for fn in (scan_kernel.contract_cuda, scan_kernel.contract_wide_cuda):
        with pytest.raises(ValueError, match="must be on"):
            fn(sv, None, lo, tc.limbs_q)
    _, wide = contexts((44, 46, 47), n=64)  # exact bound: 16 rows
    with pytest.raises(ValueError, match="exact bound 16"):
        scan_kernel.contract_wide_cuda(torch.zeros((17, 2, 2, 64), dtype=torch.int64),
                                       None, lo, wide.limbs_q)


@pytest.mark.parametrize("B", [2, 3])
@pytest.mark.parametrize("q_bits", CHAINS)
def test_database_scan_decomp_batched_matches_interpret(q_bits, B):
    jc, tc = contexts(q_bits, n=64)
    dims = (3, 4)
    total = int(np.prod(dims))
    rng = np.random.default_rng(B)
    db = residues(rng, jc.ct_moduli, (total,), jc.n)
    sv = residues(rng, jc.ct_moduli, (B, sum(dims), 2), jc.n)
    grouped = db.reshape(total // dims[-1], dims[-1], jc.L, jc.n).transpose(0, 2, 1, 3)
    jplanes = pallas_scan.split_planes(jnp.asarray(grouped), jc.ct_moduli)
    ref = jax.jit(
        lambda v, planes: jscan.database_scan_decomp_batched(
            jc, dims, v, planes, interpret=True
        )
    )(jnp.asarray(sv), jplanes)
    tplanes = scan_kernel.split_planes(tensor_u64(grouped.copy()), tc.ct_moduli)
    got = tscan.database_scan_decomp_batched(tc, dims, tensor_u64(sv), tplanes)
    assert got.shape == ref.shape
    assert np.array_equal(numpy_u64(got), np.asarray(ref))
    for b in range(B):
        single = tscan.database_scan_decomp(tc, dims, tensor_u64(sv[b]), tplanes)
        assert torch.equal(got[b], single)


@pytest.fixture(scope="module", params=[(30, 30, 32), (34, 36, 37)], ids=["q32", "q36"])
def stack(request):
    """A d=2 database at a chain of at most 32 bits (no hi plane) and one
    above, in both packages; pir_tpu's on its Pallas planes path."""
    params = tiny_pir_params(dbsize=40, bytes_per_item=8, dimensions=2, n=64,
                             q_bits=request.param)
    raw = generate_test_db(params.num_items, params.bytes_per_item, seed=9)
    return params, raw, JDB.create(raw, params, scan_impl="pallas"), pt.PirDatabase.create(raw, params)


@pytest.mark.parametrize("reply_limbs", [None, 1])
def test_process_request_batched_equals_pir_tpu(stack, reply_limbs, monkeypatch):
    """3 queries in lanes of 2: one full chunk and a ragged tail."""
    monkeypatch.setenv("PIR_BATCH_LANES", "2")
    params, raw, jdb, tdb = stack
    client = JClient(params, seed=17, compress_queries=True)
    indexes = [5, params.num_items - 1, 22]
    req = client.create_request(indexes)
    want = JServer(jdb, params, reply_limbs=reply_limbs).process_request_batched(req)
    server = pt.PirServer(tdb, params, reply_limbs=reply_limbs)
    assert server.batch_lanes() == 2
    got = server.process_request_batched(pb.Request.FromString(req.SerializeToString()))
    assert got.SerializeToString() == want.SerializeToString()
    assert server.process_request(req).SerializeToString() == want.SerializeToString()
    assert client.process_response(indexes, got) == [raw[i] for i in indexes]


def test_multi_query_reroute_equals_single_query_replies(stack, monkeypatch):
    """The reroute: a multi-query process_request (batched path, ragged tail
    included) gives each query the bytes the single-query path gives a
    Request that holds only that query and the same keys."""
    monkeypatch.setenv("PIR_BATCH_LANES", "2")
    params, raw, _, tdb = stack
    client = pt.PirClient(params, seed=23, compress_queries=True)
    server = pt.PirServer(tdb, params, reply_limbs=pt.reply_limbs_for(params))
    indexes = [0, 31, params.num_items - 1]
    req = client.create_request(indexes)
    pending = server.process_request_async(req)
    assert isinstance(pending, pt.pir.server.BatchedReplies)
    assert [count for _, count in pending.chunks] == [2, 1]
    multi = server.finalize_response(pending)
    for qi in range(len(indexes)):
        one = pb.Request(galois_keys=req.galois_keys, relin_keys=req.relin_keys)
        one.query.add().CopyFrom(req.query[qi])
        single = server.process_request(one)
        assert isinstance(server.process_request_async(one), list)
        assert single.reply[0].SerializeToString() == multi.reply[qi].SerializeToString()
    assert client.process_response(indexes, multi) == [raw[i] for i in indexes]


def test_batch_lanes_rule(stack, monkeypatch):
    """Same rule and overrides as pir_tpu's batch_lanes."""
    params, _, jdb, tdb = stack
    server = pt.PirServer(tdb, params)
    jserver = JServer(jdb, params)
    monkeypatch.delenv("PIR_BATCH_LANES", raising=False)
    for budget in (None, "1", str(3 * 5 * 2 * 3 * 64 * 8 * 5)):
        if budget is None:
            monkeypatch.delenv("PIR_BATCH_MEM_BUDGET", raising=False)
        else:
            monkeypatch.setenv("PIR_BATCH_MEM_BUDGET", budget)
        assert server.batch_lanes() == jserver.batch_lanes()
    monkeypatch.setenv("PIR_BATCH_LANES", "7")
    assert server.batch_lanes() == jserver.batch_lanes() == 7


@pytest.mark.slow
def test_tpu32_n4096_response_bytes_equal_pir_tpu():
    """The tpu32 profile at N=4096 on a small database: one single-query
    request and one batched request of two."""
    from pir_tpu.core.params import create_pir_parameters, generate_encryption_params

    ep = generate_encryption_params(4096, 24, profile="tpu32")
    params = create_pir_parameters(600, 288, 2, ep)
    raw = generate_test_db(600, 288, seed=42)
    client = JClient(params, seed=7, compress_queries=True)
    keep = pt.reply_limbs_for(params)
    assert keep == 2
    jserver = JServer(JDB.create(raw, params, scan_impl="pallas"), params, reply_limbs=keep)
    server = pt.PirServer(pt.PirDatabase.create(raw, params), params, reply_limbs=keep)
    assert server.db.db_planes[0] is None
    for indexes in ([200], [3, 599]):
        req = client.create_request(indexes)
        got = server.process_request_batched(req) if len(indexes) > 1 else server.process_request(req)
        want = jserver.process_request_batched(req) if len(indexes) > 1 else jserver.process_request(req)
        assert got.SerializeToString() == want.SerializeToString()
        assert client.process_response(indexes, got) == [raw[i] for i in indexes]
