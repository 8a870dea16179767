"""Ciphertext-multiplication mode in pir_tpu_torch against pir_tpu: each
BEHZ step of RnsTool, bfv_multiply, relinearize (with pir_tpu's relin key
through convert.relin_key_from_numpy), database_scan_ctmult, the noise
budget, and whole Responses at the CT_MULT_TINY_MATRIX rows — the same
numpy inputs through both packages, results equal (tolerance 0)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pir_tpu.bfv import encrypt as jenc
from pir_tpu.bfv import multiply as jmul
from pir_tpu.core.rns import RnsTool as JRnsTool
from pir_tpu.ops import keyswitch as jks
from pir_tpu.ops import scan as jscan
from pir_tpu.pir.client import PirClient as JClient
from pir_tpu.pir.database import PirDatabase as JDB
from pir_tpu.pir.server import PirServer as JServer
from pir_tpu.testing.fixtures import generate_test_db, make_toolkit
from pir_tpu.testing.params import tiny_pir_params
from test_correctness import CT_MULT_TINY_MATRIX

import pir_tpu_torch as pt
from pir_tpu_torch import convert
from pir_tpu_torch.bfv import encrypt as tenc
from pir_tpu_torch.bfv import multiply as tmul
from pir_tpu_torch.core.context import PirContext as TCtx
from pir_tpu_torch.core.rns import RnsTool as TRnsTool
from pir_tpu_torch.ops import keyswitch as tks
from pir_tpu_torch.ops import scan as tscan
from pir_tpu_torch.ops.modular import numpy_u64, tensor_u64
from pir_tpu_torch.proto import payload_pb2 as pb

# the tiny rings' default chain, and one with a 45-bit prime (the BEHZ
# sums' and conversions' widest words)
CHAINS = [(26, 27, 28), (40, 45, 46)]


def _setup(q_bits):
    params = tiny_pir_params(dbsize=30, bytes_per_item=8, dimensions=2, n=64,
                             q_bits=q_bits, use_ciphertext_multiplication=True)
    tk = make_toolkit(params, seed=23)
    ctx = tk.ctx
    return (params, tk, TCtx(params, "cpu"), JRnsTool(ctx.ct_moduli, ctx.n, ctx.t),
            TRnsTool(ctx.ct_moduli, ctx.n, ctx.t, device="cpu"))


@pytest.fixture(scope="module", params=CHAINS, ids=lambda b: "q" + "-".join(map(str, b)))
def setup(request):
    return _setup(request.param)


@pytest.fixture(scope="module")
def tiny():
    """The tiny rings' default chain alone, for the costlier comparisons."""
    return _setup(CHAINS[0])


def jitted(fn, *args):
    """pir_tpu's function under one jit (its eager op-by-op dispatch
    compiles every primitive on first use, tens of seconds at these
    shapes)."""
    return np.asarray(jax.jit(fn)(*args))


def residues(rng, moduli, shape):
    """u64[*shape, len(moduli), N] uniform below each limb's modulus (the
    last axis of `shape` is N)."""
    *lead, n = shape
    return np.stack([rng.integers(0, q, size=(*lead, n), dtype=np.uint64) for q in moduli],
                    axis=-2)


def same(t, j) -> bool:
    return np.array_equal(numpy_u64(t), np.asarray(j))


def test_rns_tool_bases_and_constants(setup):
    _, _, _, jt, tt = setup
    assert tt.b_moduli == jt.b_moduli and tt.m_sk == jt.m_sk
    assert tt.ntt_bsk.moduli == jt.ntt_bsk.moduli
    for name in ("psi_rev", "psi_rev_shoup", "psi_inv_rev", "n_inv"):
        assert np.array_equal(tt.ntt_bsk.host[name], np.asarray(getattr(jt.ntt_bsk, name)))
    assert same(tt.inv_punct_q.w, jt.inv_punct_q)
    assert same(tt.punct_q_mod_bsk, jt.punct_q_mod_bsk)
    assert same(tt.punct_q_mod_mtilde[:, 0], jt.punct_q_mod_mtilde)
    assert tt.neg_inv_q_mod_mtilde == int(jt.neg_inv_q_mod_mtilde)
    assert same(tt.inv_mtilde_mod_bsk.w, jt.inv_mtilde_mod_bsk)
    assert same(tt.inv_q_mod_bsk.w, jt.inv_q_mod_bsk)
    assert same(tt.inv_punct_b.w, jt.inv_punct_b)
    assert same(tt.punct_b_mod_q, jt.punct_b_mod_q)
    assert same(tt.punct_b_mod_msk[:, 0], jt.punct_b_mod_msk)
    assert tt.inv_prod_b_mod_msk == int(jt.inv_prod_b_mod_msk)
    assert same(tt.t_mod_q.w, jt.t_mod_q) and same(tt.t_mod_bsk.w, jt.t_mod_bsk)


def test_fastbconv_m_tilde_sm_mrq(setup):
    _, tk, _, jt, tt = setup
    x = residues(np.random.default_rng(1), jt.q_moduli, (3, 2, tk.ctx.n))
    x[0, 0, :, :2] = np.array(jt.q_moduli, dtype=np.uint64)[:, None] - 1  # q_i - 1
    assert same(tt.fastbconv_m_tilde_sm_mrq(tensor_u64(x)),
                jitted(jt.fastbconv_m_tilde_sm_mrq, jnp.asarray(x)))


def test_fast_floor(setup):
    _, tk, _, jt, tt = setup
    rng = np.random.default_rng(2)
    tx_q = residues(rng, jt.q_moduli, (2, 3, tk.ctx.n))
    tx_b = residues(rng, jt.bsk_moduli, (2, 3, tk.ctx.n))
    assert same(tt.fast_floor(tensor_u64(tx_q), tensor_u64(tx_b)),
                jitted(jt.fast_floor, jnp.asarray(tx_q), jnp.asarray(tx_b)))


def test_fastbconv_sk(setup):
    _, tk, _, jt, tt = setup
    x = residues(np.random.default_rng(3), jt.bsk_moduli, (4, tk.ctx.n))
    x[0, -1, :3] = [0, jt.m_sk - 1, jt.m_sk // 2]  # both sides of the centering
    assert same(tt.fastbconv_sk(tensor_u64(x)), jitted(jt.fastbconv_sk, jnp.asarray(x)))


@pytest.mark.parametrize("k_src", [4, 40])
def test_sum_conv_exact_past_u64_headroom(k_src):
    """Σ_i y_i·punct_i mod b into 60-bit targets, checked with Python ints.
    tpu32's chains reach 28 limbs, and 16 reduced 60-bit summands can
    already wrap u64, so the sum goes in chunks (one sum of all 40, or of
    these data's 28, gives wrong words)."""
    from pir_tpu_torch.core import primes
    from pir_tpu_torch.ops.modular import LimbConstants

    rng = np.random.default_rng(8)
    n = 64
    tgt = primes.coeff_modulus_from_bits(n, [60, 60])
    y = rng.integers(0, 2**60, size=(2, k_src, n), dtype=np.uint64)
    punct = np.array([[int(rng.integers(0, q)) for _ in range(k_src)] for q in tgt],
                     dtype=np.uint64)
    got = TRnsTool._sum_conv(tensor_u64(y), tensor_u64(punct), LimbConstants(tgt, "cpu"))
    want = [[[sum(int(y[b, i, c]) * int(punct[t, i]) for i in range(k_src)) % q
              for c in range(n)] for t, q in enumerate(tgt)] for b in range(2)]
    assert numpy_u64(got).tolist() == want


def test_bfv_multiply_random_and_broadcast(setup):
    """Random residues in the shapes the ct-mult scan multiplies: blocks
    [prefix, dim, 2, L, N] against the selection ciphertexts [1, dim, 2, L, N]."""
    _, tk, tctx, _, _ = setup
    rng = np.random.default_rng(4)
    a = residues(rng, tk.ctx.ct_moduli, (2, 3, 2, tk.ctx.n))
    b = residues(rng, tk.ctx.ct_moduli, (1, 3, 2, tk.ctx.n))
    got = tmul.bfv_multiply(tctx, tensor_u64(a), tensor_u64(b))
    assert got.shape == (2, 3, 3, tk.ctx.L, tk.ctx.n)
    assert same(got, jitted(lambda x, y: jmul.bfv_multiply(tk.ctx, x, y),
                            jnp.asarray(a), jnp.asarray(b)))
    assert tmul.rns_tool_for(tctx) is tmul.rns_tool_for(tctx)


def test_multiply_relinearize_decrypts_to_product(tiny):
    """Two encryptions multiplied and relinearized with pir_tpu's relin key:
    the same words as pir_tpu's, and the port decrypts the product."""
    _, tk, tctx, _, _ = tiny
    ctx = tk.ctx
    m1 = tk.rng.integers(0, ctx.t, size=ctx.n, dtype=np.uint64)
    m2 = np.zeros(ctx.n, dtype=np.uint64)
    m2[:2] = [1, 3]
    ct1 = np.asarray(jenc.encrypt(ctx, tk.pk, m1, tk.rng))
    ct2 = np.asarray(jenc.encrypt(ctx, tk.pk, m2, tk.rng))
    prod3 = tmul.bfv_multiply(tctx, tensor_u64(ct1), tensor_u64(ct2))
    jprod3 = jitted(lambda x, y: jmul.bfv_multiply(ctx, x, y), jnp.asarray(ct1),
                    jnp.asarray(ct2))
    assert same(prod3, jprod3)
    rk = convert.relin_key_from_numpy(np.asarray(tk.relin.key.data), "cpu")
    prod2 = tks.relinearize(tctx, rk, prod3)
    assert same(prod2, jitted(lambda x, k: jks.relinearize(ctx, k, x), jnp.asarray(jprod3),
                              tk.relin.key.data))
    # the port's decrypt needs the port's secret key: the same ternary
    # coefficients, carried over
    sk = pt.PirClient(tctx.params, seed=0, device="cpu").sk
    sk.coeffs = np.asarray(tk.sk.coeffs)
    sk.ntt_q = tensor_u64(np.asarray(tk.sk.ntt_q))
    sk.ntt_qp = tensor_u64(np.asarray(tk.sk.ntt_qp))
    want = (np.convolve(m1.astype(object), m2.astype(object))[: ctx.n]
            - np.append(np.convolve(m1.astype(object), m2.astype(object))[ctx.n:], 0)) % ctx.t
    assert [int(v) for v in tenc.decrypt(tctx, sk, prod2)] == [int(v) for v in want]
    assert tenc.invariant_noise_budget(tctx, sk, prod2) == jenc.invariant_noise_budget(
        ctx, tk.sk, jnp.asarray(numpy_u64(prod2)))
    assert tenc.invariant_noise_budget(tctx, sk, tensor_u64(ct1)) == jenc.invariant_noise_budget(
        ctx, tk.sk, jnp.asarray(ct1))


def test_database_scan_ctmult(tiny):
    params, tk, tctx, _, _ = tiny
    raw = generate_test_db(params.num_items, params.bytes_per_item, seed=5)
    jdb = JDB.create(raw, params)
    tdb = convert.database_from_plaintexts(params, jdb.db_pts, device="cpu")
    assert tdb.db_planes is None and same(tdb.db_ntt, jdb.db_ntt)
    sv = residues(np.random.default_rng(6), tk.ctx.ct_moduli,
                  (params.dimensions_sum, 2, tk.ctx.n))
    rk = convert.relin_key_from_numpy(np.asarray(tk.relin.key.data), "cpu")
    got = tscan.database_scan_ctmult(tctx, tdb.db_ntt, tdb.db_ntt_shoup, params.dimensions,
                                     tensor_u64(sv), rk)
    want = jitted(lambda db, v, k: jscan.database_scan_ctmult(tk.ctx, db, params.dimensions, v, k),
                  jdb.db_ntt, jnp.asarray(sv), tk.relin.key.data)
    assert got.shape == (1, 2, tk.ctx.L, tk.ctx.n) and same(got, want)
    assert same(tdb.multiply(tensor_u64(sv), rk), want)
    with pytest.raises(ValueError, match="requires relinearization keys"):
        tdb.multiply(tensor_u64(sv))


def _ct_mult_params(dbsize, elem, d, n, t_bits, bpc):
    return tiny_pir_params(dbsize=dbsize, bytes_per_item=elem, dimensions=d, n=n,
                           t_bits=t_bits, bits_per_coeff=bpc,
                           use_ciphertext_multiplication=True)


@pytest.mark.parametrize("dbsize,elem,d,n,t_bits,bpc,indices", CT_MULT_TINY_MATRIX)
def test_ct_mult_response_bytes_equal_pir_tpu(dbsize, elem, d, n, t_bits, bpc, indices):
    """Every CT_MULT_TINY_MATRIX row (tests/test_correctness.py): a request of
    pir_tpu's client, one query per index, served by both servers; equal
    Response bytes, one ciphertext a reply, decoded by either client."""
    params = _ct_mult_params(dbsize, elem, d, n, t_bits, bpc)
    raw = generate_test_db(params.num_items, params.bytes_per_item, seed=42)
    client = JClient(params, seed=7)
    req = client.create_request(indices)
    want = JServer.create(JDB.create(raw, params), params).process_request(req)
    server = pt.PirServer(pt.PirDatabase.create(raw, params, device="cpu"), params)
    got = server.process_request(pb.Request.FromString(req.SerializeToString()))
    assert got.SerializeToString() == want.SerializeToString()
    assert all(len(r.ct) == 1 for r in got.reply)
    assert client.process_response(indices, got) == [raw[i] for i in indices]
    tclient = pt.PirClient(params, seed=7, device="cpu")
    assert tclient.create_request(indices).galois_keys == req.galois_keys
    assert tclient.process_response(indices, got) == [raw[i] for i in indices]


def test_ct_mult_port_client_and_server_with_reply_limbs():
    """The port's own client against the port's server, replies
    mod-switched to one limb (30-bit primes leave the budget for it); the
    noise budget of each reply, read by the port, is positive."""
    params = tiny_pir_params(dbsize=30, bytes_per_item=8, dimensions=2, n=64,
                             q_bits=(30, 30, 32), use_ciphertext_multiplication=True)
    raw = generate_test_db(params.num_items, params.bytes_per_item, seed=9)
    client = pt.PirClient(params, seed=11, compress_queries=True, device="cpu")
    server = pt.PirServer(pt.PirDatabase.create(raw, params, device="cpu"), params,
                          reply_limbs=pt.reply_limbs_for(params))
    indexes = [3, 17, params.num_items - 1]
    resp = server.process_request(client.create_request(indexes))
    assert client.process_response(indexes, resp) == [raw[i] for i in indexes]
    for reply in resp.reply:
        ct = tensor_u64(pt.pir.wire.load_ciphertexts(reply, client.ctx)[0])
        assert ct.shape[-2] == pt.reply_limbs_for(params)
        assert tenc.invariant_noise_budget(client.ctx, client.sk, ct) > 0


def test_ct_mult_refusals(tmp_path):
    """d > 1 without a relin key in the request is refused, on one device
    and on a mesh; a mesh serves ct-mult otherwise (a 1-rank mesh answers
    with the single-device bytes)."""
    import torch.distributed as dist

    from pir_tpu_torch.parallel import sharded

    params = _ct_mult_params(30, 8, 2, 64, 12, 0)
    raw = generate_test_db(params.num_items, params.bytes_per_item, seed=1)
    db = pt.PirDatabase.create(raw, params, device="cpu")
    server = pt.PirServer(db, params)
    good = pt.PirClient(params, seed=2, device="cpu").create_request([4])
    req = pb.Request()
    req.CopyFrom(good)
    req.relin_keys = b""
    with pytest.raises(ValueError, match="requires relinearization keys in the request"):
        server.process_request(req)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            world_size=1, rank=0)
    try:
        mesh_server = pt.PirServer(db, params, mesh=sharded.Mesh(db=1))
        with pytest.raises(ValueError, match="requires relinearization keys in the request"):
            mesh_server.process_request(req)
        want = server.process_request(good).SerializeToString()
        assert mesh_server.process_request(good).SerializeToString() == want
    finally:
        dist.destroy_process_group()


def test_stage_profile_of_process_request_ct_mult():
    """profile_request's stage profile in ciphertext-multiplication mode:
    the BEHZ multiply and the relinearization come from their own spans,
    one of each a step of the upper dimension, with no device time on the
    CPU; the Response is process_request's."""
    from pir_tpu_torch import profile_request

    params = _ct_mult_params(30, 8, 2, 64, 12, 0)
    raw = generate_test_db(params.num_items, params.bytes_per_item, seed=3)
    client = pt.PirClient(params, seed=4, compress_queries=True, device="cpu")
    server = pt.PirServer(pt.PirDatabase.create(raw, params, device="cpu"), params)
    req = client.create_request([21])
    want = server.process_request(req).SerializeToString()  # the key set in the cache
    got = []
    prof = profile_request.stage_profile(lambda r: got.append(server.process_request(r)), [req])
    assert [r.SerializeToString() for r in got] == [want]
    assert client.process_response([21], got[0]) == [raw[21]]
    stages = prof["stages"]
    assert list(stages) == ["pir.query.load", "pir.keys.digest", "pir.query.upload",
                            "pir.expand", "pir.expand.level", "pir.scan.inner",
                            "pir.scan.upper", "pir.ctmult.multiply", "pir.ctmult.relin",
                            "pir.reply.wait", "pir.reply.serialize"]
    steps = stages["pir.ctmult.multiply"]["count"]
    assert steps >= 1 and stages["pir.ctmult.relin"]["count"] == steps
    assert all(st["host_self_ms"] > 0 and st["device_ms"] == 0 for st in stages.values())
    assert prof["device_ms_total"] == 0
