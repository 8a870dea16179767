"""The bounded steps of the N=32768 path, forced to one row on tiny rings:
the upper-level scan (ops.scan.UPPER_STEP_BYTES of lifted digit
plaintexts a step), the key switch (ops.keyswitch.SWITCH_CHUNK_BYTES a step),
the Shoup companions of the database set-up (pir.database.SHOUP_STEP_BYTES,
also within set-up steps of one prefix, pir.database.NTT_PREFIXES) and the
ciphertext-multiplication upper levels (ops.scan.CTMULT_STEP_BYTES of BEHZ
products a step).  Each step count must leave every word as it was: the
Responses equal pir_tpu.PirServer's bytes, on both layouts and in
ciphertext-multiplication mode, single and multi-query, d = 2 and 3.
Tolerance 0."""

import numpy as np
import pytest

import jax

from pir_tpu.ops import keyswitch as jks
from pir_tpu.ops import scan as jscan
from pir_tpu.pir.client import PirClient as JClient
from pir_tpu.pir.database import PirDatabase as JDB
from pir_tpu.pir.server import PirServer as JServer
from pir_tpu.testing.fixtures import generate_test_db, make_toolkit
from pir_tpu.testing.params import tiny_pir_params
import jax.numpy as jnp
import pir_tpu_torch as pt
from pir_tpu_torch.core.context import PirContext as TCtx
from pir_tpu_torch.ops import keyswitch, scan
from pir_tpu_torch import convert
from pir_tpu_torch.ops.modular import numpy_u64, tensor_u64
from pir_tpu_torch.pir import database


@pytest.fixture(params=["one_row", "many_set_up_steps"])
def one_row_steps(monkeypatch, request):
    """Every bounded step at one row; or set-up steps of one prefix each,
    each shorter than a companions' step."""
    if request.param == "one_row":
        monkeypatch.setattr(scan, "UPPER_STEP_BYTES", 1)
        monkeypatch.setattr(keyswitch, "SWITCH_CHUNK_BYTES", 1)
        monkeypatch.setattr(database, "SHOUP_STEP_BYTES", 1)
        monkeypatch.setattr(scan, "CTMULT_STEP_BYTES", 1)
    else:
        monkeypatch.setattr(database, "NTT_PREFIXES", 1)


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("scan_impl", ["pallas", "xla"])
@pytest.mark.parametrize("indexes", [[17], [0, 39, 22]], ids=["single", "multi"])
def test_one_row_steps_equal_pir_tpu(one_row_steps, dims, scan_impl, indexes):
    params = tiny_pir_params(dbsize=40, bytes_per_item=8, dimensions=dims, n=64,
                             q_bits=(34, 36, 37))
    raw = generate_test_db(params.num_items, params.bytes_per_item, seed=3)
    client = JClient(params, seed=13)
    request = client.create_request(indexes)
    want = JServer(JDB.create(raw, params, scan_impl=scan_impl), params,
                   reply_limbs=1).process_request(request).SerializeToString()
    server = pt.PirServer(pt.PirDatabase.create(raw, params, scan_impl=scan_impl, device="cpu"),
                          params, reply_limbs=1)
    assert server.process_request(request).SerializeToString() == want
    assert server.process_request_batched(request).SerializeToString() == want
    assert client.process_response(indexes, server.process_request(request)) == [
        raw[i] for i in indexes]


@pytest.mark.parametrize("q_bits", [(26, 27, 28), (34, 36, 37), (50, 52, 54)])
@pytest.mark.parametrize("step_rows", [1, 2, 3])
def test_switch_key_steps_equal_pir_tpu(monkeypatch, q_bits, step_rows):
    """switch_key over [5, 2] leading rows in steps of 1-3 rows (each inner
    product branch) against pir_tpu's one pass."""
    params = tiny_pir_params(dbsize=40, bytes_per_item=8, dimensions=2, n=64, q_bits=q_bits)
    tk = make_toolkit(params, seed=31)
    ctx = TCtx(params, "cpu")
    key = np.asarray(tk.galois.keys[ctx.n + 1].data)
    monkeypatch.setattr(keyswitch, "SWITCH_CHUNK_BYTES",
                        step_rows * ctx.L * 2 * len(ctx.ntt_qp.moduli) * ctx.n * 8)
    rng = np.random.default_rng(step_rows)
    c = np.stack([rng.integers(0, q, size=(5, 2, ctx.n), dtype=np.uint64)
                  for q in ctx.ct_moduli], axis=-2)  # [5, 2, L, N]
    got = keyswitch.switch_key(ctx, tensor_u64(key), tensor_u64(c))
    want = jks.switch_key(tk.ctx, jnp.asarray(key), jnp.asarray(c))
    for g, w in zip(got, want):
        assert tuple(g.shape) == c.shape
        assert np.array_equal(numpy_u64(g), np.asarray(w))


@pytest.mark.parametrize("one_row_steps", ["one_row"], indirect=True)
@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("indexes", [[17], [0, 29]], ids=["single", "two_queries"])
def test_ctmult_one_row_steps_equal_pir_tpu(one_row_steps, dims, indexes):
    """Ciphertext-multiplication mode with every bounded step at one row
    (each upper level multiplies, relinearizes and sums one row of its
    dimension at a time): pir_tpu.PirServer's Response bytes."""
    params = tiny_pir_params(dbsize=30, bytes_per_item=8, dimensions=dims, n=64,
                             q_bits=(40, 45, 46), use_ciphertext_multiplication=True)
    assert scan.ctmult_step_rows(1, 2, params.encryption_params.poly_modulus_degree) == 1
    raw = generate_test_db(params.num_items, params.bytes_per_item, seed=6)
    client = JClient(params, seed=12)
    request = client.create_request(indexes)
    want = JServer(JDB.create(raw, params), params).process_request(request).SerializeToString()
    server = pt.PirServer(pt.PirDatabase.create(raw, params, device="cpu"), params)
    assert server.process_request(request).SerializeToString() == want
    if dims == 2:
        assert client.process_response(indexes, server.process_request(request)) == [
            raw[i] for i in indexes]


def test_ctmult_every_step_count_equals_pir_tpu(monkeypatch):
    """database_scan_ctmult at d = 3 with its top dimension stepped by every
    row count from one row to the whole dimension (the level below it by the
    rows that fit the same bytes with its prefixes): pir_tpu's words."""
    params = tiny_pir_params(dbsize=40, bytes_per_item=8, dimensions=3, n=64,
                             use_ciphertext_multiplication=True)
    tk = make_toolkit(params, seed=21)
    raw = generate_test_db(params.num_items, params.bytes_per_item, seed=2)
    jdb = JDB.create(raw, params)
    tdb = convert.database_from_plaintexts(params, jdb.db_pts, device="cpu")
    rng = np.random.default_rng(8)
    sv = np.stack([rng.integers(0, q, size=(params.dimensions_sum, 2, tk.ctx.n), dtype=np.uint64)
                   for q in tk.ctx.ct_moduli], axis=-2)
    want = np.asarray(jax.jit(lambda db, v, k: jscan.database_scan_ctmult(
        tk.ctx, db, params.dimensions, v, k))(jdb.db_ntt, jnp.asarray(sv), tk.relin.key.data))
    ctx = tdb.ctx
    row_bytes = 3 * (ctx.L + 1) * ctx.L * ctx.n * 8
    rk = convert.relin_key_from_numpy(np.asarray(tk.relin.key.data), "cpu")
    for rows in range(1, max(params.dimensions) + 1):
        # prefix 1 at the top level: a step of `rows` rows there
        monkeypatch.setattr(scan, "CTMULT_STEP_BYTES", rows * row_bytes)
        assert scan.ctmult_step_rows(1, ctx.L, ctx.n) == rows
        got = scan.database_scan_ctmult(ctx, tdb.db_ntt, tdb.db_ntt_shoup, params.dimensions,
                                        tensor_u64(sv), rk)
        assert np.array_equal(numpy_u64(got), want), rows
