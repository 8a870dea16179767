"""The bounded steps of the N=32768 path, forced to one row on tiny rings:
the upper-level scan (ops.scan.UPPER_STEP_BYTES of lifted digit
plaintexts a step), the key switch (ops.keyswitch.SWITCH_CHUNK_BYTES a step) and the
Shoup companions of the database set-up (pir.database.SHOUP_STEP_BYTES,
also within set-up steps of one prefix, pir.database.NTT_PREFIXES).
Each step count must leave every word as it was: the Responses equal
pir_tpu.PirServer's bytes, on both layouts, single and multi-query, d = 2
and 3.  Tolerance 0."""

import numpy as np
import pytest

from pir_tpu.ops import keyswitch as jks
from pir_tpu.pir.client import PirClient as JClient
from pir_tpu.pir.database import PirDatabase as JDB
from pir_tpu.pir.server import PirServer as JServer
from pir_tpu.testing.fixtures import generate_test_db, make_toolkit
from pir_tpu.testing.params import tiny_pir_params
import jax.numpy as jnp
import pir_tpu_torch as pt
from pir_tpu_torch.core.context import PirContext as TCtx
from pir_tpu_torch.ops import keyswitch, scan
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
