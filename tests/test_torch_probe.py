"""The rest of pir_tpu's library surface in the port, against pir_tpu:
PirDatabase.multiply(decryptor=) with database_scan_decomp(probe=), the
reference's server-side noise-budget probe (the same printed lines, the
same returned words, both layouts, d = 2 and 3; ignored in
ciphertext-multiplication mode), and PirContext.for_params, the
process-wide context memo (shared by a client and a database; Responses
equal to pir_tpu.PirServer's bytes).  Tolerance 0."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pir_tpu.bfv import encrypt as jenc
from pir_tpu.pir.client import PirClient as JClient
from pir_tpu.pir.database import PirDatabase as JDB
from pir_tpu.pir.server import PirServer as JServer
from pir_tpu.testing.fixtures import generate_test_db
from pir_tpu.testing.params import tiny_pir_params

import pir_tpu_torch as pt
from pir_tpu_torch.bfv import encrypt as tenc
from pir_tpu_torch.bfv import multiply as tmul
from pir_tpu_torch.core.context import PirContext as TCtx
from pir_tpu_torch.core.params import create_pir_parameters, generate_encryption_params
from pir_tpu_torch.ops.modular import numpy_u64
from pir_tpu_torch.pir import database as tdatabase


def _selection_vector(params, client, index, seed):
    """The expanded selection vector of `index`, int64 [dim_sum, 2, L, N]:
    an encryption of 1 at each dimension's hot row, of 0 elsewhere (the port
    client's public key)."""
    rng = np.random.default_rng(seed)
    hot = set()
    off = 0
    for dim, i in zip(params.dimensions, tdatabase.calculate_indices(params, index)):
        hot.add(off + i)
        off += dim
    rows = []
    for r in range(params.dimensions_sum):
        m = np.zeros(client.ctx.n, dtype=np.uint64)
        m[0] = 1 if r in hot else 0
        rows.append(tenc.encrypt(client.ctx, client.pk, m, rng))
    return torch.stack(rows)


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("scan_impl", ["pallas", "xla"])
def test_noise_budget_probe_equals_pir_tpu(capsys, d, scan_impl):
    """multiply(sv, decryptor=) prints pir_tpu's lines (the budgets of the
    first two ciphertexts after the inner contraction and after each upper
    level) and returns pir_tpu's words, which are multiply(sv)'s.  pir_tpu's
    multiply runs its planes kernel only on a TPU (its server passes
    interpret mode elsewhere), so both of the port's layouts are held to
    pir_tpu's Shoup-table layout, whose words every layout gives."""
    params = tiny_pir_params(dbsize=40, bytes_per_item=8, dimensions=d, n=64,
                             q_bits=(34, 36, 37))
    raw = generate_test_db(params.num_items, params.bytes_per_item, seed=3)
    jclient = JClient(params, seed=5)
    tclient = pt.PirClient(params, seed=5, device="cpu")
    assert np.array_equal(numpy_u64(tclient.sk.ntt_q), np.asarray(jclient.sk.ntt_q))
    sv = _selection_vector(params, tclient, 27, seed=d)
    jsv = jnp.asarray(numpy_u64(sv))

    def jbudget(ct):
        return jenc.invariant_noise_budget(jclient.ctx, jclient.sk, ct)

    want = np.asarray(JDB.create(raw, params, scan_impl="xla").multiply(jsv, decryptor=jbudget))
    want_lines = capsys.readouterr().out.splitlines()
    assert len(want_lines) == d
    assert want_lines[0].startswith(f"noise budget after dim {d - 1} (inner contraction): [")
    assert want_lines[-1].startswith("noise budget after dim 0 (digit contraction): [")
    tdb = pt.PirDatabase.create(raw, params, scan_impl=scan_impl, device="cpu")
    got = tdb.multiply(
        sv, decryptor=lambda ct: tenc.invariant_noise_budget(tclient.ctx, tclient.sk, ct))
    assert capsys.readouterr().out.splitlines() == want_lines
    assert np.array_equal(numpy_u64(got), want)
    assert torch.equal(got, tdb.multiply(sv))
    assert capsys.readouterr().out == ""


def test_noise_budget_probe_ignored_in_ct_mult_mode(capsys):
    """Ciphertext-multiplication mode ignores the decryptor, as pir_tpu's
    does: nothing printed, the same words as without it and as pir_tpu's."""
    params = tiny_pir_params(dbsize=30, bytes_per_item=8, dimensions=2, n=64,
                             use_ciphertext_multiplication=True)
    raw = generate_test_db(params.num_items, params.bytes_per_item, seed=4)
    jclient = JClient(params, seed=6)
    tclient = pt.PirClient(params, seed=6, device="cpu")
    sv = _selection_vector(params, tclient, 11, seed=1)
    rk = tclient.relin_keys.key.data
    calls = []

    def decryptor(ct):
        calls.append(ct)
        return 0

    tdb = pt.PirDatabase.create(raw, params, device="cpu")
    got = tdb.multiply(sv, rk, decryptor=decryptor)
    assert capsys.readouterr().out == "" and not calls
    assert torch.equal(got, tdb.multiply(sv, rk))
    want = JDB.create(raw, params).multiply(jnp.asarray(numpy_u64(sv)),
                                            jclient.relin_keys.key.data, decryptor=decryptor)
    assert np.array_equal(numpy_u64(got), np.asarray(want))
    assert capsys.readouterr().out == "" and not calls


def test_for_params_memo():
    """Equal params on one device give one context; other params or
    another device another; a client and a database share it."""
    ep = generate_encryption_params(4096, 20)
    params = create_pir_parameters(100, 8, 2, ep)
    again = create_pir_parameters(100, 8, 2, generate_encryption_params(4096, 20))
    assert again == params and again is not params
    ctx = TCtx.for_params(params, "cpu")
    assert TCtx.for_params(again, torch.device("cpu")) is ctx
    assert ctx.device == torch.device("cpu") and ctx.params == params
    assert TCtx.for_params(create_pir_parameters(101, 8, 2, ep), "cpu") is not ctx
    meta = TCtx.for_params(params, "meta")
    assert meta is not ctx and meta.device == torch.device("meta")
    assert TCtx.for_params(params, "meta") is meta
    assert TCtx(params, "cpu") is not ctx  # the constructor still builds anew


@pytest.mark.parametrize("ct_mult", [False, True], ids=["decomp", "ct_mult"])
def test_for_params_shared_context_responses_equal_pir_tpu(ct_mult):
    """A client, a database and a server on one context (with its lazily
    derived tables and BEHZ tool shared) answer with pir_tpu's bytes, before
    and after the client has decrypted through the shared context."""
    params = tiny_pir_params(dbsize=30, bytes_per_item=8, dimensions=2, n=64,
                             use_ciphertext_multiplication=ct_mult)
    raw = generate_test_db(params.num_items, params.bytes_per_item, seed=8)
    client = pt.PirClient(params, seed=9, compress_queries=True, device="cpu")
    db = pt.PirDatabase.create(raw, params, device="cpu")
    server = pt.PirServer(db, params, reply_limbs=1)
    assert client.ctx is db.ctx is server.ctx is TCtx.for_params(params, "cpu")
    if ct_mult:
        assert tmul.rns_tool_for(client.ctx) is tmul.rns_tool_for(db.ctx)
    jserver = JServer(JDB.create(raw, params), params, reply_limbs=1)
    for indexes in ([4], [29, 0]):
        request = client.create_request(indexes)
        got = server.process_request(request)
        assert got.SerializeToString() == jserver.process_request(request).SerializeToString()
        assert client.process_response(indexes, got) == [raw[i] for i in indexes]
