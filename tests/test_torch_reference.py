"""The reference's own configurations through the port: every
REFERENCE_MATRIX row (correctness_test.cpp:95-113, both modes, N=8192
included) and every TPU32_MATRIX row (tests/test_correctness.py) — a
request of pir_tpu's client, served by pir_tpu.PirServer and by
pir_tpu_torch.PirServer over a database built from pir_tpu's plaintexts
(convert.database_from_plaintexts), on the CPU.  The Response bytes must be
equal and every item must decode.  Real rings (N=4096, 8192): ``slow``."""

import pytest

from pir_tpu.core.params import create_pir_parameters, generate_encryption_params
from pir_tpu.pir.client import PirClient as JClient
from pir_tpu.pir.database import PirDatabase as JDB
from pir_tpu.pir.server import PirServer as JServer
from pir_tpu.testing.fixtures import generate_test_db
from test_correctness import REFERENCE_MATRIX, TPU32_MATRIX

import pir_tpu_torch as pt
from pir_tpu_torch import convert
from pir_tpu_torch.proto import payload_pb2 as pb


def _serve_both(params, indices):
    raw = generate_test_db(params.num_items, params.bytes_per_item, 42)
    jdb = JDB.create(raw, params)
    client = JClient(params, seed=7)
    req = client.create_request(indices)
    want = JServer.create(jdb, params).process_request(req)
    tdb = convert.database_from_plaintexts(params, jdb.db_pts, device="cpu")
    got = pt.PirServer(tdb, params).process_request(pb.Request.FromString(req.SerializeToString()))
    assert got.SerializeToString() == want.SerializeToString()
    assert client.process_response(indices, got) == [raw[i] for i in indices]


@pytest.mark.slow
@pytest.mark.parametrize("ct_mult,n,t_bits,elem,bpc,dbsize,d,indices", REFERENCE_MATRIX)
def test_reference_matrix_response_bytes_equal_pir_tpu(
    ct_mult, n, t_bits, elem, bpc, dbsize, d, indices
):
    params = create_pir_parameters(
        dbsize, elem, d, generate_encryption_params(n, t_bits),
        use_ciphertext_multiplication=ct_mult, bits_per_coeff=bpc,
    )
    _serve_both(params, indices)


@pytest.mark.slow
@pytest.mark.parametrize("n,t_bits,elem,bpc,dbsize,d,indices", TPU32_MATRIX)
def test_tpu32_matrix_response_bytes_equal_pir_tpu(n, t_bits, elem, bpc, dbsize, d, indices):
    params = create_pir_parameters(
        dbsize, elem, d, generate_encryption_params(n, t_bits, profile="tpu32"),
        bits_per_coeff=bpc,
    )
    _serve_both(params, indices)
