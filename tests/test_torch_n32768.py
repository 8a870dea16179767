"""N=32768 on SEAL's chain (15 x 55-bit primes and a 56-bit special prime,
so the Shoup-table layout and the key switch's generic inner product) on
the CPU: a request of pir_tpu's client, served by pir_tpu.PirServer and by
pir_tpu_torch.PirServer over a database of a few plaintexts.  The Response
bytes must be equal and every item must decode.  ``slow`` (the pattern of
test_torch_reference.py); the card serves the full 2^20-item database at
this ring in chip_smoke.py's phase 20."""

import pytest

from pir_tpu.core.params import create_pir_parameters, generate_encryption_params
from pir_tpu.pir.client import PirClient as JClient
from pir_tpu.pir.database import PirDatabase as JDB
from pir_tpu.pir.server import PirServer as JServer
from pir_tpu.testing.fixtures import generate_test_db

import pir_tpu_torch as pt
from pir_tpu_torch.proto import payload_pb2 as pb


@pytest.mark.slow
def test_n32768_response_bytes_equal_pir_tpu():
    params = create_pir_parameters(1000, 288, 2, generate_encryption_params(32768, 24))
    assert params.num_pt > 1
    raw = generate_test_db(params.num_items, params.bytes_per_item, 42)
    client = JClient(params, seed=7)
    indexes = [5, params.num_items - 1]
    req = client.create_request(indexes)
    reply_limbs = pt.reply_limbs_for(params)
    want = JServer(JDB.create(raw, params), params, reply_limbs=reply_limbs).process_request(req)
    tdb = pt.PirDatabase.create(raw, params, device="cpu")
    assert tdb.db_ntt is not None  # 55-bit primes: the Shoup-table layout
    got = pt.PirServer(tdb, params, reply_limbs=reply_limbs).process_request(
        pb.Request.FromString(req.SerializeToString()))
    assert got.SerializeToString() == want.SerializeToString()
    assert client.process_response(indexes, got) == [raw[i] for i in indexes]
