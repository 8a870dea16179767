"""The port's checkpoints and shard files against pir_tpu's, both ways:

* a ``save`` of either package loads in the other, in both layouts (planes
  and Shoup table), and the loaded database answers with the Response
  bytes of a database built directly; the two packages' checkpoints hold
  equal arrays; a checkpoint of other parameters is refused;
* ``ingest_shards`` writes the same shard files and meta.json as
  pir_tpu's, byte for byte, with the same errors, and ``load_shards``
  gives the database a direct ``create`` gives.

Tolerance 0 (equal arrays, equal bytes).  The mesh fed by the shard files
is in tests/test_torch_parallel.py."""

import numpy as np
import pytest
import torch

from pir_tpu.pir.client import PirClient as JClient
from pir_tpu.pir.database import PirDatabase as JDB
from pir_tpu.pir.server import PirServer as JServer
from pir_tpu.testing.fixtures import generate_test_db
from pir_tpu.testing.params import tiny_pir_params
import pir_tpu_torch as pt
from pir_tpu_torch.pir import database as tdatabase

LAYOUTS = {"planes": "pallas", "shoup": "xla"}


@pytest.fixture(scope="module")
def stack():
    params = tiny_pir_params(dbsize=30, bytes_per_item=8, dimensions=2, n=64,
                             q_bits=(26, 34, 36))
    raw = generate_test_db(30, 8)
    client = JClient(params, seed=5)
    request = client.create_request([3, 29])
    want = JServer(JDB.create(raw, params), params).process_request(request)
    return params, raw, client, request, want.SerializeToString()


def _serve(db, params, request) -> bytes:
    return pt.PirServer(db, params).process_request(request).SerializeToString()


def _operands(db) -> list:
    if db._use_planes:
        return list(db.db_planes)
    return [db.db_ntt, db.db_ntt_shoup]


def _arrays(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


@pytest.mark.parametrize("saved_by", LAYOUTS)
@pytest.mark.parametrize("loaded_as", LAYOUTS)
def test_pir_tpu_checkpoint_loads_in_port(stack, tmp_path, saved_by, loaded_as):
    params, raw, _, request, want = stack
    path = tmp_path / "db.npz"
    JDB.create(raw, params, scan_impl=LAYOUTS[saved_by]).save(path)
    db = pt.PirDatabase.load(path, params, scan_impl=LAYOUTS[loaded_as], device="cpu")
    direct = pt.PirDatabase.create(raw, params, scan_impl=LAYOUTS[loaded_as], device="cpu")
    assert np.array_equal(db.db_pts, direct.db_pts)
    for x, y in zip(_operands(db), _operands(direct), strict=True):
        assert (x is None and y is None) or torch.equal(x, y)
    assert _serve(db, params, request) == want


@pytest.mark.parametrize("saved_by", LAYOUTS)
@pytest.mark.parametrize("loaded_as", LAYOUTS)
def test_port_checkpoint_loads_in_pir_tpu(stack, tmp_path, saved_by, loaded_as):
    params, raw, _, request, want = stack
    port_path, ref_path = tmp_path / "port.npz", tmp_path / "ref.npz"
    pt.PirDatabase.create(raw, params, scan_impl=LAYOUTS[saved_by], device="cpu").save(port_path)
    JDB.create(raw, params, scan_impl=LAYOUTS[saved_by]).save(ref_path)
    port, ref = _arrays(port_path), _arrays(ref_path)
    assert sorted(port) == sorted(ref) == ["db_ntt", "db_pts", "num_items"]
    for key in ref:
        assert port[key].dtype == ref[key].dtype and np.array_equal(port[key], ref[key]), key
    jdb = JDB.load(port_path, params, scan_impl=LAYOUTS[loaded_as])
    assert JServer(jdb, params).process_request(request).SerializeToString() == want


def test_load_refuses_other_parameters(stack, tmp_path):
    params, raw, *_ = stack
    path = tmp_path / "db.npz"
    pt.PirDatabase.create(raw, params, device="cpu").save(path)
    fewer = tiny_pir_params(dbsize=20, bytes_per_item=8, dimensions=2, n=64, q_bits=(26, 34, 36))
    with pytest.raises(ValueError, match="does not match"):
        pt.PirDatabase.load(path, fewer, device="cpu")
    other_ring = tiny_pir_params(dbsize=30, bytes_per_item=8, dimensions=2, n=128,
                                 q_bits=(26, 34, 36))
    with pytest.raises(ValueError, match="does not match"):
        pt.PirDatabase.load(path, other_ring, device="cpu")
    with pytest.raises(ValueError, match="not populated"):
        pt.PirDatabase(params, device="cpu").save(tmp_path / "empty.npz")


@pytest.mark.parametrize("n_shards,chunk_pts", [(1, 2048), (2, 1), (4, 2)])
def test_ingest_shards_files_equal_pir_tpu(stack, tmp_path, n_shards, chunk_pts):
    """Equal shard files and meta.json (4 shards leave the last ones with
    no rows, and no file)."""
    params, raw, *_ = stack
    got = pt.PirDatabase.ingest_shards(iter(raw), params, tmp_path / "port", n_shards, chunk_pts)
    want = JDB.ingest_shards(iter(raw), params, tmp_path / "ref", n_shards, chunk_pts)
    assert [p.replace("/port/", "/ref/") for p in got] == want
    names = sorted(f.name for f in (tmp_path / "ref").iterdir())
    assert names == sorted(f.name for f in (tmp_path / "port").iterdir())
    assert "meta.json" in names
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "ref" / name).read_bytes()
    assert tdatabase.shard_row_ranges(params, n_shards) == JDB(params).shard_row_ranges(n_shards)
    for s, (r0, r1) in enumerate(pt.PirDatabase(params, device="cpu").shard_row_ranges(n_shards)):
        if r1 > r0:
            rows = pt.PirDatabase.load_shard_rows(tmp_path / "port", s)
            assert np.array_equal(rows, JDB.load_shard_rows(tmp_path / "ref", s))


def test_ingest_errors_equal_pir_tpu(stack, tmp_path):
    params, raw, *_ = stack
    for bad, message in ((raw[:-1], "iterator exhausted after 29 items"),
                         (raw[:4] + [raw[4][:7]] + raw[5:], "item 4 has 7 bytes")):
        for cls, sub in ((pt.PirDatabase, "port"), (JDB, "ref")):
            with pytest.raises(ValueError, match=message):
                cls.ingest_shards(iter(bad), params, tmp_path / sub, 2)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_load_shards_equals_create(stack, tmp_path, layout):
    params, raw, _, request, want = stack
    pt.PirDatabase.ingest_shards(iter(raw), params, tmp_path, 2)
    db = pt.PirDatabase.load_shards(tmp_path, params, scan_impl=LAYOUTS[layout], device="cpu")
    direct = pt.PirDatabase.create(raw, params, scan_impl=LAYOUTS[layout], device="cpu")
    assert np.array_equal(db.db_pts, direct.db_pts)
    assert _serve(db, params, request) == want
    other = tiny_pir_params(dbsize=20, bytes_per_item=8, dimensions=2, n=64, q_bits=(26, 34, 36))
    with pytest.raises(ValueError, match="does not match"):
        pt.PirDatabase.load_shards(tmp_path, other, device="cpu")
