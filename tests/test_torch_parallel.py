"""The port's mesh against pir_tpu's: ranks of pir_tpu_torch (gloo, one
subprocess each, on the CPU) serve a request through PirServer(mesh=...),
and every rank's Response bytes must equal those of pir_tpu's mesh server
(parallel.sharded.make_sharded_pipeline on the 8-device CPU mesh of
conftest.py) and of the port's single-device server.  Tolerance 0.

Two launches run every case: four ranks (db x batch, db x limb, d=1 over
db, a mod-switched reply) and two ranks (limb=2 on both layouts, the K6
single-word and hi-plane cases).  The same launches serve the
ciphertext-multiplication cases (CT_MULT) on the db and batch axes, as
pir_tpu's tests/test_parallel.py does, and one whose D0 is odd.  In the SHARDED cases no rank builds the
whole database: each loads only its shard of a PirDatabase.ingest_shards
checkpoint and builds its block of the planes
(parallel.distributed.planes_from_shard_rows).  Every wait has a timeout, and a launch
kills its ranks when one fails or time runs out.  The layouts the mesh
refuses are checked in this process, on the mesh's shape alone.  Every
rank moves its query and reply arrays packed (the server's default
packed_transfer) except in the UNPACKED cases, held to pir_tpu's mesh
server with packed_transfer=False.
"""

import jax
import numpy as np
import pytest
import torch

from pir_tpu.parallel import sharded as jsharded
from pir_tpu.pir.client import PirClient as JClient
from pir_tpu.pir.database import PirDatabase as JDB
from pir_tpu.pir.server import PirServer as JServer
from pir_tpu.testing.fixtures import generate_test_db
from pir_tpu.testing.params import tiny_pir_params
import pir_tpu_torch as pt
from pir_tpu_torch.parallel import mesh_worker, sharded
from pir_tpu_torch.pir import wire as twire
from pir_tpu_torch.proto import payload_pb2 as pb

LAUNCH_TIMEOUT_S = 300  # whole launch; each collective gives up after 120 s

# name: (ranks, d, q_bits, scan_impl, batch, limb, reply_limbs, indexes)
CASES = {
    "db2xbatch2_planes": (4, 2, (26, 27, 28), "pallas", 2, 1, None, [3, 17, 29]),
    "db2xbatch2_shoup": (4, 2, (26, 27, 28), "xla", 2, 1, None, [3, 17, 29]),
    "db2xlimb2_planes": (4, 2, (26, 27, 28), "pallas", 1, 2, None, [0, 29]),
    "d1_db4_planes": (4, 1, (26, 34, 36), "pallas", 1, 1, None, [3, 29]),
    "db2xbatch2_reply1": (4, 2, (30, 30, 32), "pallas", 2, 1, 1, [0, 29]),
    "limb2_planes_u32": (2, 2, (26, 27, 28), "pallas", 1, 2, None, [3, 29]),
    "limb2_planes_hi": (2, 2, (26, 34, 36), "pallas", 1, 2, None, [3, 29]),
    "limb2_shoup": (2, 2, (26, 34, 36), "xla", 1, 2, None, [3, 29]),
    "db2xlimb2_shards": (4, 2, (26, 34, 36), "pallas", 1, 2, None, [3, 29]),
    "db4_shards_d1": (4, 1, (26, 34, 36), "pallas", 4, 1, None, [0, 17, 29, 5]),
    "db2_shards_reply1": (2, 2, (30, 30, 32), "pallas", 1, 1, 1, [0, 29]),
    "db2_planes_unpacked": (2, 2, (34, 36, 42), "pallas", 1, 1, None, [3, 29]),
    "db2xbatch2_unpacked": (4, 2, (26, 34, 36), "pallas", 2, 1, None, [3, 17, 29]),
}
SHARDED = {"db2xlimb2_shards", "db4_shards_d1", "db2_shards_reply1"}
UNPACKED = {"db2_planes_unpacked", "db2xbatch2_unpacked"}
# ciphertext-multiplication mode, name: (ranks, d, items, batch, indexes)
CT_MULT = {
    "ct_mult_d1_db2xbatch2": (4, 1, 30, 2, [3, 29]),
    "ct_mult_d2_db2": (2, 2, 30, 1, [3, 29]),
    "ct_mult_d2_odd_d0_db2": (2, 2, 45, 1, [0, 44]),
}
# name: (limb, reply_limbs, use_ct_mult, message), on L=2
ERRORS = {
    "limb4_does_not_divide_L": (4, None, False, "must divide"),
    "limb2_reply_limbs": (2, 1, False, "reply_limbs"),
    "limb2_ct_mult": (2, None, True, "ciphertext-multiplication"),
    "ct_mult_db_planes": (1, None, True, "decomposition-mode operand"),
}


def _params(d, q_bits):
    return tiny_pir_params(dbsize=30, bytes_per_item=8, dimensions=d, n=64, q_bits=q_bits)


def _request(name):
    world, d, q_bits, impl, batch, limb, reply_limbs, indexes = CASES[name]
    params = _params(d, q_bits)
    raw = generate_test_db(30, params.bytes_per_item)
    client = JClient(params, seed=5)
    return params, raw, client, client.create_request(indexes)


def _ct_mult_request(name):
    world, d, items, batch, indexes = CT_MULT[name]
    params = tiny_pir_params(dbsize=items, bytes_per_item=8, dimensions=d, n=64,
                             use_ciphertext_multiplication=True)
    raw = generate_test_db(items, params.bytes_per_item)
    client = JClient(params, seed=5)
    return params, raw, client, client.create_request(indexes)


def _job(world, shard_root):
    cases = []
    for name, (w, _, _, batch, _) in CT_MULT.items():
        if w == world:
            params, raw, _, request = _ct_mult_request(name)
            cases.append({
                "name": name, "params": twire.pir_params_to_proto(params).SerializeToString(),
                "items": b"".join(raw), "scan_impl": "auto", "batch": batch, "limb": 1,
                "requests": [request.SerializeToString()], "batched": True,
            })
    for name, (w, d, q_bits, impl, batch, limb, reply_limbs, _) in CASES.items():
        if w != world:
            continue
        params, raw, _, request = _request(name)
        case = {
            "name": name, "params": twire.pir_params_to_proto(params).SerializeToString(),
            "scan_impl": impl, "batch": batch, "limb": limb,
            "reply_limbs": reply_limbs, "requests": [request.SerializeToString()],
            "batched": True, "packed_transfer": name not in UNPACKED,
        }
        if name in SHARDED:
            case["shard_dir"] = str(shard_root / name)
            pt.PirDatabase.ingest_shards(iter(raw), params, shard_root / name,
                                         world // (batch * limb), chunk_pts=2)
        else:
            case["items"] = b"".join(raw)
        cases.append(case)
    return {"world": world, "backend": "gloo", "devices": ["cpu"] * world,
            "timeout_s": 120, "cases": cases}


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """Each launch's per-rank results, started on first use."""
    done = {}

    def get(world):
        if world not in done:
            done[world] = mesh_worker.run_job(
                _job(world, tmp_path_factory.mktemp(f"shards{world}")),
                tmp_path_factory.mktemp(f"mesh{world}"), LAUNCH_TIMEOUT_S,
            )
        return done[world]

    return get


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_response_equals_pir_tpu(launches, name):
    world, d, q_bits, impl, batch, limb, reply_limbs, indexes = CASES[name]
    params, raw, client, request = _request(name)
    jdb = JDB.create(raw, params, scan_impl=impl)
    jmesh = jsharded.default_mesh(devices=jax.devices()[:world], batch=batch, limb=limb)
    packed = name not in UNPACKED
    want = JServer(jdb, params, reply_limbs=reply_limbs, packed_transfer=packed,
                   mesh=jmesh).process_request(request)
    want = want.SerializeToString()
    single = pt.PirServer(
        pt.PirDatabase.create(raw, params, scan_impl=impl, device="cpu"), params,
        reply_limbs=reply_limbs, packed_transfer=packed,
    ).process_request(request)
    assert single.SerializeToString() == want
    for rank, results in enumerate(launches(world)):
        got = results[name]
        assert got["responses"] == [want], f"rank {rank}"
        assert got["batched"] == [want], f"rank {rank} (process_request_batched)"
    assert client.process_response(indexes, single) == [raw[i] for i in indexes]


@pytest.mark.parametrize("name", list(CT_MULT))
def test_mesh_ct_mult_response_equals_pir_tpu(launches, name):
    """Ciphertext-multiplication mode on the db and batch axes: every rank's
    Response equals pir_tpu's mesh server's and the port's single-device
    server's (each rank's block of D0 through kernel D's plain version,
    the ranks' reduced partials summed)."""
    world, d, _, batch, indexes = CT_MULT[name]
    params, raw, client, request = _ct_mult_request(name)
    assert params.dimensions[0] % 2 or "odd" not in name
    jmesh = jsharded.default_mesh(devices=jax.devices()[:world], batch=batch)
    want = JServer(JDB.create(raw, params), params, mesh=jmesh).process_request(request)
    want = want.SerializeToString()
    single = pt.PirServer(pt.PirDatabase.create(raw, params, device="cpu"), params)
    assert single.process_request(request).SerializeToString() == want
    for rank, results in enumerate(launches(world)):
        got = results[name]
        assert got["responses"] == [want], f"rank {rank}"
        assert got["batched"] == [want], f"rank {rank} (process_request_batched)"
    assert client.process_response(indexes, pb.Response.FromString(want)) == [
        raw[i] for i in indexes]


class _MeshShape:
    """The shape half of a parallel.sharded.Mesh: the pipeline and the
    server refuse these layouts before any rank communicates."""

    def __init__(self, **shape):
        self.shape = shape
        self.axis_names = tuple(shape)

    def size(self, axis):
        return self.shape.get(axis, 1)


@pytest.mark.parametrize("name", list(ERRORS))
def test_mesh_value_errors(name):
    limb, reply_limbs, use_ct_mult, message = ERRORS[name]
    params = _params(2, (26, 27, 28))
    db = pt.PirDatabase.create(generate_test_db(30, 8), params, device="cpu")
    mesh = _MeshShape(db=1, batch=1, limb=limb)
    with pytest.raises(ValueError, match=message):
        sharded.make_sharded_pipeline(
            db.ctx, params.dimensions, None, mesh, reply_limbs=reply_limbs,
            db_planes=db.db_planes, use_ct_mult=use_ct_mult,
        )
    if use_ct_mult and limb > 1:  # the server refuses ct-mult params on a limb axis
        ct_mult = tiny_pir_params(dbsize=30, bytes_per_item=8, dimensions=2, n=64,
                                  use_ciphertext_multiplication=True)
        with pytest.raises(ValueError, match="limb"):
            pt.PirServer(db, ct_mult, mesh=mesh)


def test_replicate_to_mesh(launches):
    """Rank 0's array reaches every rank (u64 bits included)."""
    for world in (2, 4):
        assert all(r["replicate_ok"] for r in launches(world))


class _MeshCoords(_MeshShape):
    """A mesh shape and this rank's coordinates on it."""

    def __init__(self, coords, **shape):
        super().__init__(**shape)
        self._coords = coords

    def coord(self, axis):
        return self._coords.get(axis, 0)


def test_rank_planes_are_the_whole_planes_block():
    """planes_from_shard_rows' block, from the rank's rows only, equals the
    slice of the whole database's planes that the pipeline cuts for that
    rank (every db and limb coordinate; the last shard padded), and its
    checks refuse a wrong start, too many rows, and d=1 over several db
    ranks."""
    from pir_tpu_torch.parallel import distributed
    from pir_tpu_torch.pir import database

    params = _params(2, (26, 34, 36))  # L = 2
    db = pt.PirDatabase.create(generate_test_db(30, 8), params, device="cpu")
    for n_db, n_limb in ((1, 1), (2, 1), (2, 2), (3, 2)):
        rows = database.shard_rows(params, n_db)
        l_local = db.ctx.L // n_limb
        for c_db, (r0, r1) in enumerate(database.shard_row_ranges(params, n_db)):
            for c_limb in range(n_limb):
                mesh = _MeshCoords({"db": c_db, "limb": c_limb}, db=n_db, batch=1, limb=n_limb)
                got = distributed.planes_from_shard_rows(
                    params, db.ctx, db.db_pts[r0:r1], mesh, c_db * rows)
                for g, whole in zip(got, db.db_planes):
                    want = sharded._block(whole, 0, n_db, n_db, c_db)
                    assert torch.equal(g, want.narrow(1, c_limb * l_local, l_local))
    mesh = _MeshCoords({"db": 1}, db=2, batch=1)
    rows = database.shard_rows(params, 2)
    with pytest.raises(ValueError, match="row_start"):
        distributed.planes_from_shard_rows(params, db.ctx, db.db_pts[:1], mesh, 0)
    with pytest.raises(ValueError, match="more local rows"):
        distributed.planes_from_shard_rows(
            params, db.ctx, np.zeros((rows + 1, 64), np.uint64), mesh, rows)
    d1 = _params(1, (26, 34, 36))
    with pytest.raises(ValueError, match="inner dimension"):
        distributed.planes_from_shard_rows(
            d1, pt.PirDatabase(d1, device="cpu").ctx, np.zeros((0, 64), np.uint64), mesh,
            database.shard_rows(d1, 2))
    with pytest.raises(ValueError, match="this rank's planes"):
        sharded.make_sharded_pipeline(db.ctx, params.dimensions, None, mesh,
                                      db_planes=db.db_planes, local_planes=True)


def test_rank_shards_hold_their_own_storage():
    """A rank's shard is a copy, never a view that keeps the whole database
    alive; a shard that is the whole database is not copied."""
    whole = torch.arange(4 * 3 * 5 * 8, dtype=torch.int64).reshape(4, 3, 5, 8)
    for view in (whole[2:], whole[:, 1:2], whole[1:3, :2]):
        part = sharded._own(view)
        assert part.untyped_storage().nbytes() == part.nbytes
        assert torch.equal(part, view)
    assert sharded._own(whole) is whole
