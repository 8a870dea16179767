"""The card-sized SealPIR deployment (portbench/configs/sealpir-16m-n4096-t20.json)
and what it asks of the port, on the CPU:

* the shape the configuration derives, in the program and in the
  benchmark's frozen reference alike: 2^24 items of 288 B in 714 x 713
  plaintexts of 33 items, 11 expansion levels, and the scan's bytes a query
  (arithmetic only, no tensors);
* at a tiny ring, a two-dimensional database whose dimension sum passes
  N/2, so the expansion runs every level the ring allows (as 11 of
  N=4096's 12 do there), served by ``PirServer.process_stream`` at depth 4
  and decoded by the frozen client (``portbench.reference``) to the stored
  items;
* the database build's spans (``pir.db.pack``, ``pir.db.ntt`` a step,
  ``pir.db.layout``) and ``PirDatabase.build_stats``;
* the build's NTT steps where the hypercube's zero padding fills whole
  steps, word for word against pir_tpu's database.

Tolerance 0 (equal words, equal bytes)."""

import numpy as np
import pytest
import torch

from pir_tpu.pir.database import PirDatabase as JDB
from pir_tpu.testing.fixtures import generate_test_db
from pir_tpu.testing.params import tiny_encryption_params, tiny_pir_params
import pir_tpu_torch as pt
from pir_tpu_torch.pir import database as tdatabase
from pir_tpu_torch.proto import payload_pb2 as pb
from pir_tpu_torch.utils import profiling
from portbench import measure, run, spec
from portbench.reference import bfv, wire
from portbench.reference import params as rp
from portbench.reference.client import Client

CELL = "sealpir-16m-n4096-t20.single-d4"


def test_sealpir16m_configuration_derives_the_deployment_shape():
    cell = spec.load(CELL)
    cfg = cell.config
    assert (cfg["items"], cfg["item_bytes"], cfg["poly_modulus_degree"]) == (1 << 24, 288, 4096)
    assert cell.chips == 1 and cell.traffic["queries_per_request"] == 1
    params = run.program_params(cfg)
    ref = rp.from_config(cfg)
    assert tuple(params.dimensions) == ref.dimensions == (714, 713)
    assert params.num_pt == ref.num_pt == 508_401
    assert params.items_per_plaintext == ref.items_per_plaintext == 33
    assert rp.ceil_log2(ref.dimensions_sum) == 11  # 1,427 selection rows -> 2,048
    assert measure.scan_bytes(cfg, ref, 1) == 19_110_703_104
    # the planes: a u32 and a u8 word a coefficient of each ciphertext limb
    assert 714 * 713 * ref.L * ref.n * 5 == 20_851_998_720


def _tiny_config(items: int) -> dict:
    ep = tiny_encryption_params(64)
    return {
        "items": items, "item_bytes": 8, "dimensions": 2,
        "poly_modulus_degree": ep.poly_modulus_degree,
        "plain_modulus_bits": int(ep.plain_modulus).bit_length(),
        "plain_modulus": int(ep.plain_modulus),
        "coeff_modulus": [int(q) for q in ep.coeff_modulus],
        "mode": "decomposition", "reencode_digits": "balanced",
    }


def test_every_expansion_level_streams_to_the_frozen_client():
    """2,992 items of 8 B at N=64: 17 x 16 plaintexts, 33 selection rows,
    so all log2(64) = 6 levels expand; 6 requests of 2 clients through
    process_stream at depth 4, every reply decoded to its item."""
    cfg = _tiny_config(2_992)
    ref = rp.from_config(cfg)
    assert ref.dimensions == (17, 16) and ref.dimensions_sum > ref.n // 2
    levels = rp.ceil_log2(ref.dimensions_sum)
    assert 1 << levels == ref.n
    ep = pt.EncryptionParams(cfg["poly_modulus_degree"], cfg["plain_modulus"],
                             tuple(cfg["coeff_modulus"]))
    params = pt.create_pir_parameters(cfg["items"], cfg["item_bytes"], 2, ep)
    items = np.random.default_rng(25).integers(0, 256, (cfg["items"], 8), dtype=np.uint8)
    db = pt.PirDatabase.create([r.tobytes() for r in items], params, device="cpu")
    server = pt.PirServer(db, params, reply_limbs=pt.reply_limbs_for(params))
    ctx = bfv.Context(ref, "cpu")
    clients = [Client(ctx, np.random.default_rng([25, c])) for c in range(2)]
    indexes = [[0], [2_991], [1_500], [17 * 11], [2_990], [777]]
    data = [clients[k % 2].requests([ix])[0] for k, ix in enumerate(indexes)]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        responses = list(server.process_stream((pb.Request.FromString(d) for d in data), depth=4))
    spans = profiling.span_summary()
    assert spans["pir.expand.level"]["count"] == levels * len(indexes)
    assert server.stream_stats["max_in_flight"] == 4
    for k, (ix, response) in enumerate(zip(indexes, responses)):
        replies = wire.response_replies(response.SerializeToString())
        assert clients[k % 2].items(np.stack(replies), ix) == [items[i].tobytes() for i in ix]


@pytest.mark.parametrize("scan_impl", ["pallas", "xla"])
@pytest.mark.parametrize("kind", ["strings", "ints"])
def test_build_spans_and_stats(tmp_path, scan_impl, kind):
    # integers: one a plaintext (64-byte items fill one at N=64)
    params = tiny_pir_params(dbsize=40 if kind == "strings" else 12,
                             bytes_per_item=8 if kind == "strings" else 64, dimensions=2, n=64,
                             q_bits=(34, 36, 37))
    raw = (generate_test_db(params.num_items, params.bytes_per_item, seed=4) if kind == "strings"
           else list(range(3, 3 + params.num_items)))
    with profiling.trace(tmp_path):
        db = pt.PirDatabase.create(raw, params, scan_impl=scan_impl, device="cpu")
    spans = {s.id: s for s in profiling.recorded_spans()}
    by_name = {}
    for s in spans.values():
        by_name.setdefault(s.name, []).append(s)
    stats = db.build_stats
    steps = -(-db.padded_size // db._row_step())
    assert stats["ntt_steps"] == steps
    assert [len(by_name[n]) for n in ("pir.db.pack", "pir.db.ntt", "pir.db.layout")] == [1, steps, 1]
    layout = by_name["pir.db.layout"][0]
    assert all(spans[s.parent] is layout for s in by_name["pir.db.ntt"])
    assert by_name["pir.db.pack"][0].end_ns <= layout.start_ns
    operands = db.db_planes if scan_impl == "pallas" else (db.db_ntt, db.db_ntt_shoup)
    assert stats["device_bytes"] == sum(t.numel() * t.element_size()
                                        for t in operands if t is not None) > 0
    assert stats["host_bytes"] == db.db_pts.nbytes == params.num_pt * 64 * 8
    assert stats["plaintexts"] == params.num_pt
    assert isinstance(stats["pack_s"], float) and stats["pack_s"] >= 0
    # without a profiler session the counts are the same
    again = pt.PirDatabase.create(raw, params, scan_impl=scan_impl, device="cpu")
    assert {k: v for k, v in again.build_stats.items() if k != "pack_s"} == {
        k: v for k, v in stats.items() if k != "pack_s"}


@pytest.mark.parametrize("scan_impl", ["pallas", "xla"])
def test_padding_steps_equal_pir_tpu(monkeypatch, scan_impl):
    """99 items: 9 plaintexts in 3 x 2 x 2 (12 rows), so at one prefix a
    step the last step holds only the hypercube's zero padding."""
    monkeypatch.setattr(tdatabase, "NTT_PREFIXES", 1)
    params = tiny_pir_params(dbsize=99, bytes_per_item=8, dimensions=3, n=64,
                             q_bits=(34, 36, 37))
    assert (params.num_pt, tuple(params.dimensions)) == (9, (3, 2, 2))
    raw = generate_test_db(params.num_items, params.bytes_per_item, seed=6)
    db = pt.PirDatabase.create(raw, params, scan_impl=scan_impl, device="cpu")
    assert db.build_stats["ntt_steps"] == 6
    want = np.asarray(JDB.create(raw, params, scan_impl="xla").db_ntt)
    assert np.array_equal(db._host_ntt(), want)


@pytest.mark.parametrize("bits", [19, 61], ids=["native", "pack_items"])
@pytest.mark.parametrize("chunk", [1, 3, 2048])
def test_chunked_pack_equals_one_pack(monkeypatch, bits, chunk):
    """pack_uniform's chunks on threads give the words of one pack_rows
    over the joined, zero-padded items (98 items of 24 B, 5 a plaintext:
    the last plaintext holds 3), at a width the native encoder packs and
    at one it leaves to pack_items."""
    monkeypatch.setattr(tdatabase, "PACK_CHUNK", chunk)
    raw = generate_test_db(98, 24, seed=7)
    want = tdatabase.pack_rows(b"".join(raw) + bytes(2 * 24), 20, 5 * 24, bits, 64)
    got = tdatabase.pack_uniform(raw, 5, 24, 20, bits, 64)
    assert got.dtype == np.uint64 and np.array_equal(got, want)
