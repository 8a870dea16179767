"""The port's spans (utils/profiling.py) on a tiny CPU server: nothing is
recorded without a profiler; under one, a streamed request's stage spans
in the caller's thread and its reply spans in the worker's carry one
request id and the right parents, tile the submission, and show in the
profiler's host events; a key-cache miss is a span and a count, a ninth
key set an eviction, a failed request a count; Responses are byte-equal
with the profiler on and off; concurrent threads lose no span; the buffer
drops its oldest span when full; and self time is a span's duration less
what its children cover."""

import json
import sys
import threading

import pytest
from torch.profiler import ProfilerActivity, profile

from pir_tpu.testing.fixtures import generate_test_db
from pir_tpu.testing.params import tiny_pir_params
import pir_tpu_torch as pt
from pir_tpu_torch.utils import profiling
from pir_tpu_torch.utils.profiling import SpanRecord

CALLER = {"pir.keys.digest", "pir.query.load", "pir.query.upload", "pir.expand",
          "pir.expand.level", "pir.scan.inner", "pir.scan.upper", "pir.modswitch",
          "pir.reply.enqueue", "pir.stream.wait"}
WORKER = {"pir.reply.serialize"}  # no reply copy to wait for on the CPU
PARENTS = {"pir.expand.level": "pir.expand", "pir.keys.upload": "pir.keys.load"}
INDEXES = {"single": [[5], [0], [29], [12], [7]], "multi": [[2, 17, 29], [1, 4, 9], [28, 0, 13]]}


@pytest.fixture(scope="module")
def stack():
    params = tiny_pir_params(dbsize=30, bytes_per_item=8, dimensions=2, n=64)
    raw = generate_test_db(30, 8)
    db = pt.PirDatabase.create(raw, params, device="cpu")
    clients = [pt.PirClient(params, seed=70 + c, device="cpu") for c in range(9)]
    return params, raw, db, clients


def _server(stack):
    params, _, db, _ = stack
    return pt.PirServer(db, params, reply_limbs=pt.reply_limbs_for(params))


def _requests(stack, kind, clients=1):
    _, _, _, cs = stack
    return [cs[i % clients].create_request(ix) for i, ix in enumerate(INDEXES[kind])]


def _bytes(responses):
    return [r.SerializeToString() for r in responses]


def test_nothing_is_recorded_without_a_profiler(stack):
    server = _server(stack)
    reqs = _requests(stack, "single")
    with profile(activities=[ProfilerActivity.CPU]):
        server.process_request(reqs[0])  # a session's spans in the buffer
    before = profiling.recorded_spans()
    assert before
    assert profiling.span("pir.expand") is profiling.span("pir.scan.inner")  # one shared context
    list(server.process_stream(iter(reqs), depth=2))
    server.process_request(reqs[1])
    assert profiling.recorded_spans() == before


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_a_streamed_request_records_its_spans(stack, kind, tmp_path):
    server = _server(stack)
    reqs = _requests(stack, kind)
    server.process_request(reqs[0])  # the key set in the cache
    with profiling.trace(tmp_path) as prof:
        got = list(server.process_stream(iter(reqs), depth=2))
    assert len(got) == len(reqs)
    spans = profiling.recorded_spans()
    by_id = {s.id: s for s in spans}
    requests = {}
    for s in spans:
        requests.setdefault(s.request, []).append(s)
    assert None not in requests and len(requests) == len(reqs)
    caller = threading.current_thread().name
    for rid, own in requests.items():
        names = {s.name for s in own}
        assert names == CALLER | WORKER, (rid, names)
        for s in own:
            assert (s.thread == caller) == (s.name in CALLER)
            assert s.start_ns <= s.end_ns
            parent = by_id.get(s.parent)
            if s.name in PARENTS:
                assert parent.name == PARENTS[s.name] and parent.request == rid
                assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
            else:
                assert s.parent is None
        stages = sorted((s.start_ns, s.end_ns) for s in own
                        if s.thread == caller and s.parent is None and s.name != "pir.stream.wait")
        lo, hi = stages[0][0], max(e for _, e in stages)
        assert profiling._covered_ns(stages, lo, hi) >= 0.9 * (hi - lo)  # the stages tile it
    host_ranges = {e.name for e in prof.events()}
    assert CALLER | WORKER <= host_ranges
    written = json.loads((tmp_path / "spans.json").read_text())
    assert len(written["spans"]) == len(spans) and written["dropped"] == 0
    assert written["summary"] == json.loads(json.dumps(profiling.span_summary(spans)))
    assert (tmp_path / "trace.json").exists()
    stats = server.stream_stats
    assert (stats["key_hits"], stats["key_misses"], stats["key_evictions"]) == (len(reqs), 0, 0)
    assert stats["requests_failed"] == 0


def test_key_misses_and_an_eviction_are_spans_and_counts(stack, tmp_path):
    server = _server(stack)
    _, _, _, clients = stack
    reqs = [c.create_request([3]) for c in clients]  # nine key sets, a cache of eight
    with profiling.trace(tmp_path):
        list(server.process_stream(iter(reqs + reqs[-1:]), depth=2))
    stats = server.stream_stats
    assert (stats["key_misses"], stats["key_hits"], stats["key_evictions"]) == (9, 1, 1)
    spans = profiling.recorded_spans()
    loads = [s for s in spans if s.name == "pir.keys.load"]
    uploads = [s for s in spans if s.name == "pir.keys.upload"]
    assert len(loads) == len(uploads) == 9
    assert {s.parent for s in uploads} == {s.id for s in loads}
    assert len({s.request for s in loads}) == 9


def test_a_failed_request_is_counted(stack):
    server = _server(stack)
    reqs = _requests(stack, "single")
    broken = type(reqs[0])()
    broken.CopyFrom(reqs[1])
    broken.galois_keys = b""
    with pytest.raises(ValueError):
        list(server.process_stream(iter([reqs[0], broken, reqs[2]]), depth=2))
    assert server.stream_stats["requests_failed"] == 1
    assert server.stream_stats["requests"] == 1


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_responses_are_the_same_bytes_traced_or_not(stack, kind, tmp_path):
    server = _server(stack)
    reqs = _requests(stack, kind, clients=2)
    plain = _bytes(server.process_stream(iter(reqs), depth=2))
    with profiling.trace(tmp_path):
        traced = _bytes(server.process_stream(iter(reqs), depth=2))
        single = _bytes(server.process_request(r) for r in reqs)
    assert traced == plain == single
    _, raw, _, clients = stack
    for i, (ix, resp) in enumerate(zip(INDEXES[kind], server.process_stream(iter(reqs), depth=2))):
        assert clients[i % 2].process_response(ix, resp) == [raw[k] for k in ix]


def test_threads_recording_at_once_lose_no_span():
    threads, per = 12, 400
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    errors = []

    def work(t):
        try:
            with profiling.request_scope(t):
                for _ in range(per // 2):
                    with profiling.span("outer"):
                        with profiling.span("inner"):
                            pass
        except Exception as e:  # reported below
            errors.append(e)

    try:
        with profile(activities=[ProfilerActivity.CPU]):
            pool = [threading.Thread(target=work, args=(t,)) for t in range(threads)]
            for th in pool:
                th.start()
            for th in pool:
                th.join(timeout=120)
            assert not any(th.is_alive() for th in pool)
    finally:
        sys.setswitchinterval(switch)
    assert not errors
    spans = profiling.recorded_spans()
    assert len(spans) == threads * per and len({s.id for s in spans}) == len(spans)
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.name == "inner":
            outer = by_id[s.parent]
            assert outer.name == "outer" and (outer.thread, outer.request) == (s.thread, s.request)
        else:
            assert s.parent is None
    assert {s.request for s in spans} == set(range(threads))


def test_a_full_buffer_drops_its_oldest_spans():
    recorder = profiling._Recorder(capacity=4)
    for i in range(6):
        recorder.add(SpanRecord(i, "s", None, None, "t", i, i + 1))
    assert [s.id for s in recorder.spans] == [2, 3, 4, 5] and recorder.dropped == 2


def _rec(i, name, parent, start, end, request=0):
    return SpanRecord(i, name, request, parent, "t", start * 10**6, end * 10**6)


def test_self_time_is_the_duration_less_what_children_cover():
    spans = [_rec(0, "a", None, 0, 100), _rec(1, "b", 0, 10, 30), _rec(2, "b", 0, 40, 60),
             _rec(3, "c", 1, 15, 20), _rec(4, "c", 2, 50, 70), _rec(5, "a", None, 200, 210)]
    summary = profiling.span_summary(spans)
    assert summary["a"] == {"count": 2, "total_ms": 110.0, "self_ms": 100.0 - 40.0 + 10.0}
    # a child past its parent's end covers only the part inside it
    assert summary["b"] == {"count": 2, "total_ms": 40.0, "self_ms": 40.0 - 5.0 - 10.0}
    assert summary["c"] == {"count": 2, "total_ms": 25.0, "self_ms": 25.0}
