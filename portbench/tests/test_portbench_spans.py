"""The readers of the program's spans and of the unexplained idle share:
each on a fixed buffer or trace, each None where the program has no span
API, and a traced tiny run on the CPU that reports every one of them as a
number, with one request id in the buffer for every request served."""

import importlib.util
import sys
import types

import pytest

from portbench import run, spec
from tiny import tiny_cell

SPAN_METRICS = ["server.key_digest_ms", "server.query_load_ms", "server.enqueue_ms",
                "server.serialize_ms", "server.caller_wait_ms"]
NEW = SPAN_METRICS + ["device.idle_unexplained_pct"]


def _reader(name):
    path = spec.HERE / "metrics" / f"{name}.py"
    module_spec = importlib.util.spec_from_file_location(f"test_metric_{name}", path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module.read


def _buffer():
    """Two requests' spans (ms), as the program's SpanRecord tuples."""
    from pir_tpu_torch.utils.profiling import SpanRecord

    rows = []
    for r, t in ((0, 0), (1, 1000)):
        for i, (name, parent, start, end) in enumerate([
                ("pir.query.load", None, 0, 2), ("pir.keys.digest", None, 2, 10),
                ("pir.query.upload", None, 10, 11), ("pir.expand", None, 11, 15),
                ("pir.expand.level", 3, 12, 14), ("pir.scan.inner", None, 15, 17),
                ("pir.scan.upper", None, 17, 18), ("pir.ctmult.multiply", 6, 17, 17.5),
                ("pir.modswitch", None, 18, 18.5), ("pir.reply.enqueue", None, 18.5, 19),
                ("pir.stream.wait", None, 30, 33), ("pir.reply.serialize", None, 20, 21.5)]):
            base = 100 * r
            rows.append(SpanRecord(base + i, name, r, None if parent is None else base + parent,
                                   "caller", int((t + start) * 1e6), int((t + end) * 1e6)))
    return rows


@pytest.mark.parametrize("name, want", [
    ("server.key_digest_ms", 8.0), ("server.query_load_ms", 3.0),
    ("server.enqueue_ms", 4.0 + 2.0 + 1.0 + 0.5 + 0.5), ("server.serialize_ms", 1.5),
    ("server.caller_wait_ms", 3.0)])
def test_span_readers_on_a_fixed_buffer(monkeypatch, name, want):
    from pir_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "recorded_spans", _buffer)
    assert _reader(name)(None) == pytest.approx(want)
    monkeypatch.setattr(profiling, "recorded_spans", list)  # an empty buffer
    assert _reader(name)(None) is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_readers_without_the_span_api(monkeypatch, name):
    from pir_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "recorded_spans")
    assert _reader(name)(None) is None
    monkeypatch.setattr(profiling, "recorded_spans", _buffer, raising=False)
    monkeypatch.delattr(profiling, "span_summary")
    assert _reader(name)(None) is None
    bare = types.ModuleType("pir_tpu_torch.utils.profiling")  # the module as a parent has it
    monkeypatch.setitem(sys.modules, "pir_tpu_torch.utils.profiling", bare)
    monkeypatch.setattr(sys.modules["pir_tpu_torch.utils"], "profiling", bare)
    assert _reader(name)(None) is None
    monkeypatch.setitem(sys.modules, "pir_tpu_torch.utils.profiling", None)  # not importable
    monkeypatch.delattr(sys.modules["pir_tpu_torch.utils"], "profiling")
    assert _reader(name)(None) is None


def test_unexplained_idle_share_on_a_fixed_trace():
    rows = [("portbench.stream", False, 10.0, 20.0), ("portbench.draw", False, 10.0, 11.0),
            ("pir.keys.digest", False, 12.0, 14.0), ("scan_kernel", True, 14.0, 15.0),
            ("pir.stream.wait", False, 16.0, 17.0)]
    trace = run.Trace(rows, [])
    # idle 10-14, its middle in pir.keys.digest, and 15-20, its middle in no range
    assert sum(trace.idle.values()) == pytest.approx(9.0)
    read = _reader("device.idle_unexplained_pct")
    assert read(types.SimpleNamespace(trace=trace)) == pytest.approx(100.0 * 5.0 / 9.0)
    busy = run.Trace([("portbench.stream", False, 0.0, 1.0), ("k", True, 0.0, 1.0)], [])
    assert read(types.SimpleNamespace(trace=busy)) is None  # no idle time
    assert read(types.SimpleNamespace(trace=None)) is None


def test_a_traced_tiny_run_reports_every_new_metric():
    from pir_tpu_torch.utils import profiling

    cell = tiny_cell("single-d4", per_client=1)
    counted = []
    digest = cell.readers["server.key_digest_ms"]

    def counting(run_):
        counted.append((run_.requests, len({s.request for s in profiling.recorded_spans()})))
        return digest(run_)

    cell.readers["server.key_digest_ms"] = counting
    out = run.run_cell(cell, 2**31 + 991, 0.5, True, device="cpu")
    assert out["correct"], out
    for name in NEW:
        assert isinstance(out["metrics"][name]["value"], float), name
    (requests, ids), = counted
    assert requests == ids > 0
    assert {m["name"] for m in cell.per_layer} >= set(NEW)
