"""The harness is driven by data, and its arithmetic is right on fixed
inputs: a cell, configuration, traffic mix, per-layer metric or kernel name
is added by adding files only; percentiles, rates, merged device intervals,
idle gaps and the scan's byte count from a configuration."""

import hashlib
import json
import pathlib
import shutil

import pytest

from portbench import measure, run, spec
from portbench.reference import params as rp

ROOT = pathlib.Path(__file__).resolve().parents[2]


def _digests(root: pathlib.Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_adding_files_adds_a_cell_and_a_metric(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path)
    bench = tmp_path / "portbench"

    cfg = json.loads((bench / "configs" / "sealpir-1m-n4096-t20.json").read_text())
    (bench / "configs" / "sealpir-4m-n4096.json").write_text(json.dumps(dict(cfg, items=1 << 22)))
    mix = json.loads((bench / "traffic" / "single-d4.json").read_text())
    (bench / "traffic" / "single-d2.json").write_text(json.dumps(dict(mix, depth=2)))
    (bench / "metrics" / "server.parse_ms.py").write_text(
        "def read(run):\n    return 1.5\n")
    (bench / "kernels" / "new_scan_kernel.json").write_text(
        json.dumps({"kernel": "new_scan_kernel", "layer": "scan", "source": "csrc/new.cu"}))
    spec_json = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec_json["configs"].append(dict(spec_json["configs"][0], name="sealpir-4m-n4096",
                                     file="portbench/configs/sealpir-4m-n4096.json"))
    spec_json["workloads"].append({"name": "sealpir-4m-n4096.single-d2", "config": "sealpir-4m-n4096",
                                   "traffic": "single-d2", "chips": 1, "why": "a new cell"})
    spec_json["per_layer"].append({"name": "server.parse_ms", "unit": "ms", "better": "lower",
                                   "source": "host_clock", "layer": "server and wire (host)",
                                   "moves": "qps", "workloads": ["sealpir-4m-n4096.single-d2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec_json))

    after = _digests(tmp_path)
    changed = {k for k in before if before[k] != after.get(k)}
    assert changed == {"BENCHMARK.json"}  # every other file is as it was

    cell = spec.load("sealpir-4m-n4096.single-d2", root=tmp_path)
    assert cell.config["items"] == 1 << 22 and cell.traffic["depth"] == 2
    assert cell.readers["server.parse_ms"](None) == 1.5
    assert {m["name"] for m in cell.end_to_end} >= {"qps", "latency_p50_ms", "setup_s"}
    layers = measure.kernel_layers(cell.kernels)
    assert measure.layer_of("void (anonymous namespace)::new_scan_kernel<2>(int)", layers) == "scan"
    old = spec.load("sealpir-1m-n4096-t20.single-d4", root=tmp_path)
    assert "server.parse_ms" not in old.readers  # listed for the new cell only


def test_every_cell_of_the_benchmark_loads():
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in data["workloads"]:
        cell = spec.load(w["name"])
        assert {m["name"] for m in cell.per_layer} == set(cell.readers)
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
        assert len(cell.end_to_end) >= 2 and cell.per_layer


@pytest.mark.parametrize("values, q, want", [
    ([5.0], 50, 5.0), ([1, 2, 3, 4], 50, 2.5), (list(range(1, 101)), 95, 95.05),
    ([10, 0, 30, 20], 100, 30.0),
])
def test_percentile_interpolates_over_all_samples(values, q, want):
    assert measure.percentile(values, q) == pytest.approx(want, abs=1e-12)


def test_rate_is_over_the_whole_window():
    assert measure.rate(500, 10.0) == 50.0
    with pytest.raises(ValueError):
        measure.rate(1, 0.0)


def test_merged_intervals_busy_and_gaps():
    spans = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (6.0, 7.0)]
    assert measure.merge(spans) == [(0.0, 2.0), (3.0, 4.0), (6.0, 7.0)]
    assert measure.busy(spans) == 4.0
    assert measure.gaps(spans, -1.0, 6.5) == [(-1.0, 0.0), (2.0, 3.0), (4.0, 6.0)]
    assert measure.busy(measure.clip(spans, 0.5, 3.5)) == 2.0


def test_idle_gaps_are_labelled_by_the_open_span():
    host = [("portbench.draw", 0.0, 1.0), ("aten::copy_", 0.2, 0.4), ("cudaLaunchKernel", 2.0, 3.0),
            ("cudaStreamSynchronize", 2.2, 2.9)]
    idle = [(0.1, 0.5), (2.0, 3.0), (5.0, 6.0)]
    assert measure.label_gaps(idle, host, "portbench.") == {
        "portbench.draw": pytest.approx(0.4), "host: cudaStreamSynchronize": 1.0,
        "host: Python, no op recorded": 1.0}


def test_trace_reduction():
    rows = [("portbench.stream", False, 10.0, 20.0), ("portbench.draw", False, 10.0, 11.0),
            ("void (anonymous namespace)::scan_kernel<2>(x)", True, 11.0, 12.0),
            ("void (anonymous namespace)::scan_wide_kernel<1>(x)", True, 11.5, 13.0),
            ("contract::contract_kernel<3>", True, 15.0, 16.0), ("Memcpy HtoD", True, 19.5, 21.5)]
    cell = spec.load("sealpir-1m-n4096-t20.single-d4")
    trace = run.Trace(rows, measure.kernel_layers(cell.kernels))
    assert trace.window_s == 10.0 and trace.busy_s == 2.0 + 1.0 + 0.5
    assert trace.layer_seconds("scan") == 1.0 + 1.5
    assert trace.layer_seconds("contraction") == 1.0
    b = trace.breakdown()
    assert b["device_ops"][0] == ["Memcpy HtoD", 2.0]
    assert b["idle_gaps"][0] == ["host: Python, no op recorded", pytest.approx(2.0 + 3.5)]
    assert dict(b["idle_gaps"])["portbench.draw"] == pytest.approx(1.0)


def test_trace_rows_reads_a_profiler_run():
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("portbench.stream"):
            with record_function("portbench.draw"):
                torch.ones(64).add_(1)
    rows = run.trace_rows(prof)
    spans = {name: (s, e) for name, dev, s, e in rows if not dev}
    (lo, hi), (s, e) = spans["portbench.stream"], spans["portbench.draw"]
    assert lo <= s <= e <= hi and hi - lo < 60.0
    trace = run.Trace(rows, {})
    assert trace.window_s == pytest.approx(hi - lo) and trace.busy_s == 0.0
    assert trace.device_events == 0


def test_scan_bytes_from_the_configuration():
    cfg = json.loads((ROOT / "portbench/configs/sealpir-1m-n4096-t20.json").read_text())
    p = rp.from_config(cfg)
    assert p.dimensions == (179, 178) and p.num_pt == 31776 and p.expansion_ratio() == 4
    word = 4096 * (36 + 36) / 8
    inner = 31776 * word + (178 * 2 + 179 * 2) * word
    upper = (179 * 8 + 179 * 2 + 8 * 2) * word
    assert measure.scan_bytes(cfg, p, 1) == inner + upper
    assert measure.scan_bytes(cfg, p, 16) == 31776 * word + 16 * (inner - 31776 * word + upper)
    ct = json.loads((ROOT / "portbench/configs/ctmult-1m-n8192.json").read_text())
    pc = rp.from_config(ct)
    assert pc.dimensions == (114, 114) and pc.num_pt == 12946
    word = 8192 * (43 + 43 + 44 + 44) / 8
    assert measure.scan_bytes(ct, pc, 1) == 12946 * word + (114 * 2 + 114 * 2) * word


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import sys
    import types

    before = run.forbidden_modules()
    for name in ("pir_tpu_torch", "pir_tpu_torch.pir", "jaxlike.sub", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys.modules.get(name) or types.ModuleType(name))
    assert run.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert "jax" in run.forbidden_modules()
