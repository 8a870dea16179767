"""What one cell is made of, found by name: its entry in BENCHMARK.json, its
configuration (``configs/<name>.json``), its traffic mix
(``traffic/<name>.json``), the metrics it reports (``metrics/<name>.py``
for each per-layer metric) and the map of device kernel names to layers
(every ``kernels/*.json``).  Adding a cell, a configuration, a mix, a
metric or a kernel name adds files and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list
    readers: dict  # per-layer metric name -> read(run) -> float | None
    kernels: dict  # kernel-name file stem -> {"kernel": ..., "layer": ...}


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _reader(path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def load(cell: str, root: pathlib.Path = ROOT, bench: "pathlib.Path | None" = None) -> Cell:
    """The cell named `cell` of `root`'s BENCHMARK.json (a benchmark folder
    `bench` beside it, portbench/ by default)."""
    bench = bench or root / HERE.name
    spec = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in spec["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    cfg_entry = next(c for c in spec["configs"] if c["name"] == entry["config"])
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((bench / "traffic" / f"{entry['traffic']}.json").read_text())
    if traffic["clients"] > config["clients"]:
        raise ValueError(f"{cell}: the mix has more clients than the deployment states")
    per_layer = [m for m in spec["per_layer"] if _applies(m, cell)]
    return Cell(
        name=cell,
        chips=int(entry["chips"]),
        config=config,
        traffic=traffic,
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, cell)],
        per_layer=per_layer,
        readers={m["name"]: _reader(bench / "metrics" / f"{m['name']}.py") for m in per_layer},
        kernels={p.stem: json.loads(p.read_text())
                 for p in sorted((bench / "kernels").glob("*.json"))},
    )
