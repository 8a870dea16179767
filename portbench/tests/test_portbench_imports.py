"""What the benchmark may load: no module it runs has the top-level name
jax, jaxlib, flax or pir_tpu, and the frozen reference loads nothing of
pir_tpu_torch either.  Top-level names (before the first dot) are compared
whole: pir_tpu_torch is not pir_tpu."""

import ast
import json
import pathlib
import subprocess
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "pir_tpu"}


def _imported_top_names(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_source_of_the_harness_imports_jax_or_pir_tpu(path):
    names = _imported_top_names(path)
    assert not names & FORBIDDEN
    if "reference" in path.parts:
        assert "pir_tpu_torch" not in names


def _loaded_after(code: str) -> set:
    probe = code + "\nimport sys, json\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    proc = subprocess.run([sys.executable, "-c", probe], cwd=BENCH.parent, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded_after("import numpy as np\n"
                           "from portbench.reference import bfv, client, params, wire, arith\n")
    assert not loaded & (FORBIDDEN | {"pir_tpu_torch"})


def test_a_whole_run_loads_no_jax_and_no_pir_tpu():
    code = ("import sys\nsys.path.insert(0, 'portbench/tests')\n"
            "from portbench import run\nfrom tiny import tiny_cell\n"
            "out = run.run_cell(tiny_cell('single-d4', per_client=1), 7, 0.3, True, device='cpu')\n"
            "assert out['correct'], out\n"
            "assert run.forbidden_modules() == []\n")
    loaded = _loaded_after(code)
    assert "pir_tpu_torch" in loaded and not loaded & FORBIDDEN
