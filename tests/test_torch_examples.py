"""The port's examples run end to end on the CPU at a tiny database
(`--device cpu`), each in a subprocess as a user would run it, check their
own Responses and print their numbers."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]


def _run(module, *args):
    # one torch thread: the test workers run side by side on the host's cores
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", module, "--device", "cpu", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def test_basic_pir_example():
    out = _run("pir_tpu_torch.examples.basic_pir", "--db-size", "64", "--index", "37")
    assert "retrieved item 37 correctly" in out
    assert "database on cpu" in out


@pytest.mark.parametrize("shape", ["sequential", "streamed depth 6", "batch-2 streamed"])
def test_streamed_serving_example_prints_its_rates(streamed_output, shape):
    assert re.search(rf"^{shape}\s*:\s*[0-9.]+ queries/s$", streamed_output, re.M), streamed_output


@pytest.fixture(scope="module")
def streamed_output():
    out = _run("pir_tpu_torch.examples.streamed_serving", "--db-size", "64",
               "--requests", "3", "--batch", "2")
    assert "every Response checked" in out
    return out
