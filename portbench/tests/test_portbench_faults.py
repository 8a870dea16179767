"""Whole runs of the harness on the CPU at the tiny configuration, with its
look for a card skipped: a sound run is correct; the control (replies cut
to the plaintext's bits) and each fault a cell can have, planted in the
timed path, come out not correct.  Without a card the command exits with
2 and prints no result."""

import os
import subprocess
import sys

import pytest
import torch

import pir_tpu_torch as pt
from portbench import run
from tiny import tiny_cell

SEED = 2**31 + 12345  # larger than 32 signed bits hold


def _run(cell, **kw):
    return run.run_cell(cell, SEED, 0.5, False, device="cpu", **kw)


@pytest.mark.parametrize("traffic", ["single-d4", "batch16-d4"])
@pytest.mark.parametrize("mode", ["decomposition", "ciphertext_multiplication"])
def test_a_sound_run_is_correct_and_the_control_is_not(traffic, mode):
    cell = tiny_cell(traffic, mode, per_client=1)
    sound = _run(cell)
    assert sound["correct"] and sound["failed"] == 0 and sound["attempted"] >= 1
    assert sound["checks"] == {"wrong_replies": {"value": 0, "limit": 0},
                               "missing_replies": {"value": 0, "limit": 0}}
    assert list(sound)[-1] == "checks"
    control = _run(cell, control=True)
    assert not control["correct"] and control["checks"]["wrong_replies"]["value"] > 0


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    produce = pt.PirServer.process_query

    def altered(self, *args, **kw):
        reply = produce(self, *args, **kw)
        return torch.roll(reply, 1, dims=-1)  # every coefficient moved one place

    monkeypatch.setattr(pt.PirServer, "process_query", altered)
    out = _run(tiny_cell("single-d4"))
    assert not out["correct"] and out["checks"]["wrong_replies"]["value"] > 0


def test_half_of_the_batch_left_out(monkeypatch):
    finalize = pt.PirServer.finalize_response

    def halved(self, pending):
        response = finalize(self, pending)
        del response.reply[len(response.reply) // 2:]
        return response

    monkeypatch.setattr(pt.PirServer, "finalize_response", halved)
    out = _run(tiny_cell("batch16-d4", per_client=1))
    assert not out["correct"] and out["checks"]["missing_replies"]["value"] > 0


def test_a_failing_stream_is_not_correct(monkeypatch):
    calls = {"n": 0}
    submit = pt.PirServer.process_request_async

    def failing(self, request, upload=None):
        calls["n"] += 1
        if calls["n"] > 12:  # after set-up's warm-up
            raise RuntimeError("planted")
        return submit(self, request, upload)

    monkeypatch.setattr(pt.PirServer, "process_request_async", failing)
    out = _run(tiny_cell("single-d4"))
    assert not out["correct"]


def test_without_a_card_it_exits_2_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "sealpir-1m-n4096-t20.single-d4",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=run.ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2 and proc.stdout == ""
    assert "CUDA" in proc.stderr
