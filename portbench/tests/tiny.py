"""The benchmark's CPU tests' configuration: a tiny ring (tiny.json: N=64,
200 items of 8 B, d=2) and cells of BENCHMARK.json's metrics built on it."""

import dataclasses
import json
import pathlib

from portbench import spec

TINY = json.loads((pathlib.Path(__file__).parent / "tiny.json").read_text())


def tiny_cell(traffic: str = "single-d4", mode: str = "decomposition", per_client: int = 2):
    """A cell of BENCHMARK.json's metrics on the tiny configuration."""
    base = spec.load(f"sealpir-1m-n4096-t20.{traffic}")
    return dataclasses.replace(
        base, config=dict(TINY, mode=mode),
        traffic=dict(base.traffic, requests_per_client=per_client))
