"""Tracing and timing hooks (port of ``pir_tpu/utils/profiling.py``).

    from pir_tpu_torch.utils.profiling import timed, trace
    with trace("pir-trace"):            # Chrome trace in pir-trace/trace.json
        server.process_request(request)
    with timed("one request"):          # prints "[one request] 0.0512s"
        server.process_request(request)
"""

from __future__ import annotations

import contextlib
import pathlib
import time

import torch


@contextlib.contextmanager
def trace(log_dir):
    """Profile the block with ``torch.profiler`` (host activity, and the
    card's where there is one) and write a Chrome trace, ``trace.json``,
    into log_dir.  Yields the profiler (``key_averages()`` and so on)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def timed(label: str, sink=print):
    """Wall-clock timer of the block: the current card, where there is one,
    is synchronized before each clock reading, so queued device work counts
    where it was enqueued."""
    _sync()
    t0 = time.perf_counter()
    yield
    _sync()
    sink(f"[{label}] {time.perf_counter() - t0:.4f}s")
