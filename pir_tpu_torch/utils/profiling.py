"""Tracing and timing hooks (port of ``pir_tpu/utils/profiling.py``) and the
program's spans.

    from pir_tpu_torch.utils import profiling
    with profiling.trace("pir-trace"):     # pir-trace/trace.json, spans.json
        server.process_request(request)
    profiling.span_summary()               # {span name: count, total and self ms}
    with profiling.timed("one request"):   # prints "[one request] 0.0512s"
        server.process_request(request)

The served path marks its stages with :func:`span`.  A span records only
while a torch.profiler session records (:func:`trace`, or any
``torch.profiler.profile``); otherwise it checks the profiler's flag,
notes that no session records (the next session's first span then clears
the buffer) and hands back a shared null context.  A recorded span opens a ``record_function`` range of its
name, so the profiler's trace shows the stage beside the device's kernels,
and appends a :class:`SpanRecord` to an in-memory buffer: its name, its
request (:func:`request_scope`), the span open around it in the same
thread, its thread, and its start and end on the host's clock.  The buffer
holds the spans of the current or last session (:func:`recorded_spans`),
at most ``MAX_SPANS``, the oldest dropped first (:func:`dropped_spans`).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import pathlib
import threading
import time
from typing import NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

MAX_SPANS = 1 << 20


class SpanRecord(NamedTuple):
    id: int
    name: str
    request: Optional[int]  # the request it served, None outside one
    parent: Optional[int]  # the id of the span open around it in its thread
    thread: str
    start_ns: int  # time.perf_counter_ns()
    end_ns: int


class _Recorder:
    """The span buffer, shared by every thread of the process: at most
    `capacity` spans, the oldest dropped first."""

    def __init__(self, capacity: int = MAX_SPANS):
        self.lock = threading.Lock()
        self.spans: collections.deque = collections.deque(maxlen=capacity)
        self.dropped = 0
        self.ids = itertools.count()
        # a span was opened with no profiler recording: the next recorded
        # span starts a new session
        self.idle = False

    def reset(self) -> None:
        with self.lock:
            self.spans.clear()
            self.dropped = 0
            self.idle = False

    def begin(self) -> None:
        if self.idle:
            with self.lock:
                if self.idle:
                    self.spans.clear()
                    self.dropped = 0
                    self.idle = False

    def add(self, record: SpanRecord) -> None:
        with self.lock:
            if len(self.spans) == self.spans.maxlen:
                self.dropped += 1
            self.spans.append(record)


_recorder = _Recorder()
_local = threading.local()  # per thread: the open spans' ids, the request


def _open_spans() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Span:
    __slots__ = ("name", "request", "id", "parent", "range", "start")

    def __init__(self, name: str, request: Optional[int]):
        self.name = name
        self.request = request

    def __enter__(self):
        _recorder.begin()
        stack = _open_spans()
        self.parent = stack[-1] if stack else None
        self.id = next(_recorder.ids)
        if self.request is None:
            self.request = getattr(_local, "request", None)
        stack.append(self.id)
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.range.__exit__(*exc)
        _open_spans().pop()
        _recorder.add(SpanRecord(self.id, self.name, self.request, self.parent,
                                 threading.current_thread().name, self.start, end))
        return False


_OFF = contextlib.nullcontext()  # a span opened while no profiler records


def span(name: str, request: Optional[int] = None):
    """A context manager around one stage of the served path, recorded
    while a torch.profiler session records.  request: the request it
    serves, where it is not the thread's current one (:func:`request_scope`)."""
    if _autograd_profiler._is_profiler_enabled:
        return _Span(name, request)
    _recorder.idle = True
    return _OFF


def request_scope(request: int):
    """Within the block, this thread's spans serve `request` (noted only
    while a profiler records, as spans are)."""
    if _autograd_profiler._is_profiler_enabled:
        return _serving(request)
    return _OFF


@contextlib.contextmanager
def _serving(request: int):
    outer = getattr(_local, "request", None)
    _local.request = request
    try:
        yield
    finally:
        _local.request = outer


def recorded_spans() -> list:
    """The spans of the current or last profiler session, oldest first."""
    with _recorder.lock:
        return list(_recorder.spans)


def dropped_spans() -> int:
    """How many of the session's spans the full buffer dropped."""
    return _recorder.dropped


def _covered_ns(intervals, lo: int, hi: int) -> int:
    """The part of [lo, hi] that the (start, end) intervals cover."""
    covered, cursor = 0, lo
    for start, end in sorted(intervals):
        start, end = max(start, cursor), min(end, hi)
        if end > start:
            covered += end - start
            cursor = end
    return covered


def span_summary(spans=None) -> dict:
    """{name: {"count", "total_ms", "self_ms"}} of the spans (the recorded
    ones by default).  A span's self time is its duration less the part of
    it that its child spans cover."""
    spans = recorded_spans() if spans is None else spans
    children = collections.defaultdict(list)
    for s in spans:
        if s.parent is not None:
            children[s.parent].append((s.start_ns, s.end_ns))
    out: dict = {}
    for s in spans:
        total = s.end_ns - s.start_ns
        own = total - _covered_ns(children.get(s.id, ()), s.start_ns, s.end_ns)
        entry = out.setdefault(s.name, {"count": 0, "total_ms": 0.0, "self_ms": 0.0})
        entry["count"] += 1
        entry["total_ms"] += total / 1e6
        entry["self_ms"] += own / 1e6
    return out


@contextlib.contextmanager
def trace(log_dir):
    """Profile the block with ``torch.profiler`` (host activity of every
    thread, and the card's where there is one) and write a Chrome trace,
    ``trace.json``, and the block's spans, ``spans.json``, into log_dir.
    Yields the profiler (``key_averages()`` and so on)."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    _recorder.reset()
    with profile(activities=activities,
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
    spans = recorded_spans()
    (out / "spans.json").write_text(json.dumps({
        "dropped": dropped_spans(),
        "summary": span_summary(spans),
        "spans": [s._asdict() for s in spans],
    }))


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
