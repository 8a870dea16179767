"""server.caller_wait_ms: the caller thread's time a request blocked on the
oldest in-flight Response while the stream is at its depth: the self time
of the program's pir.stream.wait spans in the traced stream over the
requests they served.  Near 0 where the caller's submission paces the
stream, large where the card does.  None where the program records no
spans."""

STAGES = ("pir.stream.wait",)


def read(run):
    try:
        from pir_tpu_torch.utils import profiling

        spans = profiling.recorded_spans()
        summary = profiling.span_summary(spans)
    except (ImportError, AttributeError):  # a program without spans
        return None
    requests = {s.request for s in spans if s.request is not None}
    if not requests:
        return None
    return sum(v["self_ms"] for name, v in summary.items() if name.startswith(STAGES)) / len(requests)
