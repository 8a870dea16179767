"""server.query_load_ms: the caller thread's host time a request in
parsing its queries and moving them to the card: the self time of the
program's pir.query.load and pir.query.upload spans in the traced stream
over the requests they served.  None where the program records no spans."""

STAGES = ("pir.query.load", "pir.query.upload")


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
