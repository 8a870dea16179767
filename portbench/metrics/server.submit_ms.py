"""server.submit_ms: the mean host time of PirServer.process_request_async
(key digest and cache, query parse and upload, every launch) over a
sequential pass of the cell's requests; the benchmark's own span."""


def read(run):
    spans = run.spans.get("submit")
    return 1e3 * sum(spans) / len(spans) if spans else None
