"""server.finalize_ms: the mean host time of PirServer.finalize_response
(the replies' copy to the host and their serialization) after the
request's device work has finished, over the same sequential pass."""


def read(run):
    spans = run.spans.get("finalize")
    return 1e3 * sum(spans) / len(spans) if spans else None
