"""device.ms_per_query: the device's busy time in the traced stream (merged
intervals of every device operation) divided by the queries it served."""


def read(run):
    trace = run.trace
    if trace is None or not run.queries:
        return None
    return 1e3 * trace.busy_s / run.queries
