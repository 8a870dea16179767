"""device.idle_pct: the share of the traced stream's wall time in which no
device operation (kernel, copy or fill) ran, from the profiler's trace."""


def read(run):
    trace = run.trace
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
