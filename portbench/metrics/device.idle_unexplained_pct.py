"""device.idle_unexplained_pct: of the traced stream's idle device time,
the share in which the host ran Python with no recorded op or range open
(portbench.measure.label_gaps's last label): what the program's spans and
the profiler's ops leave unexplained.  None without idle time."""

UNEXPLAINED = "host: Python, no op recorded"


def read(run):
    trace = run.trace
    if trace is None:
        return None
    idle = sum(trace.idle.values())
    if idle <= 0:
        return None
    return 100.0 * trace.idle.get(UNEXPLAINED, 0.0) / idle
