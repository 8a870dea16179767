"""kernels.scan_roofline_pct: the least time the database scans of the
traced stream's requests could take, their bytes (counted from the
configuration by portbench.measure.scan_bytes) at 3.35 TB/s, as a share of
the device time of the kernels whose layer is "scan" (kernels/*.json)."""

from portbench.measure import HBM_BYTES_PER_S


def read(run):
    trace = run.trace
    if trace is None:
        return None
    seconds = trace.layer_seconds("scan")
    if seconds <= 0:
        return None
    return 100.0 * run.scan_bytes / HBM_BYTES_PER_S / seconds
