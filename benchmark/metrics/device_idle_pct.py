"""device_idle_pct: 100 less the share of the traced window in which some
operation (kernel, copy, set) ran on the device: the union of the device
events' intervals, from the profiler's trace, over the window less the
benchmark's own work."""
from benchlib import tracing


def read(r):
    if r.trace is None:
        return None
    w0, w1 = r.trace["window_ns"]
    window = (w1 - w0) / 1e9 - r.tracer.tally_s
    return 100.0 * (1.0 - tracing.busy_ns(r.trace["work"]) / 1e9 / window)
