"""launches_per_proof: device kernels (the port's and plain torch's; not
copies or sets) that the traced window ran, per completed task."""
from benchlib import tracing


def read(r):
    if r.trace is None or not r.tasks:
        return None
    return sum(tracing.is_kernel(n) for n, _s, _e in r.trace["work"]) / r.tasks
