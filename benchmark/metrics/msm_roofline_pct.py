"""msm_roofline_pct: the least time the window's commitments need (each
column's points and scalars read once, the point additions of a bucket MSM
for its live digits at the best window, benchlib/roofline.py) as a share
of the device time of the work launched inside the port's MSM entry
(`msm_v2_host_batch`: digit preparation, K3, K4), from the profiler's
device spans of the "bench.msm" ranges."""
from benchlib import roofline, tracing


def read(r):
    if r.trace is None or not r.work["msm"]:
        return None
    dev_ns = tracing.device_ns_inside(r.trace["work"], r.trace["ranges"].get("bench.msm", []))
    if not dev_ns:
        return None
    return 100.0 * sum(roofline.least_seconds(*w) for w in r.work["msm"]) / (dev_ns / 1e9)
