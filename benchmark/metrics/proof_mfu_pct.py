"""proof_mfu_pct: the whole task's share of the card's peak: the least time
of all the window's NTT and MSM work (benchlib/roofline.py) over the
traced window, less the benchmark's own work. It bounds what the kernels'
rooflines can claim once a kernel leaves the path."""
from benchlib import roofline


def read(r):
    if r.trace is None or not (r.work["ntt"] or r.work["msm"]):
        return None
    w0, w1 = r.trace["window_ns"]
    window = (w1 - w0) / 1e9 - r.tracer.tally_s
    return 100.0 * sum(roofline.least_seconds(*w) for w in r.work["ntt"] + r.work["msm"]) / window
