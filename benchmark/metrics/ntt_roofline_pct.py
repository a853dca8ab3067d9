"""ntt_roofline_pct: the least time the window's transforms need (the
algorithm's work from each call's shape, benchlib/roofline.py, against the
H100's published peaks) as a share of the device time of the work
launched inside the port's NTT entry (`TiledDomain._transform`: K2 and
whatever else runs there), from the profiler's device spans of the
"bench.ntt" ranges. The profiler gives nested ranges one device span, the
innermost's: the port's own range inside ("TiledDomain.transform")
stands for it while the port keeps one."""
from benchlib import roofline, tracing


def read(r):
    if r.trace is None or not r.work["ntt"]:
        return None
    spans = sorted(r.trace["ranges"].get("bench.ntt", []) + r.trace["ranges"].get("TiledDomain.transform", []))
    dev_ns = tracing.device_ns_inside(r.trace["work"], spans)
    if not dev_ns:
        return None
    return 100.0 * sum(roofline.least_seconds(*w) for w in r.work["ntt"]) / (dev_ns / 1e9)
