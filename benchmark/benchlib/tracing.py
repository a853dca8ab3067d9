"""Spans on the host clock, and the reading of a torch.profiler trace.

Each span is also a torch.profiler range ("bench.<name>"), so that a traced
run's device events can be placed under the span that was open when they
ran. Spans and counters stay in memory and are read once the window has
closed.
"""
from __future__ import annotations

import contextlib
import gc
import time

import torch

TALLY = "bench.tally"  # the benchmark's own device work (samples, digit counts): left out of every reading


class Tracer:
    def __init__(self, ranges: bool):
        self.ranges = ranges  # a profiler range per span (traced runs)
        self.spans: list[tuple[str, int, float, float]] = []  # (name, task, start, end)
        self.task = -1
        self.tally_s = 0.0  # host seconds of TALLY work
        self.tallies: list[tuple[float, float]] = []
        self.gc_s: dict[int, float] = {}  # seconds of the collector's pauses, by task
        self._gc_t0 = None

    def _on_gc(self, phase, _info):
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            self.gc_s[self.task] = self.gc_s.get(self.task, 0.0) + time.perf_counter() - self._gc_t0
            self._gc_t0 = None

    def watch_gc(self, on: bool) -> None:
        """Count the garbage collector's pauses (gc.callbacks) by task."""
        if on and self._on_gc not in gc.callbacks:
            gc.callbacks.append(self._on_gc)
        elif not on and self._on_gc in gc.callbacks:
            gc.callbacks.remove(self._on_gc)

    @contextlib.contextmanager
    def span(self, name: str):
        rf = torch.profiler.record_function(f"bench.{name}") if self.ranges else contextlib.nullcontext()
        t0 = time.perf_counter()
        with rf:
            try:
                yield
            finally:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
        self.spans.append((name, self.task, t0, time.perf_counter()))

    @contextlib.contextmanager
    def range(self, name: str):
        """A span around a call without a synchronize (the NTT and MSM
        entries), in traced runs only."""
        if not self.ranges:
            yield
            return
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"bench.{name}"):
            yield
        self.spans.append((name, self.task, t0, time.perf_counter()))

    @contextlib.contextmanager
    def tally(self):
        """The benchmark's own work inside the window, timed so that the
        readings can leave it out. The device's queue is drained before
        the clock starts, so that the program's pending work stays in the
        window."""
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        rf = torch.profiler.record_function(TALLY) if self.ranges else contextlib.nullcontext()
        t0 = time.perf_counter()
        with rf:
            yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        t1 = time.perf_counter()
        self.tally_s += t1 - t0
        self.tallies.append((t0, t1))

    def seconds(self, name: str) -> float:
        """Seconds in the window's `name` spans (tasks 0 on), less the
        benchmark's own work inside them."""
        total = 0.0
        for n, task, t0, t1 in self.spans:
            if n == name and task >= 0:
                total += t1 - t0 - sum(max(0.0, min(t1, b) - max(t0, a)) for a, b in self.tallies)
        return total


def _union(intervals):
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _inside(ev, spans) -> bool:
    """Whether the device event (start, end) lies within one of the sorted
    (start, end) spans."""
    import bisect

    i = bisect.bisect_right(spans, (ev[0], float("inf"))) - 1
    return i >= 0 and spans[i][0] <= ev[0] and ev[1] <= spans[i][1]


def read_profile(prof, window_label: str = "bench.window") -> dict:
    """Device activity of a traced window, from the profiler's raw events.

    Device events are kernels, copies and sets; a device-side event whose
    name is also a host range's is the device span of that range (the
    profiler's user annotation). Returns the window (ns), the device
    events inside it that are not the benchmark's own (TALLY), and the
    device spans of every range by name."""
    evs = prof.profiler.kineto_results.events()
    host, dev = [], []
    for e in evs:
        rec = (e.name(), e.start_ns(), e.end_ns())
        (host if e.device_type() == torch.autograd.DeviceType.CPU else dev).append(rec)
    host_names = {n for n, _s, _e in host}
    win = [(s, e) for n, s, e in host if n == window_label]
    if not win:
        raise RuntimeError("the traced window's range is missing from the profile")
    w0, w1 = win[0]
    ranges: dict[str, list] = {}
    work = []
    for n, s, e in dev:
        if n in host_names:
            ranges.setdefault(n, []).append((s, e))
        elif w0 <= s and e <= w1:
            work.append((n, s, e))
    for v in ranges.values():
        v.sort()
    tally = ranges.get(TALLY, [])
    work = [w for w in work if not _inside((w[1], w[2]), tally)]
    # how the device spans of the MSM ranges sit against their host ranges:
    # from the launch latency (microseconds) to a misaligned clock (seconds)
    host_msm = sorted((s, e) for n, s, e in host if n == "bench.msm")
    dev_msm = ranges.get("bench.msm", [])
    lag = sorted((d[0] - h[0]) / 1e6 for h, d in zip(host_msm, dev_msm)) if len(host_msm) == len(dev_msm) else []
    return {"window_ns": (w0, w1), "work": work, "ranges": ranges,
            "msm_lag_ms": (lag[0], lag[len(lag) // 2], lag[-1]) if lag else None}


def busy_ns(work) -> int:
    return _union((s, e) for _n, s, e in work)


def device_ns_inside(work, spans) -> int:
    """Summed duration of the device events inside the given device spans."""
    return sum(e - s for _n, s, e in work if _inside((s, e), spans))


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def breakdown(trace: dict, tracer, anchor: float, top: int = 10) -> dict:
    """The device operations that took most time, and the device's idle time
    by the innermost benchmark span open on the host meanwhile. The spans
    are the tracer's own (host clock), placed on the profiler's clock by
    `anchor`, the host clock's reading as the window's range opened."""
    import bisect

    by_op: dict[str, float] = {}
    for n, s, e in trace["work"]:
        by_op[n] = by_op.get(n, 0.0) + (e - s) / 1e9
    w0, w1 = trace["window_ns"]
    shift = w0 - anchor * 1e9
    by_name: dict[str, list] = {}
    for name, task, t0, t1 in tracer.spans:
        if task >= 0:
            by_name.setdefault(f"bench.{name}", []).append((t0 * 1e9 + shift, t1 * 1e9 + shift))
    by_name[TALLY] = [(t0 * 1e9 + shift, t1 * 1e9 + shift) for t0, t1 in tracer.tallies]
    for v in by_name.values():
        v.sort()
    starts = {n: [s for s, _e in v] for n, v in by_name.items()}

    def label(t: float) -> str:
        best = (-1.0, "none")
        for n, v in by_name.items():
            i = bisect.bisect_right(starts[n], t) - 1
            if i >= 0 and v[i][1] >= t and v[i][0] > best[0]:
                best = (v[i][0], n)
        return best[1]

    # a gap can outlast a span: cut it at every span's start and end
    marks = sorted({t for v in by_name.values() for span in v for t in span})
    idle: dict[str, float] = {}
    last = w0
    for s, e in sorted((s, e) for _n, s, e in trace["work"]) + [(w1, w1)]:
        if s > last:
            cuts = [last] + marks[bisect.bisect_right(marks, last):bisect.bisect_left(marks, s)] + [s]
            for a, b in zip(cuts, cuts[1:]):
                where = label((a + b) / 2)
                idle[where] = idle.get(where, 0.0) + (b - a) / 1e9
        last = max(last, e)
    idle.pop(TALLY, None)  # the benchmark's own pauses
    return {"device_ops": [list(kv) for kv in sorted(by_op.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [list(kv) for kv in sorted(idle.items(), key=lambda kv: -kv[1])[:top]]}
