"""Spans and counters inside the port, off unless `enable(True)`.

A span is one stretch of host work: a name, an id, its parent's id, the id
of the top-level span it belongs to (`root`), a start and an end from
`time.perf_counter_ns()` and a few integer counts, given when the span
opens (`span(name, **attrs)`) or before it closes (`sp.set(**attrs)`);
`summary()` sums them by name. `@spanned(name)` makes each call of a
function one span.

While tracing is on, each span also opens a torch.profiler range
"spt.<name>", so a profiled run holds it on the profiler's clock, the clock
of the device events; the perf-counter stamps place it on the host clock.
The collector's pauses become "gc" spans (one `gc.callbacks` entry,
installed only while tracing is on). Spans never synchronize the device:
a span's interval is what the host was doing, which is what an idle stretch
of the device is attributed to.

Spans stay in memory until `drain()`. The open-span stack lives in a
`contextvars.ContextVar`, so a span opened in another thread starts its own
tree. While tracing is off, `span()` returns one shared no-op object after
a single check of a module flag: nothing is recorded and no profiler range
opens.

    from scroll_prover_tpu_torch import trace

    trace.enable(True)
    with trace.span("work", columns=4) as sp:
        ...
        sp.set(rows=n)
    trace.enable(False)
    spans = trace.drain()          # or trace.summary(trace.drain())
"""
from __future__ import annotations

import contextvars
import functools
import gc
import itertools
import time

import torch

_on = False
_spans: list["Span"] = []
_stack: contextvars.ContextVar[tuple] = contextvars.ContextVar("spt_trace_stack", default=())
_ids = itertools.count(1)
_gc_open: list = []  # the running collection's (span, profiler range), at most one


class Span:
    """One recorded span. `parent` is 0 for a top-level span, whose `root`
    is its own id."""

    __slots__ = ("name", "id", "parent", "root", "start_ns", "end_ns", "attrs", "_range", "_token")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.id = next(_ids)
        self.attrs = attrs
        self.start_ns = self.end_ns = 0

    def _parent_of(self, stack: tuple) -> None:
        self.parent = stack[-1].id if stack else 0
        self.root = stack[0].id if stack else self.id

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        stack = _stack.get()
        self._parent_of(stack)
        self._token = _stack.set(stack + (self,))
        self._range = torch.profiler.record_function("spt." + self.name)
        self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.perf_counter_ns()
        self._range.__exit__(*exc)
        _stack.reset(self._token)
        self._range = self._token = None
        _spans.append(self)

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, root={self.root}, "
                f"{(self.end_ns - self.start_ns) / 1e6:.3f} ms, {self.attrs})")


class _Off:
    """What `span()` returns while tracing is off."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        pass


OFF = _Off()


def span(name: str, **attrs):
    """A context manager timing `name`; `OFF` while tracing is off."""
    if not _on:
        return OFF
    return Span(name, attrs)


def spanned(name: str):
    """Decorator: each call of the function is the span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def _on_gc(phase: str, _info: dict) -> None:
    if phase == "start":
        sp = Span("gc", {})
        sp._parent_of(_stack.get())
        rf = torch.profiler.record_function("spt.gc")
        rf.__enter__()
        sp.start_ns = time.perf_counter_ns()
        _gc_open.append((sp, rf))
    elif _gc_open:
        sp, rf = _gc_open.pop()
        sp.end_ns = time.perf_counter_ns()
        rf.__exit__(None, None, None)
        _spans.append(sp)


def enable(on: bool = True) -> None:
    """Turn tracing on or off (off at import)."""
    global _on
    _on = bool(on)
    if _on and _on_gc not in gc.callbacks:
        gc.callbacks.append(_on_gc)
    elif not _on and _on_gc in gc.callbacks:
        gc.callbacks.remove(_on_gc)


def drain() -> list[Span]:
    """The spans closed since the last drain, by start."""
    global _spans
    out, _spans = _spans, []
    return sorted(out, key=lambda s: s.start_ns)


def summary(spans: list[Span]) -> dict[str, dict]:
    """{name: {"calls", "total_s", "self_s", "attrs"}} of drained spans.
    total_s counts only the outermost span of a name (a span inside another
    of its name is not counted twice); self_s is each span less its children
    (the collector's pauses among them); attrs sums each attribute over the
    name's spans."""
    by_id = {s.id: s for s in spans}
    child_ns: dict[int, int] = {}
    for s in spans:
        if s.parent in by_id:
            child_ns[s.parent] = child_ns.get(s.parent, 0) + s.end_ns - s.start_ns
    out: dict[str, dict] = {}
    for s in spans:
        row = out.setdefault(s.name, {"calls": 0, "total_s": 0.0, "self_s": 0.0, "attrs": {}})
        ns = s.end_ns - s.start_ns
        row["calls"] += 1
        row["self_s"] += (ns - child_ns.get(s.id, 0)) / 1e9
        for key, v in s.attrs.items():
            row["attrs"][key] = row["attrs"].get(key, 0) + v
        up = by_id.get(s.parent)
        while up is not None and up.name != s.name:
            up = by_id.get(up.parent)
        if up is None:
            row["total_s"] += ns / 1e9
    return out
