"""Spans and the device trace of a traced run (`--trace 1`).

Spans are `torch.profiler.record_function` ranges named `wabench.<name>`,
opened by the benchmark around the calls it makes and, in a traced run
only, around module attributes it wraps (`wrapped`).  The device trace is
the profiler's: every kernel, copy and fill the card ran, in the same
time base as the spans.  Untraced runs open no span and wrap nothing.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
from dataclasses import dataclass, field

PREFIX = "wabench."


class Spans:
    """Opens spans in a traced run; nothing otherwise."""

    def __init__(self, on: bool):
        self.on = on

    def __call__(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(PREFIX + name)


@contextlib.contextmanager
def wrapped(targets, spans: Spans):
    """Wrap each "module.path:Attr.attr" of `targets` in a span named by
    its last two parts for the duration; restore them after."""
    saved = []
    try:
        for target in targets:
            mod_name, attr_path = target.split(":")
            owner = importlib.import_module(mod_name)
            *parents, attr = attr_path.split(".")
            for p in parents:
                owner = getattr(owner, p)
            orig = owner.__dict__[attr] if isinstance(owner, type) \
                else getattr(owner, attr)
            name = ".".join(attr_path.split(".")[-2:])

            def make(fn, name=name):
                @functools.wraps(fn)
                def wrapper(*args, **kw):
                    with spans(name):
                        return fn(*args, **kw)
                return wrapper

            setattr(owner, attr, make(orig))
            saved.append((owner, attr, orig))
        yield
    finally:
        for owner, attr, orig in reversed(saved):
            setattr(owner, attr, orig)


@dataclass
class Trace:
    """What a traced window recorded, times in seconds from its start."""
    window_s: float
    device: list = field(default_factory=list)   # (name, start, end)
    spans: list = field(default_factory=list)    # (name, start, end)

    def span_total(self, *names) -> float:
        return sum(e - s for n, s, e in self.spans if n in names)

    def span_count(self, name) -> int:
        return sum(1 for n, _, _ in self.spans if n == name)

    def busy_intervals(self) -> list:
        return union(clip((s, e) for _, s, e in self.device), 0.0,
                     self.window_s)

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def device_time(self, match) -> float:
        """Device seconds of the operations whose name `match` accepts."""
        return sum(e - s for n, s, e in self.device if match(n))


def clip(intervals, lo=None, hi=None):
    for s, e in intervals:
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            e = min(e, hi)
        if e > s:
            yield s, e


def union(intervals, lo=None, hi=None) -> list:
    """The union of (start, end) intervals as sorted disjoint intervals,
    clipped to [lo, hi]."""
    out = []
    for s, e in sorted(clip(intervals, lo, hi)):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _ns(event, which):
    for attr, scale in ((f"{which}_ns", 1e-9), (f"{which}_us", 1e-6)):
        fn = getattr(event, attr, None)
        if fn is not None:
            return fn() * scale
    raise AttributeError(f"profiler event has no {which} time")


def from_profiler(prof) -> Trace:
    """The device operations and the benchmark's spans of a profiled
    window, which is the span `wabench.window`."""
    from torch.autograd import DeviceType

    device, spans = [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start = _ns(ev, "start")
        end = start + ev.duration_ns() * 1e-9
        annotation = getattr(ev, "is_user_annotation", None)
        if name.startswith(PREFIX) or (annotation is not None and
                                       annotation()):
            if ev.device_type() == DeviceType.CPU:
                spans.append((name[len(PREFIX):], start, end))
            continue
        if ev.device_type() == DeviceType.CUDA:
            device.append((name, start, end))
    window = [(s, e) for n, s, e in spans if n == "window"]
    if len(window) != 1:
        raise RuntimeError(f"expected one window span, found {len(window)}")
    t0, t1 = window[0]
    return Trace(window_s=t1 - t0,
                 device=[(n, s - t0, e - t0) for n, s, e in device],
                 spans=[(n, s - t0, e - t0) for n, s, e in spans])


def host_segments(spans, window_s) -> list:
    """The window cut into (start, end, innermost open span) pieces: the
    latest started of the spans open there, "untraced host" where none
    is."""
    import heapq

    order = sorted((s, e, n) for n, s, e in spans if n != "window")
    cuts = sorted({0.0, window_s, *(t for s, e, _ in order
                                    for t in (s, e) if 0.0 < t < window_s)})
    heap, i, out = [], 0, []
    for a, b in zip(cuts, cuts[1:]):
        while i < len(order) and order[i][0] <= a:
            s, e, n = order[i]
            heapq.heappush(heap, (-s, e, n))
            i += 1
        while heap and heap[0][1] <= a:
            heapq.heappop(heap)
        label = heap[0][2] if heap else "untraced host"
        if out and out[-1][2] == label and out[-1][1] == a:
            out[-1] = (out[-1][0], b, label)
        else:
            out.append((a, b, label))
    return out


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the card's idle
    time by the innermost benchmark span the host was in meanwhile
    ("untraced host" outside any), with the longest stretch of each."""
    by_op: dict = {}
    for n, s, e in trace.device:
        by_op[n] = by_op.get(n, 0.0) + (e - s)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    busy = trace.busy_intervals()
    gaps, t = [], 0.0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < trace.window_s:
        gaps.append((t, trace.window_s))
    idle: dict = {}
    longest: dict = {}
    segs = host_segments(trace.spans, trace.window_s)
    j = 0
    for gs, ge in gaps:
        while j < len(segs) and segs[j][1] <= gs:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < ge:
            a, b, label = segs[k]
            part = min(b, ge) - max(a, gs)
            if part > 0:
                idle[label] = idle.get(label, 0.0) + part
                longest[label] = max(longest.get(label, 0.0), part)
            k += 1
    gaps_out = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[f"{n} (longest {longest[n] * 1e3:.3f} ms)", v]
                          for n, v in gaps_out]}
