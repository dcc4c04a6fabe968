"""The traced window: torch.profiler over the window of a ``--trace 1`` run,
reduced to what the per-layer metrics read.

- Device activity (kernels, copies, sets) per card, as intervals. The busy
  time of a card is the length of the union of its intervals inside the
  window, so kernels that overlap (several streams, a collective beside
  compute) count once.
- CPU operators with their recorded input shapes and their correlation id;
  a kernel is the operator's when its linked correlation id is the
  operator's (the innermost operator open on the launching thread).
- The idle gaps of each card, named by the innermost operator the host had
  open at the gap's middle.

The window is the span of the ``h100bench.window`` annotation, so the
profiler's clock bounds it.
"""

from __future__ import annotations

import bisect
import contextlib
import re
from collections import defaultdict
from dataclasses import dataclass, field

WINDOW_SPAN = "h100bench.window"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "user_annotation")
RUNTIME_KINDS = ("cuda_runtime", "cuda_driver")
LONG_GAP_NS = 20_000  # gaps at least this long are named one by one
NAME_CHARS = 120


@dataclass
class Interval:
    start: int  # ns
    end: int
    name: str
    corr: int = 0  # a device event: the linked correlation id; an operator: its own
    thread: int = 0
    shapes: list = field(default_factory=list)


@dataclass
class TraceData:
    """A reduced trace: the window, device intervals per card index, host
    operators, the kinds of device activity that were left out, and the
    host's CUDA runtime calls."""

    start: int
    end: int
    device: dict[int, list[Interval]]
    ops: list[Interval]
    other_kinds: dict[str, int]
    runtime: list[Interval] = field(default_factory=list)  # CUDA runtime calls on the host

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-9

    def ops_named(self, name: str) -> list[Interval]:
        return [op for op in self.ops if op.name == name]

    def kernels_by_corr(self) -> dict[int, list[Interval]]:
        out: dict[int, list[Interval]] = defaultdict(list)
        for events in self.device.values():
            for e in events:
                if e.corr:
                    out[e.corr].append(e)
        return out


RUNTIME_RE = re.compile(r"^(cuda[A-Z]|cu[A-Z])")  # CUDA runtime and driver calls


def _kind(e, host_names: set[str]) -> str:
    """An event's activity kind: the event's own where the profiler gives it
    (``activity_type``, newer torch), else from its device, its annotation
    flag and its name (a device event named as a host event is the device
    side of an annotation)."""
    with contextlib.suppress(AttributeError):
        return e.activity_type()
    name = e.name()
    annotation = getattr(e, "is_user_annotation", lambda: False)()
    if e.device_type().name == "CUDA":
        if annotation or name in host_names:
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if annotation:
        return "user_annotation"
    return "cuda_runtime" if RUNTIME_RE.match(name) else "cpu_op"


def from_kineto(events, cards: list[int]) -> TraceData:
    """``prof.profiler.kineto_results.events()`` -> ``TraceData`` over the
    ``WINDOW_SPAN`` annotation, keeping device activity on ``cards``."""
    events = list(events)
    host_names = {e.name() for e in events if e.device_type().name != "CUDA"}
    device: dict[int, list[Interval]] = {c: [] for c in cards}
    ops: list[Interval] = []
    runtime: list[Interval] = []
    other: dict[str, int] = defaultdict(int)
    window = None
    for e in events:
        kind = _kind(e, host_names)
        start = e.start_ns()
        if e.device_type().name == "CUDA":
            if kind not in DEVICE_KINDS:
                other[kind] += 1
            elif e.device_index() in device:
                device[e.device_index()].append(
                    Interval(start, start + e.duration_ns(), e.name(), e.linked_correlation_id()))
            continue
        if e.name() == WINDOW_SPAN:
            window = (start, start + e.duration_ns())
        elif kind in HOST_KINDS:
            ops.append(Interval(start, start + e.duration_ns(), e.name(), e.correlation_id(),
                                e.start_thread_id(), e.shapes()))
        elif kind in RUNTIME_KINDS:
            runtime.append(Interval(start, start + e.duration_ns(), e.name(), 0,
                                    e.start_thread_id()))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} span")
    return TraceData(window[0], window[1], device, ops, dict(other), runtime)


def device_slice(events, cards: list[int]) -> TraceData:
    """A trace taken with device activity alone -> ``TraceData`` whose window
    runs from the first device event to the last on ``cards`` (the marks
    that open and close the slice), with the host's CUDA runtime calls where
    the trace holds them, and no operators."""
    events = list(events)
    device: dict[int, list[Interval]] = {c: [] for c in cards}
    runtime: list[Interval] = []
    other: dict[str, int] = defaultdict(int)
    for e in events:
        kind = _kind(e, set())
        start = e.start_ns()
        if e.device_type().name == "CUDA":
            if kind not in DEVICE_KINDS:
                other[kind] += 1
            elif e.device_index() in device:
                device[e.device_index()].append(Interval(start, start + e.duration_ns(), e.name()))
        elif kind in RUNTIME_KINDS:
            runtime.append(Interval(start, start + e.duration_ns(), e.name(), 0,
                                    e.start_thread_id()))
    spans = [iv for ev in device.values() for iv in ev]
    if not spans:
        raise RuntimeError("the device slice holds no device activity")
    return TraceData(min(i.start for i in spans), max(i.end for i in spans), device, [],
                     dict(other), runtime)


def merged(intervals: list[Interval], lo: int, hi: int) -> list[tuple[int, int]]:
    """The union of ``intervals`` clipped to [lo, hi], as sorted disjoint
    (start, end) pairs."""
    spans = sorted((max(i.start, lo), min(i.end, hi)) for i in intervals
                   if i.end > lo and i.start < hi)
    out: list[tuple[int, int]] = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def busy_s(trace: TraceData) -> dict[int, float]:
    """Each card's busy seconds in the window: the length of the union of
    its device intervals."""
    return {card: sum(e - s for s, e in merged(ev, trace.start, trace.end)) * 1e-9
            for card, ev in trace.device.items()}


def busy_shares(trace: TraceData) -> dict[int, float]:
    return {card: b / trace.window_s for card, b in busy_s(trace).items()}


def gaps(trace: TraceData, card: int) -> list[tuple[int, int]]:
    """The idle stretches of ``card`` inside the window."""
    out, t = [], trace.start
    for s, e in merged(trace.device[card], trace.start, trace.end):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < trace.end:
        out.append((t, trace.end))
    return out


class HostTimeline:
    """The innermost host operator open at a time (the open one that started
    last), over every thread. Operators of at least ``long_ns`` are searched
    one by one, the others by their start."""

    def __init__(self, ops: list[Interval], long_ns: int = 1_000_000) -> None:
        self.long_ns = long_ns
        self.short = sorted((o for o in ops if o.end - o.start < long_ns), key=lambda o: o.start)
        self.starts = [o.start for o in self.short]
        self.long = [o for o in ops if o.end - o.start >= long_ns]

    def innermost(self, t: int) -> str | None:
        best = None
        i = bisect.bisect_right(self.starts, t)
        while i > 0:  # a short operator open at t started less than long_ns before it
            i -= 1
            op = self.short[i]
            if t - op.start >= self.long_ns:
                break
            if op.end > t:
                best = op
                break
        for op in self.long:
            if op.start <= t < op.end and (best is None or op.start > best.start):
                best = op
        return None if best is None else best.name


def breakdown(trace: TraceData, top: int = 10) -> dict:
    """``device_ops``: device time by activity name, over all cards, the
    ``top`` largest; ``idle_gaps``: idle seconds by what the host had open
    (gaps shorter than LONG_GAP_NS together), over all cards."""
    by_name: dict[str, float] = defaultdict(float)
    for events in trace.device.values():
        for e in clipped(events, trace.start, trace.end):
            by_name[e[0]] += e[1]
    host = HostTimeline(trace.ops + trace.runtime)
    idle: dict[str, float] = defaultdict(float)
    for card in trace.device:
        for s, e in gaps(trace, card):
            if e - s < LONG_GAP_NS:
                idle[f"gaps under {LONG_GAP_NS // 1000} us"] += (e - s) * 1e-9
                continue
            name = host.innermost((s + e) // 2) or "no traced host call open"
            idle[name[:NAME_CHARS]] += (e - s) * 1e-9
    def ranked(d: dict[str, float]) -> list:
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": ranked(by_name), "idle_gaps": ranked(idle)}


def clipped(events: list[Interval], lo: int, hi: int) -> list[tuple[str, float]]:
    """(name, seconds inside [lo, hi]) of each device event."""
    return [(e.name[:NAME_CHARS], (min(e.end, hi) - max(e.start, lo)) * 1e-9)
            for e in events if e.end > lo and e.start < hi]


def op_device_time(trace: TraceData, name: str) -> list[tuple[Interval, float]]:
    """Each call of operator ``name`` inside the window that launched device
    work, with the seconds of that work (all cards)."""
    by_corr = trace.kernels_by_corr()
    out = []
    for op in trace.ops_named(name):
        if not (trace.start <= op.start < trace.end):
            continue
        kernels = by_corr.get(op.corr, [])
        if kernels:
            out.append((op, sum(k.end - k.start for k in kernels) * 1e-9))
    return out


def roofline_share(trace: TraceData, bounds: dict) -> float | None:
    """100 x (the bounds of the calls of each operator named in ``bounds``,
    from each call's recorded input shapes by ``bounds[name](shapes)``) /
    (their device time); None when no such call launched device work in the
    window."""
    calls = [(bound_s(op.shapes), t) for name, bound_s in bounds.items()
             for op, t in op_device_time(trace, name)]
    if not calls:
        return None
    return 100.0 * sum(b for b, _ in calls) / sum(t for _, t in calls)
