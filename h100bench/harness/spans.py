"""The program's own spans and counters in a traced run, and the idle gaps of
the device slice named by them.

The port (``segma_tpu_torch.telemetry``) records its spans and counts while
a torch.profiler session runs, stamped with ``time.time_ns()``, the clock
of the profiler's events. So what the program recorded over the device
slice is what lies inside the slice's window: ``device_slice_recording``.
A program without the recorder (an older commit) gives None, and so do the
readers that use it; so does a run without a card, whose slice has no
window on that clock. A program with the recorder that recorded nothing
over the slice raises: its metrics would otherwise vanish from the line
without a word.

``idle_gaps`` is ``trace.breakdown``'s naming of the idle gaps with one
more source: a gap in which no traced CUDA call was open is named by the
innermost program span open at its middle, on the thread whose runtime call
launched the first device event after the gap (that launch is what the card
waited for), or on any thread where that thread has none open.
``linked_device_slice`` is ``trace.device_slice`` with the links kept. A
runtime call's thread is CUPTI's id, the low 32 bits of the thread's
pthread id: ``telemetry.threads()`` gives each recording thread's, and so
the native id its spans carry.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from statistics import median

from h100bench.harness import trace as tr

NO_CALL = "no traced host call open"


def device_slice_recording(run):
    """What the program recorded over the device slice of ``run`` (a
    ``telemetry.Recording``), or None: no card, no device slice, or a
    program without the recorder. Raises where the recorder is there and
    recorded nothing in the slice (it no longer follows the profiler)."""
    t = run.device_trace
    if t is None or run.device != "cuda":
        return None
    try:
        from segma_tpu_torch import telemetry
    except ImportError:
        return None
    rec = telemetry.recorded(t.start, t.end)
    if not (rec.spans or rec.counters):
        raise RuntimeError("segma_tpu_torch.telemetry recorded nothing over the device slice: "
                           "the program's spans and counters did not follow torch.profiler")
    return rec


def time_share(trace: tr.TraceData, rec, name: str) -> float | None:
    """100 x the seconds of the spans ``name`` (one thread's: they do not
    overlap) over the slice's wall; None without such spans."""
    spans = rec.named(name)
    if not spans:
        return None
    return 100.0 * sum(s.end_ns - s.start_ns for s in spans) / (trace.end - trace.start)


def median_ms(rec, name: str) -> float | None:
    spans = rec.named(name)
    return median((s.end_ns - s.start_ns) * 1e-6 for s in spans) if spans else None


def linked_device_slice(events, cards: list[int]) -> tr.TraceData:
    """``trace.device_slice`` with the correlation id that links each device
    event to the runtime call that launched it kept on both
    (``Interval.corr``), and a runtime call's thread the one CUPTI reports
    (``device_resource_id``)."""
    events = list(events)
    device: dict[int, list[tr.Interval]] = {c: [] for c in cards}
    runtime: list[tr.Interval] = []
    other: dict[str, int] = defaultdict(int)
    for e in events:
        kind = tr._kind(e, set())
        start = e.start_ns()
        if e.device_type().name == "CUDA":
            if kind not in tr.DEVICE_KINDS:
                other[kind] += 1
            elif e.device_index() in device:
                device[e.device_index()].append(tr.Interval(
                    start, start + e.duration_ns(), e.name(), e.correlation_id()))
        elif kind in tr.RUNTIME_KINDS:
            runtime.append(tr.Interval(start, start + e.duration_ns(), e.name(),
                                       e.correlation_id(), e.device_resource_id()))
    spans = [iv for ev in device.values() for iv in ev]
    if not spans:
        raise RuntimeError("the device slice holds no device activity")
    return tr.TraceData(min(i.start for i in spans), max(i.end for i in spans), device, [],
                        dict(other), runtime)


def idle_gaps(trace: tr.TraceData, spans: list, idents: dict[int, int] | None = None,
              top: int = 10) -> tuple[list, dict]:
    """(``breakdown``'s ``idle_gaps``, the long gaps named by a program span
    found on the launching thread and on any thread): gaps shorter than
    ``trace.LONG_GAP_NS`` together; a longer one by the innermost runtime
    call open at its middle, else by the innermost program span (``spans``:
    ``telemetry.Span``) open there on the launching thread, else on any
    thread (the trace does not link the launch, or the launching thread
    has no span open: autograd's backward thread launches for the training
    thread's span), else as no traced host call open. ``idents``
    (``telemetry.threads()``) maps the spans' native thread ids to the
    pthread ids whose low 32 bits the runtime calls carry; without it the
    two are taken to be the same ids."""
    calls = tr.HostTimeline(trace.ops + trace.runtime)
    as_iv = [tr.Interval(s.start_ns, s.end_ns, s.name, 0, s.thread) for s in spans]
    anywhere = tr.HostTimeline(as_iv)
    by_thread: dict[int, list] = defaultdict(list)
    for iv in as_iv:
        by_thread[iv.thread].append(iv)
    on_thread = {t: tr.HostTimeline(ivs) for t, ivs in by_thread.items()}
    native = {ident & 0xFFFFFFFF: n for n, ident in (idents or {}).items()}
    launcher = {rt.corr: native.get(rt.thread & 0xFFFFFFFF, rt.thread)
                for rt in trace.runtime if rt.corr}
    idle: dict[str, float] = defaultdict(float)
    how = {"launching_thread": 0, "any_thread": 0}
    for card, events in trace.device.items():
        events = sorted(events, key=lambda e: e.start)
        starts = [e.start for e in events]
        for s, e in tr.gaps(trace, card):
            if e - s < tr.LONG_GAP_NS:
                idle[f"gaps under {tr.LONG_GAP_NS // 1000} us"] += (e - s) * 1e-9
                continue
            mid = (s + e) // 2
            name = calls.innermost(mid)
            if name is None:
                i = bisect.bisect_left(starts, e)
                thread = launcher.get(events[i].corr) if i < len(events) else None
                if thread in on_thread:
                    name = on_thread[thread].innermost(mid)
                    how["launching_thread"] += name is not None
                if name is None:
                    name = anywhere.innermost(mid)
                    how["any_thread"] += name is not None
            idle[(name or NO_CALL)[: tr.NAME_CHARS]] += (e - s) * 1e-9
    ranked = [[k, v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:top]]
    return ranked, how
