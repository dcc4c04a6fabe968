"""Spans and counters of the program, on the clock that torch.profiler
stamps its events with.

A span is one named interval of a thread's work: ``with span("serve.write",
file=stem): ...``. Recording is off unless a ``recording()`` extent is open
or a torch.profiler session is running; off, ``span()`` returns one shared
no-op object after a flag check, with no allocation and no clock read. On,
each span keeps its name, its start and end in ns, the native id of its
thread, the id of its parent (the span open on the same thread when it
began) and its attributes, in a list of its thread's, in memory, until it
is collected (``recorded``, ``take``). A span made with ``cuda_time=True``
also records a pair of CUDA timing events on the current stream, and its
``cuda_ns`` is the device time between them once both have run. While
``torch.export`` or ``torch.compile`` traces, no span is recorded, so the
traced program is the same whether recording is on or off.

Records made while a profiler runs stay in memory until ``take()`` or
``clear()`` drops them; a long-lived process that is profiled again and
again calls one of them after each profile. Whether a profiler runs is read
from ``torch.autograd.profiler._is_profiler_enabled``, a private flag: the
module refuses to import where it is missing, rather than record nothing.

The clock is ``time.time_ns()``, CLOCK_REALTIME: the one ``c10::getTime``
reads, which stamps the profiler's host events; the profiler puts its
device events on the same clock. So a span can be laid over a trace.

A counter is a number by key, counted under one lock (``x += 1`` on a global
is a read, an add and a store, and two threads at once can lose a count):
the kernel wrappers' launches (``launch.<kernel>``, which ``ops`` reads),
serving's and training's counts. The totals are always kept; while
recording is on each count is also recorded with its time, so that a
window's counts can be summed (``Recording.counters``).
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from collections.abc import Iterator
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path

import torch
from torch.autograd import profiler as _profiler

if not isinstance(getattr(_profiler, "_is_profiler_enabled", None), bool):
    raise RuntimeError(
        f"torch {torch.__version__} has no torch.autograd.profiler._is_profiler_enabled: "
        "segma_tpu_torch.telemetry records while a torch.profiler session runs by that flag, "
        "and the benchmark's traced runs read what it records")

_open = 0  # recording() extents open, over every thread


class Counters:
    """Counts by key, read and written under one lock."""

    def __init__(self, keys: tuple[str, ...] = ()) -> None:
        self._lock = threading.Lock()
        self._counts = dict.fromkeys(keys, 0)

    def add(self, counts: dict[str, int]) -> None:
        with self._lock:
            for key, n in counts.items():
                self._counts[key] = self._counts.get(key, 0) + n

    def read(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def set(self, counts: dict[str, int]) -> None:
        with self._lock:
            self._counts.update(counts)


@dataclass
class Span:
    """One recorded span: ``start_ns`` and ``end_ns`` on ``time.time_ns()``'s
    clock, ``thread`` the native id of the thread that ran it, ``parent``
    the ``id`` of the span that was open on that thread when it began."""

    name: str
    start_ns: int
    end_ns: int
    thread: int
    id: int
    parent: int | None
    attrs: dict
    events: tuple | None = field(default=None, repr=False)  # the CUDA timing pair

    @property
    def cuda_ns(self) -> int | None:
        """The device time between the span's CUDA events; None without
        them, or before both have run."""
        if self.events is None or not all(e.query() for e in self.events):
            return None
        return int(self.events[0].elapsed_time(self.events[1]) * 1e6)

    def as_dict(self) -> dict:
        out = {"name": self.name, "start_ns": self.start_ns, "end_ns": self.end_ns,
               "thread": self.thread, "id": self.id, "parent": self.parent}
        if self.attrs:
            out["attrs"] = self.attrs
        if self.events is not None:
            out["cuda_ns"] = self.cuda_ns
        return out


@dataclass
class Recording:
    """What was recorded over an extent: the spans that ended in it, in
    order of their start, and the counts made in it, by key."""

    spans: list[Span]
    counters: dict[str, int]

    def named(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]


class _Thread(threading.local):
    def __init__(self) -> None:
        self.native = threading.get_native_id()
        self.stack: list[_OpenSpan] = []
        self.spans: list[Span] | None = None  # made at the thread's first record
        self.counts: list[tuple[int, str, int]] | None = None


_local = _Thread()
_lists_lock = threading.Lock()
_lists: list[tuple[threading.Thread, list, list]] = []  # every thread's records
_ids = itertools.count(1)
_counters = Counters()


def _records() -> tuple[list[Span], list[tuple[int, str, int]]]:
    """This thread's lists of spans and counts, registered at first use."""
    if _local.spans is None:
        _local.spans, _local.counts = [], []
        with _lists_lock:
            _lists.append((threading.current_thread(), _local.spans, _local.counts))
    return _local.spans, _local.counts


def _on() -> bool:
    return bool(_open) or _profiler._is_profiler_enabled


class _NoSpan:
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None


_NO_SPAN = _NoSpan()


class _OpenSpan:
    __slots__ = ("name", "attrs", "id", "parent", "start_ns", "events")

    def __init__(self, name: str, attrs: dict, cuda_time: bool) -> None:
        self.name, self.attrs = name, attrs
        self.events = None
        if (cuda_time and torch.cuda.is_initialized()
                and not torch.cuda.is_current_stream_capturing()):
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))

    def __enter__(self) -> _OpenSpan:
        stack = _local.stack
        self.parent = stack[-1].id if stack else None
        self.id = next(_ids)
        stack.append(self)
        if self.events is not None:
            self.events[0].record()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = time.time_ns()
        if self.events is not None:
            self.events[1].record()
        _local.stack.pop()
        _records()[0].append(Span(self.name, self.start_ns, end, _local.native, self.id,
                                  self.parent, self.attrs, self.events))


def span(name: str, cuda_time: bool = False, **attrs) -> _OpenSpan | _NoSpan:
    """A context manager that records ``name`` over its extent, with
    ``attrs``, while recording is on (a shared no-op otherwise);
    ``cuda_time``: also the device time of the work enqueued on the current
    CUDA stream inside it."""
    if not (_open or _profiler._is_profiler_enabled) or torch.compiler.is_compiling():
        return _NO_SPAN
    return _OpenSpan(name, attrs, cuda_time)


def count(key: str, n: int = 1) -> None:
    """Advance counter ``key`` by ``n``."""
    add_counts({key: n})


def add_counts(counts: dict[str, int]) -> None:
    """Advance several counters at once."""
    _counters.add(counts)
    if _on():
        t = time.time_ns()
        _records()[1].extend((t, key, n) for key, n in counts.items())


def counts() -> dict[str, int]:
    """Every counter's total since it was last set."""
    return _counters.read()


def set_counts(counts: dict[str, int]) -> None:
    """Set the totals of the counters in ``counts``."""
    _counters.set(counts)


def recorded(start_ns: int = 0, end_ns: int | None = None) -> Recording:
    """The spans recorded that lie inside [start_ns, end_ns] and the counts
    made in it (every record up to now without ``end_ns``); the records
    stay."""
    end = time.time_ns() if end_ns is None else end_ns
    with _lists_lock:
        lists = [(list(s), list(c)) for _, s, c in _lists]
    spans = sorted((s for ss, _ in lists for s in ss if s.start_ns >= start_ns and s.end_ns <= end),
                   key=lambda s: s.start_ns)
    totals: dict[str, int] = {}
    for _, cs in lists:
        for t, key, n in cs:
            if start_ns <= t <= end:
                totals[key] = totals.get(key, 0) + n
    return Recording(spans, totals)


def threads() -> dict[int, int]:
    """The native id of each thread that has records, to its
    ``threading.get_ident()`` (the pthread id, whose low 32 bits are the
    thread id CUPTI gives a CUDA runtime call)."""
    with _lists_lock:
        return {t.native_id: t.ident for t, _, _ in _lists}


def clear() -> None:
    """Drop every record (the totals stay), and the lists of threads that
    have ended."""
    with _lists_lock:
        for _, s, c in _lists:
            s.clear()
            c.clear()
        _lists[:] = [entry for entry in _lists if entry[0].is_alive()]


def take(start_ns: int = 0) -> Recording:
    """``recorded(start_ns)``, and the records dropped when nothing records
    any more."""
    out = recorded(start_ns)
    if not _on():
        clear()
    return out


def write_spans(spans: list[Span], path: Path) -> None:
    """One JSON object a span (``Span.as_dict``), a line each."""
    with Path(path).open("w") as f:
        for s in spans:
            f.write(json.dumps(s.as_dict()) + "\n")


@contextmanager
def recording() -> Iterator[Recording]:
    """Turn recording on over the block; the ``Recording`` it yields is
    filled at the block's end with what was recorded in it, on every
    thread."""
    global _open
    rec = Recording([], {})
    with _lists_lock:
        _open += 1
    start = time.time_ns()
    try:
        yield rec
    finally:
        with _lists_lock:
            _open -= 1
        got = take(start)
        rec.spans, rec.counters = got.spans, got.counters
