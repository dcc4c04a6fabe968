"""The recorder of spans and counters (``segma_tpu_torch.telemetry``): off
it records nothing and costs under a microsecond a span; on, spans nest by
thread, threads stay apart, counters lose no count under threads, the
kernel wrappers' launch counters read as before, and a span lies on the
clock that torch.profiler stamps its events with."""

from __future__ import annotations

import sys
import threading
import time

import pytest
import torch

from segma_tpu_torch import ops, telemetry

N_THREADS = 8


@pytest.fixture(autouse=True)
def _empty_store():
    telemetry.clear()
    yield
    telemetry.clear()


def test_off_span_is_the_shared_no_op_and_records_nothing():
    assert telemetry.span("a") is telemetry.span("b", x=1) is telemetry._NO_SPAN
    with telemetry.span("a"):
        telemetry.count("test.off")
    assert telemetry.recorded().spans == []
    assert telemetry.recorded().counters == {}


def test_off_span_costs_under_a_microsecond():
    # the best of many short repeats: a loaded host slows some of them, not all
    n = 50_000
    best = float("inf")
    for _ in range(15):
        t0 = time.perf_counter()
        for _ in range(n):
            with telemetry.span("model.encoder"):
                pass
        best = min(best, (time.perf_counter() - t0) / n)
    assert best < 1e-6, f"a disabled span costs {best * 1e9:.0f} ns"


def test_nesting_sets_parents_and_attrs():
    with telemetry.recording() as rec:
        with telemetry.span("outer", file="f0") as outer:
            with telemetry.span("mid"):
                with telemetry.span("inner"):
                    pass
            with telemetry.span("mid2"):
                pass
        with telemetry.span("after"):
            pass
    by = {s.name: s for s in rec.spans}
    assert [s.name for s in rec.spans] == ["outer", "mid", "inner", "mid2", "after"]
    assert by["outer"].parent is None and by["after"].parent is None
    assert by["mid"].parent == by["mid2"].parent == outer.id == by["outer"].id
    assert by["inner"].parent == by["mid"].id
    assert by["outer"].attrs == {"file": "f0"} and by["mid"].attrs == {}
    for s in rec.spans:
        assert s.start_ns <= s.end_ns and s.thread == threading.get_native_id()
    assert by["outer"].start_ns <= by["inner"].start_ns <= by["inner"].end_ns <= by["outer"].end_ns
    assert by["inner"].cuda_ns is None
    # the records are taken: a later recording starts empty
    with telemetry.recording() as again:
        pass
    assert again.spans == [] and again.counters == {}


def test_spans_from_eight_threads_stay_apart():
    barrier = threading.Barrier(N_THREADS)
    ids, idents = {}, {}

    def work(k: int) -> None:
        ids[k] = threading.get_native_id()
        idents[ids[k]] = threading.get_ident()
        barrier.wait(30)
        for i in range(50):
            with telemetry.span("outer", worker=k, i=i):
                with telemetry.span("inner", worker=k, i=i):
                    time.sleep(0)

    with telemetry.recording() as rec:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(N_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
        assert idents.items() <= telemetry.threads().items()
    assert len(rec.spans) == N_THREADS * 100
    by_id = {s.id: s for s in rec.spans}
    for s in rec.spans:
        assert s.thread == ids[s.attrs["worker"]]
        if s.name == "outer":
            assert s.parent is None
        else:
            parent = by_id[s.parent]
            assert parent.name == "outer" and parent.attrs == s.attrs
            assert parent.thread == s.thread


def test_counters_lose_no_count_under_eight_threads():
    """8 threads counting at once with the interpreter switching threads
    every microsecond, recording on: the totals and the recorded counts
    both hold every count."""
    telemetry.set_counts({"test.a": 0, "test.b": 0})
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                telemetry.count("test.a")
                telemetry.add_counts({"test.b": 2})

        with telemetry.recording() as rec:
            threads = [threading.Thread(target=work) for _ in range(N_THREADS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
                assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    totals = telemetry.counts()
    assert (totals["test.a"], totals["test.b"]) == (N_THREADS * 2000, N_THREADS * 4000)
    assert rec.counters == {"test.a": N_THREADS * 2000, "test.b": N_THREADS * 4000}


def test_launch_counters_are_the_stores():
    saved = ops.launch_counts()
    try:
        ops.set_launch_counts(dict.fromkeys(saved, 0))
        assert set(ops.launch_counts()) == set(ops.LAUNCH_KEYS)
        ops.count_launch("logmel")
        ops.add_launch_counts({"flash_attn_bwd": 3})
        assert ops.launch_counts() == {**dict.fromkeys(saved, 0), "logmel": 1,
                                       "flash_attn_bwd": 3}
        assert telemetry.counts()["launch.logmel"] == 1
        with telemetry.recording() as rec:
            ops.count_launch("flash_attn_fwd")
        assert rec.counters == {"launch.flash_attn_fwd": 1}
    finally:
        ops.set_launch_counts(saved)


def test_a_span_holds_the_profilers_event_on_its_clock():
    """Inside a CPU torch.profiler profile, which turns recording on, a span
    around a ``record_function`` contains that event's interval on the
    profile's clock, within 100 us."""
    from torch.profiler import ProfilerActivity, profile, record_function

    slack = 100_000
    x = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert telemetry.span("probe") is not telemetry._NO_SPAN
        with telemetry.span("probe"):
            with record_function("probe.event"):
                for _ in range(20):
                    x = torch.tanh(x @ x)
    spans = telemetry.take().named("probe")
    events = [e for e in prof.profiler.kineto_results.events() if e.name() == "probe.event"]
    assert len(spans) == 1 and len(events) == 1
    s, e = spans[0], events[0]
    assert s.start_ns - slack <= e.start_ns()
    assert e.start_ns() + e.duration_ns() <= s.end_ns + slack
    assert telemetry.span("probe") is telemetry._NO_SPAN  # off once the profile stops


def test_counts_are_summed_by_window():
    with telemetry.recording():
        telemetry.count("test.w", 5)
        mid = time.time_ns()
        time.sleep(0.002)
        telemetry.count("test.w", 7)
        with telemetry.span("late"):
            pass
        assert telemetry.recorded(mid).counters == {"test.w": 7}
        assert telemetry.recorded(0, mid).counters == {"test.w": 5}
        assert telemetry.recorded(0, mid).spans == []


def test_no_span_while_exporting():
    """A span inside a module that torch.export traces records nothing and
    leaves the program as it is."""

    class M(torch.nn.Module):
        def forward(self, x):
            with telemetry.span("model.encoder"):
                return torch.relu(x) * 2

    with telemetry.recording() as rec:
        program = torch.export.export(M(), (torch.randn(3),), strict=False)
    assert rec.spans == []
    assert torch.equal(program.module()(torch.ones(3)), torch.full((3,), 2.0))
