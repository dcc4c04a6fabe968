"""The readers of the program's spans and counters, and the idle gaps named
by them, on synthetic traces and recordings."""

import sys
import time
from types import SimpleNamespace

import pytest

from h100bench.harness import manifest as mf
from h100bench.harness import spans as sp
from h100bench.harness import trace as tr
from segma_tpu_torch import telemetry

READERS = ("pad_share.serve", "queue_wait.serve", "bilstm_ms.serve", "loader_wait.train",
           "host_step_ms.train")


def reader(name):
    return mf.load_module(mf.metric_path(name), name)


class FakeEvent:
    """A CUDA timing event that has run, ``at_ms`` after a common origin."""

    def __init__(self, at_ms):
        self.at_ms = at_ms

    def query(self):
        return True

    def elapsed_time(self, end):
        return end.at_ms - self.at_ms


def span(name, start, end, thread=1, sid=0, parent=None, cuda_ms=None, **attrs):
    events = None if cuda_ms is None else (FakeEvent(0.0), FakeEvent(cuda_ms))
    return telemetry.Span(name, start, end, thread, sid, parent, attrs, events)


def iv(start, end, name="k", corr=0, thread=0):
    return tr.Interval(start, end, name, corr, thread)


def fake_run(trace, device="cuda"):
    return SimpleNamespace(device_trace=trace, device=device)


@pytest.fixture(autouse=True)
def _empty_store():
    telemetry.clear()
    yield
    telemetry.clear()


def test_pad_share_and_bilstm_ms():
    rec = telemetry.Recording(
        [span("model.bilstm", 0, 10, cuda_ms=2.5), span("model.bilstm", 20, 30, cuda_ms=3.5)],
        {"serve.chunks_real": 9082, "serve.chunks_padded": 646})
    assert reader("pad_share.serve").value(rec) == pytest.approx(100 * 646 / 9728)
    assert reader("bilstm_ms.serve").value(rec) == pytest.approx(6.0 / 9082)
    empty = telemetry.Recording([], {})
    assert reader("pad_share.serve").value(empty) is None
    assert reader("bilstm_ms.serve").value(empty) is None
    # a span whose events have not both run gives no device time
    pending = telemetry.Recording([span("model.bilstm", 0, 10)], {"serve.chunks_real": 1})
    assert reader("bilstm_ms.serve").value(pending) is None


def test_time_share_and_median():
    t = tr.TraceData(0, 1_000_000_000, {0: []}, [], {})
    rec = telemetry.Recording(
        [span("serve.queue_wait", 0, 100_000_000), span("serve.queue_wait", 500_000_000,
                                                         650_000_000),
         span("train.step", 0, 2_000_000), span("train.step", 0, 3_000_000),
         span("train.step", 0, 9_000_000)], {})
    assert sp.time_share(t, rec, "serve.queue_wait") == pytest.approx(25.0)
    assert sp.time_share(t, rec, "train.loader_wait") is None
    assert sp.median_ms(rec, "train.step") == pytest.approx(3.0)
    assert sp.median_ms(rec, "absent") is None


def test_readers_read_the_device_slice_and_nothing_else():
    with telemetry.recording():
        before = time.time_ns()
        with telemetry.span("serve.queue_wait"):
            time.sleep(0.001)
        t0 = time.time_ns()
        with telemetry.span("serve.queue_wait"):
            time.sleep(0.002)
        with telemetry.span("train.step"):
            time.sleep(0.001)
        with telemetry.span("train.loader_wait"):
            time.sleep(0.001)
        telemetry.add_counts({"serve.chunks_real": 30, "serve.chunks_padded": 2})
        t1 = time.time_ns()
        telemetry.add_counts({"serve.chunks_padded": 100})
        trace = tr.TraceData(t0, t1, {0: []}, [], {})
        run = fake_run(trace)
        values = {name: reader(name).read(run, None) for name in READERS}
        assert values["pad_share.serve"] == pytest.approx(100 * 2 / 32)
        wall = t1 - t0
        assert 0.002e9 / wall * 100 <= values["queue_wait.serve"] <= 100
        assert 0.001e9 / wall * 100 <= values["loader_wait.train"] <= 100
        assert values["host_step_ms.train"] >= 1.0
        assert values["bilstm_ms.serve"] is None  # no model.bilstm span
        # the earlier span lies before the slice
        assert len(sp.device_slice_recording(run).named("serve.queue_wait")) == 1
        assert before < t0
        # no card, no slice
        assert all(reader(n).read(fake_run(trace, "cpu"), None) is None for n in READERS)
        assert all(reader(n).read(fake_run(None), None) is None for n in READERS)


def test_readers_give_nothing_without_the_recorder(monkeypatch):
    """A program without ``segma_tpu_torch.telemetry`` (an older commit):
    every reader gives None and none raises."""
    import segma_tpu_torch

    monkeypatch.setitem(sys.modules, "segma_tpu_torch.telemetry", None)
    monkeypatch.delattr(segma_tpu_torch, "telemetry")
    trace = tr.TraceData(0, time.time_ns(), {0: []}, [], {})
    assert all(reader(n).read(fake_run(trace), None) is None for n in READERS)


def test_a_recorder_that_recorded_nothing_in_the_slice_raises():
    """The recorder is there but did not follow the slice's profiler: the
    readers raise rather than leave their metrics out without a word."""
    trace = tr.TraceData(0, time.time_ns(), {0: []}, [], {})
    for name in READERS:
        with pytest.raises(RuntimeError, match="recorded nothing"):
            reader(name).read(fake_run(trace), None)
    assert all(reader(n).read(fake_run(trace, "cpu"), None) is None for n in READERS)


def test_every_reader_is_in_the_manifest_for_its_one_cell():
    for name in READERS:
        m = mf.Manifest.load().metrics[name]
        assert m.kind == "per_layer" and len(m.workloads) == 1
        assert m.source in ("program_span", "program_counter")


def test_idle_gaps_named_by_the_launching_threads_span():
    us = 1000
    # card 0: kernels at 0-10 us, 100-110, 200-210, 215-216, 400-410 us
    device = {0: [iv(0, 10 * us, corr=1), iv(100 * us, 110 * us, corr=2),
                  iv(200 * us, 210 * us, corr=3), iv(215 * us, 216 * us, corr=4),
                  iv(400 * us, 410 * us, corr=5)]}
    runtime = [iv(0, 1 * us, "cudaLaunchKernel", 1, 7),
               iv(95 * us, 99 * us, "cudaLaunchKernel", 2, 7),
               iv(150 * us, 170 * us, "cudaStreamSynchronize", 0, 7),
               iv(211 * us, 212 * us, "cudaLaunchKernel", 4, 7),
               iv(390 * us, 399 * us, "cudaLaunchKernel", 5, 7)]
    t = tr.TraceData(0, 410 * us, device, [], {}, runtime)
    spans = [
        # thread 7 (the launcher) waits for its queue over the first gap; a
        # span of thread 8 that started later is open there too
        span("serve.queue_wait", 5 * us, 95 * us, thread=7, sid=1),
        span("serve.load", 20 * us, 300 * us, thread=8, sid=2),
        # the third gap (216-400 us): the launcher, thread 7, has no span
        # open at its middle (308 us), so any thread's innermost names it
        span("serve.write", 250 * us, 350 * us, thread=8, sid=3),
    ]
    named, how = sp.idle_gaps(t, spans)
    idle = dict((k, v) for k, v in named)
    # the runtime calls carry the low 32 bits of the launcher's pthread id
    pthread = {7: 0x7F5A_E239_6700, 8: 0x7F5A_E200_0700}
    hidden = tr.TraceData(0, 410 * us, device, [], {}, [
        tr.Interval(c.start, c.end, c.name, c.corr, pthread[c.thread] & 0xFFFFFFFF)
        for c in runtime])
    assert sp.idle_gaps(hidden, spans, pthread) == (named, how)
    assert idle["serve.queue_wait"] == pytest.approx(90e-6)  # 10-100 us: thread 7's
    assert idle["cudaStreamSynchronize"] == pytest.approx(90e-6)  # 110-200 us: a call
    assert idle["gaps under 20 us"] == pytest.approx(5e-6)  # 210-215
    assert idle["serve.write"] == pytest.approx(184e-6)  # 216-400
    assert how == {"launching_thread": 1, "any_thread": 1}
    # nothing open anywhere: no traced host call open
    named, _ = sp.idle_gaps(t, spans[:2])
    assert dict((k, v) for k, v in named)[sp.NO_CALL] == pytest.approx(184e-6)
    # without the links, the innermost span on any thread: the later
    # serve.load over the first gap, thread 8's serve.write over the third
    unlinked = tr.TraceData(0, 410 * us, {0: [tr.Interval(e.start, e.end, e.name)
                                              for e in device[0]]}, [], {}, runtime)
    named, how = sp.idle_gaps(unlinked, spans)
    idle = dict((k, v) for k, v in named)
    assert idle["serve.load"] == pytest.approx(90e-6)
    assert idle["serve.write"] == pytest.approx(184e-6)
    assert how == {"launching_thread": 0, "any_thread": 2}


def test_linked_device_slice_keeps_the_links():
    class E:
        def __init__(self, device, name, start, dur, corr=0, linked=0, index=0, thread=3):
            self._d, self._n, self._s, self._dur = device, name, start, dur
            self._c, self._l, self._i, self._t = corr, linked, index, thread

        def device_type(self):
            return SimpleNamespace(name=self._d)

        def name(self):
            return self._n

        def start_ns(self):
            return self._s

        def duration_ns(self):
            return self._dur

        def correlation_id(self):
            return self._c

        def linked_correlation_id(self):
            return self._l

        def device_index(self):
            return self._i

        def start_thread_id(self):
            return 1

        def device_resource_id(self):
            return self._t

        def activity_type(self):
            return "kernel" if self._d == "CUDA" else "cuda_runtime"

    events = [E("CPU", "cudaLaunchKernel", 0, 5, corr=11, thread=42),
              E("CUDA", "gemm", 10, 20, corr=11)]
    t = sp.linked_device_slice(events, [0])
    assert (t.start, t.end) == (10, 30)
    assert t.device[0][0].corr == 11
    assert (t.runtime[0].corr, t.runtime[0].thread) == (11, 42)
