"""The reduction of a trace: union busy time on overlapping intervals, idle
gaps named by the host, operator attribution and roofline shares."""

import pytest

from h100bench.harness import trace as tr


def iv(start, end, name="k", corr=0, thread=1, shapes=None):
    return tr.Interval(start, end, name, corr, thread, shapes or [])


def test_union_counts_overlaps_once():
    events = [iv(0, 10), iv(5, 15), iv(20, 30), iv(25, 28), iv(40, 50)]
    assert tr.merged(events, 0, 100) == [(0, 15), (20, 30), (40, 50)]
    t = tr.TraceData(0, 100, {0: events}, [], {})
    assert tr.busy_s(t)[0] == pytest.approx(35e-9)
    assert tr.busy_shares(t)[0] == pytest.approx(0.35)


def test_union_is_clipped_to_the_window():
    t = tr.TraceData(10, 30, {0: [iv(0, 15), iv(25, 40)]}, [], {})
    assert tr.busy_s(t)[0] == pytest.approx(10e-9)
    assert tr.gaps(t, 0) == [(15, 25)]


def test_two_streams_and_two_cards():
    # card 0: two streams overlapping fully; card 1 idle half the time
    t = tr.TraceData(0, 100, {0: [iv(0, 100), iv(10, 90)], 1: [iv(0, 50)]}, [], {})
    shares = tr.busy_shares(t)
    assert shares == {0: pytest.approx(1.0), 1: pytest.approx(0.5)}


def test_host_timeline_innermost():
    ops = [iv(0, 2_000_000, "outer", 1), iv(100, 900, "mid", 2), iv(200, 300, "inner", 3),
           iv(1000, 1100, "later", 4)]
    h = tr.HostTimeline(ops)
    assert h.innermost(250) == "inner"
    assert h.innermost(500) == "mid"
    assert h.innermost(1050) == "later"
    assert h.innermost(5000) == "outer"
    assert h.innermost(3_000_000) is None


def test_breakdown_names_gaps_by_the_host():
    ops = [iv(0, 100_000, "aten::copy_", 7), iv(200_000, 400_000, "cudaStreamSynchronize", 8)]
    device = {0: [iv(100_000, 200_000, "gemm"), iv(400_000, 405_000, "gemm"),
                  iv(410_000, 500_000, "lstm")]}
    t = tr.TraceData(0, 500_000, device, ops, {})
    b = tr.breakdown(t)
    assert b["device_ops"] == [["gemm", pytest.approx(105e-6)], ["lstm", pytest.approx(90e-6)]]
    idle = dict((k, v) for k, v in b["idle_gaps"])
    assert idle["aten::copy_"] == pytest.approx(100e-6)
    assert idle["cudaStreamSynchronize"] == pytest.approx(200e-6)
    assert idle["gaps under 20 us"] == pytest.approx(5e-6)


def test_roofline_share_from_recorded_shapes():
    ops = [iv(10, 20, "op", 5, shapes=[[2, 3]]), iv(30, 40, "op", 6, shapes=[[4, 3]]),
           iv(50, 60, "other", 7, shapes=[[1, 1]])]
    device = {0: [iv(12, 22, "k", 5), iv(32, 37, "k", 6), iv(38, 43, "k2", 6),
                  iv(52, 62, "k", 7)]}
    t = tr.TraceData(0, 100, device, ops, {})
    calls = tr.op_device_time(t, "op")
    assert [c[1] for c in calls] == [pytest.approx(10e-9), pytest.approx(10e-9)]
    # bound: 1 ns per row of the first dimension -> (2 + 4) ns over 20 ns
    share = tr.roofline_share(t, {"op": lambda shapes: shapes[0][0] * 1e-9})
    assert share == pytest.approx(30.0)
    # two operators, each with its own bound: (2 + 4 + 2 x 1) ns over 30 ns
    both = tr.roofline_share(t, {"op": lambda shapes: shapes[0][0] * 1e-9,
                                 "other": lambda shapes: 2e-9})
    assert both == pytest.approx(100.0 * 8 / 30)
    assert tr.roofline_share(t, {"absent": lambda s: 1.0}) is None


class FakeEvent:
    def __init__(self, kind, name, start, dur, device=None, corr=0, linked=0, shapes=()):
        self._k, self._n, self._s, self._d = kind, name, start, dur
        self._dev, self._c, self._l, self._sh = device, corr, linked, list(shapes)

    def activity_type(self):
        return self._k

    def device_type(self):
        return type("D", (), {"name": "CUDA" if self._dev is not None else "CPU"})

    def device_index(self):
        return self._dev

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l

    def start_thread_id(self):
        return 1

    def shapes(self):
        return self._sh


def test_from_kineto_keeps_device_work_and_the_window():
    events = [
        FakeEvent("user_annotation", tr.WINDOW_SPAN, 100, 1000),
        FakeEvent("cpu_op", "segma_tpu_torch::log10_mel", 150, 50, corr=9, shapes=[[64, 480000]]),
        FakeEvent("kernel", "logmel_kernel", 210, 100, device=0, linked=9),
        FakeEvent("gpu_memcpy", "Memcpy HtoD", 400, 20, device=0),
        FakeEvent("gpu_user_annotation", "span", 100, 1000, device=0),
        FakeEvent("kernel", "other card", 400, 20, device=3),
        FakeEvent("cuda_runtime", "cudaLaunchKernel", 160, 5),
    ]
    t = tr.from_kineto(events, [0])
    assert (t.start, t.end) == (100, 1100)
    assert [e.name for e in t.device[0]] == ["logmel_kernel", "Memcpy HtoD"]
    assert t.other_kinds == {"gpu_user_annotation": 1}
    assert [o.name for o in t.ops] == ["segma_tpu_torch::log10_mel"]
    assert tr.op_device_time(t, "segma_tpu_torch::log10_mel")[0][1] == pytest.approx(100e-9)


class OldEvent(FakeEvent):
    """An event of a torch whose events give no activity kind."""

    def __getattribute__(self, name):
        if name == "activity_type":
            raise AttributeError(name)
        return super().__getattribute__(name)


def test_from_kineto_without_activity_kinds():
    events = [
        OldEvent("", tr.WINDOW_SPAN, 100, 1000),
        OldEvent("", "segma_tpu_torch::flash_attn_fwd", 150, 50, corr=4, shapes=[[1, 2, 1, 64]]),
        OldEvent("", "cudaLaunchKernel", 160, 5, corr=4),
        OldEvent("", "flash_fwd_kernel", 210, 100, device=0, linked=4),
        OldEvent("", "Memset (Device)", 320, 10, device=0),
        OldEvent("", tr.WINDOW_SPAN, 100, 1000, device=0),
    ]
    t = tr.from_kineto(events, [0])
    assert [e.name for e in t.device[0]] == ["flash_fwd_kernel", "Memset (Device)"]
    assert t.other_kinds == {"gpu_user_annotation": 1}
    assert [o.name for o in t.ops] == ["segma_tpu_torch::flash_attn_fwd"]
    assert [r.name for r in t.runtime] == ["cudaLaunchKernel"]
    assert tr.op_device_time(t, "segma_tpu_torch::flash_attn_fwd")[0][1] == pytest.approx(100e-9)
