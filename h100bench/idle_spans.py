"""A cell's device-slice idle gaps named by the program's spans, the clock
check of those spans against the profiler's, and the recorder's cost.

    python3 h100bench/idle_spans.py --workload <cell> --seeds 11 12 --seconds 30 \
        --modes plain record trace

Runs the cell's driver once per seed and mode, in this process, and prints
one JSON line a run:

- ``plain``: an untraced run, its end-to-end values (``measured``);
- ``record``: an untraced run with the program's recording on throughout
  (``telemetry.recording()``, no profiler), its end-to-end values: against
  ``plain``, the recorder's own cost;
- ``trace``: a ``--trace 1`` run whose device slice keeps the trace's links
  (``spans.linked_device_slice``), its per-layer metrics, its end-to-end
  values over the traced window, the slice's ``idle_gaps`` as
  ``trace.breakdown`` names them and as ``spans.idle_gaps`` names them, the
  program's spans in the slice by name (count and seconds), and the clock
  check: each device event launched by a runtime call that lies inside a
  program span of the same thread starts after that span's start.
"""

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def innermost_starts(spans, calls) -> dict:
    """For each runtime call (an ``Interval``), the start of the innermost
    program span of its thread open at the call's start, by the call's
    correlation id; a thread's spans nest, so one sweep over them in order
    of start, with a stack, finds it."""
    out = {}
    by_thread = defaultdict(list)
    for s in spans:
        by_thread[s.thread].append(s)
    for thread, mine in by_thread.items():
        mine.sort(key=lambda s: s.start_ns)
        stack, i = [], 0
        for call in sorted((c for c in calls if c.thread == thread), key=lambda c: c.start):
            while i < len(mine) and mine[i].start_ns <= call.start:
                while stack and stack[-1].end_ns <= mine[i].start_ns:
                    stack.pop()
                stack.append(mine[i])
                i += 1
            while stack and stack[-1].end_ns <= call.start:
                stack.pop()
            if stack:
                out[call.corr] = stack[-1].start_ns
    return out


def leads(pairs: list[tuple[int, int]], lo: int, hi: int) -> dict:
    """(time, lead in ns) pairs: how many, how many negative, the least lead
    in us, and the negative ones in each fifth of [lo, hi]."""
    fifths = [0] * 5
    for t, d in pairs:
        if d < 0:
            fifths[min(4, max(0, (t - lo) * 5 // max(1, hi - lo)))] += 1
    return {"n": len(pairs), "negative": sum(fifths),
            "least_us": min(d for _, d in pairs) * 1e-3 if pairs else None,
            "negative_by_fifth": fifths}


def clock_check(trace, spans, idents: dict[int, int]) -> dict:
    """For each runtime call linked to a device event: the lead of the
    event's start over the call's start (``call``), and, where the call lies
    inside a program span of its thread, over that span's start
    (``span``); and the threads the trace and the spans name."""
    from h100bench.harness import trace as tr

    first_event = {}
    for events in trace.device.values():
        for e in events:
            if e.corr and (e.corr not in first_event or e.start < first_event[e.corr]):
                first_event[e.corr] = e.start
    native = {ident & 0xFFFFFFFF: n for n, ident in idents.items()}
    calls = [tr.Interval(c.start, c.end, c.name, c.corr, native.get(c.thread & 0xFFFFFFFF))
             for c in trace.runtime if c.corr in first_event]
    opened = innermost_starts(spans, calls)
    at = {c.corr: c.start for c in calls}
    return {"call": leads([(c.start, first_event[c.corr] - c.start) for c in calls],
                          trace.start, trace.end),
            "span": leads([(at[corr], first_event[corr] - start)
                           for corr, start in opened.items()], trace.start, trace.end),
            "runtime_threads": sorted({c.thread & 0xFFFFFFFF for c in trace.runtime})[:16],
            "span_threads": {n: i & 0xFFFFFFFF for n, i in idents.items()}}


def probe() -> dict:
    """A span around 16 kernels under a device-only profile: how many of the
    kernels start after the span's start, how many launches lie inside it,
    and how many launches carry the span's thread (as CUPTI names it, the
    low 32 bits of the pthread id) and a kernel's correlation id."""
    import threading

    import torch
    from torch.profiler import ProfilerActivity, profile

    from h100bench.harness import spans as sp
    from segma_tpu_torch import telemetry

    x = torch.randn(1024, 1024, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with telemetry.span("probe"):
            for _ in range(8):
                x = torch.tanh(x @ x)
        torch.cuda.synchronize()
    span = telemetry.take().named("probe")[0]
    t = sp.linked_device_slice(prof.profiler.kineto_results.events(), [0])
    kernels = t.device[0]
    calls = [c for c in t.runtime if c.name.startswith(("cudaLaunch", "cuLaunch"))]
    ident = threading.get_ident() & 0xFFFFFFFF
    return {"probe": True, "kernels": len(kernels),
            "kernels_after_span_start": sum(k.start >= span.start_ns for k in kernels),
            "launches": len(calls),
            "launches_inside_span": sum(span.start_ns <= c.start <= span.end_ns for c in calls),
            "launches_on_span_thread": sum(c.thread & 0xFFFFFFFF == ident for c in calls),
            "kernels_linked": sum(k.corr in {c.corr for c in calls} for k in kernels)}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--modes", nargs="+", choices=("plain", "record", "trace"),
                   default=["plain", "record", "trace"])
    args = p.parse_args(argv)

    from h100bench.harness import core
    from h100bench.harness import manifest as mf
    from h100bench.harness import spans as sp
    from h100bench.reference import training as ref
    from segma_tpu_torch import telemetry

    class LinkedRun(core.Run):
        """A run whose device slice keeps the trace's links."""

        def _finish_device_slice(self, work: dict) -> None:
            self.sync()
            self._mark()
            self.sync()
            self._prof.stop()
            events = self._prof.profiler.kineto_results.events()
            self.device_trace = sp.linked_device_slice(events, self.cards)
            self.device_work = dict(work)

    core.cache_env(ROOT)
    manifest = mf.Manifest.load()
    cell = manifest.cell(args.workload)
    print(json.dumps(probe()), flush=True)
    for seed in args.seeds:
        for mode in args.modes:
            telemetry.clear()
            cls = LinkedRun if mode == "trace" else core.Run
            run = cls(cell, manifest, seed, args.seconds, mode == "trace", time.perf_counter())
            driver = mf.load_module(mf.driver_path(run.traffic["driver"]))
            if mode == "record":
                with telemetry.recording():
                    outcome = driver.run(run)
            else:
                outcome = driver.run(run)
            out = {"workload": cell.name, "seed": seed, "mode": mode,
                   "measured": outcome.measured, "setup_s": run.setup_s,
                   "correct": all(c.ok for c in outcome.checks) and outcome.failed == 0,
                   "card": core.card_line()}
            if mode == "trace":
                t = run.device_trace
                rec = telemetry.recorded(t.start, t.end)
                line = core.result_line(run, outcome, "", lambda m: None)
                idents = telemetry.threads()
                named, how = sp.idle_gaps(t, rec.spans, idents)
                by_name = defaultdict(lambda: [0, 0.0])
                for s in rec.spans:
                    by_name[s.name][0] += 1
                    by_name[s.name][1] += (s.end_ns - s.start_ns) * 1e-9
                if run.device_work.get("crops"):
                    out["train_xrt_device_slice"] = (run.device_work["crops"] * ref.CHUNK
                                                     / ref.SR / t.window_s)
                out.update(metrics=line["metrics"], window_s=t.window_s,
                           busy_s=line["device"]["busy_s"],
                           idle_gaps=line["breakdown"]["idle_gaps"],
                           idle_gaps_by_span=named, named_by=how,
                           spans={k: v for k, v in sorted(by_name.items())},
                           counters=rec.counters, clock=clock_check(t, rec.spans, idents))
            print(json.dumps(out), flush=True)
            del run, outcome
            core.release("cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
