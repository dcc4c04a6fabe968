"""One run of one cell: its configuration and traffic, the cards, the
clocks, the traced window, and the result line.

A driver (``drivers/<kind>.py``) has ``run(run: Run) -> Outcome``: it sets
the cell up, calls ``run.open_window()`` right before the first timed unit
of work and ``run.close_window()`` right after the last has completed on the
device, and then checks what the window produced against the reference.
"""

from __future__ import annotations

import contextlib
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

from h100bench.harness import manifest as mf
from h100bench.harness import trace as tr

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "segma_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (``segma_tpu_torch`` is not ``segma_tpu``)."""
    return sorted({name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN})


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
        return out.strip().splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


@dataclass
class Check:
    """One number compared with its limit: correct when value <= limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Outcome:
    """What a driver measured: ``measured`` holds the end-to-end values it
    can give by metric name."""

    measured: dict[str, float]
    attempted: int
    failed: int
    checks: list[Check]
    memory_peak_bytes: int
    notes: list[str] = field(default_factory=list)
    readings: dict = field(default_factory=dict)  # more of the comparison, for calibration


class Run:
    def __init__(self, cell: mf.Cell, manifest: mf.Manifest, seed: int, seconds: float,
                 trace: bool, t_process: float, device: str = "cuda",
                 config: dict | None = None, traffic: dict | None = None) -> None:
        self.cell, self.manifest = cell, manifest
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.t_process = t_process
        self.device = device
        self.config = config if config is not None else mf.load_yaml(manifest.config_path(cell))
        self.traffic = (traffic if traffic is not None
                        else mf.load_yaml(mf.traffic_path(cell.traffic)))
        self.cards = list(range(cell.chips)) if device == "cuda" else []
        self.t_open: float | None = None
        self.t_close: float | None = None
        # under --trace 1: the device slice (device activity alone) and the
        # operator slice (host operators and their shapes too) of the window
        self.device_trace: tr.TraceData | None = None
        self.op_trace: tr.TraceData | None = None
        self.device_work: dict = {}
        self._slice: str | None = None
        self._prof = None
        self._span = None

    # -- the program's configuration ------------------------------------------
    def program_config(self, **overrides):
        """The port's ``Config`` from the configuration file's ``program``
        section, with dotted ``overrides`` (``"train.batch_size": 32``)."""
        import copy

        from segma_tpu_torch.config import config_from_dict

        data = copy.deepcopy(self.config["program"])
        for key, value in overrides.items():
            node = data
            *parents, last = key.split(".")
            for p in parents:
                node = node.setdefault(p, {})
            node[last] = value
        return config_from_dict(data)

    # -- the window -----------------------------------------------------------
    def sync(self) -> None:
        if self.device == "cuda":
            import torch

            for c in self.cards:
                torch.cuda.synchronize(c)

    def open_window(self) -> None:
        """The first timed unit of work starts now: the set-up ends. Under
        ``--trace 1`` the device slice's profiler starts first."""
        self.sync()
        if self.trace:
            self._start("device")
        self.t_open = time.perf_counter()

    def end_device_slice(self, **work) -> None:
        """Under ``--trace 1``: the device slice ends here, with ``work`` done
        in it (``chunks``, ``crops``), and the operator slice starts. A no-op
        otherwise, so the untraced window is not touched."""
        if self._slice != "device":
            return
        self._finish_device_slice(work)
        self._start("ops")

    def close_window(self, **work) -> float:
        """The last unit of work has been enqueued: wait for the cards, stop
        the clock (and the profiler). Returns the window's seconds."""
        self.sync()
        self.t_close = time.perf_counter()
        if self._slice == "device":
            self._finish_device_slice(work)
        elif self._slice == "ops":
            self._stop_operators()
        self._slice = self._prof = None
        return self.window_s

    def trace_operators(self, work) -> None:
        """Under ``--trace 1``, after the window: ``work()`` once more, its
        host operators and their shapes traced with the device (the
        operator slice), for what is read from operators."""
        if not self.trace:
            return
        self._start("ops")
        work()
        self.sync()
        self._stop_operators()
        self._slice = self._prof = None

    def _stop_operators(self) -> None:
        self._span.__exit__(None, None, None)
        self._prof.stop()
        self.op_trace = tr.from_kineto(self._prof.profiler.kineto_results.events(),
                                       self.cards or [0])

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open

    @property
    def setup_s(self) -> float:
        return self.t_open - self.t_process

    def _mark(self) -> None:
        """A small kernel on every card: the device slice's first and last
        events."""
        import torch

        for c in self.cards:
            torch.ones(1, device=f"cuda:{c}")

    def _start(self, which: str) -> None:
        """The device slice traces device activity alone (the host's
        operators are not recorded, so the host runs at its own speed); the
        operator slice traces the host's operators too, with their input
        shapes, on every thread."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CUDA] if self.device == "cuda" else []
        kwargs = {}
        if which == "ops" or self.device != "cuda":
            activities.append(ProfilerActivity.CPU)
            kwargs["record_shapes"] = True
            with contextlib.suppress(ImportError, TypeError):
                from torch._C._profiler import _ExperimentalConfig

                kwargs["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
        self._prof = profile(activities=activities, **kwargs)
        self._prof.start()
        self._slice = which
        if which == "device":
            self._mark()
        else:
            self._span = torch.profiler.record_function(tr.WINDOW_SPAN)
            self._span.__enter__()

    def _finish_device_slice(self, work: dict) -> None:
        self.sync()
        if self.device == "cuda":
            self._mark()
            self.sync()
        self._prof.stop()
        events = self._prof.profiler.kineto_results.events()
        if self.device == "cuda":
            self.device_trace = tr.device_slice(events, self.cards)
        else:  # no device: the slice's wall, with nothing on it
            self.device_trace = tr.TraceData(0, int((time.perf_counter() - self.t_open) * 1e9),
                                             {0: []}, [], {})
        self.device_work = dict(work)

    # -- the result -----------------------------------------------------------
    def memory_peak(self) -> int:
        import torch

        if self.device != "cuda":
            return 0
        return max(int(torch.cuda.max_memory_allocated(c)) for c in self.cards)


def release(device) -> None:
    """Give back the device memory that nothing refers to any more."""
    import gc

    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def per_layer_values(run: Run, outcome: Outcome, log) -> dict[str, dict]:
    """Each per-layer metric of the cell, read by ``metrics/<name>.py``'s
    ``read(run, outcome)``; a reader that finds nothing returns None and the
    metric is left out."""
    out = {}
    for m in run.manifest.per_layer(run.cell):
        reader = mf.load_module(mf.metric_path(m.name), m.name)
        value = reader.read(run, outcome)
        if value is None:
            log(f"per-layer metric {m.name}: nothing to read in this run")
            continue
        out[m.name] = {"value": float(value), "unit": m.unit}
    return out


def result_line(run: Run, outcome: Outcome, device_kind: str, log) -> dict:
    """The run's result: the end-to-end metrics (``--trace 0``) or the
    per-layer ones (``--trace 1``), the device, and the checks, last."""
    if run.trace:
        metrics = per_layer_values(run, outcome, log)
    else:
        metrics = {}
        values = dict(outcome.measured, setup_s=run.setup_s)
        for m in run.manifest.end_to_end(run.cell):
            if m.name not in values:
                raise KeyError(f"the driver gave no {m.name!r} for {run.cell.name}")
            metrics[m.name] = {"value": float(values[m.name]), "unit": m.unit}
    device = {"platform": "gpu" if run.device == "cuda" else run.device, "kind": device_kind,
              "count": len(run.cards), "memory_peak_bytes": outcome.memory_peak_bytes}
    line = {
        "correct": all(c.ok for c in outcome.checks) and outcome.failed == 0,
        "attempted": outcome.attempted,
        "failed": outcome.failed,
        "metrics": metrics,
        "device": device,
    }
    if run.trace and run.device_trace is not None:
        busy = tr.busy_s(run.device_trace)
        device["busy_s"] = sum(busy.values()) / len(busy)
        device["window_s"] = run.device_trace.window_s
        line["breakdown"] = tr.breakdown(run.device_trace)
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in outcome.checks}
    return line


def trace_summary(name: str, t: tr.TraceData) -> str:
    """What a slice's trace held: device events per card, host operators,
    device events linked to an operator, runtime calls, kinds left out."""
    ops = {op.corr for op in t.ops}
    linked = sum(1 for ev in t.device.values() for e in ev if e.corr in ops)
    return (f"{name} slice: {t.window_s:.3f} s, device events by card "
            f"{ {c: len(ev) for c, ev in t.device.items()} }, {len(t.ops)} host operators, "
            f"{linked} device events linked to one, {len(t.runtime)} runtime calls, "
            f"left out {t.other_kinds}")


def print_checks(checks: list[Check]) -> None:
    """The compared numbers beside their limits, as the last lines of stderr."""
    for c in checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr, flush=True)


def cache_env(root: Path) -> None:
    """Every kernel and build cache inside the checkout, at fixed paths."""
    base = root / ".cache" / "h100bench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"

