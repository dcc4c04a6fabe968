"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The configuration is ``configs/<config>.yml``, which names its model
family: the port's model built at its widths and the count of its
operations, ``models/<family>.py``, and its plain reference,
``reference/<family>.py``. The traffic mix is ``traffic/<traffic>.yml``,
which names its driver, ``drivers/<driver>.py``. A per-layer metric is read
by ``metrics/<name>.py``, or where there is no such file by the reader of
its measurement, ``metrics/<the name up to its first dot>.py``
(``device_idle.serve`` and ``device_idle.train`` by ``device_idle.py``).
Nothing here names a cell, a configuration, a traffic mix or a metric:
adding one is adding files and entries.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

import yaml

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
MANIFEST = ROOT / "BENCHMARK.json"

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    better: str
    source: str
    kind: str  # "end_to_end" or "per_layer"
    bound: float | None = None
    layer: str | None = None
    moves: str | None = None
    workloads: tuple[str, ...] | None = None  # None: every cell that reports what it needs


@dataclass(frozen=True)
class Cell:
    name: str
    config: str
    traffic: str
    chips: int
    why: str


class Manifest:
    """The parsed manifest, with lookups by name."""

    def __init__(self, data: dict) -> None:
        self.data = data
        self.command = data["command"]
        self.run_seconds = int(data["run_seconds"])
        self.configs = {c["name"]: c for c in data["configs"]}
        self.cells = {w["name"]: Cell(w["name"], w["config"], w["traffic"], int(w["chips"]),
                                      w["why"]) for w in data["workloads"]}
        self.metrics: dict[str, Metric] = {}
        for kind in ("end_to_end", "per_layer"):
            for m in data[kind]:
                wl = m.get("workloads")
                self.metrics[m["name"]] = Metric(
                    m["name"], m["unit"], m["better"], m["source"], kind, m.get("bound"),
                    m.get("layer"), m.get("moves"), None if wl is None else tuple(wl))

    @classmethod
    def load(cls, path: Path = MANIFEST) -> "Manifest":
        return cls(json.loads(Path(path).read_text()))

    def cell(self, name: str) -> Cell:
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in {MANIFEST.name}; it has "
                           f"{', '.join(self.cells)}")
        return self.cells[name]

    def end_to_end(self, cell: Cell) -> list[Metric]:
        """The end-to-end metrics ``cell`` reports: those without a
        ``workloads`` list, and those whose list names it."""
        return [m for m in self.metrics.values() if m.kind == "end_to_end"
                and (m.workloads is None or cell.name in m.workloads)]

    def per_layer(self, cell: Cell) -> list[Metric]:
        """The per-layer metrics ``cell`` reports: those whose ``workloads``
        name it; without the list, those whose ``moves`` the cell reports."""
        e2e = {m.name for m in self.end_to_end(cell)}
        return [m for m in self.metrics.values() if m.kind == "per_layer"
                and (cell.name in m.workloads if m.workloads is not None else m.moves in e2e)]

    def config_path(self, cell: Cell) -> Path:
        return ROOT / self.configs[cell.config]["file"]


def load_yaml(path: Path) -> dict:
    with Path(path).open() as f:
        return yaml.safe_load(f)


def traffic_path(name: str) -> Path:
    return BENCH_DIR / "traffic" / f"{name}.yml"


def driver_path(name: str) -> Path:
    return BENCH_DIR / "drivers" / f"{name}.py"


def metric_path(name: str) -> Path:
    own = BENCH_DIR / "metrics" / f"{name}.py"
    return own if own.is_file() else BENCH_DIR / "metrics" / f"{name.split('.')[0]}.py"


def family_module(config: dict) -> ModuleType:
    """``models/<family>.py`` of a configuration: ``build(run, cfg, device)``
    and ``flops(config, work)``."""
    return importlib.import_module(f"h100bench.models.{config['family']}")


def reference_module(config: dict) -> ModuleType:
    """``reference/<family>.py`` of a configuration: its plain reference."""
    return importlib.import_module(f"h100bench.reference.{config['family']}")


def load_module(path: Path, name: str | None = None) -> ModuleType:
    """A module of the harness by its file (a metric's name may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} does not exist")
    mod_name = "h100bench_" + re.sub(r"\W", "_", name or path.stem)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
