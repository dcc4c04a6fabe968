"""BENCHMARK.json against the benchmark's contract, and every name in it
resolving to its files."""

import json
import re

import pytest

from h100bench.harness import manifest as mf

M = mf.Manifest.load()
DATA = json.loads(mf.MANIFEST.read_text())
TEXT_RE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(DATA) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert DATA["paths"] == ["h100bench"]
    assert DATA["command"][1].startswith("h100bench/")
    assert 1 <= DATA["run_seconds"] <= 51
    assert len(mf.MANIFEST.read_bytes()) <= 64 * 1024


def test_names_units_and_text():
    names = [c["name"] for c in DATA["configs"]] + [w["name"] for w in DATA["workloads"]]
    names += [m["name"] for m in DATA["end_to_end"] + DATA["per_layer"]]
    names += [w["traffic"] for w in DATA["workloads"]]
    names += [k for c in DATA["configs"] for k in c["reduced"]]
    for name in names:
        assert mf.NAME_RE.match(name), name
    metric_names = [m["name"] for m in DATA["end_to_end"] + DATA["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for m in DATA["end_to_end"] + DATA["per_layer"]:
        assert mf.UNIT_RE.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    texts = [w["why"] for w in DATA["workloads"]] + [c["why"] for c in DATA["configs"]]
    texts += [c["source"] for c in DATA["configs"]] + [m["layer"] for m in DATA["per_layer"]]
    texts += DATA["command"]
    for t in texts:
        assert TEXT_RE.match(t), t


def test_entry_keys():
    for c in DATA["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in DATA["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in DATA["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in DATA["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert any(m["name"] == "setup_s" for m in DATA["end_to_end"])


@pytest.mark.parametrize("cell", list(M.cells))
def test_cell_resolves_its_files(cell):
    c = M.cell(cell)
    assert M.config_path(c).is_file()
    config = mf.load_yaml(M.config_path(c))
    assert {"source", "reduced", "family", "program", "encoder"} <= set(config)
    assert callable(mf.family_module(config).build) and callable(mf.family_module(config).flops)
    assert callable(mf.reference_module(config).model)
    traffic = mf.load_yaml(mf.traffic_path(c.traffic))
    assert mf.driver_path(traffic["driver"]).is_file()
    driver = mf.load_module(mf.driver_path(traffic["driver"]))
    assert callable(driver.run) and callable(driver.calibrate)
    for m in M.per_layer(c):
        reader = mf.load_module(mf.metric_path(m.name), m.name)
        assert callable(reader.read)
    e2e = M.end_to_end(c)
    assert "setup_s" in {m.name for m in e2e} and len(e2e) >= 2
    assert M.per_layer(c)


def test_each_metric_moves_what_its_cells_report():
    for m in M.metrics.values():
        if m.kind != "per_layer":
            continue
        assert M.metrics[m.moves].kind == "end_to_end"
        cells = m.workloads or list(M.cells)
        for cell in cells:
            assert m.moves in {e.name for e in M.end_to_end(M.cell(cell))}, (m.name, cell)


def test_every_config_is_used_and_files_are_distinct():
    used = {w["config"] for w in DATA["workloads"]}
    assert used == {c["name"] for c in DATA["configs"]}
    files = [c["file"] for c in DATA["configs"]]
    assert len(set(files)) == len(files)
    pairs = [(w["config"], w["traffic"]) for w in DATA["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in DATA["workloads"])
    assert four <= max(1, len(DATA["workloads"]) // 4)


def test_no_harness_file_names_a_cell():
    cells = list(M.cells)
    for path in mf.BENCH_DIR.rglob("*.py"):
        if "tests" in path.parts:
            continue
        text = path.read_text()
        for cell in cells:
            assert cell not in text, (path, cell)
