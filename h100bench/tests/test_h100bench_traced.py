"""A ``--trace 1`` run end to end on the CPU at tiny widths: the device and
operator slices are taken, the cell's per-layer readers run, and the line
carries the traced window and the breakdown. (Device numbers come from the
card only; here the slices hold no device work.)"""

import pytest
import torch

from h100bench_tiny import M, cell_of, drive, tiny_run

torch.set_num_threads(2)


@pytest.mark.parametrize("driver", ["serve_files", "train_fit"])
def test_traced_run_reads_its_metrics(driver):
    cell = cell_of(driver, 1)
    run = tiny_run(cell, seconds=1.0, trace=True)
    line = drive(run)
    assert line["correct"], line["checks"]
    assert run.device_trace is not None and run.op_trace is not None
    assert run.op_trace.ops, "the operator slice recorded no host operator"
    assert set(line["metrics"]) <= {m.name for m in M.per_layer(cell)}
    assert {m.unit for m in M.per_layer(cell) if m.name in line["metrics"]} == {"%"}
    assert line["device"]["window_s"] > 0 and "busy_s" in line["device"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(line)[-1] == "checks"
