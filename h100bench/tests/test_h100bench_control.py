"""The precision control comes out not correct: the reference in fp8 (the
nearest precision below the configurations' bf16) put in the program's
place fails at least one of its cell's limits, while the program, run in
f32 here, meets them. On the CPU at tiny widths; on the card
(``-m gpu``) at the cells' own sizes."""

import pytest
import torch

from h100bench.harness import core
from h100bench.harness import manifest as mf
from h100bench_tiny import M, cell_of, tiny_run

torch.set_num_threads(2)
ONE_CARD = [c for c in M.cells.values() if c.chips == 1]


def limits(cell) -> dict:
    return mf.load_yaml(mf.traffic_path(cell.traffic))["checks"]


def fails(readings: dict, lim: dict) -> bool:
    return any(not readings[k] <= v for k, v in lim.items() if k in readings)


@pytest.mark.parametrize("driver", ["serve_files", "train_fit"])
def test_control_fails_and_program_meets_the_limits(driver):
    cell = cell_of(driver, 1)
    run = tiny_run(cell)
    readings = mf.load_module(mf.driver_path(driver)).calibrate(run)
    lim = limits(cell)
    assert fails(readings["control"], lim), (readings, lim)
    assert not fails(readings["program"], lim), (readings, lim)


def test_fp8_control_rounds_the_backward():
    """In fp8 both products of a product's backward take fp8 operands: the
    output's gradient rounded, and the rounded operands of the forward."""
    from h100bench.reference.common import Cast, fp8_round

    gen = torch.Generator().manual_seed(3)
    x = torch.randn(5, 8, generator=gen, requires_grad=True)
    w = torch.randn(3, 8, generator=gen, requires_grad=True)
    b = torch.randn(3, generator=gen, requires_grad=True)
    g = torch.randn(5, 3, generator=gen)
    Cast("fp8").linear(x, w, b).backward(g)
    assert torch.allclose(x.grad, fp8_round(g) @ fp8_round(w.detach()))
    assert torch.allclose(w.grad, fp8_round(g).t() @ fp8_round(x.detach()))
    assert torch.allclose(b.grad, g.sum(0))
    assert torch.equal(Cast("f32").linear(x, w, b), torch.nn.functional.linear(x, w, b))


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ONE_CARD, ids=lambda c: c.name)
def test_control_fails_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import time

    lim = limits(cell)
    for seed in (31, 32, 33):
        run = core.Run(cell, M, seed, 0.0, False, time.perf_counter())
        readings = mf.load_module(mf.driver_path(run.traffic["driver"])).calibrate(run)
        assert fails(readings["control"], lim), (seed, readings, lim)
        assert not fails(readings["program"], lim), (seed, readings, lim)
