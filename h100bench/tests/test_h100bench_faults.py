"""A run with the timed path broken underneath comes out not correct: each
cell's driver, on the CPU at tiny widths, without the look for a card,
once sound and once for each fault the cell can have; the serving driver
also over four replicas (``mesh: auto`` over four CPU devices), the
default on a host of several cards, whose exchange can be left out."""

import pytest
import torch

import segma_tpu_torch.inference as inference
import segma_tpu_torch.parallel.mesh as mesh
import segma_tpu_torch.train as train
from h100bench_tiny import cell_of, drive, tiny_run

torch.set_num_threads(2)


@pytest.fixture
def four_cpu_cards(monkeypatch):
    monkeypatch.setattr(mesh, "visible_devices", lambda device: [torch.device("cpu")] * 4)


def altered_answers(monkeypatch):
    """Every interval written under the next label."""
    write = inference.write_intervals

    def shifted(intervals, *args, **kwargs):
        labels = sorted({label for _, _, label in intervals})
        nxt = {a: b for a, b in zip(labels, labels[1:] + labels[:1])}
        return write([(s, e, nxt[label]) for s, e, label in intervals], *args, **kwargs)

    monkeypatch.setattr(inference, "write_intervals", shifted)


def half_batch_left_out(monkeypatch):
    """Each inner batch's second half of rows is left out: zero logits."""
    batches = inference.InferencePipeline._batches

    def half(self, model, chunks):
        out = batches(self, model, chunks)
        h = out.shape[0] // 2
        out[h: 2 * h] = 0
        return out

    monkeypatch.setattr(inference.InferencePipeline, "_batches", half)


def exchange_left_out(monkeypatch):
    """The replicas' logits never reach the first card: zeros in their place."""
    run_members = inference.run_members

    def local_only(pool, fns, groups):
        outs = run_members(pool, fns, groups)
        return [o if k == 0 or o is None else torch.zeros_like(o) for k, o in enumerate(outs)]

    monkeypatch.setattr(inference, "run_members", local_only)


def state_unchanged(monkeypatch):
    """AdamW's step does nothing: the weights never move."""
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)


def heads_unmoved(monkeypatch):
    """AdamW moves every leaf but the heads' weight and bias (at the tiny
    widths the only leaves of four rows, one a label)."""
    step = torch.optim.AdamW.step

    def skip_heads(self, closure=None):
        heads = [p for g in self.param_groups for p in g["params"] if p.shape[0] == 4]
        before = [p.detach().clone() for p in heads]
        out = step(self, closure)
        with torch.no_grad():
            for p, old in zip(heads, before):
                p.copy_(old)
        return out

    monkeypatch.setattr(torch.optim.AdamW, "step", skip_heads)


def half_batch_mean(monkeypatch):
    """Each step's loss and gradients from the first half of its crops."""
    forward_backward = train.forward_backward

    def half(model, optimizer, wav, y, generator):
        return forward_backward(model, optimizer, wav[: len(wav) // 2], y[: len(y) // 2],
                                generator)

    monkeypatch.setattr(train, "forward_backward", half)


def test_serving_sound_run_is_correct():
    line = drive(tiny_run(cell_of("serve_files", 1)))
    assert line["correct"] and line["failed"] == 0, line["checks"]


@pytest.mark.parametrize("fault", [altered_answers, half_batch_left_out],
                         ids=lambda f: f.__name__)
def test_serving_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    line = drive(tiny_run(cell_of("serve_files", 1)))
    assert not line["correct"], line["checks"]


def test_serving_over_replicas_sound_run_is_correct(four_cpu_cards):
    line = drive(tiny_run(cell_of("serve_files", 1), mesh="auto"))
    assert line["correct"] and line["failed"] == 0, line["checks"]


@pytest.mark.parametrize("fault", [altered_answers, half_batch_left_out, exchange_left_out],
                         ids=lambda f: f.__name__)
def test_serving_over_replicas_fault_is_not_correct(monkeypatch, four_cpu_cards, fault):
    fault(monkeypatch)
    line = drive(tiny_run(cell_of("serve_files", 1), mesh="auto"))
    assert not line["correct"], line["checks"]


def test_training_sound_run_is_correct():
    line = drive(tiny_run(cell_of("train_fit", 1)))
    assert line["correct"] and line["failed"] == 0, line["checks"]


@pytest.mark.parametrize("fault", [state_unchanged, heads_unmoved, half_batch_mean],
                         ids=lambda f: f.__name__)
def test_training_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    line = drive(tiny_run(cell_of("train_fit", 1)))
    assert not line["correct"], line["checks"]


def test_training_epoch_ending_in_the_window_fails():
    """An epoch shorter than warm-up and window ends the run with an error
    rather than timing validation and the checkpoint inside the window."""
    with pytest.raises(RuntimeError, match="dataset_multiplier"):
        drive(tiny_run(cell_of("train_fit", 1), seconds=60.0, dataset_multiplier=4))
