"""Preemption and the train CLIs on the CPU, at the tiny HuBERT widths of
tests/test_torch_checkpoint.py (the JAX package's ``cli/train.py``,
``cli/auto_train.py`` and ``Trainer`` preemption are the reference):

- ``_handle_preempt_signal`` in the middle of an epoch and at its last
  step, with k=3 accumulation crossing the epoch boundary and the cosine
  schedule: ``fit`` returns ``interrupted``; a stop inside epoch 1 leaves
  ``last/`` at epoch 0, bit-equal to the epoch-0 checkpoint, and writes
  nothing for epoch 1; a stop at the end of epoch 0 refreshes ``last/`` at
  epoch 0 without validating; each resumed run ends on the uninterrupted
  run's trainable parameters and optimizer state bit for bit;
- ``cli.train.main([..., "--device", "cpu"])`` writes ``config.yml`` (read
  back by both packages' ``load_config``), ``metrics.jsonl`` and the
  ``models/last/best.ckpt`` link; an interrupted run raises
  ``SystemExit(75)`` and links nothing;
- ``cli.auto_train --auto-resume --run-id --output`` resumes from
  ``checkpoint.find_resumable`` of the run, or starts fresh without one.
"""

from __future__ import annotations

import json
import signal
from pathlib import Path

import numpy as np
import pytest
import torch

from segma_tpu.config import load_config as jax_load_config
from segma_tpu_torch import checkpoint as ckpt
from segma_tpu_torch.cli import auto_train
from segma_tpu_torch.cli import train as train_cli
from segma_tpu_torch.config import load_config
from tests.test_torch_checkpoint import OVERRIDES, REPO, _assert_trees_equal, _tiny_hubert
from tests.test_torch_resume import _setup
from tests.test_torch_train_accum import _fit

NAME = "surgical_hubert_hydra"
PREEMPT = ["train.grad_accum_steps=3", "train.scheduler.type=cosine",
           "train.scheduler.warmup_steps=2", "train.scheduler.min_lr_ratio=0.1"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _preempt_at(step_number: int):
    """A train-step wrapper that delivers SIGTERM's handler after global
    micro-step ``step_number`` (1-based)."""
    def wrap(trainer, step):
        def stepped(batch, generator):
            out = step(batch, generator)
            if trainer.global_step + 1 == step_number:  # counted after the call returns
                trainer._handle_preempt_signal(signal.SIGTERM, None)
            return out
        return stepped
    return wrap


@pytest.mark.parametrize("where", ["mid_epoch", "end_of_epoch"])
def test_preemption_then_resume_is_bit_exact(monkeypatch, tmp_path, where):
    cfg, ds = _setup(monkeypatch, tmp_path, PREEMPT)
    t_full, full = _fit(cfg, ds, tmp_path / "full", 2)
    n = t_full.global_step // 2  # micro-steps per epoch: 4, so mini_step 1 at epoch 0's end
    stop = n + 2 if where == "mid_epoch" else n
    t_pre, pre = _fit(cfg, ds, tmp_path / "pre", 2, wrap=_preempt_at(stop))
    assert pre["interrupted"] is True and not full["interrupted"]
    ck = tmp_path / "pre" / "checkpoints"
    last = ck / "last"
    assert ckpt.load_meta(last)["epoch"] == 0
    records = [json.loads(ln) for ln in (tmp_path / "pre" / "metrics.jsonl").read_text()
               .splitlines()]
    info = [r for r in records if "preempted_at_epoch" in r]
    assert [r["preempt_signal"] for r in records if "preempt_signal" in r] == [signal.SIGTERM]
    if where == "mid_epoch":
        assert [h["epoch"] for h in pre["history"]] == [0]
        assert info == [dict(info[0], preempted_at_epoch=1, epoch_completed=False,
                             resume_from=str(last))]
        epoch0 = next(ck.glob("epoch=00-*"))
        template = ckpt.flax_split(t_pre.model)[0]
        _assert_trees_equal(ckpt.load_params(last, template), ckpt.load_params(epoch0, template))
        assert not list(ck.glob("epoch=01-*"))
    else:
        assert pre["history"] == []  # the boundary is refreshed without validation
        assert info == [dict(info[0], preempted_at_epoch=0, epoch_completed=True,
                             resume_from=str(last))]
        assert not list(ck.glob("epoch=*"))
    tree = ckpt.msgpack_restore((last / "opt_state.msgpack").read_bytes())
    assert int(tree["mini_step"]) == n % 3  # in the middle of an accumulation
    t_res, res = _fit(cfg, ds, tmp_path / "resumed", 2, resume_from=last)
    assert [h["epoch"] for h in res["history"]] == [1] and not res["interrupted"]
    names = [k for k, p in t_full.model.module.named_parameters() if p.requires_grad]
    for k in names:
        assert torch.equal(res["params"][k], full["params"][k]), k
    _assert_trees_equal(ckpt.opt_state_tree(t_res.model, t_res.optimizer, t_res.accum),
                        ckpt.opt_state_tree(t_full.model, t_full.optimizer, t_full.accum))
    assert res["history"][0]["train/loss"] == full["history"][1]["train/loss"]
    assert res["history"][0]["lr"] == full["history"][1]["lr"]


def _cli_args(root: Path, out: Path, *extra: str) -> list[str]:
    return ["-c", str(REPO / "segma_tpu_torch/config/default.yml"), "--device", "cpu",
            *OVERRIDES[NAME], f"data.dataset_path={root}", "audio.chunk_duration_s=1.0",
            "train.batch_size=4", "train.seed=0", "train.dataloader.num_workers=1",
            "train.max_epochs=2", f"model.chkp_path={out}", *extra]


def _dataset(tmp_path: Path) -> Path:
    import chip_smoke

    root = tmp_path / "data"
    chip_smoke.write_dataset(root, chip_smoke.TRAIN_CLASSES, (2, 1, 1), 8.0)
    return root


def test_train_cli_writes_the_run_and_links_best(monkeypatch, tmp_path):
    _tiny_hubert(monkeypatch)
    root = _dataset(tmp_path)
    monkeypatch.chdir(tmp_path)
    train_cli.main(_cli_args(root, tmp_path / "models_out", "train.validation_metric=auroc",
                             "--tags", "a", "b"))
    (run_dir,) = (tmp_path / "models_out").iterdir()
    records = [json.loads(ln) for ln in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in records if "epoch" in r and "train/loss" in r] == [0, 1]
    cfg = load_config(run_dir / "config.yml")
    assert cfg.train.validation_metric == "auroc" and cfg.data.dataset_path == str(root)
    assert jax_load_config(run_dir / "config.yml").train.validation_metric == "auroc"
    link = tmp_path / "models" / "last" / "best.ckpt"
    assert link.is_symlink()
    best = Path(ckpt.resolve_checkpoint(run_dir / "checkpoints" / "best.ckpt"))
    assert link.resolve() == best.resolve()
    assert "val_auroc=" in best.name


def test_interrupted_run_exits_75_without_a_link(monkeypatch, tmp_path):
    _tiny_hubert(monkeypatch)
    root = _dataset(tmp_path)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as exit_info:
        train_cli.main(_cli_args(root, tmp_path / "out", "train.host_rss_limit_gb=0.000001"))
    assert exit_info.value.code == train_cli.EX_TEMPFAIL == 75
    assert not (tmp_path / "models" / "last").exists()


def test_auto_train_resumes_from_find_resumable(monkeypatch, tmp_path):
    _auto_resume(monkeypatch, tmp_path)


def test_auto_train_resumes_under_epoch_dispatch(monkeypatch, tmp_path):
    records = _auto_resume(monkeypatch, tmp_path, "train.dispatch=epoch",
                           "train.data_cache=device")
    assert any("device_cache_mb" in r for r in records)


def _auto_resume(monkeypatch, tmp_path, *extra: str) -> list[dict]:
    """``cli.auto_train --auto-resume``: a fresh run stopped by the watchdog
    after epoch 0 (exit 75), then resumed from ``last/`` to the end; returns
    the run's records."""
    _tiny_hubert(monkeypatch)
    root = _dataset(tmp_path)
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "runs"
    picked = []
    find = ckpt.find_resumable

    def recorded(path):
        found = find(path)
        picked.append((Path(path), found))
        return found

    monkeypatch.setattr(ckpt, "find_resumable", recorded)
    args = ["--run-id", "R", "--output", str(out), *_cli_args(root, tmp_path / "unused", *extra)]
    # a fresh run under --auto-resume, stopped by the watchdog after epoch 0
    with pytest.raises(SystemExit) as exit_info:
        auto_train.main([*args, "--auto-resume", "train.host_rss_limit_gb=0.000001"])
    assert exit_info.value.code == 75
    assert picked == [(out / "R" / "checkpoints", None)]
    auto_train.main([*args, "--auto-resume", "train.host_rss_limit_gb=0"])
    assert picked[1] == (out / "R" / "checkpoints", out / "R" / "checkpoints" / "last")
    records = [json.loads(ln) for ln in (out / "R" / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in records if "train/loss" in r] == [0, 1]
    assert not (tmp_path / "unused").exists()
    assert (tmp_path / "models" / "last" / "best.ckpt").is_symlink()
    assert np.isfinite([r["val/loss"] for r in records if "val/loss" in r]).all()
    return records
