"""Training loop: AdamW over the trainable parameters, plateau LR schedule,
early stopping, per-epoch validation metrics (counterpart of
``segma_tpu/train.py`` on its ``dispatch=step``, host-data, one-device path).

The optimizer is ``torch.optim.AdamW`` with optax's ``adamw`` defaults
(betas 0.9/0.999, eps 1e-8, weight decay 1e-4, where torch's own default
decay is 1e-2), handed only the parameters outside the model's
``frozen_prefixes``: frozen parameters get no update and no decay, as under
``optax.masked``. The plateau scheduler and early stopping are copies of the
JAX classes (not ``torch.optim.lr_scheduler.ReduceLROnPlateau``, whose
relative threshold counts improvements differently); a new LR is set through
the optimizer's ``param_groups``.

Dropout masks come from a ``torch.Generator`` on the training device,
seeded from ``(train.seed, epoch)``; they cannot reproduce JAX's dropout
stream.

``fit`` writes a checkpoint after every epoch in the JAX package's format
(``checkpoint.CheckpointManager``: top-k by the monitored metric, ``last/``,
``best.ckpt``), with the frozen parameters' fingerprint in its metadata, and
the optimizer state (optax's tree) and the scheduler and early-stopping
counters in ``last/``. ``fit(dm, resume_from=<checkpoint>)`` restores all of
them and goes on at the next epoch. Each epoch's batches and dropout masks
come from (seed, epoch), so a run resumed at an epoch boundary follows the
uninterrupted run's trajectory.

Not ported yet: epoch dispatch and the device audio cache, gradient
accumulation, the cosine schedule, int16 transport, remat, AUROC metrics,
preemption and multi-process training.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from segma_tpu_torch import resolve_device
from segma_tpu_torch.checkpoint import (
    CheckpointManager,
    flax_split,
    frozen_fingerprint,
    load_meta,
    load_opt_state,
    load_params,
    load_train_state,
    load_trainable,
    opt_state_tree,
    resolve_checkpoint,
)
from segma_tpu_torch.config import Config
from segma_tpu_torch.models.base import SegmentationModel, ieee_f32
from segma_tpu_torch.ops.metrics import binary_counts, f1_from_counts
from segma_tpu_torch.utils.logging import MetricsLogger

ADAMW_BETAS = (0.9, 0.999)
ADAMW_EPS = 1e-8
ADAMW_WEIGHT_DECAY = 1e-4  # optax.adamw's default


def get_metric(metric: str) -> tuple[str, str]:
    """(mode, monitor key) for a validation metric name."""
    table = {"loss": ("min", "val/loss"), "f1_score": ("max", "val/f1_score")}
    if metric not in table:
        raise ValueError(f"metric '{metric}' is not supported, please use 'loss' or 'f1_score'.")
    return table[metric]


def _f32_rate(lr: float) -> float:
    """The learning rate as the f32 scalar optax injects (and a checkpoint's
    optimizer state holds), so that a resumed run steps with the same rate."""
    return float(np.float32(lr))


def make_optimizer(model: SegmentationModel, lr: float) -> torch.optim.AdamW:
    """AdamW (optax defaults) over the trainable parameters only."""
    return torch.optim.AdamW(
        model.trainable_parameters(), lr=_f32_rate(lr), betas=ADAMW_BETAS, eps=ADAMW_EPS,
        weight_decay=ADAMW_WEIGHT_DECAY,
    )


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = _f32_rate(lr)


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


class ReduceLROnPlateau:
    """Host-side plateau scheduler: ``factor`` scale after ``patience``
    epochs without improvement (a copy of the JAX class)."""

    def __init__(self, mode: str, patience: int, factor: float = 0.1) -> None:
        self.mode = mode
        self.patience = patience
        self.factor = factor
        self.best: float | None = None
        self.bad_epochs = 0
        self.scale = 1.0

    def step(self, value: float) -> bool:
        """Returns True when the LR was just reduced."""
        improved = (
            self.best is None
            or (self.mode == "min" and value < self.best)
            or (self.mode == "max" and value > self.best)
        )
        if improved:
            self.best = value
            self.bad_epochs = 0
            return False
        self.bad_epochs += 1
        if self.bad_epochs > self.patience:
            self.scale *= self.factor
            self.bad_epochs = 0
            return True
        return False


class EarlyStopping:
    """Stop after ``patience`` epochs without improvement (a copy of the JAX
    class)."""

    def __init__(self, mode: str, patience: int = 10, min_delta: float = 0.0):
        self.mode = mode
        self.patience = patience
        self.min_delta = min_delta
        self.best: float | None = None
        self.bad_epochs = 0

    def step(self, value: float) -> bool:
        """Returns True when training should stop."""
        improved = self.best is None or (
            value < self.best - self.min_delta
            if self.mode == "min"
            else value > self.best + self.min_delta
        )
        if improved:
            self.best = value
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
        return self.bad_epochs >= self.patience


def make_train_step(
    model: SegmentationModel, optimizer: torch.optim.Optimizer
) -> Callable[[dict[str, torch.Tensor], torch.Generator | None], tuple[torch.Tensor, torch.Tensor]]:
    """One step: forward with ``train=True``, the model's loss (hydra or
    multiclass), backward, AdamW. The step updates the module's parameters in place and returns the
    (loss, per_label) of the batch, on the device. An f32 model's step runs
    without TF32 in cuDNN, its backward included (``ieee_f32``)."""

    def train_step(batch: dict[str, torch.Tensor], generator: torch.Generator | None):
        optimizer.zero_grad(set_to_none=True)
        with ieee_f32(model.compute_dtype):
            logits = model.module(batch["x"], train=True, generator=generator)
            loss, per_label = model.loss(logits, batch["y"])
            loss.backward()
        optimizer.step()
        return loss.detach(), per_label.detach()

    return train_step


def eval_step(
    model: SegmentationModel, batch: dict[str, torch.Tensor]
) -> tuple[torch.Tensor, torch.Tensor, dict[str, torch.Tensor]]:
    """(loss, per_label, F1 counts) of one validation batch, without dropout."""
    with torch.no_grad():
        logits = model.module(batch["x"], train=False)
        loss, per_label = model.loss(logits, batch["y"])
        probs = torch.sigmoid(logits).reshape(-1, logits.shape[-1])
        counts = binary_counts(probs, batch["y"].reshape(-1, logits.shape[-1]))
    return loss, per_label, counts


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Trainer:
    """The training loop over a datamodule's loaders. Runs on the card
    unless ``device="cpu"``. Checkpoints go to ``run_dir / "checkpoints"``;
    a model built by ``checkpoint.build_model`` (weights from ``train.seed``)
    can be served from them by ``checkpoint.load_model_for_inference``."""

    model: SegmentationModel
    config: Config
    run_dir: Path
    max_epochs: int | None = None
    device: str | torch.device = "cuda"

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        self.run_dir = Path(self.run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.global_step = 0
        self.logger = MetricsLogger(self.run_dir / "metrics.jsonl")
        self.model.to(self.device)
        tc = self.config.train
        self.mode, self.monitor = get_metric(tc.validation_metric)
        self.optimizer = make_optimizer(self.model, tc.lr)
        self.train_step = make_train_step(self.model, self.optimizer)
        self.scheduler = ReduceLROnPlateau(self.mode, tc.scheduler.patience)
        self.early_stopping = EarlyStopping(self.mode, patience=tc.early_stop_patience)
        self.ckpt = CheckpointManager(
            self.run_dir / "checkpoints", monitor=self.monitor, mode=self.mode,
            save_top_k=tc.save_top_k,
        )

    def _put(self, batch: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device, non_blocking=True) for k, v in batch.items()}

    def _train_epoch(self, loader: Any, generator: torch.Generator) -> float:
        every = self.config.train.log_every_n_steps
        labels = self.model.label_encoder.base_labels
        losses = []
        for batch in loader:
            loss, per_label = self.train_step(self._put(batch), generator)
            losses.append(loss)
            self.global_step += 1
            if every and self.global_step % every == 0:
                record = {"step": self.global_step, "train/loss_step": float(loss)}
                for i, label in enumerate(labels):
                    record[f"train/loss_step_{label}"] = float(per_label[i])
                self.logger.log(record)
        return float(torch.stack(losses).mean()) if losses else float("nan")

    def _val_epoch(self, loader: Any) -> dict[str, float]:
        tc = self.config.train
        labels = self.model.label_encoder.base_labels
        losses, per_labels = [], []
        counts_acc: dict[str, torch.Tensor] | None = None
        for batch in loader:
            loss, per_label, counts = eval_step(self.model, self._put(batch))
            losses.append(loss)
            per_labels.append(per_label)
            counts_acc = (
                counts if counts_acc is None
                else {k: counts_acc[k] + counts[k] for k in counts}
            )
        metrics: dict[str, float] = {}
        if losses:
            metrics["val/loss"] = float(torch.stack(losses).mean())
            per_label = torch.stack(per_labels).mean(0).cpu()
            for i, label in enumerate(labels):
                metrics[f"val/loss_{label}"] = float(per_label[i])
        if counts_acc is not None and (
            tc.validation_metric == "f1_score" or "f1_score" in tc.extra_val_metrics
        ):
            f1 = f1_from_counts({k: v.cpu() for k, v in counts_acc.items()})
            metrics["val/f1_score"] = float(f1.mean())
            for i, label in enumerate(labels):
                metrics[f"val/f1_{label}"] = float(f1[i])
        return metrics

    def _train_state(self) -> dict:
        """The scheduler and early-stopping counters, as JAX writes them."""
        return {
            "scheduler": {"best": self.scheduler.best, "bad_epochs": self.scheduler.bad_epochs,
                          "scale": self.scheduler.scale},
            "early_stopping": {"best": self.early_stopping.best,
                               "bad_epochs": self.early_stopping.bad_epochs},
        }

    def _resume(self, resume_from: Path | str) -> int:
        """Restore a checkpoint's trainable parameters and, where it has them
        (``last/``), the optimizer state and the counters; returns the epoch
        to start at."""
        ckpt = resolve_checkpoint(resume_from)
        load_trainable(self.model, load_params(ckpt, flax_split(self.model)[0]))
        load_opt_state(ckpt, self.model, self.optimizer)
        for obj, section in ((self.scheduler, "scheduler"),
                             (self.early_stopping, "early_stopping")):
            for attr, value in (load_train_state(ckpt).get(section) or {}).items():
                setattr(obj, attr, value)
        return int(load_meta(ckpt).get("epoch", -1)) + 1

    def fit(self, datamodule: Any, resume_from: Path | str | None = None) -> dict[str, Any]:
        """Train up to epoch ``max_epochs`` (or ``train.max_epochs``), with
        validation, plateau LR, a checkpoint and early stopping after each.
        Writes ``metrics.jsonl`` and ``checkpoints/`` under ``run_dir``.

        ``resume_from`` (a checkpoint dir such as ``<run>/checkpoints/last``,
        a ``best.ckpt`` link or a run dir) restores the trainable parameters,
        the AdamW moments, step and learning rate, and the counters, and
        starts at the epoch after the checkpoint's. Returns ``params`` (the
        module's state_dict), ``history`` (this call's epochs), and the
        manager's ``best_score`` and ``best_path``."""
        tc = self.config.train
        seed = tc.seed if tc.seed is not None else 0
        start_epoch = 0 if resume_from is None else self._resume(resume_from)
        trainable, frozen = self.model.split_state()
        self.logger.log({
            "n_params_trainable": sum(int(v.numel()) for v in trainable.values()),
            "n_params_frozen": sum(int(v.numel()) for v in frozen.values()),
        })
        # metadata of every checkpoint: the config, the monitored metric and
        # the frozen tree's fingerprint, which inference checks its rebuilt
        # frozen parameters against
        meta: dict[str, Any] = {"config": dataclasses.asdict(self.config),
                                "monitor": self.monitor}
        frozen_tree = flax_split(self.model)[1]
        if frozen_tree:
            meta["frozen_fingerprint"] = frozen_fingerprint(frozen_tree)
        train_loader = datamodule.train_dataloader()
        val_loader = datamodule.val_dataloader()
        max_epochs = self.max_epochs or tc.max_epochs
        self.global_step = start_epoch * len(train_loader)
        history = []
        for epoch in range(start_epoch, max_epochs):
            for ldr in (train_loader, val_loader):
                ldr.set_epoch(epoch)
            generator = torch.Generator(self.device).manual_seed(seed * 100_003 + epoch)
            t0 = time.perf_counter()
            train_loss = self._train_epoch(train_loader, generator)
            _sync(self.device)
            train_time = time.perf_counter() - t0
            metrics = self._val_epoch(val_loader)
            metrics["train/loss"] = train_loss
            metrics["lr"] = get_learning_rate(self.optimizer)
            metrics["epoch"] = epoch
            metrics["train_time_s"] = train_time
            metrics["time_s"] = time.perf_counter() - t0
            metrics["samples_per_s"] = round(len(train_loader) * tc.batch_size / train_time, 2)
            self.logger.log(metrics)
            history.append(metrics)

            monitored = metrics.get(self.monitor)
            if monitored is None:
                raise ValueError(f"monitored metric {self.monitor!r} missing from val metrics")
            if self.scheduler.step(monitored):
                set_learning_rate(self.optimizer, tc.lr * self.scheduler.scale)
            stop = self.early_stopping.step(monitored)
            self.ckpt.step(epoch, monitored, flax_split(self.model)[0], meta,
                           opt_state=opt_state_tree(self.model, self.optimizer),
                           train_state=self._train_state())
            if stop:
                self.logger.log({"early_stop": epoch})
                break
        best = self.ckpt.best_path
        return {"params": self.model.module.state_dict(), "history": history,
                "best_score": self.ckpt.best_score,
                "best_path": None if best is None else str(best)}
