"""Training loop: AdamW over the trainable parameters, the plateau or cosine
LR schedule, gradient accumulation, early stopping, per-epoch validation
metrics, preemption, the device audio cache and epoch dispatch
(counterpart of ``segma_tpu/train.py``), on one card or as one rank of a
data-parallel world.

The optimizer is ``torch.optim.AdamW`` with optax's ``adamw`` defaults
(betas 0.9/0.999, eps 1e-8, weight decay 1e-4, where torch's own default
decay is 1e-2), handed only the parameters outside the model's
``frozen_prefixes``: frozen parameters get no update and no decay, as under
``optax.masked``. On the card it is capturable (its step count and learning
rate are device tensors) under both dispatches, so that a step replayed from
a CUDA graph runs the kernels of an eager step. The plateau scheduler and early stopping are copies of the
JAX classes (not ``torch.optim.lr_scheduler.ReduceLROnPlateau``, whose
relative threshold counts improvements differently); a new LR is set through
the optimizer's ``param_groups``. ``scheduler.type=cosine`` sets the LR
before every micro-step from the global micro-step count (``cosine_lr``).
``train.grad_accum_steps=k`` is ``optax.MultiSteps`` (``GradAccumulation``).

Dropout masks come from a ``torch.Generator`` on the training device,
seeded from ``(train.seed, epoch)``; they cannot reproduce JAX's dropout
stream. With ``train.seed`` set, ``fit`` runs under cuDNN's deterministic
algorithms (``deterministic_cudnn``), so a seeded run repeats on the card.

``fit`` writes a checkpoint after every epoch in the JAX package's format
(``checkpoint.CheckpointManager``: top-k by the monitored metric, ``last/``,
``best.ckpt``), with the frozen parameters' fingerprint in its metadata, and
the optimizer state (optax's tree, with the accumulator) and the scheduler
and early-stopping counters in ``last/``. ``fit(dm, resume_from=<checkpoint>)``
restores all of them and goes on at the next epoch. Each epoch's batches and
dropout masks come from (seed, epoch), so a run resumed at an epoch boundary
follows the uninterrupted run's trajectory. SIGTERM (``request_preemption``)
stops the loop after the step in flight; ``fit`` then returns
``interrupted``, ``last/`` holding the newest completed epoch.

``train.data_cache=device`` (or ``auto`` within its budget): ``fit`` uploads
each subset's ``DeviceAudioCache`` once, and the steps gather their crops
from it by the batch's ``offsets`` (``WaveformSource``); the trajectory is
the host path's, bit for bit. ``train.dispatch=epoch`` (``EpochReplay``):
the epoch's offsets, labels and learning rates are stacked on the host and
uploaded in one copy each; on the card the step is captured once as a CUDA
graph and replayed for every step, on the CPU the same body runs in a plain
loop. The losses are read once per epoch.

Under a ``torch.distributed`` world (``parallel.distributed``: one process
per card) every rank runs the local step, and before AdamW the gradients are
replaced by their mean over the data group (under ``GradAccumulation``, the
accumulated mean, on the micro-step that emits), so every rank makes the
update of the global batch; the step's loss is the data group's mean. In a
data-parallel world the data group is the world: each rank takes its shard
of the files, ``batch_size / world`` crops a step, and under epoch dispatch
the all-reduce is part of the captured graph. With ``mesh.model`` or
``mesh.seq`` above 1 the world is the (data, seq, model) mesh of ranks
(``World.mesh``; JAX's ``segma_tpu/train.py`` places the parameters by the
tensor-parallel rules): each rank trains its member copy of the model
(``parallel.sharding.shard_member``: its blocks of the sharded parameters,
its seq and model groups), the ``seq * model`` ranks of a data coordinate
take the same batches and draw the same dropout masks, and the layers'
collectives carry their own backward (``parallel.collectives``), so every
member's gradient is the meshless gradient of its blocks and each
replicated parameter gets the same bits on every rank. Under epoch dispatch
the step's graph holds those collectives too, with the data group's mean
and, under ``debug_nans``, the world's finiteness vote: over NCCL, one rank
per card; gloo ranks on cards are refused there
(``parallel.mesh.check_dispatch``: a gloo collective waits for the host),
and over gloo on the CPU the epoch runs eagerly.

Validation reduces its sums (the losses, the F1 counts) and gathers its
scores (AUROC, ROC) over the data group, so every rank computes the same
metrics and takes the same plateau, early-stopping and checkpoint
decisions; rank 0 alone writes ``metrics.jsonl``, the checkpoints (the whole
trees, gathered from the model group's blocks) and the profiles. A SIGTERM
on any rank is agreed on at the next step boundary (the end of the epoch
under epoch dispatch), world-wide: every rank stops there, and rank 0
writes ``last/``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import signal
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, ContextManager

import numpy as np
import torch

from segma_tpu_torch import resolve_device, telemetry
from segma_tpu_torch.checkpoint import (
    CheckpointManager,
    flax_split,
    frozen_fingerprint,
    frozen_tree,
    load_meta,
    load_opt_state,
    load_params,
    load_train_state,
    load_trainable,
    opt_state_tree,
    resolve_checkpoint,
)
from segma_tpu_torch.config import Config
from segma_tpu_torch.data.device_cache import DeviceAudioCache
from segma_tpu_torch.data.loaders import BatchContractError
from segma_tpu_torch.models.base import (
    SegmentationModel, ieee_f32, no_tf32, weighted_index_ce,
)
from segma_tpu_torch.ops import add_launch_counts, launch_counts, set_launch_counts
from segma_tpu_torch.parallel.collectives import SOLO, DistGroup, Solo
from segma_tpu_torch.parallel.distributed import World, WorldMesh, current_world
from segma_tpu_torch.parallel.mesh import check_dispatch
from segma_tpu_torch.parallel.sharding import WHOLE, Blocks, shard_member
from segma_tpu_torch.ops.metrics import (
    binary_auroc_np,
    binary_counts,
    f1_from_counts,
    roc_curve_np,
)
from segma_tpu_torch.utils import host_mem_total_gb, host_rss_gb
from segma_tpu_torch.utils.logging import MetricsLogger

ADAMW_BETAS = (0.9, 0.999)
ADAMW_EPS = 1e-8
ADAMW_WEIGHT_DECAY = 1e-4  # optax.adamw's default
_END = object()  # the end of a loader's batches


def get_metric(metric: str) -> tuple[str, str]:
    """(mode, monitor key) for a validation metric name."""
    table = {"loss": ("min", "val/loss"), "f1_score": ("max", "val/f1_score"),
             "auroc": ("max", "val/auroc")}
    if metric not in table:
        raise ValueError(
            f"metric '{metric}' is not supported, please use 'loss', 'auroc' or 'f1_score'.")
    return table[metric]


def cosine_lr(
    step: int, base_lr: float, total_steps: int, warmup_steps: int = 0,
    min_lr_ratio: float = 0.0,
) -> float:
    """Linear warmup then cosine decay to ``min_lr_ratio * base_lr``."""
    if warmup_steps > 0 and step < warmup_steps:
        return base_lr * (step + 1) / warmup_steps
    span = max(1, total_steps - warmup_steps)
    t = min(1.0, max(0.0, (step - warmup_steps) / span))
    floor = min_lr_ratio
    return base_lr * (floor + (1.0 - floor) * 0.5 * (1.0 + math.cos(math.pi * t)))


def _f32_rate(lr: float) -> float:
    """The learning rate as the f32 scalar optax injects (and a checkpoint's
    optimizer state holds), so that a resumed run steps with the same rate."""
    return float(np.float32(lr))


def make_optimizer(model: SegmentationModel, lr: float) -> torch.optim.AdamW:
    """AdamW (optax defaults) over the trainable parameters only. On the card
    it is capturable, with its learning rate in a device tensor, so that
    replays of a captured step see each new rate; the CPU keeps a float rate."""
    params = model.trainable_parameters()
    kwargs = dict(betas=ADAMW_BETAS, eps=ADAMW_EPS, weight_decay=ADAMW_WEIGHT_DECAY)
    if params and params[0].is_cuda:
        rate = torch.tensor(_f32_rate(lr), dtype=torch.float32, device=params[0].device)
        return torch.optim.AdamW(params, lr=rate, capturable=True, foreach=True, **kwargs)
    return torch.optim.AdamW(params, lr=_f32_rate(lr), **kwargs)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):  # capturable: set in place
            group["lr"].fill_(_f32_rate(lr))
        else:
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


def deterministic_cudnn(seeded: bool) -> ContextManager:
    """For a seeded run: cuDNN's deterministic algorithms, without autotuning,
    while the context is open, the caller's flags restored on exit (cuDNN's
    default algorithms for HuBERT's positional conv backward sum in a varying
    order). The port's own kernels use no atomics. Unseeded: no change."""
    if not seeded:
        return contextlib.nullcontext()
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=False, deterministic=True,
                       allow_tf32=cudnn.allow_tf32)


def device_waveform(x: torch.Tensor) -> torch.Tensor:
    """A batch's waveforms on the device: an int16 batch (``train.transport=
    int16``, the raw PCM crop, or crops of an int16 device cache) normalised
    as ``x * 2**-15``, bit-identical to the loader's host-side ``/ 32768.0``;
    f32 batches pass through."""
    if x.dtype == torch.int16:
        return x.float() * (1.0 / 32768.0)
    return x


class WaveformSource:
    """How a batch becomes the step's waveforms: ``batch["x"]`` on the host
    path; with a placed ``cache`` (``train.data_cache=device``), the crops it
    gathers at ``batch["offsets"]``. A batch of the other mode raises
    ``BatchContractError``."""

    def __init__(self, cache: DeviceAudioCache | None = None) -> None:
        self.cache = cache

    def __call__(self, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        if self.cache is None:
            if "x" not in batch:
                raise BatchContractError(
                    "the batch carries device-cache offsets (key 'offsets') but this step has "
                    "no device cache: place the loader's device_cache into the step's source, "
                    "or set train.data_cache=host")
            return device_waveform(batch["x"])
        if "offsets" not in batch:
            raise BatchContractError(
                "the step gathers from a device cache but the batch carries host waveforms "
                "(key 'x'): use the device-cache loader's batches, or a step without a cache")
        return device_waveform(self.cache.gather(batch["offsets"]))


class GradAccumulation:
    """Gradient accumulation as ``optax.MultiSteps(opt, every_k_schedule=k)``
    with its running mean: micro-step ``mini_step`` folds its gradients into
    f32 buffers of its own as ``acc + (g - acc) / (mini_step + 1)``; the k-th
    hands the mean to AdamW, which steps with the learning rate set before
    that micro-step, and the buffers return to zero. ``mini_step`` carries
    across epochs; it, ``gradient_step`` (the updates made) and the buffers are
    saved in ``last/`` (``checkpoint.opt_state_tree``).

    The device work (``apply``) reads the count ``mini_step + 1`` from the
    device scalar ``count``, which ``step`` fills; an epoch replay copies it
    from the epoch's stacked counts. The host keeps the counters (``advance``),
    so it knows every micro-step's kind in advance. The emitting micro-step
    replaces the buffers by their mean over ``group`` (the data group of a
    world; ``SOLO``, nothing, on one process) before AdamW reads them."""

    def __init__(self, model: SegmentationModel, k: int,
                 group: DistGroup | Solo = SOLO) -> None:
        self.group = group
        named = [(n, p) for n, p in model.module.named_parameters() if p.requires_grad]
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.k = k
        self.mini_step = 0
        self.gradient_step = 0
        self.acc = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.count = torch.zeros((), dtype=torch.float32, device=self.acc[0].device)

    @property
    def emits(self) -> bool:
        """Whether the next micro-step hands the mean to AdamW."""
        return self.mini_step == self.k - 1

    def step(self, optimizer: torch.optim.Optimizer) -> bool:
        """Fold the parameters' ``.grad`` in; on the k-th micro-step, AdamW
        steps on the mean. Returns whether it stepped."""
        emit = self.emits
        self.count.fill_(float(self.mini_step + 1))
        self.apply(optimizer, emit)
        self.advance()
        return emit

    def apply(self, optimizer: torch.optim.Optimizer, emit: bool) -> None:
        """The micro-step's device work, with no host sync (capturable)."""
        for acc, p in zip(self.acc, self.params):
            if p.grad is not None:  # None: no gradient reached it, a zero one
                acc.add_(torch.div(p.grad.float() - acc, self.count))
            else:
                acc.sub_(torch.div(acc, self.count))
        if emit:
            self.group.mean_(self.acc)
            for acc, p in zip(self.acc, self.params):
                p.grad = acc.to(p.dtype)
            optimizer.step()
            optimizer.zero_grad(set_to_none=True)
            for acc in self.acc:
                acc.zero_()

    def advance(self) -> None:
        """The host's counters after a micro-step."""
        if self.emits:
            self.gradient_step += 1
        self.mini_step = (self.mini_step + 1) % self.k


def _finite_flags(loss: torch.Tensor, model: SegmentationModel, world: World | None = None
                  ) -> tuple[list[str], torch.Tensor]:
    """(names, device bools): whether the loss and each trainable gradient
    hold only finite values (on every rank of ``world``: a vote of the whole
    world, which a mesh's repeated members do not change, so that every
    rank raises or none does)."""
    named = [(n, p.grad) for n, p in model.module.named_parameters()
             if p.requires_grad and p.grad is not None]
    flags = torch.stack([torch.isfinite(loss).all()] + [torch.isfinite(g).all() for _, g in named])
    if world is not None:
        votes = flags.float()
        world.group.mean_([votes])
        flags = votes == 1.0
    return ["loss"] + [n for n, _ in named], flags


def _nonfinite(loss: torch.Tensor, model: SegmentationModel, world: World | None = None
               ) -> list[str]:
    """The names of the loss and of the trainable gradients that hold a NaN
    or an infinity, on any rank of ``world`` (one host sync)."""
    names, flags = _finite_flags(loss, model, world)
    return [name for name, ok in zip(names, flags.cpu().tolist()) if not ok]


def world_mean(group: DistGroup | Solo, model: SegmentationModel, loss: torch.Tensor,
               per_label: torch.Tensor, grads: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The step's (loss, per_label) as their means over ``group`` (the data
    group of a world); with ``grads``, also each trainable ``.grad`` in
    place. Over ``SOLO``, unchanged."""
    if group.size == 1:
        return loss, per_label
    both = torch.cat([loss.reshape(1), per_label])
    tensors = [both]
    if grads:
        tensors += [p.grad for p in model.module.parameters()
                    if p.requires_grad and p.grad is not None]
    group.mean_(tensors)
    return both[0], both[1:]


def forward_backward(
    model: SegmentationModel, optimizer: torch.optim.Optimizer, wav: torch.Tensor,
    y: torch.Tensor, generator: torch.Generator | None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gradients set to None, the forward with ``train=True``, the model's
    loss (hydra, multiclass or powerset), backward; returns the detached
    (loss, per_label). An f32 model's forward runs without TF32 (``ieee_f32``
    of its ``compute_dtype``; a bf16 model's f32 parts scope their own), and
    so does every backward: the gradients of a bf16 model's f32 parts (its
    heads, BiLSTM, WavLM's f32 scores and bias) are f32 computations too."""
    with telemetry.span("train.forward_backward"):
        optimizer.zero_grad(set_to_none=True)
        with ieee_f32(model.compute_dtype):
            logits = model.module(wav, train=True, generator=generator)
            loss, per_label = model.loss(logits, y)
        with no_tf32():
            loss.backward()
        return loss.detach(), per_label.detach()


def make_train_step(
    model: SegmentationModel, optimizer: torch.optim.Optimizer,
    accum: GradAccumulation | None = None, debug_nans: bool = False,
    source: WaveformSource | None = None, world: World | None = None,
    group: DistGroup | Solo = SOLO,
) -> Callable[[dict[str, torch.Tensor], torch.Generator | None], tuple[torch.Tensor, torch.Tensor]]:
    """One step (``train.dispatch=step``): ``forward_backward``, then AdamW, or
    ``accum``'s micro-step. The step updates the module's parameters in place
    and returns the (loss, per_label) of the batch, on the device. The batch's
    waveforms come from ``source`` (host waveforms without one).
    ``debug_nans``: raise ``FloatingPointError``, before any update, when the
    loss or a trainable gradient is not finite, on any rank of ``world``. The
    loss, and the gradients before AdamW, are their means over ``group``, the
    data group of a world (``world_mean``)."""
    source = source or WaveformSource()

    def train_step(batch: dict[str, torch.Tensor], generator: torch.Generator | None):
        loss, per_label = forward_backward(model, optimizer, source(batch), batch["y"], generator)
        loss, per_label = world_mean(group, model, loss, per_label, grads=accum is None)
        if debug_nans:
            bad = _nonfinite(loss, model, world)
            if bad:
                raise FloatingPointError(f"non-finite {', '.join(bad[:8])}"
                                         + (f" and {len(bad) - 8} more" if len(bad) > 8 else ""))
        with telemetry.span("train.optimizer"):
            if accum is None:
                optimizer.step()
            else:
                accum.step(optimizer)
        return loss, per_label

    return train_step


def eval_step(
    model: SegmentationModel, batch: dict[str, torch.Tensor], source: WaveformSource | None = None,
) -> tuple[torch.Tensor, torch.Tensor, dict[str, torch.Tensor], torch.Tensor, tuple | None]:
    """(loss, per_label, F1 counts, (N, L) per-label scores, subset stats) of
    one validation batch, without dropout; its waveforms from ``source``
    (host waveforms without one). The scores are the sigmoid of
    ``inference_transform(logits)`` (a powerset model's marginals).

    Powerset models' subset stats, for the ``partial_*`` metrics: the CE
    weighted onto the classes of fewer than two labels
    (``weighted_index_ce``), the argmax one-hot's per-class TP/FP/FN counts,
    the (N, C) subset softmax and the (N,) target class ids; None for the
    other models."""
    with torch.no_grad():
        logits = model.module((source or WaveformSource())(batch), train=False)
        y = batch["y"]
        loss, per_label = model.loss(logits, y)
        frame_logits = model.inference_transform(logits)
        probs = torch.sigmoid(frame_logits).reshape(-1, frame_logits.shape[-1])
        counts = binary_counts(probs, y.reshape(-1, y.shape[-1]))
        subset = None
        if model.powerset is not None:
            n_classes = logits.shape[-1]
            flat = logits.reshape(-1, n_classes)
            class_ids = model.subset_ids(y).reshape(-1)
            partial_loss = weighted_index_ce(flat, class_ids, model.single_class_weights(
                flat.device))
            classes = torch.arange(n_classes, device=flat.device)
            pred = flat.argmax(-1)[:, None] == classes
            target = class_ids[:, None] == classes
            subset_counts = {"tp": (pred & target).sum(0), "fp": (pred & ~target).sum(0),
                             "fn": (~pred & target).sum(0)}
            subset = (partial_loss, subset_counts, torch.softmax(flat, dim=-1), class_ids)
    return loss, per_label, counts, probs, subset


class EpochReplay:
    """``train.dispatch=epoch``: the training step over static input buffers
    (a batch's offsets and labels; the learning rate is AdamW's own device
    tensor, the accumulation count ``GradAccumulation.count``), run once per
    step of the epoch.

    On the card each kind of step (a plain or accumulation micro-step that
    updates, or one that only folds its gradients in) is captured once as a
    CUDA graph into a private memory pool, after ``WARMUP`` eager runs of
    that kind on a side stream (real steps of the epoch: they initialise
    AdamW's state, cuBLAS's workspaces and the kernel library outside the
    capture); from then on every such step is a replay. The dropout
    generator is registered with each graph, so a replay draws the masks an
    eager step would, and reseeding it reaches the replays. Under a world
    the graph holds the step's collectives (NCCL): the data group's mean of
    the loss and the gradients (``world_mean``, or ``GradAccumulation``'s
    on the step that updates), the world's finiteness vote and, for a mesh
    member, its layers' own in forward and backward; the eager warm-up of
    each kind of step has created every communicator the kind uses before
    its capture; free the graphs (the trainer) before the world
    (``distributed.destroy``). On the CPU the same body runs eagerly: the
    graph's plain version.

    A step's outputs (loss, per_label and, with ``debug_nans``, whether the
    loss and the trainable gradients are finite) are the body's tensors,
    which each replay overwrites; the caller copies them out before the next
    step."""

    WARMUP = 1

    def __init__(
        self, model: SegmentationModel, optimizer: torch.optim.Optimizer,
        accum: GradAccumulation | None, cache: DeviceAudioCache, generator: torch.Generator,
        batch_size: int, y_shape: tuple[int, ...], debug_nans: bool, world: World | None = None,
        group: DistGroup | Solo = SOLO,
    ) -> None:
        self.model, self.optimizer, self.accum, self.world = model, optimizer, accum, world
        self.group = group
        self.cache, self.generator, self.debug_nans = cache, generator, debug_nans
        device = model.device
        self.offsets = torch.zeros(batch_size, dtype=torch.int32, device=device)
        self.y = torch.zeros((batch_size, *y_shape), dtype=torch.float32, device=device)
        self.graphs: dict[bool, tuple[Any, tuple]] = {}
        self.eager_runs = {False: 0, True: 0}
        self.cuda = device.type == "cuda"
        self.side = torch.cuda.Stream(device) if self.cuda else None
        self.captured_launches: dict[bool, dict[str, int]] = {}

    def body(self, emit: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
        """One step on the static buffers, with no host sync."""
        wav = device_waveform(self.cache.gather(self.offsets))
        loss, per_label = forward_backward(self.model, self.optimizer, wav, self.y,
                                           self.generator)
        # the data group's mean, captured with the step as the layers'
        # collectives are: the eager warm-up before the capture has set the
        # communicators up
        loss, per_label = world_mean(self.group, self.model, loss, per_label,
                                     grads=self.accum is None)
        finite = (_finite_flags(loss, self.model, self.world)[1].all() if self.debug_nans
                  else None)
        with telemetry.span("train.optimizer"):
            if self.accum is None:
                self.optimizer.step()
            else:
                self.accum.apply(self.optimizer, emit)
        return loss, per_label, finite

    def run(self, emit: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
        """The step of kind ``emit`` on the current buffers."""
        if not self.cuda:
            return self.body(emit)
        if emit in self.graphs:
            graph, outs = self.graphs[emit]
            graph.replay()
            add_launch_counts(self.captured_launches[emit])
            return outs
        current = torch.cuda.current_stream(self.model.device)
        self.side.wait_stream(current)
        if self.eager_runs[emit] < self.WARMUP:
            with torch.cuda.stream(self.side):
                outs = self.body(emit)
            current.wait_stream(self.side)
            self.eager_runs[emit] += 1
            return outs
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        before = launch_counts()
        with torch.cuda.graph(graph):
            outs = self.body(emit)
        # capture records the kernels without running them, and the wrappers
        # cannot see a replay: each replay adds the captured counts, the
        # capture adds none
        after = launch_counts()
        self.captured_launches[emit] = {k: after[k] - before[k] for k in after}
        set_launch_counts(before)
        self.graphs[emit] = (graph, outs)
        graph.replay()
        add_launch_counts(self.captured_launches[emit])
        return outs


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Trainer:
    """The training loop over a datamodule's loaders. Runs on the card
    unless ``device="cpu"``. Checkpoints go to ``run_dir / "checkpoints"``;
    a model built by ``checkpoint.build_model`` (weights from ``train.seed``)
    can be served from them by ``checkpoint.load_model_for_inference``.
    Under an initialised ``torch.distributed`` world it is one rank of the
    run, and only rank 0 writes to ``run_dir``; with ``mesh.model`` or
    ``mesh.seq`` above 1 it is one member of the world's mesh, and
    ``model`` becomes its member copy (``mesh``, ``blocks``)."""

    model: SegmentationModel
    config: Config
    run_dir: Path
    max_epochs: int | None = None
    device: str | torch.device = "cuda"

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        self.run_dir = Path(self.run_dir)
        # the single writer: rank 0 makes the run's files, the other ranks
        # keep the same bookkeeping in memory
        self.world = current_world()
        self.is_main = self.world is None or self.world.is_main
        if self.is_main:
            self.run_dir.mkdir(parents=True, exist_ok=True)
        self.global_step = 0  # micro-steps taken, the cosine schedule's clock
        self.logger = MetricsLogger(self.run_dir / "metrics.jsonl" if self.is_main else None,
                                    echo=self.is_main)
        # this rank's place in the world's mesh, refused before any work
        # where its dispatch cannot run there
        self.mesh: WorldMesh | None = None
        if self.world is not None:
            self.mesh = self.world.mesh(self.config)
            check_dispatch(self.config, self.mesh.shape, self.world.backend, self.device)
        self.model.to(self.device)
        tc = self.config.train
        self.mode, self.monitor = get_metric(tc.validation_metric)
        # the whole model's counts and frozen fingerprint, before a member
        # takes its blocks (JAX's fingerprint comes before sharding too)
        trainable, frozen = self.model.split_state()
        self.n_params = {"n_params_trainable": sum(int(v.numel()) for v in trainable.values()),
                         "n_params_frozen": sum(int(v.numel()) for v in frozen.values())}
        frozen = frozen_tree(self.model)
        self.frozen_fp = frozen_fingerprint(frozen) if frozen else None
        # the data group the step reduces over (SOLO on one process), (data
        # coordinate, data size), the blocks
        self.data_group: DistGroup | Solo = SOLO
        self.coordinate = (0, 1)
        self.blocks: Blocks = WHOLE
        if self.mesh is not None:
            self.data_group = self.mesh.data
            self.coordinate = (self.mesh.coordinate[0], self.mesh.shape[0])
            if self.mesh.seq.size * self.mesh.model.size > 1:
                member = shard_member(self.model.module, self.mesh.seq, self.mesh.model)
                self.model = dataclasses.replace(self.model, module=member)
                self.blocks = Blocks(member, self.mesh.model)
        if tc.dispatch not in ("step", "epoch"):
            raise ValueError(f"train.dispatch must be 'step' or 'epoch', got {tc.dispatch!r}")
        if tc.dispatch == "epoch" and tc.data_cache == "host":
            # "auto" passes here; fit raises if it resolves to the host
            raise ValueError(
                "train.dispatch=epoch replays the step over device-resident crops: it "
                "requires train.data_cache=device (or auto within budget)")
        self.optimizer = make_optimizer(self.model, tc.lr)
        self.accum = (GradAccumulation(self.model, tc.grad_accum_steps, self.data_group)
                      if tc.grad_accum_steps > 1 else None)
        # fit places the loaders' device caches into these
        self.train_source, self.val_source = WaveformSource(), WaveformSource()
        self.train_step = make_train_step(self.model, self.optimizer, self.accum,
                                          debug_nans=tc.debug_nans, source=self.train_source,
                                          world=self.world, group=self.data_group)
        # the dropout masks' generator, reseeded from (seed, epoch) every epoch
        self.generator = torch.Generator(self.device)
        self.replay: EpochReplay | None = None
        self.scheduler = ReduceLROnPlateau(self.mode, tc.scheduler.patience)
        self.early_stopping = EarlyStopping(self.mode, patience=tc.early_stop_patience)
        self.ckpt = CheckpointManager(
            self.run_dir / "checkpoints", monitor=self.monitor, mode=self.mode,
            save_top_k=tc.save_top_k, write=self.is_main,
        )
        self._preempt_requested = False
        self._preempt_signum: int | None = None

    # -- preemption ----------------------------------------------------------------

    def request_preemption(self) -> None:
        """Ask the training loop to stop after the current step, with a
        resumable ``last/``. Called by the SIGTERM handler (a cluster sends
        SIGTERM ahead of the hard kill); safe to call from anywhere."""
        self._preempt_requested = True

    def _handle_preempt_signal(self, signum: int, _frame: Any) -> None:
        # only flags: logging from signal context could raise at the
        # interrupted bytecode; the loop logs when it sees the flag
        self._preempt_signum = int(signum)
        self.request_preemption()

    def _agree(self, flag: bool) -> bool:
        """Whether ``flag`` holds on any rank (on one process, ``flag``):
        the ranks must stop at the same step to run the same collectives."""
        if self.world is None or self.world.size == 1:
            return flag
        with telemetry.span("train.agree"):
            return self.world.any(flag)

    # -- epochs --------------------------------------------------------------------

    def _put(self, batch: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        with telemetry.span("train.put"):
            return {k: torch.from_numpy(v).to(self.device, non_blocking=True)
                    for k, v in batch.items()}

    def _train_epoch(self, loader: Any, generator: torch.Generator) -> tuple[float, bool]:
        """(mean train loss, whether every step of the epoch ran): the loop
        stops after the step in flight once preemption is requested."""
        tc = self.config.train
        every = tc.log_every_n_steps
        labels = self.model.label_encoder.base_labels
        cosine = tc.scheduler.type == "cosine"
        losses = []
        n_seen = 0
        batches = iter(loader)
        while True:
            # the iterator is explicit so that the wait for the next batch
            # is timed alone
            with telemetry.span("train.loader_wait"):
                batch = next(batches, _END)
            if batch is _END:
                break
            if cosine:
                set_learning_rate(self.optimizer, cosine_lr(
                    self.global_step, tc.lr, self._total_steps, tc.scheduler.warmup_steps,
                    tc.scheduler.min_lr_ratio))
            device_batch = self._put(batch)
            try:
                with telemetry.span("train.step", step=self.global_step + 1):
                    loss, per_label = self.train_step(device_batch, generator)
            except FloatingPointError as e:
                raise FloatingPointError(f"train step {self.global_step + 1}: {e}") from e
            losses.append(loss)
            self.global_step += 1
            if every and self.global_step % every == 0:
                with telemetry.span("train.log"):
                    record = {"step": self.global_step, "train/loss_step": float(loss)}
                    for i, label in enumerate(labels):
                        record[f"train/loss_step_{label}"] = float(per_label[i])
                self.logger.log(record)
            n_seen += 1
            if self._agree(self._preempt_requested):
                self._preempt_requested = True
                break
        # counted, not a for/else: a signal during the last step still
        # leaves a completed epoch
        mean = float(torch.stack(losses).mean()) if losses else float("nan")
        return mean, n_seen == len(loader)

    def _train_epoch_replay(self, loader: Any) -> tuple[float, bool]:
        """``train.dispatch=epoch``: the loader's batches stacked on the host,
        with each step's learning rate (cosine per step; under plateau the
        current rate) and accumulation count; each uploaded in one copy; then
        ``EpochReplay`` steps over them with no host sync, and the losses are
        read once. The whole epoch runs: a signal is honoured at its end, and
        the epoch counts as completed.

        ``debug_nans``: each step's finiteness is recorded on the device, and
        ``FloatingPointError`` names the first bad step after the epoch; the
        updates of the steps after it have run by then."""
        tc = self.config.train
        if self._agree(self._preempt_requested):  # a signal between epochs
            self._preempt_requested = True
            return float("nan"), False
        with telemetry.span("train.replay_stack"):
            offs, ys = [], []
            for batch in loader:
                if "offsets" not in batch:
                    raise BatchContractError("train.dispatch=epoch needs device-cache batches "
                                             "(key 'offsets')")
                offs.append(batch["offsets"])
                ys.append(batch["y"])
        n = len(offs)
        if n == 0:
            return float("nan"), False
        step0 = self.global_step
        if tc.scheduler.type == "cosine":
            lrs = [cosine_lr(step0 + i, tc.lr, self._total_steps, tc.scheduler.warmup_steps,
                             tc.scheduler.min_lr_ratio) for i in range(n)]
        else:
            lrs = [get_learning_rate(self.optimizer)] * n
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)  # noqa: E731
        offsets_e, y_e = put(np.stack(offs)), put(np.stack(ys))
        lrs_e = put(np.asarray(lrs, np.float32))
        accum = self.accum
        counts_e = None if accum is None else put(np.asarray(
            [(accum.mini_step + i) % accum.k + 1 for i in range(n)], np.float32))
        replay = self.replay
        if replay is None or replay.cache is not self.train_source.cache:
            replay = self.replay = EpochReplay(
                self.model, self.optimizer, accum, self.train_source.cache, self.generator,
                offsets_e.shape[1], tuple(y_e.shape[2:]), tc.debug_nans, self.world,
                self.data_group)
        lr = self.optimizer.param_groups[0]["lr"]
        losses_e = torch.empty(n, dtype=torch.float32, device=self.device)
        per_label_e = torch.empty((n, len(self.model.label_encoder.base_labels)),
                                  dtype=torch.float32, device=self.device)
        finite_e = torch.ones(n, dtype=torch.bool, device=self.device)
        for i in range(n):
            replay.offsets.copy_(offsets_e[i])
            replay.y.copy_(y_e[i])
            if isinstance(lr, torch.Tensor):
                lr.copy_(lrs_e[i])
            else:  # the CPU's float rate
                set_learning_rate(self.optimizer, lrs[i])
            if accum is not None:
                accum.count.copy_(counts_e[i])
            loss, per_label, finite = replay.run(accum is None or accum.emits)
            losses_e[i].copy_(loss)
            per_label_e[i].copy_(per_label)
            if finite is not None:
                finite_e[i].copy_(finite)
            if accum is not None:
                accum.advance()
        self.global_step = step0 + n
        if tc.debug_nans:
            bad = (~finite_e).nonzero()
            if len(bad):
                first = int(bad[0])
                raise FloatingPointError(
                    f"train step {step0 + first + 1}: non-finite loss or trainable gradient "
                    f"(epoch dispatch: the {n - first - 1} updates after it have run)")
        every = tc.log_every_n_steps
        if every:
            labels = self.model.label_encoder.base_labels
            losses_h, per_label_h = losses_e.cpu().tolist(), per_label_e.cpu().tolist()
            for i in range(n):
                if (step0 + i + 1) % every == 0:
                    record = {"step": step0 + i + 1, "train/loss_step": losses_h[i]}
                    for j, label in enumerate(labels):
                        record[f"train/loss_step_{label}"] = per_label_h[i][j]
                    self.logger.log(record)
        return float(losses_e.mean()), True

    def _need_scores(self) -> bool:
        """Whether validation gathers the per-frame scores on the host
        (auroc, roc)."""
        tc = self.config.train
        return (tc.validation_metric == "auroc" or "auroc" in tc.extra_val_metrics
                or "roc" in tc.extra_val_metrics)

    def _val_batches(self, loader: Any):
        """(device batch, host labels) of the validation pass: host batches
        are uploaded one by one; device-cache batches (offsets and labels,
        under either dispatch) are stacked and uploaded in one copy."""
        if self.val_source.cache is None:
            for batch in loader:
                yield self._put(batch), batch["y"]
            return
        batches = list(loader)
        if not batches:
            return
        stacked = self._put({k: np.stack([b[k] for b in batches]) for k in ("offsets", "y")})
        for i, batch in enumerate(batches):
            yield {k: v[i] for k, v in stacked.items()}, batch["y"]

    def _val_epoch(self, loader: Any) -> dict[str, float]:
        """The validation metrics, with no host sync between batches: the
        losses, counts and (for auroc and roc) scores are read at the end.
        A powerset model adds ``val/partial_loss`` (with ``partial_loss`` in
        ``extra_val_metrics``), ``val/partial_f1_score`` and
        ``val/partial_auroc`` (with f1_score and auroc), each averaged over
        its classes of fewer than two labels. Under a world the losses are
        the means over the data group (every rank runs as many batches of
        one size), the counts its sums, and the scores are gathered over it,
        so every rank computes the same metrics (the members of a data
        coordinate score the same batches: reduced over the world, they
        would count them ``seq * model`` times)."""
        tc = self.config.train
        labels = self.model.label_encoder.base_labels
        wants = lambda m: tc.validation_metric == m or m in tc.extra_val_metrics  # noqa: E731
        need_scores = self._need_scores()
        losses, per_labels, all_probs, all_targets = [], [], [], []
        partial_losses, subset_probs, subset_ids = [], [], []
        counts_acc: dict[str, torch.Tensor] | None = None
        subset_acc: dict[str, torch.Tensor] | None = None
        for batch, y in self._val_batches(loader):
            loss, per_label, counts, probs, subset = eval_step(self.model, batch, self.val_source)
            losses.append(loss)
            per_labels.append(per_label)
            counts_acc = (
                counts if counts_acc is None
                else {k: counts_acc[k] + counts[k] for k in counts}
            )
            if need_scores:
                all_probs.append(probs)
                all_targets.append(y.reshape(-1, len(labels)))
            if subset is not None:
                p_loss, s_counts, s_probs, s_ids = subset
                partial_losses.append(p_loss)
                subset_acc = (s_counts if subset_acc is None
                              else {k: subset_acc[k] + s_counts[k] for k in s_counts})
                if wants("auroc"):
                    subset_probs.append(s_probs)
                    subset_ids.append(s_ids)
        group = self.data_group
        metrics: dict[str, float] = {}
        if losses:
            loss, per_label = torch.stack(losses).mean(), torch.stack(per_labels).mean(0)
            group.mean_([loss, per_label])
            metrics["val/loss"] = float(loss)
            per_label = per_label.cpu()
            for i, label in enumerate(labels):
                metrics[f"val/loss_{label}"] = float(per_label[i])
        if counts_acc is not None:
            counts_acc = {k: group.sum_(v) for k, v in counts_acc.items()}
        if counts_acc is not None and wants("f1_score"):
            f1 = f1_from_counts({k: v.cpu() for k, v in counts_acc.items()})
            metrics["val/f1_score"] = float(f1.mean())
            for i, label in enumerate(labels):
                metrics[f"val/f1_{label}"] = float(f1[i])
        if need_scores and all_probs:
            probs, targets = torch.cat(all_probs), np.concatenate(all_targets)
            if group.size > 1:
                probs = group.all_gather(probs, 0)
                targets = group.all_gather(torch.from_numpy(targets).to(probs.device),
                                           0).cpu().numpy()
            probs = probs.cpu().numpy()
            if wants("auroc"):
                auroc = binary_auroc_np(probs, targets)
                metrics["val/auroc"] = float(auroc.mean())
                for i, label in enumerate(labels):
                    metrics[f"val/auroc_{label}"] = float(auroc[i])
            if "roc" in tc.extra_val_metrics and self.is_main:
                self._plot_roc(probs, targets, labels)
        if partial_losses:
            n_single = self.model.powerset.n_single_classes
            partial_loss = torch.stack(partial_losses).mean()
            group.mean_([partial_loss])
            subset_acc = {k: group.sum_(v) for k, v in subset_acc.items()}
            if "partial_loss" in tc.extra_val_metrics:
                metrics["val/partial_loss"] = float(partial_loss)
            if wants("f1_score"):
                subset_f1 = f1_from_counts({k: v.cpu() for k, v in subset_acc.items()})
                metrics["val/partial_f1_score"] = float(subset_f1[:n_single].mean())
            if subset_probs:
                s_probs, s_ids = torch.cat(subset_probs), torch.cat(subset_ids)
                s_probs, s_ids = group.all_gather(s_probs, 0), group.all_gather(s_ids, 0)
                s_probs, s_ids = s_probs.cpu().numpy(), s_ids.cpu().numpy()
                s_auroc = binary_auroc_np(s_probs, np.eye(s_probs.shape[-1])[s_ids])
                metrics["val/partial_auroc"] = float(s_auroc[:n_single].mean())
        return metrics

    def _plot_roc(self, probs: np.ndarray, targets: np.ndarray, labels: tuple[str, ...]) -> None:
        """Per-label ROC curves -> ``<run_dir>/roc_latest.png``; nothing
        without matplotlib, as in JAX."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        auroc = binary_auroc_np(probs, targets)
        fig, ax = plt.subplots(figsize=(10, 5))
        for i, label in enumerate(labels):
            fpr, tpr = roc_curve_np(probs[:, i], targets[:, i])
            ax.plot(fpr, tpr, label=f"{label} - AUC={auroc[i]:.4f}")
        ax.plot([0, 1], [0, 1], "k--", label="Random classifier: AUC=0.5")
        ax.set_xlabel("False Positive Rate")
        ax.set_ylabel("True Positive Rate")
        ax.legend(loc="lower right")
        fig.tight_layout()
        fig.savefig(self.run_dir / "roc_latest.png", dpi=120)
        plt.close(fig)

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
        (``last/``), the optimizer state with the accumulator, and the
        counters; returns the epoch to start at."""
        ckpt = resolve_checkpoint(resume_from)
        self.replay = None  # a graph captured before reads the replaced optimizer state
        load_trainable(self.model, load_params(ckpt, flax_split(self.model, self.blocks)[0]),
                       self.blocks)
        load_opt_state(ckpt, self.model, self.optimizer, self.accum, self.blocks)
        for obj, section in ((self.scheduler, "scheduler"),
                             (self.early_stopping, "early_stopping")):
            for attr, value in (load_train_state(ckpt).get(section) or {}).items():
                setattr(obj, attr, value)
        return int(load_meta(ckpt).get("epoch", -1)) + 1

    def _trees(self) -> tuple[dict, dict]:
        """The whole trainable tree and optax's tree, as every rank computes
        them (a mesh member gathers its blocks: a collective); rank 0
        writes them."""
        return (flax_split(self.model, self.blocks)[0],
                opt_state_tree(self.model, self.optimizer, self.accum, self.blocks))

    def _refresh_last(self, epoch: int, meta: dict) -> None:
        with telemetry.span("train.checkpoint", epoch=epoch):
            params, opt_state = self._trees()
            self.ckpt.refresh_last(epoch, params, meta, opt_state=opt_state,
                                   train_state=self._train_state())

    def _profiler(self) -> torch.profiler.profile:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=activities)

    def fit(self, datamodule: Any, resume_from: Path | str | None = None) -> dict[str, Any]:
        """Train up to epoch ``max_epochs`` (or ``train.max_epochs``), with
        validation every ``train.val_every_n_epochs`` epochs and at the last,
        plateau LR, a checkpoint and early stopping after each validation, and
        ``last/`` refreshed after every epoch. Writes ``metrics.jsonl`` and
        ``checkpoints/`` under ``run_dir``; with ``train.profiler`` set, a
        torch.profiler trace of the epoch after the first into
        ``run_dir/profile`` (``epoch_<n>.json``), and the program's spans
        over the same epoch beside it (``spans_epoch_<n>.jsonl``).

        Spans (``telemetry``, recorded while it records): per step
        ``train.loader_wait`` (the wait for the loader's next batch),
        ``train.put``, ``train.step`` (the host's enqueue of a step) with
        ``train.forward_backward`` and ``train.optimizer``, ``train.log``
        (the loss read on log steps), ``train.agree`` (a world's vote); per
        epoch ``train.replay_stack`` (epoch dispatch's host stacking),
        ``train.validate``, ``train.checkpoint``. A replayed CUDA graph runs
        no span.

        The loaders' device caches (``train.data_cache=device``, or ``auto``
        within budget) are uploaded once; how ``auto`` resolved is logged as
        ``data_cache_train`` and ``data_cache_val``, the train cache's size as
        ``device_cache_mb``. ``train.dispatch=epoch`` needs a train cache and
        raises, naming the resolution, without one.

        ``resume_from`` (a checkpoint dir such as ``<run>/checkpoints/last``,
        a ``best.ckpt`` link or a run dir) restores the trainable parameters,
        the AdamW moments, step and learning rate, the accumulator, and the
        counters, and starts at the epoch after the checkpoint's.

        SIGTERM (installed from the main thread, the caller's handler restored
        afterwards) stops after the step in flight: an epoch that completed
        refreshes ``last/``; a stop inside an epoch persists nothing, since
        ``last/`` holds the previous boundary. The host RSS watchdog
        (``train.host_rss_limit_gb``) stops at an epoch boundary. Both return
        ``interrupted`` True. Returns ``params`` (the module's state_dict),
        ``history`` (this call's epochs), ``interrupted``, and the manager's
        ``best_score`` and ``best_path``."""
        tc = self.config.train
        seed = tc.seed if tc.seed is not None else 0
        start_epoch = 0 if resume_from is None else self._resume(resume_from)
        self.logger.log(self.n_params)
        # metadata of every checkpoint: the config, the monitored metric and
        # the frozen tree's fingerprint, which inference checks its rebuilt
        # frozen parameters against
        meta: dict[str, Any] = {"config": dataclasses.asdict(self.config),
                                "monitor": self.monitor}
        if self.frozen_fp is not None:
            meta["frozen_fingerprint"] = self.frozen_fp
        train_loader = datamodule.train_dataloader()
        val_loader = datamodule.val_dataloader()
        t_cache = getattr(train_loader, "device_cache", None)
        v_cache = getattr(val_loader, "device_cache", None)
        for which, ldr in (("train", train_loader), ("val", val_loader)):
            note = getattr(ldr, "data_cache_decision", None)
            if note:
                self.logger.log({f"data_cache_{which}": note})
        if tc.dispatch == "epoch" and t_cache is None:
            resolved = getattr(train_loader, "data_cache_decision", None)
            raise ValueError(
                "train.dispatch=epoch requires the train loader to carry a device_cache "
                "(train.data_cache=device through SegmentationDataLoader); this loader has none"
                + (f": data_cache resolved {resolved}" if resolved else ""))
        if t_cache is not None:
            t_cache.place(self.device)
            self.logger.log({"device_cache_mb": round(t_cache.nbytes / 1e6, 1)})
        if v_cache is not None:
            v_cache.place(self.device)
        self.train_source.cache, self.val_source.cache = t_cache, v_cache
        max_epochs = self.max_epochs or tc.max_epochs
        self.global_step = start_epoch * len(train_loader)
        self._total_steps = max_epochs * len(train_loader)
        profile_epoch = start_epoch + 1 if tc.profiler else None
        rss_limit = tc.host_rss_limit_gb
        if rss_limit is None:
            rss_limit = 0.9 * host_mem_total_gb()  # 0 when /proc is absent
        installed: list[tuple[int, Any]] = []
        if threading.current_thread() is threading.main_thread():
            installed.append((signal.SIGTERM, signal.getsignal(signal.SIGTERM)))
            signal.signal(signal.SIGTERM, self._handle_preempt_signal)
        history = []
        interrupted = False
        try:
            with deterministic_cudnn(tc.seed is not None):
                for epoch in range(start_epoch, max_epochs):
                    for ldr in (train_loader, val_loader):
                        ldr.set_epoch(epoch)
                    # each data coordinate its own dropout stream (coordinate
                    # 0's is one process's): the members of a coordinate draw
                    # the same masks on their replicated activations
                    d, data = self.coordinate
                    self.generator.manual_seed((seed * 100_003 + epoch) * data + d)
                    prof = self._profiler() if epoch == profile_epoch else None
                    if prof is not None:
                        prof.start()
                        t_prof = time.time_ns()
                    t0 = time.perf_counter()
                    if tc.dispatch == "epoch":
                        train_loss, completed = self._train_epoch_replay(train_loader)
                    else:
                        train_loss, completed = self._train_epoch(train_loader, self.generator)
                    _sync(self.device)
                    train_time = time.perf_counter() - t0
                    if prof is not None:
                        prof.stop()
                        spans = telemetry.take(t_prof).spans
                        if self.is_main:
                            profile_dir = self.run_dir / "profile"
                            profile_dir.mkdir(parents=True, exist_ok=True)
                            prof.export_chrome_trace(str(profile_dir / f"epoch_{epoch}.json"))
                            telemetry.write_spans(spans,
                                                  profile_dir / f"spans_epoch_{epoch}.jsonl")
                            self.logger.log({"profile_dir": str(profile_dir)})
                    if self._agree(self._preempt_requested):
                        self._preempt_requested = True
                        if self._preempt_signum is not None:
                            self.logger.log({"preempt_signal": self._preempt_signum})
                        if completed:  # the boundary, without validation
                            self._refresh_last(epoch, meta)
                        last = self.ckpt.last_path
                        self.logger.log({
                            "preempted_at_epoch": epoch, "epoch_completed": completed,
                            "resume_from": (str(last) if (last / "params.msgpack").exists()
                                            else "fresh"),
                        })
                        interrupted = True
                        break
                    do_val = ((epoch + 1) % max(1, tc.val_every_n_epochs) == 0
                              or epoch == max_epochs - 1)
                    with telemetry.span("train.validate", epoch=epoch):
                        metrics = self._val_epoch(val_loader) if do_val else {}
                    metrics["train/loss"] = train_loss
                    metrics["lr"] = get_learning_rate(self.optimizer)
                    metrics["epoch"] = epoch
                    metrics["train_time_s"] = train_time
                    metrics["time_s"] = time.perf_counter() - t0
                    metrics["samples_per_s"] = round(
                        len(train_loader) * tc.batch_size / train_time, 2)
                    self.logger.log(metrics)
                    history.append(metrics)
                    if not do_val:
                        self._refresh_last(epoch, meta)
                    else:
                        monitored = metrics.get(self.monitor)
                        if monitored is None:
                            raise ValueError(
                                f"monitored metric {self.monitor!r} missing from val metrics")
                        if tc.scheduler.type == "plateau" and self.scheduler.step(monitored):
                            set_learning_rate(self.optimizer, tc.lr * self.scheduler.scale)
                        stop = self.early_stopping.step(monitored)
                        with telemetry.span("train.checkpoint", epoch=epoch):
                            params, opt_state = self._trees()
                            self.ckpt.step(epoch, monitored, params, meta, opt_state=opt_state,
                                           train_state=self._train_state())
                        if stop:
                            self.logger.log({"early_stop": epoch})
                            break
                    rss = host_rss_gb() if rss_limit else 0.0
                    if self._agree(bool(rss_limit) and rss > rss_limit):
                        # last/ was just written: the resume is exact
                        self.logger.log({"recycle_at_epoch": epoch, "host_rss_gb": round(rss, 2),
                                         "host_rss_limit_gb": round(rss_limit, 2)})
                        interrupted = True
                        break
        finally:
            for sig, prev in installed:
                signal.signal(sig, prev)
        best = self.ckpt.best_path
        return {"params": self.model.module.state_dict(), "history": history,
                "interrupted": interrupted, "best_score": self.ckpt.best_score,
                "best_path": None if best is None else str(best)}
