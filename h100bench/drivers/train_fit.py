"""Driver ``train_fit``: training through ``segma_tpu_torch.train.Trainer.fit``
over a ``SegmentationDataLoader``, as the train CLI runs it.

Set-up: a labelled corpus written from the seed; the model with seeded
weights (``models/<family>.py`` of the configuration); one ``Trainer`` and
its loaders; ``fit`` started, whose first
steps (through the trainer's own step and feed) warm the cell up; the
first ``compared_steps`` of them are the steps held to the reference: each
step's loss, the first gradient (AdamW's first moment after step 1, over
1 - beta1) and the weights after the last compared step. Window: the steps
after ``warmup_steps``, until ``--seconds`` have passed on the host's clock;
then ``Trainer.request_preemption()`` stops the loop after the step in
flight, inside the first epoch, so no validation or checkpoint falls in it.
The epoch is sized to outlast warm-up and window at several times today's
step rate; should it end first all the same, the window closes with its
last step, before validation, and the run fails: a window cut short by the
epoch is no measurement of ``--seconds``. Its metric: the crops' audio seconds of every step completed in the
window over the window's wall seconds. Under ``--trace 1`` the first two
thirds of ``--seconds`` are the device slice, and OP_SLICE_STEPS more steps
the operator slice.

Traffic keys: ``train_files`` and ``train_file_s``, ``val_files`` and
``val_file_s``, ``events_per_minute``, ``batch_size``, ``dispatch``,
``data_cache``, ``dataset_multiplier``, ``warmup_steps``,
``compared_steps``, ``checks`` (limits of ``grad_gap``, ``update_gap``,
``update_gap_worst``).
"""

from __future__ import annotations

import math
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from h100bench.harness import manifest as mf
from h100bench.harness.core import Check, Outcome, Run, release
from h100bench.reference import training as ref
from h100bench.traffic.wavgen import write_dataset

# leaves whose reference gradient is below this share of the median leaf's
# move under AdamW by rounding alone (a key's bias under softmax): they are
# left out of the weights' change
ZERO_GRAD_SHARE = 1e-3
OP_SLICE_STEPS = 8  # steps traced with their host operators, under --trace 1


def epoch_steps(tr: dict) -> int:
    """The loader's steps an epoch: dataset_multiplier x the crops the split
    holds (at least a batch), in whole batches."""
    crops = max(math.ceil(tr["train_files"] * tr["train_file_s"] * ref.SR / ref.CHUNK),
                tr["batch_size"])
    return int(tr["dataset_multiplier"] * crops) // tr["batch_size"]


class StepWatch:
    """Wraps the trainer's step: keeps the compared steps' readings, opens
    the window after the warm-up steps and closes it (and asks the trainer
    to stop) once ``seconds`` have passed."""

    def __init__(self, run: Run, trainer, names: dict, compared: int, warmup: int,
                 batch: int, last: int) -> None:
        self.run, self.trainer, self.names, self.batch = run, trainer, names, batch
        self.compared, self.warmup, self.last = compared, warmup, last
        self.step = trainer.train_step
        self.n = 0
        self.losses: list[torch.Tensor] = []
        self.window_losses: list[torch.Tensor] = []
        self.first_moment: dict[str, torch.Tensor] = {}
        self.after: dict[str, torch.Tensor] = {}
        self.window_steps = 0
        self.op_steps: int | None = None
        self.closed = False
        self.cut_short = False  # the epoch's last step came before --seconds

    def __call__(self, batch, generator):
        if self.n == self.warmup:
            self.run.open_window()
        loss, per_label = self.step(batch, generator)
        self.n += 1
        opt = self.trainer.optimizer
        if self.n <= self.compared:
            self.losses.append(loss.detach().clone())
        if self.n == 1:
            # an optimizer that kept no state moved nothing: a zero moment
            self.first_moment = {
                self.names[p]: opt.state[p].get("exp_avg", torch.zeros_like(p)).detach().clone()
                for p in self.names}
        if self.n == self.compared:
            self.after = {self.names[p]: p.detach().clone() for p in self.names}
        if self.n > self.warmup and not self.closed:
            self.window_steps += 1
            self.window_losses.append(loss.detach())
            elapsed = time.perf_counter() - self.run.t_open
            if self.run.trace:
                # the device slice: two thirds of --seconds; then the
                # operator slice: OP_SLICE_STEPS steps
                if self.op_steps is None and elapsed >= 2 * self.run.seconds / 3:
                    self.run.end_device_slice(crops=self.window_steps * self.batch)
                    self.op_steps = 0
                elif self.op_steps is not None:
                    self.op_steps += 1
                done = self.op_steps == OP_SLICE_STEPS
            else:
                done = elapsed >= self.run.seconds
            self.cut_short = not done and self.n == self.last
            if done or self.cut_short:
                self.run.close_window(crops=self.window_steps * self.batch)
                self.closed = True
                self.trainer.request_preemption()
        return loss, per_label


def leaf_gaps(prog: dict, refd: dict, keep: set[str]) -> dict[str, float]:
    """Per leaf of ``keep``: |norm(program) - norm(reference)| over the
    larger of the leaf's reference norm and the median leaf's."""
    norms = {k: float(refd[k].double().norm()) for k in keep}
    median = float(np.median(list(norms.values())))
    return {k: abs(float(prog[k].double().norm()) - norms[k]) / max(norms[k], median, 1e-30)
            for k in sorted(keep)}


def worst(gaps: dict[str, float]) -> tuple[float, str]:
    """(the worst gap, its leaf); a NaN is the worst."""
    k = max(gaps, key=lambda k: float("inf") if gaps[k] != gaps[k] else gaps[k])
    return gaps[k], k


def readings(losses: list[float], g1: dict, delta: dict, reference: dict,
             sd: dict) -> dict[str, float]:
    """Against the reference's ``train_steps`` result (``sd``: the weights
    before step 1): each step's relative loss gap, and the gradient's and
    the change's leaf gaps, worst (``grad_gap``, ``update_gap_worst``, with
    their leaves) and median (``grad_gap_median``, ``update_gap``). Leaves
    whose reference gradient is below ZERO_GRAD_SHARE of the median leaf's
    are left out of the change."""
    out = {f"loss_gap_step{i + 1}": abs(a - b) / abs(b)
           for i, (a, b) in enumerate(zip(losses, reference["losses"]))}
    gnorm = {k: float(v.double().norm()) for k, v in reference["grads"].items()}
    med = float(np.median(list(gnorm.values())))
    moved = {k for k, n in gnorm.items() if n >= ZERO_GRAD_SHARE * med}
    ref_delta = {k: reference["params"][k] - sd[k].float() for k in reference["params"]}
    grad = leaf_gaps(g1, reference["grads"], set(gnorm))
    update = leaf_gaps(delta, ref_delta, moved)
    out["grad_gap"], out["grad_leaf"] = worst(grad)
    out["grad_gap_median"] = float(np.median(list(grad.values())))
    out["update_gap_worst"], out["update_leaf"] = worst(update)
    out["update_gap"] = float(np.median(list(update.values())))
    return out


def compared(r: dict[str, float]) -> dict[str, float]:
    """The compared numbers of a training cell, from its ``readings``: the
    first gradient's worst leaf; the median leaf's change over the compared
    steps, and the worst leaf's, which reads about 1 where a leaf was left
    unmoved or moved twice. The losses are not compared: neither the
    precision control nor a planted fault reads them apart from sound runs
    (``PERF.md``)."""
    return {"grad_gap": r["grad_gap"], "update_gap": r["update_gap"],
            "update_gap_worst": r["update_gap_worst"]}


def reference_steps(run: Run, data: Path, labels: list[str], sd: dict, device: torch.device,
                    precision: str = "f32", half_batch: bool = False) -> dict:
    """The reference's compared steps on the corpus at ``data``, from the
    seeded weights ``sd``; ``half_batch`` leaves out the second half of each
    batch (a planted fault)."""
    tr, family = run.traffic, mf.reference_module(run.config)
    workers = min(run.config["program"]["train"]["dataloader"]["num_workers"], epoch_steps(tr))
    batches = ref.Corpus(data, labels).batches(run.seed, 0, workers, tr["batch_size"],
                                               tr["compared_steps"], family.crop_frames(run.config))
    if half_batch:
        batches = [(x[: len(x) // 2], y[: len(y) // 2]) for x, y in batches]
    return ref.train_steps(family.model(sd, run.config, device, precision), batches,
                           run.config["program"]["train"]["lr"], run.seed * 100_003)


def run(run: Run) -> Outcome:
    from segma_tpu_torch.data.file_dataset import SegmaFileDataset
    from segma_tpu_torch.data.loaders import SegmentationDataLoader
    from segma_tpu_torch.train import ADAMW_BETAS, Trainer

    tr = run.traffic
    device = torch.device("cuda:0" if run.device == "cuda" else run.device)
    notes = []
    with tempfile.TemporaryDirectory(prefix="h100bench-train-") as tmp:
        tmp = Path(tmp)
        data = tmp / "data"
        cfg = run.program_config(**{
            "data.dataset_path": str(data), "train.seed": run.seed,
            "train.batch_size": tr["batch_size"], "train.dispatch": tr["dispatch"],
            "train.data_cache": tr["data_cache"],
            "data.dataset_multiplier": tr["dataset_multiplier"], "train.max_epochs": 1})
        labels = list(cfg.data.classes)
        t_data = time.perf_counter()
        write_dataset(data, labels, {"train": (tr["train_files"], tr["train_file_s"]),
                                     "val": (tr["val_files"], tr["val_file_s"]),
                                     "test": (tr["val_files"], tr["val_file_s"])},
                      tr["events_per_minute"], run.seed, device)
        t_model = time.perf_counter()
        model, sd = mf.family_module(run.config).build(run, cfg, device)
        notes.append(f"set-up: imports {t_data - run.t_process:.1f} s, dataset "
                     f"{t_model - t_data:.1f} s, model {time.perf_counter() - t_model:.1f} s")
        trainer = Trainer(model, cfg, run_dir=tmp / "run", max_epochs=1, device=device)
        names = {p: n for n, p in model.module.named_parameters() if p.requires_grad}
        dataset = SegmaFileDataset.from_config(cfg)
        dataset.load(use_cache=False)
        loader = SegmentationDataLoader(dataset, model.label_encoder, cfg, model.conv_settings)
        n_batches = epoch_steps(tr)
        if n_batches <= tr["warmup_steps"] + 1:
            raise ValueError(f"an epoch of {n_batches} steps leaves no window")
        watch = StepWatch(run, trainer, names, tr["compared_steps"], tr["warmup_steps"],
                          tr["batch_size"], n_batches)
        trainer.train_step = watch
        t_fit = time.perf_counter()
        trainer.fit(loader)
        notes.append(f"set-up: fit to the window {run.t_open - t_fit:.1f} s "
                     f"({tr['warmup_steps']} steps among it)")
        if watch.cut_short or not watch.closed:
            raise RuntimeError(
                f"the epoch of {n_batches} steps ended {watch.window_steps} steps into the "
                f"window, before --seconds had passed: raise the traffic's dataset_multiplier")
        peak = run.memory_peak()
        window_losses = torch.stack(watch.window_losses).float().cpu()
        failed = int((~torch.isfinite(window_losses)).sum())
        losses = [float(x) for x in watch.losses]
        g1 = {k: m / (1 - ADAMW_BETAS[0]) for k, m in watch.first_moment.items()}
        delta = {k: watch.after[k] - sd[k] for k in watch.after}
        crops = watch.window_steps * tr["batch_size"]
        del trainer, model, watch, loader
        release(device)

        t_ref = time.perf_counter()
        reference = reference_steps(run, data, labels, sd, device)
        detail = readings(losses, g1, delta, reference, sd)
        notes.append(f"reference: {time.perf_counter() - t_ref:.1f} s; losses {losses} "
                     f"against {reference['losses']}; " + ", ".join(
                         f"{k} {v!r}" for k, v in detail.items()))
    return Outcome(
        measured={"train_xrt": crops * ref.CHUNK / ref.SR / run.window_s},
        attempted=crops // tr["batch_size"], failed=failed,
        checks=[Check(name, value, tr["checks"][name])
                for name, value in compared(detail).items()],
        memory_peak_bytes=peak, notes=notes, readings=detail)


def calibrate(cell_run: Run) -> dict:
    """This seed's readings of the compared numbers: the program's (a run of
    the cell with the window cut to a second: the compared steps are the
    set-up's), the precision control's (the reference in fp8 in the
    program's place) and a planted fault's (half of each batch left out,
    the mean taken over the rest), each against the f32 reference; a state
    left unchanged reads 1 on ``update_gap`` by its measure."""
    tr = cell_run.traffic
    cell_run.seconds = 1.0
    program = run(cell_run).readings
    device = torch.device("cuda:0" if cell_run.device == "cuda" else cell_run.device)
    with tempfile.TemporaryDirectory(prefix="h100bench-control-") as tmp:
        data = Path(tmp) / "data"
        cfg = cell_run.program_config()
        labels = list(cfg.data.classes)
        write_dataset(data, labels, {"train": (tr["train_files"], tr["train_file_s"])},
                      tr["events_per_minute"], cell_run.seed, device)
        model, sd = mf.family_module(cell_run.config).build(cell_run, cfg, device)
        del model
        exact = reference_steps(cell_run, data, labels, sd, device)
        out = {"program": program}
        for label, got in (
                ("control", reference_steps(cell_run, data, labels, sd, device, "fp8")),
                ("half_batch", reference_steps(cell_run, data, labels, sd, device,
                                               half_batch=True))):
            delta = {k: got["params"][k] - sd[k].float() for k in got["params"]}
            out[label] = readings(got["losses"], got["grads"], delta, exact, sd)
    return out
