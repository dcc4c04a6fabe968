"""Training CLI (counterpart of ``segma_tpu/cli/train.py``), one card:

    python -m segma_tpu_torch.cli.train -c <config.yml> [key.path=value ...]
        [--resume-from <checkpoint>] [--tags ...] [--device cuda|cpu]

The run directory is ``<model.chkp_path or "models">/<timestamp>``; it holds
``config.yml`` (readable by both packages' ``load_config``),
``metrics.jsonl`` (the port logs there only; a config's ``wandb`` section is
read and ignored) and ``checkpoints/``. A run that ends uninterrupted points
``models/last/best.ckpt`` (under the working directory) at its best
checkpoint. A preempted run (SIGTERM, or the host RSS watchdog) exits with
code 75 (EX_TEMPFAIL) and resumes with ``cli.auto_train --auto-resume``.
SIGTERM is caught, so ``timeout``'s default signal does not end a run:
bound a run's wall with ``timeout -s KILL``, or kill it by PID.
"""

from __future__ import annotations

import argparse
import os
import time
from datetime import datetime
from pathlib import Path
from typing import Any

from segma_tpu_torch.config import CONFIG_DIR, Config, load_config
from segma_tpu_torch.utils.logging import log

EX_TEMPFAIL = 75  # interrupted: requeue and resume


def build_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", type=str, default=str(CONFIG_DIR / "default.yml"),
                        help="Config file to be loaded and used for the training.")
    parser.add_argument("--tags", nargs="*", default=[], help="Tags for the logging instance.")
    parser.add_argument("--resume-from", type=str, default=None,
                        help="Checkpoint to resume from.")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the model trains (the card unless cpu)")
    return parser


def fast_context_hint(cfg: Config) -> str | None:
    """The hint toward ``model.config.fast_context`` for a NEW Whisper-family
    training that left it off outside ``audio.reference_tail`` mode, else
    None. The padded 30 s context runs the encoder over 1500 positions where
    a 4 s chunk has 200; fast_context runs the chunk's own positions."""
    mc = cfg.model.config
    if not hasattr(mc, "fast_context") or mc.fast_context:
        return None
    if cfg.audio.reference_tail:
        return None  # parity mode: the padded context is the point
    return (
        "hint: model.config.fast_context=true runs the whisper encoder on the chunk's own "
        "frames instead of the padded 30 s context (200 positions for 4 s, not 1500). "
        "Numerics differ from the padded reference; use it for NEW trainings (train and "
        "infer with the same setting), keep the default for reference-parity checkpoints."
    )


def run_training(cfg: Config, tags: list[str], resume_from: str | None = None,
                 run_id: str | None = None, output: str | None = None,
                 device: str = "cuda") -> dict[str, Any]:
    """Train ``cfg`` through ``Trainer.fit`` into a new (or ``run_id``'s) run
    directory; returns ``fit``'s result."""
    from segma_tpu_torch.checkpoint import build_model
    from segma_tpu_torch.data import SegmaFileDataset, SegmentationDataLoader
    from segma_tpu_torch.train import Trainer
    from segma_tpu_torch.utils import set_seed

    if cfg.train.seed is not None:  # 0 is a valid seed
        set_seed(cfg.train.seed)
    if "hydra" not in cfg.model.name and "vad" not in cfg.model.name:
        raise ValueError("Only `MultiLabelEncoder` is supported")
    model = build_model(cfg, device=device)
    hint = fast_context_hint(cfg)
    if hint:
        log(hint)

    log("SegmentationDataLoader initializing ...")
    sfd = SegmaFileDataset.from_config(cfg)
    sfd.load()
    dm = SegmentationDataLoader(sfd, model.label_encoder, cfg, model.conv_settings)
    log("SegmentationDataLoader initialized")

    chkp_root = Path(output) if output else Path(cfg.model.chkp_path or "models")
    stamp = run_id or datetime.fromtimestamp(time.time()).strftime("%Y%m%d_%H%M%S")
    run_dir = chkp_root / stamp
    run_dir.mkdir(parents=True, exist_ok=True)
    cfg.save(run_dir / "config.yml")
    if tags:
        log(f"tags: {tags}")

    trainer = Trainer(model=model, config=cfg, run_dir=run_dir, device=device)
    log("started training")
    result = trainer.fit(dm, resume_from=resume_from)

    if result.get("interrupted"):
        # last/ holds the resumable state; requeue with --auto-resume
        log(f"preempted — resume from {run_dir / 'checkpoints' / 'last'}")
        return result

    if result["best_path"] is not None:
        # the static best-model pointer; an atomic replace, so a concurrent
        # reader never sees a missing link
        static_p = Path("models/last")
        static_p.mkdir(parents=True, exist_ok=True)
        best_link = static_p / "best.ckpt"
        tmp_link = static_p / f".best.ckpt.{os.getpid()}"
        tmp_link.unlink(missing_ok=True)
        tmp_link.symlink_to(Path(result["best_path"]).resolve())
        os.replace(tmp_link, best_link)

    log(f"best model score: {result['best_score']}")
    log(f"best model path: {result['best_path']}")
    return result


def main(argv: list[str] | None = None) -> None:
    args, extra_args = build_argparser().parse_known_args(argv)
    cfg = load_config(args.config, cli_extra_args=extra_args)
    result = run_training(cfg, args.tags, resume_from=args.resume_from, device=args.device)
    if result.get("interrupted"):
        # not finished: the requeue loop keeps the run alive
        raise SystemExit(EX_TEMPFAIL)


if __name__ == "__main__":
    main()
