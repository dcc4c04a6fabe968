"""Training CLI (counterpart of ``segma_tpu/cli/train.py``):

    python -m segma_tpu_torch.cli.train -c <config.yml> [key.path=value ...]
        [--resume-from <checkpoint>] [--tags ...] [--device cuda|cpu]
        [--dist-backend nccl|gloo]

Several cards: under a launcher (``torchrun --nproc-per-node N python -m
segma_tpu_torch.cli.train ...``, or the JAX package's ``COORDINATOR_ADDRESS``,
``PROCESS_COUNT`` and ``PROCESS_ID``) each rank trains on card
``LOCAL_RANK`` (``parallel.distributed``): its shard of the files in a
data-parallel world, or, with ``mesh.model`` or ``mesh.seq`` above 1, its
member of the (data, seq, model) mesh of ranks (``train.Trainer``), and rank
0 alone makes the run directory and writes ``config.yml``,
``metrics.jsonl`` and the checkpoints. Run plainly with several visible
cards and a config that asks for more than one device (``mesh.data`` other
than 1, or ``mesh.seq * mesh.model`` above 1), the command starts one rank
per card of ``parallel.auto_mesh`` itself (data x seq x model of them, as
JAX's CLI builds its mesh over the visible devices) on a local rendezvous,
forwards SIGTERM to them and exits with their code (75 when they were
preempted). On one card such a config trains meshless, as JAX's does on
one device.

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
import signal
import socket
import subprocess
import sys
import time
from datetime import datetime
from pathlib import Path
from typing import Any

import numpy as np

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
    parser.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                        help="the collectives' backend under several processes: nccl on "
                        "cards, gloo on the CPU by default; gloo on cards lets several "
                        "ranks share one card")
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
                 device: str = "cuda", dist_backend: str | None = None) -> dict[str, Any]:
    """Train ``cfg`` through ``Trainer.fit`` into a new (or ``run_id``'s) run
    directory; returns ``fit``'s result. Under a launcher's environment this
    process is one rank of the world (``maybe_init_distributed``)."""
    from segma_tpu_torch.parallel import distributed

    started = (not distributed.is_initialized()
               and distributed.maybe_init_distributed(device, dist_backend))
    if distributed.is_initialized():
        device = distributed.local_device(device)
        log(f"rank {distributed.rank()} of {distributed.world_size()} on {device}")
    try:
        return _train(cfg, tags, resume_from, run_id, output, device)
    finally:
        if started:  # a world this call joined; a caller's stays
            distributed.destroy()


def _train(cfg: Config, tags: list[str], resume_from: str | None, run_id: str | None,
           output: str | None, device: Any) -> dict[str, Any]:
    from segma_tpu_torch.checkpoint import build_model
    from segma_tpu_torch.data import SegmaFileDataset, SegmentationDataLoader
    from segma_tpu_torch.parallel import distributed
    from segma_tpu_torch.parallel.distributed import current_world
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

    world = current_world()
    is_main = distributed.is_main()
    chkp_root = Path(output) if output else Path(cfg.model.chkp_path or "models")
    stamp = run_id or datetime.fromtimestamp(time.time()).strftime("%Y%m%d_%H%M%S")
    if world is not None:
        stamp = world.broadcast(stamp)  # one run directory: rank 0's clock
    run_dir = chkp_root / stamp
    if is_main:  # the single writer
        run_dir.mkdir(parents=True, exist_ok=True)
        cfg.save(run_dir / "config.yml")
    if tags:
        log(f"tags: {tags}")

    trainer = Trainer(model=model, config=cfg, run_dir=run_dir, device=device)
    # under a mesh the trainer holds its member copy: let the whole model go
    del model
    log("started training")
    result = trainer.fit(dm, resume_from=resume_from)

    if result.get("interrupted"):
        # last/ holds the resumable state; requeue with --auto-resume
        log(f"preempted — resume from {run_dir / 'checkpoints' / 'last'}")
        return result

    if result["best_path"] is not None and is_main:
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


def local_world_size(cfg: Config, device: str, backend: str | None = None) -> int:
    """How many ranks a plain run on ``device`` starts itself: one per card
    of ``parallel.auto_mesh`` (several visible cards and a config that asks
    for more than one device), data x seq x model of them, under either
    dispatch; 1 under a launcher, on the CPU or on one card. ``backend``
    (``--dist-backend``, NCCL by default) is checked against the dispatch
    first: epoch dispatch over gloo ranks on cards with seq or model above
    1 raises (``parallel.mesh.check_dispatch``)."""
    import torch

    from segma_tpu_torch.parallel.distributed import launcher_env
    from segma_tpu_torch.parallel.mesh import auto_mesh, check_dispatch

    mesh = None if launcher_env() is not None else auto_mesh(cfg, torch.device(device))
    if mesh is None:
        return 1
    shape = tuple(mesh.shape.values())
    check_dispatch(cfg, shape, backend or "nccl", device)
    return int(np.prod(shape))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_ranks(module: str, argv: list[str], n: int) -> int:
    """Run ``python -m module argv`` as ``n`` ranks of one world on this
    host (rank r on card r, a rendezvous on a free local port); SIGTERM is
    forwarded to every rank, and a rank that fails ends the others. Returns
    0 when every rank did, 75 when a rank was preempted and none failed
    otherwise, else the first other code."""
    port = _free_port()
    procs = []
    for r in range(n):
        env = {**os.environ, "RANK": str(r), "LOCAL_RANK": str(r), "WORLD_SIZE": str(n),
               "LOCAL_WORLD_SIZE": str(n), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
        procs.append(subprocess.Popen([sys.executable, "-m", module, *argv], env=env))

    def forward(signum: int, _frame: Any) -> None:
        for proc in procs:
            if proc.poll() is None:
                proc.send_signal(signum)

    previous = signal.signal(signal.SIGTERM, forward)
    try:
        # a rank that fails leaves the others waiting in a collective: end them
        while any(proc.poll() is None for proc in procs):
            if any(proc.poll() not in (None, 0, EX_TEMPFAIL) for proc in procs):
                for proc in procs:
                    if proc.poll() is None:
                        proc.kill()
            time.sleep(0.2)
        codes = [proc.wait() for proc in procs]
    finally:
        signal.signal(signal.SIGTERM, previous)
    log(f"ranks exited with {codes}")
    failed = [c for c in codes if c not in (0, EX_TEMPFAIL)]
    if failed:
        return failed[0]
    return EX_TEMPFAIL if EX_TEMPFAIL in codes else 0


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    args, extra_args = build_argparser().parse_known_args(argv)
    cfg = load_config(args.config, cli_extra_args=extra_args)
    n = local_world_size(cfg, args.device, args.dist_backend)
    if n > 1:
        log(f"{n} cards visible, mesh.data={cfg.mesh.data}, mesh.seq={cfg.mesh.seq}, "
            f"mesh.model={cfg.mesh.model}: one rank per card")
        raise SystemExit(launch_ranks("segma_tpu_torch.cli.train", argv, n))
    result = run_training(cfg, args.tags, resume_from=args.resume_from, device=args.device,
                          dist_backend=args.dist_backend)
    if result.get("interrupted"):
        # not finished: the requeue loop keeps the run alive
        raise SystemExit(EX_TEMPFAIL)


if __name__ == "__main__":
    main()
