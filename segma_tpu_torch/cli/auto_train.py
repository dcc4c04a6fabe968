"""Resumable training CLI (counterpart of ``segma_tpu/cli/auto_train.py``):

    python -m segma_tpu_torch.cli.auto_train -c <config.yml> --run-id <id>
        [--output <root>] [--auto-resume] [key.path=value ...] [--device cuda|cpu]

``--run-id`` pins the run directory ``<output or model.chkp_path>/<id>``;
``--auto-resume`` continues from that run's newest valid checkpoint
(``checkpoint.find_resumable``: ``last/``, else the newest epoch directory),
or starts fresh when there is none. An interrupted run exits with code 75,
so a requeue loop runs the same command again. Several processes
(``torchrun``, or one rank per card of the config's mesh started here) as
in ``cli.train``: every rank resumes from the same checkpoint, a mesh
member taking its blocks of it.
"""

from __future__ import annotations

import sys
from pathlib import Path

from segma_tpu_torch.cli.train import (
    EX_TEMPFAIL, build_argparser, launch_ranks, local_world_size, run_training,
)
from segma_tpu_torch.config import load_config
from segma_tpu_torch.utils.logging import log


def main(argv: list[str] | None = None) -> None:
    parser = build_argparser()
    parser.add_argument("--auto-resume", action="store_true",
                        help="resume from the run's last checkpoint if present")
    parser.add_argument("--run-id", type=str, default=None)
    parser.add_argument("--output", type=str, default=None)
    argv = sys.argv[1:] if argv is None else list(argv)
    args, extra_args = parser.parse_known_args(argv)
    cfg = load_config(args.config, cli_extra_args=extra_args)
    n = local_world_size(cfg, args.device)
    if n > 1:
        log(f"{n} cards visible, mesh.data={cfg.mesh.data}, mesh.seq={cfg.mesh.seq}, "
            f"mesh.model={cfg.mesh.model}: one rank per card")
        raise SystemExit(launch_ranks("segma_tpu_torch.cli.auto_train", argv, n))

    resume_from = args.resume_from
    if args.auto_resume and resume_from is None and args.run_id:
        from segma_tpu_torch.checkpoint import find_resumable

        root = Path(args.output) if args.output else Path(cfg.model.chkp_path or "models")
        # the newest VALID resume point: a torn last/ must not turn the
        # requeue contract into a crash loop
        resumable = find_resumable(root / args.run_id / "checkpoints")
        if resumable is not None:
            resume_from = resumable
            log(f"auto-resume from {resumable}")
        else:
            log("auto-resume requested but no (valid) checkpoint found; fresh run")

    result = run_training(cfg, args.tags, resume_from=resume_from, run_id=args.run_id,
                          output=args.output, device=args.device,
                          dist_backend=args.dist_backend)
    if result.get("interrupted"):
        raise SystemExit(EX_TEMPFAIL)


if __name__ == "__main__":
    main()
