"""``segma-tpu-torch`` console command: one dispatcher over every entry
point of the port (counterpart of ``segma_tpu/cli/__init__.py``).

    segma-tpu-torch <command> [args]

Each command is also ``python -m <its module>``.
"""

from __future__ import annotations

import sys

_COMMANDS = {
    "train": ("segma_tpu_torch.cli.train", "full training run"),
    "auto-train": (
        "segma_tpu_torch.cli.auto_train",
        "training with --auto-resume/--run-id (cluster requeue contract)",
    ),
    "predict": ("segma_tpu_torch.inference", "sliding-window inference over WAV files -> RTTM"),
    "tune": ("segma_tpu_torch.tune", "per-label threshold grid search"),
    "evaluate": ("segma_tpu_torch.evaluate", "macro-average F-measure / DER vs ground-truth RTTM"),
    "serve": ("segma_tpu_torch.cli.serve", "HTTP serving (batch + streaming)"),
    "export": ("segma_tpu_torch.cli.export", "freeze a trained model into a torch.export artifact"),
    "import": ("segma_tpu_torch.cli.import_checkpoint", "convert a reference torch checkpoint"),
    "bundle": (
        "segma_tpu_torch.cli.bundle",
        "catalog a directory of artifacts for multi-model serving",
    ),
    "doctor": (
        "segma_tpu_torch.cli.doctor",
        "environment diagnostics (card, kernel build, probe, host)",
    ),
}


def _usage() -> str:
    lines = ["usage: segma-tpu-torch <command> [args]", "", "commands:"]
    for name, (_, desc) in _COMMANDS.items():
        lines.append(f"  {name:<12} {desc}")
    lines.append("")
    lines.append("run `segma-tpu-torch <command> --help` for command arguments")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(_usage())
        return
    cmd = argv[0]
    if cmd not in _COMMANDS:
        print(f"unknown command {cmd!r}\n\n{_usage()}", file=sys.stderr)
        raise SystemExit(2)
    import importlib

    importlib.import_module(_COMMANDS[cmd][0]).main(argv[1:])
