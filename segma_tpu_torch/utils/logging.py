"""Metrics logging (counterpart of ``segma_tpu/utils/logging.py``): an
append-only JSONL stream with a console echo. The JAX package's optional
wandb mirror is not ported."""

from __future__ import annotations

import json
import time
from pathlib import Path


class MetricsLogger:
    """Append-only JSONL metrics stream with console echo."""

    def __init__(self, path: Path | str | None = None, echo: bool = True) -> None:
        self.path = Path(path) if path is not None else None
        if self.path is not None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
        self.echo = echo

    def log(self, metrics: dict) -> None:
        record = {"ts": time.time(), **metrics}
        if self.path is not None:
            with self.path.open("a") as f:
                f.write(json.dumps(record) + "\n")
        if self.echo:
            short = {k: (round(v, 5) if isinstance(v, float) else v) for k, v in metrics.items()}
            print(f"[log] - {short}", flush=True)


def log(msg: str) -> None:
    """Timestamped console log line."""
    print(f"[log @ {time.strftime('%Y%m%d_%H:%M:%S')}] - {msg}", flush=True)
