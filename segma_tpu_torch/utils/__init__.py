"""Audio, label and unit helpers (numpy only); seeding and host memory
probes (counterpart of ``segma_tpu/utils/__init__.py``)."""

from __future__ import annotations

import random

import numpy as np


def set_seed(seed: int) -> None:
    """Seed python's, numpy's and torch's global RNGs, as the reference's
    ``set_seed`` does. The training loop's own randomness (crops, dropout)
    comes from generators seeded from ``(train.seed, epoch)``; cuDNN's
    deterministic algorithms are scoped inside ``Trainer.fit``."""
    import torch

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def host_rss_gb() -> float:
    """This process's resident set size in GB (0.0 when /proc is absent)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / 1e6  # kB -> GB
    except OSError:
        pass
    return 0.0


def host_mem_total_gb() -> float:
    """Total host RAM in GB (0.0 when /proc is absent)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal"):
                    return int(line.split()[1]) / 1e6
    except OSError:
        pass
    return 0.0
