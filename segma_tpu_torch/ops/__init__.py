"""Operators: the log-mel frontend, attention and the LSTM's recurrence,
each with its CUDA kernel, and the kernel wrappers' launch counters
(``telemetry``'s counters ``launch.<kernel>``, counted under its lock: the
replicas of a mesh launch from threads of their own).

Importing this package registers the port's ``torch.library`` ops in the
``segma_tpu_torch`` namespace (``segma_tpu_torch::log10_mel``,
``::flash_attn_fwd``, ``::flash_attn_fwd_lse``, ``::wavlm_attn_fwd`` and
``::lstm``): a program
saved by ``torch.export`` names them, and loading one needs this import and
nothing else of the port.
"""

from __future__ import annotations

from typing import Any, Callable, Hashable

import torch

from segma_tpu_torch import telemetry

# the kernel wrappers' counters, by kernel: log-mel, the bf16 flash forward
# and backward (one per call, which runs the dq and the dkv kernel), the f32
# ones, the LSTM's recurrence (one per layer call) and WavLM's gated-bias
# attention forward (one per layer)
LAUNCH_KEYS = ("logmel", "flash_attn_fwd", "flash_attn_bwd", "flash_attn_fwd_f32",
               "flash_attn_bwd_f32", "lstm_fwd", "wavlm_attn_fwd")


def cached_constant(cache: dict, key: Hashable, make: Callable[[], Any]) -> Any:
    """``cache[key]``, made by ``make()`` on the first call. While
    ``torch.export`` or ``torch.compile`` traces, the cache is neither read
    nor filled: ``make()`` builds the constant in the traced program, as a
    table stored from a trace would be a fake tensor that later eager calls
    (and the next trace) would read. A constant made under
    ``torch.inference_mode`` is made outside it, so that a model served
    first can still be trained (autograd refuses to save an inference
    tensor). Two threads filling one key at once store equal tensors."""
    if torch.compiler.is_compiling():
        return make()
    value = cache.get(key)
    if value is None:
        with torch.inference_mode(False):
            value = cache.setdefault(key, make())
    return value


# the counter store is ``telemetry``'s; ``LaunchCounter`` is its class
LaunchCounter = telemetry.Counters


def count_launch(key: str) -> None:
    """One launch of kernel ``key``: each wrapper calls it where it launches."""
    telemetry.count(f"launch.{key}")


def launch_counts() -> dict[str, int]:
    """Each kernel wrapper's launches since its counter was last set."""
    counts = telemetry.counts()
    return {key: counts.get(f"launch.{key}", 0) for key in LAUNCH_KEYS}


def set_launch_counts(counts: dict[str, int]) -> None:
    """Set the wrappers' counters (``launch_counts``'s keys)."""
    telemetry.set_counts({f"launch.{key}": counts[key] for key in LAUNCH_KEYS})


def add_launch_counts(counts: dict[str, int]) -> None:
    """Advance the counters by ``counts`` at once (a graph replay's)."""
    telemetry.add_counts({f"launch.{key}": n for key, n in counts.items()})


# the op registrations (after the helpers above, which the modules import)
from segma_tpu_torch.ops import attention, logmel, rnn  # noqa: E402,F401
