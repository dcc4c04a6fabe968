"""Operators: the log-mel frontend and attention, each with its CUDA kernel,
and the kernel wrappers' launch counters.

Importing this package registers the port's ``torch.library`` ops in the
``segma_tpu_torch`` namespace (``segma_tpu_torch::log10_mel``,
``::flash_attn_fwd``, ``::flash_attn_fwd_lse`` and ``::lstm``): a program
saved by ``torch.export`` names them, and loading one needs this import and
nothing else of the port.
"""

from __future__ import annotations

from typing import Any, Callable, Hashable

import torch


def cached_constant(cache: dict, key: Hashable, make: Callable[[], Any]) -> Any:
    """``cache[key]``, made by ``make()`` on the first call. While
    ``torch.export`` or ``torch.compile`` traces, the cache is neither read
    nor filled: ``make()`` builds the constant in the traced program, as a
    table stored from a trace would be a fake tensor that later eager calls
    (and the next trace) would read. Two threads filling one key at once
    store equal tensors."""
    if torch.compiler.is_compiling():
        return make()
    value = cache.get(key)
    if value is None:
        value = cache.setdefault(key, make())
    return value


def launch_counts() -> dict[str, int]:
    """Each kernel wrapper's launches since its counter was last set."""
    from segma_tpu_torch.ops import attention, logmel

    return {"logmel": logmel.launches, "flash_attn_fwd": attention.launches,
            "flash_attn_bwd": attention.bwd_launches,
            "flash_attn_fwd_f32": attention.launches_f32,
            "flash_attn_bwd_f32": attention.bwd_launches_f32}


def set_launch_counts(counts: dict[str, int]) -> None:
    """Set the wrappers' counters (``launch_counts``'s keys)."""
    from segma_tpu_torch.ops import attention, logmel

    logmel.launches = counts["logmel"]
    attention.launches, attention.bwd_launches = counts["flash_attn_fwd"], counts["flash_attn_bwd"]
    attention.launches_f32 = counts["flash_attn_fwd_f32"]
    attention.bwd_launches_f32 = counts["flash_attn_bwd_f32"]


# the op registrations (after the helpers above, which the modules import)
from segma_tpu_torch.ops import attention, logmel, rnn  # noqa: E402,F401
