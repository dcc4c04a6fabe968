"""Unit conversions between seconds, milliseconds and frames (counterpart of
``segma_tpu/utils/conversions.py``). "Frames" means raw audio samples."""

from __future__ import annotations

import numpy as np

DEFAULT_SAMPLE_RATE = 16_000


def second_to_millisecond(s: float | np.ndarray) -> float | np.ndarray:
    return s * 1e3


def seconds_to_frames(
    s: float | np.ndarray, sample_rate: int = DEFAULT_SAMPLE_RATE
) -> int | np.ndarray:
    """Seconds -> sample count, truncated (``int(s * sample_rate)``)."""
    if isinstance(s, np.ndarray):
        return (s * sample_rate).astype(np.int64)
    return int(s * sample_rate)


def frames_to_seconds(
    f: int | np.ndarray, sample_rate: int = DEFAULT_SAMPLE_RATE
) -> float | np.ndarray:
    return f / sample_rate
