"""Unit conversions between seconds and frames (counterpart of
``segma_tpu/utils/conversions.py``). "Frames" means raw audio samples."""

from __future__ import annotations

import numpy as np

DEFAULT_SAMPLE_RATE = 16_000


def frames_to_seconds(
    f: int | np.ndarray, sample_rate: int = DEFAULT_SAMPLE_RATE
) -> float | np.ndarray:
    return f / sample_rate
