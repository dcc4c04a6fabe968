"""Receptive-field geometry of strided conv stacks (a copy of
``segma_tpu/models/geometry.py``; numpy only). It lives outside ``models``
so that an exported artifact's loader (``export.ExportedPipeline``) reads
frame geometry without importing the model package.

This single class links model output frames <-> raw sample indices and shapes
every number downstream: label windowing during training, chunk geometry
during inference, and interval decode. Equations follow
https://distill.pub/2019/computing-receptive-fields/ (eqs 2, 5, 6), with the
same even-kernel ``+1`` step correction the reference applies in
``n_windows`` (``src/segma/models/base.py:119-142``).

Key invariants reproduced bit-for-bit (reference ``SURVEY.md`` §2.9):
- Whisper stack ``((400,3,3),(160,1,2),(200,1,1))`` -> rf_step 320 (20 ms).
- HuBERT stack ``((10,3,3,3,3,2,2),(5,2,2,2,2,2,2),zeros)`` -> rf_step 320.
- 4 s @ 16 kHz chunk (64_000 samples), even kernel present -> effective step
  321 -> 199 windows both strict and non-strict.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from math import floor, prod

import numpy as np


@dataclass(frozen=True)
class ConvolutionSettings:
    """Kernel/stride/padding description of a stack of 1-D convolutions."""

    kernels: tuple[int, ...]
    strides: tuple[int, ...]
    paddings: tuple[int, ...]
    _cache: dict = field(default_factory=dict, compare=False, repr=False)

    def __post_init__(self):
        if not (len(self.kernels) == len(self.strides) == len(self.paddings)):
            raise ValueError(
                "Given settings do not match, please provide matching dimensions "
                "for kernels, strides and paddings."
            )

    # -- cumulative quantities ------------------------------------------------
    @property
    def _total_stride(self) -> int:
        """Product of all strides: input samples per output frame."""
        return prod(self.strides)

    @property
    def _total_padding(self) -> int:
        """Effective left padding of the whole stack (P_0 in distill eq 5)."""
        return sum(
            p * prod(self.strides[:i]) for i, p in enumerate(self.paddings)
        )

    def rf_start_i(self, u_L: int) -> int:
        """First input sample index covered by output frame ``u_L``.

        distill.pub eq (5). May be negative when padding reaches past the
        start of the signal.
        """
        return u_L * self._total_stride - self._total_padding

    def rf_end_i(self, v_L: int) -> int:
        """Last input sample index covered by output frame ``v_L``.

        distill.pub eq (6). May exceed the input length near the tail.
        """
        tail = sum(
            (1 + self.paddings[i] - self.kernels[i]) * prod(self.strides[:i])
            for i in range(len(self.kernels))
        )
        return v_L * self._total_stride - tail

    def run_interval(self, first_frame: int, last_frame: int) -> tuple[int, int]:
        """Sample interval ``[start, end)`` covered by the frame run
        ``[first_frame, last_frame]`` (inclusive).

        THE decode invariant (pinned by tests/golden/decode.rttm):
        start = max(0, rf_start(first)), end = rf_end(last) + 1 — matching
        the reference's ``create_intervals`` (``inference.py:237-263``).
        Every decode path (packed device runs, mask fallback, streaming
        emit/flush) must build intervals through ``run_bounds``, which this
        method calls for one run.
        """
        start, end = self.run_bounds(first_frame, last_frame)
        return int(start), int(end)

    def run_bounds(self, first: np.ndarray, last: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """``run_interval`` over arrays of runs at once: the int64 (starts,
        ends) of [max(0, rf_start(first)), rf_end(last) + 1). The serving
        decode unpacks a file's runs, up to hundreds of thousands, with it."""
        first, last = np.asarray(first, np.int64), np.asarray(last, np.int64)
        return np.maximum(self.rf_start_i(first), 0), self.rf_end_i(last) + 1

    @property
    def rf_size(self) -> int:
        """Receptive-field size of one output frame (distill.pub eq 2)."""
        if "rf_size" not in self._cache:
            self._cache["rf_size"] = (
                sum(
                    (k - 1) * prod(self.strides[:i])
                    for i, k in enumerate(self.kernels)
                )
                + 1
            )
        return self._cache["rf_size"]

    def rf_center_i(self, u_L: int) -> float:
        """Center input index of output frame ``u_L``'s receptive field."""
        return u_L * self._total_stride + (self.rf_size - 1) / 2 - self._total_padding

    @property
    def rf_step(self) -> int:
        """Stride (in input samples) between two consecutive receptive fields."""
        if "rf_step" not in self._cache:
            step = self.rf_start_i(1) - self.rf_start_i(0)
            assert step == self.rf_end_i(1) - self.rf_end_i(0)
            self._cache["rf_step"] = abs(step)
        return self._cache["rf_step"]

    @property
    def effective_step(self) -> int:
        """``rf_step`` plus the even-kernel alignment correction.

        The reference adds +1 to the step inside ``n_windows`` whenever any
        kernel is even (``models/base.py:131-137``); the corrected value is
        what actually divides chunks into windows everywhere downstream.
        """
        has_even_kernel = any(k % 2 == 0 for k in self.kernels)
        return int(self.rf_step) + (1 if has_even_kernel else 0)

    def n_windows(self, chunk_duration_f: int, strict: bool = True) -> int:
        """Number of model output frames for a chunk of ``chunk_duration_f``
        input samples.

        strict=True counts only fully-contained receptive fields; strict=False
        allows windows that partially exceed the chunk (truncation mode used
        for the Whisper path, which pads to 30 s internally).
        """
        step = self.effective_step
        if strict:
            # clamp: an input shorter than one receptive field has zero
            # frames, not a negative count (found by property testing)
            return max(0, floor((chunk_duration_f - self.rf_size) / step) + 1)
        return chunk_duration_f // step

    # -- vectorized variants ---------------------------------------------------
    def rf_bounds(self, n_windows: int) -> np.ndarray:
        """(n_windows, 2) array of [rf_start, rf_end] per output frame."""
        idx = np.arange(n_windows, dtype=np.int64)
        starts = idx * self._total_stride - self._total_padding
        ends = np.array([self.rf_end_i(0)], dtype=np.int64) + idx * self._total_stride
        return np.stack([starts, ends], axis=1)
