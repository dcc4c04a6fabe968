"""Vectorized annotation interval index (a copy of
``segma_tpu/data/intervals.py``; numpy only).

All windows of a chunk are labeled at once with one broadcast. Overlap
semantics match InterLap (inclusive on both endpoints).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from segma_tpu_torch.annotation import AudioAnnotation
from segma_tpu_torch.utils.encoders import MultiLabelEncoder


@dataclass
class IntervalIndex:
    """Annotations of one audio file as flat arrays (frame units).

    Attributes:
        starts: (A,) int64 annotation start frames.
        ends: (A,) int64 annotation end frames.
        label_onehot: (A, L) float32 one-hot of each annotation's label.
        labels: (A,) object array of label strings (for readable queries).
    """

    starts: np.ndarray
    ends: np.ndarray
    label_onehot: np.ndarray
    labels: np.ndarray

    @classmethod
    def from_annotations(
        cls, annotations: list[AudioAnnotation], label_encoder: MultiLabelEncoder
    ) -> "IntervalIndex":
        n_labels = len(label_encoder.base_labels)
        if not annotations:
            return cls(
                starts=np.zeros(0, np.int64),
                ends=np.zeros(0, np.int64),
                label_onehot=np.zeros((0, n_labels), np.float32),
                labels=np.array([], dtype=object),
            )
        starts = np.array([a.start_time_f for a in annotations], np.int64)
        ends = np.array([a.end_time_f for a in annotations], np.int64)
        onehot = np.zeros((len(annotations), n_labels), np.float32)
        for i, a in enumerate(annotations):
            onehot[i, label_encoder.transform(a.label)] = 1.0
        labels = np.array([a.label for a in annotations], dtype=object)
        return cls(starts, ends, onehot, labels)

    def query_windows(self, windows: np.ndarray) -> np.ndarray:
        """(W, n_labels) float32 multi-hot targets for (W, 2) inclusive
        [start, end] frame windows; all-zero rows mean "no class"."""
        if len(self.starts) == 0:
            return np.zeros((windows.shape[0], self.label_onehot.shape[1]), np.float32)
        w_start = windows[:, 0:1]  # (W, 1)
        w_end = windows[:, 1:2]
        hit = (self.starts[None, :] <= w_end) & (self.ends[None, :] >= w_start)
        y = hit.astype(np.float32) @ self.label_onehot  # (W, L) counts
        return (y > 0).astype(np.float32)

    def __len__(self) -> int:
        return len(self.starts)
