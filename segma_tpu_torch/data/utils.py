"""Dataset annotation helpers (counterpart of ``segma_tpu/data/utils.py``)."""

from __future__ import annotations

from pathlib import Path

from segma_tpu_torch.annotation import AudioAnnotation
from segma_tpu_torch.data.intervals import IntervalIndex
from segma_tpu_torch.utils.conversions import seconds_to_frames
from segma_tpu_torch.utils.encoders import LabelEncoder


def load_uris(file_p: Path) -> list[str]:
    """Load a newline-separated list of URIs."""
    with Path(file_p).open("r") as f:
        return [line.strip() for line in f.readlines() if line.strip()]


def load_annotations(aa_file_p: Path) -> list[AudioAnnotation]:
    """Parse a ``.aa`` annotation file."""
    with Path(aa_file_p).open("r") as f:
        return [AudioAnnotation.read_line(line) for line in f if line.strip()]


def filter_annotations(
    annotations: list[AudioAnnotation],
    covered_labels: tuple[str, ...] | list[str] | set[str],
) -> list[AudioAnnotation]:
    """Keep only annotations whose label is configured."""
    covered = set(covered_labels)
    return [annot for annot in annotations if annot.label in covered]


def total_annotation_duration_ms(annotations: list[AudioAnnotation]) -> float:
    return sum(a.duration_ms for a in annotations)


def total_annotation_duration_f(annotations: list[AudioAnnotation], sample_rate: int) -> int:
    return seconds_to_frames(sum(a.duration_s for a in annotations), sample_rate=sample_rate)


def create_index_from_annotations(
    annotations: list[AudioAnnotation], label_encoder: LabelEncoder
) -> IntervalIndex:
    """Build the vectorized interval index for one file."""
    return IntervalIndex.from_annotations(annotations, label_encoder)
