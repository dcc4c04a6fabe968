"""Multi-label encoder (counterpart of ``segma_tpu/utils/encoders.py``):
label <-> index maps."""

from __future__ import annotations


class MultiLabelEncoder:
    """Maps each label to an integer index (one hydra head per label)."""

    def __init__(self, labels: list[str] | tuple[str, ...]) -> None:
        self._labels = tuple(labels)
        self.n_labels = len(self._labels)
        self.map = {label: i for i, label in enumerate(self._labels)}
        self.rev_map = {i: label for label, i in self.map.items()}

    @property
    def labels(self) -> tuple[str, ...]:
        return tuple(self.map.keys())

    @property
    def base_labels(self) -> tuple[str, ...]:
        return self._labels

    def transform(self, label: str) -> int:
        return self.map[label]

    def inv_transform(self, i: int) -> str:
        if not (0 <= i < self.n_labels):
            raise ValueError(
                f"transformed index '{i}' is not assigned, only "
                f"{self.n_labels} labels are available."
            )
        return self.rev_map[i]

    def __len__(self) -> int:
        return self.n_labels

    def __contains__(self, label) -> bool:
        return label in self.map
