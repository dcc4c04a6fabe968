"""Label encoders (counterpart of ``segma_tpu/utils/encoders.py``): the
interface every encoder gives (``LabelEncoder``), the multi-label encoder's
label <-> index maps, and the powerset encoder's subset classes."""

from __future__ import annotations

from abc import ABC, abstractmethod
from collections.abc import Iterable

import numpy as np


class LabelEncoder(ABC):
    """The label encoder interface shared by every pipeline layer."""

    @property
    @abstractmethod
    def labels(self) -> tuple[str, ...]:
        """Encoded labels, in index order."""

    @property
    @abstractmethod
    def base_labels(self) -> tuple[str, ...]:
        """Raw label vocabulary."""

    @abstractmethod
    def transform(self, label: str | tuple[str, ...]) -> int: ...

    @abstractmethod
    def inv_transform(self, i: int) -> str | tuple[str, ...]: ...

    @abstractmethod
    def one_hot(self, labels: Iterable[str] | str) -> np.ndarray: ...

    @abstractmethod
    def i_to_one_hot(self, i: int) -> np.ndarray: ...

    def __call__(self, labels: str | tuple[str, ...] = ()) -> int:
        return self.transform(labels)

    def __len__(self) -> int:
        raise NotImplementedError

    def __contains__(self, label) -> bool:
        raise NotImplementedError


class MultiLabelEncoder(LabelEncoder):
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

    def one_hot(self, labels: Iterable[str] | str) -> np.ndarray:
        """Multi-hot vector over a set of simultaneously active labels."""
        labels = (labels,) if isinstance(labels, str) else labels
        vec = np.zeros(self.n_labels, dtype=int)
        vec[[self.transform(label) for label in labels]] = 1
        return vec

    def i_to_one_hot(self, i: int) -> np.ndarray:
        return self.one_hot(self.rev_map[i])

    def __len__(self) -> int:
        return self.n_labels

    def __contains__(self, label) -> bool:
        return label in self.map


class PowersetEncoder(LabelEncoder):
    """Powerset multi-class encoder (a copy of the JAX package's): every
    subset of at most ``max_set_size`` simultaneously active labels is one
    class, ordered by set size, class 0 the empty set ("no speaker")."""

    def __init__(self, labels: list[str] | tuple[str, ...], max_set_size: int = 2) -> None:
        from itertools import combinations

        self._base = tuple(labels)
        self.max_set_size = max_set_size
        subsets: list[tuple[str, ...]] = [()]
        for k in range(1, max_set_size + 1):
            subsets.extend(combinations(self._base, k))
        self._subsets = tuple(subsets)
        self.map = {s: i for i, s in enumerate(self._subsets)}
        self.rev_map = {i: s for s, i in self.map.items()}

    @property
    def labels(self) -> tuple[tuple[str, ...], ...]:
        return self._subsets

    @property
    def base_labels(self) -> tuple[str, ...]:
        return self._base

    def _canonical(self, labels) -> tuple[str, ...]:
        """The subset of ``labels`` in vocabulary order, cut to its first
        ``max_set_size`` labels."""
        if isinstance(labels, str):
            labels = (labels,)
        extra = set(labels) - set(self._base)
        if extra:
            raise KeyError(f"unknown labels: {sorted(extra)}")
        return tuple(label for label in self._base if label in set(labels))[: self.max_set_size]

    def transform(self, label: str | tuple[str, ...]) -> int:
        return self.map[self._canonical(label)]

    def inv_transform(self, i: int) -> tuple[str, ...]:
        if not (0 <= i < len(self._subsets)):
            raise ValueError(
                f"transformed index '{i}' is not assigned, only "
                f"{len(self._subsets)} classes are available."
            )
        return self.rev_map[i]

    def one_hot(self, labels: Iterable[str] | str) -> np.ndarray:
        vec = np.zeros(len(self._subsets), dtype=int)
        vec[self.transform(tuple(labels) if not isinstance(labels, str) else labels)] = 1
        return vec

    def i_to_one_hot(self, i: int) -> np.ndarray:
        vec = np.zeros(len(self._subsets), dtype=int)
        vec[i] = 1
        return vec

    @property
    def n_single_classes(self) -> int:
        """Classes holding fewer than two labels (the empty set and the
        singletons): the first ``n_single_classes`` class ids, over which
        the ``partial_*`` validation metrics average."""
        return sum(1 for s in self._subsets if len(s) < 2)

    def membership_matrix(self) -> np.ndarray:
        """(n_classes, n_base) 0/1 f32: subset i holds base label j."""
        member = np.zeros((len(self._subsets), len(self._base)), np.float32)
        for i, subset in enumerate(self._subsets):
            for label in subset:
                member[i, self._base.index(label)] = 1.0
        return member

    def multihot_lut(self) -> np.ndarray:
        """(2**n_base,) int32: multi-hot bitmask (bit j = base label j) ->
        class id; a mask of more than ``max_set_size`` labels maps to its
        first ``max_set_size`` in vocabulary order."""
        n = len(self._base)
        if n > 16:
            raise ValueError("multihot LUT limited to 16 base labels")
        lut = np.zeros(2**n, np.int32)
        for mask in range(2**n):
            lut[mask] = self.map[self._canonical(
                tuple(self._base[j] for j in range(n) if (mask >> j) & 1))]
        return lut

    def __len__(self) -> int:
        return len(self._subsets)
