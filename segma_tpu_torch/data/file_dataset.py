"""On-disk dataset with splits, exclusion, leakage check, validation & cache
(a copy of ``segma_tpu/data/file_dataset.py``; numpy only). Layout:

```
dataset_name/
├── aa/        0000.aa
├── rttm/      0000.rttm
├── uem/       0000.uem          (optional)
├── wav/       0000.wav
├── train.txt  val.txt  test.txt
└── exclude.txt                  (optional)
```
"""

from __future__ import annotations

import pickle
import time
from collections import Counter
from dataclasses import dataclass
from itertools import combinations
from pathlib import Path

import numpy as np

from segma_tpu_torch.config import Config
from segma_tpu_torch.data.intervals import IntervalIndex
from segma_tpu_torch.data.utils import (
    filter_annotations,
    load_annotations,
    load_uris,
    total_annotation_duration_f,
)
from segma_tpu_torch.utils.conversions import frames_to_seconds
from segma_tpu_torch.utils.encoders import MultiLabelEncoder
from segma_tpu_torch.utils.io import get_audio_info

DURATIONS_DTYPE = np.dtype(
    [("audio_duration_f", np.int64), ("annotated_duration_f", np.int64)]
)


class DatasetNotLoadedError(Exception): ...


class URISubsetLeakageError(Exception):
    """Raised when the same uri appears in several subsets (data leakage)."""


class CacheTooOldError(Exception):
    """Raised when the on-disk cache exceeded its TTL."""


@dataclass
class DatasetSubset:
    uris: list[str]
    durations: np.ndarray  # structured DURATIONS_DTYPE
    indexes: list[IntervalIndex]


class SegmaFileDataset:
    """Loads dataset metadata: uri lists per split, per-file durations and
    vectorized annotation interval indexes, with a TTL'd pickle cache."""

    SUBSET_NAMES = ("train", "val", "test")
    CACHE_ROOT = Path(".cache/segma_tpu_torch")  # relative to the working directory

    def __init__(
        self,
        base_p: Path | str,
        classes: list[str],
        chunk_duration_s: float,
        sample_rate: int = 16_000,
    ) -> None:
        self.base_p = Path(base_p)
        if not self.base_p.exists():
            raise FileNotFoundError(
                f"Dataset directory does not exist: `{self.base_p}`"
            )
        self.classes = list(classes)
        self.chunk_duration_s = chunk_duration_s
        self.sample_rate = sample_rate
        self._encoder = MultiLabelEncoder(self.classes)

        self.removed_uris: dict[str, set[str] | list[str]] = {}
        self.subset_to_uris: dict[str, list[str]] = self.load_all_uris()
        # raw-from-disk split content, snapshotted BEFORE _load() filters
        # invalid uris out — the cache key must be stable between the
        # save (post-filter) and a later load (pre-filter)
        self._splits_fingerprint = "|".join(
            f"{name}:{','.join(uris)}"
            for name, uris in sorted(self.subset_to_uris.items())
        )
        self._content_fingerprint = self._fingerprint_files()

        # populated by .load()
        self.subds_to_durations: dict[str, np.ndarray] | None = None
        self.subds_to_indexes: dict[str, list[IntervalIndex]] | None = None

    @classmethod
    def from_config(cls, config: Config) -> "SegmaFileDataset":
        return cls(
            config.data.dataset_path,
            config.data.classes,
            config.audio.chunk_duration_s,
            config.audio.sample_rate,
        )

    # -- uri handling ---------------------------------------------------------
    def check_for_data_leakage(self, subset_to_uris: dict[str, list[str]]) -> None:
        """Pairwise intersection of subsets must be empty."""
        for k1, k2 in combinations(self.SUBSET_NAMES, 2):
            overlap = set(subset_to_uris[k1]) & set(subset_to_uris[k2])
            if overlap:
                raise URISubsetLeakageError(
                    f"uri(s) present in both '{k1}' and '{k2}' splits — "
                    f"train/eval leakage: {sorted(overlap)}"
                )

    def load_all_uris(self) -> dict[str, list[str]]:
        """Load split uri lists, track duplicates, apply exclude.txt."""
        subset_to_uris: dict[str, list[str]] = {}
        for subset in self.SUBSET_NAMES:
            uri_list_p = (self.base_p / subset).with_suffix(".txt")
            uri_list = load_uris(uri_list_p) if uri_list_p.exists() else []
            duplicates = [u for u, n in Counter(uri_list).items() if n > 1]
            if duplicates:
                self.removed_uris[f"duplicate.{subset}"] = duplicates
            subset_to_uris[subset] = uri_list

        exclude_p = self.base_p / "exclude.txt"
        if exclude_p.exists():
            to_remove = set(load_uris(exclude_p))
            subset_to_uris = {
                subset: [u for u in uris if u not in to_remove]
                for subset, uris in subset_to_uris.items()
            }
            self.removed_uris["exclude.txt"] = to_remove

        self.check_for_data_leakage(subset_to_uris)
        return subset_to_uris

    # -- loading ---------------------------------------------------------------
    def _validate_uri(self, num_frames: int, sample_rate: int) -> bool:
        """Audio must be at least one chunk long at the configured rate."""
        return (
            frames_to_seconds(num_frames, sample_rate) >= self.chunk_duration_s
            and sample_rate == self.sample_rate
        )

    def _load(self) -> None:
        subds_to_durations: dict[str, np.ndarray] = {}
        subds_to_indexes: dict[str, list[IntervalIndex]] = {
            subset: [] for subset in self.SUBSET_NAMES
        }
        uris_to_remove: set[str] = set()
        for subset in self.SUBSET_NAMES:
            durations: list[tuple[int, int]] = []
            for uri in self.subset_to_uris[subset]:
                uri_path = (self.wav_p / uri).with_suffix(".wav").resolve()
                info = get_audio_info(uri_path)
                if not self._validate_uri(info.n_samples, info.sample_rate):
                    uris_to_remove.add(uri)
                    continue
                annotations = load_annotations((self.aa_p / uri).with_suffix(".aa"))
                annotations = filter_annotations(annotations, self.classes)
                subds_to_indexes[subset].append(
                    IntervalIndex.from_annotations(annotations, self._encoder)
                )
                durations.append(
                    (
                        info.n_samples,
                        total_annotation_duration_f(annotations, self.sample_rate),
                    )
                )
            subds_to_durations[subset] = np.array(durations, dtype=DURATIONS_DTYPE)

        self.removed_uris["invalid"] = uris_to_remove
        for subset in self.SUBSET_NAMES:
            self.subset_to_uris[subset] = [
                u for u in self.subset_to_uris[subset] if u not in uris_to_remove
            ]
        for subset, uris in self.subset_to_uris.items():
            if len(uris) == 0:
                raise ValueError(
                    f"split '{subset}' has no usable files left: every uri was "
                    f"dropped (shorter than the {self.chunk_duration_s} s chunk, "
                    "wrong sample rate, or no annotations in the configured "
                    "classes)."
                )
        self.subds_to_durations = subds_to_durations
        self.subds_to_indexes = subds_to_indexes

    def load(self, use_cache: bool = True) -> None:
        """Load metadata, preferring a fresh cache when available."""
        if use_cache:
            try:
                self.load_cache()
                return
            except (FileNotFoundError, CacheTooOldError):
                pass
            except Exception as e:  # noqa: BLE001 — a torn cache (killed
                # mid-write, disk corruption) must trigger a rebuild, not
                # crash every run until someone deletes .cache by hand
                from segma_tpu_torch.utils.logging import log

                log(
                    f"WARNING: dataset cache unreadable "
                    f"({type(e).__name__}: {e}); rebuilding"
                )
        self._load()
        if use_cache:
            self.save_cache()

    def is_loaded(self, raises: bool = False) -> bool:
        loaded = (
            self.subds_to_durations is not None and self.subds_to_indexes is not None
        )
        if raises and not loaded:
            raise DatasetNotLoadedError
        return loaded

    # -- cache ------------------------------------------------------------------
    def _fingerprint_files(self) -> str:
        """stat-based digest of every split file's audio + annotation:
        (mtime_ns, size) of ``wav/<uri>.wav`` and ``aa/<uri>.aa`` for all
        uris in the raw splits, so a dataset regenerated in place invalidates
        the cache."""
        import hashlib

        h = hashlib.sha1()
        for uris in (self.subset_to_uris[s] for s in self.SUBSET_NAMES):
            for uri in uris:
                for p in (
                    (self.wav_p / uri).with_suffix(".wav"),
                    (self.aa_p / uri).with_suffix(".aa"),
                ):
                    try:
                        st = p.stat()
                        h.update(f"{uri}|{st.st_mtime_ns}|{st.st_size};".encode())
                    except OSError:
                        h.update(f"{uri}|missing;".encode())
        return h.hexdigest()[:16]

    @property
    def _cache_path(self) -> Path:
        """Cache key: dataset stem + hash of (resolved path, classes, chunk,
        sample rate, split uri lists, per-file content fingerprint)."""
        import hashlib

        # the split lists are part of the key: durations/indexes are stored
        # POSITIONALLY against the uri lists, so an edited/reordered
        # train.txt with a stale cache would silently pair every uri with
        # another file's annotations
        key = hashlib.sha1(
            f"{self.base_p.resolve()}|{sorted(self.classes)}|"
            f"{self.chunk_duration_s}|{self.sample_rate}|"
            f"{self._splits_fingerprint}|{self._content_fingerprint}".encode()
        ).hexdigest()[:10]
        return self.CACHE_ROOT / f"{self.base_p.stem}-{key}"

    def load_cache(self, max_days: float = 2.0) -> None:
        cache_path = self._cache_path
        durations_p = cache_path / "subds_to_durations"
        indexes_p = cache_path / "subds_to_indexes"
        if not durations_p.exists() or not indexes_p.exists():
            raise FileNotFoundError
        now = time.time()
        for p in (durations_p, indexes_p):
            if (now - p.stat().st_mtime) / 86400 > max_days:
                raise CacheTooOldError(f"Cache is older than {max_days} days.")
        with durations_p.open("rb") as bf:
            self.subds_to_durations = pickle.load(bf)
        with indexes_p.open("rb") as bf:
            self.subds_to_indexes = pickle.load(bf)
        # restore the FILTERED uri lists (durations/indexes pair with them
        # positionally; the raw disk lists still contain any invalid uris
        # that _load() dropped before saving)
        uris_p = cache_path / "subset_to_uris"
        if uris_p.exists():
            with uris_p.open("rb") as bf:
                self.subset_to_uris = pickle.load(bf)

    def save_cache(self) -> None:
        import os

        cache_path = self._cache_path
        cache_path.mkdir(parents=True, exist_ok=True)
        payloads = (
            ("subds_to_durations", self.subds_to_durations),
            ("subds_to_indexes", self.subds_to_indexes),
            ("subset_to_uris", self.subset_to_uris),
        )
        # write-then-rename per file: a process killed mid-save leaves the
        # previous entry (or an incomplete set, which load_cache treats as
        # absent), never a torn pickle; the temporary file is this process's
        # own, so the ranks of a world saving at once each rename their own
        for name, payload in payloads:
            tmp = cache_path / f".{name}.{os.getpid()}.tmp"
            with tmp.open("wb") as bf:
                pickle.dump(payload, bf)
            os.replace(tmp, cache_path / name)

    # -- layout ------------------------------------------------------------------
    @property
    def aa_p(self) -> Path:
        return self.base_p / "aa"

    @property
    def wav_p(self) -> Path:
        return self.base_p / "wav"

    def _subset(self, name: str) -> DatasetSubset:
        self.is_loaded(raises=True)
        return DatasetSubset(
            uris=self.subset_to_uris[name],
            durations=self.subds_to_durations[name],
            indexes=self.subds_to_indexes[name],
        )

    @property
    def train(self) -> DatasetSubset:
        return self._subset("train")

    @property
    def val(self) -> DatasetSubset:
        return self._subset("val")

    @property
    def test(self) -> DatasetSubset:
        return self._subset("test")
