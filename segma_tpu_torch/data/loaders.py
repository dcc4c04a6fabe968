"""Training data pipeline: random-crop sampler producing host batches
(counterpart of ``segma_tpu/data/loaders.py``, host path, one process).

Batches are numpy arrays ``x: (B, chunk_f) float32`` and
``y: (B, n_windows, n_labels) float32``; the trainer moves them to the
device, where the model extracts its features. A background thread per
sampler keeps batches ready. The same seed and epoch give the same crops and
targets as the JAX loader, bit for bit (at ``num_workers=1``, which also
fixes the batch order).

Virtual-epoch semantics: ``samples_per_epoch = dataset_multiplier *
max(ceil(total_audio_s / chunk_s), batch_size)``, with drop-last batching.

Not ported yet: the device audio cache (``train.data_cache=device``), int16
transport, host-side feature hooks and multi-process sharding.
"""

from __future__ import annotations

import queue
import threading
from math import ceil
from pathlib import Path
from typing import Iterator

import numpy as np

from segma_tpu_torch.config import Config
from segma_tpu_torch.data.file_dataset import DatasetSubset, SegmaFileDataset
from segma_tpu_torch.data.intervals import IntervalIndex
from segma_tpu_torch.models.geometry import ConvolutionSettings
from segma_tpu_torch.utils.conversions import frames_to_seconds, seconds_to_frames
from segma_tpu_torch.utils.encoders import MultiLabelEncoder
from segma_tpu_torch.utils.io import get_samples_in_range, read_pcm16_mono


class DataLoaderError(Exception): ...


def generate_frames(
    conv_settings: ConvolutionSettings,
    sample_rate: int,
    chunk_duration_s: float = 2.0,
    strict: bool = True,
) -> np.ndarray:
    """(n_windows, 2) [rf_start, rf_end] per model output frame, clipped to
    the chunk."""
    chunk_duration_f = int(seconds_to_frames(chunk_duration_s, sample_rate))
    n_windows = conv_settings.n_windows(chunk_duration_f, strict=strict)
    return conv_settings.rf_bounds(n_windows).clip(0, chunk_duration_f)


def windows_to_targets(windows: np.ndarray, index: IntervalIndex) -> np.ndarray:
    """Multi-hot targets for (offset) windows — one vectorized query."""
    return index.query_windows(windows)


DEFAULT_CACHE_GB = 8.0


class AudioCache:
    """Thread-safe decoded-audio RAM cache shared by a subset's samplers;
    once the budget is reached, new files are read directly instead."""

    def __init__(self, budget_bytes: int) -> None:
        self.budget = budget_bytes
        self._d: dict[int, np.ndarray] = {}
        self._held = 0
        self._lock = threading.Lock()

    def get(self, key: int) -> np.ndarray | None:
        return self._d.get(key)

    def put(self, key: int, arr: np.ndarray) -> None:
        with self._lock:
            if key in self._d:
                return
            if self._held + arr.nbytes <= self.budget:
                self._d[key] = arr
                self._held += arr.nbytes


class AudioSegmentationSampler:
    """Infinite random-crop sampler over one dataset subset: a file drawn
    with probability proportional to its duration, then a uniform start."""

    def __init__(
        self,
        subset: DatasetSubset,
        config: Config,
        conv_settings: ConvolutionSettings,
        label_encoder: MultiLabelEncoder,
        seed: int | None = None,
        shared_audio_cache: AudioCache | None = None,
    ) -> None:
        self.uris = subset.uris
        self.durations = subset.durations
        self.indexes = subset.indexes
        self.config = config
        self.label_encoder = label_encoder
        self._seed = seed
        self.rng = np.random.default_rng(seed)
        # decoded-audio RAM cache (int16), skipped when the subset exceeds it
        self._audio_cache: AudioCache | None = None
        budget = int(DEFAULT_CACHE_GB * 1e9)
        if int(subset.durations["audio_duration_f"].sum()) * 2 <= budget:
            self._audio_cache = (
                shared_audio_cache if shared_audio_cache is not None else AudioCache(budget)
            )
        if len(self.uris) != self.durations.shape[0]:
            raise DataLoaderError("Mismatch between URIs and durations.")

        self.windows = generate_frames(
            conv_settings=conv_settings,
            sample_rate=config.audio.sample_rate,
            chunk_duration_s=config.audio.chunk_duration_s,
            strict=config.audio.strict_frames,
        )
        self.chunk_f = config.audio.chunk_duration_f
        audio_f = self.durations["audio_duration_f"].astype(np.float64)
        self._weights = audio_f / audio_f.sum()

    @property
    def n_windows(self) -> int:
        return self.windows.shape[0]

    def reseed(self, epoch: int) -> None:
        """Re-derive the crop rng from ``(seed, epoch)``. No-op when unseeded."""
        if self._seed is not None:
            self.rng = np.random.default_rng((self._seed, epoch))

    def sample(self) -> tuple[np.ndarray, np.ndarray]:
        """One (waveform (chunk_f,) f32, targets (n_windows, L)) pair."""
        uri_i = int(self.rng.choice(len(self.uris), p=self._weights))
        high = int(self.durations["audio_duration_f"][uri_i]) - self.chunk_f
        start_f = int(self.rng.integers(low=0, high=max(1, high)))
        audio_path = (
            Path(self.config.data.dataset_path) / "wav" / self.uris[uri_i]
        ).with_suffix(".wav")
        waveform = self._read_crop(uri_i, audio_path, start_f)
        if waveform.shape[0] < self.chunk_f:  # guard short tail reads
            waveform = np.pad(waveform, (0, self.chunk_f - waveform.shape[0]))
        y = windows_to_targets(self.windows + start_f, self.indexes[uri_i])
        return waveform.astype(np.float32), y

    def _read_crop(self, uri_i: int, audio_path: Path, start_f: int) -> np.ndarray:
        """chunk_f mono samples at start_f, from the RAM cache when enabled."""
        if self._audio_cache is not None:
            cached = self._audio_cache.get(uri_i)
            if cached is None:
                raw = read_pcm16_mono(audio_path)
                if raw is None:  # non-PCM16: cache as float32 mono
                    full = get_samples_in_range(audio_path, 0, -1)
                    cached = (full.mean(axis=0) if full.shape[0] > 1 else full[0]).astype(
                        np.float32
                    )
                else:
                    cached = raw
                self._audio_cache.put(uri_i, cached)
            crop = cached[start_f : start_f + self.chunk_f]
            if crop.dtype == np.int16:
                return crop.astype(np.float32) / 32768.0
            return np.array(crop, np.float32)
        waveform = get_samples_in_range(audio_path, start_f, self.chunk_f)
        if waveform.shape[0] > 1:  # downmix to mono
            waveform = waveform.mean(axis=0, keepdims=True)
        return waveform[0]

    def sample_batch(self, batch_size: int) -> dict[str, np.ndarray]:
        xs, ys = zip(*(self.sample() for _ in range(batch_size)))
        return {"x": np.stack(xs), "y": np.stack(ys)}


class PrefetchingLoader:
    """Background-thread batch producer. ``num_workers`` > 1 runs several
    sampler threads, each with its own derived seed; batch ORDER is then
    nondeterministic, so use 1 worker for bit-reproducible runs."""

    def __init__(
        self,
        sampler: AudioSegmentationSampler,
        batch_size: int,
        n_batches: int,
        prefetch: int = 2,
        extra_samplers: list[AudioSegmentationSampler] | None = None,
    ) -> None:
        self.sampler = sampler
        self.batch_size = batch_size
        self.n_batches = n_batches
        self.prefetch = prefetch
        self.extra_samplers = extra_samplers or []

    def __len__(self) -> int:
        return self.n_batches

    def set_epoch(self, epoch: int) -> None:
        """Reseed every worker's sampler from ``(worker seed, epoch)``."""
        for s in (self.sampler, *self.extra_samplers):
            s.reseed(epoch)

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        samplers = [self.sampler] + self.extra_samplers
        q: queue.Queue = queue.Queue(maxsize=max(self.prefetch, len(samplers)))
        stop = object()
        shares = [self.n_batches // len(samplers)] * len(samplers)
        shares[0] += self.n_batches - sum(shares)

        def producer(sampler, n):
            try:
                for _ in range(n):
                    q.put(sampler.sample_batch(self.batch_size))
            except BaseException as e:  # noqa: BLE001 — surfaced in the consumer
                q.put((stop, e))
            finally:
                q.put(stop)

        for sampler, n in zip(samplers, shares):
            threading.Thread(target=producer, args=(sampler, n), daemon=True).start()

        finished = 0
        while finished < len(samplers):
            item = q.get()
            if item is stop:
                finished += 1
                continue
            if isinstance(item, tuple) and len(item) == 2 and item[0] is stop:
                raise RuntimeError("data loader worker failed") from item[1]
            yield item


class SegmentationDataLoader:
    """Train/val loader factory bound to a loaded ``SegmaFileDataset``."""

    def __init__(
        self,
        dataset: SegmaFileDataset,
        label_encoder: MultiLabelEncoder,
        config: Config,
        conv_settings: ConvolutionSettings,
        seed: int | None = None,
    ) -> None:
        self.dataset = dataset
        self.label_encoder = label_encoder
        self.config = config
        self.conv_settings = conv_settings
        self.seed = seed if seed is not None else config.train.seed
        if not dataset.is_loaded():
            dataset.load()

    def _loader(self, subset: DatasetSubset, seed_offset: int) -> PrefetchingLoader:
        batch_size = self.config.train.batch_size
        spe = int(
            self.config.data.dataset_multiplier
            * max(
                ceil(
                    frames_to_seconds(int(subset.durations["audio_duration_f"].sum()))
                    / self.config.audio.chunk_duration_s
                ),
                batch_size,
            )
        )
        n_batches = max(1, spe // batch_size)  # drop_last
        shared_cache = AudioCache(budget_bytes=int(DEFAULT_CACHE_GB * 1e9))

        def make_sampler(worker: int) -> AudioSegmentationSampler:
            return AudioSegmentationSampler(
                subset=subset,
                config=self.config,
                conv_settings=self.conv_settings,
                label_encoder=self.label_encoder,
                seed=None if self.seed is None else self.seed + seed_offset + 1000 * worker,
                shared_audio_cache=shared_cache,
            )

        n_workers = max(1, self.config.train.dataloader.num_workers)
        extras = [make_sampler(w) for w in range(1, min(n_workers, n_batches))]
        return PrefetchingLoader(make_sampler(0), batch_size, n_batches, extra_samplers=extras)

    def train_dataloader(self) -> PrefetchingLoader:
        return self._loader(self.dataset.train, seed_offset=0)

    def val_dataloader(self) -> PrefetchingLoader:
        return self._loader(self.dataset.val, seed_offset=1)
