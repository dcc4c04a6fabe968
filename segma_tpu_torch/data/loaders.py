"""Training data pipeline: random-crop sampler producing host batches
(counterpart of ``segma_tpu/data/loaders.py``).

Batches are numpy arrays ``x: (B, chunk_f) float32`` and
``y: (B, n_windows, n_labels) float32``; the trainer moves them to the
device, where the model extracts its features. Under
``train.transport=int16`` ``x`` is the raw PCM16 crop, ``(B, chunk_f) int16``,
which the train step normalises on the device (``train.device_waveform``),
half the bytes per batch; a batch with a source that is not PCM16 ships f32. A background thread per
sampler keeps batches ready. The same seed and epoch give the same crops and
targets as the JAX loader, bit for bit (at ``num_workers=1``; with more
workers the port takes their batches in a fixed order, JAX as they come).

Virtual-epoch semantics: ``samples_per_epoch = dataset_multiplier *
max(ceil(total_audio_s / chunk_s), batch_size)``, with drop-last batching.

``train.data_cache`` decides where a subset's audio lives: ``host`` (the
sampler reads each crop), ``device`` (``data.device_cache.DeviceAudioCache``:
the audio is uploaded once, and a batch is ``{"offsets": (B,) int32, "y"}``
from the same rng draws), or ``auto`` (the device within
``train.device_cache_budget_gb``, counted over the train and val subsets
together, and within the host's available RAM, else the host). The
resolution of each subset is the loader's ``data_cache_decision``.

Under a world of several processes (``parallel.distributed``), data
coordinate d of ``data`` (a rank's own, rank r of ``world`` processes, in
a data-parallel world; ``distributed.data_process`` under tensor or
sequence parallelism, where the ``seq * model`` ranks of a coordinate take
the same batches) samples from the files ``uris[d::data]`` with the seed
``seed + 7919 * d`` and yields ``batch_size / data`` crops a batch: JAX's
loader with ``(process_count, process_index) = (data, d)``. The step count
comes from the whole subset, so every rank runs the same number of steps,
as JAX's loader does. The device cache's decision and dtype come from
every coordinate's plan over the whole file list, so the ranks agree on
them.

Not ported yet: host-side feature hooks.
"""

from __future__ import annotations

import queue
import threading
from math import ceil
from pathlib import Path
from typing import Iterator

import numpy as np

from segma_tpu_torch.config import Config
from segma_tpu_torch.data.device_cache import MAX_SAMPLES, DeviceAudioCache
from segma_tpu_torch.data.file_dataset import DatasetSubset, SegmaFileDataset
from segma_tpu_torch.data.intervals import IntervalIndex
from segma_tpu_torch.geometry import ConvolutionSettings
from segma_tpu_torch.parallel.distributed import process_shard
from segma_tpu_torch.utils.conversions import frames_to_seconds, seconds_to_frames
from segma_tpu_torch.utils.encoders import MultiLabelEncoder
from segma_tpu_torch.utils.io import get_samples_in_range, read_pcm16_mono


class DataLoaderError(Exception): ...


class BatchContractError(DataLoaderError):
    """A batch was given to a step built for the other ``data_cache`` mode:
    host batches carry waveforms under ``"x"``, device-cache batches carry
    flat-buffer offsets under ``"offsets"``."""


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


def _mem_available_bytes() -> int | None:
    """The host's MemAvailable in bytes, or None where /proc/meminfo is absent."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        return None
    return None


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
        device_bases: np.ndarray | None = None,
    ) -> None:
        self.uris = subset.uris
        self.durations = subset.durations
        self.indexes = subset.indexes
        self.config = config
        self.label_encoder = label_encoder
        self.transport = config.train.transport
        if self.transport not in ("f32", "int16"):
            raise DataLoaderError(
                f"train.transport must be 'f32' or 'int16', got {self.transport!r}")
        # train.data_cache=device: sample() emits (flat-buffer offset, targets)
        # from the same rng draws instead of reading the waveform
        self._device_bases = device_bases
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
        """One (waveform (chunk_f,), targets (n_windows, L)) pair: the
        waveform in f32, or the raw PCM16 crop under int16 transport; with
        the device cache, the crop's int32 offset in the flat buffer."""
        uri_i = int(self.rng.choice(len(self.uris), p=self._weights))
        high = int(self.durations["audio_duration_f"][uri_i]) - self.chunk_f
        start_f = int(self.rng.integers(low=0, high=max(1, high)))
        if self._device_bases is not None:
            y = windows_to_targets(self.windows + start_f, self.indexes[uri_i])
            return np.int32(self._device_bases[uri_i] + start_f), y
        audio_path = (
            Path(self.config.data.dataset_path) / "wav" / self.uris[uri_i]
        ).with_suffix(".wav")
        waveform = self._read_crop(uri_i, audio_path, start_f)
        if waveform.shape[0] < self.chunk_f:  # guard short tail reads
            waveform = np.pad(waveform, (0, self.chunk_f - waveform.shape[0]))
        y = windows_to_targets(self.windows + start_f, self.indexes[uri_i])
        if waveform.dtype == np.int16:
            return waveform, y
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
                if self.transport == "int16":
                    return np.array(crop)  # raw PCM16, normalised on the device
                return crop.astype(np.float32) / 32768.0
            return np.array(crop, np.float32)
        waveform = get_samples_in_range(audio_path, start_f, self.chunk_f)
        if waveform.shape[0] > 1:  # downmix to mono
            waveform = waveform.mean(axis=0, keepdims=True)
        return waveform[0]

    def sample_batch(self, batch_size: int) -> dict[str, np.ndarray]:
        xs, ys = zip(*(self.sample() for _ in range(batch_size)))
        if self._device_bases is not None:
            return {"offsets": np.stack(xs), "y": np.stack(ys)}
        if any(x.dtype != xs[0].dtype for x in xs):
            # int16 transport over sources of which some are not PCM16: the
            # whole batch in normalised f32, never raw PCM beside [-1, 1]
            xs = [x.astype(np.float32) / 32768.0 if x.dtype == np.int16
                  else np.asarray(x, np.float32) for x in xs]
        return {"x": np.stack(xs), "y": np.stack(ys)}


class PrefetchingLoader:
    """Background-thread batch producer. ``num_workers`` > 1 runs several
    sampler threads, each with its own derived seed, and takes their batches
    in a fixed round-robin order (worker 0's, 1's, ..., then 0's again), so
    the same seeds give the same batch sequence whatever the threads'
    timing: the ranks of a data coordinate under tensor or sequence
    parallelism, each with its own loader, take the same batches. (JAX's
    loader takes them as they arrive; at ``num_workers=1`` both give the
    same sequence.)"""

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
        # set by SegmentationDataLoader: the subset's DeviceAudioCache under
        # train.data_cache=device, and how data_cache=auto resolved
        self.device_cache: DeviceAudioCache | None = None
        self.data_cache_decision: str | None = None

    def __len__(self) -> int:
        return self.n_batches

    def set_epoch(self, epoch: int) -> None:
        """Reseed every worker's sampler from ``(worker seed, epoch)``."""
        for s in (self.sampler, *self.extra_samplers):
            s.reseed(epoch)

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        samplers = [self.sampler] + self.extra_samplers
        # a queue per worker, about ``prefetch`` batches deep together
        depth = max(1, -(-self.prefetch // len(samplers)))
        queues = [queue.Queue(maxsize=depth) for _ in samplers]
        failed = object()
        shares = [self.n_batches // len(samplers)] * len(samplers)
        shares[0] += self.n_batches - sum(shares)

        def producer(sampler, n, q):
            try:
                for _ in range(n):
                    q.put(sampler.sample_batch(self.batch_size))
            except BaseException as e:  # noqa: BLE001 — surfaced in the consumer
                q.put((failed, e))

        for sampler, n, q in zip(samplers, shares, queues):
            threading.Thread(target=producer, args=(sampler, n, q), daemon=True).start()

        for i in range(max(shares)):
            for n, q in zip(shares, queues):
                if i >= n:
                    continue
                item = q.get()
                if isinstance(item, tuple) and len(item) == 2 and item[0] is failed:
                    raise RuntimeError("data loader worker failed") from item[1]
                yield item


def _shard(subset: DatasetSubset, rank: int, world: int) -> DatasetSubset:
    """Rank ``rank``'s files of ``world`` (``distributed.process_shard``)."""
    if world == 1:
        return subset
    return DatasetSubset(*(process_shard(a, rank, world)
                           for a in (subset.uris, subset.durations, subset.indexes)))


class SegmentationDataLoader:
    """Train/val loader factory bound to a loaded ``SegmaFileDataset``."""

    def __init__(
        self,
        dataset: SegmaFileDataset,
        label_encoder: MultiLabelEncoder,
        config: Config,
        conv_settings: ConvolutionSettings,
        seed: int | None = None,
        process: tuple[int, int] | None = None,
    ) -> None:
        """``process``: (data coordinate, data size); the torch.distributed
        world's by default (``distributed.data_process`` under the config's
        mesh), (0, 1) without one."""
        from segma_tpu_torch.parallel import distributed

        self.dataset = dataset
        self.label_encoder = label_encoder
        self.config = config
        self.conv_settings = conv_settings
        self.seed = seed if seed is not None else config.train.seed
        self.rank, self.world = process or distributed.data_process(config)
        # data_cache=auto: the device bytes planned per subset (keyed by its
        # seed offset, train before val), so the budget bounds their sum and
        # building a loader again does not count it twice
        self._planned_device_bytes: dict[int, int] = {}
        if not dataset.is_loaded():
            dataset.load()

    def _loader(self, subset: DatasetSubset, seed_offset: int) -> PrefetchingLoader:
        batch_size = self.config.train.batch_size
        seed = self.seed
        if self.world > 1:
            if batch_size % self.world:
                raise DataLoaderError(
                    f"train.batch_size={batch_size} must divide evenly over "
                    f"{self.world} processes")
            if len(subset.uris) < self.world:
                raise DataLoaderError(
                    f"subset has {len(subset.uris)} files but {self.world} processes — "
                    "every process needs at least one")
            if seed is not None:  # decorrelate the ranks' crop streams
                seed = seed + 7919 * self.rank
        # the step count from the whole subset, equal on every rank
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
        shards = [_shard(subset, r, self.world) for r in range(self.world)]
        subset = shards[self.rank]
        batch_size //= self.world
        device_cache, decision_note = self._resolve_data_cache(shards, self.rank, seed_offset)
        shared_cache = AudioCache(budget_bytes=int(DEFAULT_CACHE_GB * 1e9))

        def make_sampler(worker: int) -> AudioSegmentationSampler:
            return AudioSegmentationSampler(
                subset=subset,
                config=self.config,
                conv_settings=self.conv_settings,
                label_encoder=self.label_encoder,
                seed=None if seed is None else seed + seed_offset + 1000 * worker,
                shared_audio_cache=shared_cache,
                device_bases=None if device_cache is None else device_cache.bases,
            )

        n_workers = max(1, self.config.train.dataloader.num_workers)
        extras = [make_sampler(w) for w in range(1, min(n_workers, n_batches))]
        loader = PrefetchingLoader(make_sampler(0), batch_size, n_batches, extra_samplers=extras)
        loader.device_cache = device_cache
        loader.data_cache_decision = decision_note
        return loader

    def _resolve_data_cache(
        self, shards: list[DatasetSubset], rank: int, seed_offset: int
    ) -> tuple[DeviceAudioCache | None, str | None]:
        """(the device cache of ``shards[rank]`` or None, how ``auto``
        resolved), as the JAX loader resolves ``train.data_cache``: every
        rank plans every rank's shard, so that the decision (from the largest
        buffer) and the buffer's dtype (f32 when any rank's source is not
        PCM16) are the same on every rank."""
        tc = self.config.train
        data_cache = tc.data_cache
        if data_cache not in ("host", "device", "auto"):
            raise DataLoaderError(
                f"train.data_cache must be 'host', 'device' or 'auto', got {data_cache!r}")
        if data_cache == "host":
            return None, None
        chunk_f = self.config.audio.chunk_duration_f
        # header probes only: nothing is decoded before the decision
        plans = [DeviceAudioCache.plan(s, self.config.data.dataset_path, chunk_f)
                 for s in shards]
        any_f32 = any(p[0] for p in plans)
        pos = max(p[4] for p in plans)
        planned = pos * (4 if any_f32 else 2)  # bytes on each rank's card, at most
        note = None
        if data_cache == "device" and pos >= MAX_SAMPLES:
            raise DataLoaderError(
                f"train.data_cache=device: {pos} planned samples exceed the int32 offset "
                "range (2^31) of the device gather; use data_cache=host (or auto, which "
                "resolves to host)")
        if data_cache == "auto":
            self._planned_device_bytes.pop(seed_offset, None)
            budget = int(tc.device_cache_budget_gb * 1e9)
            remaining = budget - sum(self._planned_device_bytes.values())
            # host RAM differs between hosts and over time: only a process
            # alone may ask it
            from segma_tpu_torch.parallel import distributed

            avail = (_mem_available_bytes()
                     if len(shards) == 1 and distributed.world_size() == 1 else None)
            if pos >= MAX_SAMPLES:
                decision = "host"
                reason = (f"{pos} planned samples exceed the int32 offset range (2^31) of "
                          "the device gather")
            elif planned > remaining:
                decision = "host"
                reason = (f"{planned / 1e9:.2f} GB exceeds the remaining budget "
                          f"{max(remaining, 0) / 1e9:.2f} GB (train.device_cache_budget_gb="
                          f"{tc.device_cache_budget_gb} bounds ALL subsets jointly)")
            elif avail is not None and planned > 0.8 * avail:
                # building decodes about the buffer's size into host RAM first
                decision = "host"
                reason = (f"building needs ~{planned / 1e9:.2f} GB host RAM but only "
                          f"{avail / 1e9:.2f} GB is available")
            else:
                decision = "device"
                reason = f"{planned / 1e6:.1f} MB fits the {remaining / 1e9:.1f} GB remaining budget"
                self._planned_device_bytes[seed_offset] = planned
            note = f"auto -> {decision} ({reason})"
            if decision == "host":
                return None, note
        return DeviceAudioCache.build(shards[rank], self.config.data.dataset_path, chunk_f,
                                      plan=plans[rank], force_f32=any_f32), note

    def train_dataloader(self) -> PrefetchingLoader:
        return self._loader(self.dataset.train, seed_offset=0)

    def val_dataloader(self) -> PrefetchingLoader:
        return self._loader(self.dataset.val, seed_offset=1)
