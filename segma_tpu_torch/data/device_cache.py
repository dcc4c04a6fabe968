"""Device-resident training audio (counterpart of
``segma_tpu/data/device_cache.py``).

With ``train.data_cache=device`` a subset's audio is uploaded to the
training device once, and a batch carries only ``(crop offsets, labels)``:
the train and eval steps gather the crops on the device. The crops are the
host sampler's exactly (the same rng draws, the same ``x * 2**-15``
normalisation of int16 on the device), so training follows the host path's
trajectory bit for bit.

Layout: the files are concatenated into one flat buffer. Each file's slot is
``max(metadata duration, chunk_f)``, the duration the sampler draws crop
starts from, so the crop of a short or truncated file reads trailing zeros
(the host path's zero padding), never the next file's samples. The buffer is
int16 when every source is mono PCM16, else f32 (PCM16 divided by 32768.0).

Under several processes each data coordinate's ranks build the cache of
its own files and place it on their cards: JAX's row of process d, whose
crops they give.
The dtype is the world's (``force_f32`` when any rank's source is not mono
PCM16). JAX pads the rows to one length to stack them into one global
array; the port's buffers never meet, so none is padded.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from segma_tpu_torch.data.file_dataset import DatasetSubset
from segma_tpu_torch.utils.io import get_samples_in_range, probe_pcm16_mono, read_pcm16_mono

MAX_SAMPLES = 2**31  # offsets are int32, as in the JAX package


class DeviceAudioCache:
    """A flat audio buffer and each file's base offset, built on the host;
    ``place`` uploads it once, ``gather`` cuts crops from it."""

    def __init__(self, host_flat: np.ndarray, bases: np.ndarray, chunk_f: int) -> None:
        self.host_flat = host_flat  # int16 (all sources mono PCM16) or float32
        self.bases = bases  # (n_files,) int32 slot starts
        self.chunk_f = chunk_f
        self.buf: torch.Tensor | None = None
        self._windows: torch.Tensor | None = None

    @classmethod
    def plan(
        cls, subset: DatasetSubset, dataset_path: str | Path, chunk_f: int
    ) -> tuple[bool, list[Path], list[int], list[int], int]:
        """Header probes only, nothing decoded: (any source not mono PCM16,
        paths, slot bases, slot sizes, total samples). Slots are sized from
        the metadata duration the sampler draws crop starts from, not from
        the decoded sample count."""
        wav_dir = Path(dataset_path) / "wav"
        paths = [(wav_dir / uri).with_suffix(".wav") for uri in subset.uris]
        any_f32 = not all(probe_pcm16_mono(p) for p in paths)
        bases: list[int] = []
        slots: list[int] = []
        pos = 0
        for dur in subset.durations["audio_duration_f"]:
            bases.append(pos)
            slot = max(int(dur), chunk_f)  # a short file: a zero-padded slot
            slots.append(slot)
            pos += slot
        return any_f32, paths, bases, slots, pos

    @classmethod
    def plan_nbytes(cls, subset: DatasetSubset, dataset_path: str | Path, chunk_f: int) -> int:
        """The buffer's bytes from header probes alone."""
        any_f32, _, _, _, pos = cls.plan(subset, dataset_path, chunk_f)
        return pos * (4 if any_f32 else 2)

    @classmethod
    def build(
        cls, subset: DatasetSubset, dataset_path: str | Path, chunk_f: int,
        plan: tuple | None = None, force_f32: bool = False,
    ) -> "DeviceAudioCache":
        """Decode each file into its slot. ``plan``: this subset's ``plan``
        result, where the caller already probed the headers. ``force_f32``:
        an f32 buffer even when every source is mono PCM16."""
        any_f32, paths, bases, slots, pos = plan if plan is not None else (
            cls.plan(subset, dataset_path, chunk_f))
        any_f32 = any_f32 or force_f32
        if pos >= MAX_SAMPLES:
            raise ValueError(
                f"device cache would hold {pos} samples (>= 2^31): offsets are int32; "
                "use train.data_cache=host for datasets this large")
        flat = np.zeros(pos, np.float32 if any_f32 else np.int16)
        for path, base, slot in zip(paths, bases, slots):
            if any_f32:
                # one dtype for the buffer: PCM16 divided by 32768.0, the host
                # sampler's division, bit for bit
                full = get_samples_in_range(path, 0, -1)
                a = (full.mean(axis=0) if full.shape[0] > 1 else full[0]).astype(np.float32)
            else:
                a = read_pcm16_mono(path)
            # no crop starts past (duration - chunk_f): samples beyond the
            # slot are unreachable, so the write stops at the slot's end
            n = min(len(a), slot)
            flat[base : base + n] = a[:n]
        return cls(flat, np.asarray(bases, np.int32), chunk_f)

    @property
    def nbytes(self) -> int:
        return int(self.host_flat.nbytes)

    def place(self, device: str | torch.device) -> torch.Tensor:
        """Upload the buffer to ``device`` in one copy; idempotent."""
        if self.buf is None:
            self.buf = torch.from_numpy(self.host_flat).to(device)
            # row o of this view is the crop at offset o: a gather is one
            # index_select of B rows, with no index tensor of B x chunk_f
            n = self.buf.numel() - self.chunk_f + 1
            self._windows = self.buf.as_strided((n, self.chunk_f), (1, 1))
        return self.buf

    def gather(self, offsets: torch.Tensor) -> torch.Tensor:
        """(B,) int32 offsets on the buffer's device -> (B, chunk_f) crops in
        the buffer's dtype, an exact copy of the samples."""
        if self._windows is None:
            raise RuntimeError("place() the cache before gathering from it")
        return torch.index_select(self._windows, 0, offsets)
