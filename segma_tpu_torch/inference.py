"""Sliding-window inference over long WAV files (counterpart of
``segma_tpu/inference.py``).

One file goes to the device once as a flat waveform (int16 by default,
normalized there), and the device does:

    pad -> overlap-unfold (two reshapes + concat, no gather)
        -> model forward in inner batches (log-mel and attention kernels)
        -> sigmoid + per-label thresholds -> run boundaries -> packed runs

The host reads WAV bytes, copies O(runs) int32s back and writes RTTM lines
(and, with ``dump_logits``, each file's frame logits for the tuner). File
lengths are bucketed in chunks to powers of two; long files go in segments of
at most ``max_bucket_chunks`` chunks. Files of one bucket and transport dtype
can share a dispatch (``logits_for_audios_async``, ``--pack-files``).

Over a mesh (``mesh=``, ``--mesh auto`` with several cards) every dispatch's
window stack is cut into contiguous blocks, one per data coordinate, in
order (``parallel.mesh``). A data-only mesh has one replica of the model per
coordinate; under ``model`` or ``seq`` each coordinate has ``seq * model``
members, module copies that hold their shards (``parallel.sharding``) and
meet in the collectives of their groups (``parallel.collectives``). Every
member runs its coordinate's block, in the meshless pipeline's inner
batches, on its own card and CUDA stream, from a thread of its own; member
(seq 0, model 0) of each coordinate supplies the block's logits, gathered
in order on the first card, where the decode runs. Buckets hold at least
one chunk per data coordinate.

Transports, the samples copied to the device: int16 (default; exact, half
the bytes of f32), int8 mu-law, f32, and 4-bit block ADPCM (``ops/adpcm``,
0.547 bytes per sample, decoded on the device). Host buffers go to the card
from pinned memory without blocking, and each file's packed decode is queued
right behind its forward with its own CUDA event, so finishing file i waits
for file i alone while the next group's forward runs.

Spans (``telemetry``, recorded while it records): ``serve.load`` (the
prefetch thread, a file), ``serve.queue_wait`` (the dispatching thread
waiting for it), ``serve.dispatch`` (a group) with a ``serve.segment`` per
``_infer`` call (the pad copy, the copy to the device, the forward
enqueued), ``serve.finish`` (a file) with ``serve.decode_wait`` and
``serve.write``; a file's spans carry ``file=<stem>``. Counters:
``serve.chunks_real`` and ``serve.chunks_padded`` (each dispatch's bucket,
the chunks the files need and the rest), ``serve.bytes_to_device``.

``python -m segma_tpu_torch.inference --config ... --wavs ... --output ...``
is the predict CLI (``main``), with the JAX package's flags and ``--device``.

Chunk geometry: stride = chunk_f - missing_n_frames, missing_n_frames =
chunk_f - n_windows * rf_step; the tail is processed iff >= 400 samples
remain; a run of frames [s, e] decodes to [max(0, rf_start(s)), rf_end(e) + 1].
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from math import floor
from pathlib import Path
from typing import TYPE_CHECKING

import numpy as np
import torch

from segma_tpu_torch import resolve_device, telemetry
from segma_tpu_torch.annotation import rttm_line
from segma_tpu_torch.config import Config
from segma_tpu_torch.geometry import ConvolutionSettings
from segma_tpu_torch.ops import cached_constant
from segma_tpu_torch.ops.adpcm import (
    AdpcmAudio, adpcm_decode, adpcm_encode, adpcm_encode_audio, n_blocks,
)
from segma_tpu_torch.parallel.collectives import run_members
from segma_tpu_torch.parallel.mesh import Mesh, auto_mesh, block_bounds, replicate
from segma_tpu_torch.utils.conversions import frames_to_seconds
from segma_tpu_torch.utils.encoders import MultiLabelEncoder
from segma_tpu_torch.utils.io import get_all_samples, get_audio_info, read_pcm16_mono

if TYPE_CHECKING:
    from segma_tpu_torch.models.base import SegmentationModel

TAIL_MIN_SAMPLES = 400
TRANSPORTS = ("int16", "mulaw", "adpcm", "f32")


class Chunkyfier:
    """Sliding-chunk bookkeeping, derived from the chunk length and the
    model's frame step."""

    def __init__(
        self,
        batch_size: int,
        chunk_duration_f: int,
        cnn_settings: ConvolutionSettings,
    ) -> None:
        self.cnn_settings = cnn_settings
        self.chunk_duration_f = chunk_duration_f
        self.batch_size = batch_size
        self.n_windows = cnn_settings.n_windows(chunk_duration_f, strict=True)
        self.missing_n_frames = chunk_duration_f - self.n_windows * cnn_settings.rf_step
        self.chunk_stride = chunk_duration_f - self.missing_n_frames

    def chunk_start_i(self, i: int) -> int:
        return i * self.chunk_stride

    def chunk_end_i(self, i: int) -> int:
        return self.chunk_start_i(i) + self.chunk_duration_f

    def chunk_end_i_coverage(self, i: int) -> int:
        return (i + 1) * self.chunk_stride

    def batch_start_i(self, i: int) -> int:
        return i * self.batch_size * self.chunk_stride

    def batch_end_i(self, i: int) -> int:
        return self.batch_start_i(i) + self.batch_size * self.chunk_duration_f

    def batch_end_i_coverage(self, i: int) -> int:
        return self.batch_end_i(i) - self.batch_size * self.missing_n_frames

    def get_n_fitting_chunks(self, n_frames: int) -> int:
        """Complete overlapped chunks that fit in ``n_frames`` samples."""
        if n_frames < self.chunk_duration_f:
            return 0
        return floor((n_frames - self.chunk_duration_f) / self.chunk_stride) + 1

    def total_frames(
        self, n_frames: int, strict_tail: bool = False, reference_tail: bool = False
    ) -> int:
        """Output frames for a file: full chunks plus the >= 400-sample tail.
        ``reference_tail`` counts a full chunk of frames for the tail (frames
        computed from zero padding)."""
        n_fit = self.get_n_fitting_chunks(n_frames)
        tail_len = n_frames - self.chunk_start_i(n_fit)
        tail_frames = 0
        if tail_len >= TAIL_MIN_SAMPLES:
            if reference_tail:
                tail_frames = self.n_windows
            else:
                tail_frames = self.cnn_settings.n_windows(tail_len, strict=strict_tail)
        return n_fit * self.n_windows + tail_frames


def _bucket(n: int, minimum: int = 1) -> int:
    """Round up to the next power of two."""
    n = max(n, minimum)
    return 1 << (n - 1).bit_length()


def _count_chunks(real: int, dispatched: int) -> None:
    """One dispatch's chunks: ``real`` that a file needs, the rest of the
    ``dispatched`` bucket padding."""
    telemetry.add_counts({"serve.chunks_real": real, "serve.chunks_padded": dispatched - real})


def _expand(audio: torch.Tensor) -> torch.Tensor:
    """int16 PCM, int8 mu-law or f32 samples -> f32 waveform, on the device."""
    if audio.dtype == torch.int8:  # ITU-T G.711 mu-law expansion (mu = 255)
        y = audio.float() * (1.0 / 127.0)
        return torch.sign(y) * (1.0 / 255.0) * (256.0 ** y.abs() - 1.0)
    if audio.dtype == torch.int16:
        return audio.float() * (1.0 / 32768.0)
    if audio.dtype == torch.float32:
        return audio
    raise TypeError(f"unsupported sample dtype {audio.dtype}")


def host_to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``. To a card the copy leaves pinned memory
    without blocking: a pageable copy would wait for every forward queued
    before it."""
    host = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return host
    return host.pin_memory().to(device, non_blocking=True)


@dataclass
class _QueuedDecode:
    """One file's packed run decode, queued on the device: ``packed`` is
    the host copy (pinned on a card), complete once ``event`` has fired."""

    logits: torch.Tensor  # the device grid, for the mask fallback and the dump
    packed: torch.Tensor
    event: torch.cuda.Event | None
    cap: int
    valid: int


@dataclass
class InferencePipeline:
    """Batched inference for one model on one device, or over ``mesh`` (any
    (data, seq, model) shape), whose first device is then the pipeline's
    ``device``.

    ``transport``: "auto" ships buffers as they are (their dtype selects the
    expansion on the device: f32, int16, int8 mu-law, or uint8 ADPCM bytes);
    "adpcm" encodes every other buffer to ADPCM right before the copy."""

    model: SegmentationModel
    batch_size: int = 64
    # long files go in segments of at most this many chunks
    max_bucket_chunks: int = 512
    device: str | torch.device | None = "cuda"
    transport: str = "auto"
    mesh: Mesh | None = None
    frame_settings: ConvolutionSettings = field(init=False)

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        if self.transport not in ("auto", "adpcm"):
            raise ValueError(f"transport must be 'auto' or 'adpcm', got {self.transport!r}")
        if self.mesh is not None:
            if self.mesh.primary.type != self.device.type:
                raise ValueError(f"device {self.device} and the mesh's first device "
                                 f"{self.mesh.primary} differ in type")
            self.device = self.mesh.primary
        if self.model.device != self.device:
            self.model.to(self.device)
        # the members (a (data, seq, model) array of models), their CUDA
        # streams, and a thread for each member: one thread enqueueing every
        # card's inner batches would hold the later cards idle while it
        # enqueues the earlier ones, and a member's collectives wait for its
        # peers; ``replicas`` are the members that supply each data
        # coordinate's logits
        self.members = np.empty((1, 1, 1), dtype=object)
        self.members[0, 0, 0] = self.model
        self._groups = []
        if self.mesh is not None and self.mesh.devices[0].size > 1:
            from segma_tpu_torch.parallel.sharding import member_groups, shard_model

            self.members = shard_model(self.model, self.mesh)
            self._groups = list({g for m in self.members.flat for g in member_groups(m.module)})
        elif self.mesh is not None:
            self.members = np.empty(self.mesh.devices.shape, dtype=object)
            self.members[:, 0, 0] = replicate(self.model, self.mesh)
        self.replicas = list(self.members[:, 0, 0])
        # one dispatch over the members at a time: the pool has a thread per
        # member, and two calls' members waiting at each other's barriers
        # would hold every thread
        self._dispatch = threading.Lock()
        self._pool = self._streams = None
        if self.members.size > 1:
            self._pool = ThreadPoolExecutor(self.members.size, thread_name_prefix="segma-member")
            self._streams = [torch.cuda.Stream(m.device) if m.device.type == "cuda" else None
                             for m in self.members.flat]
        cfg = self.model.config
        step = int(self.model.conv_settings.rf_step)
        self.frame_settings = ConvolutionSettings((step,), (step,), (0,))
        self.chunkyfier = Chunkyfier(
            self.batch_size, cfg.audio.chunk_duration_f, self.frame_settings
        )
        if self.model.n_windows != self.chunkyfier.n_windows:
            raise ValueError(
                f"model produces {self.model.n_windows} frames per "
                f"{cfg.audio.chunk_duration_s}s chunk but the frame grid "
                f"expects {self.chunkyfier.n_windows}; check "
                "audio.strict_frames for this model family"
            )
        # threshold vectors on the device, by value: a copy from the host
        # would wait for the forwards queued before it
        self._thresholds: dict[tuple[float, ...], torch.Tensor] = {}

    # -- device core -------------------------------------------------------------
    def _infer(self, audio: torch.Tensor, n_chunks: int) -> torch.Tensor:
        """audio: (F, n_chunks*stride + chunk_f) samples, or ADPCM bytes of
        that many -> (F, n_chunks*n_w, L). The F files are independent."""
        ck = self.chunkyfier
        stride, chunk_f = ck.chunk_stride, ck.chunk_duration_f
        overlap = chunk_f - stride
        f = audio.shape[0]
        if audio.dtype == torch.uint8:
            audio = adpcm_decode(audio, n_chunks * stride + chunk_f)
        audio = _expand(audio)
        # chunk i = audio[i*stride : (i+1)*stride] ++ the next `overlap` samples
        body = audio[:, : n_chunks * stride].reshape(f, n_chunks, stride)
        nxt = audio[:, stride : (n_chunks + 1) * stride].reshape(f, n_chunks, stride)
        chunks = torch.cat([body, nxt[:, :, :overlap]], dim=2).reshape(f * n_chunks, chunk_f)

        logits = self._forward(chunks) if self._pool else self._batches(self.model, chunks)
        return logits.reshape(f, n_chunks * logits.shape[1], -1)

    @property
    def min_chunks(self) -> int:
        """The smallest bucket: one chunk per data coordinate."""
        return len(self.replicas)

    def _batches(self, model: SegmentationModel, chunks: torch.Tensor) -> torch.Tensor:
        """(N, chunk_f) chunks -> (N, n_w, L) logits, in inner batches of
        ``batch_size`` rows and one batch of the rows left over."""
        total = chunks.shape[0]
        bs = min(self.batch_size, total)
        n_batches = total // bs
        out = [
            model.inference_transform(model.apply(chunks[i * bs : (i + 1) * bs]))
            for i in range(n_batches)
        ]
        rem = total - n_batches * bs
        if rem:
            out.append(model.inference_transform(model.apply(chunks[-rem:])))
        return torch.cat(out)

    def _forward(self, chunks: torch.Tensor) -> torch.Tensor:
        """The window stack over the mesh: contiguous blocks, in order, one
        per data coordinate, each a whole number of inner batches where a
        block holds more than one (so each member runs the meshless
        pipeline's inner batches); every member of a coordinate runs its
        block on its card and stream, from its thread; the first member's
        logits are gathered in order on the first card. A member that
        raises aborts the others' collectives, and its error is raised."""
        primary = self.device
        on_card = primary.type == "cuda"
        main_stream = torch.cuda.current_stream(primary) if on_card else None
        bounds = block_bounds(chunks.shape[0], len(self.replicas), align=self.batch_size)
        per_coordinate = self.members[0].size

        def run(k: int) -> torch.Tensor | None:
            lo, hi = bounds[k // per_coordinate]
            if lo == hi:
                return None
            member, stream = self.members.flat[k], self._streams[k]
            supplies = k % per_coordinate == 0
            if not on_card:
                logits = self._batches(member, chunks[lo:hi])
                return logits if supplies else None
            # this thread's current streams: the caller's on the first card,
            # the member's own on its card; a copy between the two cards
            # orders itself against both, and the member's stream starts
            # after the chunks and ends before the caller's stream goes on
            with torch.cuda.stream(main_stream), torch.cuda.stream(stream):
                stream.wait_stream(main_stream)
                block = chunks[lo:hi]
                block.record_stream(stream)
                logits = self._batches(member, block.to(member.device, non_blocking=True))
                if supplies:
                    logits = logits.to(primary, non_blocking=True)
                main_stream.wait_stream(stream)
            if not supplies:
                return None
            logits.record_stream(main_stream)
            return logits

        with self._dispatch:
            outs = run_members(self._pool, [lambda k=k: run(k) for k in range(self.members.size)],
                               self._groups)
        return torch.cat([out for out in outs if out is not None])

    def _ship(self, padded: np.ndarray) -> torch.Tensor:
        """Host buffer -> device tensor through the transport: uint8 buffers
        are ADPCM bytes already; under ``transport='adpcm'`` anything else is
        encoded here. On a card the copy leaves pinned memory without
        blocking."""
        if self.transport == "adpcm" and padded.dtype != np.uint8:
            # adpcm_encode reads int16 as PCM and floats as [-1, 1]; anything
            # else (an int8 mu-law buffer) would be clipped to +-1 LSB
            if padded.dtype not in (np.int16, np.float32, np.float64):
                raise TypeError(
                    "transport='adpcm' accepts float32/float64 waveforms in "
                    "[-1, 1], int16 PCM, or pre-encoded AdpcmAudio/uint8 "
                    f"blocks — got dtype {padded.dtype} (mu-law int8 must go "
                    "through transport='mulaw')"
                )
            padded = adpcm_encode(padded)
        telemetry.count("serve.bytes_to_device", padded.nbytes)
        return host_to_device(padded, self.device)

    def _n_frames(self, audio: np.ndarray | AdpcmAudio) -> tuple[int, int]:
        """(samples, total frames) of one file."""
        n = audio.n_samples if isinstance(audio, AdpcmAudio) else int(audio.shape[0])
        audio_cfg = self.model.config.audio
        return n, self.chunkyfier.total_frames(
            n, strict_tail=audio_cfg.strict_frames, reference_tail=audio_cfg.reference_tail
        )

    def logits_for_audio_async(
        self, audio: np.ndarray | AdpcmAudio
    ) -> tuple[torch.Tensor | None, int]:
        """Full-file inference. ``audio``: mono (n,) float32 in [-1, 1], int16
        PCM, int8 mu-law, or an ``AdpcmAudio`` (padded with zero blocks here,
        so nothing is encoded at dispatch). Returns (device logits
        (grid_frames, L) or None, total_frames): the first ``total_frames``
        rows are the frames backed by real audio."""
        ck = self.chunkyfier
        n, total_frames = self._n_frames(audio)
        if total_frames == 0:
            return None, 0
        n_chunks_needed = -(-total_frames // ck.n_windows)

        if n_chunks_needed <= self.max_bucket_chunks:
            n_chunks = _bucket(n_chunks_needed, minimum=self.min_chunks)
            _count_chunks(n_chunks_needed, n_chunks)
            padded_len = n_chunks * ck.chunk_stride + ck.chunk_duration_f
            with telemetry.span("serve.segment", chunks=n_chunks):
                if isinstance(audio, AdpcmAudio):
                    padded = audio.block_slice(0, n_blocks(padded_len))[None]
                else:
                    padded = np.zeros((1, padded_len), audio.dtype)
                    padded[0, :n] = audio
                return self._infer(self._ship(padded), n_chunks)[0], total_frames

        # long file: segments of at most max_bucket_chunks chunks (chunks are
        # independent windows, so splitting at chunk boundaries is exact)
        seg_logits: list[torch.Tensor] = []
        start_chunk = 0
        while start_chunk < n_chunks_needed:
            seg_chunks = min(self.max_bucket_chunks, n_chunks_needed - start_chunk)
            n_chunks = _bucket(seg_chunks, minimum=self.min_chunks)
            _count_chunks(seg_chunks, n_chunks)
            padded_len = n_chunks * ck.chunk_stride + ck.chunk_duration_f
            off = start_chunk * ck.chunk_stride
            with telemetry.span("serve.segment", chunks=n_chunks):
                if isinstance(audio, AdpcmAudio):
                    # exact: every model's chunk stride is a multiple of BLOCK
                    seg = audio.block_slice(off, n_blocks(padded_len))[None]
                else:
                    seg = np.zeros((1, padded_len), audio.dtype)
                    take = min(padded_len, max(0, n - off))
                    if take > 0:
                        seg[0, :take] = audio[off : off + take]
                out = self._infer(self._ship(seg), n_chunks)[0]
            seg_logits.append(out[: seg_chunks * ck.n_windows])
            start_chunk += seg_chunks
        logits = torch.cat(seg_logits)
        # re-bucket the row count, as the single-dispatch grid is bucketed
        rows = logits.shape[0]
        target = _bucket(rows)
        if target > rows:
            logits = torch.nn.functional.pad(logits, (0, 0, 0, target - rows))
        return logits, total_frames

    def logits_for_audios_async(
        self, audios: list[np.ndarray | AdpcmAudio], pack_files: int = 8
    ) -> list[tuple[torch.Tensor | None, int]]:
        """Packed dispatch: one ``_infer`` call per group of up to
        ``pack_files`` files that share a chunk bucket and a transport dtype
        (an f32 waveform must never share an int16 buffer). Many short files
        fill inner batches that each would leave mostly padding. Returns per
        file (device logits grid (T, L) or None, total_frames), in input
        order, as ``logits_for_audio_async``."""
        ck = self.chunkyfier
        results: list[tuple[torch.Tensor | None, int]] = [(None, 0)] * len(audios)
        by_bucket: dict[tuple[int, str], list[tuple[int, int]]] = {}
        for i, audio in enumerate(audios):
            _n, total_frames = self._n_frames(audio)
            if total_frames == 0:
                continue
            needed = -(-total_frames // ck.n_windows)
            if needed > self.max_bucket_chunks:
                # a very long file goes in segments on its own
                results[i] = self.logits_for_audio_async(audio)
                continue
            tag = "adpcm" if isinstance(audio, AdpcmAudio) else np.dtype(audio.dtype).str
            by_bucket.setdefault((_bucket(needed, minimum=self.min_chunks), tag), []).append(
                (i, total_frames))

        step = max(1, pack_files)
        for (n_chunks, tag), items in by_bucket.items():
            padded_len = n_chunks * ck.chunk_stride + ck.chunk_duration_f
            for g in range(0, len(items), step):
                group = items[g : g + step]
                real = sum(-(-tf // ck.n_windows) for _i, tf in group)
                _count_chunks(real, len(group) * n_chunks)
                with telemetry.span("serve.segment", chunks=len(group) * n_chunks):
                    if tag == "adpcm":
                        packed = np.stack(
                            [audios[i].block_slice(0, n_blocks(padded_len)) for i, _tf in group]
                        )
                    else:
                        packed = np.zeros((len(group), padded_len), np.dtype(tag))
                        for row, (i, _tf) in enumerate(group):
                            packed[row, : audios[i].shape[0]] = audios[i]
                    logits = self._infer(self._ship(packed), n_chunks)
                for row, (i, tf) in enumerate(group):
                    results[i] = (logits[row], tf)
        return results

    def logits_for_audio(self, audio: np.ndarray | AdpcmAudio) -> np.ndarray:
        """Full-file frame logits (total_frames, n_labels) float32."""
        logits, total_frames = self.logits_for_audio_async(audio)
        if logits is None:
            return np.zeros((0, self.model.n_labels), np.float32)
        return logits[:total_frames].float().cpu().numpy()

    # -- thresholding + decode -----------------------------------------------------
    def _threshold_vector(self, thresholds: dict[str, dict[str, float]]) -> torch.Tensor:
        values = threshold_vector(self.model.label_encoder.base_labels, thresholds)
        return cached_constant(self._thresholds, tuple(values.tolist()),
                               lambda: torch.from_numpy(values).to(self.device))

    def decode_boundaries(
        self, logits: np.ndarray | torch.Tensor, thresholds: dict[str, dict[str, float]]
    ) -> tuple[np.ndarray, np.ndarray]:
        """Thresholding + run-boundary detection on the device: (T, L) bool
        masks of the first and last frame of each run."""
        if logits.shape[0] == 0:
            z = np.zeros(tuple(logits.shape), bool)
            return z, z
        logits = torch.as_tensor(logits).to(self.device)
        _, starts, ends = _decode(logits, self._threshold_vector(thresholds))
        return starts.cpu().numpy(), ends.cpu().numpy()

    def queue_decode(
        self,
        logits: np.ndarray | torch.Tensor,
        thresholds: dict[str, dict[str, float]],
        valid_frames: int | None = None,
    ) -> _QueuedDecode | None:
        """Queue the packed run decode of one grid on the device and its copy
        to the host, without waiting; ``finish_decode`` turns it into
        intervals. None for an empty grid."""
        t = int(logits.shape[0])
        valid = t if valid_frames is None else int(valid_frames)
        if t == 0 or valid == 0:
            return None
        logits = torch.as_tensor(logits).to(self.device)
        cap = decode_capacity(t)
        packed = _decode_packed(logits, self._threshold_vector(thresholds), valid, cap)
        if self.device.type != "cuda":
            return _QueuedDecode(logits, packed, None, cap, valid)
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return _QueuedDecode(logits, host, event, cap, valid)

    def finish_decode(
        self, queued: _QueuedDecode | None, thresholds: dict[str, dict[str, float]]
    ) -> list[tuple[int, int, str]]:
        """Wait for one queued decode alone and unpack its runs to sample
        intervals; a label with more runs than the capacity falls back to
        the exact mask path."""
        if queued is None:
            return []
        if queued.event is not None:
            with telemetry.span("serve.decode_wait"):
                queued.event.synchronize()
        enc = self.model.label_encoder
        intervals = unpack_run_intervals(
            queued.packed.numpy(), queued.cap, enc.base_labels, self.frame_settings
        )
        if intervals is None:  # capacity overflow: exact mask fallback
            starts, ends = self.decode_boundaries(queued.logits[: queued.valid], thresholds)
            return intervals_from_boundaries(starts, ends, self.frame_settings, enc)
        return intervals

    def decode_intervals(
        self,
        logits: np.ndarray | torch.Tensor,
        thresholds: dict[str, dict[str, float]],
        valid_frames: int | None = None,
    ) -> list[tuple[int, int, str]]:
        """Device-side run-length decode -> sample intervals.

        Pass the full bucketed grid plus ``valid_frames``; rows past it are
        forced inactive. Falls back to the exact mask path when a label has
        more runs than the packed capacity."""
        return self.finish_decode(self.queue_decode(logits, thresholds, valid_frames), thresholds)


def _decode(
    logits: torch.Tensor, thr: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Threshold + run-boundary detection: (mask, starts, ends), each (T, L)."""
    mask = torch.sigmoid(logits.float()) > thr[None, :]
    zero = torch.zeros((1, mask.shape[1]), dtype=torch.bool, device=mask.device)
    prev = torch.cat([zero, mask[:-1]])
    nxt = torch.cat([mask[1:], zero])
    return mask, mask & ~prev, mask & ~nxt


def _first_indices(flags: torch.Tensor, cap: int) -> torch.Tensor:
    """(T, L) bool -> (L, cap) int32: per column the first ``cap`` row
    indices where ``flags`` holds, -1 padded (``jnp.nonzero(size=cap)``).

    Each flagged row goes to the slot of its rank in its column (a cumsum),
    rows past the capacity and unflagged rows to one spare slot that is cut
    off: no step waits for the host, as ``nonzero`` would."""
    t, n_labels = flags.shape
    rank = torch.cumsum(flags, dim=0, dtype=torch.int32) - 1
    slot = torch.where(flags & (rank < cap), rank, cap).long()
    rows = torch.arange(t, dtype=torch.int32, device=flags.device)[None, :].expand(n_labels, t)
    out = torch.full((n_labels, cap + 1), -1, dtype=torch.int32, device=flags.device)
    out.scatter_(1, slot.t(), rows)
    return out[:, :cap]


def _decode_packed(
    logits: torch.Tensor, thr: torch.Tensor, valid: int, cap: int
) -> torch.Tensor:
    """Fused threshold + boundary detection + packed run emission.

    Returns one (L, 2*cap + 1) int32 tensor: [count, starts[cap], ends[cap]]
    per label (inclusive frame indices, -1 padded), so the host copies
    O(runs) numbers. Rows at or past ``valid`` are forced inactive."""
    t_idx = torch.arange(logits.shape[0], device=logits.device)[:, None]
    logits = torch.where(t_idx < valid, logits.float(), torch.full_like(logits.float(), -1e9))
    _, starts, ends = _decode(logits, thr)
    counts = starts.sum(dim=0, dtype=torch.int32)
    return torch.cat(
        [counts[:, None], _first_indices(starts, cap), _first_indices(ends, cap)], dim=1
    )


def decode_capacity(rows: int) -> int:
    """Packed-run capacity for a ``rows``-frame grid: one run per 32 frames,
    bucketed; the worst case overflows and falls back to the mask path."""
    return min(_bucket(max(rows // 32, 16)), rows // 2 + 1)


def unpack_run_intervals(
    packed: np.ndarray,
    cap: int,
    labels: list[str] | tuple[str, ...],
    frame_settings: ConvolutionSettings,
) -> list[tuple[int, int, str]] | None:
    """(n_labels, 1+2*cap) packed runs -> sample intervals; None when any
    label overflowed ``cap``."""
    counts, s_idx, e_idx = packed[:, 0], packed[:, 1 : cap + 1], packed[:, cap + 1 :]
    if int(counts.max(initial=0)) > cap:
        return None
    starts, ends = frame_settings.run_bounds(s_idx, e_idx)
    intervals: list[tuple[int, int, str]] = []
    for li, label in enumerate(labels):
        k = int(counts[li])
        intervals.extend(zip(starts[li, :k].tolist(), ends[li, :k].tolist(), [label] * k))
    return intervals


def load_thresholds(thresholds: dict | str | Path | None) -> dict | None:
    """dict passes through; a str/Path loads the tuner's YAML; None stays None."""
    if thresholds is None or isinstance(thresholds, dict):
        return thresholds
    thr_path = Path(thresholds)
    if not thr_path.exists():
        raise ValueError("Path to a valid threshold dict does not exist.")
    import yaml

    with thr_path.open("r") as f:
        return yaml.safe_load(f)


def default_thresholds(labels: tuple[str, ...]) -> dict[str, dict[str, float]]:
    return {label: {"lower_bound": 0.5, "upper_bound": 1.0} for label in labels}


def threshold_vector(
    labels: tuple[str, ...] | list[str], thresholds: dict[str, dict[str, float]]
) -> np.ndarray:
    """Per-label lower bounds in label-encoder order, resolved by name when
    the keys match the label set (insertion order otherwise)."""
    if set(thresholds) == set(labels):
        values = [thresholds[label]["lower_bound"] for label in labels]
    else:
        values = [t["lower_bound"] for t in thresholds.values()]
    return np.asarray(values, np.float32)


def mulaw_compress(audio: np.ndarray) -> np.ndarray:
    """mu-law (G.711, mu=255) companding of f32 [-1, 1] or int16 to int8."""
    if audio.dtype == np.int16:
        x = audio.astype(np.float32) / 32768.0
    else:
        x = np.clip(audio.astype(np.float32), -1.0, 1.0)
    mu = 255.0
    y = np.sign(x) * np.log1p(mu * np.abs(x)) / np.log1p(mu)
    return np.round(y * 127.0).astype(np.int8)


def intervals_from_boundaries(
    starts: np.ndarray,
    ends: np.ndarray,
    conv_settings: ConvolutionSettings,
    label_encoder: MultiLabelEncoder,
) -> list[tuple[int, int, str]]:
    """(T, L) run-boundary masks -> sample intervals."""
    intervals: list[tuple[int, int, str]] = []
    for label_i, label in enumerate(label_encoder.base_labels):
        run_starts = np.flatnonzero(starts[:, label_i])
        run_ends = np.flatnonzero(ends[:, label_i])
        n = min(len(run_starts), len(run_ends))
        lo, hi = conv_settings.run_bounds(run_starts[:n], run_ends[:n])
        intervals.extend(zip(lo.tolist(), hi.tolist(), [label] * n))
    return intervals


def create_intervals(
    thresholded: np.ndarray,
    conv_settings: ConvolutionSettings,
    label_encoder: MultiLabelEncoder,
) -> list[tuple[int, int, str]]:
    """Frame mask (T, L) -> sample intervals [(start_f, end_f, label), ...]."""
    intervals: list[tuple[int, int, str]] = []
    t = thresholded.astype(np.int8)
    padded = np.concatenate(
        [np.zeros((1, t.shape[1]), np.int8), t, np.zeros((1, t.shape[1]), np.int8)]
    )
    diff = np.diff(padded, axis=0)
    for label_i, label in enumerate(label_encoder.base_labels):
        starts = np.flatnonzero(diff[:, label_i] == 1)
        ends = np.flatnonzero(diff[:, label_i] == -1)  # exclusive frame index
        lo, hi = conv_settings.run_bounds(starts, ends - 1)
        intervals.extend(zip(lo.tolist(), hi.tolist(), [label] * len(starts)))
    return intervals


def postprocess_intervals(
    intervals: list[tuple[int, int, str]],
    min_duration_f: int = 0,
    merge_gap_f: int = 0,
) -> list[tuple[int, int, str]]:
    """Merge same-label intervals closer than ``merge_gap_f`` samples, then
    drop intervals shorter than ``min_duration_f`` samples."""
    if merge_gap_f > 0:
        by_label: dict[str, list[tuple[int, int]]] = {}
        for s, e, label in sorted(intervals):
            runs = by_label.setdefault(label, [])
            if runs and s - runs[-1][1] < merge_gap_f:
                runs[-1] = (runs[-1][0], max(runs[-1][1], e))
            else:
                runs.append((s, e))
        intervals = sorted(
            (s, e, label) for label, runs in by_label.items() for s, e in runs
        )
    if min_duration_f > 0:
        intervals = [(s, e, label) for s, e, label in intervals if e - s >= min_duration_f]
    return intervals


def write_intervals(
    intervals: list[tuple[int, int, str]],
    audio_path: Path,
    output_p: Path,
    rttm_dirname: str = "raw_rttm",
) -> Path:
    """Write intervals as RTTM under ``output_p / rttm_dirname``, in one
    write (a file's intervals can number hundreds of thousands, written on
    the serving thread)."""
    rttm_out = output_p / rttm_dirname
    rttm_out.mkdir(exist_ok=True, parents=True)
    uri = audio_path.stem
    out = rttm_out / f"{uri}.rttm"
    out.write_text("".join(
        rttm_line(uri, float(frames_to_seconds(start_f)),
                  float(frames_to_seconds(end_f - start_f)), str(label)) + "\n"
        for start_f, end_f, label in intervals
    ))
    return out


def save_logits(
    logits: np.ndarray,
    label_encoder: MultiLabelEncoder | list[str] | tuple[str, ...],
    output_p: Path,
    uri: str,
) -> Path:
    """Dump one file's (frames, labels) logits for threshold tuning:
    ``output_p/logits/<uri>-logits_dict_t.npz``, one array per label, as the
    JAX package writes them (``tune.load_pred_logits`` reads both)."""
    if isinstance(label_encoder, (list, tuple)):
        labels = list(label_encoder)
    else:
        labels = [label_encoder.inv_transform(i) for i in range(label_encoder.n_labels)]
    logits_out = Path(output_p) / "logits"
    logits_out.mkdir(parents=True, exist_ok=True)
    out = logits_out / f"{uri}-logits_dict_t.npz"
    np.savez(out, **{label: logits[:, i] for i, label in enumerate(labels)})
    return out


def _load_mono(
    audio_path: Path, transport: str = "int16", expect_sr: int | None = None
) -> np.ndarray | AdpcmAudio:
    """Decode one file for the device hop: 'int16' (exact, half the bytes of
    f32), 'mulaw' (int8, lossy), 'adpcm' (an ``AdpcmAudio``, lossy, encoded
    here, on the prefetch thread, so dispatch pads bytes only) or 'f32'.
    ``expect_sr`` rejects files whose rate differs from the model's."""
    if transport not in TRANSPORTS:
        raise ValueError(f"transport must be one of {TRANSPORTS}, got {transport!r}")
    if expect_sr is not None:
        sr = get_audio_info(audio_path).sample_rate
        if sr != expect_sr:
            raise ValueError(
                f"{audio_path}: sample rate {sr} != the model's {expect_sr}"
                " (resample the audio first)"
            )
    raw = read_pcm16_mono(audio_path)
    if raw is not None:
        if transport == "mulaw":
            return mulaw_compress(raw)
        if transport == "adpcm":
            return adpcm_encode_audio(raw)
        if transport == "f32":
            return raw.astype(np.float32) / 32768.0
        return raw
    audio = get_all_samples(audio_path)
    if audio.shape[0] > 1:
        audio = audio.mean(axis=0, keepdims=True)
    mono = audio[0]
    if transport == "mulaw":
        return mulaw_compress(mono)
    if transport == "adpcm":
        return adpcm_encode_audio(mono)
    return mono


def _finish_file(
    pipeline: InferencePipeline,
    audio_path: Path,
    queued: _QueuedDecode | None,
    total_frames: int,
    thresholds: dict,
    output_p: Path,
    rttm_dirname: str,
    min_duration_s: float,
    merge_gap_s: float,
    dump_logits: bool = False,
) -> list[tuple[int, int, str]]:
    """One file's queued decode -> intervals -> RTTM (and its logits for the
    tuner with ``dump_logits``)."""
    with telemetry.span("serve.finish", file=audio_path.stem):
        if dump_logits:
            # the one full (T, L) download: only the tuner's dump needs it
            if queued is None:
                logits = np.zeros((0, pipeline.model.n_labels), np.float32)
            else:
                logits = queued.logits[:total_frames].float().cpu().numpy()
            save_logits(logits, pipeline.model.label_encoder, output_p, audio_path.stem)
        intervals = pipeline.finish_decode(queued, thresholds)
        sr = pipeline.model.config.audio.sample_rate
        with telemetry.span("serve.write", file=audio_path.stem):
            intervals = postprocess_intervals(
                intervals,
                min_duration_f=int(min_duration_s * sr),
                merge_gap_f=int(merge_gap_s * sr),
            )
            write_intervals(intervals, audio_path, output_p, rttm_dirname)
        return intervals


def infer_file(
    audio_path: Path,
    pipeline: InferencePipeline,
    output_p: Path,
    thresholds: dict | None = None,
    dump_logits: bool = False,
    rttm_dirname: str = "raw_rttm",
    audio: np.ndarray | AdpcmAudio | None = None,
    min_duration_s: float = 0.0,
    merge_gap_s: float = 0.0,
) -> list[tuple[int, int, str]]:
    """One file: decode WAV -> device logits -> thresholds -> intervals -> RTTM
    (and the logits under ``output_p/logits`` with ``dump_logits``)."""
    enc = pipeline.model.label_encoder
    if thresholds is None:
        thresholds = default_thresholds(enc.base_labels)
    if audio is None:
        audio = _load_mono(audio_path, expect_sr=pipeline.model.config.audio.sample_rate)
    logits_dev, total_frames = pipeline.logits_for_audio_async(audio)
    queued = None if logits_dev is None else pipeline.queue_decode(
        logits_dev, thresholds, valid_frames=total_frames)
    return _finish_file(
        pipeline, audio_path, queued, total_frames, thresholds, output_p,
        rttm_dirname, min_duration_s, merge_gap_s, dump_logits,
    )


def get_list_of_files_to_process(
    wavs: Path, recursive: bool = False, uris: Path | None = None
) -> tuple[list[Path], int]:
    """Resolve the audio file list from a uri list or a glob."""
    wavs = Path(wavs)
    if not wavs.exists():
        raise FileNotFoundError(f"Path `{wavs=}` does not exists")
    if uris:
        with Path(uris).open("r") as uri_f:
            files = [
                (wavs / uri.strip()).with_suffix(".wav")
                for uri in uri_f.readlines()
                if uri.strip()
            ]
    else:
        files = list(wavs.rglob("*.wav") if recursive else wavs.glob("*.wav"))
    return sorted(files), len(files)


def resolve_mesh(mesh: Mesh | str | None, config: Config, device: torch.device) -> Mesh | None:
    """A ``mesh`` argument of an entry point: "auto" (``parallel.auto_mesh``),
    "off" or None (one card), or a ``parallel.Mesh``."""
    if isinstance(mesh, Mesh) or mesh is None:
        return mesh
    if mesh == "auto":
        return auto_mesh(config, device)
    if mesh == "off":
        return None
    raise ValueError(f"mesh must be 'auto', 'off', None or a Mesh, got {mesh!r}")


def run_inference_on_audios(
    config: Path | str | Config,
    wavs: Path | str,
    checkpoint: Path | str | None,
    output: Path | str,
    uris: Path | str | None = None,
    thresholds: dict | str | Path | None = None,
    batch_size: int = 64,
    recursive: bool = False,
    dump_logits: bool = False,
    rttm_dirname: str = "raw_rttm",
    model: SegmentationModel | None = None,
    min_duration_s: float = 0.0,
    merge_gap_s: float = 0.0,
    transport: str = "int16",
    device: str | torch.device | None = "cuda",
    pack_files: int = 1,
    mesh: Mesh | str | None = "auto",
) -> list[Path]:
    """Batch entry point: inference over ``wavs`` with RTTMs under
    ``output / rttm_dirname``. Returns the files that got an RTTM, in order.

    ``mesh``: "auto" (the default) serves over the config's (data, seq,
    model) mesh of the visible cards when more than one is visible and the
    config asks for more than one device (``parallel.auto_mesh``): each
    dispatch's windows split over ``data``, each coordinate's members
    splitting heads and features over ``model`` and the encoder's time axis
    over ``seq``; "off" or None serves on one card; or a ``parallel.Mesh``.

    The model is ``model`` (which carries its own config), or else the one
    ``checkpoint.load_model_for_inference`` builds from ``config`` (a
    ``Config`` or a YAML path) and ``checkpoint`` (a checkpoint dir, a
    ``best.ckpt`` link or a run dir; None: the random weights of
    ``train.seed``). Passing both ``model`` and ``checkpoint`` raises.
    ``dump_logits`` also writes each file's logits (``save_logits``) for the
    tuner. ``transport`` is one of ``TRANSPORTS``.

    A thread decodes the files ahead into a queue of two while one group of
    ``pack_files`` files (one dispatch, ``logits_for_audios_async``) is on
    the device and the group before it is being written out; a file that
    cannot be decoded is reported and skipped, and the order stays the
    files' order.
    """
    import queue
    import threading
    from collections import deque

    dev = resolve_device(device)
    if transport not in TRANSPORTS:
        raise ValueError(f"transport must be one of {TRANSPORTS}, got {transport!r}")
    output = Path(output)
    thresholds = load_thresholds(thresholds)
    files_to_infer_on, n_files = get_list_of_files_to_process(Path(wavs), recursive, uris)
    if model is not None and checkpoint is not None:
        raise ValueError("pass model= or checkpoint=, not both")
    if model is None:
        from segma_tpu_torch.checkpoint import load_model_for_inference
        from segma_tpu_torch.config import load_config

        cfg = config if isinstance(config, Config) else load_config(config)
        model = load_model_for_inference(cfg, checkpoint, device=dev)
    pipeline = InferencePipeline(
        model, batch_size=batch_size, device=dev,
        transport="adpcm" if transport == "adpcm" else "auto",
        mesh=resolve_mesh(mesh, model.config, dev),
    )
    thr = thresholds or default_thresholds(model.label_encoder.base_labels)
    sr = model.config.audio.sample_rate

    q: queue.Queue = queue.Queue(maxsize=2)
    stop = object()

    def producer() -> None:
        try:
            for audio_path in files_to_infer_on:
                try:
                    with telemetry.span("serve.load", file=audio_path.stem):
                        audio = _load_mono(audio_path, transport, expect_sr=sr)
                    q.put((audio_path, audio, None))
                except Exception as e:  # noqa: BLE001 — one bad file must not end the batch
                    q.put((audio_path, None, e))
        finally:
            q.put(stop)

    threading.Thread(target=producer, daemon=True).start()

    failed: list[Path] = []
    pending: deque = deque()
    group: list[tuple[Path, np.ndarray | AdpcmAudio]] = []
    n_done = 0

    def finalize(item) -> None:
        nonlocal n_done
        audio_path, t0, queued, total_frames = item
        _finish_file(pipeline, audio_path, queued, total_frames, thr, output, rttm_dirname,
                     min_duration_s, merge_gap_s, dump_logits)
        n_done += 1
        print(
            f"[log] - ({n_done:>{len(str(n_files))}}/{n_files}) inference for "
            f"'{audio_path.stem}' in {time.perf_counter() - t0:.2f}s",
            flush=True,
        )

    def dispatch_group() -> None:
        """Queue the buffered files' forwards and decodes, then finish the
        group before them, which waits for that group's decodes alone."""
        if not group:
            return
        t0 = time.perf_counter()
        with telemetry.span("serve.dispatch", file="+".join(path.stem for path, _ in group)):
            if len(group) == 1:
                outs = [pipeline.logits_for_audio_async(group[0][1])]
            else:
                outs = pipeline.logits_for_audios_async([a for _, a in group],
                                                        pack_files=pack_files)
            new = [
                (path, t0, None if lg is None else pipeline.queue_decode(lg, thr, valid_frames=tf),
                 tf)
                for (path, _), (lg, tf) in zip(group, outs)
            ]
        group.clear()
        while pending:
            finalize(pending.popleft())
        pending.extend(new)

    while True:
        with telemetry.span("serve.queue_wait"):
            item = q.get()
        if item is stop:
            break
        audio_path, audio, err = item
        if err is not None:
            failed.append(audio_path)
            print(f"[log] - SKIPPED '{audio_path}': {type(err).__name__}: {err}", flush=True)
            continue
        group.append((audio_path, audio))
        if len(group) >= max(1, pack_files):
            dispatch_group()
    dispatch_group()
    while pending:
        finalize(pending.popleft())
    if failed:
        print(
            f"[log] - WARNING: {len(failed)}/{n_files} files failed to "
            "decode and have no output (listed above)",
            flush=True,
        )
    return [p for p in files_to_infer_on if p not in failed]


def main(argv: list[str] | None = None) -> None:
    """The predict CLI: the JAX package's flags, plus ``--device`` (default
    ``cuda``; ``cpu`` runs the plain path). Exactly one of ``--config`` and
    ``--artifact`` (an exported directory, ``export.run_inference_on_artifact``).
    Unknown arguments are config overrides (``key.path=value``)."""
    import argparse

    from segma_tpu_torch.config import load_config

    parser = argparse.ArgumentParser(description="segma_tpu_torch batch inference")
    parser.add_argument("--config", default=None)
    parser.add_argument("--uris", help="list of uris to use for prediction")
    parser.add_argument("--wavs", required=True)
    parser.add_argument("--checkpoint", default="models/last/best.ckpt")
    parser.add_argument(
        "--artifact", default=None,
        help="predict from an exported artifact directory (cli.export) instead of "
        "config+checkpoint",
    )
    parser.add_argument("--output", required=True)
    parser.add_argument("--thresholds", default=None)
    parser.add_argument("--batch_size", "--batch-size", default=64, type=int)
    parser.add_argument("--save-logits", action="store_true")
    parser.add_argument("--recursive", action="store_true")
    parser.add_argument("--rttm-dirname", default="raw_rttm")
    parser.add_argument(
        "--min-duration", type=float, default=0.0,
        help="drop intervals shorter than this many seconds",
    )
    parser.add_argument(
        "--merge-gap", type=float, default=0.0,
        help="merge same-label intervals separated by less than this many seconds",
    )
    parser.add_argument(
        "--transport", default="int16", choices=["int16", "mulaw", "adpcm", "f32"],
        help="host->device sample encoding (mulaw: 4x fewer bytes than f32; "
        "adpcm: ~7x fewer; both lossy)",
    )
    parser.add_argument(
        "--mesh", default="auto", choices=["auto", "off"],
        help="auto: with several visible cards, the config's (data, seq, model) mesh: "
        "each dispatch's windows split over data (mesh.data: -1 every card, k the first "
        "k coordinates, 1 one), heads and features over mesh.model, the Whisper "
        "encoder's time axis over mesh.seq; off: one card",
    )
    parser.add_argument(
        "--pack-files", type=int, default=1,
        help="pack N files per device dispatch (fills the inner batches that "
        "many short files leave mostly padding)",
    )
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda (the kernels) or cpu (the plain path)")
    args, extra_args = parser.parse_known_args(argv)
    if (args.config is None) == (args.artifact is None):
        parser.error("exactly one of --config or --artifact is required")
    if args.artifact is not None:
        from segma_tpu_torch.export import run_inference_on_artifact

        # an artifact fixes its transport and batch geometry: refuse flags
        # that it would ignore, and config overrides (there is no config)
        unsupported = [
            flag for flag, on in (
                ("--checkpoint", args.checkpoint != parser.get_default("checkpoint")),
                ("--transport", args.transport != "int16"),
                ("--batch_size", args.batch_size != 64),
                ("--mesh", args.mesh != "auto"),
                ("--pack-files", args.pack_files != 1),
            ) if on
        ]
        if unsupported:
            parser.error(f"{', '.join(unsupported)} not supported with --artifact "
                         "(the exported programs fix transport and batch geometry)")
        if extra_args:
            parser.error(f"unrecognized arguments with --artifact: {extra_args}")
        run_inference_on_artifact(
            artifact=args.artifact, wavs=args.wavs, output=Path(args.output), uris=args.uris,
            thresholds=args.thresholds, recursive=args.recursive,
            rttm_dirname=args.rttm_dirname, min_duration_s=args.min_duration,
            merge_gap_s=args.merge_gap, dump_logits=args.save_logits, device=args.device,
        )
        return
    run_inference_on_audios(
        config=load_config(args.config, extra_args),
        uris=args.uris,
        wavs=args.wavs,
        checkpoint=args.checkpoint,
        output=args.output,
        thresholds=args.thresholds,
        batch_size=args.batch_size,
        dump_logits=args.save_logits,
        recursive=args.recursive,
        rttm_dirname=args.rttm_dirname,
        min_duration_s=args.min_duration,
        merge_gap_s=args.merge_gap,
        transport=args.transport,
        device=args.device,
        pack_files=args.pack_files,
        mesh=args.mesh,
    )


if __name__ == "__main__":
    main()
