"""Online (streaming) segmentation with bounded latency (counterpart of
``segma_tpu/streaming.py`` for a live model).

Audio arrives in pushes of any size; whenever a full chunk is available it
goes through the model on the device, its frames are thresholded there with
the offline decode's own op, and intervals are emitted as soon as their runs
close. Open runs stay pending until more audio (or ``flush``) decides them.
Same chunk geometry, tail rule and decode as ``inference``: the intervals
equal the offline pipeline's on the same audio wherever the logits do.

``ChunkForwardBatcher`` groups the chunks of concurrent sessions that arrive
within a window into one padded batched forward. Both classes also run off
an exported artifact (``from_exported``): its stream programs take the
model's place, with the same geometry and decode.
"""

from __future__ import annotations

import queue
import threading
import time
from types import SimpleNamespace
from typing import TYPE_CHECKING, Any, Callable

import numpy as np
import torch

from segma_tpu_torch.inference import (
    TAIL_MIN_SAMPLES, Chunkyfier, default_thresholds, host_to_device, threshold_vector,
)
from segma_tpu_torch.geometry import ConvolutionSettings

if TYPE_CHECKING:
    from segma_tpu_torch.models.base import SegmentationModel


class StreamFlushedError(RuntimeError):
    """push()/flush() called after flush() completed: the session is over.
    A type of its own so that the HTTP layer maps it to 409 Conflict."""


def _chunk_to_f32(chunk: np.ndarray) -> np.ndarray:
    """Host normalization, bit-identical to the device's (x * 2**-15)."""
    if chunk.dtype == np.int16:
        return chunk.astype(np.float32) / 32768.0
    return np.asarray(chunk, np.float32)


def _on_device(chunks: np.ndarray, device: torch.device) -> torch.Tensor:
    """Samples to the device; int16 is normalized there (half the bytes)."""
    x = host_to_device(chunks, device)
    if x.dtype == torch.int16:
        return x.float() * (1.0 / 32768.0)
    return x


def make_streaming_forward(model: SegmentationModel) -> Callable[[np.ndarray], torch.Tensor]:
    """One per-chunk forward ``chunk -> (T, L) logits on the device``,
    shared by every StreamingSegmenter of a server."""

    def forward(chunk: np.ndarray) -> torch.Tensor:
        x = _on_device(np.asarray(chunk)[None], model.device)
        return model.inference_transform(model.apply(x))[0]

    return forward


class ChunkForwardBatcher:
    """Cross-session micro-batcher for streaming chunk forwards.

    Chunks from concurrent sessions that arrive within ``window_ms`` go
    through ONE padded batched forward (rows bucketed to powers of two up to
    ``max_batch``), and each session gets its row. Call-compatible with the
    single-chunk forward: pass an instance as
    ``StreamingSegmenter(forward_fn=...)``. Its thread serializes the
    forwards it runs; it enters ``torch.inference_mode`` itself, as that
    mode belongs to a thread."""

    def __init__(
        self, model: SegmentationModel, window_ms: float = 3.0, max_batch: int = 8
    ) -> None:
        def batch_forward(chunks: np.ndarray, n_real: int) -> torch.Tensor:
            # pad rows ride along: one shape per bucket
            x = _on_device(chunks, model.device)
            return model.inference_transform(model.apply(x))

        buckets, b = [], 1
        while b < max(1, max_batch):
            buckets.append(b)
            b *= 2
        buckets.append(max(1, max_batch))
        self._setup(batch_forward, window_ms, buckets)

    @classmethod
    def from_exported(cls, exported: Any, window_ms: float = 3.0) -> "ChunkForwardBatcher":
        """Batcher over an artifact's stream programs: a group of one runs
        ``stream_int16.pt2`` (or ``stream.pt2`` for f32), larger groups pad
        to the next exported ``stream_batch<b>.pt2`` bucket (the programs'
        shapes are fixed at export)."""
        if not exported.stream_batch_fns:
            raise ValueError(
                "artifact has no batched streaming programs (stream_batch<b>.pt2) "
                "— re-export to enable cross-session batching"
            )
        single_f32, single_i16 = exported.stream_fn, exported.stream_i16_fn
        fns = dict(exported.stream_batch_fns)
        batch_dtype = exported.stream_batch_dtype

        def batch_forward(chunks: np.ndarray, n_real: int) -> torch.Tensor:
            if chunks.dtype != batch_dtype:
                if batch_dtype == np.float32:
                    chunks = _chunk_to_f32(chunks)
                else:
                    # an int16 bucket cannot take a group promoted to f32 (a
                    # session that mixed dtypes): its real rows one by one
                    return torch.stack([single_f32.call(c)
                                        for c in _chunk_to_f32(chunks[:n_real])])
            if chunks.shape[0] == 1:
                if chunks.dtype == np.int16 and single_i16 is not None:
                    return single_i16.call(chunks[0])[None]
                return single_f32.call(_chunk_to_f32(chunks[0]))[None]
            return fns[int(chunks.shape[0])].call(chunks)

        self = cls.__new__(cls)
        self._setup(batch_forward, window_ms, [1, *fns])
        return self

    def _setup(
        self, batch_forward: Callable, window_ms: float, buckets: list[int]
    ) -> None:
        self._batch_forward = batch_forward
        self.window_s = window_ms / 1000.0
        self._bucket_sizes = sorted(set(buckets))
        self.max_batch = self._bucket_sizes[-1]
        self.dispatches = 0  # batched forwards run so far
        self._q: queue.Queue = queue.Queue()
        threading.Thread(target=self._run, daemon=True).start()

    def __call__(self, chunk: np.ndarray) -> torch.Tensor:
        done = threading.Event()
        box: dict = {}
        self._q.put((np.asarray(chunk), done, box))
        done.wait()
        if "err" in box:
            raise box["err"]
        return box["logits"]

    def _bucket(self, n: int) -> int:
        for b in self._bucket_sizes:
            if b >= n:
                return b
        return self.max_batch

    def _run(self) -> None:
        with torch.inference_mode():
            while True:
                group = [self._q.get()]
                deadline = time.monotonic() + self.window_s
                while len(group) < self.max_batch:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        group.append(self._q.get(timeout=remaining))
                    except queue.Empty:
                        break
                self.dispatches += 1
                try:
                    cs = [c for c, _, _ in group]
                    if len({c.dtype for c in cs}) > 1:
                        # sessions may buffer different dtypes: int16 goes to
                        # f32 (exact); a plain stack would mix PCM magnitudes
                        # with [-1, 1] floats
                        cs = [_chunk_to_f32(c) for c in cs]
                    chunks = np.stack(cs)
                    bucket = self._bucket(len(group))
                    if bucket > len(group):  # pad to the bucket's row count
                        pad = np.zeros((bucket - len(group), chunks.shape[1]), chunks.dtype)
                        chunks = np.concatenate([chunks, pad])
                    logits = self._batch_forward(chunks, len(group))
                    for i, (_, done, box) in enumerate(group):
                        box["logits"] = logits[i]
                        done.set()
                except Exception as e:  # noqa: BLE001 — each session gets the error
                    for _, done, box in group:
                        box["err"] = e
                        done.set()


class _ExportedShim:
    """What StreamingSegmenter reads of a model, from an artifact's manifest
    (geometry, labels, device); the forward is the artifact's program."""

    def __init__(self, manifest: dict, device: torch.device) -> None:
        step = int(manifest["rf_step"])
        self.conv_settings = ConvolutionSettings((step,), (step,), (0,))
        self.config = SimpleNamespace(audio=SimpleNamespace(
            chunk_duration_f=int(manifest["chunk_duration_f"]),
            strict_frames=bool(manifest["strict_frames"]),
            reference_tail=bool(manifest["reference_tail"]),
            sample_rate=int(manifest["sample_rate"]),
        ))
        self.label_encoder = SimpleNamespace(base_labels=tuple(manifest["labels"]))
        self.device = device


class StreamingSegmenter:
    """Push samples in, get finalized ``(start_f, end_f, label)`` out."""

    @classmethod
    def from_exported(
        cls,
        exported: Any,
        thresholds: dict[str, dict[str, float]] | None = None,
        forward_fn: Callable | None = None,
    ) -> "StreamingSegmenter":
        """Online segmentation off an ``export.ExportedPipeline`` with stream
        programs: the live segmenter's intervals on the same pushes wherever
        the logits are the same. ``forward_fn`` (``ChunkForwardBatcher.
        from_exported``) shares one dispatcher across segmenters."""
        if exported.stream_fn is None:
            raise ValueError("artifact has no streaming program")
        if forward_fn is None:
            i16 = exported.stream_i16_fn

            def forward_fn(chunk: np.ndarray) -> torch.Tensor:
                chunk = np.asarray(chunk)
                if chunk.dtype == np.int16 and i16 is not None:
                    return i16.call(chunk)  # raw PCM16, normalized in the program
                return exported.stream_fn.call(_chunk_to_f32(chunk))

        return cls(
            _ExportedShim(exported.manifest, exported.device),
            thresholds or exported.manifest["thresholds"],
            forward_fn=forward_fn,
        )

    def __init__(
        self,
        model: SegmentationModel,
        thresholds: dict[str, dict[str, float]] | None = None,
        forward_fn: Callable[[np.ndarray], torch.Tensor] | None = None,
    ) -> None:
        """``forward_fn``: a shared ``chunk -> logits`` forward (one per
        server, ``make_streaming_forward`` or a ``ChunkForwardBatcher``);
        None makes one for this segmenter."""
        self.model = model
        cfg = model.config
        step = int(model.conv_settings.rf_step)
        self.frame_settings = ConvolutionSettings((step,), (step,), (0,))
        self.ck = Chunkyfier(1, cfg.audio.chunk_duration_f, self.frame_settings)
        self.strict_tail = cfg.audio.strict_frames
        enc = model.label_encoder
        thresholds = thresholds or default_thresholds(enc.base_labels)
        # by label name, as the offline pipeline resolves them
        self.thr = threshold_vector(enc.base_labels, thresholds)
        self._thr = torch.from_numpy(self.thr).to(model.device)
        self.labels = enc.base_labels

        self._buffer = np.zeros(0, np.float32)
        self._consumed = 0  # absolute sample index of buffer[0]
        self._n_chunks = 0
        self._open = np.full(len(self.labels), -1, np.int64)  # open-run start frame or -1
        self._n_frames = 0  # frames decoded so far
        self._finalized: list[tuple[int, int, str]] = []
        self._done = False
        self._forward = forward_fn if forward_fn is not None else make_streaming_forward(model)

    # -- internals ---------------------------------------------------------------
    def _emit_frames(self, probs_mask: np.ndarray) -> list[tuple[int, int, str]]:
        """Advance the run state over new frames; return closed intervals.
        Transitions come from a diff of the mask with the carried state
        prepended: O(runs) Python work per chunk."""
        out: list[tuple[int, int, str]] = []
        base = self._n_frames
        carry = (self._open >= 0)[None, :]  # (1, L) open-run state
        diff = np.diff(np.concatenate([carry, probs_mask]).astype(np.int8), axis=0)
        for li, label in enumerate(self.labels):
            opens = np.where(diff[:, li] == 1)[0]
            closes = np.where(diff[:, li] == -1)[0]
            open_start = int(self._open[li])
            # closes pair in order: first with the carried-open run (if any),
            # the rest with this chunk's opens; at most one open is left over
            oi = 0
            for c in closes:
                start = open_start if open_start >= 0 else base + int(opens[oi])
                if open_start >= 0:
                    open_start = -1
                else:
                    oi += 1
                out.append((*self.frame_settings.run_interval(start, base + int(c) - 1), label))
            if oi < len(opens):  # one run left open past the chunk end
                open_start = base + int(opens[oi])
            self._open[li] = open_start
        self._n_frames += probs_mask.shape[0]
        return out

    def _process_chunk(self, chunk: np.ndarray, keep_frames: int) -> np.ndarray:
        """The chunk's first ``keep_frames`` frames thresholded on the device,
        with the offline decode's op: sigmoid(f32 logits) > threshold."""
        with torch.inference_mode():
            logits = self._forward(chunk)
            mask = torch.sigmoid(logits[:keep_frames].float()) > self._thr[None, :]
            return mask.cpu().numpy()

    # -- public API ---------------------------------------------------------------
    def push(self, samples: np.ndarray) -> list[tuple[int, int, str]]:
        """Feed more mono samples (float32 in [-1, 1] or int16 PCM); returns
        newly finalized intervals.

        int16 pushes are buffered and shipped as int16 and normalized on the
        device (bit-identical to the host division, half the bytes). Mixing
        dtypes mid-stream promotes the buffer to f32 (also exact)."""
        if self._done:
            raise StreamFlushedError("flush() already called on this segmenter")
        samples = np.asarray(samples)
        if samples.dtype != np.int16:
            samples = samples.astype(np.float32)
        if self._buffer.size == 0:
            self._buffer = self._buffer.astype(samples.dtype)
        elif samples.dtype != self._buffer.dtype:
            if self._buffer.dtype == np.int16:
                self._buffer = self._buffer.astype(np.float32) / 32768.0
            if samples.dtype == np.int16:
                samples = samples.astype(np.float32) / 32768.0
        self._buffer = np.concatenate([self._buffer, samples])
        out: list[tuple[int, int, str]] = []
        ck = self.ck
        while True:
            chunk_start = ck.chunk_start_i(self._n_chunks)
            avail = self._consumed + self._buffer.shape[0] - chunk_start
            if avail < ck.chunk_duration_f:
                break
            off = chunk_start - self._consumed
            chunk = self._buffer[off : off + ck.chunk_duration_f]
            out.extend(self._emit_frames(self._process_chunk(chunk, ck.n_windows)))
            self._n_chunks += 1
            # drop samples no later chunk needs
            next_start = ck.chunk_start_i(self._n_chunks)
            drop = next_start - self._consumed
            if drop > 0:
                self._buffer = self._buffer[drop:]
                self._consumed = next_start
        self._finalized.extend(out)
        return out

    def flush(self) -> list[tuple[int, int, str]]:
        """Process the tail (>= 400 samples) and close all open runs."""
        if self._done:
            raise StreamFlushedError("flush() already called on this segmenter")
        self._done = True
        ck = self.ck
        out: list[tuple[int, int, str]] = []
        tail_start = ck.chunk_start_i(self._n_chunks)
        tail_len = self._consumed + self._buffer.shape[0] - tail_start
        if tail_len >= TAIL_MIN_SAMPLES:
            if self.model.config.audio.reference_tail:
                # a full chunk of frames computed from zero padding
                tail_frames = ck.n_windows
            else:
                tail_frames = self.frame_settings.n_windows(int(tail_len), strict=self.strict_tail)
            if tail_frames > 0:
                tail = self._buffer[tail_start - self._consumed :]
                chunk = np.zeros(ck.chunk_duration_f, self._buffer.dtype)
                chunk[: tail.shape[0]] = tail
                out.extend(self._emit_frames(self._process_chunk(chunk, tail_frames)))
        # close open runs at the final frame
        for li, label in enumerate(self.labels):
            if self._open[li] >= 0:
                out.append((*self.frame_settings.run_interval(
                    int(self._open[li]), self._n_frames - 1), label))
                self._open[li] = -1
        self._finalized.extend(out)
        return out

    @property
    def intervals(self) -> list[tuple[int, int, str]]:
        """Everything finalized so far."""
        return sorted(self._finalized)
