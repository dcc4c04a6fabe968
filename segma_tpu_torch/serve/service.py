"""The per-model serving core: decode, dispatch, streaming sessions
(counterpart of ``segma_tpu/serve/service.py``).

:class:`SegmentationService` owns one pipeline, a live
:class:`~segma_tpu_torch.inference.InferencePipeline` or an exported
:class:`~segma_tpu_torch.export.ExportedPipeline`, its thresholds, and the
device lock shared by the HTTP threads (and, under bundle serving, by every
model's service).
"""

from __future__ import annotations

import contextlib
import json
import queue
import tempfile
import threading
import time
import uuid
from pathlib import Path
from typing import Any

import numpy as np
import torch

from segma_tpu_torch.annotation import rttm_line
from segma_tpu_torch.inference import _load_mono, default_thresholds
from segma_tpu_torch.serve.stats import _Stats
from segma_tpu_torch.streaming import (
    ChunkForwardBatcher, StreamingSegmenter, make_streaming_forward,
)
from segma_tpu_torch.utils.conversions import frames_to_seconds

# Upload bound: a Content-Length bigger than this is refused with 413 before
# the body is read (one request must not exhaust host RAM). 512 MiB covers
# ~4.5 h of int16 WAV per request; batch the CLI for anything longer.
MAX_BODY_BYTES = 512 << 20

# Streaming sessions hold host buffers and a dict slot until flushed or
# TTL-evicted; an unauthenticated client must not open them without bound.
# Overridable per service (--max-sessions).
MAX_STREAM_SESSIONS = 256


class SessionLimitError(RuntimeError):
    """stream_start refused: the concurrent-session cap is reached. A type of
    its own so that the HTTP layer maps it to 429 Too Many Requests."""


class _MicroBatcher:
    """Group concurrent requests into one packed device dispatch: requests
    arriving within ``window_ms`` of the first queued one (up to
    ``max_batch``) share one ``logits_for_audios_async`` call, the predict
    CLI's ``--pack-files``, which fills inner batches that single short
    requests leave mostly padding."""

    def __init__(self, service: "SegmentationService", window_ms: float, max_batch: int) -> None:
        self.service = service
        self.window_s = window_ms / 1000.0
        self.max_batch = max(1, max_batch)
        self.q: queue.Queue = queue.Queue()
        self.dispatches = 0  # packed dispatches run so far
        threading.Thread(target=self._run, daemon=True).start()

    def submit(self, audio: np.ndarray) -> list[tuple]:
        done = threading.Event()
        box: dict[str, Any] = {}
        self.q.put((audio, done, box))
        done.wait()
        if "err" in box:
            raise box["err"]
        return box["result"]

    def _run(self) -> None:
        while True:
            group = [self.q.get()]
            deadline = time.monotonic() + self.window_s
            while len(group) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    group.append(self.q.get(timeout=remaining))
                except queue.Empty:
                    break
            self.dispatches += 1
            try:
                results = self.service._segment_audios([audio for audio, _, _ in group])
                for (_, done, box), result in zip(group, results):
                    box["result"] = result
                    done.set()
            except Exception as e:  # noqa: BLE001 — each request gets the error
                for _, done, box in group:
                    box["err"] = e
                    done.set()


class SegmentationService:
    """Model + thresholds + device serialization, shared by HTTP threads.
    ``pipeline`` is a live :class:`InferencePipeline` or an
    :class:`~segma_tpu_torch.export.ExportedPipeline`; the serving surface is
    the same, but an artifact serves one request per dispatch (its programs
    are fixed at batch 1) and streams only when it has stream programs."""

    STREAM_TTL_S = 600.0

    def __init__(
        self,
        pipeline: Any,
        thresholds: dict[str, dict[str, float]] | None = None,
        transport: str = "int16",
        batch_window_ms: float = 0.0,
        max_batch: int = 8,
        device_lock: threading.Lock | None = None,
        max_sessions: int = MAX_STREAM_SESSIONS,
    ) -> None:
        self.pipeline = pipeline
        self.max_sessions = max_sessions
        self.exported = not hasattr(pipeline, "model")
        if self.exported:
            m = pipeline.manifest
            self.labels = list(pipeline.labels)
            self.sample_rate = int(m["sample_rate"])
            self.model_name = f"{m['model_name']} (exported artifact)"
            self.thresholds = thresholds or m["thresholds"]
            # uploads decode to int16; prepare() encodes them for the
            # transport the artifact was exported with
            transport = "int16"
        else:
            enc = pipeline.model.label_encoder
            self.labels = list(enc.base_labels)
            self.sample_rate = pipeline.model.config.audio.sample_rate
            self.model_name = pipeline.model.name
            self.thresholds = thresholds or default_thresholds(enc.base_labels)
        self.transport = transport
        self._device_lock = device_lock or threading.Lock()
        self.stats = _Stats()
        # sid -> (segmenter, per-session lock, last use). The per-session lock
        # serializes pushes and flushes of ONE segmenter; concurrency ACROSS
        # sessions is governed by the device lock or the ChunkForwardBatcher
        self._streams: dict[str, tuple] = {}
        self._streams_lock = threading.Lock()
        self._stream_forward = None
        self._batcher = (
            _MicroBatcher(self, batch_window_ms, max_batch) if batch_window_ms > 0 else None
        )

    # -- decode -----------------------------------------------------------------
    @staticmethod
    def _decode_l16(body: bytes, content_type: str) -> np.ndarray:
        """RFC 2586 audio/L16 is big-endian; the non-standard
        ``;endianness=little`` parameter selects s16le. Raw octet-streams
        default to little-endian. Returns native-order int16."""
        ct = content_type.lower()  # media types are case-insensitive
        le = "little" in ct or not ct.startswith("audio/l16")
        return np.frombuffer(body, dtype="<i2" if le else ">i2").astype(np.int16)

    def _audio_from_body(self, body: bytes, content_type: str) -> np.ndarray:
        if content_type.lower().startswith("audio/l16"):
            return self._decode_l16(body, content_type)
        if body[:4] != b"RIFF":
            raise ValueError(
                "body must be a RIFF/WAVE file or raw int16 PCM "
                "(Content-Type: audio/l16)"
            )
        # the WAV reader takes a path: spool the upload to a temporary file
        with tempfile.NamedTemporaryFile(suffix=".wav") as f:
            f.write(body)
            f.flush()
            return _load_mono(Path(f.name), self.transport, expect_sr=self.sample_rate)

    # -- inference ---------------------------------------------------------------
    def _segment_audios(self, audios: list) -> list[list[tuple]]:
        """Decoded audios -> per-audio sorted interval lists, in one packed
        device dispatch when several arrive together."""
        pipe = self.pipeline
        if self.exported:
            # the programs are fixed at one file: no packing across requests,
            # but the lock still serializes the device
            with self._device_lock:
                return [sorted(pipe.segment(a, self.thresholds)) for a in audios]
        with self._device_lock, torch.inference_mode():
            if len(audios) == 1:
                outs = [pipe.logits_for_audio_async(audios[0])]
            else:
                outs = pipe.logits_for_audios_async(audios, pack_files=len(audios))
            queued = [
                None if lg is None else pipe.queue_decode(lg, self.thresholds, valid_frames=tf)
                for lg, tf in outs
            ]
            return [sorted(pipe.finish_decode(q, self.thresholds)) for q in queued]

    def segment(self, body: bytes, content_type: str = "") -> list[tuple]:
        """audio bytes -> sorted [(start_f, end_f, label), ...]."""
        return self.segment_audio(self._audio_from_body(body, content_type))

    def segment_audio(self, audio) -> list[tuple]:
        """decoded audio -> sorted [(start_f, end_f, label), ...]."""
        if self._batcher is not None:
            return self._batcher.submit(audio)
        return self._segment_audios([audio])[0]

    # -- streaming sessions --------------------------------------------------------
    def _pcm_from_body(self, body: bytes, content_type: str) -> np.ndarray:
        """Raw PCM16 push payload (no WAV container mid-stream)."""
        if body[:4] == b"RIFF":
            raise ValueError("stream pushes take raw PCM16 (audio/l16), not WAV files")
        return self._decode_l16(body, content_type)

    def _evict_stale_streams(self) -> None:
        now = time.monotonic()
        for sid in [sid for sid, (_s, _l, ts) in self._streams.items()
                    if now - ts > self.STREAM_TTL_S]:
            self._streams.pop(sid, None)

    def stream_start(self) -> str:
        """Open an online-segmentation session; returns its id."""
        with self._streams_lock:
            self._evict_stale_streams()
            if len(self._streams) >= self.max_sessions:
                raise SessionLimitError(
                    f"{len(self._streams)} streaming sessions open (cap "
                    f"{self.max_sessions}); flush existing sessions or "
                    "raise --max-sessions"
                )
            if self.exported:
                # streams off the artifact's stream programs (ValueError, 400,
                # when it has none); under micro-batching, sessions share its
                # batched programs, whose buckets were fixed at export
                fwd = None
                if self._batcher is not None and self.pipeline.stream_batch_fns:
                    if self._stream_forward is None:
                        self._stream_forward = ChunkForwardBatcher.from_exported(
                            self.pipeline, window_ms=self._batcher.window_s * 1000.0)
                    fwd = self._stream_forward
                seg = self.pipeline.streaming_segmenter(self.thresholds, forward_fn=fwd)
                sid = uuid.uuid4().hex[:16]
                self._streams[sid] = (seg, threading.Lock(), time.monotonic())
                return sid
            if self._stream_forward is None:
                model = self.pipeline.model
                if self._batcher is not None:
                    # micro-batching on: concurrent sessions' chunk forwards
                    # share one padded batched forward
                    self._stream_forward = ChunkForwardBatcher(
                        model, window_ms=self._batcher.window_s * 1000.0,
                        max_batch=self._batcher.max_batch,
                    )
                else:  # one per-chunk forward shared by every session
                    self._stream_forward = make_streaming_forward(model)
            sid = uuid.uuid4().hex[:16]
            seg = StreamingSegmenter(
                self.pipeline.model, self.thresholds, forward_fn=self._stream_forward
            )
            self._streams[sid] = (seg, threading.Lock(), time.monotonic())
        return sid

    def _stream(self, sid: str, claim: bool = False) -> tuple:
        with self._streams_lock:
            self._evict_stale_streams()
            entry = self._streams.get(sid)
            if entry is None:
                raise KeyError(sid)
            seg, lock, _ = entry
            if claim:
                # removed at once: a racing push or second flush gets a clean
                # 404 instead of touching a flushed segmenter
                self._streams.pop(sid)
            else:
                self._streams[sid] = (seg, lock, time.monotonic())
        return seg, lock

    def _dispatch_lock(self) -> Any:
        """Cross-session lock for streaming dispatch. With the
        ChunkForwardBatcher active it is the serialization point itself:
        holding the device lock across push() would starve it of
        concurrent chunks."""
        if isinstance(self._stream_forward, ChunkForwardBatcher):
            return contextlib.nullcontext()
        return self._device_lock

    def stream_push(self, sid: str, body: bytes, content_type: str) -> list:
        """Feed PCM16 samples; returns newly finalized intervals."""
        seg, lock = self._stream(sid)
        samples = self._pcm_from_body(body, content_type)
        with lock, self._dispatch_lock():
            return seg.push(samples)

    def stream_flush(self, sid: str) -> list:
        """Process the tail, close all open runs, end the session."""
        seg, lock = self._stream(sid, claim=True)
        with lock, self._dispatch_lock():
            return seg.flush()

    def stream_discard(self, sid: str) -> None:
        """Drop a session without running the tail forward (error paths with
        no client left to answer); waits out an in-flight push."""
        try:
            _seg, lock = self._stream(sid, claim=True)
        except KeyError:
            return
        with lock:
            pass

    # -- formatting ---------------------------------------------------------------
    def to_json(self, intervals: list[tuple], uri: str) -> bytes:
        return json.dumps(
            {
                "uri": uri,
                "sample_rate": self.sample_rate,
                "intervals": [
                    {
                        "label": label,
                        "start_s": round(float(frames_to_seconds(s, self.sample_rate)), 6),
                        "end_s": round(float(frames_to_seconds(e, self.sample_rate)), 6),
                    }
                    for s, e, label in intervals
                ],
            }
        ).encode()

    def to_rttm(self, intervals: list[tuple], uri: str) -> bytes:
        return "".join(
            rttm_line(uri, float(frames_to_seconds(s, self.sample_rate)),
                      float(frames_to_seconds(e - s, self.sample_rate)), str(label)) + "\n"
            for s, e, label in intervals
        ).encode()

    def health(self) -> bytes:
        from segma_tpu_torch import __version__

        dev = self.pipeline.device
        name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        return json.dumps(
            {
                "status": "ok",
                "version": __version__,
                "model": self.model_name,
                "labels": self.labels,
                "device": f"{dev} ({name})",
            }
        ).encode()
