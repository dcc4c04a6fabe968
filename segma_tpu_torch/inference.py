"""Sliding-window inference over long WAV files (counterpart of
``segma_tpu/inference.py``).

One file goes to the device once as a flat waveform (int16 by default,
normalized there), and the device does:

    pad -> overlap-unfold (two reshapes + concat, no gather)
        -> model forward in inner batches (log-mel and attention kernels)
        -> sigmoid + per-label thresholds -> run boundaries -> packed runs

The host reads WAV bytes, copies O(runs) int32s back and writes RTTM lines.
File lengths are bucketed in chunks to powers of two; long files go in
segments of at most ``max_bucket_chunks`` chunks.

Chunk geometry: stride = chunk_f - missing_n_frames, missing_n_frames =
chunk_f - n_windows * rf_step; the tail is processed iff >= 400 samples
remain; a run of frames [s, e] decodes to [max(0, rf_start(s)), rf_end(e) + 1].
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from math import floor
from pathlib import Path

import numpy as np
import torch

from segma_tpu_torch import resolve_device
from segma_tpu_torch.annotation import AudioAnnotation
from segma_tpu_torch.config import Config
from segma_tpu_torch.models.base import ConvolutionSettings, SegmentationModel
from segma_tpu_torch.utils.conversions import frames_to_seconds
from segma_tpu_torch.utils.encoders import MultiLabelEncoder
from segma_tpu_torch.utils.io import get_all_samples, get_audio_info, read_pcm16_mono

TAIL_MIN_SAMPLES = 400


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


@dataclass
class InferencePipeline:
    """Batched inference for one model on one device."""

    model: SegmentationModel
    batch_size: int = 64
    # long files go in segments of at most this many chunks
    max_bucket_chunks: int = 512
    device: str | torch.device | None = "cuda"
    frame_settings: ConvolutionSettings = field(init=False)

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        if self.model.device != self.device:
            self.model.to(self.device)
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

    # -- device core -------------------------------------------------------------
    def _infer(self, audio: torch.Tensor, n_chunks: int) -> torch.Tensor:
        """audio: (F, n_chunks*stride + chunk_f) -> (F, n_chunks*n_w, L)."""
        ck = self.chunkyfier
        stride, chunk_f = ck.chunk_stride, ck.chunk_duration_f
        overlap = chunk_f - stride
        f = audio.shape[0]
        audio = _expand(audio)
        # chunk i = audio[i*stride : (i+1)*stride] ++ the next `overlap` samples
        body = audio[:, : n_chunks * stride].reshape(f, n_chunks, stride)
        nxt = audio[:, stride : (n_chunks + 1) * stride].reshape(f, n_chunks, stride)
        chunks = torch.cat([body, nxt[:, :, :overlap]], dim=2).reshape(f * n_chunks, chunk_f)

        total = f * n_chunks
        bs = min(self.batch_size, total)
        n_batches = total // bs
        out = [
            self.model.inference_transform(self.model.apply(chunks[i * bs : (i + 1) * bs]))
            for i in range(n_batches)
        ]
        rem = total - n_batches * bs
        if rem:
            out.append(self.model.inference_transform(self.model.apply(chunks[-rem:])))
        logits = torch.cat(out)
        return logits.reshape(f, n_chunks * logits.shape[1], -1)

    def logits_for_audio_async(self, audio: np.ndarray) -> tuple[torch.Tensor | None, int]:
        """Full-file inference. ``audio``: mono (n,) float32 in [-1, 1], int16
        PCM or int8 mu-law. Returns (device logits (grid_frames, L) or None,
        total_frames): the first ``total_frames`` rows are the frames backed
        by real audio."""
        if isinstance(audio, np.ndarray) and audio.dtype == np.uint8:
            raise NotImplementedError("the ADPCM transport is not ported yet")
        ck = self.chunkyfier
        n = int(audio.shape[0])
        audio_cfg = self.model.config.audio
        total_frames = ck.total_frames(
            n, strict_tail=audio_cfg.strict_frames, reference_tail=audio_cfg.reference_tail
        )
        if total_frames == 0:
            return None, 0
        n_chunks_needed = -(-total_frames // ck.n_windows)

        if n_chunks_needed <= self.max_bucket_chunks:
            n_chunks = _bucket(n_chunks_needed)
            padded = np.zeros((1, n_chunks * ck.chunk_stride + ck.chunk_duration_f), audio.dtype)
            padded[0, :n] = audio
            return self._infer(torch.from_numpy(padded).to(self.device), n_chunks)[0], total_frames

        # long file: segments of at most max_bucket_chunks chunks (chunks are
        # independent windows, so splitting at chunk boundaries is exact)
        seg_logits: list[torch.Tensor] = []
        start_chunk = 0
        while start_chunk < n_chunks_needed:
            seg_chunks = min(self.max_bucket_chunks, n_chunks_needed - start_chunk)
            n_chunks = _bucket(seg_chunks)
            padded_len = n_chunks * ck.chunk_stride + ck.chunk_duration_f
            off = start_chunk * ck.chunk_stride
            seg = np.zeros((1, padded_len), audio.dtype)
            take = min(padded_len, max(0, n - off))
            if take > 0:
                seg[0, :take] = audio[off : off + take]
            out = self._infer(torch.from_numpy(seg).to(self.device), n_chunks)[0]
            seg_logits.append(out[: seg_chunks * ck.n_windows])
            start_chunk += seg_chunks
        logits = torch.cat(seg_logits)
        # re-bucket the row count, as the single-dispatch grid is bucketed
        rows = logits.shape[0]
        target = _bucket(rows)
        if target > rows:
            logits = torch.nn.functional.pad(logits, (0, 0, 0, target - rows))
        return logits, total_frames

    def logits_for_audio(self, audio: np.ndarray) -> np.ndarray:
        """Full-file frame logits (total_frames, n_labels) float32."""
        logits, total_frames = self.logits_for_audio_async(audio)
        if logits is None:
            return np.zeros((0, self.model.n_labels), np.float32)
        return logits[:total_frames].float().cpu().numpy()

    # -- thresholding + decode -----------------------------------------------------
    def _threshold_vector(self, thresholds: dict[str, dict[str, float]]) -> torch.Tensor:
        return torch.from_numpy(
            threshold_vector(self.model.label_encoder.base_labels, thresholds)
        ).to(self.device)

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
        enc = self.model.label_encoder
        t = int(logits.shape[0])
        valid = t if valid_frames is None else int(valid_frames)
        if t == 0 or valid == 0:
            return []
        logits = torch.as_tensor(logits).to(self.device)
        cap = decode_capacity(t)
        packed = _decode_packed(logits, self._threshold_vector(thresholds), valid, cap)
        intervals = unpack_run_intervals(
            packed.cpu().numpy(), cap, enc.base_labels, self.frame_settings
        )
        if intervals is None:  # capacity overflow: exact mask fallback
            starts, ends = self.decode_boundaries(logits[:valid], thresholds)
            return intervals_from_boundaries(starts, ends, self.frame_settings, enc)
        return intervals


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
    indices where ``flags`` holds, -1 padded (``jnp.nonzero(size=cap)``)."""
    n_labels = flags.shape[1]
    labels, rows = flags.t().nonzero(as_tuple=True)  # label-major, rows ascending
    counts = torch.bincount(labels, minlength=n_labels)
    rank = torch.arange(labels.numel(), device=flags.device) - (counts.cumsum(0) - counts)[labels]
    keep = rank < cap
    out = torch.full((n_labels, cap), -1, dtype=torch.int32, device=flags.device)
    out[labels[keep], rank[keep]] = rows[keep].to(torch.int32)
    return out


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
    intervals: list[tuple[int, int, str]] = []
    for li, label in enumerate(labels):
        k = int(counts[li])
        for s, e in zip(s_idx[li, :k], e_idx[li, :k]):
            intervals.append((*frame_settings.run_interval(s, e), label))
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
        run_starts = np.where(starts[:, label_i])[0]
        run_ends = np.where(ends[:, label_i])[0]
        for s, e in zip(run_starts, run_ends):
            intervals.append((*conv_settings.run_interval(s, e), label))
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
        starts = np.where(diff[:, label_i] == 1)[0]
        ends = np.where(diff[:, label_i] == -1)[0]  # exclusive frame index
        for s, e in zip(starts, ends):
            intervals.append((*conv_settings.run_interval(s, e - 1), label))
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
    """Write intervals as RTTM under ``output_p / rttm_dirname``."""
    rttm_out = output_p / rttm_dirname
    rttm_out.mkdir(exist_ok=True, parents=True)
    uri = audio_path.stem
    out = rttm_out / f"{uri}.rttm"
    with out.open("w") as rttm_f:
        for start_f, end_f, label in intervals:
            aa = AudioAnnotation(
                uid=uri,
                start_time_s=float(frames_to_seconds(start_f)),
                duration_s=float(frames_to_seconds(end_f - start_f)),
                label=str(label),
            )
            rttm_f.write(aa.to_rttm() + "\n")
    return out


def _load_mono(
    audio_path: Path, transport: str = "int16", expect_sr: int | None = None
) -> np.ndarray:
    """Decode one file for the device hop: 'int16' (exact, half the bytes of
    f32), 'mulaw' (int8, lossy) or 'f32'. ``expect_sr`` rejects files whose
    rate differs from the model's."""
    if transport not in ("int16", "mulaw", "f32"):
        raise NotImplementedError(f"transport {transport!r} is not ported")
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
        if transport == "f32":
            return raw.astype(np.float32) / 32768.0
        return raw
    audio = get_all_samples(audio_path)
    if audio.shape[0] > 1:
        audio = audio.mean(axis=0, keepdims=True)
    mono = audio[0]
    return mulaw_compress(mono) if transport == "mulaw" else mono


def _finish_file(
    pipeline: InferencePipeline,
    audio_path: Path,
    logits_dev: torch.Tensor | None,
    total_frames: int,
    thresholds: dict,
    output_p: Path,
    rttm_dirname: str,
    min_duration_s: float,
    merge_gap_s: float,
) -> list[tuple[int, int, str]]:
    if logits_dev is None:
        logits_dev = np.zeros((0, pipeline.model.n_labels), np.float32)
    intervals = pipeline.decode_intervals(logits_dev, thresholds, valid_frames=total_frames)
    sr = pipeline.model.config.audio.sample_rate
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
    rttm_dirname: str = "raw_rttm",
    audio: np.ndarray | None = None,
    min_duration_s: float = 0.0,
    merge_gap_s: float = 0.0,
) -> list[tuple[int, int, str]]:
    """One file: decode WAV -> device logits -> thresholds -> intervals -> RTTM."""
    enc = pipeline.model.label_encoder
    if thresholds is None:
        thresholds = default_thresholds(enc.base_labels)
    if audio is None:
        audio = _load_mono(audio_path, expect_sr=pipeline.model.config.audio.sample_rate)
    logits_dev, total_frames = pipeline.logits_for_audio_async(audio)
    return _finish_file(
        pipeline, audio_path, logits_dev, total_frames, thresholds, output_p,
        rttm_dirname, min_duration_s, merge_gap_s,
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


def run_inference_on_audios(
    config: Path | str | Config,
    wavs: Path | str,
    checkpoint: Path | str | None,
    output: Path | str,
    uris: Path | str | None = None,
    thresholds: dict | str | Path | None = None,
    batch_size: int = 64,
    recursive: bool = False,
    rttm_dirname: str = "raw_rttm",
    model: SegmentationModel | None = None,
    min_duration_s: float = 0.0,
    merge_gap_s: float = 0.0,
    transport: str = "int16",
    device: str | torch.device | None = "cuda",
) -> list[Path]:
    """Batch entry point: per-file inference over ``wavs`` with RTTMs under
    ``output / rttm_dirname``. Returns the files that got an RTTM, in order.

    ``model`` is required and carries its own config (``config`` is read
    only to build a model from a checkpoint, which is not ported yet), so
    ``checkpoint`` must be None. Files are read and served one after the
    other; a file that cannot be decoded is reported and skipped.
    """
    dev = resolve_device(device)
    output = Path(output)
    thresholds = load_thresholds(thresholds)
    files_to_infer_on, n_files = get_list_of_files_to_process(Path(wavs), recursive, uris)
    if model is None or checkpoint is not None:
        raise NotImplementedError(
            "loading checkpoints is not ported: pass model= and checkpoint=None"
        )
    pipeline = InferencePipeline(model, batch_size=batch_size, device=dev)
    thr = thresholds or default_thresholds(model.label_encoder.base_labels)
    failed: list[Path] = []
    for i, audio_path in enumerate(files_to_infer_on, start=1):
        t0 = time.perf_counter()
        try:
            audio = _load_mono(audio_path, transport, expect_sr=model.config.audio.sample_rate)
        except (ValueError, OSError) as e:
            failed.append(audio_path)
            print(f"[log] - SKIPPED '{audio_path}': {type(e).__name__}: {e}", flush=True)
            continue
        infer_file(
            audio_path, pipeline, output, thresholds=thr, rttm_dirname=rttm_dirname,
            audio=audio, min_duration_s=min_duration_s, merge_gap_s=merge_gap_s,
        )
        print(
            f"[log] - ({i:>{len(str(n_files))}}/{n_files}) inference for "
            f"'{audio_path.stem}' in {time.perf_counter() - t0:.2f}s",
            flush=True,
        )
    if failed:
        print(
            f"[log] - WARNING: {len(failed)}/{n_files} files failed to "
            "decode and have no output (listed above)",
            flush=True,
        )
    return [p for p in files_to_infer_on if p not in failed]
