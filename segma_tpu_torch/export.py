"""Self-contained inference artifacts as ``torch.export`` programs
(counterpart of ``segma_tpu/export.py``).

``export_inference`` freezes a model into a directory of programs, each an
``ExportedProgram`` saved by ``torch.export.save`` with the weights inside:
one whole-pipeline forward per chunk bucket, the fused packed-run decode per
bucket and the streaming forwards, beside a JSON manifest with the chunk
geometry, labels and thresholds. ``ExportedPipeline`` loads the directory in
any process that imports ``segma_tpu_torch.ops`` (the registered ops the
programs name: the log-mel and flash-forward kernels, the LSTM) and
reproduces the live pipeline's numbers without the model registry, a config
or a checkpoint.

Layout::

    manifest.json                  geometry, labels, thresholds, buckets
    <platform>/infer_<n>.pt2       waveform (1, padded_len) -> logits grid
    <platform>/decode_<n>.pt2      logits grid, thresholds, valid -> runs
    <platform>/stream.pt2          one f32 chunk -> frame logits
    <platform>/stream_int16.pt2    one int16 chunk -> frame logits
    <platform>/stream_batch<b>.pt2 b int16 chunks -> frame logits

A platform is ``cuda`` or ``cpu``: a program is traced on that device, and
device-dependent constants are part of its graph, so each platform has its
own programs. A CUDA program records the kernels' ops, a CPU program the
same ops, which run their plain versions there; no switch of lowering is
needed. Programs run under the live pipeline's TF32 scope (``no_tf32``),
since a flag is not part of a graph.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

import segma_tpu_torch.ops  # noqa: F401 — registers the ops the programs name
from segma_tpu_torch import __version__, no_tf32, resolve_device
from segma_tpu_torch.geometry import ConvolutionSettings
from segma_tpu_torch.inference import (
    Chunkyfier,
    _decode_packed,
    create_intervals,
    decode_capacity,
    default_thresholds,
    host_to_device,
    mulaw_compress,
    threshold_vector,
    unpack_run_intervals,
)
from segma_tpu_torch.ops.adpcm import AdpcmAudio, adpcm_encode_audio, encoded_nbytes, n_blocks

FORMAT_VERSION = 1
PROGRAMS = "torch.export"  # the manifest's name for the program format
PLATFORMS = ("cuda", "cpu")
# cross-session streaming batch programs: power-of-two buckets, as the live
# ChunkForwardBatcher's, so a group pads to less than twice its rows
STREAM_BATCHES = (2, 4, 8)
_TRANSPORT_DTYPES = {
    "f32": torch.float32,
    "int16": torch.int16,
    "mulaw": torch.int8,
    "adpcm": torch.uint8,
}


def _bucket_plan(needed: int, buckets: list[int]) -> list[int]:
    """Dispatch plan covering ``needed`` chunks with the exported buckets.

    DP minimizing ``shipped_chunks + OVERHEAD * n_dispatches``: shipped
    chunks model the host->device transfer and OVERHEAD charges each
    dispatch in chunk-equivalents, so the plan neither pads a 60-chunk file
    into the 128 bucket nor shreds an 88-chunk tail into [8]*11: with
    (8,32,128,512), 60 -> [32, 32], 88 -> [32, 32, 32], 127 -> [128].
    Everything above the largest bucket runs as full largest-bucket
    dispatches; the remainder is solved exactly by an iterative DP. The
    plans are the JAX package's.
    """
    OVERHEAD = 8  # chunks of transfer one extra dispatch is "worth"
    buckets = sorted(set(buckets))
    largest = buckets[-1]
    plan: list[int] = []
    while needed >= largest:
        plan.append(largest)
        needed -= largest

    # bottom-up over the remainder: cost[r] -> (total, plan tuple)
    cost: list[tuple[int, tuple[int, ...]]] = [(0, ())]
    for r in range(1, needed + 1):
        best = None
        for b in buckets:
            if b >= r:
                cand = (b + OVERHEAD, (b,))
            else:
                c, tail = cost[r - b]
                cand = (b + OVERHEAD + c, (b, *tail))
            if best is None or cand[0] < best[0]:
                best = cand
        cost.append(best)

    plan.extend(cost[needed][1])
    return plan


class _Traced(torch.nn.Module):
    """``fn`` as a module whose parameters are ``module``'s: what
    ``torch.export`` traces, the weights becoming the program's own."""

    def __init__(self, fn: Callable, module: torch.nn.Module | None = None) -> None:
        super().__init__()
        self.weights = module
        self._fn = fn

    def forward(self, *args: torch.Tensor) -> torch.Tensor:
        return self._fn(*args)


def export_inference(
    model: Any,
    output_dir: Path | str,
    thresholds: dict | None = None,
    buckets: tuple[int, ...] = (8, 32, 128, 512),
    batch_size: int = 64,
    transport: str = "int16",
    platforms: tuple[str, ...] = PLATFORMS,
    model_version: str | None = None,
    stream_batches: tuple[int, ...] = STREAM_BATCHES,
    walls: dict[str, float] | None = None,
) -> Path:
    """Freeze ``model`` (a ``SegmentationModel``, with its current weights)
    into an artifact directory.

    ``platforms``: ``cuda`` and/or ``cpu``; a ``cuda`` export needs a card.
    The model is moved to each platform's device in turn and back to its
    own at the end. ``stream_batches`` sets the cross-session streaming
    buckets (each program holds a copy of the weights; ``()`` ships the
    single-chunk stream programs only). ``walls``, when given, receives
    each program's export wall in seconds, by file name."""
    from segma_tpu_torch.inference import InferencePipeline

    platforms = tuple(platforms)
    unknown = sorted(set(platforms) - set(PLATFORMS))
    if unknown or not platforms:
        raise ValueError(f"platforms must be among {PLATFORMS}, got {platforms}")
    if "cuda" in platforms and not torch.cuda.is_available():
        raise RuntimeError(
            "exporting for the cuda platform needs a CUDA device and none is "
            "available; pass platforms=('cpu',) for a CPU artifact"
        )
    if transport not in _TRANSPORT_DTYPES:
        raise ValueError(f"transport must be one of {sorted(_TRANSPORT_DTYPES)}")
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    enc = model.label_encoder
    thresholds = thresholds or default_thresholds(enc.base_labels)
    buckets = tuple(sorted({int(b) for b in buckets}))
    stream_batches = tuple(sorted({int(b) for b in stream_batches if b > 1}))
    home = model.device
    try:
        for platform in platforms:
            pipe = InferencePipeline(model, batch_size=batch_size, device=platform)
            out = output_dir / platform
            out.mkdir(exist_ok=True)
            _export_programs(pipe, out, buckets, transport, stream_batches, walls)
    finally:
        model.to(home)

    ck = pipe.chunkyfier
    manifest = {
        "format_version": FORMAT_VERSION,
        "framework_version": __version__,
        "model_name": model.name,
        "labels": list(enc.base_labels),
        "sample_rate": model.config.audio.sample_rate,
        "chunk_duration_f": ck.chunk_duration_f,
        "chunk_stride": ck.chunk_stride,
        "n_windows": ck.n_windows,
        "rf_step": int(model.conv_settings.rf_step),
        "strict_frames": model.config.audio.strict_frames,
        "reference_tail": model.config.audio.reference_tail,
        "transport": transport,
        "buckets": list(buckets),
        "decode_caps": {str(n): decode_capacity(n * ck.n_windows) for n in buckets},
        "thresholds": thresholds,
        "platforms": list(platforms),
        # provenance: bundle catalogs and GET /v1/models show these
        "model_version": model_version,
        "created_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "streaming": True,
        "stream_batches": list(stream_batches),
        # stream.pt2 takes f32, stream_int16.pt2 raw PCM16 (normalized in the
        # program), and the stream_batch<b>.pt2 buckets take stream_batch_dtype
        "stream_int16": True,
        "stream_batch_dtype": "int16",
        "programs": PROGRAMS,
    }
    (output_dir / "manifest.json").write_text(json.dumps(manifest, indent=2))
    return output_dir


def _export_programs(
    pipe: Any,
    out: Path,
    buckets: tuple[int, ...],
    transport: str,
    stream_batches: tuple[int, ...],
    walls: dict[str, float] | None,
) -> None:
    """Trace and save one platform's programs, on ``pipe``'s device."""
    model, ck, dev = pipe.model, pipe.chunkyfier, pipe.device
    dtype = _TRANSPORT_DTYPES[transport]

    def save(name: str, fn: Callable, *args: torch.Tensor, weights: bool = True) -> None:
        t0 = time.perf_counter()
        with torch.no_grad():
            program = torch.export.export(
                _Traced(fn, model.module if weights else None), args, strict=False)
        torch.export.save(program, str(out / name))
        if walls is not None:
            walls[f"{out.name}/{name}"] = time.perf_counter() - t0

    for n_chunks in buckets:
        padded_len = n_chunks * ck.chunk_stride + ck.chunk_duration_f
        in_len = encoded_nbytes(padded_len) if transport == "adpcm" else padded_len
        save(f"infer_{n_chunks}.pt2", lambda audio, _n=n_chunks: pipe._infer(audio, _n)[0],
             torch.zeros((1, in_len), dtype=dtype, device=dev))
        rows = n_chunks * ck.n_windows
        save(f"decode_{n_chunks}.pt2",
             lambda logits, thr, valid, _cap=decode_capacity(rows):
             _decode_packed(logits, thr, valid, _cap),
             torch.zeros((rows, model.n_labels), dtype=torch.float32, device=dev),
             torch.zeros((model.n_labels,), dtype=torch.float32, device=dev),
             torch.zeros((), dtype=torch.int32, device=dev), weights=False)

    # the streaming forwards, the live make_streaming_forward's: int16 is
    # normalized in the program (half the bytes of f32 to the device)
    def stream_batch(chunks: torch.Tensor) -> torch.Tensor:
        if chunks.dtype == torch.int16:
            chunks = chunks.float() * (1.0 / 32768.0)
        return model.inference_transform(model.apply(chunks))

    chunk_f = ck.chunk_duration_f
    for name, sdtype in (("stream.pt2", torch.float32), ("stream_int16.pt2", torch.int16)):
        save(name, lambda chunk: stream_batch(chunk[None])[0],
             torch.zeros((chunk_f,), dtype=sdtype, device=dev))
    for b in stream_batches:
        save(f"stream_batch{b}.pt2", stream_batch,
             torch.zeros((b, chunk_f), dtype=torch.int16, device=dev))


class Program:
    """One saved program, run on ``device`` under the live pipeline's TF32
    scope and without autograd. ``call`` takes host arrays or device
    tensors and returns the program's output on the device."""

    def __init__(self, path: Path, device: torch.device) -> None:
        self.path = path
        self.device = device
        self.exported = torch.export.load(str(path))
        self._module = self.exported.module()

    def call(self, *args: np.ndarray | torch.Tensor) -> torch.Tensor:
        xs = [a if isinstance(a, torch.Tensor) else host_to_device(a, self.device)
              for a in args]
        with no_tf32(), torch.inference_mode():
            return self._module(*xs)


@dataclass
class ExportedPipeline:
    """Serve an exported artifact directory (no model registry needed)."""

    manifest: dict
    infer_fns: dict  # n_chunks -> Program
    decode_fns: dict  # n_chunks -> Program
    stream_fn: Program | None = None  # f32 chunk forward
    stream_batch_fns: dict | None = None  # batch size -> Program
    stream_i16_fn: Program | None = None  # int16 chunk forward
    device: torch.device = torch.device("cuda")

    @classmethod
    def load(cls, artifact_dir: Path | str, device: str | torch.device = "cuda"
             ) -> "ExportedPipeline":
        """Load the programs of ``device``'s platform (``cuda`` by default;
        ``device="cpu"`` for the CPU ones). Raises ``ValueError`` on a newer
        format, a JAX artifact, or a platform the artifact lacks."""
        artifact_dir = Path(artifact_dir)
        manifest = json.loads((artifact_dir / "manifest.json").read_text())
        if manifest["format_version"] > FORMAT_VERSION:
            raise ValueError(
                f"artifact format {manifest['format_version']} is newer than "
                f"this build ({FORMAT_VERSION})"
            )
        if manifest.get("programs") != PROGRAMS:
            jax_programs = sorted(p.name for p in artifact_dir.glob("*.jaxexp"))
            raise ValueError(
                f"{artifact_dir} is not a torch.export artifact"
                + (f": it is a JAX artifact (StableHLO programs {jax_programs[:3]}...), "
                   "which only segma_tpu serves; export the model with "
                   "segma_tpu_torch.export" if jax_programs else
                   f" (manifest 'programs': {manifest.get('programs')!r})")
            )
        dev = resolve_device(device)
        if dev.type not in manifest["platforms"]:
            raise ValueError(
                f"artifact {artifact_dir} has no {dev.type} programs (platforms "
                f"{manifest['platforms']}); export it with platforms including "
                f"{dev.type!r}"
            )
        root = artifact_dir / dev.type

        def program(name: str) -> Program | None:
            return Program(root / name, dev) if (root / name).is_file() else None

        return cls(
            manifest,
            {n: Program(root / f"infer_{n}.pt2", dev) for n in manifest["buckets"]},
            {n: Program(root / f"decode_{n}.pt2", dev) for n in manifest["buckets"]},
            program("stream.pt2"),
            {int(b): p for b in manifest.get("stream_batches", [])
             if (p := program(f"stream_batch{b}.pt2")) is not None},
            program("stream_int16.pt2"),
            dev,
        )

    @property
    def supports_streaming(self) -> bool:
        return self.stream_fn is not None

    @property
    def stream_batch_dtype(self) -> np.dtype:
        """Input dtype of the ``stream_batch<b>.pt2`` buckets: int16, or f32
        where the manifest does not say (the one decode of its key)."""
        return np.dtype(
            np.int16 if self.manifest.get("stream_batch_dtype") == "int16" else np.float32
        )

    def streaming_segmenter(
        self, thresholds: dict | None = None, forward_fn: Callable | None = None
    ) -> Any:
        """Online segmentation off the artifact's stream programs, the
        contract of ``StreamingSegmenter(model, ...)``; ``forward_fn`` shares
        one cross-session dispatcher (``ChunkForwardBatcher.from_exported``)."""
        from segma_tpu_torch.streaming import StreamingSegmenter

        if self.stream_fn is None:
            raise ValueError(
                "this artifact was exported without a streaming program "
                "(stream.pt2) — re-export with a current build to enable /v1/stream/*"
            )
        return StreamingSegmenter.from_exported(
            self, thresholds or self.manifest["thresholds"], forward_fn
        )

    # -- geometry ---------------------------------------------------------------
    @property
    def labels(self) -> list[str]:
        return self.manifest["labels"]

    @property
    def frame_settings(self) -> ConvolutionSettings:
        step = self.manifest["rf_step"]
        return ConvolutionSettings((step,), (step,), (0,))

    def _chunkyfier(self) -> Chunkyfier:
        return Chunkyfier(1, self.manifest["chunk_duration_f"], self.frame_settings)

    # -- inference ----------------------------------------------------------------
    def prepare(self, audio: np.ndarray) -> np.ndarray | AdpcmAudio:
        """Encode a decoded waveform (f32 [-1, 1] or int16) for the
        artifact's transport. Takes 1-D mono or (channels, n): several
        channels are downmixed, as ``inference._load_mono`` does."""
        if audio.ndim == 2:
            if audio.shape[0] > 1:
                was_int16 = audio.dtype == np.int16
                audio = audio.astype(np.float32).mean(axis=0)
                if was_int16:  # back to [-1, 1]: the mean is int16-scaled
                    audio = audio / 32768.0
            else:
                audio = audio[0]
        transport = self.manifest["transport"]
        if transport == "adpcm":
            return adpcm_encode_audio(audio)
        if transport == "mulaw":
            return mulaw_compress(audio)
        if transport == "int16":
            if audio.dtype == np.int16:
                return audio
            return np.rint(np.clip(audio, -1, 1) * 32767).astype(np.int16)
        return (audio.astype(np.float32) / 32768.0 if audio.dtype == np.int16
                else audio.astype(np.float32))

    def logits_for_audio(self, audio: np.ndarray | AdpcmAudio) -> np.ndarray:
        """Full-file frame logits (total_frames, n_labels) f32, dispatched
        over the exported buckets by ``_bucket_plan``."""
        m = self.manifest
        ck = self._chunkyfier()
        n = audio.n_samples if isinstance(audio, AdpcmAudio) else int(audio.shape[0])
        total = ck.total_frames(
            n, strict_tail=m["strict_frames"], reference_tail=m["reference_tail"]
        )
        if total == 0:
            return np.zeros((0, len(self.labels)), np.float32)
        needed = -(-total // ck.n_windows)
        grids = []
        start_chunk = 0
        for n_chunks in _bucket_plan(needed, m["buckets"]):
            seg_chunks = min(n_chunks, needed - start_chunk)
            padded_len = n_chunks * ck.chunk_stride + ck.chunk_duration_f
            off = start_chunk * ck.chunk_stride
            if isinstance(audio, AdpcmAudio):
                seg = audio.block_slice(off, n_blocks(padded_len))[None]
            else:
                seg = np.zeros((1, padded_len), audio.dtype)
                take = min(padded_len, max(0, n - off))
                if take > 0:
                    seg[0, :take] = audio[off : off + take]
            grid = self.infer_fns[n_chunks].call(seg)
            grids.append(grid[: seg_chunks * ck.n_windows])
            start_chunk += seg_chunks
        return torch.cat(grids)[:total].float().cpu().numpy()

    def decode_intervals(
        self, logits: np.ndarray, thresholds: dict | None = None
    ) -> list[tuple[int, int, str]]:
        """Frame logits -> sample intervals through the exported packed
        decode, with the exact host fallback when a label overflows the
        packed capacity (or the file is longer than the largest bucket)."""
        m = self.manifest
        thr = threshold_vector(self.labels, thresholds or m["thresholds"]).astype(np.float32)
        valid = int(logits.shape[0])
        if valid == 0:
            return []
        n_w = m["n_windows"]
        needed = -(-valid // n_w)
        bucket = next((b for b in m["buckets"] if b >= needed), m["buckets"][-1])
        rows = bucket * n_w
        cs = self.frame_settings
        if valid > rows:  # longer than the largest exported decode
            return self._host_decode(logits, thr, cs)
        grid = np.zeros((rows, len(self.labels)), np.float32)
        grid[:valid] = logits
        valid_t = torch.tensor(valid, dtype=torch.int32, device=self.device)
        packed = self.decode_fns[bucket].call(grid, thr, valid_t).cpu().numpy()
        intervals = unpack_run_intervals(packed, int(m["decode_caps"][str(bucket)]),
                                         self.labels, cs)
        if intervals is None:  # capacity overflow: exact host fallback
            return self._host_decode(logits, thr, cs)
        return intervals

    def _host_decode(
        self, logits: np.ndarray, thr: np.ndarray, cs: ConvolutionSettings
    ) -> list[tuple[int, int, str]]:
        mask = 1.0 / (1.0 + np.exp(-logits)) > thr[None, :]

        class _Enc:  # create_intervals reads .base_labels only
            base_labels = tuple(self.labels)

        return create_intervals(mask, cs, _Enc())

    def segment(
        self, audio: np.ndarray, thresholds: dict | None = None
    ) -> list[tuple[int, int, str]]:
        """Waveform -> sorted sample intervals (the one-call serving API)."""
        logits = self.logits_for_audio(self.prepare(audio))
        return sorted(self.decode_intervals(logits, thresholds))


def run_inference_on_artifact(
    artifact: Path | str,
    wavs: Path | str,
    output: Path | str,
    uris: Path | str | None = None,
    thresholds: dict | str | Path | None = None,
    recursive: bool = False,
    rttm_dirname: str = "raw_rttm",
    min_duration_s: float = 0.0,
    merge_gap_s: float = 0.0,
    dump_logits: bool = False,
    device: str | torch.device = "cuda",
) -> list[Path]:
    """Batch prediction from an artifact directory: the RTTM layout of
    ``run_inference_on_audios`` without a model registry, config or
    checkpoint (``python -m segma_tpu_torch.inference --artifact``).
    ``dump_logits`` writes the tuner's per-label ``.npz`` files."""
    from segma_tpu_torch.inference import (
        _load_mono,
        get_list_of_files_to_process,
        load_thresholds,
        postprocess_intervals,
        save_logits,
        write_intervals,
    )

    thresholds = load_thresholds(thresholds)
    pipe = ExportedPipeline.load(artifact, device=device)
    files, n_files = get_list_of_files_to_process(Path(wavs), recursive, uris)
    sr = int(pipe.manifest["sample_rate"])
    processed: list[Path] = []
    for i, audio_path in enumerate(files, 1):
        t0 = time.perf_counter()
        try:
            # the live CLI's decode, so that the RTTMs are the same
            audio = _load_mono(audio_path, "int16", expect_sr=sr)
        except Exception as e:  # noqa: BLE001 — one bad file must not end the batch
            print(f"[log] - SKIPPED '{audio_path}': {type(e).__name__}: {e}", flush=True)
            continue
        # per-label decode order (not segment()'s sorted one), as the live CLI
        logits = pipe.logits_for_audio(pipe.prepare(audio))
        if dump_logits:
            save_logits(logits, list(pipe.labels), Path(output), audio_path.stem)
        intervals = postprocess_intervals(
            pipe.decode_intervals(logits, thresholds),
            min_duration_f=int(min_duration_s * sr),
            merge_gap_f=int(merge_gap_s * sr),
        )
        write_intervals(intervals, audio_path, Path(output), rttm_dirname)
        print(
            f"[log] - ({i:>{len(str(n_files))}}/{n_files}) inference for "
            f"'{audio_path.stem}' in {time.perf_counter() - t0:.2f}s",
            flush=True,
        )
        processed.append(audio_path)
    return processed
