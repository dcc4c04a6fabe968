#!/usr/bin/env python3
"""Smoke run of segma_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits nonzero without printing the final result line:

1. device: the card's name and power limit (nvidia-smi); no CUDA -> exit 1.
2. build: one nvcc call compiles ``segma_tpu_torch/csrc/*.cu``; ptxas's
   registers, spills and shared memory of each kernel are printed.
3. kernels: each CUDA kernel against its plain PyTorch version on the card
   at the main path's shapes (and a ragged small shape), then timed with
   CUDA events beside its plain version, a library call where one exists,
   and its roofline bound.
4. slice: full-width Whisper-base ``surgical_hydra`` (random weights from a
   seed) serves a synthetic 10-minute int16 WAV through
   ``run_inference_on_audios``; the launch counters show that the path went
   through both kernels, twice (first and second run in the process); the
   RTTM is parsed; one more run under torch.profiler prints device time by
   kernel; the card's logits for the first two chunks are held against the
   same model on the CPU plain path.
5. the ``kernels`` JSON line and the ``kernels:`` launch line.
6. last line: ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
import wave
from pathlib import Path

import numpy as np

# Published H100 SXM peaks (dense): f32 outside the tensor cores, bf16 tensor
# cores, HBM3 bandwidth. A card set below 700 W runs slower than these.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

LOGMEL_ATOL = 1e-5  # f32 frontend, IEEE FMA in the kernel
FLASH_ATOL = FLASH_RTOL = 2e-2  # bf16 output rounding against f32 scores
# Card (bf16 kernels, cuDNN LSTM) against CPU (bf16 plain path) logits: both
# round to bf16 at every encoder op, in other orders, through six layers
LOGITS_ATOL = 1e-2

INNER_BATCH = 64
N_CHUNKS = 150  # chunks in the synthetic WAV (~10 min at 16 kHz)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, peak_flops: float, n_bytes: float) -> tuple[float, str]:
    t_ops = flops / peak_flops
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def check_close(name: str, got, ref, atol: float, rtol: float = 0.0) -> float:
    import torch

    got, ref = got.float(), ref.float()
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (got - ref).abs()
    limit = atol + rtol * ref.abs()
    max_err = float(err.max())
    if bool((err > limit).any()):
        raise AssertionError(f"{name}: max abs err {max_err:.3e} exceeds atol {atol} rtol {rtol}")
    print(f"check {name}: max_abs_err {max_err:.3e} (atol {atol}, rtol {rtol})", flush=True)
    return max_err


def phase_build() -> float:
    from segma_tpu_torch.ops import _build

    t0 = time.perf_counter()
    report = _build.build()
    _build.library()
    secs = time.perf_counter() - t0
    print(f"build: {secs:.1f} s ({len(_build.sources())} sources, one nvcc call)", flush=True)
    for line in report:
        print(f"ptxas: {line}", flush=True)
    return secs


def logmel_checks(card: str) -> dict:
    import torch

    from segma_tpu_torch.ops import logmel

    g = torch.Generator(device="cuda").manual_seed(1)
    # the main path: 4 s chunks padded to the 30 s context
    wav = torch.zeros((INNER_BATCH, 480_000), device="cuda")
    wav[:, :64_000] = torch.randn((INNER_BATCH, 64_000), device="cuda", generator=g) * 0.1
    wav[: INNER_BATCH // 2] = torch.randn(
        (INNER_BATCH // 2, 480_000), device="cuda", generator=g
    ) * 0.1
    err = check_close(
        "logmel (64, 480000)", logmel.finish(logmel.log10_mel_cuda(wav)),
        logmel.log_mel_spectrogram_plain(wav), LOGMEL_ATOL,
    )
    tail = torch.randn((2, (256 + 7) * 160), device="cuda", generator=g) * 0.1
    err_tail = check_close(
        "logmel (2, 42080)", logmel.finish(logmel.log10_mel_cuda(tail)),
        logmel.log_mel_spectrogram_plain(tail), LOGMEL_ATOL,
    )
    ms = time_ms(lambda: logmel.log10_mel_cuda(wav), iters=20)
    plain_ms = time_ms(lambda: logmel.log10_mel_plain(wav), iters=5)
    b, t = wav.shape
    frames = b * (t // 160)
    flops = frames * (2 * 400 * 201 * 2 + 2 * 201 * 80)
    n_bytes = wav.numel() * 4 + frames * 80 * 4 + (2 * 400 * 201 + 201 * 80) * 4
    bms, by = bound_ms(flops, PEAK_F32_FLOPS, n_bytes)
    print(
        f"time logmel (64, 480000) [{card}]: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"bound {bms:.3f} ms ({by}, f32 CUDA-core peak)", flush=True,
    )
    return {
        "name": "logmel", "route": "cuda", "source": "segma_tpu_torch/csrc/logmel.cu",
        "replaces": "segma_tpu/ops/pallas_melspec.py:91",
        "max_abs_err": max(err, err_tail), "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bms, "bound_by": by, "library_ms": None,
    }


def flash_checks(card: str) -> dict:
    import torch
    import torch.nn.functional as F

    from segma_tpu_torch.ops import attention

    g = torch.Generator(device="cuda").manual_seed(2)
    sm = 64**-0.5
    errs = []
    for shape in ((INNER_BATCH, 1500, 8, 64), (2, 199, 8, 64)):
        q, k, v = (
            torch.randn(shape, device="cuda", generator=g).to(torch.bfloat16)
            for _ in range(3)
        )
        errs.append(check_close(
            f"flash_attn_fwd {shape}", attention.flash_attn_fwd(q, k, v, sm),
            attention.attention_plain(q, k, v, sm, torch.float32),
            FLASH_ATOL, FLASH_RTOL,
        ))
    q, k, v = (
        torch.randn((INNER_BATCH, 1500, 8, 64), device="cuda", generator=g).to(torch.bfloat16)
        for _ in range(3)
    )
    b, s, h, d = q.shape
    ms = time_ms(lambda: attention.flash_attn_fwd(q, k, v, sm), iters=20)
    plain_ms = time_ms(lambda: attention.attention_plain(q, k, v, sm, torch.bfloat16), iters=3)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=sm), iters=20)
    flops = 4 * b * h * s * s * d
    n_bytes = 4 * q.numel() * 2
    bms, by = bound_ms(flops, PEAK_BF16_FLOPS, n_bytes)
    print(
        f"time flash_attn_fwd (64, 1500, 8, 64) [{card}]: kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms, sdpa {library_ms:.3f} ms, bound {bms:.3f} ms "
        f"({by}, bf16 tensor-core peak)", flush=True,
    )
    return {
        "name": "flash_attn_fwd", "route": "cuda",
        "source": "segma_tpu_torch/csrc/flash_attn.cu",
        "replaces": "segma_tpu/ops/attention.py:148",
        "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bms, "bound_by": by, "library_ms": library_ms,
    }


def write_wav(path: Path, n_samples: int, seed: int = 0) -> np.ndarray:
    """Synthetic 16 kHz int16 mono WAV: noise bursts and tones."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples) / 16_000
    env = (np.sin(2 * np.pi * t / 7.0) > 0).astype(np.float32)
    tone = np.sin(2 * np.pi * 440.0 * t) * env
    sig = 0.3 * tone + 0.05 * rng.standard_normal(n_samples)
    pcm = (np.clip(sig, -1, 1) * 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16_000)
        w.writeframes(pcm.tobytes())
    return pcm


def surgical_hydra_config():
    """``config/default.yml`` with model.name=surgical_hydra and
    model.config.encoder=whisper_base_random, built in code."""
    from segma_tpu_torch.config import (
        AudioConfig, Config, DataConfig, LSTMConfig, ModelConfig,
        SurgicalHydraConfig, TrainConfig,
    )

    return Config(
        data=DataConfig(classes=["KCHI", "OCH", "MAL", "FEM"]),
        audio=AudioConfig(
            chunk_duration_s=4.0, sample_rate=16_000, strict_frames=False,
            reference_tail=False,
        ),
        model=ModelConfig(
            name="surgical_hydra",
            config=SurgicalHydraConfig(
                encoder="whisper_base_random", encoder_layers=[],
                reduction="weighted",
                lstm=LSTMConfig(hidden_size=128, num_layers=2, bidirectional=True, dropout=0.5),
                classifier=256,
            ),
        ),
        train=TrainConfig(precision="bf16"),
    )


def phase_slice(card: str) -> dict:
    import warnings

    import torch

    from segma_tpu_torch.annotation import AudioAnnotation
    from segma_tpu_torch.inference import Chunkyfier, _bucket, run_inference_on_audios
    from segma_tpu_torch.models import Models
    from segma_tpu_torch.models.geometry import ConvolutionSettings
    from segma_tpu_torch.ops import attention, logmel
    from segma_tpu_torch.utils.encoders import MultiLabelEncoder

    cfg = surgical_hydra_config()
    enc = MultiLabelEncoder(cfg.data.classes)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # random encoder weights, on purpose
        model = Models["surgical_hydra"](
            enc, cfg, device="cuda", generator=torch.Generator().manual_seed(0)
        )
        model_cpu = Models["surgical_hydra"](
            enc, cfg, device="cpu", generator=torch.Generator().manual_seed(0)
        )
    n_layers = model.module.enc_cfg.n_layers

    ck = Chunkyfier(INNER_BATCH, cfg.audio.chunk_duration_f, ConvolutionSettings((320,), (320,), (0,)))
    n_samples = N_CHUNKS * ck.chunk_stride + ck.missing_n_frames + 8_000
    total_frames = ck.total_frames(n_samples)
    n_needed = -(-total_frames // ck.n_windows)
    n_chunks = _bucket(n_needed)
    bs = min(INNER_BATCH, n_chunks)
    n_inner = n_chunks // bs + (1 if n_chunks % bs else 0)

    with tempfile.TemporaryDirectory() as tmp:
        wav_dir = Path(tmp) / "wav"
        wav_dir.mkdir()
        pcm = write_wav(wav_dir / "smoke.wav", n_samples)
        audio_s = n_samples / 16_000

        def drive(run: int) -> tuple[float, dict, int]:
            """One main-path run from zeroed launch counters."""
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            logmel.launches = 0
            attention.launches = 0
            t0 = time.perf_counter()
            done = run_inference_on_audios(
                cfg, wav_dir, None, Path(tmp) / f"out{run}", model=model, device="cuda",
                batch_size=INNER_BATCH,
            )
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {"logmel": logmel.launches, "flash_attn_fwd": attention.launches}
            if len(done) != 1:
                raise AssertionError("run_inference_on_audios served no file")
            return wall, launches, torch.cuda.max_memory_allocated()

        for run, label in enumerate(("first run", "second run")):
            wall, launches, peak = drive(run)
            if launches["logmel"] != n_inner or launches["flash_attn_fwd"] != n_layers * n_inner:
                raise AssertionError(
                    f"launch counts {launches} != logmel {n_inner}, flash {n_layers * n_inner}"
                )
            print(
                f"slice {label} [{card}]: wall {wall:.3f} s, {audio_s / wall:.2f}x real time, "
                f"peak device memory {peak} B ({peak / 2**30:.2f} GiB), launches {launches}",
                flush=True,
            )
        rttm = Path(tmp) / "out1" / "raw_rttm" / "smoke.rttm"
        lines = [ln for ln in rttm.read_text().splitlines() if ln.strip()]
        segs = [AudioAnnotation.from_rttm(ln) for ln in lines]
        if any(s.duration_s <= 0 or s.label not in cfg.data.classes for s in segs):
            raise AssertionError("RTTM holds a malformed segment")
        if rttm.read_text() != (Path(tmp) / "out0" / "raw_rttm" / "smoke.rttm").read_text():
            raise AssertionError("two runs over the same WAV wrote different RTTMs")
        profile_slice(card, lambda: run_inference_on_audios(
            cfg, wav_dir, None, Path(tmp) / "out_prof", model=model, device="cuda",
            batch_size=INNER_BATCH,
        ), wall)
    print(
        f"slice: {N_CHUNKS}+ chunk WAV ({audio_s:.1f} s audio), bucket {n_chunks} chunks, "
        f"{n_inner} inner batches of {bs}, {len(segs)} RTTM segments", flush=True,
    )

    # card vs CPU plain path on the first two chunks, same weights
    x = torch.from_numpy(pcm[: 2 * ck.chunk_stride + ck.missing_n_frames].astype(np.float32) / 32768.0)
    chunks = torch.stack([x[i * ck.chunk_stride : i * ck.chunk_stride + ck.chunk_duration_f] for i in range(2)])
    with torch.inference_mode():
        got = model.apply(chunks.cuda()).cpu()
        ref = model_cpu.apply(chunks)
    check_close("surgical_hydra logits, card vs CPU (2 chunks, bf16)", got, ref, LOGITS_ATOL)
    return launches


def profile_slice(card: str, fn, wall_s: float) -> None:
    """One more main-path run under torch.profiler: device time by kernel,
    and the device's busy share of ``wall_s``, the same run's wall time
    without the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_us = sum(e.self_device_time_total for e in events)
    print(f"profile [{card}]: wall under the profiler {wall_us / 1e3:.1f} ms, device busy "
          f"{busy_us / 1e3:.1f} ms = {100 * busy_us / (wall_s * 1e6):.1f}% of the "
          f"unprofiled wall {wall_s * 1e3:.1f} ms (kernels may overlap)", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"profile kernel: {e.self_device_time_total / 1e3:9.2f} ms {e.count:6d}x {e.key[:100]}",
              flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    card = card_line()
    print(f"device: {card}", flush=True)
    # plain versions compare in true f32: no TF32 in matmuls or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("plain versions: allow_tf32 False for matmul and cuDNN", flush=True)

    phase_build()
    with torch.inference_mode():
        rows = [logmel_checks(card), flash_checks(card)]
    torch.cuda.empty_cache()
    launches = phase_slice(card)
    for row in rows:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": rows}), flush=True)
    print(f"kernels: {json.dumps(launches)}", flush=True)
    print(card, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
