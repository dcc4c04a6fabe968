#!/usr/bin/env python3
"""Smoke run of segma_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits nonzero without printing the final result line:

1. device: the card's name and power limit (nvidia-smi); no CUDA -> exit 1.
2. build: one nvcc per ``segma_tpu_torch/csrc/*.cu``, all started together,
   then one link; ptxas's registers, spills and shared memory of each
   kernel are printed.
3. kernels: each CUDA kernel against its plain PyTorch version on the card
   at the main paths' shapes (and ragged small shapes), then timed with
   CUDA events beside its plain version, a library call where one exists,
   and its roofline bound. The log-mel kernel is checked at atol 1e-5
   against the plain version on the main path's padded chunks and the
   reflect edges (T = 201, 16001, 42080), against a float64 computation on
   white noise over the whole serving batch and on wide-range signals
   (tone, brown noise, quiet int16 noise): at most twice the f32 plain
   version's own error, and on each wide-range signal at most
   LOGMEL_BULK_FACTOR times as many outputs more than 1e-5 off as the plain
   version; and bitwise over two launches; it is timed
   on an all-signal input and on the padded chunks beside the plain
   version, a cuFFT composition (a yardstick, never called by the port)
   and ``finish``, with its bound (bytes, or the FFT and sparse mel's
   operations at the f32 peak) and two floors of its dense-DFT design. The
   flash forward's output and log-sum-exp are
   checked at FLASH_SHAPES (both main paths and the edges of its 128-row,
   128-key tiling), bitwise equal with and without the LSE and over two
   launches; its bound is the larger of the bf16 products at the tensor-core
   peak and its exp2 at 16 per SM per clock. The flash backward is checked
   at FLASH_BWD_SHAPES (the training shape (32, 199, 12, 64), (64, 1500, 8,
   64), (2, 70, 2, 64) and the edges of its tiling), on the forward's output
   and log-sum-exp, and bitwise over two launches. Kernels and library calls
   are timed in turns (``time_turns``: the median of 5 groups of 20 calls,
   the device held by a spin kernel while the host queues each group), and
   every SDPA backend that takes the shape is timed; the fastest is the
   ``library_ms``. The f32 forward and backward (both 3xTF32 on wgmma)
   are checked at FLASH_F32_SHAPES and
   FLASH_F32_BWD_SHAPES against their plain versions in f32 and in float64
   (the JAX suite's f32 pins), bitwise with and without the LSE and over
   two launches, and timed at both main paths' shapes beside every SDPA
   backend that takes f32 (the refusals are printed), with their bounds at
   the f32 CUDA-core peak and as 3xTF32 at the tensor-core peak; the
   backward's and SDPA's f32 gradients are printed against the float64
   gradient.
4. serving slice: full-width Whisper-base ``surgical_hydra`` (random
   weights from a seed) serves a synthetic 10-minute int16 WAV through
   ``run_inference_on_audios``; the launch counters show that the path went
   through both forward kernels, twice (first and second run in the
   process); the RTTM is parsed; one more run under torch.profiler prints
   device time by kernel; the card's logits for the first two chunks are
   held against the same model on the CPU plain path.
5. training slice: full-width HuBERT-base ``surgical_hubert_hydra`` (random
   weights from a seed, transformer trainable, front end frozen) trains two
   epochs through ``Trainer.fit`` on a synthetic dataset written here (8
   train and 4 val files of 64 s: 4 steps of 32 crops per epoch). Checked:
   the step-1 loss (dropout 0) against the CPU plain path, finite losses,
   non-zero q/k/v projection gradients after step 1, an unchanged front end,
   and 12 flash forward and 12 flash backward launches per step. Then
   WARM_STEP_REPEATS steps on one batch, timed, and one more under
   torch.profiler (the 15 longest kernels and the port's own).
6. the reference workflow (``phase_workflow``, bf16, full width): exact
   resume of HuBERT-base from ``last/`` under cuDNN's deterministic
   algorithms, bit for bit against the uninterrupted run and apart from a
   resume with fresh moments; a Whisper-base snapshot in HF's layout
   through the predict CLI (``inference.main``, ``--save-logits``), the
   saved logits against ``logits_for_audio`` and the CPU; a HuBERT-base
   snapshot trained one epoch, its checkpoint served and another snapshot
   refused; ``tune.main`` against a brute-force F1 grid; ``evaluate.main``.
7. f32 serving, under PyTorch's default TF32 flags: the serving slice's WAV
   through ``surgical_hydra`` with train.precision=f32, through the f32
   forward kernel, profiled; the card's logits against the CPU f32 plain
   path at LOGITS_F32_ATOL; the flags unchanged by the run.
8. f32 train, checkpoint, serve: ``surgical_hubert_hydra`` in f32 trains two
   epochs through ``Trainer.fit`` (the f32 forward and backward kernels on
   every attention), writing JAX-format checkpoints; the run directory is
   served through ``run_inference_on_audios(checkpoint=...)`` on the card,
   RTTMs out; the models ``load_model_for_inference`` rebuilds from
   best.ckpt and last/ give the in-memory model's logits at that epoch, bit
   for bit; one warm f32 step profiled.
9. the reference's six models (``phase_reference_models``, bf16 and f32,
   full width): reference ``best.ckpt`` files of the five Whisper variants
   and of ``surgical_hubert_hydra`` imported by the import CLI and served
   by the predict CLI over the snapshots of their encoders, against the
   CPU; whisperidou with ``fast_context`` in bf16 and f32; whisperimax in
   f32; whisperimax trained with the multiclass loss, its ``bias_ih`` still
   zero. Before the phases, the three forward kernels are also checked
   and timed at the fast_context shapes, log-mel on (64, 64000) and both
   flash forwards on (64, 200, 8, 64) (``fast_context_kernel_times``).
10. the ``kernels`` JSON line (log-mel, the bf16 and the f32 flash forward
   and backward; each with its fast_context times where it has them) and
   the ``kernels:`` launch line, per path (the workflow's resumed fit and
   predict CLI run, and each reference-model path, among them).
11. last line: ``{"ok": true, "device": {...}}``.
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
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# f32 frontend (3xTF32 products, f32 accumulation) against the f32 plain
# version, on inputs with a flat spectrum; on wide-range signals both are held
# to float64 instead (logmel_checks)
LOGMEL_ATOL = 1e-5
# On the wide-range signals, the kernel may have at most this many times as
# many outputs more than LOGMEL_ATOL from float64 as the f32 plain version:
# 1, as exact in the bulk as an f32 implementation. Without each frame's
# mean taken out the kernel had 2.4x on brown noise: its tensor-core sums
# truncate, and the frame's offset scaled every product; with the mean out
# it has none there (csrc/logmel.cu, PERF.md). The maximum keeps its own
# rule above.
LOGMEL_BULK_FACTOR = 1.0
FLASH_ATOL = FLASH_RTOL = 2e-2  # bf16 output rounding against f32 scores
# backward: P and dS round to bf16 before their products, the gradients to
# bf16 on the way out; held per tensor at FLASH_BWD_REL * max(1, max|ref|)
FLASH_BWD_REL = 2e-2
LSE_ATOL = 1e-3  # f32 running max and sum against torch.logsumexp
# f32 kernels: the JAX suite's f32 pins against its einsum attention, 2e-5 on
# the forward and 5e-5 on the gradients (tests/test_ops_attention.py:52, :74),
# the gradients per tensor times max(1, max|ref|) as for bf16, since at S =
# 199 with N(0, 1) inputs dq and dk reach |10|; the LSE is a log of sums of
# order S, held at 1e-5
FLASH_F32_ATOL = 2e-5
FLASH_F32_BWD_REL = 5e-5
LSE_F32_ATOL = 1e-5
TRAIN_ATTN_SHAPE = (32, 199, 12, 64)  # HuBERT-base training: batch 32, 4 s
# Card (bf16 kernels, cuDNN LSTM) against CPU (bf16 plain path) logits: both
# round to bf16 at every encoder op, in other orders, through six layers
LOGITS_ATOL = 1e-2
# f32 on the card (IEEE f32 kernels and cuBLAS, cuDNN without TF32) against
# the CPU f32 plain path: the suite's f32 logits pin
# (tests/test_torch_surgical_hydra.py, tests/test_torch_hubert.py)
LOGITS_F32_ATOL = 1e-4
# bf16 served logits of the reference models against their f32 model (on the
# CPU): at most this many times as far as the CPU's bf16 plain path is, or
# LOGITS_ATOL. Two bf16 computations in other orders differ by a few bf16
# ulps of the logits, which LOGITS_ATOL covers for logits below 1 through six
# layers, not for the MLP heads' logits of order 2 to 3 or HuBERT's twelve
# layers, where the CPU's own bf16 path is 0.02 to 0.03 from f32 (PERF.md)
LOGITS_BF16_FACTOR = 3.0

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


def time_turns(fns: dict, groups: int = 5, iters: int = 20) -> dict[str, list[float]]:
    """Device time per call of each function in ``fns``, taken in turns: in
    each of ``groups`` groups every function runs ``iters`` times between two
    CUDA events. A spin kernel queued before each run holds the device while
    the host queues the run, so the events time the device's work, not the
    host's launch rate. Returns each function's per-group means in ms."""
    import torch

    host_s = 0.0
    for fn in fns.values():  # warm-up, and the host's time to queue one run
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_s = max(host_s, time.perf_counter() - t0)
        torch.cuda.synchronize()
    spin_cycles = int(2 * host_s * max_sm_clock_hz())
    times: dict[str, list[float]] = {name: [] for name in fns}
    for _ in range(groups):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(spin_cycles)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / iters)
    return times


def median(xs: list[float]) -> float:
    return float(np.median(xs))


def spread(xs: list[float]) -> str:
    return f"median {median(xs):.4f} ms (groups {min(xs):.4f} to {max(xs):.4f})"


SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION")


def sdpa_calls(q, k, v, sm: float, dout=None) -> dict:
    """One call per SDPA backend that takes these contiguous (B, H, S, D)
    inputs: its forward, or, given ``dout``, the backward of a forward it
    recorded. A backend that refuses the inputs is printed and left out."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    calls = {}
    for name in SDPA_BACKENDS:
        backend = getattr(SDPBackend, name)
        try:
            if dout is None:
                def call(backend=backend):
                    with sdpa_kernel(backend):
                        return F.scaled_dot_product_attention(q, k, v, scale=sm)
            else:
                with torch.enable_grad(), sdpa_kernel(backend):
                    ins = tuple(x.detach().requires_grad_() for x in (q, k, v))
                    out = F.scaled_dot_product_attention(*ins, scale=sm)

                def call(out=out, ins=ins):
                    return torch.autograd.grad(out, ins, dout, retain_graph=True)
            call()
            torch.cuda.synchronize()
        except RuntimeError as err:
            print(f"sdpa {name}: refuses {tuple(q.shape)}: {str(err).splitlines()[0][:120]}",
                  flush=True)
            continue
        calls[f"sdpa {name}"] = call
    return calls


def bound_ms(flops: float, peak_flops: float, n_bytes: float) -> tuple[float, str]:
    t_ops = flops / peak_flops
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def check_close(name: str, got, ref, atol: float, rtol: float = 0.0) -> float:
    import torch

    got, ref = got.double(), ref.double()
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
    print(f"build: {secs:.1f} s ({len(_build.sources())} sources, one nvcc each in parallel)",
          flush=True)
    for line in report:
        print(f"ptxas: {line}", flush=True)
    return secs


def stft_log10_mel(wav, window, fb):
    """A cuFFT composition of the same function, printed as a yardstick only
    (the port never calls it): torch.stft (periodic Hann, centred, reflect
    padding, Whisper's last frame dropped), power, @ fb, log10."""
    import torch

    spec = torch.stft(wav, 400, 160, window=window, center=True, pad_mode="reflect",
                      return_complex=True)[..., :-1]
    power = spec.real.square() + spec.imag.square()  # (B, 201, frames)
    return torch.log10(torch.clamp(power.transpose(1, 2) @ fb, min=1e-10))


def wide_range_signals(seed: int, t: int) -> dict[str, np.ndarray]:
    """Test signals that use the 8 decades ``finish`` keeps, as recordings
    do, unlike white noise's flat spectrum: a 440 Hz tone at 0.5 over noise
    70 dB below it (10^-3.5), brown noise peaking at 0.5, and int16-quantised
    noise of 3 LSB. f32, (t,) each, from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    n = np.arange(t) / 16_000
    tone = 0.5 * np.sin(2 * np.pi * 440.0 * n) + 10**-3.5 * rng.standard_normal(t)
    brown = np.cumsum(rng.standard_normal(t))
    brown = 0.5 * (brown - brown.mean()) / np.abs(brown - brown.mean()).max()
    quiet = np.round(3.0 * rng.standard_normal(t)) / 32_768
    return {
        name: sig.astype(np.float32)
        for name, sig in (("tone", tone), ("brown", brown), ("int16-quiet", quiet))
    }


def log_mel_float64(wav):
    """The finished log-mel in float64 throughout (the f32 DFT basis and
    filterbank widened), on whatever device ``wav`` lies: the reference that
    the kernel and the f32 plain version are held to where two f32
    implementations cannot meet 1e-5 against each other (here, and in
    tests/test_torch_melspec.py and tests/test_torch_kernels_gpu.py)."""
    import torch
    import torch.nn.functional as F

    from segma_tpu_torch.ops.melspec import dft_basis, mel_filterbank

    x = wav.double()
    frames = F.pad(x[:, None], (200, 200), mode="reflect")[:, 0].unfold(1, 400, 160)
    frames = frames[:, : x.shape[1] // 160]  # Whisper's last frame dropped
    cos_b, sin_b, fb = (torch.from_numpy(a).to(x) for a in (*dft_basis(), mel_filterbank()))
    spec = torch.log10(torch.clamp(((frames @ cos_b) ** 2 + (frames @ sin_b) ** 2) @ fb, min=1e-10))
    spec = torch.maximum(spec, spec.amax(dim=(1, 2), keepdim=True) - 8.0)
    return (spec + 4.0) / 4.0


def logmel_bounds(b: int, t: int) -> dict:
    """The bound of one launch on a (b, t) waveform, and two floors of the
    kernel's dense-DFT design. The bound is the larger of the bytes (the
    waveform read once, the log-mel written once) at HBM rate and the
    operations the function needs at the f32 peak: per frame the window
    (400), a 400-point real FFT (2.5 N log2 N, half a complex one's 5 N log2
    N), the power (3 per bin, 201 bins) and the sparse mel (2 per non-zero
    filterbank weight). The floors: the dense DFT and dense mel at the f32
    CUDA-core peak, and the dense DFT's three TF32 products at the TF32
    tensor-core peak."""
    from segma_tpu_torch.ops.melspec import mel_filterbank

    frames = b * (t // 160)
    frame_ops = float(400 + 2.5 * 400 * np.log2(400) + 3 * 201
                      + 2 * np.count_nonzero(mel_filterbank()))
    n_bytes = b * t * 4 + frames * 80 * 4
    ms, by = bound_ms(frames * frame_ops, PEAK_F32_FLOPS, n_bytes)
    dft_flops = frames * 2 * 2 * 400 * 201
    return {
        "bound_ms": ms, "bound_by": by,
        "fft_ops_ms": frames * frame_ops / PEAK_F32_FLOPS * 1e3,
        "bytes_ms": n_bytes / PEAK_BYTES_PER_S * 1e3,
        "dense_dft_f32_ms": (dft_flops + frames * 2 * 201 * 80) / PEAK_F32_FLOPS * 1e3,
        "dense_dft_3xtf32_ms": 3 * dft_flops / PEAK_TF32_FLOPS * 1e3,
    }


def logmel_checks(card: str) -> dict:
    """The kernel against the plain version at LOGMEL_ATOL on white noise, the
    main path's padded chunks and the reflect edges; against a float64
    computation on white noise over the serving batch and on the wide-range
    signals (at most twice the plain version's own error, or LOGMEL_ATOL);
    bitwise over two launches. Then timed in turns beside the
    plain version, the cuFFT yardstick and ``finish``, on an all-signal input
    and on the main path's padded chunks, with its bound and two floors."""
    import torch

    from segma_tpu_torch.ops import logmel

    g = torch.Generator(device="cuda").manual_seed(1)
    full = torch.randn((INNER_BATCH, 480_000), device="cuda", generator=g) * 0.1
    # the main path: 4 s chunks padded with zeros to the 30 s context
    chunks = torch.zeros((INNER_BATCH, 480_000), device="cuda")
    chunks[:, :64_000] = torch.randn((INNER_BATCH, 64_000), device="cuda", generator=g) * 0.1
    cases = {
        "padded chunks (64, 480000)": chunks,
        "(2, 42080)": torch.randn((2, (256 + 7) * 160), device="cuda", generator=g) * 0.1,
        "(1, 16001)": torch.randn((1, 16_001), device="cuda", generator=g) * 0.1,
        "(3, 201)": torch.randn((3, 201), device="cuda", generator=g) * 0.1,
    }
    errs = [
        check_close(f"logmel {name}", logmel.finish(logmel.log10_mel_cuda(wav)),
                    logmel.log_mel_spectrogram_plain(wav), LOGMEL_ATOL)
        for name, wav in cases.items()
    ]
    if not torch.equal(logmel.log10_mel_cuda(full), logmel.log10_mel_cuda(full)):
        raise AssertionError("logmel: two launches differ")
    print("check logmel (64, 480000): two launches bitwise equal", flush=True)
    # Held to float64, where two f32 implementations differ by more than
    # 1e-5: the wide-range signals (cancellation in the DFT of a loud bin
    # leaks into the quiet ones), and white noise over the whole serving
    # batch, whose 15.4 M outputs include bins far below the mean power by
    # chance. There the plain version itself is 2.7e-5 to 4.9e-5 off, and
    # the kernel 0.4 to 1.4 times that, by input (PERF.md), so neither 1e-5
    # against the plain version nor a limit below its own error holds a
    # correct kernel. The count of outputs more than 1e-5 off shows the bulk.
    wide = {}
    signals = {"white all-signal (64, 480000)": full}
    for name, sig in wide_range_signals(8, INNER_BATCH * 64_000).items():
        signals[f"{name} (64, 64000)"] = torch.from_numpy(sig.reshape(INNER_BATCH, 64_000)).cuda()
    for name, wav in signals.items():
        ref = log_mel_float64(wav)
        plain_off = (logmel.log_mel_spectrogram_plain(wav).double() - ref).abs()
        off = (logmel.finish(logmel.log10_mel_cuda(wav)).double() - ref).abs()
        plain_err, err = float(plain_off.max()), float(off.max())
        limit = max(2 * plain_err, LOGMEL_ATOL)
        if not err <= limit:
            raise AssertionError(f"logmel {name}: {err:.3e} from float64 exceeds {limit:.3e}")
        count, plain_count = int((off > LOGMEL_ATOL).sum()), int((plain_off > LOGMEL_ATOL).sum())
        print(f"check logmel {name} against float64: kernel {err:.3e}, plain {plain_err:.3e} "
              f"(limit {limit:.3e} = max(2 x plain, {LOGMEL_ATOL})); outputs more than "
              f"{LOGMEL_ATOL} off: kernel {count}, plain {plain_count} of {off.numel()}",
              flush=True)
        if not name.startswith("white") and not count <= LOGMEL_BULK_FACTOR * plain_count:
            raise AssertionError(f"logmel {name}: {count} outputs more than {LOGMEL_ATOL} from "
                                 f"float64, over {LOGMEL_BULK_FACTOR} x the plain version's "
                                 f"{plain_count}")
        wide[name] = {"max_abs_err": err, "plain_max_abs_err": plain_err,
                      "outputs_off": count, "plain_outputs_off": plain_count}

    window = torch.hann_window(400, device="cuda")
    fb = logmel._plain_tables(full.device)[2]
    yard_err = float((stft_log10_mel(full, window, fb) - logmel.log10_mel_plain(full)).abs().max())
    timed = {}
    for label, wav in (("all-signal", full), ("padded chunks", chunks)):
        spec = logmel.log10_mel_cuda(wav)
        times = time_turns({
            "kernel": lambda: logmel.log10_mel_cuda(wav),
            "plain": lambda: logmel.log10_mel_plain(wav),
            "stft yardstick": lambda: stft_log10_mel(wav, window, fb),
            "finish": lambda: logmel.finish(spec),
        })
        for name, t in times.items():
            print(f"time logmel {name} {label} (64, 480000) [{card}]: {spread(t)}", flush=True)
        timed[label] = {name: median(t) for name, t in times.items()}
    bounds = logmel_bounds(*full.shape)
    ms = timed["all-signal"]["kernel"]
    print(
        f"time logmel (64, 480000) all-signal [{card}]: kernel {ms:.4f} ms, padded chunks "
        f"{timed['padded chunks']['kernel']:.4f} ms, plain {timed['all-signal']['plain']:.4f} "
        f"ms, stft yardstick {timed['all-signal']['stft yardstick']:.4f} ms (|diff| from plain "
        f"{yard_err:.2e}), finish {timed['all-signal']['finish']:.4f} ms; bound "
        f"{bounds['bound_ms']:.4f} ms ({bounds['bound_by']}; {100 * bounds['bound_ms'] / ms:.1f}% "
        f"of it; bytes {bounds['bytes_ms']:.4f} ms, FFT and sparse mel at the f32 peak "
        f"{bounds['fft_ops_ms']:.4f} ms); dense-DFT floors: 3xTF32 tensor cores "
        f"{bounds['dense_dft_3xtf32_ms']:.4f} ms, f32 CUDA cores "
        f"{bounds['dense_dft_f32_ms']:.4f} ms", flush=True,
    )
    return {
        "name": "logmel", "route": "cuda", "source": "segma_tpu_torch/csrc/logmel.cu",
        "replaces": "segma_tpu/ops/pallas_melspec.py:91",
        "max_abs_err": max(errs),
        "max_abs_err_vs_float64": max(w["max_abs_err"] for w in wide.values()),
        "ms": ms, "plain_ms": timed["all-signal"]["plain"],
        "library_ms": None, **bounds, "padded_chunks_ms": timed["padded chunks"]["kernel"],
        "stft_yardstick_ms": timed["all-signal"]["stft yardstick"],
        "finish_ms": timed["all-signal"]["finish"], "wide_range": wide,
    }


# The forward's shapes: both main paths, then the edges of its tiling (128
# query rows per work item, 128 keys per tile): exact tiles, one row or key
# past a tile, a partial first tile, a single key.
FLASH_SHAPES = (
    (INNER_BATCH, 1500, 8, 64), TRAIN_ATTN_SHAPE, (2, 128, 2, 64), (2, 129, 2, 64),
    (2, 256, 2, 64), (3, 65, 2, 64), (1, 1, 2, 64),
)
EXP2_PER_SM_CLOCK = 16  # special-function unit, compute capability 9.0


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.split()
    return float(out[0]) * 1e6


def flash_checks(card: str) -> dict:
    """The forward against ``attention_plain`` (output) and
    ``attention_lse_plain`` (log-sum-exp) at FLASH_SHAPES, its output bitwise
    the same with and without the LSE and over two launches, then timed at the
    serving shape beside its plain version, every SDPA backend (in turns) and
    two bounds: bf16 products
    at the tensor-core peak, and B H S^2 exp2 at 16 per SM per clock at the
    card's max SM clock."""
    import torch

    from segma_tpu_torch.ops import attention

    g = torch.Generator(device="cuda").manual_seed(2)
    sm = 64**-0.5
    errs, lse_errs = [], []
    for shape in FLASH_SHAPES:
        q, k, v = (
            torch.randn(shape, device="cuda", generator=g).to(torch.bfloat16)
            for _ in range(3)
        )
        out, lse = attention.flash_attn_fwd(q, k, v, sm, with_lse=True)
        errs.append(check_close(
            f"flash_attn_fwd {shape}", out, attention.attention_plain(q, k, v, sm, torch.float32),
            FLASH_ATOL, FLASH_RTOL,
        ))
        lse_errs.append(check_close(
            f"flash_attn_fwd lse {shape}", lse, attention.attention_lse_plain(q, k, sm), LSE_ATOL,
        ))
        if not torch.equal(out, attention.flash_attn_fwd(q, k, v, sm)):
            raise AssertionError(f"flash_attn_fwd {shape}: output differs without the LSE")
        if not torch.equal(out, attention.flash_attn_fwd(q, k, v, sm, with_lse=True)[0]):
            raise AssertionError(f"flash_attn_fwd {shape}: two launches differ")
        del q, k, v, out, lse
        torch.cuda.empty_cache()
    print(f"check flash_attn_fwd: bitwise equal with and without the LSE, and over two "
          f"launches, at {len(FLASH_SHAPES)} shapes", flush=True)
    q, k, v = (
        torch.randn((INNER_BATCH, 1500, 8, 64), device="cuda", generator=g).to(torch.bfloat16)
        for _ in range(3)
    )
    b, s, h, d = q.shape
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    times = time_turns({"kernel": lambda: attention.flash_attn_fwd(q, k, v, sm),
                        **sdpa_calls(qt, kt, vt, sm)})
    ms = median(times.pop("kernel"))
    library = {name: median(t) for name, t in times.items()}
    library_ms = min(library.values()) if library else None
    for name, t in times.items():
        print(f"time {name} forward (64, 8, 1500, 64) [{card}]: {spread(t)}", flush=True)
    plain_ms = time_ms(lambda: attention.attention_plain(q, k, v, sm, torch.bfloat16), iters=3)
    flops = 4 * b * h * s * s * d
    n_bytes = 4 * q.numel() * 2
    bf16_ms, by = bound_ms(flops, PEAK_BF16_FLOPS, n_bytes)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    clock = max_sm_clock_hz()
    exp_ms = b * h * s * s / (EXP2_PER_SM_CLOCK * n_sm * clock) * 1e3
    bms = max(bf16_ms, exp_ms)
    bound_op = "bf16 tensor core" if bf16_ms >= exp_ms else "exp2 special-function unit"
    print(
        f"time flash_attn_fwd (64, 1500, 8, 64) [{card}]: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.3f} ms, fastest sdpa {library_ms} ms; bounds: bf16 products "
        f"{bf16_ms:.4f} ms ({by}, bf16 tensor-core peak), exp2 {exp_ms:.4f} ms "
        f"({b * h * s * s:.4g} exp2 at {EXP2_PER_SM_CLOCK}/SM/clock x {n_sm} SMs x "
        f"{clock / 1e6:.0f} MHz); binding: {bound_op}", flush=True,
    )
    return {
        "name": "flash_attn_fwd", "route": "cuda",
        "source": "segma_tpu_torch/csrc/flash_attn.cu",
        "replaces": "segma_tpu/ops/attention.py:148",
        "max_abs_err": max(errs), "lse_max_abs_err": max(lse_errs), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bms, "bound_by": "operations",
        "bound_op": bound_op, "bf16_bound_ms": bf16_ms, "exp2_bound_ms": exp_ms,
        "library_ms": library_ms, "library_backends_ms": library,
    }


def check_rel(name: str, got, ref, rel: float) -> float:
    """max|got - ref| <= rel * max(1, max|ref|), per tensor."""
    import torch

    got, ref = got.double(), ref.double()
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    max_err = float((got - ref).abs().max())
    limit = rel * max(1.0, float(ref.abs().max()))
    if max_err > limit:
        raise AssertionError(f"{name}: max abs err {max_err:.3e} exceeds {limit:.3e}")
    print(f"check {name}: max_abs_err {max_err:.3e} (limit {limit:.3e} = {rel} * max(1, max|ref|))",
          flush=True)
    return max_err


# The backward's shapes: the training shape, many tiles, a partial tile, and
# the edges of its tiling (128 resident rows per work item, 64 streamed rows
# per tile): one row, one short of, at and one past each tile edge.
FLASH_BWD_EDGE_S = (1, 63, 64, 65, 127, 128, 129, 255, 256)
FLASH_BWD_SHAPES = (
    TRAIN_ATTN_SHAPE, (INNER_BATCH, 1500, 8, 64), (2, 70, 2, 64),
    *((2, s, 3, 64) for s in FLASH_BWD_EDGE_S),
)


def time_flash_bwd(card: str, q, k, v, out, lse, dout, sm: float, plain_iters: int) -> dict:
    """The backward kernels and every SDPA backend's backward on the same
    inputs, in turns; the plain version; the bound. Prints one line each."""
    import torch

    from segma_tpu_torch.ops import attention

    b, s, h, d = q.shape
    qt, kt, vt, dout_t = (x.transpose(1, 2).contiguous() for x in (q, k, v, dout))
    times = time_turns({
        "kernel": lambda: attention.flash_attn_bwd(q, k, v, out, lse, dout, sm),
        **sdpa_calls(qt, kt, vt, sm, dout_t),
    })
    kernel = times.pop("kernel")
    library = {name: median(t) for name, t in times.items()}
    plain_ms = time_ms(lambda: attention.attention_bwd_plain(q, k, v, out, lse, dout, sm),
                       iters=plain_iters)
    flops = 10 * b * h * s * s * d  # five S x S x D products
    n_bytes = 8 * q.numel() * 2 + lse.numel() * 4  # q k v out dO dq dk dv, lse
    bms, by = bound_ms(flops, PEAK_BF16_FLOPS, n_bytes)
    print(f"time flash_attn_bwd {tuple(q.shape)} [{card}]: kernels {spread(kernel)}", flush=True)
    for name, t in times.items():
        print(f"time {name} backward {(b, h, s, d)} [{card}]: {spread(t)}", flush=True)
    ms = median(kernel)
    fastest = min(library.values()) if library else None
    print(
        f"time flash_attn_bwd {tuple(q.shape)} [{card}]: kernels {ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, fastest sdpa backward {fastest} ms, bound {bms:.4f} ms ({by}, "
        f"{flops / 1e9:.1f} GFLOP, {n_bytes / 1e6:.1f} MB; {100 * bms / ms:.1f}% of it)",
        flush=True,
    )
    return {"ms": ms, "ms_groups": kernel, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": fastest, "library_backends_ms": library}


def flash_bwd_checks(card: str) -> tuple[dict, dict]:
    """The backward kernels against ``attention_bwd_plain`` on the same bf16
    inputs (q, k, v, dO random; out and lse from the forward kernel) at
    FLASH_BWD_SHAPES, two launches bitwise equal, and the forward on the
    training route (lse pointer set): its output against ``attention_plain``,
    its log-sum-exp against ``attention_lse_plain``. Then timed at the
    training shape and at (64, 1500, 8, 64). Returns the backward's row and
    the forward's errors and times at the training slice's shape."""
    import torch

    from segma_tpu_torch.ops import attention

    torch.set_grad_enabled(False)
    g = torch.Generator(device="cuda").manual_seed(3)
    sm = 64**-0.5
    errs, out_errs, lse_errs = [], [], []
    for shape in FLASH_BWD_SHAPES:
        q, k, v, dout = (
            torch.randn(shape, device="cuda", generator=g).to(torch.bfloat16)
            for _ in range(4)
        )
        out, lse = attention.flash_attn_fwd(q, k, v, sm, with_lse=True)
        out_errs.append(check_close(
            f"flash_attn_fwd with lse {shape}", out,
            attention.attention_plain(q, k, v, sm, torch.float32), FLASH_ATOL, FLASH_RTOL,
        ))
        lse_errs.append(check_close(
            f"flash_attn_fwd lse {shape}", lse, attention.attention_lse_plain(q, k, sm), LSE_ATOL,
        ))
        got = attention.flash_attn_bwd(q, k, v, out, lse, dout, sm)
        ref = attention.attention_bwd_plain(q, k, v, out, lse, dout, sm)
        for name, a, b in zip(("dq", "dk", "dv"), got, ref):
            errs.append(check_rel(f"flash_attn_bwd {name} {shape}", a, b, FLASH_BWD_REL))
        if shape == TRAIN_ATTN_SHAPE:
            again = attention.flash_attn_bwd(q, k, v, out, lse, dout, sm)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"flash_attn_bwd {shape}: two launches differ")
            print(f"check flash_attn_bwd {shape}: two launches bitwise equal", flush=True)
        del q, k, v, dout, out, lse, got, ref
        torch.cuda.empty_cache()

    # many tiles, where the products bind: not on a main path
    big = [torch.randn((INNER_BATCH, 1500, 8, 64), device="cuda", generator=g).to(torch.bfloat16)
           for _ in range(4)]
    big_out, big_lse = attention.flash_attn_fwd(*big[:3], sm, with_lse=True)
    many = time_flash_bwd(card, *big[:3], big_out, big_lse, big[3], sm, plain_iters=2)
    del big, big_out, big_lse
    torch.cuda.empty_cache()

    q, k, v, dout = (
        torch.randn(TRAIN_ATTN_SHAPE, device="cuda", generator=g).to(torch.bfloat16)
        for _ in range(4)
    )
    out, lse = attention.flash_attn_fwd(q, k, v, sm, with_lse=True)
    timed = time_flash_bwd(card, q, k, v, out, lse, dout, sm, plain_iters=10)
    fwd = time_turns({
        "with lse": lambda: attention.flash_attn_fwd(q, k, v, sm, with_lse=True),
        "without": lambda: attention.flash_attn_fwd(q, k, v, sm),
    })
    torch.set_grad_enabled(True)
    print(
        f"time flash_attn_fwd {TRAIN_ATTN_SHAPE} [{card}]: with lse {spread(fwd['with lse'])}, "
        f"without {spread(fwd['without'])}", flush=True,
    )
    row = {
        "name": "flash_attn_bwd", "route": "cuda",
        "source": "segma_tpu_torch/csrc/flash_attn_bwd.cu",
        "replaces": "segma_tpu/ops/attention.py:148",
        "tpu_kernels": [
            "jax/experimental/pallas/ops/tpu/flash_attention.py:941 _flash_attention_bwd_dkv",
            "jax/experimental/pallas/ops/tpu/flash_attention.py:1287 _flash_attention_bwd_dq",
        ],
        "max_abs_err": max(errs), **timed,
        "many_tiles": {"shape": [INNER_BATCH, 1500, 8, 64], **many},
    }
    return row, {"lse_max_abs_err": max(lse_errs), "with_lse_max_abs_err": max(out_errs),
                 "train_shape_ms": median(fwd["without"]),
                 "train_shape_lse_ms": median(fwd["with lse"])}

# The f32 kernels' shapes: both main paths, then the edges of their tiling:
# one row, one short of, at and one past each edge. The forward: 128 query
# rows per work item (64 per consumer warpgroup), 32 keys per tile. The
# backward: 128 resident rows per work item (64 per consumer warpgroup), 32
# streamed rows per tile.
FLASH_F32_EDGE_S = (1, 31, 32, 33, 63, 64, 65, 127, 128, 129)
FLASH_F32_BWD_EDGE_S = (1, 31, 32, 33, 63, 64, 65, 95, 96, 97, 127, 128, 129)
FLASH_F32_SHAPES = ((INNER_BATCH, 1500, 8, 64), TRAIN_ATTN_SHAPE,
                    *((2, s, 3, 64) for s in FLASH_F32_EDGE_S))
FLASH_F32_BWD_SHAPES = (TRAIN_ATTN_SHAPE, *((2, s, 3, 64) for s in FLASH_F32_BWD_EDGE_S))


def f32_attention_bounds(b: int, s: int, h: int, d: int, products: int, tensors: int) -> dict:
    """The least time for ``products`` S x S x D f32 products against
    ``tensors`` (B, S, H, D) f32 tensors and one (B, H, S) f32 lse read or
    written once: ``bound_ms`` (``bound_by``) with the products in IEEE f32
    at the CUDA-core peak, ``bound_3xtf32_ms`` (``bound_3xtf32_by``) with
    each as three TF32 products at the tensor-core peak."""
    flops = 2 * products * b * h * s * s * d
    n_bytes = tensors * b * s * h * d * 4 + b * h * s * 4
    ms, by = bound_ms(flops, PEAK_F32_FLOPS, n_bytes)
    tf32_ms, tf32_by = bound_ms(3 * flops, PEAK_TF32_FLOPS, n_bytes)
    return {"bound_ms": ms, "bound_by": by, "bound_3xtf32_ms": tf32_ms,
            "bound_3xtf32_by": tf32_by}


def row_bounds(bd: dict) -> dict:
    """An f32 row's bounds: ``bound_ms`` the 3xTF32 one (the f32 kernels run
    their products as three TF32 products on the tensor cores, which meets
    the f32 bar), ``bound_cuda_cores_ms`` the products in IEEE f32 on the
    CUDA cores."""
    return {"bound_ms": bd["bound_3xtf32_ms"], "bound_by": bd["bound_3xtf32_by"],
            "bound_cuda_cores_ms": bd["bound_ms"]}


def grad_shares(got, ref) -> list[float]:
    """Each gradient's max |got - ref| over max(1, max|ref|), in float64."""
    return [float((a.double() - r).abs().max()) / max(1.0, float(r.abs().max()))
            for a, r in zip(got, ref)]


def flash_f32_checks(card: str) -> tuple[dict, dict]:
    """The f32 forward against ``attention_plain`` in f32 and in float64 and
    its LSE against ``attention_lse_plain`` at FLASH_F32_SHAPES, bitwise the
    same with and without the LSE and over two launches; the f32 backward
    against ``attention_bwd_plain`` in f32 and in float64 at
    FLASH_F32_BWD_SHAPES, bitwise over two launches. Then each timed in turns
    beside every SDPA backend that takes f32 (the refusals are printed), its
    plain version and its bounds (the f32 CUDA-core peak, and 3xTF32 at the
    tensor-core peak); at the training shape the backward's gradients and
    SDPA EFFICIENT's are printed against the float64 gradient (information,
    not a gate). Returns the two kernels' rows."""
    import torch

    from segma_tpu_torch.ops import attention

    torch.set_grad_enabled(False)
    g = torch.Generator(device="cuda").manual_seed(4)
    sm = 64**-0.5
    errs, errs64, lse_errs = [], [], []
    for shape in FLASH_F32_SHAPES:
        q, k, v = (torch.randn(shape, device="cuda", generator=g) for _ in range(3))
        out, lse = attention.flash_attn_fwd(q, k, v, sm, with_lse=True)
        errs.append(check_close(f"flash_attn_fwd f32 {shape}", out,
                                attention.attention_plain(q, k, v, sm, torch.float32),
                                FLASH_F32_ATOL))
        errs64.append(check_close(
            f"flash_attn_fwd f32 {shape} against float64", out,
            attention.attention_plain(q.double(), k.double(), v.double(), sm, torch.float64),
            FLASH_F32_ATOL))
        lse_errs.append(check_close(f"flash_attn_fwd f32 lse {shape}", lse,
                                    attention.attention_lse_plain(q, k, sm), LSE_F32_ATOL))
        if not torch.equal(out, attention.flash_attn_fwd(q, k, v, sm)):
            raise AssertionError(f"flash_attn_fwd f32 {shape}: output differs without the LSE")
        if not torch.equal(out, attention.flash_attn_fwd(q, k, v, sm, with_lse=True)[0]):
            raise AssertionError(f"flash_attn_fwd f32 {shape}: two launches differ")
        del q, k, v, out, lse
        torch.cuda.empty_cache()
    print(f"check flash_attn_fwd f32: bitwise equal with and without the LSE, and over two "
          f"launches, at {len(FLASH_F32_SHAPES)} shapes", flush=True)
    bwd_errs, bwd_errs64 = [], []
    for shape in FLASH_F32_BWD_SHAPES:
        q, k, v, dout = (torch.randn(shape, device="cuda", generator=g) for _ in range(4))
        out, lse = attention.flash_attn_fwd(q, k, v, sm, with_lse=True)
        got = attention.flash_attn_bwd(q, k, v, out, lse, dout, sm)
        ref = attention.attention_bwd_plain(q, k, v, out, lse, dout, sm)
        ref64 = attention.attention_bwd_plain(*(x.double() for x in (q, k, v, out, lse, dout)), sm)
        for name, a, b, c in zip(("dq", "dk", "dv"), got, ref, ref64):
            bwd_errs.append(check_rel(f"flash_attn_bwd f32 {name} {shape}", a, b, FLASH_F32_BWD_REL))
            bwd_errs64.append(check_rel(f"flash_attn_bwd f32 {name} {shape} against float64", a, c,
                                        FLASH_F32_BWD_REL))
        again = attention.flash_attn_bwd(q, k, v, out, lse, dout, sm)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"flash_attn_bwd f32 {shape}: two launches differ")
        del q, k, v, dout, out, lse, got, ref, ref64, again
        torch.cuda.empty_cache()
    print(f"check flash_attn_bwd f32: bitwise equal over two launches at "
          f"{len(FLASH_F32_BWD_SHAPES)} shapes", flush=True)

    timed = {}
    for label, shape, iters, plain_iters in (("serving", (INNER_BATCH, 1500, 8, 64), 5, 2),
                                             ("training", TRAIN_ATTN_SHAPE, 20, 10)):
        q, k, v = (torch.randn(shape, device="cuda", generator=g) for _ in range(3))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        times = time_turns({"kernel": lambda: attention.flash_attn_fwd(q, k, v, sm),
                            "kernel with lse": lambda: attention.flash_attn_fwd(q, k, v, sm,
                                                                                with_lse=True),
                            **sdpa_calls(qt, kt, vt, sm)}, iters=iters)
        for name, t in times.items():
            print(f"time flash_attn_fwd f32 {name} {shape} [{card}]: {spread(t)}", flush=True)
        b, s, h, d = shape
        library = {n: median(t) for n, t in times.items() if n.startswith("sdpa")}
        timed[label] = {
            "ms": median(times["kernel"]), "lse_ms": median(times["kernel with lse"]),
            "plain_ms": time_ms(lambda: attention.attention_plain(q, k, v, sm, torch.float32),
                                iters=plain_iters),
            "library_backends_ms": library,
            "library_ms": min(library.values()) if library else None,
            "bound": f32_attention_bounds(b, s, h, d, products=2, tensors=4),
        }
        if label == "training":
            dout = torch.randn(shape, device="cuda", generator=g)
            out, lse = attention.flash_attn_fwd(q, k, v, sm, with_lse=True)
            bcalls = sdpa_calls(qt, kt, vt, sm, dout.transpose(1, 2).contiguous())
            bt = time_turns({
                "kernel": lambda: attention.flash_attn_bwd(q, k, v, out, lse, dout, sm),
                **bcalls,
            })
            # the exact gradient: forward and backward in float64
            q64, k64, v64, do64 = (x.double() for x in (q, k, v, dout))
            exact = attention.attention_bwd_plain(
                q64, k64, v64, attention.attention_plain(q64, k64, v64, sm, torch.float64),
                attention.attention_lse_plain(q64, k64, sm), do64, sm)
            del q64, k64, v64, do64
            shares = {"kernel": grad_shares(attention.flash_attn_bwd(q, k, v, out, lse, dout, sm),
                                            exact)}
            for name, call in bcalls.items():
                shares[name] = grad_shares((x.transpose(1, 2) for x in call()), exact)
            for name, sh in shares.items():
                print(f"error flash_attn_bwd f32 {name} {shape} against the float64 gradient: "
                      f"dq, dk, dv max abs err / max(1, max|ref|) = "
                      f"{', '.join(f'{x:.3e}' for x in sh)} (bar {FLASH_F32_BWD_REL})",
                      flush=True)
            del exact
            for name, t in bt.items():
                print(f"time flash_attn_bwd f32 {name} {shape} [{card}]: {spread(t)}", flush=True)
            blib = {n: median(t) for n, t in bt.items() if n.startswith("sdpa")}
            bwd_timed = {
                "ms": median(bt["kernel"]),
                "plain_ms": time_ms(lambda: attention.attention_bwd_plain(q, k, v, out, lse, dout,
                                                                          sm), iters=plain_iters),
                "library_backends_ms": blib, "library_ms": min(blib.values()) if blib else None,
                "bound": f32_attention_bounds(b, s, h, d, products=5, tensors=8),
                "grad_error_shares": shares,
            }
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    torch.set_grad_enabled(True)

    def bounds_text(bd: dict, ms: float) -> str:
        return (f"bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}, f32 CUDA-core peak; "
                f"{100 * bd['bound_ms'] / ms:.1f}% of it), 3xTF32 bound "
                f"{bd['bound_3xtf32_ms']:.4f} ms ({bd['bound_3xtf32_by']}, TF32 tensor-core peak; "
                f"{100 * bd['bound_3xtf32_ms'] / ms:.1f}% of it)")

    for label, t in timed.items():
        print(f"time flash_attn_fwd f32 {label} [{card}]: kernel {t['ms']:.4f} ms (with lse "
              f"{t['lse_ms']:.4f}), plain {t['plain_ms']:.4f} ms, fastest sdpa {t['library_ms']} "
              f"ms; {bounds_text(t['bound'], t['ms'])}", flush=True)
    print(f"time flash_attn_bwd f32 {TRAIN_ATTN_SHAPE} [{card}]: kernels {bwd_timed['ms']:.4f} "
          f"ms, plain {bwd_timed['plain_ms']:.4f} ms, fastest sdpa backward "
          f"{bwd_timed['library_ms']} ms; {bounds_text(bwd_timed['bound'], bwd_timed['ms'])}",
          flush=True)
    serve, train = timed["serving"], timed["training"]
    fwd_row = {
        "name": "flash_attn_fwd_f32", "route": "cuda",
        "source": "segma_tpu_torch/csrc/flash_attn_f32.cu",
        "replaces": "segma_tpu/ops/attention.py:148",
        "max_abs_err": max(errs), "max_abs_err_vs_float64": max(errs64),
        "lse_max_abs_err": max(lse_errs), "ms": serve["ms"], "lse_ms": serve["lse_ms"],
        "plain_ms": serve["plain_ms"], **row_bounds(serve["bound"]),
        "library_ms": serve["library_ms"], "library_backends_ms": serve["library_backends_ms"],
        "train_shape": list(TRAIN_ATTN_SHAPE), "train_shape_ms": train["ms"],
        "train_shape_lse_ms": train["lse_ms"], "train_shape_plain_ms": train["plain_ms"],
        "train_shape_bound_ms": train["bound"]["bound_3xtf32_ms"],
        "train_shape_bound_cuda_cores_ms": train["bound"]["bound_ms"],
        "train_shape_library_ms": train["library_ms"],
        "train_shape_library_backends_ms": train["library_backends_ms"],
    }
    bwd_row = {
        "name": "flash_attn_bwd_f32", "route": "cuda",
        "source": "segma_tpu_torch/csrc/flash_attn_bwd_f32.cu",
        "replaces": "segma_tpu/ops/attention.py:148",
        "tpu_kernels": [
            "jax/experimental/pallas/ops/tpu/flash_attention.py:941 _flash_attention_bwd_dkv",
            "jax/experimental/pallas/ops/tpu/flash_attention.py:1287 _flash_attention_bwd_dq",
        ],
        "max_abs_err": max(bwd_errs), "max_abs_err_vs_float64": max(bwd_errs64),
        "ms": bwd_timed["ms"], "plain_ms": bwd_timed["plain_ms"], **row_bounds(bwd_timed["bound"]),
        "grad_error_shares": bwd_timed["grad_error_shares"],
        "library_ms": bwd_timed["library_ms"],
        "library_backends_ms": bwd_timed["library_backends_ms"],
    }
    return fwd_row, bwd_row


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


def surgical_hydra_config(precision: str = "bf16"):
    """``config/default.yml`` with model.name=surgical_hydra,
    model.config.encoder=whisper_base_random and train.precision, built in
    code so that the script needs no pyyaml; tests/test_torch_train.py holds
    it equal to ``load_config``."""
    from segma_tpu_torch.config import (
        AudioConfig, Config, DataConfig, LSTMConfig, ModelConfig,
        SurgicalHydraConfig, TrainConfig,
    )

    return Config(
        data=DataConfig(classes=["KCHI", "OCH", "MAL", "FEM"], dataset_path="data/baby_train"),
        audio=AudioConfig(
            chunk_duration_s=4.0, sample_rate=16_000, strict_frames=False,
            reference_tail=False,
        ),
        model=ModelConfig(
            name="surgical_hydra", chkp_path="models",
            config=SurgicalHydraConfig(
                encoder="whisper_base_random", encoder_layers=[],
                reduction="weighted",
                lstm=LSTMConfig(hidden_size=128, num_layers=2, bidirectional=True, dropout=0.5),
                classifier=256,
            ),
        ),
        train=TrainConfig(precision=precision),
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
            reset_launches()
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
        kernels = profile_run(card, "serve", lambda: run_inference_on_audios(
            cfg, wav_dir, None, Path(tmp) / "out_prof", model=model, device="cuda",
            batch_size=INNER_BATCH,
        ), wall)
        # the log-mel kernel reflects the edges as it loads: no padded copy
        padding = [k for k in kernels if "reflection_pad" in k.lower()]
        if padding:
            raise AssertionError(f"serving ran a reflect-padding kernel: {padding}")
        print("check serving profile: no reflect-padding kernel", flush=True)
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

TRAIN_CLASSES = ["KCHI", "OCH", "MAL", "FEM"]  # data.classes of config/default.yml
TRAIN_FILES, VAL_FILES, TEST_FILES = 8, 4, 1  # a test split is required by the dataset
TRAIN_FILE_S = 64.0
TRAIN_EPOCHS = 2
LOSS_ATOL = 2e-2  # card (bf16 kernels) against CPU (bf16 plain path), step-1 loss
WARM_STEP_REPEATS = 5


def write_dataset(root: Path, classes: list[str], n_files: tuple[int, int, int],
                  duration_s: float, seed: int = 0) -> None:
    """A synthetic SegmaFileDataset tree (wav/ aa/ rttm/ uem/ and the split
    lists), the layout of scripts/generate_data.py: per file, 4 to 9 labeled
    events of 0.2 to 3 s, label i rendered as a 440 * (i + 1) Hz tone in a
    16 kHz PCM16 WAV, over a noise floor at -40 dBFS.

    The noise floor matters for a randomly initialised HuBERT: its biases
    are zero, so an all-silent crop maps to exactly-zero activations, and
    each post-norm LayerNorm's backward then scales the gradient by
    1 / sqrt(eps) (two per layer, ~1e60 over twelve), which overflows, in
    the JAX package as in the port (tests/test_torch_train.py,
    test_silent_batch_gradients_explode_as_in_jax)."""
    from segma_tpu_torch.annotation import AudioAnnotation

    rng = np.random.default_rng(seed)
    for sub in ("wav", "aa", "rttm", "uem"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    uid_iter = iter(f"{i:04d}" for i in range(sum(n_files)))
    n = int(duration_s * 16_000)
    for split, count in zip(("train", "val", "test"), n_files):
        uids = [next(uid_iter) for _ in range(count)]
        (root / f"{split}.txt").write_text("".join(u + "\n" for u in uids))
        for uid in uids:
            k = int(rng.integers(4, 10))
            starts = np.sort(rng.uniform(0.0, duration_s - 3.0, size=k))
            lengths = rng.uniform(0.2, 3.0, size=k)
            which = rng.integers(len(classes), size=k)
            events = [AudioAnnotation(uid, float(t0), float(dt), classes[c])
                      for t0, dt, c in zip(starts, lengths, which)]
            track = (0.01 * rng.standard_normal(n)).astype(np.float32)
            for ev, c in zip(events, which):
                a = int(ev.start_time_s * 16_000)
                b = min(n, a + int(ev.duration_s * 16_000))
                track[a:b] = np.sin(2 * np.pi * 440 * (c + 1) * np.arange(b - a) / 16_000)
            with wave.open(str(root / "wav" / f"{uid}.wav"), "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(16_000)
                w.writeframes((np.clip(track, -1, 1) * 32767).astype("<i2").tobytes())
            (root / "aa" / f"{uid}.aa").write_text("".join(ev.write() + "\n" for ev in events))
            (root / "rttm" / f"{uid}.rttm").write_text(
                "".join(ev.to_rttm() + "\n" for ev in events))
            (root / "uem" / f"{uid}.uem").write_text(f"{uid} NA 0.000 {duration_s}")


def surgical_hubert_hydra_config(dataset_path: Path, precision: str = "bf16"):
    """``config/default.yml`` with model.name=surgical_hubert_hydra,
    audio.strict_frames=true, data.dataset_path, train.seed=0,
    train.max_epochs=2, train.dataloader.num_workers=1 and train.precision,
    built in code so that the script needs no pyyaml;
    tests/test_torch_train.py holds it equal to ``load_config``."""
    from segma_tpu_torch.config import (
        AudioConfig, Config, DataConfig, DataloaderConfig, ModelConfig,
        SurgicalHubertHydraConfig, TrainConfig,
    )

    return Config(
        data=DataConfig(classes=list(TRAIN_CLASSES), dataset_path=str(dataset_path)),
        audio=AudioConfig(chunk_duration_s=4.0, sample_rate=16_000, strict_frames=True),
        model=ModelConfig(
            name="surgical_hubert_hydra", chkp_path="models",
            config=SurgicalHubertHydraConfig(
                wav_encoder="hubert_base", encoder_layers=[], reduction="weighted",
                classifier=256,
            ),
        ),
        train=TrainConfig(
            lr=1e-3, batch_size=32, max_epochs=TRAIN_EPOCHS, seed=0, precision=precision,
            dataloader=DataloaderConfig(num_workers=1),
        ),
    )


def phase_train(card: str) -> dict:
    """Train full-width HuBERT-base ``surgical_hubert_hydra`` (random
    weights from seed 0) for two epochs through ``Trainer.fit`` on a
    synthetic dataset, with its checks; returns the launch counts."""
    import warnings

    import torch

    from segma_tpu_torch.data import SegmaFileDataset, SegmentationDataLoader
    from segma_tpu_torch.models import Models
    from segma_tpu_torch.ops import attention, logmel
    from segma_tpu_torch.train import Trainer
    from segma_tpu_torch.utils.encoders import MultiLabelEncoder

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "data"
        write_dataset(root, TRAIN_CLASSES, (TRAIN_FILES, VAL_FILES, TEST_FILES), TRAIN_FILE_S)
        cfg = surgical_hubert_hydra_config(root)
        enc = MultiLabelEncoder(cfg.data.classes)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # random encoder weights, on purpose
            model = Models["surgical_hubert_hydra"](
                enc, cfg, device="cuda", generator=torch.Generator().manual_seed(0))
            model_cpu = Models["surgical_hubert_hydra"](
                enc, cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        n_layers = model.module.enc_cfg.n_layers
        ds = SegmaFileDataset.from_config(cfg)
        ds.load(use_cache=False)
        dm = SegmentationDataLoader(ds, enc, cfg, model.conv_settings)

        # step 1's batch without dropout: card (kernels, training route) against
        # CPU (plain path)
        sampler = dm.train_dataloader().sampler  # with one worker, it makes every batch
        sampler.reseed(0)
        batch = sampler.sample_batch(cfg.train.batch_size)
        x, y = (torch.from_numpy(batch[k]) for k in ("x", "y"))
        t0 = time.perf_counter()
        with torch.no_grad():
            loss_cpu = float(model_cpu.loss(model_cpu.module(x), y)[0])
        cpu_s = time.perf_counter() - t0
        # with autograd recording, as in training: the forward takes FlashAttention
        loss_card = float(model.loss(model.module(x.cuda()), y.cuda())[0].detach())
        print(f"check surgical_hubert_hydra step-1 loss, card vs CPU (batch 32, bf16, dropout 0): "
              f"card {loss_card:.6f}, CPU {loss_cpu:.6f}, |diff| {abs(loss_card - loss_cpu):.3e} "
              f"(atol {LOSS_ATOL}; CPU forward {cpu_s:.1f} s)", flush=True)
        if not abs(loss_card - loss_cpu) <= LOSS_ATOL:
            raise AssertionError("step-1 loss on the card differs from the CPU plain path")
        del model_cpu

        frozen_before = {k: v.clone() for k, v in model.split_state()[1].items()}
        trainer = Trainer(model=model, config=cfg, run_dir=Path(tmp) / "run")
        grad_norms: dict[str, float] = {}
        step = trainer.train_step

        def first_step_probe(b, generator):
            out = step(b, generator)
            if not grad_norms:
                for name, p in model.module.named_parameters():
                    if ".attention." in name and name.endswith(("q_proj.weight", "k_proj.weight",
                                                                "v_proj.weight")):
                        grad_norms[name] = float(p.grad.norm()) if p.grad is not None else 0.0
            return out

        trainer.train_step = first_step_probe
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        result = trainer.fit(dm)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"flash_attn_fwd": attention.launches, "flash_attn_bwd": attention.bwd_launches,
                    "logmel": logmel.launches}
        peak = torch.cuda.max_memory_allocated()

        history = result["history"]
        n_steps, n_val = len(dm.train_dataloader()), len(dm.val_dataloader())
        if len(history) != TRAIN_EPOCHS:
            raise AssertionError(f"fit ran {len(history)} epochs, not {TRAIN_EPOCHS}")
        for h in history:
            print(f"train epoch {h['epoch']} [{card}]: train/loss {h['train/loss']:.6f}, "
                  f"val/loss {h['val/loss']:.6f}, val/f1_score {h['val/f1_score']:.4f}, "
                  f"train time {h['train_time_s']:.3f} s, epoch time {h['time_s']:.3f} s",
                  flush=True)
            if not all(np.isfinite([h["train/loss"], h["val/loss"]])):
                raise AssertionError(f"epoch {h['epoch']}: non-finite loss")
        bad = {k: v for k, v in grad_norms.items() if not (np.isfinite(v) and v > 0)}
        if len(grad_norms) != 3 * n_layers or bad:
            raise AssertionError(f"q/k/v projection gradients after step 1: {bad or grad_norms}")
        print(f"check q/k/v projection gradient norms after step 1: {len(grad_norms)} weights, "
              f"min {min(grad_norms.values()):.3e}, max {max(grad_norms.values()):.3e}", flush=True)
        after = model.split_state()[1]
        changed = [k for k, v in after.items() if not torch.equal(v, frozen_before[k])]
        if changed or not frozen_before:
            raise AssertionError(f"frozen feature_extractor parameters changed: {changed}")
        print(f"check frozen front end unchanged: {len(frozen_before)} tensors", flush=True)
        want = {"flash_attn_fwd": n_layers * (n_steps + n_val) * TRAIN_EPOCHS,
                "flash_attn_bwd": n_layers * n_steps * TRAIN_EPOCHS, "logmel": 0}
        if launches != want:
            raise AssertionError(f"training launch counts {launches} != {want}")

        warm = history[-1]["train_time_s"]
        audio_s = n_steps * cfg.train.batch_size * cfg.audio.chunk_duration_s
        print(
            f"train slice [{card}]: {TRAIN_EPOCHS} epochs of {n_steps} steps (batch "
            f"{cfg.train.batch_size}, 4 s crops) + {n_val} val batches, fit wall {wall:.3f} s; "
            f"warm step {1e3 * warm / n_steps:.3f} ms, {audio_s / warm:.2f} audio s per s; "
            f"peak device memory {peak} B ({peak / 2**30:.2f} GiB); launches {launches} = "
            f"{launches['flash_attn_fwd'] // (n_steps + n_val) // TRAIN_EPOCHS} fwd per step or "
            f"val batch, {launches['flash_attn_bwd'] // n_steps // TRAIN_EPOCHS} bwd per step",
            flush=True,
        )
        gen = torch.Generator("cuda").manual_seed(1)
        warm_batch = trainer._put(batch)
        # the same step repeated on one batch, without the loader: the
        # spread of its wall time is the host's
        step_ms = []
        for _ in range(WARM_STEP_REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_step(warm_batch, gen)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
        print(f"train step repeated on one batch [{card}]: {WARM_STEP_REPEATS} steps, median "
              f"{median(step_ms):.3f} ms (min {min(step_ms):.3f}, max {max(step_ms):.3f})",
              flush=True)
        profile_run(card, "train step", lambda: trainer.train_step(warm_batch, gen),
                    warm / n_steps)
    return launches


def reset_launches() -> None:
    """Every kernel wrapper's launch count to 0."""
    from segma_tpu_torch.ops import attention, logmel

    logmel.launches = 0
    attention.launches = attention.bwd_launches = 0
    attention.launches_f32 = attention.bwd_launches_f32 = 0


def read_launches() -> dict:
    from segma_tpu_torch.ops import attention, logmel

    return {"logmel": logmel.launches, "flash_attn_fwd": attention.launches,
            "flash_attn_bwd": attention.bwd_launches,
            "flash_attn_fwd_f32": attention.launches_f32,
            "flash_attn_bwd_f32": attention.bwd_launches_f32}


def tf32_flags() -> tuple[bool, bool]:
    import torch

    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


def phase_serve_f32(card: str) -> dict:
    """The serving slice's WAV through full-width ``surgical_hydra`` with
    train.precision=f32, under PyTorch's default TF32 flags: the f32
    forward kernel on every attention, the flags unchanged after the run,
    the RTTM parsed, device time by kernel, and the card's logits for the
    first two chunks against the same model on the CPU f32 plain path at
    LOGITS_F32_ATOL. Returns the launch counts of the run."""
    import warnings

    import torch

    from segma_tpu_torch.annotation import AudioAnnotation
    from segma_tpu_torch.inference import Chunkyfier, _bucket, run_inference_on_audios
    from segma_tpu_torch.models import Models
    from segma_tpu_torch.models.geometry import ConvolutionSettings
    from segma_tpu_torch.utils.encoders import MultiLabelEncoder

    cfg = surgical_hydra_config("f32")
    enc = MultiLabelEncoder(cfg.data.classes)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # random encoder weights, on purpose
        model, model_cpu = (
            Models["surgical_hydra"](enc, cfg, device=dev, generator=torch.Generator().manual_seed(0))
            for dev in ("cuda", "cpu")
        )
    n_layers = model.module.enc_cfg.n_layers
    ck = Chunkyfier(INNER_BATCH, cfg.audio.chunk_duration_f, ConvolutionSettings((320,), (320,), (0,)))
    n_samples = N_CHUNKS * ck.chunk_stride + ck.missing_n_frames + 8_000
    n_chunks = _bucket(-(-ck.total_frames(n_samples) // ck.n_windows))
    n_inner = -(-n_chunks // min(INNER_BATCH, n_chunks))
    flags = tf32_flags()
    with tempfile.TemporaryDirectory() as tmp:
        wav_dir = Path(tmp) / "wav"
        wav_dir.mkdir()
        pcm = write_wav(wav_dir / "smoke.wav", n_samples)
        walls = []
        for run in range(2):
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            run_inference_on_audios(cfg, wav_dir, None, Path(tmp) / f"out{run}", model=model,
                                    device="cuda", batch_size=INNER_BATCH)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            launches = read_launches()
            want = {"logmel": n_inner, "flash_attn_fwd": 0, "flash_attn_bwd": 0,
                    "flash_attn_fwd_f32": n_layers * n_inner, "flash_attn_bwd_f32": 0}
            if launches != want:
                raise AssertionError(f"f32 serving launch counts {launches} != {want}")
        if tf32_flags() != flags:
            raise AssertionError(f"f32 serving changed the TF32 flags {flags} to {tf32_flags()}")
        rttm = (Path(tmp) / "out1" / "raw_rttm" / "smoke.rttm").read_text()
        segs = [AudioAnnotation.from_rttm(ln) for ln in rttm.splitlines() if ln.strip()]
        if any(s.duration_s <= 0 or s.label not in cfg.data.classes for s in segs):
            raise AssertionError("f32 RTTM holds a malformed segment")
        print(f"slice f32 serving [{card}]: walls {walls[0]:.3f} s and {walls[1]:.3f} s "
              f"({n_samples / 16_000 / walls[1]:.2f}x real time warm), {len(segs)} RTTM "
              f"segments, launches {launches}, TF32 flags (cuDNN, matmul) {flags} before and "
              f"after", flush=True)
        profile_run(card, "serve f32", lambda: run_inference_on_audios(
            cfg, wav_dir, None, Path(tmp) / "out_prof", model=model, device="cuda",
            batch_size=INNER_BATCH,
        ), walls[1])
    x = torch.from_numpy(pcm[: 2 * ck.chunk_stride + ck.missing_n_frames].astype(np.float32) / 32768.0)
    chunks = torch.stack([x[i * ck.chunk_stride : i * ck.chunk_stride + ck.chunk_duration_f]
                          for i in range(2)])
    with torch.inference_mode():
        got = model.apply(chunks.cuda()).cpu()
        ref = model_cpu.apply(chunks)
    check_close("surgical_hydra logits, card vs CPU (2 chunks, f32, default TF32 flags)", got, ref,
                LOGITS_F32_ATOL)
    return launches


def phase_train_f32(card: str) -> dict:
    """Train full-width HuBERT-base ``surgical_hubert_hydra`` with
    train.precision=f32 for two epochs through ``Trainer.fit`` on the card,
    under PyTorch's default TF32 flags, writing checkpoints; the model is
    ``checkpoint.build_model``'s, its weights drawn from train.seed. Checked:
    finite losses, the f32 forward and backward kernels on every attention
    and no bf16 one, the checkpoints (top-k, last/, best.ckpt, the frozen
    fingerprint). Then the run directory is served through
    ``run_inference_on_audios(checkpoint=...)`` on the card, RTTMs out, and
    the model ``load_model_for_inference`` rebuilds gives the logits of the
    in-memory model at the same epoch, bit for bit: the best epoch's (a
    snapshot taken during fit) for best.ckpt, the final weights for last/.
    Returns the training run's launch counts."""
    import warnings

    import torch

    from segma_tpu_torch import checkpoint
    from segma_tpu_torch.annotation import AudioAnnotation
    from segma_tpu_torch.data import SegmaFileDataset, SegmentationDataLoader
    from segma_tpu_torch.inference import InferencePipeline, _load_mono, run_inference_on_audios
    from segma_tpu_torch.train import Trainer

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "data"
        write_dataset(root, TRAIN_CLASSES, (TRAIN_FILES, VAL_FILES, TEST_FILES), TRAIN_FILE_S)
        cfg = surgical_hubert_hydra_config(root, "f32")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # random encoder weights, on purpose
            model = checkpoint.build_model(cfg, device="cuda")
        n_layers = model.module.enc_cfg.n_layers
        ds = SegmaFileDataset.from_config(cfg)
        ds.load(use_cache=False)
        dm = SegmentationDataLoader(ds, model.label_encoder, cfg, model.conv_settings)
        run_dir = Path(tmp) / "run"
        trainer = Trainer(model=model, config=cfg, run_dir=run_dir)
        best_state: dict = {}
        ckpt_step = trainer.ckpt.step

        def snapshot_best(epoch, score, trainable, meta, **state):
            before = trainer.ckpt.best_path
            ckpt_step(epoch, score, trainable, meta, **state)
            if trainer.ckpt.best_path != before:
                best_state.clear()
                best_state.update({k: v.clone() for k, v in model.module.state_dict().items()})

        trainer.ckpt.step = snapshot_best
        flags = tf32_flags()
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        history = trainer.fit(dm)["history"]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        n_steps, n_val = len(dm.train_dataloader()), len(dm.val_dataloader())
        want = {"logmel": 0, "flash_attn_fwd": 0, "flash_attn_bwd": 0,
                "flash_attn_fwd_f32": n_layers * (n_steps + n_val) * TRAIN_EPOCHS,
                "flash_attn_bwd_f32": n_layers * n_steps * TRAIN_EPOCHS}
        if launches != want:
            raise AssertionError(f"f32 training launch counts {launches} != {want}")
        if tf32_flags() != flags:
            raise AssertionError(f"f32 training changed the TF32 flags {flags} to {tf32_flags()}")
        for h in history:
            print(f"train f32 epoch {h['epoch']} [{card}]: train/loss {h['train/loss']:.6f}, "
                  f"val/loss {h['val/loss']:.6f}, train time {h['train_time_s']:.3f} s, epoch "
                  f"time {h['time_s']:.3f} s", flush=True)
            if not all(np.isfinite([h["train/loss"], h["val/loss"]])):
                raise AssertionError(f"f32 epoch {h['epoch']}: non-finite loss")
        warm = history[-1]["train_time_s"]
        print(f"train f32 slice [{card}]: fit wall {wall:.3f} s, warm step "
              f"{1e3 * warm / n_steps:.3f} ms, launches {launches}", flush=True)

        ckdir = run_dir / "checkpoints"
        kept = sorted(p.name for p in ckdir.glob("epoch=*"))
        best = (ckdir / "best.ckpt").resolve()
        meta = checkpoint.load_meta(ckdir / "last")
        fingerprint = checkpoint.frozen_fingerprint(checkpoint.flax_split(model)[1])
        if (len(kept) != TRAIN_EPOCHS or best.name not in kept or meta["epoch"] != TRAIN_EPOCHS - 1
                or meta["frozen_fingerprint"] != fingerprint):
            raise AssertionError(f"checkpoints: kept {kept}, best {best.name}, last meta {meta}")
        print(f"check f32 checkpoints: {kept}, best.ckpt -> {best.name}, last/ epoch "
              f"{meta['epoch']}, frozen fingerprint {fingerprint[:12]}", flush=True)

        x = torch.from_numpy(np.stack([
            write_wav(Path(tmp) / f"probe{i}.wav", cfg.audio.chunk_duration_f, seed=10 + i)
            for i in range(4)]).astype(np.float32) / 32768.0).cuda()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            served_last = checkpoint.load_model_for_inference(cfg, ckdir / "last", device="cuda")
            served_best = checkpoint.load_model_for_inference(cfg, run_dir, device="cuda")
        pairs = [("last/", served_last, model.apply(x))]
        model.module.load_state_dict(best_state)  # the in-memory model at the best epoch
        pairs.append((f"best.ckpt ({best.name})", served_best, model.apply(x)))
        for label, served, want_logits in pairs:
            got = served.apply(x)
            diff = float((got - want_logits).abs().max())
            if not torch.equal(got, want_logits):
                raise AssertionError(f"served {label} logits differ from the trained model's "
                                     f"by up to {diff:.3e}")
            print(f"check served {label} logits equal the in-memory model's at that epoch "
                  f"(4 chunks, bitwise; max |diff| {diff})", flush=True)
        del served_last, served_best

        # serve the run directory (its best.ckpt) on the card, and the in-memory
        # model at that epoch, each threshold at the median of the label's
        # frame probabilities on the test file so that both write segments
        test_wavs = [root / "wav" / f"{u}.wav" for u in (root / "test.txt").read_text().split()]
        pipe = InferencePipeline(model, batch_size=INNER_BATCH, device="cuda")
        probs = np.concatenate([
            1 / (1 + np.exp(-pipe.logits_for_audio(_load_mono(p)))) for p in test_wavs])
        thresholds = {label: {"lower_bound": float(np.median(probs[:, i])), "upper_bound": 1.0}
                      for i, label in enumerate(model.label_encoder.base_labels)}
        reset_launches()
        files = run_inference_on_audios(cfg, root / "wav", run_dir, Path(tmp) / "served",
                                        uris=root / "test.txt", thresholds=thresholds,
                                        device="cuda", batch_size=INNER_BATCH)
        torch.cuda.synchronize()
        served_launches = read_launches()
        run_inference_on_audios(cfg, root / "wav", None, Path(tmp) / "in_memory", model=model,
                                uris=root / "test.txt", thresholds=thresholds, device="cuda",
                                batch_size=INNER_BATCH)
        if files != test_wavs or served_launches["flash_attn_fwd_f32"] == 0:
            raise AssertionError(f"served {files} with launches {served_launches}")
        n_segs = 0
        for p in files:
            rttm = (Path(tmp) / "served" / "raw_rttm" / f"{p.stem}.rttm").read_text()
            if rttm != (Path(tmp) / "in_memory" / "raw_rttm" / f"{p.stem}.rttm").read_text():
                raise AssertionError(f"{p.name}: the checkpoint's RTTM differs from the trained "
                                     "model's")
            segs = [AudioAnnotation.from_rttm(ln) for ln in rttm.splitlines() if ln.strip()]
            if not segs or any(s.duration_s <= 0 or s.label not in cfg.data.classes for s in segs):
                raise AssertionError(f"{p.name}: served RTTM is empty or malformed")
            n_segs += len(segs)
        print(f"check f32 serving of the checkpoint [{card}]: {len(files)} file(s), {n_segs} "
              f"RTTM segments (thresholds at the median probability), the same RTTM as the "
              f"in-memory model's; launches {served_launches}", flush=True)
        sampler = dm.train_dataloader().sampler
        sampler.reseed(0)
        batch = trainer._put(sampler.sample_batch(cfg.train.batch_size))
        gen = torch.Generator("cuda").manual_seed(1)
        trainer.train_step(batch, gen)
        profile_run(card, "train f32 step", lambda: trainer.train_step(batch, gen), warm / n_steps)
    return launches


# -- the reference workflow: exact resume, snapshots, predict, tune, evaluate --------

WHISPER_BASE = dict(d_model=512, encoder_attention_heads=8, encoder_layers=6,
                    encoder_ffn_dim=2048, num_mel_bins=80, max_source_positions=1500)
HUBERT_BASE = dict(hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
                   intermediate_size=3072, conv_dim=[512] * 7, conv_kernel=[10, 3, 3, 3, 3, 2, 2],
                   conv_stride=[5, 2, 2, 2, 2, 2, 2], num_conv_pos_embeddings=128,
                   num_conv_pos_embedding_groups=16)
TUNE_GRID = 10  # tune.main's default precision 0.1: round(linspace(0, 1, 10), 1)


def write_safetensors(path: Path, tensors: dict[str, np.ndarray]) -> None:
    """An F32 ``.safetensors`` file as HF's ``save_pretrained`` writes one: a
    u64 little-endian header length, the JSON header (padded to 8 bytes),
    then the tensors' bytes in order."""
    import struct

    header: dict = {"__metadata__": {"format": "pt"}}
    offset = 0
    for name, a in tensors.items():
        header[name] = {"dtype": "F32", "shape": list(a.shape),
                        "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with path.open("wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for a in tensors.values():
            f.write(np.ascontiguousarray(a, "<f4").tobytes())


def _snapshot_tensors(seed: int):
    rng = np.random.default_rng(seed)

    def weight(*shape: int) -> np.ndarray:  # N(0, 1 / fan_in), fan_in over all but dim 0
        return (rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))).astype(np.float32)

    def vec(n: int, base: float = 0.0) -> np.ndarray:
        return (base + 0.02 * rng.standard_normal(n)).astype(np.float32)

    return weight, vec


def write_whisper_snapshot(out: Path, seed: int, dims: dict = WHISPER_BASE
                           ) -> dict[str, np.ndarray]:
    """A random Whisper encoder snapshot (Whisper-base unless ``dims`` says
    otherwise) in HF's layout: config.json and model.safetensors with
    ``model.encoder.*`` keys (k_proj without bias). Returns the tensors
    written."""
    weight, vec = _snapshot_tensors(seed)
    d, ffn = dims["d_model"], dims["encoder_ffn_dim"]
    t = {"model.encoder.conv1.weight": weight(d, dims["num_mel_bins"], 3),
         "model.encoder.conv1.bias": vec(d),
         "model.encoder.conv2.weight": weight(d, d, 3), "model.encoder.conv2.bias": vec(d),
         "model.encoder.embed_positions.weight":
             (0.02 * np.random.default_rng(seed + 1).standard_normal(
                 (dims["max_source_positions"], d))).astype(np.float32)}
    for i in range(dims["encoder_layers"]):
        pre = f"model.encoder.layers.{i}."
        t[pre + "self_attn_layer_norm.weight"] = vec(d, 1.0)
        t[pre + "self_attn_layer_norm.bias"] = vec(d)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            t[pre + f"self_attn.{proj}.weight"] = weight(d, d)
            if proj != "k_proj":
                t[pre + f"self_attn.{proj}.bias"] = vec(d)
        t[pre + "final_layer_norm.weight"] = vec(d, 1.0)
        t[pre + "final_layer_norm.bias"] = vec(d)
        t[pre + "fc1.weight"], t[pre + "fc1.bias"] = weight(ffn, d), vec(ffn)
        t[pre + "fc2.weight"], t[pre + "fc2.bias"] = weight(d, ffn), vec(d)
    t["model.encoder.layer_norm.weight"], t["model.encoder.layer_norm.bias"] = vec(d, 1.0), vec(d)
    out.mkdir(parents=True)
    (out / "config.json").write_text(json.dumps({"model_type": "whisper", **dims}))
    write_safetensors(out / "model.safetensors", t)
    return t


def write_hubert_snapshot(out: Path, seed: int, dims: dict = HUBERT_BASE
                          ) -> dict[str, np.ndarray]:
    """A random HuBERT snapshot (HuBERT-base unless ``dims`` says otherwise)
    in HF's ``HubertModel`` layout:
    config.json and model.safetensors, the positional conv weight-normed as
    ``parametrizations.weight.original0`` (g, (1, 1, k)) and ``original1``
    (v). Returns the tensors written."""
    weight, vec = _snapshot_tensors(seed)
    h, ffn = dims["hidden_size"], dims["intermediate_size"]
    t: dict[str, np.ndarray] = {}
    c_in = 1
    for i, (c, k) in enumerate(zip(dims["conv_dim"], dims["conv_kernel"])):
        t[f"feature_extractor.conv_layers.{i}.conv.weight"] = weight(c, c_in, k)
        c_in = c
    c = dims["conv_dim"][0]
    t["feature_extractor.conv_layers.0.layer_norm.weight"] = vec(c, 1.0)
    t["feature_extractor.conv_layers.0.layer_norm.bias"] = vec(c)
    t["feature_projection.layer_norm.weight"] = vec(c, 1.0)
    t["feature_projection.layer_norm.bias"] = vec(c)
    t["feature_projection.projection.weight"] = weight(h, c)
    t["feature_projection.projection.bias"] = vec(h)
    groups, k = dims["num_conv_pos_embedding_groups"], dims["num_conv_pos_embeddings"]
    v = weight(h, h // groups, k)
    g = np.sqrt((v.astype(np.float64) ** 2).sum(axis=(0, 1), keepdims=True)).astype(np.float32)
    t["encoder.pos_conv_embed.conv.parametrizations.weight.original0"] = g
    t["encoder.pos_conv_embed.conv.parametrizations.weight.original1"] = v
    t["encoder.pos_conv_embed.conv.bias"] = vec(h)
    t["encoder.layer_norm.weight"], t["encoder.layer_norm.bias"] = vec(h, 1.0), vec(h)
    for i in range(dims["num_hidden_layers"]):
        pre = f"encoder.layers.{i}."
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            t[pre + f"attention.{proj}.weight"], t[pre + f"attention.{proj}.bias"] = (
                weight(h, h), vec(h))
        t[pre + "layer_norm.weight"], t[pre + "layer_norm.bias"] = vec(h, 1.0), vec(h)
        t[pre + "feed_forward.intermediate_dense.weight"] = weight(ffn, h)
        t[pre + "feed_forward.intermediate_dense.bias"] = vec(ffn)
        t[pre + "feed_forward.output_dense.weight"] = weight(h, ffn)
        t[pre + "feed_forward.output_dense.bias"] = vec(h)
        t[pre + "final_layer_norm.weight"], t[pre + "final_layer_norm.bias"] = vec(h, 1.0), vec(h)
    t["masked_spec_embed"] = vec(h)  # in HF snapshots, unused by the encoder
    out.mkdir(parents=True)
    (out / "config.json").write_text(json.dumps({
        "model_type": "hubert", "feat_extract_norm": "group", "do_stable_layer_norm": False,
        **dims}))
    write_safetensors(out / "model.safetensors", t)
    return t


def reference_state_dict(name: str, encoder: dict[str, np.ndarray], labels: list[str],
                         seed: int, lstm_hidden: int = 128, lstm_layers: int = 2,
                         classifier: int = 256) -> dict[str, np.ndarray]:
    """A reference (PyTorch Lightning) state_dict of model ``name`` in the
    reference's key layout: ``encoder``, a snapshot's tensors
    (``write_whisper_snapshot``, ``write_hubert_snapshot``), under
    ``w_encoder.`` or, for HuBERT, under torchaudio's ``wav2vec2.`` paths;
    random heads from ``seed``: per-label ``task_heads.linear_head_<label>``
    (hydra), ``classifier.0``/``.2`` (MLP), whisperimax's ``linear.0``/``.2``
    and ``classifier``; an ``nn.LSTM`` with both biases random
    (``lstm_shared.``, whisperimax's ``lstm.``); ``layer_weights``."""
    weight, vec = _snapshot_tensors(seed)
    sd: dict[str, np.ndarray] = {}
    if name == "surgical_hubert_hydra":
        for k, v in encoder.items():
            if k == "masked_spec_embed":
                continue
            if k.startswith("feature_projection."):
                k = "encoder." + k
            elif k.startswith("encoder."):
                k = "encoder.transformer." + k.removeprefix("encoder.")
                k = k.replace("conv.parametrizations.weight.original0", "conv.weight_g")
                k = k.replace("conv.parametrizations.weight.original1", "conv.weight_v")
            sd[f"wav2vec2.{k}"] = v
        width = encoder["feature_projection.projection.weight"].shape[0]
        n_layers = len({k.split(".")[2] for k in encoder if k.startswith("encoder.layers.")})
    else:
        sd.update({"w_encoder." + k.removeprefix("model.encoder."): v
                   for k, v in encoder.items()})
        width = encoder["model.encoder.conv1.weight"].shape[0]
        n_layers = len({k.split(".")[3] for k in encoder
                        if k.startswith("model.encoder.layers.")})
    if name in ("whisperimax", "hydra_whisper", "surgical_hydra"):
        prefix = "lstm" if name == "whisperimax" else "lstm_shared"
        d_in = width
        for layer in range(lstm_layers):
            for sfx in ("", "_reverse"):
                sd[f"{prefix}.weight_ih_l{layer}{sfx}"] = weight(4 * lstm_hidden, d_in)
                sd[f"{prefix}.weight_hh_l{layer}{sfx}"] = weight(4 * lstm_hidden, lstm_hidden)
                sd[f"{prefix}.bias_ih_l{layer}{sfx}"] = vec(4 * lstm_hidden) * 5
                sd[f"{prefix}.bias_hh_l{layer}{sfx}"] = vec(4 * lstm_hidden) * 5
            d_in = 2 * lstm_hidden
        width = 2 * lstm_hidden
    if name in ("hydra_whisper", "surgical_hydra", "surgical_hubert_hydra"):
        for label in labels:
            sd[f"task_heads.linear_head_{label}.weight"] = weight(1, width)
            sd[f"task_heads.linear_head_{label}.bias"] = vec(1)
    elif name == "whisperimax":
        sd["linear.0.weight"], sd["linear.0.bias"] = weight(128, width), vec(128)
        sd["linear.2.weight"], sd["linear.2.bias"] = weight(128, 128), vec(128)
        sd["classifier.weight"], sd["classifier.bias"] = weight(len(labels), 128), vec(len(labels))
    else:
        sd["classifier.0.weight"], sd["classifier.0.bias"] = weight(classifier, width), vec(classifier)
        sd["classifier.2.weight"] = weight(len(labels), classifier)
        sd["classifier.2.bias"] = vec(len(labels))
    if name in ("surgical_whisper", "surgical_hydra", "surgical_hubert_hydra"):
        sd["layer_weights"] = np.random.default_rng(seed + 1).standard_normal(n_layers).astype(
            np.float32)
    return sd


def write_reference_ckpt(path: Path, sd: dict[str, np.ndarray]) -> Path:
    """A reference ``best.ckpt``: ``torch.save({"state_dict": ...})`` of
    f32 tensors."""
    import torch

    torch.save({"state_dict": {k: torch.from_numpy(np.ascontiguousarray(v))
                               for k, v in sd.items()}}, path)
    return path


def write_config(path: Path, cfg) -> Path:
    """A Config as a file the CLIs' ``--config`` reads: JSON, which YAML
    parses, so the script needs no pyyaml."""
    import dataclasses

    path.write_text(json.dumps(dataclasses.asdict(cfg)))
    return path


def rttm_frames(path: Path, labels: list[str], step_s: float = 0.02) -> np.ndarray:
    """(frames, labels) 0/1 of an RTTM on the 20 ms grid: frame int(start /
    step) up to ceil(end / step), the grid as long as the last segment's end."""
    import math

    segs = []
    for line in path.read_text().splitlines():
        f = line.split()
        if f and f[7] in labels:
            segs.append((float(f[3]), float(f[4]), labels.index(f[7])))
    n = math.ceil(max((s + d for s, d, _ in segs), default=0.0) / step_s)
    out = np.zeros((n, len(labels)))
    for start, dur, li in segs:
        out[int(start / step_s) : min(math.ceil((start + dur) / step_s), n), li] = 1.0
    return out


def brute_force_thresholds(root: Path, logits_dir: Path, labels: list[str]) -> dict:
    """Per label, the first threshold of round(linspace(0, 1, 10), 1) with
    the highest frame F1 (zero division 1) of sigmoid(logits) > threshold in
    float64 over the val files, each file's logits and RTTM grid padded with
    zeros to the longer: tune.py's contract, computed by brute force."""
    uris = [u for u in (root / "val.txt").read_text().split()]
    truth, probs = [], []
    for uri in uris:
        data = np.load(logits_dir / f"{uri}-logits_dict_t.npz")
        p = 1.0 / (1.0 + np.exp(-np.stack([data[lb] for lb in labels], 1).astype(np.float64)))
        t = rttm_frames(root / "rttm" / f"{uri}.rttm", labels)
        n = max(len(p), len(t))
        probs.append(np.pad(p, ((0, n - len(p)), (0, 0))))
        truth.append(np.pad(t, ((0, n - len(t)), (0, 0))) > 0.5)
    probs, truth = np.concatenate(probs), np.concatenate(truth)
    grid = np.round(np.linspace(0, 1, TUNE_GRID), 1)
    best = {}
    for li, label in enumerate(labels):
        scores = []
        for thr in grid:
            pred = probs[:, li] > thr
            tp = int((pred & truth[:, li]).sum())
            fp = int((pred & ~truth[:, li]).sum())
            fn = int((~pred & truth[:, li]).sum())
            scores.append(1.0 if 2 * tp + fp + fn == 0 else 2 * tp / (2 * tp + fp + fn))
        best[label] = {"lower_bound": float(grid[int(np.argmax(scores))]), "upper_bound": 1.0}
    return best


def _trainable_state(model) -> dict:
    return {k: v.detach().float().cpu().clone() for k, v in model.module.named_parameters()
            if v.requires_grad}


def _max_dist(a: dict, b: dict) -> float:
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def phase_workflow(card: str) -> dict:
    """The reference workflow on the card, in bf16 at full width:

    1. exact resume, with cuDNN's deterministic algorithms: HuBERT-base
       ``surgical_hubert_hydra`` (the training slice's config) trains 2
       epochs, twice; 1 epoch, then a fresh model
       and Trainer ``fit(..., resume_from=<run>/checkpoints/last)`` to epoch
       2; and once more from a copy of last/ without opt_state.msgpack. If
       the two uninterrupted runs agree bit for bit, the resumed run's
       trainable parameters and epoch-1 loss must too; else it may differ
       from the uninterrupted run by no more than the repeat does. The run
       with fresh moments must differ by more than the repeat.
    2. snapshots and the predict CLI: a random Whisper-base snapshot in HF's
       layout (config.json, model.safetensors from ``write_safetensors``)
       serves the val WAVs through ``inference.main([..., "--save-logits"])``
       in this process: the encoder on the card equals the arrays written,
       each saved .npz equals ``logits_for_audio`` of the same model bit for
       bit, the first two chunks' logits agree with the CPU plain path at
       LOGITS_ATOL, the RTTMs parse. Then a HuBERT-base snapshot (positional
       conv as ``original0``/``original1``) trains 1 epoch, its checkpoint
       serves with the fingerprint accepted, and another snapshot is refused.
    3. tune and evaluate: ``tune.main`` on the val RTTMs and logits equals
       ``brute_force_thresholds``; the test WAVs are predicted with them;
       ``evaluate.main`` writes fscore.csv, every score finite in [0, 1].

    Returns the launch counts of the resumed fit and of the predict CLI's run."""
    import csv
    import dataclasses
    import shutil
    import warnings

    import torch

    from segma_tpu_torch import checkpoint, evaluate, inference, tune
    from segma_tpu_torch.annotation import AudioAnnotation
    from segma_tpu_torch.data import SegmaFileDataset, SegmentationDataLoader
    from segma_tpu_torch.inference import (
        Chunkyfier, InferencePipeline, _bucket, _load_mono, load_thresholds,
        run_inference_on_audios,
    )
    from segma_tpu_torch.models.geometry import ConvolutionSettings
    from segma_tpu_torch.train import Trainer

    walls: dict[str, float] = {}
    launches: dict[str, dict] = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        root = tmp / "data"
        write_dataset(root, TRAIN_CLASSES, (TRAIN_FILES, VAL_FILES, TEST_FILES), TRAIN_FILE_S)
        labels = list(TRAIN_CLASSES)

        # 1. exact resume
        cfg = surgical_hubert_hydra_config(root)
        ds = SegmaFileDataset.from_config(cfg)
        ds.load(use_cache=False)

        def fit(run: str, epochs: int, resume_from: Path | None = None):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # random encoder weights, on purpose
                model = checkpoint.build_model(cfg, device="cuda")
            dm = SegmentationDataLoader(ds, model.label_encoder, cfg, model.conv_settings)
            trainer = Trainer(model=model, config=cfg, run_dir=tmp / run, max_epochs=epochs)
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            result = trainer.fit(dm, resume_from=resume_from)
            torch.cuda.synchronize()
            walls[f"fit {run}"] = time.perf_counter() - t0
            out = (_trainable_state(model), result["history"], read_launches(),
                   len(dm.train_dataloader()), len(dm.val_dataloader()))
            del model, trainer, result
            torch.cuda.empty_cache()
            return out

        # a bit-exact trajectory on the card needs cuDNN's deterministic
        # algorithms: under the default ones two identical bf16 runs differ
        # within the first epoch (the positional conv's backward)
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=cudnn.enabled, benchmark=False, deterministic=True,
                         allow_tf32=cudnn.allow_tf32):
            full, h_full, _, n_steps, n_val = fit("full", TRAIN_EPOCHS)
            repeat, h_repeat, _, _, _ = fit("repeat", TRAIN_EPOCHS)
            fit("first", 1)
            last = tmp / "first" / "checkpoints" / "last"
            files = sorted(p.name for p in last.iterdir())
            if files != ["meta.yaml", "opt_state.msgpack", "params.msgpack", "train_state.yaml"]:
                raise AssertionError(f"last/ holds {files}")
            resumed, h_res, resume_launches, _, _ = fit("resumed", TRAIN_EPOCHS, last)
            no_moments = tmp / "last_without_moments"
            shutil.copytree(last, no_moments)
            (no_moments / "opt_state.msgpack").unlink()
            fresh, _, _, _, _ = fit("fresh_moments", TRAIN_EPOCHS, no_moments)
        n_layers = HUBERT_BASE["num_hidden_layers"]
        want = {"logmel": 0, "flash_attn_fwd": n_layers * (n_steps + n_val),
                "flash_attn_bwd": n_layers * n_steps, "flash_attn_fwd_f32": 0,
                "flash_attn_bwd_f32": 0}
        if [h["epoch"] for h in h_res] != [1] or resume_launches != want:
            raise AssertionError(f"resumed fit ran epochs {[h['epoch'] for h in h_res]} with "
                                 f"launches {resume_launches} (want {want})")
        launches["resume"] = resume_launches
        d_repeat, d_resume, d_fresh = (_max_dist(full, x) for x in (repeat, resumed, fresh))
        loss_full, loss_res = h_full[1]["train/loss"], h_res[0]["train/loss"]
        print(f"workflow resume [{card}] (cuDNN deterministic): max |trainable - "
              f"uninterrupted| after epoch 2: "
              f"repeat {d_repeat:.3e}, resumed {d_resume:.3e}, fresh moments {d_fresh:.3e}; "
              f"epoch-1 train/loss uninterrupted {loss_full!r}, repeat "
              f"{h_repeat[1]['train/loss']!r}, resumed {loss_res!r}", flush=True)
        if d_repeat == 0.0:
            if d_resume != 0.0 or loss_res != loss_full:
                raise AssertionError("the uninterrupted runs agree bit for bit, the resumed "
                                     "run does not")
            print("check exact resume: bit for bit, parameters and epoch-1 loss", flush=True)
        elif not d_resume <= d_repeat:
            raise AssertionError(f"resumed run differs by {d_resume:.3e}, more than the "
                                 f"repeat's {d_repeat:.3e}")
        if not d_fresh > d_repeat:
            raise AssertionError(f"resume with fresh moments differs by {d_fresh:.3e}, no more "
                                 f"than the repeat's {d_repeat:.3e}: the moments did nothing")

        # 2. a Whisper-base snapshot through the predict CLI
        t0 = time.perf_counter()
        written = write_whisper_snapshot(tmp / "whisper_base", seed=5)
        walls["write Whisper-base snapshot"] = time.perf_counter() - t0
        wcfg = surgical_hydra_config()
        wcfg = dataclasses.replace(wcfg, data=dataclasses.replace(
            wcfg.data, dataset_path=str(root)), model=dataclasses.replace(
            wcfg.model, config=dataclasses.replace(wcfg.model.config,
                                                   encoder=str(tmp / "whisper_base"))))
        config_path = write_config(tmp / "whisper_config.yml", wcfg)
        model = checkpoint.build_model(wcfg, device="cuda")
        state = model.module.state_dict()
        hf_names = {k: "encoder." + k.removeprefix("model.encoder.").replace(
            "embed_positions.weight", "embed_positions") for k in written}
        encoder_keys = {k for k in state if k.startswith("encoder.")}
        if set(hf_names.values()) != encoder_keys:
            raise AssertionError(f"snapshot keys {sorted(set(hf_names.values()) ^ encoder_keys)}")
        off = [k for k, name in hf_names.items()
               if not torch.equal(state[name].cpu(), torch.from_numpy(written[k]))]
        if off:
            raise AssertionError(f"encoder weights on the card differ from the snapshot: {off}")
        print(f"check Whisper-base snapshot: {len(written)} tensors on the card equal the "
              f"arrays written, exactly in f32", flush=True)
        trainable, frozen = checkpoint.flax_split(model)
        checkpoint.save_params(tmp / "whisper_ck", trainable,
                               {"frozen_fingerprint": checkpoint.frozen_fingerprint(frozen)})
        del model
        val_uris = (root / "val.txt").read_text().split()
        ck = Chunkyfier(INNER_BATCH, wcfg.audio.chunk_duration_f,
                        ConvolutionSettings((320,), (320,), (0,)))
        n_samples = int(TRAIN_FILE_S * 16_000)
        n_chunks = _bucket(-(-ck.total_frames(n_samples) // ck.n_windows))
        n_inner = -(-n_chunks // min(INNER_BATCH, n_chunks))
        predict = ["--config", str(config_path), "--wavs", str(root / "wav"),
                   "--checkpoint", str(tmp / "whisper_ck"), "--batch-size", str(INNER_BATCH),
                   "--device", "cuda"]
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        inference.main([*predict, "--uris", str(root / "val.txt"), "--output",
                        str(tmp / "val_out"), "--save-logits"])
        torch.cuda.synchronize()
        walls["predict CLI, val"] = time.perf_counter() - t0
        launches["predict"] = read_launches()
        want = {"logmel": n_inner * len(val_uris),
                "flash_attn_fwd": WHISPER_BASE["encoder_layers"] * n_inner * len(val_uris),
                "flash_attn_bwd": 0, "flash_attn_fwd_f32": 0, "flash_attn_bwd_f32": 0}
        if launches["predict"] != want:
            raise AssertionError(f"predict CLI launch counts {launches['predict']} != {want}")
        served = checkpoint.load_model_for_inference(wcfg, tmp / "whisper_ck", device="cuda")
        pipe = InferencePipeline(served, batch_size=INNER_BATCH, device="cuda")
        n_segs = 0
        for uri in val_uris:
            data = np.load(tmp / "val_out" / "logits" / f"{uri}-logits_dict_t.npz")
            saved = np.stack([data[lb] for lb in labels], axis=1)
            direct = pipe.logits_for_audio(_load_mono(root / "wav" / f"{uri}.wav"))
            if saved.shape != direct.shape or not np.array_equal(saved, direct):
                raise AssertionError(f"{uri}: saved logits differ from logits_for_audio")
            rttm = (tmp / "val_out" / "raw_rttm" / f"{uri}.rttm").read_text()
            segs = [AudioAnnotation.from_rttm(ln) for ln in rttm.splitlines() if ln.strip()]
            if any(sg.duration_s <= 0 or sg.label not in labels for sg in segs):
                raise AssertionError(f"{uri}: malformed RTTM segment")
            n_segs += len(segs)
        print(f"check predict CLI: {len(val_uris)} val files, saved logits equal "
              f"logits_for_audio bit for bit, {n_segs} RTTM segments parse; launches "
              f"{launches['predict']}", flush=True)
        first = _load_mono(root / "wav" / f"{val_uris[0]}.wav")[: 2 * ck.chunk_stride
                                                              + ck.missing_n_frames]
        x = torch.from_numpy(first.astype(np.float32) / 32768.0)
        chunks = torch.stack([x[i * ck.chunk_stride : i * ck.chunk_stride + ck.chunk_duration_f]
                              for i in range(2)])
        model_cpu = checkpoint.load_model_for_inference(wcfg, tmp / "whisper_ck", device="cpu")
        with torch.inference_mode():
            ref = model_cpu.apply(chunks).reshape(-1, len(labels))
        data = np.load(tmp / "val_out" / "logits" / f"{val_uris[0]}-logits_dict_t.npz")
        got = torch.from_numpy(np.stack([data[lb] for lb in labels], axis=1)[: ref.shape[0]])
        check_close("saved logits of the first two chunks, card vs CPU (Whisper-base snapshot, "
                    "bf16)", got, ref, LOGITS_ATOL)
        del served, pipe, model_cpu
        torch.cuda.empty_cache()

        # a HuBERT-base snapshot: train one epoch, serve the checkpoint
        t0 = time.perf_counter()
        write_hubert_snapshot(tmp / "hubert_base", seed=6)
        write_hubert_snapshot(tmp / "hubert_other", seed=7)
        walls["write two HuBERT-base snapshots"] = time.perf_counter() - t0
        hcfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, config=dataclasses.replace(cfg.model.config,
                                                  wav_encoder=str(tmp / "hubert_base"))))
        model = checkpoint.build_model(hcfg, device="cuda")
        dm = SegmentationDataLoader(ds, model.label_encoder, hcfg, model.conv_settings)
        t0 = time.perf_counter()
        history = Trainer(model=model, config=hcfg, run_dir=tmp / "hubert_run",
                          max_epochs=1).fit(dm)["history"]
        torch.cuda.synchronize()
        walls["fit 1 epoch on the HuBERT-base snapshot"] = time.perf_counter() - t0
        if not np.isfinite([history[0]["train/loss"], history[0]["val/loss"]]).all():
            raise AssertionError(f"training on the snapshot: non-finite loss {history[0]}")
        hlast = tmp / "hubert_run" / "checkpoints" / "last"
        served = checkpoint.load_model_for_inference(hcfg, hlast, device="cuda")
        probe = torch.from_numpy(np.stack([
            write_wav(tmp / f"probe{i}.wav", hcfg.audio.chunk_duration_f, seed=20 + i)
            for i in range(2)]).astype(np.float32) / 32768.0).cuda()
        if not torch.equal(served.apply(probe), model.apply(probe)):
            raise AssertionError("the checkpoint served over the snapshot gives other logits")
        t0 = time.perf_counter()
        served_files = run_inference_on_audios(hcfg, root / "wav", hlast, tmp / "hubert_out",
                                               uris=root / "test.txt", device="cuda",
                                               batch_size=INNER_BATCH)
        walls["serve the HuBERT checkpoint, test"] = time.perf_counter() - t0
        for path in served_files:
            rttm = (tmp / "hubert_out" / "raw_rttm" / f"{path.stem}.rttm").read_text()
            for ln in rttm.splitlines():
                if ln.strip() and AudioAnnotation.from_rttm(ln).label not in labels:
                    raise AssertionError(f"{path.name}: malformed RTTM line {ln!r}")
        if not served_files:
            raise AssertionError("serving the HuBERT checkpoint wrote no RTTM")
        other = dataclasses.replace(hcfg, model=dataclasses.replace(
            hcfg.model, config=dataclasses.replace(hcfg.model.config,
                                                   wav_encoder=str(tmp / "hubert_other"))))
        refused = None
        try:
            checkpoint.load_model_for_inference(other, hlast, device="cuda")
        except ValueError as e:
            refused = str(e)
        if refused is None or "fingerprint" not in refused:
            raise AssertionError(f"serving over another snapshot was not refused: {refused}")
        print(f"check HuBERT-base snapshot: 1 epoch, train/loss {history[0]['train/loss']:.6f}, "
              f"val/loss {history[0]['val/loss']:.6f}; its checkpoint serves with the fingerprint "
              f"accepted (logits equal the trained model's; {len(served_files)} test RTTM(s)); "
              f"another snapshot refused: {refused[:80]}...", flush=True)
        del model, served
        torch.cuda.empty_cache()

        # 3. tune on val, predict test with the thresholds, evaluate
        t0 = time.perf_counter()
        tune.main(["--config", str(config_path), "--val-ds", str(root), "--val-logits",
                   str(tmp / "val_out" / "logits"), "--output", str(tmp / "tune")])
        walls["tune CLI"] = time.perf_counter() - t0
        tuned = load_thresholds(tmp / "tune" / "best_thresholds.yml")
        brute = brute_force_thresholds(root, tmp / "val_out" / "logits", labels)
        if tuned != brute:
            raise AssertionError(f"tune.main {tuned} != brute-force F1 grid {brute}")
        print(f"check tune CLI: best_thresholds.yml equals the float64 brute-force F1 grid: "
              f"{ {k: v['lower_bound'] for k, v in tuned.items()} }", flush=True)
        t0 = time.perf_counter()
        inference.main([*predict, "--uris", str(root / "test.txt"), "--output",
                        str(tmp / "test_out"), "--thresholds",
                        str(tmp / "tune" / "best_thresholds.yml")])
        walls["predict CLI, test, tuned thresholds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        evaluate.main(["--gt", str(root / "rttm"), "--pred", str(tmp / "test_out" / "raw_rttm"),
                       "-c", str(config_path), "--frame-f1"])
        walls["evaluate CLI"] = time.perf_counter() - t0
        with (tmp / "test_out" / "fscore.csv").open() as f:
            rows = list(csv.reader(f))
        scores = [float(v) for row in rows[1:] for v in row[1:]]
        if rows[-1][0] != "TOTAL" or not scores or not all(
                np.isfinite(v) and 0.0 <= v <= 1.0 for v in scores):
            raise AssertionError(f"fscore.csv: {rows}")
        print(f"check evaluate CLI: fscore.csv {rows[0]} TOTAL {rows[-1][1:]}, every score "
              f"finite in [0, 1]", flush=True)
    print(f"workflow walls [{card}]: " + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items()),
          flush=True)
    return launches


# -- the reference's six models: imported checkpoints, fast_context, multiclass --------

WHISPER_VARIANTS = ("whisperidou", "whisperimax", "surgical_whisper", "hydra_whisper",
                    "surgical_hydra")
FAST_CONTEXT_SAMPLES = 64_000  # fast_context: the 4 s chunk itself, 400 log-mel frames


def whisper_variant_config(name: str, encoder: str, dataset_path: str = "data/baby_train",
                           precision: str = "bf16", fast_context: bool = False, **train):
    """``config/default.yml`` with model.name, model.config.encoder,
    model.config.fast_context, data.dataset_path and train.precision (and
    any other ``train`` fields), the per-model YAML merged, built in code so
    that the script needs no pyyaml; tests/test_torch_whisper_variants.py
    holds it equal to ``load_config``."""
    from segma_tpu_torch.config import (
        AudioConfig, Config, DataConfig, HydraWhisperConfig, LSTMConfig, ModelConfig,
        SurgicalHydraConfig, SurgicalWhisperConfig, TrainConfig, WhisperidouConfig,
        WhisperimaxConfig,
    )

    lstm = LSTMConfig(hidden_size=128, num_layers=2, bidirectional=True, dropout=0.5)
    mc = {
        "whisperidou": lambda: WhisperidouConfig(encoder, [256], 256, fast_context),
        "whisperimax": lambda: WhisperimaxConfig(encoder, lstm, [256], 256, fast_context),
        "surgical_whisper": lambda: SurgicalWhisperConfig(encoder, [], "weighted", [256], 256,
                                                          fast_context),
        "hydra_whisper": lambda: HydraWhisperConfig(encoder, lstm, 256, fast_context),
        "surgical_hydra": lambda: SurgicalHydraConfig(encoder, [], "weighted", lstm, 256,
                                                      fast_context),
    }[name]()
    return Config(
        data=DataConfig(classes=list(TRAIN_CLASSES), dataset_path=str(dataset_path)),
        audio=AudioConfig(chunk_duration_s=4.0, sample_rate=16_000, strict_frames=False,
                          reference_tail=False),
        model=ModelConfig(name=name, chkp_path="models", config=mc),
        train=TrainConfig(precision=precision, **train),
    )


def expected_inner_batches(cfg, n_samples: int) -> int:
    """Inner batches ``InferencePipeline`` runs for one file of ``n_samples``
    (one log-mel launch each, and one flash launch per encoder layer)."""
    from segma_tpu_torch.inference import Chunkyfier, _bucket
    from segma_tpu_torch.models.geometry import ConvolutionSettings

    ck = Chunkyfier(INNER_BATCH, cfg.audio.chunk_duration_f,
                    ConvolutionSettings((320,), (320,), (0,)))
    total = ck.total_frames(n_samples, strict_tail=cfg.audio.strict_frames,
                            reference_tail=cfg.audio.reference_tail)
    n_chunks = _bucket(-(-total // ck.n_windows))
    return -(-n_chunks // min(INNER_BATCH, n_chunks))


def check_logits(label: str, card, cpu, cpu_f32) -> None:
    """Served logits against the CPU plain path on the same weights. f32:
    the card against the CPU at LOGITS_F32_ATOL * max(1, max|logit|). bf16:
    the card's logits against the f32 model's (on the CPU), no further than
    LOGITS_BF16_FACTOR times the CPU's bf16 logits are, or LOGITS_ATOL; the
    card's distance from the CPU's bf16 logits is printed."""
    import torch

    scale = float(cpu.abs().max())
    if cpu_f32 is cpu:
        check_close(f"{label}: saved logits of the first two chunks, card vs CPU, f32 "
                    f"(max|logit| {scale:.3f})", card, cpu, LOGITS_F32_ATOL * max(1.0, scale))
        return
    card_off = float((card.double() - cpu_f32.double()).abs().max())
    cpu_off = float((cpu.double() - cpu_f32.double()).abs().max())
    between = float((card.double() - cpu.double()).abs().max())
    limit = max(LOGITS_ATOL, LOGITS_BF16_FACTOR * cpu_off)
    if not (bool(torch.isfinite(card).all()) and card_off <= limit):
        raise AssertionError(f"{label}: card bf16 logits {card_off:.3e} from the f32 model, "
                             f"over {limit:.3e} (the CPU's bf16: {cpu_off:.3e})")
    print(f"check {label}: saved logits of the first two chunks (max|logit| {scale:.3f}), bf16 "
          f"from the f32 model: card {card_off:.3e}, CPU {cpu_off:.3e} (limit {limit:.3e} = "
          f"max({LOGITS_ATOL}, {LOGITS_BF16_FACTOR} x CPU)); card vs CPU bf16 {between:.3e}",
          flush=True)


def fast_context_kernel_times(card: str) -> dict:
    """The three forward kernels at the fast_context shapes: log-mel on (64,
    64000), the bf16 and the f32 flash forward on (64, 200, 8, 64). Each is
    held against its plain version (log-mel on white noise over the batch
    against float64, at most twice the plain version's own error, as in
    ``logmel_checks``; FLASH_ATOL/RTOL; FLASH_F32_ATOL and float64) and timed in turns beside it and, for
    flash, every SDPA backend that takes the dtype; with its bound."""
    import torch

    from segma_tpu_torch.ops import attention, logmel

    g = torch.Generator(device="cuda").manual_seed(9)
    out: dict[str, dict] = {}
    wav = torch.randn((INNER_BATCH, FAST_CONTEXT_SAMPLES), device="cuda", generator=g) * 0.1
    # white noise over a whole batch: held to float64, as in logmel_checks
    ref = log_mel_float64(wav)
    plain_err = float((logmel.log_mel_spectrogram_plain(wav).double() - ref).abs().max())
    err = float((logmel.finish(logmel.log10_mel_cuda(wav)).double() - ref).abs().max())
    limit = max(2 * plain_err, LOGMEL_ATOL)
    if not err <= limit:
        raise AssertionError(f"logmel fast_context: {err:.3e} from float64 exceeds {limit:.3e}")
    print(f"check logmel fast_context {tuple(wav.shape)} against float64: kernel {err:.3e}, "
          f"plain {plain_err:.3e} (limit {limit:.3e} = max(2 x plain, {LOGMEL_ATOL}))", flush=True)
    window = torch.hann_window(400, device="cuda")
    fb = logmel._plain_tables(wav.device)[2]
    times = time_turns({"kernel": lambda: logmel.log10_mel_cuda(wav),
                        "plain": lambda: logmel.log10_mel_plain(wav),
                        "stft yardstick": lambda: stft_log10_mel(wav, window, fb)})
    for name, t in times.items():
        print(f"time logmel fast_context {name} {tuple(wav.shape)} [{card}]: {spread(t)}",
              flush=True)
    bounds = logmel_bounds(*wav.shape)
    out["logmel"] = {"shape": list(wav.shape), "max_abs_err": err,
                     "ms": median(times["kernel"]), "plain_ms": median(times["plain"]),
                     "stft_yardstick_ms": median(times["stft yardstick"]), "library_ms": None,
                     "bound_ms": bounds["bound_ms"], "bound_by": bounds["bound_by"]}
    sm = 64**-0.5
    shape = (INNER_BATCH, 200, 8, 64)
    b, s, h, d = shape
    for name, dtype in (("flash_attn_fwd", torch.bfloat16), ("flash_attn_fwd_f32", torch.float32)):
        q, k, v = (torch.randn(shape, device="cuda", generator=g).to(dtype) for _ in range(3))
        got = attention.flash_attn_fwd(q, k, v, sm)
        ref = attention.attention_plain(q, k, v, sm, torch.float32)
        if dtype == torch.bfloat16:
            err = check_close(f"{name} fast_context {shape}", got, ref, FLASH_ATOL, FLASH_RTOL)
            bf16_ms, _ = bound_ms(4 * b * h * s * s * d, PEAK_BF16_FLOPS, 4 * q.numel() * 2)
            n_sm = torch.cuda.get_device_properties(0).multi_processor_count
            exp_ms = b * h * s * s / (EXP2_PER_SM_CLOCK * n_sm * max_sm_clock_hz()) * 1e3
            bound = {"bound_ms": max(bf16_ms, exp_ms), "bound_by": "operations"}
        else:
            err = check_close(f"{name} fast_context {shape}", got, ref, FLASH_F32_ATOL)
            check_close(f"{name} fast_context {shape} against float64", got.double(),
                        attention.attention_plain(q.double(), k.double(), v.double(), sm,
                                                  torch.float64), FLASH_F32_ATOL)
            bound = row_bounds(f32_attention_bounds(b, s, h, d, products=2, tensors=4))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        plain_dtype = torch.float32 if dtype == torch.float32 else torch.bfloat16
        times = time_turns({"kernel": lambda: attention.flash_attn_fwd(q, k, v, sm),
                            "plain": lambda: attention.attention_plain(q, k, v, sm, plain_dtype),
                            **sdpa_calls(qt, kt, vt, sm)})
        for label, t in times.items():
            print(f"time {name} fast_context {label} {shape} [{card}]: {spread(t)}", flush=True)
        library = {n: median(t) for n, t in times.items() if n.startswith("sdpa")}
        out[name] = {"shape": list(shape), "max_abs_err": err, "ms": median(times["kernel"]),
                     "plain_ms": median(times["plain"]), "library_backends_ms": library,
                     "library_ms": min(library.values()) if library else None, **bound}
        del q, k, v, qt, kt, vt, got, ref
        torch.cuda.empty_cache()
    for name, row in out.items():
        print(f"time {name} fast_context {tuple(row['shape'])} [{card}]: kernel "
              f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library {row['library_ms']} "
              f"ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}; "
              f"{100 * row['bound_ms'] / row['ms']:.1f}% of it)", flush=True)
    return out


def phase_reference_models(card: str) -> dict:
    """The reference's six models on the card, at Whisper-base and
    HuBERT-base width, through the entry points a migrating user calls:

    1. each Whisper variant: a random Whisper-base snapshot, and a reference
       ``best.ckpt`` in the reference's key layout holding the snapshot's
       tensors under ``w_encoder.`` and random heads (an ``nn.LSTM`` with
       both biases random); imported by ``python -m
       segma_tpu_torch.cli.import_checkpoint`` (whisperidou's in a process
       of its own, the others through the same ``main`` in this one) and
       served in bf16 by the predict CLI (``inference.main``, ``--save-logits``)
       over the snapshot, fingerprint accepted; the saved logits of the
       first two chunks against the CPU plain path on the same weights
       (``check_logits``): log-mel at (B, 480000), the bf16 flash forward at
       S = 1500;
    2. whisperidou with fast_context, served in bf16 and in f32: log-mel at
       (B, 64000), both flash forwards at S = 200;
    3. the imported whisperimax served with train.precision=f32: the f32
       flash forward at S = 1500;
    4. surgical_hubert_hydra: a reference ``.ckpt`` with torchaudio's
       ``wav2vec2.`` keys at HuBERT-base width, imported and served;
    5. whisperimax (multiclass loss) trains two epochs in bf16 through
       ``Trainer.fit`` on the snapshot: finite losses that fall from epoch 1
       to 2, every ``bias_ih`` exactly zero afterwards, and its checkpoint
       serves the trained model's logits.

    Returns the launch counts of each path."""
    import dataclasses
    import warnings

    import torch

    from segma_tpu_torch import checkpoint, inference
    from segma_tpu_torch.cli import import_checkpoint
    from segma_tpu_torch.config import DataloaderConfig
    from segma_tpu_torch.data import SegmaFileDataset, SegmentationDataLoader
    from segma_tpu_torch.inference import Chunkyfier, _load_mono
    from segma_tpu_torch.models.geometry import ConvolutionSettings
    from segma_tpu_torch.train import Trainer

    walls: dict[str, float] = {}
    launches: dict[str, dict] = {}
    labels = list(TRAIN_CLASSES)
    repo = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        root = tmp / "data"
        write_dataset(root, TRAIN_CLASSES, (TRAIN_FILES, VAL_FILES, TEST_FILES), TRAIN_FILE_S)
        val_uris = (root / "val.txt").read_text().split()
        n_samples = int(TRAIN_FILE_S * 16_000)
        t0 = time.perf_counter()
        whisper = write_whisper_snapshot(tmp / "whisper_base", seed=11)
        walls["write Whisper-base snapshot"] = time.perf_counter() - t0

        def first_chunks(cfg) -> torch.Tensor:
            ck = Chunkyfier(INNER_BATCH, cfg.audio.chunk_duration_f,
                            ConvolutionSettings((320,), (320,), (0,)))
            pcm = _load_mono(root / "wav" / f"{val_uris[0]}.wav")
            x = torch.from_numpy(pcm[: 2 * ck.chunk_stride + ck.missing_n_frames]
                                 .astype(np.float32) / 32768.0)
            return torch.stack([x[i * ck.chunk_stride : i * ck.chunk_stride
                                  + ck.chunk_duration_f] for i in range(2)])

        def serve(label: str, cfg, ckpt_dir: Path, n_layers: int, kernel: str):
            """The predict CLI over the val WAVs from zeroed launch counts;
            the saved logits of the first two chunks against the CPU."""
            config_path = write_config(tmp / f"{label}.yml", cfg)
            out = tmp / f"{label}_out"
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            inference.main(["--config", str(config_path), "--wavs", str(root / "wav"),
                            "--uris", str(root / "val.txt"), "--checkpoint", str(ckpt_dir),
                            "--output", str(out), "--batch-size", str(INNER_BATCH),
                            "--save-logits", "--device", "cuda"])
            torch.cuda.synchronize()
            walls[f"predict CLI {label}"] = time.perf_counter() - t0
            got = read_launches()
            n_inner = expected_inner_batches(cfg, n_samples) * len(val_uris)
            want = {k: 0 for k in got}
            want[kernel] = n_layers * n_inner
            if cfg.model.name != "surgical_hubert_hydra":
                want["logmel"] = n_inner
            if got != want:
                raise AssertionError(f"{label}: launch counts {got} != {want}")
            launches[label] = got
            chunks = first_chunks(cfg)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                model_cpu = checkpoint.load_model_for_inference(cfg, ckpt_dir, device="cpu")
                with torch.inference_mode():
                    ref = model_cpu.apply(chunks).reshape(-1, len(labels))
                    f32 = (ref if cfg.train.precision == "f32" else
                           checkpoint.load_model_for_inference(
                               dataclasses.replace(cfg, train=dataclasses.replace(
                                   cfg.train, precision="f32")), ckpt_dir, device="cpu")
                           .apply(chunks).reshape(-1, len(labels)))
            data = np.load(out / "logits" / f"{val_uris[0]}-logits_dict_t.npz")
            saved = torch.from_numpy(np.stack([data[lb] for lb in labels], 1)[: ref.shape[0]])
            check_logits(label, saved, ref, f32)
            n_segs = sum(len((out / "raw_rttm" / f"{u}.rttm").read_text().splitlines())
                         for u in val_uris)
            print(f"check {label}: {len(val_uris)} val files served, {n_segs} RTTM lines, "
                  f"launches {got}", flush=True)
            del model_cpu

        imported: dict[str, Path] = {}
        for i, name in enumerate(WHISPER_VARIANTS):
            cfg = whisper_variant_config(name, str(tmp / "whisper_base"), str(root))
            sd = reference_state_dict(name, whisper, labels, seed=20 + i)
            ckpt_path = write_reference_ckpt(tmp / f"{name}.ckpt", sd)
            args = ["--ckpt", str(ckpt_path), "--config", str(write_config(
                tmp / f"{name}_import.yml", cfg)), "--out", str(tmp / f"{name}_imported"),
                "--device", "cuda"]
            t0 = time.perf_counter()
            if i == 0:
                subprocess.run([sys.executable, "-m", "segma_tpu_torch.cli.import_checkpoint",
                                *args], cwd=repo, check=True, timeout=600)
            else:
                import_checkpoint.main(args)
            walls[f"import {name}"] = time.perf_counter() - t0
            imported[name] = tmp / f"{name}_imported"
            meta = checkpoint.load_meta(imported[name])
            if meta.get("model") != name or "frozen_fingerprint" not in meta:
                raise AssertionError(f"{name}: imported meta {meta}")
            serve(f"{name} bf16", cfg, imported[name], WHISPER_BASE["encoder_layers"],
                  "flash_attn_fwd")
            torch.cuda.empty_cache()

        # fast_context: the encoder on the chunk's own 400 frames
        for precision, kernel in (("bf16", "flash_attn_fwd"), ("f32", "flash_attn_fwd_f32")):
            cfg = whisper_variant_config("whisperidou", str(tmp / "whisper_base"), str(root),
                                         precision=precision, fast_context=True)
            serve(f"whisperidou fast_context {precision}", cfg, imported["whisperidou"],
                  WHISPER_BASE["encoder_layers"], kernel)
        # an imported checkpoint served in f32 at the padded context
        cfg = whisper_variant_config("whisperimax", str(tmp / "whisper_base"), str(root),
                                     precision="f32")
        serve("whisperimax f32", cfg, imported["whisperimax"], WHISPER_BASE["encoder_layers"],
              "flash_attn_fwd_f32")
        torch.cuda.empty_cache()

        # surgical_hubert_hydra from torchaudio-style keys
        t0 = time.perf_counter()
        hubert = write_hubert_snapshot(tmp / "hubert_base", seed=12)
        hcfg = surgical_hubert_hydra_config(root)
        hcfg = dataclasses.replace(hcfg, model=dataclasses.replace(
            hcfg.model, config=dataclasses.replace(hcfg.model.config,
                                                   wav_encoder=str(tmp / "hubert_base"))))
        sd = reference_state_dict("surgical_hubert_hydra", hubert, labels, seed=30)
        import_checkpoint.main(["--ckpt", str(write_reference_ckpt(tmp / "hubert.ckpt", sd)),
                                "--config", str(write_config(tmp / "hubert_import.yml", hcfg)),
                                "--out", str(tmp / "hubert_imported"), "--device", "cuda"])
        walls["write and import HuBERT-base"] = time.perf_counter() - t0
        serve("surgical_hubert_hydra bf16", hcfg, tmp / "hubert_imported",
              HUBERT_BASE["num_hidden_layers"], "flash_attn_fwd")
        torch.cuda.empty_cache()

        # whisperimax trains: the multiclass loss, the LSTM's one bias
        tcfg = whisper_variant_config("whisperimax", str(tmp / "whisper_base"), str(root),
                                      lr=1e-3, batch_size=32, max_epochs=TRAIN_EPOCHS, seed=0,
                                      dataloader=DataloaderConfig(num_workers=1))
        model = checkpoint.build_model(tcfg, device="cuda")
        if model.loss_type != "multiclass":
            raise AssertionError(f"whisperimax loss_type {model.loss_type}")
        ds = SegmaFileDataset.from_config(tcfg)
        ds.load(use_cache=False)
        dm = SegmentationDataLoader(ds, model.label_encoder, tcfg, model.conv_settings)
        n_steps, n_val = len(dm.train_dataloader()), len(dm.val_dataloader())
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        history = Trainer(model=model, config=tcfg, run_dir=tmp / "imax_run").fit(dm)["history"]
        torch.cuda.synchronize()
        walls["fit whisperimax"] = time.perf_counter() - t0
        got = read_launches()
        n_batches = TRAIN_EPOCHS * (n_steps + n_val)
        want = {"logmel": n_batches, "flash_attn_fwd": WHISPER_BASE["encoder_layers"] * n_batches,
                "flash_attn_bwd": 0, "flash_attn_fwd_f32": 0, "flash_attn_bwd_f32": 0}
        if got != want:
            raise AssertionError(f"whisperimax fit: launch counts {got} != {want}")
        launches["whisperimax fit"] = got
        losses = [h["train/loss"] for h in history]
        if not (np.isfinite(losses + [h["val/loss"] for h in history]).all()
                and losses[-1] < losses[0]):
            raise AssertionError(f"whisperimax train/loss per epoch {losses}: not finite and "
                                 f"falling")
        lstm = model.module.lstm_shared.lstm
        nonzero = [n for n, p in lstm.named_parameters() if n.startswith("bias_ih") and p.any()]
        if nonzero:
            raise AssertionError(f"whisperimax: {nonzero} moved off zero in training")
        served = checkpoint.load_model_for_inference(
            tcfg, tmp / "imax_run" / "checkpoints" / "last", device="cuda")
        probe = first_chunks(tcfg).cuda()
        if not torch.equal(served.apply(probe), model.apply(probe)):
            raise AssertionError("whisperimax: the checkpoint serves other logits than the "
                                 "trained model")
        print(f"check whisperimax fit [{card}]: {TRAIN_EPOCHS} epochs of {n_steps} steps, "
              f"multiclass train/loss {losses}, val/loss {[h['val/loss'] for h in history]}; "
              f"bias_ih exactly zero; last/ serves the trained logits; launches {got}",
              flush=True)
        del model, served
        torch.cuda.empty_cache()
    print(f"reference models walls [{card}]: " + ", ".join(f"{k} {v:.3f} s"
                                                           for k, v in walls.items()), flush=True)
    return launches



def profile_run(card: str, label: str, fn, wall_s: float) -> list[str]:
    """One more main-path run under torch.profiler: device time by kernel,
    and the device's busy share of ``wall_s``, the same run's wall time
    without the profiler. Returns the names of the kernels that ran."""
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
    print(f"profile {label} [{card}]: wall under the profiler {wall_us / 1e3:.1f} ms, device busy "
          f"{busy_us / 1e3:.1f} ms = {100 * busy_us / (wall_s * 1e6):.1f}% of the "
          f"unprofiled wall {wall_s * 1e3:.1f} ms (kernels may overlap)", flush=True)
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)
    # the 15 longest, and the port's own kernels wherever they rank
    for rank, e in enumerate(ranked):
        if rank < 15 or any(k in e.key for k in ("flash_", "logmel_")):
            print(f"profile {label} kernel: {e.self_device_time_total / 1e3:9.2f} ms "
                  f"{e.count:6d}x #{rank + 1} {e.key[:100]}", flush=True)
    return [e.key for e in ranked]


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
    bwd_row, fwd_train = flash_bwd_checks(card)
    fwd = rows[1]
    fwd["max_abs_err"] = max(fwd["max_abs_err"], fwd_train.pop("with_lse_max_abs_err"))
    fwd["lse_max_abs_err"] = max(fwd["lse_max_abs_err"], fwd_train.pop("lse_max_abs_err"))
    fwd.update(fwd_train)  # the training shape's times, with and without the LSE
    rows.append(bwd_row)
    rows.extend(flash_f32_checks(card))
    with torch.inference_mode():
        fast = fast_context_kernel_times(card)
    for row in rows:
        if row["name"] in fast:
            row["fast_context"] = fast[row["name"]]
    torch.cuda.empty_cache()
    serve = phase_slice(card)
    torch.cuda.empty_cache()
    train = phase_train(card)
    torch.cuda.empty_cache()
    workflow = phase_workflow(card)
    torch.cuda.empty_cache()
    reference = phase_reference_models(card)
    torch.cuda.empty_cache()
    # the f32 phases run under PyTorch's defaults, which let cuDNN take TF32:
    # the f32 model itself keeps its convolutions and LSTM in IEEE f32
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    print("f32 phases: PyTorch's default flags, allow_tf32 True for cuDNN, False for matmul",
          flush=True)
    serve_f32 = phase_serve_f32(card)
    torch.cuda.empty_cache()
    train_f32 = phase_train_f32(card)
    # each row's launches come from the path that runs it: serving for the
    # forward kernels, training for the backward ones (bf16 and f32)
    for row in rows:
        name = row["name"]
        if name.endswith("_f32"):
            row["launches"] = serve_f32[name] if "fwd" in name else train_f32[name]
        else:
            row["launches"] = serve[name] if name in serve else train[name]
    by_name = {row["name"]: row for row in rows}
    by_name["flash_attn_fwd"]["launches_train"] = train["flash_attn_fwd"]
    by_name["flash_attn_fwd_f32"]["launches_train"] = train_f32["flash_attn_fwd_f32"]
    for row in rows:  # the reference models' paths, all of them together
        row["launches_reference_models"] = sum(path[row["name"]] for path in reference.values())
    print(json.dumps({"kernels": rows}), flush=True)
    paths = {"serve": serve, "train": train, "workflow_resume": workflow["resume"],
             "workflow_predict": workflow["predict"], "serve_f32": serve_f32,
             "train_f32": train_f32,
             **{f"reference {label}": counts for label, counts in reference.items()}}
    print(f"kernels: {json.dumps(paths)}", flush=True)
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
