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
   at FLASH_BWD_SHAPES (the training shape (32, 199, 12, 64), the training
   meshes' (16, 199, 6, 64), (64, 1500, 8, 64), (2, 70, 2, 64) and the edges
   of its tiling), on the forward's output
   and log-sum-exp, and bitwise over two launches. Kernels and library calls
   are timed in turns (``time_turns``: the median of 5 groups of 20 calls,
   the device held by a spin kernel while the host queues each group), and
   every SDPA backend that takes the shape is timed; the fastest is the
   ``library_ms``. The f32 forward and backward (both 3xTF32 on wgmma)
   are checked at FLASH_F32_SHAPES and
   FLASH_F32_BWD_SHAPES (both with the f32 training mesh's (32, 199, 6,
   64)) against their plain versions in f32 and in float64
   (the JAX suite's f32 pins), bitwise with and without the LSE and over
   two launches, and timed at both main paths' shapes beside every SDPA
   backend that takes f32 (the refusals are printed), with their bounds at
   the f32 CUDA-core peak and as 3xTF32 at the tensor-core peak; the
   backward's and SDPA's f32 gradients are printed against the float64
   gradient. The LSTM kernel (``lstm_checks``) through ``BiLSTM``'s kernel
   path at LSTM_SHAPES against cuDNN's ``torch.lstm`` (LSTM_CUDNN_ATOL)
   and the CPU's (LSTM_ATOL), one launch a layer, bitwise over two calls
   and through the registered op; one layer call at the serving shape (64,
   1500, H 128, both directions) timed beside the layer call with its input
   GEMM, cuDNN's call (a yardstick the port no longer calls in serving), the
   plain version and its bound; the clusters the card runs at once.
4. serving slice: full-width Whisper-base ``surgical_hydra`` (random
   weights from a seed) serves a synthetic 10-minute int16 WAV through
   ``run_inference_on_audios``; the launch counters show that the path went
   through log-mel, the flash forward and the LSTM kernel, twice (first and
   second run in the process); the RTTM is parsed; one more run under torch.profiler prints
   device time by kernel; the card's logits for the first two chunks are
   held against the same model on the CPU plain path; the WAV's logits are
   bit-equal with cuDNN's TF32 allowed (PyTorch's default) and not (the
   bf16 model's f32 BiLSTM scopes itself out of TF32), and the LSTM's
   device time is printed as it runs now and as it ran before that repair.
5. training slice: full-width HuBERT-base ``surgical_hubert_hydra`` (random
   weights from a seed, transformer trainable, front end frozen) trains two
   epochs through ``Trainer.fit`` on a synthetic dataset written here (8
   train and 4 val files of 64 s: 4 steps of 32 crops per epoch). Checked:
   the step-1 loss (dropout 0) against the CPU plain path, finite losses,
   non-zero q/k/v projection gradients after step 1, an unchanged front end,
   and 12 flash forward and 12 flash backward launches per step. Then
   WARM_STEP_REPEATS steps on one batch, timed, and one more under
   torch.profiler (the 15 longest kernels and the port's own); then the
   capturable AdamW against PyTorch's default one (``optimizer_times``).
6. the reference workflow (``phase_workflow``, bf16, full width): exact
   resume of HuBERT-base's widths at TRAIN_CLI_LAYERS layers from
   ``last/`` with no cuDNN flag from the caller
   (a seeded fit scopes cuDNN's deterministic algorithms itself): two
   seeded runs and the resumed run bit for bit, apart from a resume with
   fresh moments; a Whisper-base snapshot in HF's layout
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
10. the train CLIs (``phase_train_cli``, bf16, HuBERT-base's widths at
   TRAIN_CLI_LAYERS layers from a random snapshot): HuBERT
   through ``python -m segma_tpu_torch.cli.train`` with the cosine
   schedule, k=3 accumulation, int16 transport, remat and AUROC, 4 epochs
   in a child process; ``cli.auto_train`` stopped by SIGTERM inside epoch 2
   (exit 75) and resumed with ``--auto-resume`` to the uninterrupted run's
   final state bit for bit; remat and int16 transport each bit-equal to
   their plain counterparts. (It runs before the f32 phases, 7 and 8.)
10b. the device audio cache and epoch dispatch (``phase_device_cache``,
   full width): HuBERT-base bf16 over 1.05 GB of synthetic audio for two
   20-step epochs with the host path, the device cache under step
   dispatch, and epoch dispatch (the step replayed from a captured CUDA
   graph), each bit-equal to the one before, with equal launch counts;
   k=3 accumulation, f32 and whisperimax, step against epoch dispatch,
   bit-equal; per-step medians and spread and peak memory printed.
10c. the JAX package's four other model families (``phase_model_families``,
   bf16, full width: WavLM-base ``surgical_wavlm_hydra`` from a random HF
   snapshot, ``sincnet_hydra``, ``conv_vad``, ``powerset_vad``): log-mel
   checked and timed at (32, 64000); each model's step-1 loss against the
   CPU, two epochs of ``Trainer.fit`` (powerset_vad with its partial_*
   metrics; WavLM and powerset_vad again under epoch dispatch, bit-equal,
   equal launches), its ``last/`` rebuilt bit for bit, its ``best.ckpt``
   served by the predict CLI against the CPU (log-mel launched on the
   conv_vad paths only), and its warm serving xRT and step time.
10d. live serving (``phase_serve``, bf16, full-width Whisper-base
   ``surgical_hydra``, PyTorch's default TF32 flags): the ADPCM decode on
   the card bit-equal to the numpy decode on 600 s; ``run_inference_on_audios``
   over 32 WAVs of 20 s with pack_files 1, 8 and 8 under ADPCM (warm xRT,
   device-busy share, bytes to the device; int16 RTTMs identical between
   pack sizes; ADPCM's frame agreement); the predict CLI with ``--transport
   adpcm --pack-files 8``; the HTTP server in this process driven by
   ``SegmaClient`` (one-shot requests at batch windows 0 and 5 ms, four
   HTTP and one WebSocket streaming sessions under the ChunkForwardBatcher,
   each held to offline where no frame lies within LOGITS_ATOL of the
   threshold, a SIGTERM drain with a request in flight, the TF32 flags
   unchanged); ``python -m segma_tpu_torch.cli.serve`` in a child, drained
   by SIGTERM to exit 0. (It runs after the flags switch, before phase 7.)
10e. frozen artifacts (``phase_export``, under the same flags): the bf16
   ``surgical_hydra`` exported for the cuda platform (walls, bytes), loaded
   by a child that imports segma_tpu_torch.ops and .export only, its logits
   on the serving slice's WAV bit-equal to the live pipeline's at the same
   inner batch, its programs calling the log-mel and flash-forward ops, the
   launches of its bucket plan, cold load and warm xRT beside the live xRT;
   ``predict --artifact`` against ``--config``; a stream session over the
   artifact against the live one; the f32 artifact gated the same way; both
   and conv_vad in a bundle served by ``cli.serve --bundle`` in a child
   (``?model=`` routing, POST /admin/reload after a re-export, the old
   session drained); ``cli.doctor`` exit 0.
10f. data parallelism (``phase_parallel``, bf16 unless said): full-width
   Whisper-base ``surgical_hydra`` served over the serving slice's WAV with
   ``mesh`` off, auto (one card: no mesh) and two replicas on cuda:0 (a
   thread and a CUDA stream each), logits, RTTMs and launches bit-equal to
   off's, with the walls of the three (the split and gather's cost on one
   card, not a scaling figure), and one request to ``serve_forever`` over
   the two replicas; HuBERT-base's seeded one-epoch fit in an NCCL world of
   one bit-equal to the meshless fit under step and epoch dispatch (the
   all-reduce captured in the graph); a 2-rank gloo world on cuda:0 in
   child processes at 4 HuBERT-base layers: one f32 step against one
   process's global-batch step, and the train CLI preempted by a SIGTERM
   to one rank (both exit 75) and resumed. (It runs after phase 10c.) With
   several cards visible, ``phase_parallel_cards`` also serves over one
   replica per card, steps an NCCL world of one rank per card against the
   global-batch step, and runs ``cli.auto_train`` as one rank per card
   (epoch dispatch, SIGTERM and ``--auto-resume`` bit-equal to step
   dispatch), fits HuBERT-base bf16 at (1, 1, 2) as NCCL ranks under epoch
   dispatch (the layers' collectives in the captured graph) bit-equal to
   step dispatch, and with four cards serves over five tensor- and
   sequence-parallel meshes and one request through ``serve_forever`` at
   (2, 1, 2), and fits HuBERT-base f32 at (1, 1, 2), HuBERT-base bf16 at
   (2, 1, 2) and Whisper-base at (1, 2, 2) under both dispatches the same
   way; on one card it is skipped.
10g. tensor and sequence parallelism in serving (``phase_tensor_seq``, one
   card, every member of a mesh on cuda:0 with a thread and a stream of its
   own): the serving slice over the (data, seq, model) meshes (1,1,2),
   (1,2,1), (1,2,2), (1,4,1) and (2,2,2) against the meshless pipeline:
   logits within the card's bf16 rule (LOGITS_BF16_FACTOR times the CPU's
   bf16 distance from its f32 model, or LOGITS_ATOL), RTTM frames equal
   but near the threshold, the members of each data coordinate ending in
   the same bits, launches seq x model times meshless; the f32 model at
   (1,2,2) within LOGITS_F32_ATOL x max(1, max|logit|); HuBERT-base and
   WavLM-base at model=2 over 400 s. Before the phases, the bf16 and f32
   flash forward are checked and timed at a seq member's unequal lengths
   (``flash_unequal_checks``: Sq query rows against Skv keys).
10h. training under tensor and sequence parallelism
   (``phase_train_tensor_seq``, one card, gloo ranks on cuda:0 in child
   processes, one process per mesh device): three steps of
   ``Trainer.train_step`` on the training slice's batch of 32 crops of 4 s
   for HuBERT-base bf16 at (2,1,2), Whisper-base ``surgical_hydra`` bf16 at
   (1,2,2) and HuBERT-base f32 at (1,1,2), against this process's meshless
   steps: each step's loss and the first step's gradients (f32 at rtol 1e-5
   and 1e-4; bf16 within TRAIN_TP_BF16_FACTOR times the bf16 meshless
   step's own distance from the f32 one), every replicated
   parameter and the gathered tree the same bits on every rank, the flash
   backward launched layers x steps times per rank; the first world's
   gathered checkpoint served meshless; a ``Trainer`` asked for
   ``train.dispatch=epoch`` refused on every gloo rank, the message read
   back (gloo collectives wait for the host: no CUDA graph holds them).
   With four cards, ``phase_parallel_cards`` runs the HuBERT and Whisper
   worlds as NCCL ranks of their own cards, ``cli.train`` with
   ``mesh.model=2`` under both dispatches, and the epoch-dispatch fits
   (``_cards_epoch_worlds``).
11. the ``kernels`` JSON line (log-mel, the bf16 and the f32 flash forward
   and backward, the LSTM's recurrence; each with its fast_context times
   where it has them, and
   log-mel's at (32, 64000) as ``vad_train``) and
   the ``kernels:`` launch line, per path (the workflow's resumed fit and
   predict CLI run, each reference-model path, the train CLI, the
   epoch-dispatch paths and the live-serving paths among them); log-mel and
   the bf16 flash forward also carry ``launches_live_serving``, and they and
   the f32 flash forward ``launches_export``; every row carries
   ``launches_parallel_serve``, ``launches_parallel_train``,
   ``launches_parallel_train_epoch`` (the epoch-dispatch fits across cards,
   a replay counting its captured launches), ``launches_tensor_seq`` and
   ``launches_train_tensor_seq``; both flash
   forwards carry ``unequal_lengths``,
   their times, bounds and SDPA times at FLASH_UNEQUAL_SHAPES; then the
   ``wavlm_attn`` JSON line: WavLM's gated-bias attention kernel
   (``wavlm_attn_checks``: against its plain version at WAVLM_ATTN_SHAPES,
   timed at WAVLM_TIMED_SHAPES beside the plain version and SDPA with the
   materialised bias), WavLM-Large at its published widths
   (``wavlm_large_steps``: one step's gradients, f32 and bf16, against the
   plain f32 reference; f32 and bf16 steps from the same weights; a served
   inner batch), and the kernel's launches
   on every path.
12. last line: ``{"ok": true, "device": {...}}``.
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
# Card (bf16 kernels, the LSTM kernel) against CPU (bf16 plain path) logits: both
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
    import threading

    from segma_tpu_torch.ops import _build

    t0 = time.perf_counter()
    host = threading.Thread(target=_build.build_host)  # g++, beside the nvcc processes
    host.start()
    report = _build.build()
    _build.library()
    host.join()
    _build.host_library()
    secs = time.perf_counter() - t0
    print(f"build: {secs:.1f} s ({len(_build.sources())} sources, one nvcc each in parallel, "
          f"and the WAV reader by the host C++ compiler)", flush=True)
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
            "op": lambda: logmel.log10_mel(wav),  # the registered op the model calls
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
        f"time logmel (64, 480000) all-signal [{card}]: kernel {ms:.4f} ms (through the "
        f"registered op {timed['all-signal']['op']:.4f} ms), padded chunks "
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
        "ms": ms, "op_ms": timed["all-signal"]["op"], "plain_ms": timed["all-signal"]["plain"],
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
                        "op": lambda: attention.flash_fwd_op(q, k, v, sm),
                        **sdpa_calls(qt, kt, vt, sm)})
    ms = median(times.pop("kernel"))
    op_ms = median(times.pop("op"))
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
        f"time flash_attn_fwd (64, 1500, 8, 64) [{card}]: kernel {ms:.4f} ms (through the "
        f"registered op {op_ms:.4f} ms), "
        f"plain {plain_ms:.3f} ms, fastest sdpa {library_ms} ms; bounds: bf16 products "
        f"{bf16_ms:.4f} ms ({by}, bf16 tensor-core peak), exp2 {exp_ms:.4f} ms "
        f"({b * h * s * s:.4g} exp2 at {EXP2_PER_SM_CLOCK}/SM/clock x {n_sm} SMs x "
        f"{clock / 1e6:.0f} MHz); binding: {bound_op}", flush=True,
    )
    return {
        "name": "flash_attn_fwd", "route": "cuda",
        "source": "segma_tpu_torch/csrc/flash_attn.cu",
        "replaces": "segma_tpu/ops/attention.py:148",
        "max_abs_err": max(errs), "lse_max_abs_err": max(lse_errs), "ms": ms, "op_ms": op_ms,
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
# The training meshes' shapes: HuBERT-base's 12 heads over model=2, the
# training batch of 32 over data=2 in bf16 (phase_train_tensor_seq's (2, 1,
# 2)), whole in f32 (its (1, 1, 2)).
TRAIN_TP_ATTN_SHAPE = (16, 199, 6, 64)
TRAIN_TP_F32_ATTN_SHAPE = (32, 199, 6, 64)
FLASH_BWD_SHAPES = (
    TRAIN_ATTN_SHAPE, TRAIN_TP_ATTN_SHAPE, (INNER_BATCH, 1500, 8, 64), (2, 70, 2, 64),
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
FLASH_F32_SHAPES = ((INNER_BATCH, 1500, 8, 64), TRAIN_ATTN_SHAPE, TRAIN_TP_F32_ATTN_SHAPE,
                    *((2, s, 3, 64) for s in FLASH_F32_EDGE_S))
FLASH_F32_BWD_SHAPES = (TRAIN_ATTN_SHAPE, TRAIN_TP_F32_ATTN_SHAPE,
                        *((2, s, 3, 64) for s in FLASH_F32_BWD_EDGE_S))


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
                            "op": lambda: attention.flash_fwd_op(q, k, v, sm),
                            "kernel with lse": lambda: attention.flash_attn_fwd(q, k, v, sm,
                                                                                with_lse=True),
                            **sdpa_calls(qt, kt, vt, sm)}, iters=iters)
        for name, t in times.items():
            print(f"time flash_attn_fwd f32 {name} {shape} [{card}]: {spread(t)}", flush=True)
        b, s, h, d = shape
        library = {n: median(t) for n, t in times.items() if n.startswith("sdpa")}
        timed[label] = {
            "ms": median(times["kernel"]), "op_ms": median(times["op"]),
            "lse_ms": median(times["kernel with lse"]),
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
        print(f"time flash_attn_fwd f32 {label} [{card}]: kernel {t['ms']:.4f} ms (through the "
              f"registered op {t['op_ms']:.4f}, with lse {t['lse_ms']:.4f}), plain {t['plain_ms']:.4f} ms, fastest sdpa {t['library_ms']} "
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
        "lse_max_abs_err": max(lse_errs), "ms": serve["ms"], "op_ms": serve["op_ms"],
        "lse_ms": serve["lse_ms"],
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
    from segma_tpu_torch.geometry import ConvolutionSettings
    from segma_tpu_torch.ops import attention, logmel, rnn
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
    lstm_layers = model.module.lstm_shared.cfg.num_layers

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
            launches = {"logmel": logmel.launches, "flash_attn_fwd": attention.launches,
                        "lstm_fwd": rnn.launches}
            if len(done) != 1:
                raise AssertionError("run_inference_on_audios served no file")
            return wall, launches, torch.cuda.max_memory_allocated()

        for run, label in enumerate(("first run", "second run")):
            wall, launches, peak = drive(run)
            if (launches["logmel"] != n_inner or launches["flash_attn_fwd"] != n_layers * n_inner
                    or launches["lstm_fwd"] != lstm_layers * n_inner):
                raise AssertionError(
                    f"launch counts {launches} != logmel {n_inner}, flash {n_layers * n_inner}, "
                    f"lstm {lstm_layers * n_inner}"
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
    lstm_tf32_check(card, model, pcm)
    return launches


def lstm_tf32_check(card: str, model, pcm: np.ndarray) -> dict:
    """The bf16 model's f32 BiLSTM in IEEE f32 whatever the caller's flags:
    the serving slice's WAV served (``InferencePipeline.logits_for_audio``)
    with ``torch.backends.cudnn.allow_tf32`` True, PyTorch's default, and
    False; the logits must be bit-equal. Then the LSTM's device time at the
    serving shape, (64, 1500, 512), under the default flags, in turns: as
    the model runs it now (scoped out of TF32) and the unscoped cuDNN call
    it made before the repair (TF32). Returns the times."""
    import torch

    from segma_tpu_torch.inference import InferencePipeline

    cudnn = torch.backends.cudnn

    def flags(allow: bool):
        return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                           deterministic=cudnn.deterministic, allow_tf32=allow)

    pipe = InferencePipeline(model, batch_size=INNER_BATCH)
    logits = {}
    for allow in (True, False):
        with flags(allow), torch.inference_mode():
            logits[allow] = pipe.logits_for_audio(pcm)
    if not np.array_equal(logits[True], logits[False]):
        diff = float(np.abs(logits[True] - logits[False]).max())
        raise AssertionError(f"bf16 serving logits differ with cuDNN's TF32 allowed: {diff:.3e}")
    print(f"check bf16 surgical_hydra served with cudnn.allow_tf32 True and False [{card}]: "
          f"logits {logits[True].shape} bit-equal", flush=True)
    lstm = model.module.lstm_shared
    gen = torch.Generator("cuda").manual_seed(0)
    x = torch.randn((INNER_BATCH, 1500, lstm.lstm.input_size), generator=gen,
                    device="cuda").to(torch.bfloat16)
    with flags(True), torch.inference_mode():
        unscoped = lstm.lstm(x.float())[0]
        scoped = lstm(x)
        times = time_turns({"after": lambda: lstm(x), "before": lambda: lstm.lstm(x.float())},
                           iters=5)
    out = {k: median(v) for k, v in times.items()}
    print(f"BiLSTM at ({INNER_BATCH}, 1500, {lstm.lstm.input_size}) under PyTorch's default "
          f"flags [{card}]: {out['after']:.4f} ms repaired (IEEE f32), {out['before']:.4f} ms "
          f"before the repair (cuDNN TF32; {spread(times['before'])}); their outputs differ by "
          f"{float((unscoped - scoped).abs().max()):.3e}", flush=True)
    return out

# The LSTM kernel's shapes (B, T, I, H, layers, bidirectional): serving's
# (Whisper's 1500 positions), the truncating variants' 199 and odd batches,
# whose last cluster holds fewer than 8 rows, at H 128 and the tests' 16
LSTM_SHAPES = (
    (INNER_BATCH, 1500, 512, 128, 2, True), (INNER_BATCH, 199, 512, 128, 2, True),
    (1, 199, 512, 128, 2, True), (5, 1500, 512, 128, 2, True), (67, 199, 512, 128, 2, True),
    (5, 300, 128, 16, 2, True), (3, 77, 40, 48, 1, False),
)
# The LSTM kernel against the CPU's f32 torch.lstm: f32 sums in another order
# (each gate's sum over k in eight slices, then a butterfly over lanes), the
# rounding carried through every step, so the outputs agree to this, not bit
# for bit (the kernel read at most 1.8e-7 from the CPU at LSTM_SHAPES, an
# H100). Against cuDNN's torch.lstm (TF32 off) the limit is wider: cuDNN
# itself lies 2.3e-6 to 1.2e-5 from the CPU at these shapes and seeds
LSTM_ATOL = 1e-5
LSTM_CUDNN_ATOL = 5e-5


def lstm_bounds(b: int, t: int, hidden: int, dirs: int) -> dict:
    """The bound of one layer call's recurrence: the recurrent products, 2 H
    4H FLOP a row, step and direction, at the f32 CUDA-core peak, and the
    bytes, the input projection G (4H a row, step and direction) read once
    and the output (H) written once."""
    flops = 2 * b * t * dirs * 4 * hidden * hidden
    n_bytes = 4 * b * t * dirs * 5 * hidden
    ms, by = bound_ms(flops, PEAK_F32_FLOPS, n_bytes)
    return {"bound_ms": ms, "bound_by": by, "ops_ms": flops / PEAK_F32_FLOPS * 1e3,
            "bytes_ms": n_bytes / PEAK_BYTES_PER_S * 1e3}


def wavlm_layers(cfg) -> int:
    """The gated-bias attention kernel's launches an inner batch (or
    validation batch) of ``cfg``'s model in inference: a WavLM's layers in
    bf16 (its snapshot's, WavLM-base's without one), 0 otherwise. Training
    steps run the plain attention and launch none."""
    if cfg.model.name != "surgical_wavlm_hydra" or cfg.train.precision == "f32":
        return 0
    from segma_tpu_torch.models.wavlm.convert import read_wavlm_config

    return read_wavlm_config(Path(cfg.model.config.wav_encoder)).n_layers


def lstm_layers(cfg) -> int:
    """The LSTM kernel's launches an inner batch (or validation batch) of
    ``cfg``'s model in inference: the layers of its BiLSTM (the Whisper
    variants with one, sincnet_hydra), 0 without one. Training steps run
    cuDNN and launch none."""
    from segma_tpu_torch.models.whisper.builders import VARIANTS

    name = cfg.model.name
    if name != "sincnet_hydra" and VARIANTS.get(name, (None, None))[1] != "lstm":
        return 0
    return cfg.model.config.lstm.num_layers


def lstm_checks(card: str) -> dict:
    """The BiLSTM's kernel path (``BiLSTM`` under ``inference_mode``: the
    input GEMM and ``csrc/lstm_fwd.cu``) against cuDNN's ``torch.lstm`` on the
    card (LSTM_CUDNN_ATOL) and the CPU's f32 ``torch.lstm`` (LSTM_ATOL) at
    LSTM_SHAPES, its launches one a
    layer, bitwise over two calls and through the registered op; then one
    layer call at the serving shape timed in turns: the kernel alone, the
    layer call (GEMM and kernel), cuDNN's call (the yardstick the port no
    longer calls in serving), and the plain version beside the bound."""
    import copy
    import ctypes

    import torch

    from segma_tpu_torch.config import LSTMConfig
    from segma_tpu_torch.models.layers import BiLSTM
    from segma_tpu_torch.ops import _build, rnn

    lib = _build.library()
    clusters = ctypes.c_int(0)
    _build.check(lib.segma_lstm_fwd_clusters(128, ctypes.byref(clusters)), "clusters")
    print(f"lstm_fwd [{card}]: {clusters.value} clusters of two CTAs at once at H 128 "
          f"(serving needs {INNER_BATCH} for one wave)", flush=True)
    errs, cudnn_errs = [], []
    for b, t, i, h, layers, bidir in LSTM_SHAPES:
        cfg = LSTMConfig(hidden_size=h, num_layers=layers, bidirectional=bidir, dropout=0.0)
        with torch.random.fork_rng():
            torch.manual_seed(b * t + h)
            cpu = BiLSTM(i, cfg)
        mod = copy.deepcopy(cpu).cuda()
        x = torch.from_numpy(np.random.default_rng(t).standard_normal((b, t, i)).astype(np.float32))
        with torch.inference_mode():
            before = rnn.launches
            got = mod(x.cuda())
            torch.cuda.synchronize()
            if rnn.launches != before + layers:
                raise AssertionError(f"lstm_fwd {(b, t, i, h)}: {rnn.launches - before} launches")
            cudnn = mod.lstm(x.cuda())[0]
            ref = cpu(x)
            label = f"lstm_fwd {(b, t, i)} H {h} x{layers}{' bidirectional' if bidir else ''}"
            errs.append(check_close(f"{label} against the CPU", got.cpu(), ref, LSTM_ATOL))
            check_close(f"{label} against cuDNN", got, cudnn, LSTM_CUDNN_ATOL)
            cudnn_errs.append(float((cudnn.cpu() - ref).abs().max()))
            print(f"check {label}: cuDNN against the CPU {cudnn_errs[-1]:.3e}", flush=True)
            if not torch.equal(got, mod(x.cuda())):
                raise AssertionError(f"{label}: two calls differ")
            if not torch.equal(got, rnn.lstm(x.cuda(), mod.weights, layers, bidir, False)):
                raise AssertionError(f"{label}: the registered op differs from the module")
        del mod, got, cudnn
        torch.cuda.empty_cache()
    print(f"check lstm_fwd: one launch a layer, bitwise over two calls and through the "
          f"registered op, at {len(LSTM_SHAPES)} shapes", flush=True)

    b, t, i, h = INNER_BATCH, 1500, 512, 128
    lstm = torch.nn.LSTM(i, h, bidirectional=True, batch_first=True).cuda()
    weights = [getattr(lstm, n) for n in lstm._flat_weights_names]
    x = torch.randn((b, t, i), device="cuda", generator=torch.Generator("cuda").manual_seed(4))
    with torch.inference_mode():
        layer = rnn._layer_weights(weights, 0, 2)
        gates = rnn.input_gates(x, layer)
        w_hh = torch.stack([w for _, w, _, _ in layer]).contiguous()
        times = time_turns({
            "kernel": lambda: rnn.launch(lib, gates, w_hh),
            "layer call": lambda: rnn.lstm_cuda(x, weights, 1, True),
            "input GEMM": lambda: rnn.input_gates(x, layer),
            "cudnn": lambda: rnn.torch_lstm(x, weights, 1, True, False),
        }, iters=5)
        plain_ms = time_ms(lambda: rnn.lstm_plain(x, weights, 1, True), iters=1, warmup=1)
    for name, ts in times.items():
        print(f"time lstm {name} ({b}, {t}, {i}) H {h} bidirectional [{card}]: {spread(ts)}",
              flush=True)
    ms = median(times["kernel"])
    bounds = lstm_bounds(b, t, h, 2)
    print(
        f"time lstm_fwd ({b}, {t}, H {h}, both directions) [{card}]: kernel {ms:.4f} ms "
        f"({ms / t * 1e3:.3f} us a step), layer call {median(times['layer call']):.4f} ms "
        f"(input GEMM {median(times['input GEMM']):.4f} ms), cuDNN's call "
        f"{median(times['cudnn']):.4f} ms, plain {plain_ms:.3f} ms; bound "
        f"{bounds['bound_ms']:.4f} ms ({bounds['bound_by']}; {100 * bounds['bound_ms'] / ms:.1f}% "
        f"of it; bytes {bounds['bytes_ms']:.4f} ms)", flush=True,
    )
    return {
        "name": "lstm_fwd", "route": "cuda", "source": "segma_tpu_torch/csrc/lstm_fwd.cu",
        "replaces": "cuDNN's LSTM in inference (no TPU kernel: segma_tpu/models/layers.py "
                    "BiLSTM is a lax.scan)",
        "max_abs_err": max(errs), "cudnn_max_abs_err": max(cudnn_errs), "ms": ms,
        "layer_call_ms": median(times["layer call"]),
        "input_gemm_ms": median(times["input GEMM"]), "plain_ms": plain_ms,
        "library_ms": median(times["cudnn"]), "clusters": clusters.value, **bounds,
    }


# WavLM's gated-bias attention (op segma_tpu_torch::wavlm_attn_fwd): WavLM-Large's
# serving shape, WavLM-base's, 30 s windows' lengths, and the edges of the
# kernel's 128-row and 128-key tiles; (B, T, H, 64)
WAVLM_ATTN_SHAPES = ((INNER_BATCH, 199, 16, 64), (INNER_BATCH, 199, 12, 64), (8, 800, 16, 64),
                     (8, 1500, 16, 64), (3, 1, 2, 64), (2, 127, 4, 64), (2, 129, 4, 64),
                     (2, 256, 3, 64), (1, 4096, 2, 64))
WAVLM_TIMED_SHAPES = WAVLM_ATTN_SHAPES[:4]
# WavLM-Large's encoder config (huggingface.co/microsoft/wavlm-large), the port's keys
WAVLM_LARGE = dict(hidden_size=1024, n_layers=24, n_heads=16, ffn_dim=4096,
                   feat_extract_norm="layer", conv_bias=False, stable_layer_norm=True)
WAVLM_LARGE_STEPS = 3
WAVLM_LARGE_GRAD_ATOL = 1e-4  # the f32 port's gradients, per leaf (tests' GRAD_ATOL)
WAVLM_LARGE_BF16_GRAD_GAP = 0.1  # the bf16 port's, all leaves' relative norm


def wavlm_attn_inputs(shape, seed: int):
    """q, k, v N(0, 1) in bf16, gates in (1, 3) as WavLM's ``a (b c - 1) +
    2`` with c near 1 gives, and N(0, 1) rows (the benchmark's draw of the
    relative-position table): a bias as large as the scores."""
    import torch

    b, t, h, d = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(shape, device="cuda", generator=g).to(torch.bfloat16)
               for _ in range(3))
    gate = 1.0 + 2.0 * torch.rand((b, h, t), device="cuda", generator=g)
    rel = torch.randn((h, 2 * t - 1), device="cuda", generator=g)
    return q, k, v, gate, rel


def wavlm_attn_bound_ms(b: int, t: int, h: int, d: int) -> float:
    """The two products at the bf16 peak, or q, k, v read and the output
    written once in bf16 with the f32 gate and rows read, at HBM rate."""
    n_bytes = 8 * b * t * h * d + 4 * b * h * t + 4 * h * (2 * t - 1)
    return bound_ms(4 * b * h * t * t * d, PEAK_BF16_FLOPS, n_bytes)[0]


def wavlm_attn_checks(card: str) -> dict:
    """The gated-bias attention kernel against ``wavlm_attention_plain`` (f32
    scores, the bias materialised) at WAVLM_ATTN_SHAPES within the bf16
    flash forward's tolerance, one launch a call, bitwise over two launches
    and through the registered op; then timed in turns at WAVLM_TIMED_SHAPES
    beside the plain version and, as the library's yardstick, SDPA with the
    materialised (B, H, T, T) bias as its bf16 ``attn_mask``."""
    import torch
    import torch.nn.functional as F

    from segma_tpu_torch.ops import attention, launch_counts
    from segma_tpu_torch.ops.attention import relative_bias

    sm = 64**-0.5
    errs = []
    for shape in WAVLM_ATTN_SHAPES:
        q, k, v, gate, rel = wavlm_attn_inputs(shape, sum(shape))
        before = launch_counts()["wavlm_attn_fwd"]
        out = attention.wavlm_attn_fwd(q, k, v, gate, rel, sm)
        if launch_counts()["wavlm_attn_fwd"] != before + 1:
            raise AssertionError(f"wavlm_attn_fwd {shape}: not one launch")
        ref = attention.wavlm_attention_plain(q.float(), k.float(), v.float(), gate, rel, sm)
        errs.append(check_close(f"wavlm_attn_fwd {shape}", out, ref, FLASH_ATOL, FLASH_RTOL))
        if not torch.equal(out, attention.wavlm_attn_fwd(q, k, v, gate, rel, sm)):
            raise AssertionError(f"wavlm_attn_fwd {shape}: two launches differ")
        if not torch.equal(out, attention.wavlm_attn_op(q, k, v, gate, rel, sm)):
            raise AssertionError(f"wavlm_attn_fwd {shape}: the registered op differs")
        del q, k, v, gate, rel, out, ref
        torch.cuda.empty_cache()
    print(f"check wavlm_attn_fwd: one launch a call, bitwise over two launches and through "
          f"the registered op, at {len(WAVLM_ATTN_SHAPES)} shapes", flush=True)

    timed = {}
    for shape in WAVLM_TIMED_SHAPES:
        b, t, h, d = shape
        q, k, v, gate, rel = wavlm_attn_inputs(shape, 7)
        mask = (gate[..., None] * relative_bias(rel, t)[None]).to(torch.bfloat16)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        times = time_turns({
            "kernel": lambda: attention.wavlm_attn_fwd(q, k, v, gate, rel, sm),
            "op": lambda: attention.wavlm_attn_op(q, k, v, gate, rel, sm),
            "sdpa, mask given": lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                                       scale=sm),
        })
        plain_ms = time_ms(lambda: attention.wavlm_attention_plain(q, k, v, gate, rel, sm),
                           iters=3)
        bound = wavlm_attn_bound_ms(b, t, h, d)
        row = {name: median(ts) for name, ts in times.items()}
        row.update(plain_ms=plain_ms, bound_ms=bound, share=100 * bound / row["kernel"])
        timed[str(shape)] = row
        for name, ts in times.items():
            print(f"time wavlm_attn {name} {shape} [{card}]: {spread(ts)}", flush=True)
        print(f"time wavlm_attn_fwd {shape} [{card}]: kernel {row['kernel']:.4f} ms (op "
              f"{row['op']:.4f}), bound {bound:.4f} ms ({row['share']:.1f}% of it), plain "
              f"{plain_ms:.3f} ms, SDPA with the materialised bias {row['sdpa, mask given']:.4f} "
              f"ms", flush=True)
        del q, k, v, gate, rel, mask, qt, kt, vt
        torch.cuda.empty_cache()
    return {"name": "wavlm_attn_fwd", "route": "cuda",
            "source": "segma_tpu_torch/csrc/flash_attn.cu (kBias)",
            "replaces": "none: WavLM's biased attention is XLA "
                        "(segma_tpu/models/wavlm/encoder.py)",
            "max_abs_err": max(errs), "timed": timed}


def wavlm_large_grads(model, twin) -> dict:
    """One step's gradients of WavLM-Large at its published widths on the
    card, 2 crops of 4 s, dropout off, at the initial weights: ``model`` (bf16)
    and ``twin`` (the same weights in f32), each through ``forward_backward``,
    against autograd through the plain f32 reference ``tests/plain_wavlm.py``
    (HF's ``WavLMEncoderStableLayerNorm`` written out, nothing of the port).
    The f32 port holds each leaf within WAVLM_LARGE_GRAD_ATOL x max(1,
    max|g|), the CPU tests' pin at tiny widths; the bf16 port, the leaves'
    relative norm of the difference taken together within
    WAVLM_LARGE_BF16_GRAD_GAP."""
    import torch

    from segma_tpu_torch.train import forward_backward, make_optimizer
    from tests import plain_wavlm

    enc = twin.module.enc_cfg
    keys = dict(hidden_size=enc.hidden_size, num_hidden_layers=enc.n_layers,
                num_attention_heads=enc.n_heads, intermediate_size=enc.ffn_dim,
                conv_dim=list(enc.conv_dim), conv_kernel=list(enc.conv_kernels),
                conv_stride=list(enc.conv_strides), num_conv_pos_embeddings=enc.pos_conv_kernel,
                num_conv_pos_embedding_groups=enc.pos_conv_groups, num_buckets=enc.num_buckets,
                max_bucket_distance=enc.max_distance, feat_extract_norm=enc.feat_extract_norm,
                conv_bias=enc.conv_bias, do_stable_layer_norm=enc.stable_layer_norm,
                layer_norm_eps=1e-5)
    rng = np.random.default_rng(25)
    wav = torch.from_numpy((rng.standard_normal((2, 64_000)) * 0.1).astype(np.float32)).to(model.device)
    y = torch.from_numpy((rng.random((2, model.n_windows, 4)) > 0.7).astype(np.float32)).to(model.device)
    got = {}
    for m in (model, twin):
        dropout, m.module.dropout = m.module.dropout, 0.0
        forward_backward(m, make_optimizer(m, 1e-4), wav, y, None)
        m.module.dropout = dropout
        got[m.compute_dtype] = {n: p.grad for n, p in m.module.named_parameters()
                                if p.grad is not None}
    named = dict(twin.module.named_parameters())
    sd = {k: v.detach().clone().requires_grad_(v.requires_grad) for k, v in named.items()}
    twin.loss(plain_wavlm.logits(sd, keys, wav), y)[0].backward()
    want = {n: sd[n].grad for n in got[torch.float32]}
    if set(want) != set(got[torch.bfloat16]) or any(g is None for g in want.values()):
        raise AssertionError("WavLM-Large gradients: the port and the reference differ in leaves")
    def leaf_gap(dtype) -> float:
        return max(float((got[dtype][n].float() - w).abs().max()) / max(1.0, float(w.abs().max()))
                   for n, w in want.items())

    diff = sum(float((got[torch.bfloat16][n].float() - w).square().sum()) for n, w in want.items())
    norm = sum(float(w.square().sum()) for w in want.values())
    f32_gap, bf16_gap = leaf_gap(torch.float32), (diff / norm) ** 0.5
    row = {"leaves": len(want), "f32_gap": f32_gap, "bf16_gap": bf16_gap,
           "bf16_leaf_gap": leaf_gap(torch.bfloat16)}
    print(f"check WavLM-Large gradients against the plain f32 reference: {row}", flush=True)
    if f32_gap > WAVLM_LARGE_GRAD_ATOL or bf16_gap > WAVLM_LARGE_BF16_GRAD_GAP:
        raise AssertionError(f"WavLM-Large gradients off the reference: {row}")
    for m in (model, twin):
        m.module.zero_grad(set_to_none=True)
    return row


def wavlm_large_steps(card: str) -> dict:
    """WavLM-Large (``surgical_wavlm_hydra`` at its published widths and
    layout, random weights) on the card: one step's gradients against the
    plain f32 reference (``wavlm_large_grads``); WAVLM_LARGE_STEPS training
    steps of 8 crops of 4 s (``make_train_step``, as ``Trainer.fit``'s step
    dispatch runs them) in f32 and then in bf16 from the same weights and
    batches, with finite losses; then one served inner batch of INNER_BATCH
    windows with one gated-bias launch a layer."""
    import warnings

    import torch

    from segma_tpu_torch.config import (
        AudioConfig, Config, DataConfig, ModelConfig, SurgicalHubertHydraConfig, TrainConfig,
    )
    from segma_tpu_torch.models import Models
    from segma_tpu_torch.models.wavlm.encoder import WavLMEncoderConfig
    from segma_tpu_torch.ops import launch_counts
    from segma_tpu_torch.train import make_optimizer, make_train_step
    from segma_tpu_torch.utils.encoders import MultiLabelEncoder

    def build(precision: str):
        cfg = Config(data=DataConfig(classes=list(TRAIN_CLASSES)),
                     audio=AudioConfig(chunk_duration_s=4.0, sample_rate=16_000,
                                       strict_frames=True),
                     model=ModelConfig(name="surgical_wavlm_hydra",
                                       config=SurgicalHubertHydraConfig(
                                           wav_encoder="wavlm_large_random", encoder_layers=[],
                                           reduction="weighted", classifier=256)),
                     train=TrainConfig(lr=1e-4, batch_size=8, precision=precision))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # random encoder weights, on purpose
            return cfg, Models["surgical_wavlm_hydra"](
                MultiLabelEncoder(cfg.data.classes), cfg, device="cuda",
                generator=torch.Generator().manual_seed(0),
                enc_cfg=WavLMEncoderConfig(**WAVLM_LARGE))

    cfg, model = build("bf16")
    twin = build("f32")[1]
    twin.module.load_state_dict(model.module.state_dict())
    n_params = sum(p.numel() for p in model.module.parameters())
    grads = wavlm_large_grads(model, twin)
    rng = np.random.default_rng(24)
    batches = [{"x": torch.from_numpy((rng.standard_normal((8, 64_000)) * 0.1)
                                      .astype(np.float32)).cuda(),
                "y": torch.from_numpy((rng.random((8, model.n_windows, 4)) > 0.7)
                                      .astype(np.float32)).cuda()}
               for _ in range(WAVLM_LARGE_STEPS)]

    def steps(m) -> list[float]:
        step = make_train_step(m, make_optimizer(m, cfg.train.lr))
        return [float(step(batch, torch.Generator(device="cuda").manual_seed(i))[0])
                for i, batch in enumerate(batches)]

    losses_f32 = steps(twin)
    del twin
    before = launch_counts()
    t0 = time.perf_counter()
    losses = steps(model)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / WAVLM_LARGE_STEPS
    trained = launch_counts()["wavlm_attn_fwd"] - before["wavlm_attn_fwd"]
    if not np.isfinite(losses + losses_f32).all() or trained:
        raise AssertionError(f"WavLM-Large steps: losses {losses}, f32 {losses_f32}, "
                             f"{trained} kernel launches")
    with torch.inference_mode():
        wav = torch.randn((INNER_BATCH, 64_000), device="cuda") * 0.1
        before = launch_counts()["wavlm_attn_fwd"]
        logits = model.apply(wav)
        torch.cuda.synchronize()
        served = launch_counts()["wavlm_attn_fwd"] - before
    if served != WAVLM_LARGE["n_layers"] or not torch.isfinite(logits).all():
        raise AssertionError(f"WavLM-Large served: {served} launches")
    print(f"check WavLM-Large [{card}]: {n_params} parameters, {WAVLM_LARGE_STEPS} steps of "
          f"8 crops, losses bf16 {losses}, f32 {losses_f32} (same weights and batches), "
          f"{step_s:.3f} s a bf16 step (the first included), no kernel launch in training; "
          f"one inner batch of {INNER_BATCH} served with {served} launches, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    del model
    torch.cuda.empty_cache()
    return {"losses": losses, "losses_f32": losses_f32, "step_s": step_s, "params": n_params,
            "served_launches": served, "grads": grads}


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
    import dataclasses
    import warnings

    import torch

    from segma_tpu_torch.data import SegmaFileDataset, SegmentationDataLoader
    from segma_tpu_torch.models import Models
    from segma_tpu_torch.ops import attention, logmel
    from segma_tpu_torch.train import Trainer, deterministic_cudnn
    from segma_tpu_torch.utils.encoders import MultiLabelEncoder

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "data"
        write_dataset(root, TRAIN_CLASSES, (TRAIN_FILES, VAL_FILES, TEST_FILES), TRAIN_FILE_S)
        cfg = surgical_hubert_hydra_config(root)
        # the host data path stays covered here; the default (auto) resolves
        # to the device cache, which phase_device_cache holds against it
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, data_cache="host"))
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
        # spread of its wall time is the host's; under the cuDNN algorithms
        # the seeded fit used
        step_ms = []
        with deterministic_cudnn(True):
            for _ in range(WARM_STEP_REPEATS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                trainer.train_step(warm_batch, gen)
                torch.cuda.synchronize()
                step_ms.append(1e3 * (time.perf_counter() - t0))
            print(f"train step repeated on one batch [{card}]: {WARM_STEP_REPEATS} steps, "
                  f"median {median(step_ms):.3f} ms (min {min(step_ms):.3f}, max "
                  f"{max(step_ms):.3f})", flush=True)
            profile_run(card, "train step", lambda: trainer.train_step(warm_batch, gen),
                        warm / n_steps)
            optimizer_times(card, model, trainer, warm_batch, gen)
    return launches


def optimizer_times(card: str, model, trainer, batch: dict, gen) -> dict:
    """The card's optimizer (``train.make_optimizer``: a capturable AdamW, its
    rate a device tensor) against PyTorch's default AdamW with a float rate
    (the optimizer the port used before epoch dispatch), on the training
    slice's model: the host's time to queue one ``step()`` and its device
    time (``time_turns``), then the whole step repeated on one batch, synced,
    with each, in turns. Returns the medians in ms."""
    import torch

    from segma_tpu_torch.train import (
        ADAMW_BETAS, ADAMW_EPS, ADAMW_WEIGHT_DECAY, make_train_step,
    )

    lr = float(trainer.optimizer.param_groups[0]["lr"])
    default = torch.optim.AdamW(model.trainable_parameters(), lr=lr, betas=ADAMW_BETAS,
                                eps=ADAMW_EPS, weight_decay=ADAMW_WEIGHT_DECAY)
    steps = {"capturable": trainer.train_step, "default": make_train_step(model, default)}
    opts = {"capturable": trainer.optimizer, "default": default}
    for step in steps.values():  # the default AdamW's state is made here
        step(batch, gen)
    queue_ms: dict[str, list[float]] = {k: [] for k in opts}
    walls: dict[str, list[float]] = {k: [] for k in opts}
    for _ in range(WARM_STEP_REPEATS):
        for name, opt in opts.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opt.step()
            queue_ms[name].append(1e3 * (time.perf_counter() - t0))
        for name, step in steps.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(batch, gen)
            torch.cuda.synchronize()
            walls[name].append(1e3 * (time.perf_counter() - t0))
    device = time_turns({k: opt.step for k, opt in opts.items()}, groups=3, iters=5)
    out = {}
    for name in opts:
        out[name] = {"queue_ms": median(queue_ms[name]), "device_ms": median(device[name]),
                     "step_ms": median(walls[name])}
        print(f"AdamW {name} over {sum(p.numel() for p in model.trainable_parameters())} "
              f"parameters [{card}]: host queues a step() in {out[name]['queue_ms']:.3f} ms "
              f"(min {min(queue_ms[name]):.3f}, max {max(queue_ms[name]):.3f}), device "
              f"{spread(device[name])}; the train step repeated on one batch, synced, median "
              f"{out[name]['step_ms']:.3f} ms (min {min(walls[name]):.3f}, max "
              f"{max(walls[name]):.3f})", flush=True)
    return out


def reset_launches() -> None:
    """Every kernel wrapper's launch count to 0."""
    from segma_tpu_torch.ops import launch_counts, set_launch_counts

    set_launch_counts(dict.fromkeys(launch_counts(), 0))


def read_launches() -> dict:
    from segma_tpu_torch.ops import launch_counts

    return launch_counts()


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
    from segma_tpu_torch.geometry import ConvolutionSettings
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
                    "flash_attn_fwd_f32": n_layers * n_inner, "flash_attn_bwd_f32": 0,
                    "lstm_fwd": lstm_layers(cfg) * n_inner, "wavlm_attn_fwd": 0}
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
    from segma_tpu_torch.train import Trainer, deterministic_cudnn

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
                "flash_attn_bwd_f32": n_layers * n_steps * TRAIN_EPOCHS, "lstm_fwd": 0,
                "wavlm_attn_fwd": 0}
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
        with deterministic_cudnn(True):  # as in the seeded fit
            trainer.train_step(batch, gen)
            profile_run(card, "train f32 step", lambda: trainer.train_step(batch, gen),
                        warm / n_steps)
    return launches


# -- the reference workflow: exact resume, snapshots, predict, tune, evaluate --------

WHISPER_BASE = dict(d_model=512, encoder_attention_heads=8, encoder_layers=6,
                    encoder_ffn_dim=2048, num_mel_bins=80, max_source_positions=1500)
HUBERT_BASE = dict(hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
                   intermediate_size=3072, conv_dim=[512] * 7, conv_kernel=[10, 3, 3, 3, 3, 2, 2],
                   conv_stride=[5, 2, 2, 2, 2, 2, 2], num_conv_pos_embeddings=128,
                   num_conv_pos_embedding_groups=16)
# WavLM-base: HuBERT-base's widths, 320 relative-position buckets out to 800
WAVLM_BASE = dict(HUBERT_BASE, num_buckets=320, max_bucket_distance=800)
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
    t = hubert_snapshot_tensors(seed, dims)
    out.mkdir(parents=True)
    (out / "config.json").write_text(json.dumps({
        "model_type": "hubert", "feat_extract_norm": "group", "do_stable_layer_norm": False,
        **dims}))
    write_safetensors(out / "model.safetensors", t)
    return t


def write_wavlm_snapshot(out: Path, seed: int, dims: dict = WAVLM_BASE
                         ) -> dict[str, np.ndarray]:
    """A random WavLM snapshot (WavLM-base unless ``dims`` says otherwise) in
    HF's ``WavLMModel`` layout: HuBERT's tensors, and in every layer
    ``attention.gru_rel_pos_linear`` (8, head_dim) and ``gru_rel_pos_const``
    (1, H, 1, 1), in layer 0 ``attention.rel_attn_embed.weight`` (buckets, H).
    Returns the tensors written."""
    t = hubert_snapshot_tensors(seed, dims)
    weight, vec = _snapshot_tensors(seed + 1)
    rng = np.random.default_rng(seed + 2)
    h = dims["num_attention_heads"]
    for i in range(dims["num_hidden_layers"]):
        pre = f"encoder.layers.{i}.attention."
        t[pre + "gru_rel_pos_linear.weight"] = weight(8, dims["hidden_size"] // h)
        t[pre + "gru_rel_pos_linear.bias"] = vec(8)
        t[pre + "gru_rel_pos_const"] = vec(h, 1.0).reshape(1, h, 1, 1)
    t["encoder.layers.0.attention.rel_attn_embed.weight"] = (
        0.02 * rng.standard_normal((dims["num_buckets"], h))).astype(np.float32)
    out.mkdir(parents=True)
    (out / "config.json").write_text(json.dumps({
        "model_type": "wavlm", "feat_extract_norm": "group", "do_stable_layer_norm": False,
        **dims}))
    write_safetensors(out / "model.safetensors", t)
    return t


def hubert_snapshot_tensors(seed: int, dims: dict) -> dict[str, np.ndarray]:
    """The tensors of ``write_hubert_snapshot``, random from ``seed``."""
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
    """The reference workflow on the card, in bf16 at full width (the
    exact-resume fits at TRAIN_CLI_LAYERS layers):

    1. exact resume, with no cuDNN flag set by the caller (a seeded
       ``Trainer.fit`` scopes cuDNN's deterministic algorithms itself, and
       gives the caller's flags back): ``surgical_hubert_hydra`` (the
       training slice's config over a random snapshot of HuBERT-base's
       widths at TRAIN_CLI_LAYERS layers) trains 2 epochs, twice; 1 epoch,
       then a fresh model and Trainer ``fit(..., resume_from=<run>/checkpoints/last)`` to epoch
       2; and once more from a copy of last/ without opt_state.msgpack. The
       two uninterrupted runs and the resumed run must agree bit for bit,
       trainable parameters and epoch-1 loss. The run with fresh moments
       must differ.
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
    from segma_tpu_torch.geometry import ConvolutionSettings
    from segma_tpu_torch.train import Trainer

    walls: dict[str, float] = {}
    launches: dict[str, dict] = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        root = tmp / "data"
        write_dataset(root, TRAIN_CLASSES, (TRAIN_FILES, VAL_FILES, TEST_FILES), TRAIN_FILE_S)
        labels = list(TRAIN_CLASSES)

        # 1. exact resume, at HuBERT-base's widths over TRAIN_CLI_LAYERS layers:
        # resume's mechanics do not depend on depth, and its checkpoints'
        # I/O scales with it
        write_hubert_snapshot(tmp / "hubert_resume", seed=17,
                              dims=dict(HUBERT_BASE, num_hidden_layers=TRAIN_CLI_LAYERS))
        cfg = surgical_hubert_hydra_config(root)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, config=dataclasses.replace(
            cfg.model.config, wav_encoder=str(tmp / "hubert_resume"))))
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

        # no cuDNN flag from here: a seeded fit scopes cuDNN's deterministic
        # algorithms itself (Trainer.fit), without which two identical bf16
        # runs differ within the first epoch (the positional conv's backward)
        cudnn = torch.backends.cudnn
        caller_flags = (cudnn.deterministic, cudnn.benchmark)
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
        if (cudnn.deterministic, cudnn.benchmark) != caller_flags:
            raise AssertionError("Trainer.fit left cuDNN's flags changed")
        n_layers = TRAIN_CLI_LAYERS
        want = {"logmel": 0, "flash_attn_fwd": n_layers * (n_steps + n_val),
                "flash_attn_bwd": n_layers * n_steps, "flash_attn_fwd_f32": 0,
                "flash_attn_bwd_f32": 0, "lstm_fwd": 0, "wavlm_attn_fwd": 0}
        if [h["epoch"] for h in h_res] != [1] or resume_launches != want:
            raise AssertionError(f"resumed fit ran epochs {[h['epoch'] for h in h_res]} with "
                                 f"launches {resume_launches} (want {want})")
        launches["resume"] = resume_launches
        d_repeat, d_resume, d_fresh = (_max_dist(full, x) for x in (repeat, resumed, fresh))
        loss_full, loss_res = h_full[1]["train/loss"], h_res[0]["train/loss"]
        print(f"workflow resume [{card}] (seeded fits, no flag from the caller): max |trainable - "
              f"uninterrupted| after epoch 2: "
              f"repeat {d_repeat:.3e}, resumed {d_resume:.3e}, fresh moments {d_fresh:.3e}; "
              f"epoch-1 train/loss uninterrupted {loss_full!r}, repeat "
              f"{h_repeat[1]['train/loss']!r}, resumed {loss_res!r}", flush=True)
        # a seeded run repeats on the card, and a resumed one follows it
        if d_repeat != 0.0 or h_repeat[1]["train/loss"] != loss_full:
            raise AssertionError(f"two identical seeded runs differ by {d_repeat:.3e}")
        if d_resume != 0.0 or loss_res != loss_full:
            raise AssertionError(f"the resumed run differs by {d_resume:.3e} from the "
                                 "uninterrupted one")
        print("check seeded repeat and exact resume: bit for bit, parameters and epoch-1 loss",
              flush=True)
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
                "flash_attn_bwd": 0, "flash_attn_fwd_f32": 0, "flash_attn_bwd_f32": 0,
                "lstm_fwd": lstm_layers(wcfg) * n_inner * len(val_uris), "wavlm_attn_fwd": 0}
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
    from segma_tpu_torch.geometry import ConvolutionSettings

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


def logmel_shape_row(card: str, label: str, shape: tuple[int, int], g) -> dict:
    """Log-mel on white noise of ``shape``: held to float64 over the whole
    batch (at most twice the f32 plain version's own error, or 1e-5, as in
    ``logmel_checks``), its distance from the plain version printed, and
    timed in turns beside the plain version and the cuFFT yardstick, with
    its bound. Returns its row."""
    import torch

    from segma_tpu_torch.ops import logmel

    wav = torch.randn(shape, device="cuda", generator=g) * 0.1
    ref = log_mel_float64(wav)
    plain = logmel.log_mel_spectrogram_plain(wav)
    plain_err = float((plain.double() - ref).abs().max())
    got = logmel.finish(logmel.log10_mel_cuda(wav))
    err = float((got.double() - ref).abs().max())
    limit = max(2 * plain_err, LOGMEL_ATOL)
    if not err <= limit:
        raise AssertionError(f"logmel {label}: {err:.3e} from float64 exceeds {limit:.3e}")
    print(f"check logmel {label} {tuple(wav.shape)} against float64: kernel {err:.3e}, "
          f"plain {plain_err:.3e} (limit {limit:.3e} = max(2 x plain, {LOGMEL_ATOL})); "
          f"kernel vs plain {float((got - plain).abs().max()):.3e}", flush=True)
    window = torch.hann_window(400, device="cuda")
    fb = logmel._plain_tables(wav.device)[2]
    times = time_turns({"kernel": lambda: logmel.log10_mel_cuda(wav),
                        "plain": lambda: logmel.log10_mel_plain(wav),
                        "stft yardstick": lambda: stft_log10_mel(wav, window, fb)})
    for name, t in times.items():
        print(f"time logmel {label} {name} {tuple(wav.shape)} [{card}]: {spread(t)}",
              flush=True)
    bounds = logmel_bounds(*wav.shape)
    return {"shape": list(wav.shape), "max_abs_err": err,
            "ms": median(times["kernel"]), "plain_ms": median(times["plain"]),
            "stft_yardstick_ms": median(times["stft yardstick"]), "library_ms": None,
            "bound_ms": bounds["bound_ms"], "bound_by": bounds["bound_by"]}


def fast_context_kernel_times(card: str) -> dict:
    """The three forward kernels at the fast_context shapes: log-mel on (64,
    64000), the bf16 and the f32 flash forward on (64, 200, 8, 64). Each is
    held against its plain version (log-mel on white noise over the batch
    against float64, at most twice the plain version's own error, as in
    ``logmel_checks``; FLASH_ATOL/RTOL; FLASH_F32_ATOL and float64) and timed in turns beside it and, for
    flash, every SDPA backend that takes the dtype; with its bound."""
    import torch

    from segma_tpu_torch.ops import attention

    g = torch.Generator(device="cuda").manual_seed(9)
    out: dict[str, dict] = {"logmel": logmel_shape_row(
        card, "fast_context", (INNER_BATCH, FAST_CONTEXT_SAMPLES), g)}
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
    from segma_tpu_torch.geometry import ConvolutionSettings
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
            want["lstm_fwd"] = lstm_layers(cfg) * n_inner
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
                "flash_attn_bwd": 0, "flash_attn_fwd_f32": 0, "flash_attn_bwd_f32": 0,
                "lstm_fwd": lstm_layers(tcfg) * TRAIN_EPOCHS * n_val, "wavlm_attn_fwd": 0}
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


# -- the JAX package's four other model families ---------------------------------------

FAMILY_NAMES = ("surgical_wavlm_hydra", "sincnet_hydra", "conv_vad", "powerset_vad")
FAMILY_LOGMEL = ("conv_vad", "powerset_vad")  # the families that run the log-mel kernel
FAMILY_EPOCH_DISPATCH = ("surgical_wavlm_hydra", "powerset_vad")  # also fit under replay
FAMILY_WAV_S = 400.0  # the served WAV: 100 chunks of 4 s, 2 inner batches of 64
VAD_TRAIN_SHAPE = (32, 64_000)  # conv_vad's and powerset_vad's log-mel in training
WAVLM_LOSS_CROPS = 8  # the step-1 batch's crops WavLM-base's loss is compared on


def family_config(name: str, dataset_path, wav_encoder: str = "wavlm_base",
                  precision: str = "bf16", **train):
    """``config/default.yml`` with model.name=``name`` and its per-model YAML,
    data.dataset_path, train.seed=0, train.max_epochs=2,
    train.dataloader.num_workers=1 and the compute dtype ``precision``
    (``model.config.dtype``, or train.precision for surgical_wavlm_hydra,
    which also takes audio.strict_frames=true and model.config.wav_encoder);
    any other ``train`` fields. Built in code so that the script needs no
    pyyaml; tests/test_torch_families.py holds it equal to ``load_config``."""
    from segma_tpu_torch.config import (
        AudioConfig, Config, ConvVADConfig, DataConfig, DataloaderConfig, LSTMConfig,
        ModelConfig, SincNetHydraConfig, SurgicalHubertHydraConfig, TrainConfig,
    )

    wavlm = name == "surgical_wavlm_hydra"
    mc = {
        "surgical_wavlm_hydra": lambda: SurgicalHubertHydraConfig(
            wav_encoder=wav_encoder, encoder_layers=[], reduction="weighted", classifier=256),
        "sincnet_hydra": lambda: SincNetHydraConfig(
            stride=10, filters=80, kernel_size=251, hidden=128, dtype=precision,
            lstm=LSTMConfig(hidden_size=128, num_layers=2, bidirectional=True, dropout=0.0)),
        "conv_vad": lambda: ConvVADConfig(hidden=256, depth=4, dtype=precision),
        "powerset_vad": lambda: ConvVADConfig(hidden=256, depth=4, dtype=precision),
    }[name]()
    return Config(
        data=DataConfig(classes=list(TRAIN_CLASSES), dataset_path=str(dataset_path)),
        audio=AudioConfig(chunk_duration_s=4.0, sample_rate=16_000, strict_frames=wavlm),
        model=ModelConfig(name=name, chkp_path="models", config=mc),
        train=TrainConfig(lr=1e-3, batch_size=32, max_epochs=TRAIN_EPOCHS, seed=0,
                          precision=precision if wavlm else "bf16",
                          dataloader=DataloaderConfig(num_workers=1), **train),
    )


def _with_precision(cfg, precision: str):
    """``cfg`` computing in ``precision``: train.precision, or
    model.config.dtype for the families without an encoder."""
    import dataclasses

    if cfg.model.name == "surgical_wavlm_hydra":
        return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, precision=precision))
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, config=dataclasses.replace(cfg.model.config, dtype=precision)))


def step_profile(card: str, name: str, model, x, y) -> None:
    """A bf16 train step of ``model`` on the host batch (x, y), with dropout,
    under the seeded fit's cuDNN algorithms: WARM_STEP_REPEATS synced steps
    timed after two warm-up steps, then one under torch.profiler (the 15
    longest kernels)."""
    import torch

    from segma_tpu_torch.train import deterministic_cudnn, forward_backward, make_optimizer

    optimizer = make_optimizer(model, 1e-3)
    gen = torch.Generator("cuda").manual_seed(1)
    xb, yb = x.cuda(), y.cuda()

    def step():
        forward_backward(model, optimizer, xb, yb, gen)
        optimizer.step()

    with deterministic_cudnn(True):
        for _ in range(2):
            step()
        walls = []
        for _ in range(WARM_STEP_REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        print(f"{name} train step repeated on one batch [{card}]: {WARM_STEP_REPEATS} steps, "
              f"median {1e3 * median(walls):.3f} ms (min {1e3 * min(walls):.3f}, max "
              f"{1e3 * max(walls):.3f})", flush=True)
        profile_run(card, f"{name} train step", step, median(walls))


def phase_model_families(card: str) -> dict:
    """The JAX package's four other model families on the card at their YAML
    widths, random weights from seed 0, bf16: ``surgical_wavlm_hydra`` at
    WavLM-base (hidden 768, 12 layers, 12 heads of 64, FFN 3072, 320
    buckets out to 800, the 7-conv front end) from a random snapshot in HF's
    ``WavLMModel`` layout (``write_wavlm_snapshot``), ``sincnet_hydra`` (80
    filters of 251 taps at stride 10, hidden 128, a 128 x 2 bidirectional
    LSTM), ``conv_vad`` and ``powerset_vad`` (hidden 256, depth 4; 11 subset
    classes). For each, on the training slice's data (``write_dataset``,
    batch 32 of 4 s crops):

    1. the step-1 loss (no dropout) on the card against the CPU plain path,
       at LOSS_ATOL (WavLM-base's on WAVLM_LOSS_CROPS of the batch's 32);
    2. ``Trainer.fit`` for 2 epochs (the default device cache, step
       dispatch): finite losses; powerset_vad with
       ``extra_val_metrics=[loss, partial_loss, auroc]`` and finite
       ``val/partial_*``. surgical_wavlm_hydra and powerset_vad fit again
       under ``train.dispatch=epoch``: bit-equal to step dispatch, with
       equal launch counts;
    3. the trained model rebuilt from ``last/`` by
       ``load_model_for_inference`` gives its logits bit for bit; then
       WavLM-base's train step is timed on the step-1 batch and profiled
       (``step_profile``);
    4. the predict CLI (``inference.main``, ``--save-logits``) serves the
       run's ``best.ckpt`` over a FAMILY_WAV_S WAV and the val split's
       WAVs, in bf16 and in f32 (the latter with TF32 allowed for cuDNN and
       cuBLAS, which the f32 model scopes out): the saved logits of the long
       WAV's first two chunks against the CPU (``check_logits``: bf16 to
       the f32 model and the CPU's bf16, f32 at LOGITS_F32_ATOL), and the
       log-mel kernel launched once per inner batch on the conv_vad and
       powerset_vad paths and on no other; then warm bf16 serving of the
       long WAV: two ``run_inference_on_audios`` runs of the served model,
       the second's xRT.

    Before the models, log-mel is checked and timed at VAD_TRAIN_SHAPE
    (``logmel_shape_row``). Returns the launch counts of each path and the
    log-mel row."""
    import dataclasses
    import warnings

    import torch

    from segma_tpu_torch import checkpoint, inference
    from segma_tpu_torch.data import SegmaFileDataset, SegmentationDataLoader
    from segma_tpu_torch.inference import Chunkyfier, run_inference_on_audios
    from segma_tpu_torch.geometry import ConvolutionSettings

    with torch.inference_mode():
        row = logmel_shape_row(card, "vad training", VAD_TRAIN_SHAPE,
                               torch.Generator(device="cuda").manual_seed(13))
    launches: dict[str, dict] = {}
    summary: dict[str, str] = {}
    labels = list(TRAIN_CLASSES)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        root = tmp / "data"
        write_dataset(root, TRAIN_CLASSES, (TRAIN_FILES, VAL_FILES, TEST_FILES), TRAIN_FILE_S)
        wav_dir = tmp / "serve"
        wav_dir.mkdir()
        n_samples = int(FAMILY_WAV_S * 16_000)
        pcm = write_wav(wav_dir / "family.wav", n_samples, seed=5)
        # the predict CLI serves it and the val split's WAVs
        val_uris = (root / "val.txt").read_text().split()
        cli_dir = tmp / "serve_cli"
        cli_dir.mkdir()
        for uri in val_uris:
            (cli_dir / f"{uri}.wav").symlink_to(root / "wav" / f"{uri}.wav")
        (cli_dir / "family.wav").symlink_to(wav_dir / "family.wav")
        (tmp / "serve.txt").write_text("".join(u + "\n" for u in ["family", *val_uris]))
        t0 = time.perf_counter()
        write_wavlm_snapshot(tmp / "wavlm_base", seed=13)
        print(f"families: WavLM-base snapshot written in {time.perf_counter() - t0:.3f} s",
              flush=True)
        for name in FAMILY_NAMES:
            extra = ({"extra_val_metrics": ["loss", "partial_loss", "auroc"]}
                     if name == "powerset_vad" else {})
            cfg = family_config(name, root, str(tmp / "wavlm_base"), **extra)
            ds = SegmaFileDataset.from_config(cfg)
            ds.load(use_cache=False)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                model = checkpoint.build_model(cfg, device="cuda")
                model_cpu = checkpoint.build_model(cfg, device="cpu")
            n_params = sum(p.numel() for p in model.trainable_parameters())

            # 1. the step-1 batch without dropout, card against CPU
            host = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                                      data_cache="host"))
            sampler = SegmentationDataLoader(ds, model.label_encoder, host,
                                             model.conv_settings).train_dataloader().sampler
            sampler.reseed(0)
            batch = sampler.sample_batch(cfg.train.batch_size)
            x, y = (torch.from_numpy(batch[k]) for k in ("x", "y"))
            # WavLM-base's bf16 forward of 32 crops takes about 16 s on an
            # 8-core host: its loss is compared on the batch's first 8
            n = WAVLM_LOSS_CROPS if name == "surgical_wavlm_hydra" else len(x)
            t0 = time.perf_counter()
            with torch.no_grad():
                loss_cpu = float(model_cpu.loss(model_cpu.module(x[:n]), y[:n])[0])
            cpu_s = time.perf_counter() - t0
            loss_card = float(model.loss(model.module(x[:n].cuda()), y[:n].cuda())[0].detach())
            print(f"check {name} step-1 loss, card vs CPU ({n} crops of the batch, bf16, no "
                  f"dropout): card "
                  f"{loss_card:.6f}, CPU {loss_cpu:.6f}, |diff| {abs(loss_card - loss_cpu):.3e} "
                  f"(atol {LOSS_ATOL}; CPU forward {cpu_s:.1f} s)", flush=True)
            if not abs(loss_card - loss_cpu) <= LOSS_ATOL:
                raise AssertionError(f"{name}: step-1 loss on the card differs from the CPU")
            del model_cpu

            # 2. two epochs under step dispatch, then epoch dispatch
            run_dir = tmp / f"{name}_run"
            run = _dispatch_fit(card, f"{name} step", cfg, ds, run_dir, model=model,
                                timed_epoch=1)
            history = run["history"]
            keys = ["train/loss", "val/loss"] + [k for k in history[-1]
                                                 if k.startswith("val/partial_")]
            values = [h[k] for h in history for k in keys]
            if len(history) != TRAIN_EPOCHS or not np.isfinite(values).all():
                raise AssertionError(f"{name}: {len(history)} epochs, {keys}: {values}")
            if name == "powerset_vad" and keys[2:] != ["val/partial_loss", "val/partial_auroc"]:
                raise AssertionError(f"powerset_vad validation logged {keys}")
            print(f"check {name} fit [{card}]: {TRAIN_EPOCHS} epochs of {run['n_steps']} steps, "
                  + "; ".join(f"{k} {[h[k] for h in history]}" for k in keys), flush=True)
            n_val = len(SegmentationDataLoader(ds, model.label_encoder, cfg,
                                               model.conv_settings).val_dataloader())
            want = dict.fromkeys(run["launches"], 0)
            if name in FAMILY_LOGMEL:  # every step and val batch, and no other path
                want["logmel"] = TRAIN_EPOCHS * (run["n_steps"] + n_val)
            want["lstm_fwd"] = lstm_layers(cfg) * TRAIN_EPOCHS * n_val  # validation only
            want["wavlm_attn_fwd"] = wavlm_layers(cfg) * TRAIN_EPOCHS * n_val  # validation only
            if run["launches"] != want:
                raise AssertionError(f"{name} fit: launch counts {run['launches']} != {want}")
            launches[f"{name} fit"] = run["launches"]
            if name in FAMILY_EPOCH_DISPATCH:
                ecfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                                          dispatch="epoch"))
                replay = _dispatch_fit(card, f"{name} epoch", ecfg, ds, tmp / f"{name}_epoch")
                _same_run(run, replay, f"{name}: epoch dispatch against step dispatch")
                if replay["launches"] != run["launches"]:
                    raise AssertionError(f"{name}: epoch dispatch launched {replay['launches']}, "
                                         f"step dispatch {run['launches']}")
                launches[f"{name} fit epoch"] = replay["launches"]
                del replay

            # 3. the checkpoint rebuilds the trained model
            ck = Chunkyfier(INNER_BATCH, cfg.audio.chunk_duration_f,
                            ConvolutionSettings((320,), (320,), (0,)))
            wav = torch.from_numpy(pcm[: 2 * ck.chunk_stride + ck.missing_n_frames]
                                   .astype(np.float32) / 32768.0)
            chunks = torch.stack([wav[i * ck.chunk_stride: i * ck.chunk_stride
                                      + ck.chunk_duration_f] for i in range(2)])
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                served = checkpoint.load_model_for_inference(
                    cfg, run_dir / "checkpoints" / "last", device="cuda")
            if not torch.equal(served.apply(chunks.cuda()), model.apply(chunks.cuda())):
                raise AssertionError(f"{name}: last/ serves other logits than the trained model")
            if name == "surgical_wavlm_hydra":
                step_profile(card, name, model, x, y)
            del model

            # 4. the predict CLI over the run's best.ckpt, in bf16 and in f32 (under
            # TF32 allowed for cuDNN and cuBLAS: the f32 model keeps itself out)
            best = run_dir / "checkpoints" / "best.ckpt"
            n_inner = (expected_inner_batches(cfg, n_samples) + len(val_uris)
                       * expected_inner_batches(cfg, int(TRAIN_FILE_S * 16_000)))
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                cpu_f32 = checkpoint.load_model_for_inference(_with_precision(cfg, "f32"), best,
                                                              device="cpu")
                with torch.inference_mode():
                    f32 = cpu_f32.inference_transform(cpu_f32.apply(chunks)).reshape(
                        -1, len(labels))
            cli_s: dict[str, float] = {}
            for precision in ("bf16", "f32"):
                pcfg = _with_precision(cfg, precision)
                out = tmp / f"{name}_{precision}_out"
                args = ["--config", str(write_config(tmp / f"{name}_{precision}.yml", pcfg)),
                        "--wavs", str(cli_dir), "--uris", str(tmp / "serve.txt"),
                        "--checkpoint", str(run_dir), "--output", str(out), "--batch-size",
                        str(INNER_BATCH), "--save-logits", "--device", "cuda"]
                tf32 = precision == "f32"
                flags = tf32_flags()
                torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
                torch.cuda.synchronize()
                reset_launches()
                t0 = time.perf_counter()
                try:
                    inference.main(args)
                    torch.cuda.synchronize()
                finally:
                    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
                cli_s[precision] = time.perf_counter() - t0
                got = read_launches()
                want = dict.fromkeys(got, 0)
                if name in FAMILY_LOGMEL:
                    want["logmel"] = n_inner
                want["lstm_fwd"] = lstm_layers(cfg) * n_inner
                want["wavlm_attn_fwd"] = wavlm_layers(pcfg) * n_inner
                if got != want:
                    raise AssertionError(f"{name} predict CLI {precision}: launch counts {got} "
                                         f"!= {want}")
                launches[f"{name} predict" + (" f32" if tf32 else "")] = got
                if tf32:
                    ref = f32
                else:
                    with warnings.catch_warnings():
                        warnings.simplefilter("ignore")
                        cpu = checkpoint.load_model_for_inference(cfg, best, device="cpu")
                    with torch.inference_mode():
                        ref = cpu.inference_transform(cpu.apply(chunks)).reshape(-1, len(labels))
                    del cpu
                data = np.load(out / "logits" / "family-logits_dict_t.npz")
                saved = torch.from_numpy(np.stack([data[lb] for lb in labels], 1)[: ref.shape[0]])
                check_logits(f"{name} predict CLI {precision}" + (" (TF32 allowed)" if tf32
                                                                   else ""), saved, ref, f32)
                if precision == "bf16":
                    n_rttm = [len((out / "raw_rttm" / f"{u}.rttm").read_text().splitlines())
                              for u in ["family", *val_uris]]
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                served = checkpoint.load_model_for_inference(cfg, best, device="cuda")
            walls = []
            for i in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run_inference_on_audios(cfg, wav_dir, None, tmp / f"{name}_warm{i}",
                                        model=served, device="cuda", batch_size=INNER_BATCH)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            summary[name] = (
                f"{n_params} trainable parameters; warm bf16 step {run['warm_ms']:.3f} ms "
                f"(epoch 1's train time over {run['n_steps']} steps), epoch 1's step-to-step "
                f"median {median(run['steps_ms']) if run['steps_ms'] else float('nan'):.3f} ms, "
                f"peak device memory {run['peak'] / 2**30:.2f} GiB; predict CLI bf16 "
                f"{cli_s['bf16']:.3f} s, f32 {cli_s['f32']:.3f} s (bf16 RTTM lines: the "
                f"{FAMILY_WAV_S:.0f} s WAV {n_rttm[0]}, the val WAVs {n_rttm[1:]}); warm bf16 "
                f"serving {walls[1]:.3f} s for {FAMILY_WAV_S:.0f} s of audio = "
                f"{FAMILY_WAV_S / walls[1]:.2f}x real time (first {walls[0]:.3f} s)")
            print(f"family {name} [{card}]: {summary[name]}", flush=True)
            del served, cpu_f32, run
            torch.cuda.empty_cache()
    return {"launches": launches, "logmel": row}


# -- the training entry points: repairs, the train CLIs ---------------------------------


DEVICE_CACHE_EPOCHS = 2
# the timed runs' data: 16 train files of 2048 s, 1.05 GB of 16 kHz PCM16 (an
# int16 device cache of that size), 1 val file, 1 test file; the virtual
# epoch cut by data.dataset_multiplier to DEVICE_CACHE_STEPS steps of 32
DEVICE_CACHE_FILES = (16, 1, 1)
DEVICE_CACHE_FILE_S = 2048.0
DEVICE_CACHE_STEPS = 20


def _dispatch_fit(card: str, label: str, cfg, ds, run_dir: Path, model=None,
                  timed_epoch: int | None = None, profile_epoch: int | None = None) -> dict:
    """One seeded ``Trainer.fit`` of ``cfg`` (the model from
    ``checkpoint.build_model`` unless given) from zeroed launch counters and
    peak memory statistics. With ``timed_epoch``, a CUDA event after each
    step of that epoch: the gaps between them are the steps' times on the
    device's clock, the idle time the host leaves included. With
    ``profile_epoch``, that epoch's training under torch.profiler: its
    device time and its wall, synced, under the profiler. Returns the result,
    the history, the launch counts, the peak memory, the warm step (the
    second epoch's train time over its steps; the first's in a one-epoch
    run), the timed steps, the profiled epoch's device time and wall, the
    logged records (rank 0's: none on the other ranks of a world), and
    copies of the trainable parameters (a mesh member's blocks) and AdamW
    state, the names of the sharded ones and the member's coordinate."""
    import gc
    import json

    import torch
    from torch.profiler import ProfilerActivity, profile

    from segma_tpu_torch import checkpoint
    from segma_tpu_torch.data import SegmentationDataLoader
    from segma_tpu_torch.train import EpochReplay, Trainer

    if model is None:
        model = checkpoint.build_model(cfg, device="cuda")
    dm = SegmentationDataLoader(ds, model.label_encoder, cfg, model.conv_settings)
    trainer = Trainer(model=model, config=cfg, run_dir=run_dir)
    method = "_train_epoch_replay" if cfg.train.dispatch == "epoch" else "_train_epoch"
    real = getattr(trainer, method)
    prof_out: dict[str, float] = {}
    calls: list[int] = []
    ends: list = []  # an event after each step of the timed epoch
    timing = [False]

    def epoch(*args):
        calls.append(1)
        n = len(calls) - 1
        if n == timed_epoch:
            timing[0] = True
            try:
                return real(*args)
            finally:
                timing[0] = False
        if n != profile_epoch:
            return real(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = real(*args)
            torch.cuda.synchronize()
        prof_out["wall_ms"] = 1e3 * (time.perf_counter() - t0)
        prof_out["busy_ms"] = sum(e.self_device_time_total for e in prof.key_averages()
                                  if e.device_type.name == "CUDA") / 1e3
        return out

    def mark():
        if timing[0]:
            ends.append(torch.cuda.Event(enable_timing=True))
            ends[-1].record()

    setattr(trainer, method, epoch)
    replay_run = EpochReplay.run
    if cfg.train.dispatch == "epoch":
        def run(self, emit):
            out = replay_run(self, emit)
            mark()
            return out

        EpochReplay.run = run
    else:
        step = trainer.train_step

        def timed_step(batch, generator):
            out = step(batch, generator)
            mark()
            return out

        trainer.train_step = timed_step
    # an earlier run's trainer, in a cycle through its wrapped epoch method,
    # is freed first: each run's peak memory is its own
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    try:
        result = trainer.fit(dm)
    finally:
        EpochReplay.run = replay_run
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    history = result["history"]
    n_steps = trainer.global_step // len(history)
    # rank 0 alone writes metrics.jsonl under a world
    records = ([json.loads(ln) for ln in (run_dir / "metrics.jsonl").read_text().splitlines()]
               if trainer.is_main else [])
    # a mesh member trains its member copy: its blocks of the parameters
    params = dict(trainer.model.module.named_parameters())
    steps_ms = [a.elapsed_time(b) for a, b in zip(ends, ends[1:])]
    out = {
        "history": history, "launches": launches, "peak": torch.cuda.max_memory_allocated(),
        "records": records, "wall": wall, "n_steps": n_steps,
        "warm_ms": 1e3 * history[min(1, len(history) - 1)]["train_time_s"] / n_steps,
        "steps_ms": steps_ms, **prof_out,
        # copies on the host: the next run's peak memory is its own
        "params": {n: p.detach().cpu() for n, p in params.items() if p.requires_grad},
        "adam": {n: {k: v.detach().cpu() for k, v in trainer.optimizer.state[p].items()}
                 for n, p in params.items() if p.requires_grad},
        "graphs": sorted(trainer.replay.graphs) if trainer.replay is not None else [],
        "sharded": sorted(trainer.blocks.dims),
        "coordinate": list(trainer.mesh.coordinate) if trainer.mesh is not None else None,
    }
    mb = [r["device_cache_mb"] for r in records if "device_cache_mb" in r]
    notes = {k: r[k] for r in records for k in ("data_cache_train", "data_cache_val") if k in r}
    timed = ""
    if steps_ms:
        q = np.percentile(steps_ms, [0, 10, 50, 90, 100])
        timed = (f", epoch {timed_epoch}'s {len(steps_ms)} step-to-step gaps (CUDA events) "
                 f"median {q[2]:.3f} ms (p10 {q[1]:.3f}, p90 {q[3]:.3f}, min {q[0]:.3f}, "
                 f"max {q[4]:.3f})")
    busy = ""
    if prof_out:
        busy = (f", epoch {profile_epoch} under torch.profiler: device busy "
                f"{prof_out['busy_ms']:.1f} ms of its wall {prof_out['wall_ms']:.1f} ms = "
                f"{100 * prof_out['busy_ms'] / prof_out['wall_ms']:.1f}% ("
                f"{prof_out['busy_ms'] / n_steps:.3f} ms device and "
                f"{prof_out['wall_ms'] / n_steps:.3f} ms wall per step)")
    step = "warm step" if len(history) > 1 else "step of the first epoch (capture included)"
    last = history[min(1, len(history) - 1)]
    val_ms = 1e3 * (last["time_s"] - last["train_time_s"])
    print(f"device cache {label} [{card}]: {len(history)} epochs of {n_steps} steps, fit wall "
          f"{wall:.3f} s, {step} {out['warm_ms']:.3f} ms (epoch train time over steps)"
          f"{timed}{busy}, validation {val_ms:.1f} ms, peak device memory "
          f"{out['peak']} B ({out['peak'] / 2**30:.2f} GiB), device_cache_mb "
          f"{mb[0] if mb else None}, data_cache notes {notes or None}, replayed graphs "
          f"{out['graphs']}, launches {launches}", flush=True)
    return out


def _launched(counts: dict, kernels: tuple[str, ...], what: str) -> None:
    """Raise unless each of ``kernels`` was launched in the run."""
    missing = [k for k in kernels if not counts[k]]
    if missing:
        raise AssertionError(f"{what}: {missing} never launched ({counts})")


def _same_run(a: dict, b: dict, what: str) -> int:
    """Raise unless two fits end bit-equal: every epoch's losses and metrics,
    every step's logged loss, the trainable parameters and AdamW's state.
    Returns the number of tensors compared."""
    import torch

    keys = ("train/loss", "val/loss", "val/f1_score", "lr")
    for ha, hb in zip(a["history"], b["history"], strict=True):
        for k in keys:
            if k in ha and ha[k] != hb.get(k):
                raise AssertionError(f"{what}: epoch {ha['epoch']} {k} {ha[k]!r} != {hb.get(k)!r}")
    steps = [[(r["step"], r["train/loss_step"]) for r in x["records"] if "train/loss_step" in r]
             for x in (a, b)]
    if steps[0] != steps[1]:
        raise AssertionError(f"{what}: the per-step losses differ")
    n = 0
    for name, p in a["params"].items():
        if not torch.equal(p, b["params"][name]):
            diff = float((p.double() - b["params"][name].double()).abs().max())
            raise AssertionError(f"{what}: parameter {name} differs by {diff:.3e}")
        for k, v in a["adam"][name].items():
            if not torch.equal(v, b["adam"][name][k]):
                raise AssertionError(f"{what}: AdamW {k} of {name} differs")
            n += 1
        n += 1
    print(f"check {what}: bit-equal ({len(a['history'])} epochs, {len(steps[0])} step losses, "
          f"{n} parameter and AdamW tensors)", flush=True)
    return n


def phase_device_cache(card: str) -> dict:
    """The device audio cache and epoch dispatch on the card: the training
    slice's config (full HuBERT-base, bf16, batch 32, seed 0, dropout on)
    over ``write_dataset``'s data at a deployment's size (DEVICE_CACHE_FILES
    of DEVICE_CACHE_FILE_S: a 1.05 GB int16 train cache), the virtual epoch
    cut to DEVICE_CACHE_STEPS steps, for DEVICE_CACHE_EPOCHS epochs, three
    times:

    1. ``data_cache=host``, ``dispatch=step``;
    2. ``data_cache=auto`` (the default, which resolves to the device cache
       and logs its note), ``dispatch=step``;
    3. ``data_cache=device``, ``dispatch=epoch``: the step captured as a
       CUDA graph after one eager step, replayed for every other step.

    Run 2 must be bit-equal to run 1, and run 3 to run 2 (losses, step
    losses, parameters, AdamW's state), run 3's launch counts must be run
    2's (a replay counts its captured launches), and run 2 must log its
    resolution note. Printed for each: the warm step, the median and spread
    of the second epoch's steps (CUDA events), the peak device memory,
    ``device_cache_mb``. Then,
    over the training slice's small data, step against epoch dispatch,
    bit-equal each: k=3 accumulation over two epochs (so that both graphs,
    fold-in and update, replay), f32 (``train.precision=f32``: both f32
    flash kernels under replay) one epoch, and whisperimax in bf16 over a
    random Whisper-base snapshot (log-mel, the bf16 forward and the cuDNN
    LSTM under replay) one epoch. Returns the launch counts of run 3 and of
    each epoch-dispatch path."""
    import dataclasses
    import math
    import shutil
    import warnings

    import torch

    from segma_tpu_torch.config import DataloaderConfig
    from segma_tpu_torch.data import SegmaFileDataset

    def train(cfg, **fields):
        return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **fields))

    paths: dict[str, dict] = {}
    with tempfile.TemporaryDirectory() as tmp, warnings.catch_warnings():
        warnings.simplefilter("ignore")  # random encoder weights, on purpose
        tmp = Path(tmp)
        big = tmp / "big"
        t0 = time.perf_counter()
        write_dataset(big, TRAIN_CLASSES, DEVICE_CACHE_FILES, DEVICE_CACHE_FILE_S)
        write_s = time.perf_counter() - t0
        chunks = math.ceil(DEVICE_CACHE_FILES[0] * DEVICE_CACHE_FILE_S / 4.0)
        timed = surgical_hubert_hydra_config(big)
        timed = dataclasses.replace(timed, data=dataclasses.replace(
            timed.data, dataset_multiplier=DEVICE_CACHE_STEPS * timed.train.batch_size / chunks))
        timed = train(timed, max_epochs=DEVICE_CACHE_EPOCHS, log_every_n_steps=1)
        big_ds = SegmaFileDataset.from_config(timed)
        big_ds.load(use_cache=False)
        print(f"device cache data [{card}]: {DEVICE_CACHE_FILES} files of "
              f"{DEVICE_CACHE_FILE_S} s written in {write_s:.1f} s; "
              f"data.dataset_multiplier {timed.data.dataset_multiplier}", flush=True)
        runs = {}
        for label, fields in (("host step", dict(data_cache="host")),
                              ("auto step", dict(data_cache="auto")),
                              ("device epoch", dict(data_cache="device", dispatch="epoch"))):
            runs[label] = _dispatch_fit(card, label, train(timed, **fields), big_ds, tmp / label,
                                        timed_epoch=1)
        if runs["auto step"]["n_steps"] != DEVICE_CACHE_STEPS:
            raise AssertionError(f"{runs['auto step']['n_steps']} steps per epoch, not "
                                 f"{DEVICE_CACHE_STEPS}")
        _same_run(runs["host step"], runs["auto step"], "device cache (auto) against host, step")
        _same_run(runs["auto step"], runs["device epoch"],
                  "epoch dispatch (CUDA graph replays) against step dispatch, device cache")
        note = [r["data_cache_train"] for r in runs["auto step"]["records"]
                if "data_cache_train" in r]
        if not (note and note[0].startswith("auto -> device")):
            raise AssertionError(f"data_cache=auto logged {note}")
        if runs["device epoch"]["launches"] != runs["auto step"]["launches"]:
            raise AssertionError(f"launches under epoch dispatch {runs['device epoch']['launches']}"
                                 f" != step dispatch's {runs['auto step']['launches']}")
        if runs["device epoch"]["graphs"] != [True]:
            raise AssertionError(f"epoch dispatch replayed {runs['device epoch']['graphs']}")
        _launched(runs["device epoch"]["launches"], ("flash_attn_fwd", "flash_attn_bwd"),
                  "epoch dispatch")
        print(f"check epoch dispatch launch counts equal step dispatch's, replays counted: "
              f"{runs['device epoch']['launches']}", flush=True)
        paths["device_cache epoch"] = runs["device epoch"]["launches"]
        del runs
        torch.cuda.empty_cache()
        shutil.rmtree(big)
        root = tmp / "data"
        write_dataset(root, TRAIN_CLASSES, (TRAIN_FILES, VAL_FILES, TEST_FILES), TRAIN_FILE_S)
        base = train(surgical_hubert_hydra_config(root), log_every_n_steps=1)
        ds = SegmaFileDataset.from_config(base)
        ds.load(use_cache=False)

        # accumulation across the epoch boundary: both graphs replay in epoch 1
        accum = {d: _dispatch_fit(card, f"k=3 {d}", train(base, data_cache="device", dispatch=d,
                                                           grad_accum_steps=3, max_epochs=2),
                                  ds, tmp / f"accum_{d}") for d in ("step", "epoch")}
        _same_run(accum["step"], accum["epoch"], "k=3 accumulation, epoch against step dispatch")
        if accum["epoch"]["launches"] != accum["step"]["launches"]:
            raise AssertionError("k=3: launch counts differ between the dispatches")
        if accum["epoch"]["graphs"] != [False, True]:
            raise AssertionError(f"k=3 epoch dispatch replayed {accum['epoch']['graphs']}")
        _launched(accum["epoch"]["launches"], ("flash_attn_fwd", "flash_attn_bwd"), "k=3 epoch")
        paths["device_cache epoch k=3"] = accum["epoch"]["launches"]
        del accum
        # f32: both f32 flash kernels under replay
        f32 = {d: _dispatch_fit(card, f"f32 {d}", train(base, data_cache="device", dispatch=d,
                                                         precision="f32", max_epochs=1),
                                ds, tmp / f"f32_{d}") for d in ("step", "epoch")}
        _same_run(f32["step"], f32["epoch"], "f32, epoch against step dispatch")
        if f32["epoch"]["launches"] != f32["step"]["launches"]:
            raise AssertionError("f32: launch counts differ between the dispatches")
        _launched(f32["epoch"]["launches"], ("flash_attn_fwd_f32", "flash_attn_bwd_f32"),
                  "f32 epoch")
        paths["device_cache epoch f32"] = f32["epoch"]["launches"]
        del f32
        torch.cuda.empty_cache()
        # whisperimax over a Whisper-base snapshot: log-mel under replay
        write_whisper_snapshot(tmp / "whisper_base", seed=11)
        wcfg = whisper_variant_config("whisperimax", str(tmp / "whisper_base"), str(root),
                                      lr=1e-3, batch_size=32, max_epochs=1, seed=0,
                                      log_every_n_steps=1, data_cache="device",
                                      dataloader=DataloaderConfig(num_workers=1))
        imax = {d: _dispatch_fit(card, f"whisperimax {d}", train(wcfg, dispatch=d), ds,
                                 tmp / f"imax_{d}") for d in ("step", "epoch")}
        _same_run(imax["step"], imax["epoch"], "whisperimax bf16, epoch against step dispatch")
        _launched(imax["epoch"]["launches"], ("logmel", "flash_attn_fwd"), "whisperimax epoch")
        if imax["epoch"]["launches"] != imax["step"]["launches"]:
            raise AssertionError(f"whisperimax launches {imax['epoch']['launches']} != "
                                 f"{imax['step']['launches']}")
        paths["device_cache epoch whisperimax"] = imax["epoch"]["launches"]
    return paths


TRAIN_CLI_EPOCHS = 4
# HuBERT-base's widths at 4 of its 12 layers (a snapshot the phase writes):
# the phase checks the CLIs' mechanics, which do not depend on depth, and
# its children's time is mostly checkpoint I/O, which scales with it
TRAIN_CLI_LAYERS = 4
TRAIN_CLI_ACCUM = 3  # 4 micro-steps per epoch: the accumulation crosses epoch boundaries
CHILD_WALL_S = 600  # a child run's wall, after which it is killed (SIGTERM is caught)
# `python -m <module> <args>` with the launch counts written to a file at exit
LAUNCH_REPORTING_CHILD = (
    "import atexit, json, pathlib, runpy, sys\n"
    "import chip_smoke\n"
    "report, module = sys.argv[1], sys.argv[2]\n"
    "atexit.register(lambda: pathlib.Path(report).write_text("
    "json.dumps(chip_smoke.read_launches())))\n"
    "sys.argv = [module, *sys.argv[3:]]\n"
    "runpy.run_module(module, run_name='__main__', alter_sys=True)\n"
)


def train_cli_config(dataset_path: Path, wav_encoder: str = "hubert_base"):
    """The training slice's HuBERT-base config (``surgical_hubert_hydra_config``)
    over the encoder ``wav_encoder`` with every switch of the train CLIs on:
    the cosine schedule (warmup 2, floor 0.1), k=3 accumulation, int16
    transport, remat, AUROC monitored (loss, f1_score and auroc computed),
    validation every 2 epochs, 4 epochs, seed 0, the profiler."""
    import dataclasses

    from segma_tpu_torch.config import SchedulerConfig

    cfg = surgical_hubert_hydra_config(dataset_path)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, config=dataclasses.replace(
        cfg.model.config, wav_encoder=wav_encoder)))
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, max_epochs=TRAIN_CLI_EPOCHS, grad_accum_steps=TRAIN_CLI_ACCUM,
        transport="int16", remat=True, validation_metric="auroc",
        extra_val_metrics=["loss", "f1_score", "auroc"], val_every_n_epochs=2,
        profiler="simple",
        scheduler=SchedulerConfig(type="cosine", warmup_steps=2, min_lr_ratio=0.1)))


def _child(args: list[str], cwd: Path, log: Path,
           extra_env: dict | None = None) -> "subprocess.Popen":
    import os

    repo = Path(__file__).resolve().parent
    env = {**os.environ, **(extra_env or {}), "PYTHONPATH": os.pathsep.join(
        [str(repo), *filter(None, [os.environ.get("PYTHONPATH")])])}
    cwd.mkdir(parents=True, exist_ok=True)
    with log.open("w") as out:
        return subprocess.Popen([sys.executable, *args], cwd=cwd, env=env, stdout=out,
                                stderr=subprocess.STDOUT)


def _wait(proc, log: Path, label: str, want: int) -> float:
    """Wait for a child at most CHILD_WALL_S, then KILL it; its exit code
    must be ``want``. Returns its wall."""
    t0 = time.perf_counter()
    try:
        rc = proc.wait(timeout=CHILD_WALL_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError(f"{label}: killed after {CHILD_WALL_S} s:\n"
                             + log.read_text()[-3000:]) from None
    if rc != want:
        raise AssertionError(f"{label}: exit {rc}, not {want}:\n" + log.read_text()[-3000:])
    return time.perf_counter() - t0


def _records(metrics: Path) -> list[dict]:
    return [json.loads(ln) for ln in metrics.read_text().splitlines() if ln.strip()]


def _epochs(records: list[dict]) -> list[dict]:
    return [r for r in records if "train/loss" in r]


def _same_tree(a: dict, b: dict, where: str) -> int:
    """Leaves of two msgpack trees equal bit for bit; returns their count."""
    if set(a) != set(b):
        raise AssertionError(f"{where}: keys {sorted(a)} != {sorted(b)}")
    n = 0
    for k in a:
        if isinstance(a[k], dict):
            n += _same_tree(a[k], b[k], f"{where}/{k}")
        elif not np.array_equal(np.asarray(a[k]), np.asarray(b[k])):
            raise AssertionError(f"{where}/{k} differs")
        else:
            n += 1
    return n


def phase_train_cli(card: str) -> dict:
    """The train CLIs on the card, HuBERT-base's widths in bf16 at
    TRAIN_CLI_LAYERS layers (from a random snapshot) with every switch on
    (``train_cli_config``), on ``write_dataset``'s data (4 micro-steps per
    epoch):

    1. ``python -m segma_tpu_torch.cli.train`` in a child process (run as
       ``__main__`` by ``LAUNCH_REPORTING_CHILD``, which writes its launch
       counts at exit): exit 0, ``models/last/best.ckpt`` under its working
       directory, the profile of epoch 1, no validation at epochs 0 and 2;
    2. ``python -m segma_tpu_torch.cli.auto_train --run-id R --output O``,
       SIGTERM sent by PID once epoch 1's line is in metrics.jsonl: exit 75,
       ``last/`` at epoch 1 with ``mini_step`` 2, the stop logged inside
       epoch 2;
    3. the same command with ``--auto-resume``: exit 0, and the final
       trainable parameters and optimizer state (``last/``) bit-equal to
       run 1's, with the same LR and val/auroc at every epoch;
       no cuDNN flag is set by this script for any of them (each child
       starts with PyTorch's defaults);
    4. in this process, one epoch each with remat and int16 transport,
       without remat, and with f32 transport: the trainable parameters of
       each pair bit-equal; peak device memory, the warm step and the flash
       forward's launches per step of remat on and off.

    Children are killed after CHILD_WALL_S (a caught SIGTERM does not end
    them). Returns run 1's launch counts."""
    import dataclasses
    import signal
    import warnings

    import torch

    from segma_tpu_torch import checkpoint
    from segma_tpu_torch.data import SegmaFileDataset, SegmentationDataLoader
    from segma_tpu_torch.train import Trainer, deterministic_cudnn

    walls: dict[str, float] = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        root = tmp / "data"
        write_dataset(root, TRAIN_CLASSES, (TRAIN_FILES, VAL_FILES, TEST_FILES), TRAIN_FILE_S)
        n_layers = TRAIN_CLI_LAYERS
        write_hubert_snapshot(tmp / "hubert_cli", seed=14,
                              dims=dict(HUBERT_BASE, num_hidden_layers=n_layers))
        cfg = train_cli_config(root, str(tmp / "hubert_cli"))
        config_path = write_config(tmp / "train_cli.yml", cfg)

        # 1. the uninterrupted run
        report = tmp / "launches.json"
        log1 = tmp / "run1.log"
        proc = _child(["-c", LAUNCH_REPORTING_CHILD, str(report), "segma_tpu_torch.cli.train",
                       "-c", str(config_path), f"model.chkp_path={tmp / 'runs1'}"],
                      tmp / "cwd1", log1)
        try:
            walls["cli.train, 4 epochs"] = _wait(proc, log1, "cli.train", 0)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        (run1,) = (tmp / "runs1").iterdir()
        launches = json.loads(report.read_text())
        link = tmp / "cwd1" / "models" / "last" / "best.ckpt"
        if not link.is_symlink() or not link.resolve().is_relative_to(run1.resolve()):
            raise AssertionError(f"cli.train: models/last/best.ckpt {link} is not a link into "
                                 f"{run1}")
        rec1 = _records(run1 / "metrics.jsonl")
        ep1 = _epochs(rec1)
        if [r["epoch"] for r in ep1] != list(range(TRAIN_CLI_EPOCHS)) or [
                "val/auroc" in r for r in ep1] != [False, True, False, True]:
            raise AssertionError(f"cli.train epochs: {[(r['epoch'], sorted(r)) for r in ep1]}")
        if not (run1 / "profile" / "epoch_1.json").exists() or not any(
                "profile_dir" in r for r in rec1):
            raise AssertionError("cli.train: no profile of epoch 1")
        n_steps = 4
        want = {"logmel": 0, "flash_attn_fwd": n_layers * TRAIN_CLI_EPOCHS * 2 * n_steps
                + n_layers * 2 * 2, "flash_attn_bwd": n_layers * TRAIN_CLI_EPOCHS * n_steps,
                "flash_attn_fwd_f32": 0, "flash_attn_bwd_f32": 0, "lstm_fwd": 0,
                "wavlm_attn_fwd": 0}
        if launches != want:
            raise AssertionError(f"cli.train launch counts {launches} != {want} (remat: two "
                                 "forward launches per layer and step)")
        print(f"check cli.train [{card}]: exit 0, {TRAIN_CLI_EPOCHS} epochs, val/auroc at "
              f"epochs 1 and 3 {[r['val/auroc'] for r in ep1 if 'val/auroc' in r]}, lr "
              f"{[r['lr'] for r in ep1]}, best.ckpt linked, epoch 1 profiled; launches "
              f"{launches}", flush=True)

        # 2. preempted by SIGTERM inside epoch 2
        out = tmp / "runs2"
        auto = ["-m", "segma_tpu_torch.cli.auto_train", "-c", str(config_path), "--run-id", "R",
                "--output", str(out)]
        metrics = out / "R" / "metrics.jsonl"
        log2 = tmp / "run2.log"
        t0 = time.perf_counter()
        proc = _child(auto, tmp / "cwd2", log2)
        try:
            while not (metrics.exists() and any(r.get("epoch") == 1 and "train/loss" in r
                                                 for r in _records(metrics))):
                if proc.poll() is not None or time.perf_counter() - t0 > CHILD_WALL_S:
                    raise AssertionError("cli.auto_train ended or stalled before epoch 1:\n"
                                         + log2.read_text()[-3000:])
                time.sleep(0.02)
            proc.send_signal(signal.SIGTERM)
            walls["cli.auto_train to SIGTERM and exit"] = _wait(proc, log2, "preempted run", 75)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        last = out / "R" / "checkpoints" / "last"
        tree = checkpoint.msgpack_restore((last / "opt_state.msgpack").read_bytes())
        stopped = [r for r in _records(metrics) if "preempted_at_epoch" in r]
        if (checkpoint.load_meta(last).get("epoch") != 1 or int(tree["mini_step"]) == 0
                or [(r["preempted_at_epoch"], r["epoch_completed"]) for r in stopped]
                != [(2, False)]):
            raise AssertionError(f"preempted run: last/ epoch {checkpoint.load_meta(last)}, "
                                 f"mini_step {int(tree['mini_step'])}, stop {stopped}")
        print(f"check cli.auto_train SIGTERM [{card}]: exit 75 inside epoch 2, last/ at epoch 1 "
              f"with mini_step {int(tree['mini_step'])} of {TRAIN_CLI_ACCUM}", flush=True)

        # 3. --auto-resume
        log3 = tmp / "run3.log"
        proc = _child([*auto, "--auto-resume"], tmp / "cwd3", log3)
        try:
            walls["cli.auto_train --auto-resume"] = _wait(proc, log3, "resumed run", 0)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if "auto-resume from" not in log3.read_text():
            raise AssertionError("the resumed run did not resume:\n" + log3.read_text()[-3000:])
        n_leaves = 0
        for name in ("params.msgpack", "opt_state.msgpack"):
            n_leaves += _same_tree(
                checkpoint.msgpack_restore((run1 / "checkpoints" / "last" / name).read_bytes()),
                checkpoint.msgpack_restore((last / name).read_bytes()), name)
        ep23 = _epochs(_records(metrics))
        for key in ("lr", "val/auroc", "train/loss"):
            a = [r.get(key) for r in ep1]
            b = [r.get(key) for r in ep23]
            if a != b:
                raise AssertionError(f"{key} per epoch: uninterrupted {a}, preempted and "
                                     f"resumed {b}")
        if not (tmp / "cwd3" / "models" / "last" / "best.ckpt").is_symlink():
            raise AssertionError("the resumed run linked no best.ckpt")
        print(f"check preempt and --auto-resume [{card}]: exit 0, final trainable parameters "
              f"and optimizer state bit-equal to the uninterrupted run's ({n_leaves} leaves), "
              f"the same lr, train/loss and val/auroc at every epoch", flush=True)

        # 4. remat and int16 transport, in this process, one epoch each
        ds = SegmaFileDataset.from_config(cfg)
        ds.load(use_cache=False)
        one = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, profiler=None,
                                                                 max_epochs=1))
        runs = {}
        for label, fields in (("remat, int16", {}), ("no remat, int16", {"remat": False}),
                              ("remat, f32", {"transport": "f32"})):
            rcfg = dataclasses.replace(one, train=dataclasses.replace(one.train, **fields))
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # random encoder weights, on purpose
                model = checkpoint.build_model(rcfg, device="cuda")
            dm = SegmentationDataLoader(ds, model.label_encoder, rcfg, model.conv_settings)
            trainer = Trainer(model=model, config=rcfg, run_dir=tmp / label.replace(", ", "_"))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t0 = time.perf_counter()
            history = trainer.fit(dm)["history"]
            torch.cuda.synchronize()
            got = read_launches()
            peak = torch.cuda.max_memory_allocated()
            walls[f"fit 1 epoch, {label}"] = time.perf_counter() - t0
            state = _trainable_state(model)
            loader = dm.train_dataloader()
            loader.set_epoch(0)
            batch = trainer._put(next(iter(loader)))
            gen = torch.Generator("cuda").manual_seed(1)
            step_ms = []
            with deterministic_cudnn(True):  # as inside the seeded fit
                for _ in range(4 * TRAIN_CLI_ACCUM):  # four updates' worth of micro-steps
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    trainer.train_step(batch, gen)
                    torch.cuda.synchronize()
                    step_ms.append(1e3 * (time.perf_counter() - t0))
            n_val = len(dm.val_dataloader())
            per_step = (got["flash_attn_fwd"] - n_layers * n_val) / len(loader)
            runs[label] = (state, history[0], got, per_step)
            print(f"train_cli {label} [{card}]: 1 epoch of {len(loader)} micro-steps, peak "
                  f"device memory {peak} B ({peak / 2**30:.2f} GiB), warm micro-step median "
                  f"{median(step_ms):.3f} ms (min {min(step_ms):.3f}, max {max(step_ms):.3f}, "
                  f"{len(step_ms)} steps, 4 of them AdamW updates), flash forward launches "
                  f"per micro-step {per_step:g}, launches {got}", flush=True)
            del model, trainer
            torch.cuda.empty_cache()
        if [runs[k][3] for k in runs] != [2 * n_layers, n_layers, 2 * n_layers]:
            raise AssertionError(f"flash forward launches per step: "
                                 f"{ {k: v[3] for k, v in runs.items()} }")
        for a, b in (("remat, int16", "no remat, int16"), ("remat, int16", "remat, f32")):
            d = _max_dist(runs[a][0], runs[b][0])
            if d != 0.0 or runs[a][1]["val/loss"] != runs[b][1]["val/loss"]:
                raise AssertionError(f"{a} against {b}: trainable parameters {d:.3e} apart")
            print(f"check {a} against {b}: trainable parameters and val/loss bit-equal",
                  flush=True)
    print(f"train_cli walls [{card}]: " + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items()),
          flush=True)
    return launches


SERVE_FILES = 32  # synthetic int16 WAVs served by the predict path
SERVE_FILE_S = 20.0
SERVE_PACK = 8  # files per dispatch: 8 files of 8 chunks fill one inner batch of 64
SERVE_REQUESTS = 16  # one-shot requests, from SERVE_CLIENTS client threads
SERVE_CLIENTS = 4
SERVE_STREAMS = 4  # concurrent HTTP streaming sessions, and one WebSocket session
SERVE_PUSH_S = 0.5
SERVE_WINDOW_MS = 5.0
ADPCM_SIGNAL_S = 600.0
SERVE_LAUNCH_KEYS = ("logmel", "flash_attn_fwd", "lstm_fwd")  # the serving path's kernels (bf16)


def _p50_p90(xs: list[float]) -> str:
    return f"p50 {np.percentile(xs, 50) * 1e3:.1f} ms, p90 {np.percentile(xs, 90) * 1e3:.1f} ms"


def _serve_launches(counts: dict, what: str) -> dict:
    """The serving path's counts; each of its kernels must have launched."""
    counts = {k: counts[k] for k in SERVE_LAUNCH_KEYS}
    if not all(counts.values()):
        raise AssertionError(f"{what}: a serving kernel never launched: {counts}")
    return counts


def device_busy(card: str, label: str, fn, wall_s: float) -> float:
    """One more run of ``fn`` under torch.profiler: the device's busy time
    as a share of ``wall_s``, the same run's wall without the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type.name == "CUDA")
    share = busy_us / (wall_s * 1e6)
    print(f"serve {label} [{card}]: device busy {busy_us / 1e3:.1f} ms = {100 * share:.1f}% of "
          f"the unprofiled wall {wall_s * 1e3:.1f} ms", flush=True)
    return share


def _frames_of(intervals, labels: list[str], n: int) -> np.ndarray:
    """(n, labels) bool of client intervals (seconds) on the 20 ms grid."""
    out = np.zeros((n, len(labels)), bool)
    for iv in intervals:
        out[round(iv.start_s * 50) : round(iv.end_s * 50), labels.index(iv.label)] = True
    return out


def _rttm_mask(path: Path, labels: list[str], n: int) -> np.ndarray:
    """(n, labels) bool of an RTTM's segments on the 20 ms grid."""
    out = np.zeros((n, len(labels)), bool)
    for line in path.read_text().splitlines():
        f = line.split()
        start, dur = float(f[3]), float(f[4])
        out[round(start * 50) : round((start + dur) * 50), labels.index(f[7])] = True
    return out


def _near_threshold_check(what: str, streamed: np.ndarray, logits: np.ndarray,
                          atol: float = LOGITS_ATOL) -> int:
    """Streamed frames against the offline mask (sigmoid(logits) > 0.5): a
    frame may differ only where the offline logit lies within ``atol`` (the
    bf16 card tolerance LOGITS_ATOL by default) of the threshold's logit 0.
    Returns the count of frames that differ."""
    import torch

    offline = (torch.sigmoid(torch.from_numpy(logits)) > 0.5).numpy()
    if streamed.shape != offline.shape:
        raise AssertionError(f"{what}: {streamed.shape} frames, offline {offline.shape}")
    diff = streamed != offline
    far = diff & (np.abs(logits) > atol)
    if far.any():
        raise AssertionError(f"{what}: {int(far.sum())} frames differ from offline away from "
                             f"the threshold (of {int(diff.sum())} differing; the farthest at "
                             f"|logit| {float(np.abs(logits[diff]).max()):.3e})")
    return int(diff.sum())


def phase_serve(card: str, device: str = "cuda") -> dict:
    """The host data path and live serving of full-width Whisper-base
    ``surgical_hydra`` (bf16, random weights of train.seed 0), under
    PyTorch's default TF32 flags:

    - the ADPCM decode on the card bit-equal to ``adpcm_decode_np`` on a
      600 s signal, timed;
    - ``run_inference_on_audios`` over SERVE_FILES 20 s WAVs with
      pack_files 1, SERVE_PACK, and SERVE_PACK under ADPCM: warm xRT,
      device-busy share and bytes copied to the device of each; the int16
      RTTMs identical between pack sizes; ADPCM's frame agreement with
      int16; packed logits against single-file logits;
    - the predict CLI with ``--transport adpcm --pack-files 8``;
    - the server in this process on 127.0.0.1 (``SegmaClient``): /healthz,
      a WAV and an L16 /segment equal to run_inference_on_audios's
      intervals; SERVE_REQUESTS requests from SERVE_CLIENTS threads at
      batch windows 0 and SERVE_WINDOW_MS (fewer dispatches than requests
      at the latter); SERVE_STREAMS HTTP streaming sessions and one
      WebSocket session at once under the ChunkForwardBatcher, each held
      to offline by the near-threshold rule, in fewer batched forwards than
      chunks; a SIGTERM with a request in flight drains the server; the TF32
      flags as before the phase;
    - ``python -m segma_tpu_torch.cli.serve`` in a child: /healthz, one
      request, a SIGTERM drain to exit 0.

    Returns each path's launch counts of the serving kernels. ``device``
    "cpu" runs the same steps on the plain path, untimed, to try the phase
    out without a card."""
    import os
    import signal
    import threading
    import urllib.request

    import torch

    from segma_tpu_torch import checkpoint, inference, telemetry
    from segma_tpu_torch.client import SegmaClient
    from segma_tpu_torch.ops import adpcm
    from segma_tpu_torch.serve import SegmentationService, _serve_until_signalled, make_server

    flags = tf32_flags()
    paths: dict[str, dict] = {}
    on_gpu = device == "cuda"

    def sync() -> None:
        if on_gpu:
            torch.cuda.synchronize()

    # ADPCM decode on the card, 600 s
    n = int(ADPCM_SIGNAL_S * 16_000)
    with tempfile.TemporaryDirectory() as tmp:
        pcm = write_wav(Path(tmp) / "long.wav", n, seed=7)
    t0 = time.perf_counter()
    data = adpcm.adpcm_encode(pcm)
    encode_s = time.perf_counter() - t0
    on_card = torch.from_numpy(data).to(device)
    got = adpcm.adpcm_decode(on_card, n)
    if not np.array_equal(got.cpu().numpy(), adpcm.adpcm_decode_np(data, n)):
        raise AssertionError("the ADPCM decode on the card differs from adpcm_decode_np")
    ms = time_ms(lambda: adpcm.adpcm_decode(on_card, n), iters=10) if on_gpu else 0.0
    print(f"serve adpcm [{card}]: decode of {ADPCM_SIGNAL_S:.0f} s ({data.nbytes} B, "
          f"{data.nbytes / n:.4f} B/sample) on the card bit-equal to adpcm_decode_np, "
          f"{ms:.3f} ms on the card; host encode {encode_s:.2f} s", flush=True)
    del on_card, got

    cfg = surgical_hydra_config()
    model = checkpoint.build_model(cfg, device=device)
    labels = list(cfg.data.classes)
    audio_s = SERVE_FILES * SERVE_FILE_S
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        wav_dir = tmp / "wav"
        wav_dir.mkdir()
        pcms = [write_wav(wav_dir / f"{i:03d}.wav", int(SERVE_FILE_S * 16_000), seed=100 + i)
                for i in range(SERVE_FILES)]
        wavs = sorted(wav_dir.glob("*.wav"))

        # the predict path, three ways
        rttms: dict[str, dict[str, str]] = {}
        for label, pack, transport in (("pack1", 1, "int16"), (f"pack{SERVE_PACK}", SERVE_PACK,
                                        "int16"), (f"pack{SERVE_PACK}_adpcm", SERVE_PACK,
                                        "adpcm")):
            def run(out: Path, pack=pack, transport=transport):
                return inference.run_inference_on_audios(
                    cfg, wav_dir, None, out, model=model, device=device,
                    batch_size=INNER_BATCH, transport=transport, pack_files=pack)

            walls = []
            for k in range(2):  # the second run is warm
                sync()
                reset_launches()
                telemetry.set_counts({"serve.bytes_to_device": 0})
                t0 = time.perf_counter()
                done = run(tmp / f"{label}_{k}")
                sync()
                walls.append(time.perf_counter() - t0)
                if len(done) != SERVE_FILES:
                    raise AssertionError(f"{label}: {len(done)} of {SERVE_FILES} files served")
            paths[label] = _serve_launches(read_launches(), label)
            shipped = telemetry.counts()["serve.bytes_to_device"]
            busy = (device_busy(card, label, lambda: run(tmp / f"{label}_prof"), walls[1])
                    if on_gpu else 0.0)
            rttms[label] = {p.stem: (tmp / f"{label}_1" / "raw_rttm" / f"{p.stem}.rttm").read_text()
                            for p in wavs}
            print(f"serve {label} [{card}]: {SERVE_FILES} files of {SERVE_FILE_S:.0f} s, walls "
                  f"{walls[0]:.3f} s and {walls[1]:.3f} s, warm {audio_s / walls[1]:.1f}x real "
                  f"time, device busy {100 * busy:.1f}%, {shipped} B to the device "
                  f"({shipped / SERVE_FILES:.0f} B per file), launches {paths[label]}", flush=True)
        pipe = inference.InferencePipeline(model, batch_size=INNER_BATCH, device=device)
        offline_logits: dict[int, np.ndarray] = {}

        def logits_of(i: int) -> np.ndarray:
            """File i's logits through the single-file path (inner batch 8)."""
            if i not in offline_logits:
                offline_logits[i] = pipe.logits_for_audio(pcms[i])
            return offline_logits[i]

        # packed against single-file logits: bit-equal where the inner
        # batches have the same rows (batch 8: one file's 8 chunks each);
        # at batch 64 cuBLAS and cuDNN take other algorithms for 64 rows
        narrow = inference.InferencePipeline(model, batch_size=8, device=device)
        with torch.inference_mode():
            same = narrow.logits_for_audios_async(pcms[:SERVE_PACK], pack_files=SERVE_PACK)
            wide = pipe.logits_for_audios_async(pcms[:SERVE_PACK], pack_files=SERVE_PACK)
        for i, (lg, tf) in enumerate(same):
            if not np.array_equal(lg[:tf].float().cpu().numpy(), logits_of(i)):
                raise AssertionError(f"file {i}: packed logits at inner batch 8 differ from "
                                     "the single-file logits")
        print(f"serve [{card}]: packed logits bit-equal to single-file logits at inner batch 8 "
              "(the same rows)", flush=True)
        dist = check_close(
            f"packed logits at inner batch {INNER_BATCH} ({SERVE_PACK} files of 8 chunks) "
            "against single-file logits (inner batch 8), bf16",
            torch.cat([lg[:tf].float().cpu() for lg, tf in wide]),
            torch.from_numpy(np.concatenate([logits_of(i) for i in range(SERVE_PACK)])),
            LOGITS_ATOL)
        n_frames = len(logits_of(0))
        diff_frames = {
            lb: [_near_threshold_check(f"{lb} RTTM {i}", _rttm_mask(
                tmp / f"{lb}_1" / "raw_rttm" / f"{p.stem}.rttm", labels, n_frames), logits_of(i))
                 for i, p in enumerate(wavs)]
            for lb in ("pack1", f"pack{SERVE_PACK}")}
        agree = []
        for i, p in enumerate(wavs):
            a, b = (_rttm_mask(tmp / f"{lb}_1" / "raw_rttm" / f"{p.stem}.rttm", labels, n_frames)
                    for lb in ("pack1", f"pack{SERVE_PACK}_adpcm"))
            agree.append(float((a == b).mean()))
        same_rttms = sum(rttms["pack1"][k] == rttms[f"pack{SERVE_PACK}"][k] for k in rttms["pack1"])
        print(f"serve [{card}]: int16 RTTMs at pack 1 and {SERVE_PACK}: {same_rttms} of "
              f"{SERVE_FILES} identical; frames differing from the single-file logits' decode "
              f"{ {lb: sum(d) for lb, d in diff_frames.items()} }, each within LOGITS_ATOL of "
              f"the threshold (packed logits up to {dist:.3e} away); ADPCM's frame agreement "
              f"with int16 mean {np.mean(agree):.4f}, min {min(agree):.4f}", flush=True)

        # the predict CLI
        config_path = write_config(tmp / "serve_config.yml", cfg)
        trainable, frozen = checkpoint.flax_split(model)
        checkpoint.save_params(tmp / "ck", trainable,
                               {"frozen_fingerprint": checkpoint.frozen_fingerprint(frozen)})
        sync()
        reset_launches()
        t0 = time.perf_counter()
        inference.main(["--config", str(config_path), "--wavs", str(wav_dir), "--checkpoint",
                        str(tmp / "ck"), "--output", str(tmp / "cli"), "--batch-size",
                        str(INNER_BATCH), "--device", device, "--transport", "adpcm",
                        "--pack-files", str(SERVE_PACK)])
        sync()
        paths["predict_cli_adpcm"] = _serve_launches(read_launches(), "predict CLI")
        if {p.stem: (tmp / "cli" / "raw_rttm" / f"{p.stem}.rttm").read_text() for p in wavs} != (
                rttms[f"pack{SERVE_PACK}_adpcm"]):
            raise AssertionError("the predict CLI's ADPCM RTTMs differ from the API run's")
        print(f"serve predict CLI --transport adpcm --pack-files {SERVE_PACK} [{card}]: "
              f"{time.perf_counter() - t0:.2f} s with the model build, RTTMs equal the API "
              f"run's, launches {paths['predict_cli_adpcm']}", flush=True)

        # the server in this process
        thr = inference.default_thresholds(labels)
        pipe.decode_intervals(pipe.logits_for_audio(pcms[0]), thr)  # the pipeline warm
        body = wavs[0].read_bytes()
        offline0 = sorted(pipe.decode_intervals(pipe.logits_for_audio(pcms[0]), thr))

        def as_samples(intervals) -> list:
            return sorted((round(iv.start_s * 16_000), round(iv.end_s * 16_000), iv.label)
                          for iv in intervals)

        def check_offline(what: str, i: int, intervals) -> int:
            """Intervals of file i against its single-file logits, by the
            near-threshold rule; returns the count of frames that differ."""
            lg = logits_of(i)
            return _near_threshold_check(f"{what} {i}", _frames_of(intervals, labels, len(lg)), lg)

        def one_shots(url: str) -> tuple[list[float], list]:
            lat, outs = [], []
            lock = threading.Lock()

            def worker(k: int) -> None:
                client = SegmaClient(url)
                for i in range(k, SERVE_REQUESTS, SERVE_CLIENTS):
                    t = time.perf_counter()
                    res = client.segment(wavs[i])
                    with lock:
                        lat.append(time.perf_counter() - t)
                        outs.append((i, res))

            ts = [threading.Thread(target=worker, args=(k,)) for k in range(SERVE_CLIENTS)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(300)
            if len(lat) != SERVE_REQUESTS:
                raise AssertionError(f"{len(lat)} of {SERVE_REQUESTS} requests answered")
            return lat, outs

        svc0 = SegmentationService(pipe, thr)
        srv0 = make_server(svc0, port=0)
        threading.Thread(target=srv0.serve_forever, daemon=True).start()
        url0 = f"http://127.0.0.1:{srv0.server_address[1]}"
        client = SegmaClient(url0)
        sync()
        reset_launches()
        telemetry.set_counts({"serve.bytes_to_device": 0})
        health = client.health()
        got_wav = as_samples(client.segment(wavs[0]))
        wav_bytes = telemetry.counts()["serve.bytes_to_device"]
        got_l16 = as_samples(client.segment(pcms[0]))
        l16_bytes = telemetry.counts()["serve.bytes_to_device"] - wav_bytes
        if not (got_wav == got_l16 == offline0 and offline0):
            raise AssertionError("the WAV or L16 /segment differs from the pipeline's intervals")
        lat0, outs0 = one_shots(url0)
        srv0.shutdown()
        diffs0 = [check_offline("request, window 0,", i, res) for i, res in outs0]
        paths["http_window0"] = _serve_launches(read_launches(), "server, window 0")
        print(f"serve http [{card}]: /healthz {health}; WAV and L16 /segment equal the pipeline's "
              f"{len(offline0)} intervals; bytes to the device per 20 s request: {wav_bytes} "
              f"(WAV, int16 transport), {l16_bytes} (L16); window 0: {SERVE_REQUESTS} requests "
              f"from {SERVE_CLIENTS} threads in {SERVE_REQUESTS} dispatches, latency "
              f"{_p50_p90(lat0)}, frames differing from offline near the threshold "
              f"{sum(diffs0)}, launches {paths['http_window0']}", flush=True)

        long_wav = tmp / "drain.wav"
        write_wav(long_wav, 120 * 16_000, seed=9)  # long enough to be in flight at SIGTERM
        svc5 = SegmentationService(pipe, thr, batch_window_ms=SERVE_WINDOW_MS, max_batch=8)
        srv5 = make_server(svc5, port=0)
        url5 = f"http://127.0.0.1:{srv5.server_address[1]}"
        report: dict = {}
        errors: list = []

        def drive() -> None:
            try:
                lat, outs = one_shots(url5)
                report["one_shot"] = (lat, outs, svc5._batcher.dispatches)
                push_lat: list[float] = []
                lock = threading.Lock()
                streamed: dict[int, list] = {}

                def session(i: int, ws: bool) -> None:
                    c = SegmaClient(url5)
                    step = int(SERVE_PUSH_S * 16_000)
                    with (c.stream_ws() if ws else c.stream()) as s:
                        for k in range(0, len(pcms[i]), step):
                            t = time.perf_counter()
                            s.push(pcms[i][k : k + step])
                            with lock:
                                push_lat.append(time.perf_counter() - t)
                    streamed[i] = s.intervals

                ts = [threading.Thread(target=session, args=(i, i == SERVE_STREAMS))
                      for i in range(SERVE_STREAMS + 1)]
                for t in ts:
                    t.start()
                for t in ts:
                    t.join(300)
                report["streams"] = (streamed, push_lat)
                # a request in flight when SIGTERM lands is answered
                box = {}
                inflight = threading.Thread(target=lambda: box.update(
                    res=SegmaClient(url5).segment(long_wav)))
                inflight.start()
                deadline = time.monotonic() + 30
                while srv5.inflight() == 0 and time.monotonic() < deadline:
                    time.sleep(0.001)
                os.kill(os.getpid(), signal.SIGTERM)
                inflight.join(60)
                report["drained"] = box.get("res")
            except Exception as e:  # noqa: BLE001 — raised in the main thread
                errors.append(e)
                os.kill(os.getpid(), signal.SIGTERM)

        sync()
        reset_launches()
        clients = threading.Thread(target=drive)
        clients.start()
        t0 = time.perf_counter()
        _serve_until_signalled(srv5)  # returns once SIGTERM has drained it
        drained_s = time.perf_counter() - t0
        clients.join(60)
        if errors:
            raise errors[0]
        paths[f"http_window{SERVE_WINDOW_MS:g}"] = _serve_launches(read_launches(), "server")
        lat5, outs5, dispatches = report["one_shot"]
        if dispatches >= SERVE_REQUESTS:
            raise AssertionError(f"{dispatches} dispatches for {SERVE_REQUESTS} requests at "
                                 f"a {SERVE_WINDOW_MS} ms window")
        diffs5 = [check_offline(f"request, window {SERVE_WINDOW_MS:g},", i, res)
                  for i, res in outs5]
        streamed, push_lat = report["streams"]
        n_chunks = svc5._stream_forward.dispatches
        pushed = 0
        diffs = []
        for i, intervals in streamed.items():
            diffs.append(check_offline("stream", i, intervals))
            pushed += pipe.chunkyfier.get_n_fitting_chunks(len(pcms[i])) + 1  # and the tail
        if n_chunks >= pushed:
            raise AssertionError(f"{n_chunks} batched forwards for {pushed} chunks")
        if report["drained"] is None or tf32_flags() != flags:
            raise AssertionError(f"SIGTERM drain answered {report['drained']!r}; TF32 flags "
                                 f"{tf32_flags()} after, {flags} before")
        print(f"serve http [{card}]: window {SERVE_WINDOW_MS:g} ms: {SERVE_REQUESTS} requests in "
              f"{dispatches} dispatches, latency {_p50_p90(lat5)}, frames differing from offline "
              f"near the threshold {sum(diffs5)}; "
              f"{SERVE_STREAMS} HTTP + 1 WebSocket streams of {SERVE_FILE_S:.0f} s in "
              f"{SERVE_PUSH_S} s pushes: {pushed} chunks in {n_chunks} batched forwards, push "
              f"latency {_p50_p90(push_lat)}, frames differing from offline near the "
              f"threshold {diffs}; SIGTERM drained the server with a request in flight "
              f"({drained_s:.1f} s served); TF32 flags (cuDNN, matmul) {flags} before and after; "
              f"launches {paths[f'http_window{SERVE_WINDOW_MS:g}']}", flush=True)

        # the serve CLI in a child process
        report_path = tmp / "cli_launches.json"
        log = tmp / "serve_cli.log"
        t0 = time.perf_counter()
        proc = _child(["-c", LAUNCH_REPORTING_CHILD, str(report_path),
                       "segma_tpu_torch.cli.serve", "--config", str(config_path),
                       "--checkpoint", str(tmp / "ck"), "--port", "0", "--device", device],
                      tmp / "cli_cwd", log)
        try:
            url = None
            deadline = time.monotonic() + CHILD_WALL_S
            while url is None and proc.poll() is None and time.monotonic() < deadline:
                for line in log.read_text().splitlines():
                    if " on http://" in line and "serving" in line:
                        url = line.split(" on ")[-1].strip()
                time.sleep(0.2)
            if url is None:
                raise AssertionError("the serve CLI never served:\n" + log.read_text()[-3000:])
            up_s = time.perf_counter() - t0
            with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
                health = json.loads(r.read())
            if as_samples(SegmaClient(url).segment(wavs[0])) != offline0:
                raise AssertionError("the serve CLI's /segment differs from the pipeline's")
            proc.send_signal(signal.SIGTERM)
            _wait(proc, log, "serve CLI", 0)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        paths["serve_cli"] = _serve_launches(json.loads(report_path.read_text()), "serve CLI")
        print(f"serve CLI [{card}]: python -m segma_tpu_torch.cli.serve up in {up_s:.1f} s "
              f"(start, model build, warm-up), device {health['device']}, /segment equal to the "
              f"pipeline's, SIGTERM exit 0, launches {paths['serve_cli']}", flush=True)
    return paths


EXPORT_BUCKETS = (8, 32)  # the bf16 artifact's buckets; its inner batch is the larger
EXPORT_F32_BUCKET = 8  # the f32 artifact's one bucket, also its inner batch
EXPORT_STREAM_BATCHES = (2,)
EXPORT_STREAM_S = 60.0  # audio streamed over the artifact and the live model
EXPORT_BUNDLE_CLIP_S = 20.0  # the clip each bundle model segments over HTTP
EXPORT_OPS = ("segma_tpu_torch.log10_mel.default", "segma_tpu_torch.flash_attn_fwd.default",
              "segma_tpu_torch.lstm.default")
# the artifact's loader, a fresh process: it imports segma_tpu_torch.ops and
# segma_tpu_torch.export (and the stdlib, numpy, torch) and must not import
# the model package; it writes the WAV's logits, its times, the launch
# counts of one run and the op nodes of the infer programs
EXPORT_CHILD = (
    "import json, sys, time, wave\n"
    "import numpy as np, torch\n"
    "import segma_tpu_torch.ops as ops\n"
    "from segma_tpu_torch.export import ExportedPipeline\n"
    "art, wav_path, out_npy, out_json = sys.argv[1:5]\n"
    "with wave.open(wav_path) as w:\n"
    "    pcm = np.frombuffer(w.readframes(w.getnframes()), '<i2').astype(np.int16)\n"
    "load_s = []\n"
    "for _ in range(2):  # the first pays the process's one-time imports and CUDA set-up\n"
    "    t0 = time.perf_counter()\n"
    "    exp = ExportedPipeline.load(art)\n"
    "    torch.cuda.synchronize()\n"
    "    load_s.append(time.perf_counter() - t0)\n"
    "targets = sorted({str(n.target) for p in exp.infer_fns.values()\n"
    "                  for n in p.exported.graph.nodes if str(n.target).startswith('segma')})\n"
    "ops.set_launch_counts(dict.fromkeys(ops.launch_counts(), 0))\n"
    "walls = []\n"
    "for k in range(3):\n"
    "    t0 = time.perf_counter()\n"
    "    logits = exp.logits_for_audio(exp.prepare(pcm))\n"
    "    walls.append(time.perf_counter() - t0)\n"
    "    if k == 0:\n"
    "        launches = ops.launch_counts()\n"
    "models = sorted(m for m in sys.modules if m.startswith('segma_tpu_torch.models'))\n"
    "np.save(out_npy, logits)\n"
    "with open(out_json, 'w') as f:\n"
    "    json.dump({'load_s': load_s, 'walls': walls, 'launches': launches,\n"
    "               'targets': targets, 'models': models}, f)\n"
)


def _artifact_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def _program_targets(pipe) -> set[str]:
    """The registered ops the artifact's infer programs call."""
    return {str(n.target) for prog in pipe.infer_fns.values()
            for n in prog.exported.graph.nodes if str(n.target).startswith("segma_tpu_torch.")}


def _same_or_near(what: str, got: np.ndarray, ref: np.ndarray, atol: float) -> str:
    """Bit-equal logits, or else the near-threshold rule on their masks
    with max |delta| printed; returns which held."""
    if got.shape != ref.shape:
        raise AssertionError(f"{what}: shape {got.shape}, live {ref.shape}")
    if np.array_equal(got, ref):
        return "bit-equal"
    import torch

    delta = float(np.abs(got - ref).max())
    n = _near_threshold_check(what, (torch.sigmoid(torch.from_numpy(got)) > 0.5).numpy(), ref,
                              atol)
    return f"not bit-equal: max |delta| {delta:.3e}, {n} frames flip, all within {atol:g}"


def phase_export(card: str) -> dict:
    """Frozen artifacts on the card: ``export_inference`` of full-width
    Whisper-base ``surgical_hydra`` in bf16 (train.seed 0 weights) for the
    cuda platform, buckets EXPORT_BUCKETS, stream batches
    EXPORT_STREAM_BATCHES (export wall of each program, the artifact's
    bytes); a fresh child process that imports segma_tpu_torch.ops and
    segma_tpu_torch.export only loads it (cold load), serves the serving
    slice's 597.5 s WAV three times and holds no module of the model
    package: its logits bit-equal to the live pipeline's at the same inner
    batch (else the near-threshold rule with max |delta|), the log-mel and
    flash-forward op nodes in its programs, log-mel launched once and the
    flash forward once per layer for each dispatch of the bucket plan, and
    its warm xRT beside the live one. ``predict --artifact`` against
    ``predict --config`` (RTTMs, near-threshold rule); a stream session over
    the artifact against the live streaming path. The f32 model's artifact
    (bucket EXPORT_F32_BUCKET, no stream batches) gated the same way, in
    this process. Then the two with ``conv_vad`` at its YAML width in one
    bundle, served by ``python -m segma_tpu_torch.cli.serve --bundle`` in a
    child: GET /v1/models, ``?model=`` for each model against its artifact
    in this process, and POST /admin/reload after conv_vad is re-exported
    (its open session drains, new requests see the new artifact). Last,
    ``python -m segma_tpu_torch.cli.doctor`` exits 0. Returns each path's
    launch counts."""
    import signal

    import torch

    from segma_tpu_torch import checkpoint, inference
    from segma_tpu_torch.bundle import write_bundle_manifest
    from segma_tpu_torch.client import Interval, SegmaClient
    from segma_tpu_torch.export import ExportedPipeline, _bucket_plan, export_inference
    from segma_tpu_torch.streaming import StreamingSegmenter

    paths: dict[str, dict] = {}
    cfg = surgical_hydra_config()
    labels = list(cfg.data.classes)
    batch = max(EXPORT_BUCKETS)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        wav_dir = tmp / "wav"
        wav_dir.mkdir()
        stride, chunk_f, n_w = 63_680, 64_000, 199  # surgical_hydra's 4 s chunks
        n_samples = N_CHUNKS * stride + (chunk_f - stride) + 8_000
        pcm = write_wav(wav_dir / "smoke.wav", n_samples)
        audio_s = n_samples / 16_000
        bundle = tmp / "bundle"

        # the bf16 artifact
        model = checkpoint.build_model(cfg, device="cuda")
        n_layers = model.module.enc_cfg.n_layers
        walls: dict[str, float] = {}
        t0 = time.perf_counter()
        art = export_inference(model, bundle / "whisper_bf16", buckets=EXPORT_BUCKETS,
                               batch_size=batch, platforms=("cuda",),
                               stream_batches=EXPORT_STREAM_BATCHES, model_version="bf16",
                               walls=walls)
        export_s = time.perf_counter() - t0
        print(f"export bf16 [{card}]: {export_s:.1f} s for {len(walls)} programs ("
              + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items())
              + f"), artifact {_artifact_bytes(art)} B", flush=True)

        live = inference.InferencePipeline(model, batch_size=batch)
        live.logits_for_audio(pcm)  # warm
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        live_logits = live.logits_for_audio(pcm)
        live_wall = time.perf_counter() - t0
        paths["export live bf16"] = read_launches()

        log = tmp / "child.log"
        proc = _child(["-c", EXPORT_CHILD, str(art), str(wav_dir / "smoke.wav"),
                       str(tmp / "child.npy"), str(tmp / "child.json")], tmp / "child_cwd", log)
        child_s = _wait(proc, log, "artifact loader child", 0)
        report = json.loads((tmp / "child.json").read_text())
        if report["models"]:
            raise AssertionError(f"the loader child imported {report['models']}")
        if not set(EXPORT_OPS) <= set(report["targets"]):
            raise AssertionError(f"the bf16 programs call {report['targets']}, not {EXPORT_OPS}")
        needed = -(-inference.Chunkyfier(1, chunk_f, model.conv_settings).total_frames(
            n_samples) // n_w)
        plan = _bucket_plan(needed, list(EXPORT_BUCKETS))
        n_inner = sum(-(-b // batch) for b in plan)
        counts = report["launches"]
        paths["export child bf16"] = counts
        lstm_layers = model.module.lstm_shared.cfg.num_layers
        if (counts["logmel"] != n_inner or counts["flash_attn_fwd"] != n_layers * n_inner
                or counts["lstm_fwd"] != lstm_layers * n_inner):
            raise AssertionError(f"artifact launches {counts}, not log-mel {n_inner}, flash "
                                 f"{n_layers * n_inner} and lstm {lstm_layers * n_inner} "
                                 f"(plan {plan})")
        verdict = _same_or_near("bf16 artifact logits", np.load(tmp / "child.npy"),
                                live_logits, LOGITS_ATOL)
        warm_s = min(report["walls"][1:])
        print(f"export bf16 child [{card}]: imports segma_tpu_torch.ops and .export, no model "
              f"module; cold load {report['load_s'][0]:.2f} s, a second load in the process "
              f"{report['load_s'][1]:.2f} s, runs {report['walls']} s, warm "
              f"{audio_s / warm_s:.1f}x real time against the live pipeline's "
              f"{audio_s / live_wall:.1f}x (inner batch {batch}, this run); child wall "
              f"{child_s:.1f} s; plan {plan}; logits {verdict}; ops {report['targets']}; "
              f"launches {counts}", flush=True)

        # predict --artifact against predict --config
        config_path = write_config(tmp / "cfg.json", cfg)
        trainable, frozen = checkpoint.flax_split(model)
        checkpoint.save_params(tmp / "ck", trainable,
                               {"frozen_fingerprint": checkpoint.frozen_fingerprint(frozen)})
        reset_launches()
        inference.main(["--artifact", str(art), "--wavs", str(wav_dir), "--output",
                        str(tmp / "pa")])
        paths["export predict --artifact"] = read_launches()
        inference.main(["--config", str(config_path), "--checkpoint", str(tmp / "ck"), "--wavs",
                        str(wav_dir), "--output", str(tmp / "pc"), "--batch-size", str(batch)])
        n_frames = len(live_logits)
        flips = [_near_threshold_check(f"predict {side}", _rttm_mask(
            tmp / side / "raw_rttm" / "smoke.rttm", labels, n_frames), live_logits)
            for side in ("pa", "pc")]
        same = ((tmp / "pa" / "raw_rttm" / "smoke.rttm").read_text()
                == (tmp / "pc" / "raw_rttm" / "smoke.rttm").read_text())
        print(f"export predict [{card}]: --artifact and --config RTTMs "
              f"{'identical' if same else 'differ'}; frames off the live decode {flips}, each "
              f"within LOGITS_ATOL of the threshold; launches "
              f"{paths['export predict --artifact']}", flush=True)

        # a stream session over the artifact against the live streaming path
        exp = ExportedPipeline.load(art)
        n_stream = int(EXPORT_STREAM_S * 16_000)
        step = int(SERVE_PUSH_S * 16_000)
        streamed = {}
        for side, seg in (("artifact", exp.streaming_segmenter()),
                          ("live", StreamingSegmenter(model))):
            for k in range(0, n_stream, step):
                seg.push(pcm[k : min(k + step, n_stream)])
            seg.flush()
            streamed[side] = seg.intervals
        if streamed["artifact"] == streamed["live"]:
            stream_verdict = f"equal ({len(streamed['live'])} intervals)"
        else:
            prefix = live.logits_for_audio(pcm[:n_stream])
            n = [_near_threshold_check(f"stream {side}", _frames_of(
                [Interval(s / 16_000, e / 16_000, lb) for s, e, lb in ivs], labels,
                len(prefix)), prefix) for side, ivs in streamed.items()]
            stream_verdict = f"differ, frames off offline {n}, each near the threshold"
        print(f"export stream [{card}]: {EXPORT_STREAM_S:.0f} s in {SERVE_PUSH_S} s pushes, "
              f"artifact against live intervals: {stream_verdict}", flush=True)
        del exp, live, model
        torch.cuda.empty_cache()

        # the f32 artifact
        cfg32 = surgical_hydra_config("f32")
        model32 = checkpoint.build_model(cfg32, device="cuda")
        walls32: dict[str, float] = {}
        art32 = export_inference(model32, bundle / "whisper_f32", buckets=(EXPORT_F32_BUCKET,),
                                 batch_size=EXPORT_F32_BUCKET, platforms=("cuda",),
                                 stream_batches=(), model_version="f32", walls=walls32)
        live32 = inference.InferencePipeline(model32, batch_size=EXPORT_F32_BUCKET)
        ref32 = live32.logits_for_audio(pcm)
        t0 = time.perf_counter()
        exp32 = ExportedPipeline.load(art32)
        load32_s = time.perf_counter() - t0
        if not set(EXPORT_OPS) <= _program_targets(exp32):
            raise AssertionError(f"the f32 programs call {_program_targets(exp32)}")
        exp32.logits_for_audio(pcm)  # warm
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        got32 = exp32.logits_for_audio(pcm)
        warm32_s = time.perf_counter() - t0
        counts32 = paths["export f32"] = read_launches()
        plan32 = _bucket_plan(needed, [EXPORT_F32_BUCKET])
        if (counts32["logmel"] != len(plan32)
                or counts32["flash_attn_fwd_f32"] != n_layers * len(plan32)
                or counts32["lstm_fwd"] != lstm_layers * len(plan32)):
            raise AssertionError(f"f32 artifact launches {counts32}, plan of {len(plan32)}")
        verdict32 = _same_or_near("f32 artifact logits", got32, ref32, LOGITS_F32_ATOL)
        print(f"export f32 [{card}]: {sum(walls32.values()):.1f} s for {len(walls32)} programs, "
              f"artifact {_artifact_bytes(art32)} B, load {load32_s:.2f} s, warm "
              f"{audio_s / warm32_s:.1f}x real time, logits {verdict32}, launches {counts32}",
              flush=True)
        del exp32, live32, model32
        torch.cuda.empty_cache()

        # the bundle: both artifacts and conv_vad at its YAML width
        vcfg = family_config("conv_vad", tmp / "data")
        vmodel = checkpoint.build_model(vcfg, device="cuda")

        def export_vad(version: str) -> Path:
            return export_inference(vmodel, bundle / "conv_vad", buckets=(8,), batch_size=8,
                                    platforms=("cuda",), stream_batches=(2,),
                                    model_version=version)

        export_vad("v1")
        write_bundle_manifest(bundle, default="whisper_bf16")
        clip = pcm[: int(EXPORT_BUNDLE_CLIP_S * 16_000)]
        wants = {name: sorted(ExportedPipeline.load(bundle / name).segment(clip))
                 for name in ("whisper_bf16", "whisper_f32", "conv_vad")}
        report_path = tmp / "bundle_launches.json"
        log = tmp / "bundle_serve.log"
        proc = _child(["-c", LAUNCH_REPORTING_CHILD, str(report_path),
                       "segma_tpu_torch.cli.serve", "--bundle", str(bundle), "--port", "0"],
                      tmp / "bundle_cwd", log)
        try:
            url = None
            t0 = time.perf_counter()
            deadline = time.monotonic() + CHILD_WALL_S
            while url is None and proc.poll() is None and time.monotonic() < deadline:
                for line in log.read_text().splitlines():
                    if " on http://" in line and "serving bundle" in line:
                        url = line.split(" on ")[-1].strip()
                time.sleep(0.2)
            if url is None:
                raise AssertionError("the bundle server never served:\n" + log.read_text()[-3000:])
            up_s = time.perf_counter() - t0
            client = SegmaClient(url)
            catalog = client.models()
            if catalog["default"] != "whisper_bf16" or set(catalog["models"]) != set(wants):
                raise AssertionError(f"GET /v1/models: {catalog}")
            for name, want in wants.items():
                got = sorted((round(iv.start_s * 16_000), round(iv.end_s * 16_000), iv.label)
                             for iv in client.segment(clip, model=name))
                if got != want:
                    raise AssertionError(f"?model={name}: the server's intervals differ from "
                                         "its artifact's in this process")
            session = client.stream(model="conv_vad")
            session.push(clip[: 5 * 16_000])
            time.sleep(1.1)  # created_at has a resolution of 1 s
            export_vad("v2")
            reload = client.reload()
            if reload["replaced"] != ["conv_vad"] or reload["kept"] != ["whisper_bf16",
                                                                         "whisper_f32"]:
                raise AssertionError(f"POST /admin/reload: {reload}")
            session.push(clip[5 * 16_000 :])
            drained = session.flush()
            version = client.models()["models"]["conv_vad"]["model_version"]
            if version != "v2" or not client.segment(clip, model="conv_vad"):
                raise AssertionError(f"after the reload conv_vad is {version}")
            proc.send_signal(signal.SIGTERM)
            _wait(proc, log, "bundle server", 0)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        paths["export bundle serve"] = json.loads(report_path.read_text())
        print(f"export bundle [{card}]: {sorted(wants)} served by cli.serve --bundle, up in "
              f"{up_s:.1f} s (load and warm); ?model= intervals equal each artifact's; reload "
              f"{reload}; the old conv_vad session drained ({len(drained)} intervals at its "
              f"flush), new requests see v2; SIGTERM exit 0; launches "
              f"{paths['export bundle serve']}", flush=True)

        # doctor on the card
        log = tmp / "doctor.log"
        _wait(_child(["-m", "segma_tpu_torch.cli.doctor"], tmp / "doctor_cwd", log), log,
              "doctor", 0)
        print(f"export doctor [{card}]: exit 0\n" + log.read_text().rstrip(), flush=True)
    return paths


PARALLEL_REPLICAS = ("cuda:0", "cuda:0")  # two replicas on the one card
PARALLEL_LAYERS = 4  # the gloo world's HuBERT-base widths at 4 layers, as phase_train_cli's
PARALLEL_GLOBAL_BATCH = 8  # the world step's global batch: 4 crops a rank of two
PARALLEL_LR = 1e-3
PARALLEL_CLI_EPOCHS = 2
PARALLEL_REQUEST_S = 20.0  # the request sent to the server over the two-replica mesh
STEEP_GRAD = 100 * 1e-8  # updates held at 1e-5 where |grad| is 100 times AdamW's eps
TRAIN_LAUNCH_KEYS = ("flash_attn_fwd", "flash_attn_bwd")  # the bf16 training path's kernels
# one step of a rank of a world (backend argv[4]): each rank takes its block
# of the global batch in <out>/batch.npz; each writes its loss, gradients and
# weights
PARALLEL_STEP_CHILD = (
    "import sys, numpy as np, torch\n"
    "from segma_tpu_torch import checkpoint\n"
    "from segma_tpu_torch.config import load_config\n"
    "from segma_tpu_torch.parallel import distributed\n"
    "from segma_tpu_torch.train import make_optimizer, make_train_step\n"
    "cfg_path, out, lr, backend = sys.argv[1], sys.argv[2], float(sys.argv[3]), sys.argv[4]\n"
    "assert distributed.maybe_init_distributed('cuda', backend=backend)\n"
    "world = distributed.current_world()\n"
    "model = checkpoint.build_model(load_config(cfg_path), device='cuda')\n"
    "model.module.dropout = 0.0\n"
    "b = np.load(out + '/batch.npz')\n"
    "n = len(b['x']) // world.size\n"
    "rows = slice(world.rank * n, (world.rank + 1) * n)\n"
    "step = make_train_step(model, make_optimizer(model, lr), world=world, group=world.group)\n"
    "loss, per_label = step({k: torch.from_numpy(b[k][rows]).cuda() for k in ('x', 'y')}, None)\n"
    "named = [(k, p) for k, p in model.module.named_parameters() if p.requires_grad]\n"
    "np.savez(f'{out}/rank{world.rank}.npz', loss=loss.cpu().numpy()[None],\n"
    "         per_label=per_label.cpu().numpy(),\n"
    "         **{'grad:' + k: p.grad.cpu().numpy() for k, p in named},\n"
    "         **{'param:' + k: p.detach().cpu().numpy() for k, p in named})\n"
)


def _rank_env(rank: int, world: int, port: int, card: int = 0) -> dict:
    """torchrun's variables for rank ``rank`` of a world on this host, on
    card ``card``."""
    return {"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(card),
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ranks(args: list[str], cwd: Path, logs: Path, label: str, n: int = 2,
           own_cards: bool = False) -> list:
    """``python args`` as ``n`` ranks of a world on a free port: all on card
    0, or with ``own_cards`` rank r on card r."""
    port = _free_port()
    return [_child(args, cwd / f"rank{r}", logs / f"{label}{r}.log",
                   _rank_env(r, n, port, r if own_cards else 0)) for r in range(n)]


def _wait_ranks(procs: list, logs: Path, label: str, want: int) -> float:
    t0 = time.perf_counter()
    try:
        for r, proc in enumerate(procs):
            _wait(proc, logs / f"{label}{r}.log", f"{label} rank {r}", want)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return time.perf_counter() - t0


def _serving_wav(tmp: Path):
    """The serving slice's config, model (seed 0, on cuda:0), WAV directory,
    seconds of audio, and the chunks its bucket holds."""
    import warnings

    import torch

    from segma_tpu_torch.geometry import ConvolutionSettings
    from segma_tpu_torch.inference import Chunkyfier, _bucket
    from segma_tpu_torch.models import Models
    from segma_tpu_torch.utils.encoders import MultiLabelEncoder

    cfg = surgical_hydra_config()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # random encoder weights, on purpose
        model = Models["surgical_hydra"](MultiLabelEncoder(cfg.data.classes), cfg,
                                         device="cuda", generator=torch.Generator().manual_seed(0))
    ck = Chunkyfier(INNER_BATCH, cfg.audio.chunk_duration_f,
                    ConvolutionSettings((320,), (320,), (0,)))
    n_samples = N_CHUNKS * ck.chunk_stride + ck.missing_n_frames + 8_000
    wav_dir = tmp / "wav"
    wav_dir.mkdir()
    write_wav(wav_dir / "smoke.wav", n_samples)
    n_chunks = _bucket(-(-ck.total_frames(n_samples) // ck.n_windows))
    return cfg, model, wav_dir, n_samples / 16_000, n_chunks


def _whole_batches(n_chunks: int, replicas: int) -> bool:
    """Whether ``replicas`` blocks of ``n_chunks`` windows are each a whole
    number of inner batches (the meshless pipeline's, so bit-equal)."""
    return replicas == 1 or n_chunks % (replicas * INNER_BATCH) == 0


def _serve_paths(card: str, cfg, model, wav_dir: Path, out: Path, audio_s: float,
                 meshes: dict, note: str) -> dict:
    """The serving slice's WAV through ``run_inference_on_audios`` once per
    entry of ``meshes`` (label: (``mesh`` argument, whether the replicas'
    blocks are whole inner batches)), the first entry the reference, each
    run twice (the second timed, from zeroed launch counters), logits
    dumped: each run's launches equal the reference's, its logits and RTTM
    bit-equal to them where the blocks are whole inner batches, else its
    logits within LOGITS_ATOL. Returns the launch counts by label."""
    import torch

    from segma_tpu_torch.inference import run_inference_on_audios

    def drive(mesh, tag: str) -> tuple[float, dict, dict]:
        for run in range(2):
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            done = run_inference_on_audios(cfg, wav_dir, None, out / f"{tag}{run}", model=model,
                                           device="cuda", batch_size=INNER_BATCH,
                                           dump_logits=True, mesh=mesh)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if len(done) != 1:
                raise AssertionError(f"parallel serve {tag}: no file served")
        logits = dict(np.load(out / f"{tag}1" / "logits" / "smoke-logits_dict_t.npz"))
        return wall, read_launches(), logits

    paths, walls, ref, first = {}, {}, None, None
    for label, (mesh, exact) in meshes.items():
        tag = label.replace(" ", "_").replace("(", "").replace(")", "")
        walls[label], paths[label], logits = drive(mesh, tag)
        _launched(paths[label], SERVE_LAUNCH_KEYS, f"parallel serve {label}")
        if ref is None:
            ref, first = logits, tag
            continue
        if paths[label] != paths[next(iter(meshes))]:
            raise AssertionError(f"parallel serve {label}: launches {paths[label]} against "
                                 f"the reference's {paths[next(iter(meshes))]}")
        rttm = (out / f"{tag}1" / "raw_rttm" / "smoke.rttm").read_text()
        same_rttm = rttm == (out / f"{first}1" / "raw_rttm" / "smoke.rttm").read_text()
        for name, value in ref.items():
            if not exact:
                check_close(f"parallel serve {label}, {name} logits", logits[name], value,
                            LOGITS_ATOL)
            elif not np.array_equal(logits[name], value):
                raise AssertionError(f"parallel serve {label}: {name} logits differ from the "
                                     f"reference by {np.abs(logits[name] - value).max()}")
        if exact and not same_rttm:
            raise AssertionError(f"parallel serve {label}: the RTTM differs")
        print(f"check parallel serve {label} [{card}]: logits of {len(value)} frames x "
              f"{len(ref)} labels {'bit-equal to' if exact else 'within LOGITS_ATOL of'} "
              f"{next(iter(meshes))}, RTTM {'identical' if same_rttm else 'differs'}, "
              f"launches {paths[label]}", flush=True)
    print(f"parallel serve walls [{card}] over {audio_s:.1f} s of audio ({note}): " + ", ".join(
        f"{label} {walls[label]:.4f} s = {audio_s / walls[label]:.1f}x real time"
        for label in walls), flush=True)
    return paths


def _serve_request(card: str, cfg, model, tmp: Path, mesh, label: str,
                   near: float | None = None) -> dict:
    """One request to ``serve_forever`` (in a thread of this process) over
    ``mesh``, answered as a meshless service on the same model answers it;
    with ``near`` (a mesh whose logits are not bit-equal to meshless, as
    under ``model``), each answer's frames equal the meshless pipeline's
    logits thresholded, except where a logit lies within ``near`` of the
    threshold. Returns the request's launch counts."""
    import threading

    from segma_tpu_torch import checkpoint, serve
    from segma_tpu_torch.client import SegmaClient
    from segma_tpu_torch.inference import InferencePipeline
    from segma_tpu_torch.serve import runtime

    wav = tmp / "request.wav"
    write_wav(wav, int(PARALLEL_REQUEST_S * 16_000), seed=5)
    servers: list = []
    real_make, real_load = runtime.make_server, checkpoint.load_model_for_inference

    def capture(*a, **kw):
        servers.append(real_make(*a, **kw))
        return servers[-1]

    runtime.make_server = capture
    checkpoint.load_model_for_inference = lambda *a, **kw: model
    thread = threading.Thread(target=serve.serve_forever, kwargs=dict(
        config=cfg, port=0, batch_size=INNER_BATCH, device="cuda", mesh=mesh), daemon=True)
    try:
        thread.start()
        t0 = time.perf_counter()
        while not servers:
            if not thread.is_alive() or time.perf_counter() - t0 > 300:
                raise AssertionError("serve_forever over the mesh did not bind")
            time.sleep(0.05)
        ref_server = serve.make_server(serve.SegmentationService(
            InferencePipeline(model, batch_size=INNER_BATCH, device="cuda")), port=0)
        threading.Thread(target=ref_server.serve_forever, daemon=True).start()
        try:
            want = SegmaClient(f"http://127.0.0.1:{ref_server.server_address[1]}").segment(
                str(wav))
        finally:
            ref_server.shutdown()
        reset_launches()
        t0 = time.perf_counter()
        got = SegmaClient(f"http://127.0.0.1:{servers[0].server_address[1]}").segment(str(wav))
        wall = time.perf_counter() - t0
        launches = read_launches()
    finally:
        runtime.make_server, checkpoint.load_model_for_inference = real_make, real_load
        for server in servers:
            server.shutdown()
        thread.join(60)
    if thread.is_alive():
        raise AssertionError("serve_forever did not stop")
    if near is None and (got != want or not got):
        raise AssertionError(f"the server over {label} answered {len(got)} intervals, the "
                             f"meshless one {len(want)}, not the same")
    how = f"as the meshless service does ({len(got)} intervals)"
    if near is not None:
        from segma_tpu_torch.inference import _load_mono

        ref = InferencePipeline(model, batch_size=INNER_BATCH, device="cuda").logits_for_audio(
            _load_mono(wav))
        labels = list(cfg.data.classes)
        flips = [_near_threshold_check(f"the server over {label}, {side}",
                                       _frames_of(answer, labels, len(ref)), ref, near)
                 for side, answer in (("mesh", got), ("meshless", want))]
        if not got:
            raise AssertionError(f"the server over {label} answered no interval")
        how = (f"with {len(got)} intervals against the meshless service's {len(want)}: "
               f"{flips[0]} and {flips[1]} frames off the meshless logits, all within {near:.3e} "
               "of the threshold")
    _launched(launches, SERVE_LAUNCH_KEYS, "parallel serve request")
    print(f"check parallel serve request [{card}]: serve_forever over {label} answered a "
          f"{PARALLEL_REQUEST_S:.0f} s request {how} in {wall:.3f} s, launches {launches}",
          flush=True)
    return launches


def _nccl_world_of_one(card: str, tmp: Path) -> dict:
    """A seeded one-epoch fit of the training slice (HuBERT-base, bf16, the
    device cache) with and without an NCCL world of one in this process,
    under step and epoch dispatch: bit-equal in every epoch's losses and
    metrics, the trainable parameters and AdamW's state, with equal
    launches; under epoch dispatch the world's all-reduce is inside the
    captured graph. Returns the world's launch counts by dispatch."""
    import dataclasses
    import os

    import torch

    from segma_tpu_torch.data import SegmaFileDataset
    from segma_tpu_torch.parallel import distributed

    root = tmp / "data"
    write_dataset(root, TRAIN_CLASSES, (TRAIN_FILES, VAL_FILES, TEST_FILES), TRAIN_FILE_S)
    base = surgical_hubert_hydra_config(root)
    ds = SegmaFileDataset.from_config(base)
    ds.load(use_cache=False)
    env = _rank_env(0, 1, _free_port())
    paths = {}
    for dispatch in ("step", "epoch"):
        # one epoch: its four steps cover the eager warm-up, the capture and
        # the replays under epoch dispatch
        cfg = dataclasses.replace(base, train=dataclasses.replace(
            base.train, dispatch=dispatch, data_cache="device", max_epochs=1))
        alone = _dispatch_fit(card, f"{dispatch} dispatch, one process", cfg, ds,
                              tmp / f"alone_{dispatch}")
        os.environ.update(env)
        try:
            if not distributed.maybe_init_distributed("cuda"):
                raise AssertionError("the NCCL world of one did not start")
            backend = torch.distributed.get_backend()
            world = _dispatch_fit(card, f"{dispatch} dispatch, NCCL world of 1", cfg, ds,
                                  tmp / f"world_{dispatch}")
        finally:
            distributed.destroy()
            for k in env:
                os.environ.pop(k, None)
        _same_run(alone, world, f"parallel train {dispatch} dispatch, NCCL ({backend}) world "
                  "of 1 against one process")
        if world["launches"] != alone["launches"]:
            raise AssertionError(f"parallel train {dispatch}: launches {world['launches']} "
                                 f"against {alone['launches']}")
        _launched(world["launches"], TRAIN_LAUNCH_KEYS, f"parallel train {dispatch}")
        if dispatch == "epoch" and world["graphs"] != [True]:
            raise AssertionError(f"parallel train epoch: replayed graphs {world['graphs']}")
        paths[f"world1 {dispatch}"] = world["launches"]
    return paths


def _assert_update(name: str, got: np.ndarray, want: np.ndarray, grad: np.ndarray) -> float:
    """AdamW's first update held at 1e-5 where the gradient is steep, within
    the learning rate elsewhere (there it is set by the gradient's last
    digits); returns the largest difference on the steep entries."""
    steep = np.abs(grad) >= STEEP_GRAD
    diff = np.abs(got.astype(np.float64) - want)
    if diff[steep].max(initial=0.0) > 1e-5 or diff.max(initial=0.0) > PARALLEL_LR * (1 + 1e-3):
        raise AssertionError(f"{name}: update differs by {diff[steep].max(initial=0.0):.3e} "
                             f"(steep), {diff.max():.3e} (all)")
    return float(diff[steep].max(initial=0.0))


def _world_step(card: str, cfg, cfg_path: Path, tmp: Path, n: int = 2,
                backend: str = "gloo", own_cards: bool = False) -> None:
    """One f32 step of an ``n``-rank world in child processes (HuBERT-base
    widths at PARALLEL_LAYERS layers, dropout 0), each rank on its block of
    a global batch, against this process's step over the whole batch: loss
    and per-label loss at 1e-5, gradients at 1e-4, updates by
    ``_assert_update``; every rank's weights bit-equal. In f32, as the CPU
    tests hold the step: a bf16 forward over 4 rows and over 8 rounds
    differently. Default: 2 gloo ranks on cuda:0."""
    import torch

    from segma_tpu_torch import checkpoint
    from segma_tpu_torch.train import make_optimizer, make_train_step

    label = f"{backend}_step"
    out = tmp / label
    out.mkdir()
    batch = n * max(1, PARALLEL_GLOBAL_BATCH // n)
    rng = np.random.default_rng(23)
    t = np.arange(64_000) / 16_000
    x = (0.1 * rng.standard_normal((batch, 64_000))
         + 0.3 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)
    y = (rng.random((batch, 199, len(TRAIN_CLASSES))) > 0.6).astype(np.float32)
    np.savez(out / "batch.npz", x=x, y=y)
    procs = _ranks(["-c", PARALLEL_STEP_CHILD, str(cfg_path), str(out), str(PARALLEL_LR),
                    backend], tmp / f"cwd_{label}", tmp, label, n, own_cards)
    wall = _wait_ranks(procs, tmp, label, 0)
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(n)]
    for other in ranks[1:]:
        for k in ranks[0]:
            if k.startswith("param:") and not np.array_equal(ranks[0][k], other[k]):
                raise AssertionError(f"{label}: the ranks' {k} differ")
    model = checkpoint.build_model(cfg, device="cuda")
    model.module.dropout = 0.0
    loss, per_label = make_train_step(model, make_optimizer(model, PARALLEL_LR))(
        {"x": torch.from_numpy(x).cuda(), "y": torch.from_numpy(y).cuda()}, None)
    got = ranks[0]
    d_loss = abs(float(got["loss"][0]) - float(loss))
    d_per = float(np.abs(got["per_label"] - per_label.cpu().numpy()).max())
    if d_loss > 1e-5 or d_per > 1e-5:
        raise AssertionError(f"{label}: loss differs by {d_loss:.3e}, per label {d_per:.3e}")
    d_grad = d_update = 0.0
    n_tensors = 0
    for name, p in model.module.named_parameters():
        if not p.requires_grad:
            continue
        g = p.grad.float().cpu().numpy()
        diff = float(np.abs(got["grad:" + name] - g).max())
        if diff > 1e-4:
            raise AssertionError(f"{label}: gradient of {name} differs by {diff:.3e}")
        d_grad = max(d_grad, diff)
        d_update = max(d_update, _assert_update(name, got["param:" + name],
                                                p.detach().double().cpu().numpy(), g))
        n_tensors += 1
    where = f"cuda:0 to cuda:{n - 1}" if own_cards else "cuda:0"
    print(f"check parallel train {label} [{card}]: {n} {backend} ranks on {where} (f32, "
          f"{PARALLEL_LAYERS} HuBERT-base layers, {batch // n} crops a rank) "
          f"against one process over {batch}: loss {d_loss:.3e}, per label "
          f"{d_per:.3e}, gradients {d_grad:.3e} (max of {n_tensors} tensors), steep updates "
          f"{d_update:.3e}; the ranks' weights bit-equal; children's wall {wall:.1f} s",
          flush=True)


def _gloo_preemption(card: str, cfg_path: Path, tmp: Path) -> None:
    """``cli.auto_train --dist-backend gloo`` as 2 ranks on cuda:0: SIGTERM
    to rank 1 once epoch 0 is logged; both ranks exit 75, rank 0's ``last/``
    is on disk and ``metrics.jsonl`` has each epoch once; then
    ``--auto-resume`` as 2 ranks ends every epoch, exit 0."""
    import signal

    from segma_tpu_torch import checkpoint

    out = tmp / "runs"
    auto = ["-m", "segma_tpu_torch.cli.auto_train", "-c", str(cfg_path), "--run-id", "R",
            "--output", str(out), "--dist-backend", "gloo"]
    metrics = out / "R" / "metrics.jsonl"
    procs = _ranks(auto, tmp / "cwd_pre", tmp, "preempt")
    t0 = time.perf_counter()
    try:
        while not (metrics.exists() and any("train/loss" in r for r in _records(metrics))):
            if any(p.poll() is not None for p in procs) or time.perf_counter() - t0 > CHILD_WALL_S:
                raise AssertionError("the 2-rank run ended or stalled before epoch 0 ended:\n"
                                     + (tmp / "preempt0.log").read_text()[-3000:])
            time.sleep(0.02)
        procs[1].send_signal(signal.SIGTERM)
    except BaseException:
        for proc in procs:
            proc.kill()
            proc.wait()
        raise
    wall = _wait_ranks(procs, tmp, "preempt", 75)
    last = out / "R" / "checkpoints" / "last"
    epoch = checkpoint.load_meta(last).get("epoch")
    stopped = [(r["preempted_at_epoch"], r["epoch_completed"]) for r in _records(metrics)
               if "preempted_at_epoch" in r]
    epochs = [r["epoch"] for r in _epochs(_records(metrics))]
    if epoch is None or len(stopped) != 1 or epochs != sorted(set(epochs)):
        raise AssertionError(f"preempted world: last/ epoch {epoch}, stops {stopped}, epochs "
                             f"{epochs}")
    procs = _ranks([*auto, "--auto-resume"], tmp / "cwd_res", tmp, "resume")
    wall_resume = _wait_ranks(procs, tmp, "resume", 0)
    epochs = [r["epoch"] for r in _epochs(_records(metrics))]
    if epochs[-1] != PARALLEL_CLI_EPOCHS - 1 or checkpoint.load_meta(last).get(
            "epoch") != PARALLEL_CLI_EPOCHS - 1:
        raise AssertionError(f"resumed world: epochs {epochs}")
    print(f"check parallel train SIGTERM [{card}]: rank 1 signalled, both ranks exit 75 "
          f"(stop {stopped[0]}), last/ at epoch {epoch} by rank 0; --auto-resume as 2 ranks "
          f"exit 0 through epoch {epochs[-1]} (logged epochs {epochs}); walls {wall:.1f} s and "
          f"{wall_resume:.1f} s", flush=True)


def phase_parallel(card: str) -> dict:
    """Data parallelism on the one card (bf16 unless said):

    1. serving (``_serve_paths``): full-width Whisper-base ``surgical_hydra``
       at inner batch 64 over the serving slice's WAV through
       ``run_inference_on_audios`` with ``mesh="off"``, ``"auto"`` (one card:
       no mesh) and a mesh of two replicas on cuda:0 (a thread and a stream
       each, the windows split in two halves of two inner batches): logits
       and RTTMs bit-equal to off's, launches equal (auto) or equal in total
       (two replicas); the walls of the three, which on one card measure the
       split and gather, not scaling; then one request to ``serve_forever``
       over the two-replica mesh (``_serve_request``);
    2. an NCCL world of one (``_nccl_world_of_one``): seeded one-epoch fits
       of HuBERT-base bit-equal to the meshless fit, step and epoch dispatch;
    3. a 2-rank gloo world on cuda:0 in child processes, HuBERT-base widths
       at PARALLEL_LAYERS layers: one f32 step against one process's
       global-batch step (``_world_step``), and the train CLI preempted by a
       SIGTERM to one rank and resumed (``_gloo_preemption``).

    Returns the launch counts by path."""
    import dataclasses

    import torch

    from segma_tpu_torch.parallel import auto_mesh, make_mesh, replicate

    paths: dict[str, dict] = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cfg, model, wav_dir, audio_s, n_chunks = _serving_wav(tmp)
        two = make_mesh(devices=list(PARALLEL_REPLICAS))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        replicate(model, two)
        torch.cuda.synchronize()
        copy_s = time.perf_counter() - t0
        auto = auto_mesh(cfg, torch.device("cuda"))
        serve = _serve_paths(
            card, cfg, model, wav_dir, tmp / "serve", audio_s,
            {"off": ("off", True),
             "auto": ("auto", _whole_batches(n_chunks, 1 if auto is None else auto.shape["data"])),
             "2 replicas": (two, _whole_batches(n_chunks, 2))},
            "one card: the split and gather's cost, not a scaling figure; the two-replica "
            f"run includes copying the model for its second replica, {copy_s:.4f} s alone")
        paths.update({f"parallel serve {k}": v for k, v in serve.items()})
        paths["parallel serve request"] = _serve_request(card, cfg, model, tmp, two,
                                                         "2 replicas on cuda:0")
        del model
        torch.cuda.empty_cache()

        paths.update({f"parallel train {k}": v
                      for k, v in _nccl_world_of_one(card, tmp / "nccl").items()})

        gloo = tmp / "gloo"
        gloo.mkdir()
        write_hubert_snapshot(gloo / "hubert4", seed=16,
                              dims=dict(HUBERT_BASE, num_hidden_layers=PARALLEL_LAYERS))
        root = tmp / "nccl" / "data"
        cfg = surgical_hubert_hydra_config(root, precision="f32")
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, config=dataclasses.replace(cfg.model.config,
                                                  wav_encoder=str(gloo / "hubert4"))))
        _world_step(card, cfg, write_config(gloo / "step.json", cfg), gloo)
        cli_cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, precision="bf16", max_epochs=PARALLEL_CLI_EPOCHS, data_cache="host"))
        _gloo_preemption(card, write_config(gloo / "cli.json", cli_cfg), gloo)
    return paths


def _cards_fits(card: str, cfg_path: Path, tmp: Path, n: int) -> None:
    """``cli.auto_train`` run plainly with ``n`` visible cards: it starts
    one NCCL rank per card. Three runs of PARALLEL_CLI_EPOCHS epochs: step
    dispatch (A), epoch dispatch (the all-reduce captured in the graph), and
    step dispatch with SIGTERM sent to the command once epoch 0 is logged
    (every rank exits 75), then ``--auto-resume`` (exit 0); ``last/`` of the
    second and the fourth bit-equal to A's."""
    import signal

    out = tmp / "runs"
    base = ["-m", "segma_tpu_torch.cli.auto_train", "-c", str(cfg_path), "--output", str(out)]
    walls = {}

    def run(label: str, run_id: str, *extra: str, want: int = 0, signal_after: bool = False):
        log = tmp / f"{label}.log"
        proc = _child([*base, "--run-id", run_id, *extra], tmp / f"cwd_{label}", log)
        metrics = out / run_id / "metrics.jsonl"
        t0 = time.perf_counter()
        try:
            while signal_after and not (metrics.exists() and any(
                    "train/loss" in r for r in _records(metrics))):
                if proc.poll() is not None or time.perf_counter() - t0 > CHILD_WALL_S:
                    raise AssertionError(f"{label}: ended or stalled before epoch 0 ended:\n"
                                         + log.read_text()[-3000:])
                time.sleep(0.02)
            if signal_after:
                proc.send_signal(signal.SIGTERM)
            walls[label] = _wait(proc, log, label, want)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        return log.read_text()

    log_a = run("step", "A")
    if f"{n} cards visible" not in log_a or f"ranks exited with {[0] * n}" not in log_a:
        raise AssertionError(f"cli.auto_train did not start {n} ranks:\n{log_a[-3000:]}")
    run("epoch", "E", "train.dispatch=epoch")
    log_p = run("preempted", "P", want=75, signal_after=True)
    if f"ranks exited with {[75] * n}" not in log_p:
        raise AssertionError(f"SIGTERM: not every rank exited 75:\n{log_p[-3000:]}")
    run("resumed", "P", "--auto-resume")
    ref = (out / "A" / "checkpoints" / "last" / "params.msgpack").read_bytes()
    for run_id, what in (("E", "epoch dispatch"), ("P", "the preempted and resumed run")):
        if (out / run_id / "checkpoints" / "last" / "params.msgpack").read_bytes() != ref:
            raise AssertionError(f"{n} cards: {what} ends on other weights than step dispatch")
    epochs = [r["epoch"] for r in _epochs(_records(out / "A" / "metrics.jsonl"))]
    print(f"check parallel train {n} cards [{card}]: cli.auto_train started {n} NCCL ranks, "
          f"one per card, epochs {epochs} logged once; epoch dispatch and a run preempted by "
          f"SIGTERM (every rank exit 75) then --auto-resume end bit-equal to step dispatch; "
          "walls " + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()), flush=True)


TENSOR_SEQ_MESHES = ((1, 1, 2), (1, 2, 1), (1, 2, 2), (1, 4, 1), (2, 2, 2))  # (data, seq, model)
TENSOR_SEQ_F32_MESH = (1, 2, 2)
# over four cards (phase_parallel_cards)
TENSOR_SEQ_CARD_MESHES = ((1, 2, 2), (1, 4, 1), (1, 1, 4), (2, 1, 2), (2, 2, 1))
TENSOR_SEQ_FAMILY_S = 400.0  # HuBERT-base and WavLM-base at model=2: 100 chunks of 4 s
# the flash forward at a seq member's shapes (B, Sq, Skv, H): Whisper-base's
# 1500 positions over seq 2 and, at model 2, over seq 4; fast_context's 200
# over seq 2; a query block that is not a multiple of 64 rows; and the shapes
# of TENSOR_SEQ_MESHES' members not among those: (1,2,2) and (2,2,2) give
# (750 | 1500, 4), (1,4,1) (375 | 1500, 8)
FLASH_UNEQUAL_SHAPES = ((INNER_BATCH, 750, 1500, 8), (INNER_BATCH, 375, 1500, 4),
                        (INNER_BATCH, 100, 200, 8), (INNER_BATCH, 333, 1500, 8),
                        (INNER_BATCH, 750, 1500, 4), (INNER_BATCH, 375, 1500, 8))


def flash_unequal_checks(card: str) -> dict:
    """The bf16 and the f32 forward at FLASH_UNEQUAL_SHAPES: the output
    against ``attention_plain`` (bf16 at FLASH_ATOL and FLASH_RTOL, f32 at
    FLASH_F32_ATOL) and the LSE against ``attention_lse_plain``; timed in
    turns beside every SDPA backend that takes the shape, and the plain
    version; bounds for the work of Sq x Skv: bf16 products at the
    tensor-core peak or Sq Skv exp2 on the special-function units, f32 as
    3xTF32 at the TF32 peak. Returns {kernel name: {shape: row}}."""
    import torch

    from segma_tpu_torch.ops import attention

    g = torch.Generator(device="cuda").manual_seed(17)
    sm = 64**-0.5
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    clock = max_sm_clock_hz()
    out_rows: dict[str, dict] = {"flash_attn_fwd": {}, "flash_attn_fwd_f32": {}}
    for dtype, name in ((torch.bfloat16, "flash_attn_fwd"), (torch.float32, "flash_attn_fwd_f32")):
        f32 = dtype == torch.float32
        for b, sq, skv, h in FLASH_UNEQUAL_SHAPES:
            label = f"({b}, {sq} | {skv}, {h}, 64)"
            q = torch.randn((b, sq, h, 64), device="cuda", generator=g).to(dtype)
            k, v = (torch.randn((b, skv, h, 64), device="cuda", generator=g).to(dtype)
                    for _ in range(2))
            out, lse = attention.flash_attn_fwd(q, k, v, sm, with_lse=True)
            err = check_close(f"{name} {label}", out,
                              attention.attention_plain(q, k, v, sm, torch.float32),
                              FLASH_F32_ATOL if f32 else FLASH_ATOL, 0.0 if f32 else FLASH_RTOL)
            check_close(f"{name} lse {label}", lse, attention.attention_lse_plain(q, k, sm),
                        LSE_F32_ATOL if f32 else LSE_ATOL)
            if not torch.equal(out, attention.flash_attn_fwd(q, k, v, sm)):
                raise AssertionError(f"{name} {label}: output differs without the LSE")
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            times = time_turns({"kernel": lambda: attention.flash_attn_fwd(q, k, v, sm),
                                **sdpa_calls(qt, kt, vt, sm)}, groups=3, iters=10)
            ms = median(times.pop("kernel"))
            library = {n: median(t) for n, t in times.items()}
            plain_ms = time_ms(lambda: attention.attention_plain(q, k, v, sm, dtype), iters=2)
            flops = 4 * b * h * sq * skv * 64
            n_bytes = 2 * (sq + skv) * b * h * 64 * q.element_size()
            if f32:
                bms, by = bound_ms(3 * flops, PEAK_TF32_FLOPS, n_bytes)
            else:
                bms, by = bound_ms(flops, PEAK_BF16_FLOPS, n_bytes)
                exp_ms = b * h * sq * skv / (EXP2_PER_SM_CLOCK * n_sm * clock) * 1e3
                bms, by = max((bms, by), (exp_ms, "operations"))
            out_rows[name][label] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                "library_ms": min(library.values()) if library else None,
                "library_backends_ms": library, "max_abs_err": err}
            print(f"time {name} {label} [{card}]: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
                  f"bound {bms:.4f} ms ({by}), sdpa " + ", ".join(
                      f"{n[5:]} {t:.4f} ms" for n, t in library.items()), flush=True)
            del q, k, v, qt, kt, vt, out, lse
            torch.cuda.empty_cache()
    return out_rows


def _train_precision(cfg, precision: str):
    """``cfg`` with train.precision ``precision`` (the encoder models' dtype)."""
    import dataclasses

    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, precision=precision))


def _one_card_mesh(shape: tuple[int, int, int], device: str = "cuda:0"):
    from segma_tpu_torch.parallel import make_mesh

    data, seq, model = shape
    return make_mesh(devices=[device] * (data * seq * model), data=data, seq=seq, model=model)


def _two_chunks(pcm: np.ndarray):
    """The first two 4 s chunks of an int16 waveform, as f32 in [-1, 1)."""
    import torch

    return torch.from_numpy(pcm[: 2 * 64_000].reshape(2, 64_000).astype(np.float32) / 32768)


def _bf16_limit(name: str, cfg, chunks) -> float:
    """The card's bf16 rule for a mesh run against the meshless one:
    LOGITS_BF16_FACTOR times the CPU's bf16 distance from its f32 model on
    ``chunks`` (same seed-0 weights), or LOGITS_ATOL."""
    import warnings

    import torch

    from segma_tpu_torch.models import Models
    from segma_tpu_torch.utils.encoders import MultiLabelEncoder

    out = {}
    for precision in ("bf16", "f32"):
        c = _train_precision(cfg, precision)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # random encoder weights, on purpose
            m = Models[name](MultiLabelEncoder(c.data.classes), c, device="cpu",
                             generator=torch.Generator().manual_seed(0))
        out[precision] = m.apply(chunks).double()
    cpu_off = float((out["bf16"] - out["f32"]).abs().max())
    limit = max(LOGITS_ATOL, LOGITS_BF16_FACTOR * cpu_off)
    print(f"tensor_seq {name}: the CPU's bf16 logits are {cpu_off:.3e} from its f32 model on "
          f"{len(chunks)} chunks: the card's rule allows {limit:.3e}", flush=True)
    return limit


def _mesh_serving(card: str, label: str, model, wav: Path, out: Path, meshes, limit: float,
                  keys: tuple[str, ...], atol_scale: bool = False,
                  mesh_of=_one_card_mesh) -> dict:
    """``model`` over the WAV meshless and over each of ``meshes`` (the
    (data, seq, model) shapes ``mesh_of`` places: by default every member on
    one card): each mesh's logits within ``limit`` of the meshless ones
    (times max(1, max|logit|) with ``atol_scale``), its RTTM the meshless
    one except where the meshless logit lies within ``limit`` of the
    threshold, every member of a coordinate ending in the same bits on a
    batch of windows, its launches of ``keys`` (the kernels of the model's
    path, each launched) the meshless run's times seq x model. Returns the
    launch counts by mesh."""
    import torch

    from segma_tpu_torch.inference import InferencePipeline, infer_file
    from segma_tpu_torch.parallel.collectives import run_members

    labels = list(model.config.data.classes)

    def serve(mesh, tag: str):
        pipe = InferencePipeline(model, batch_size=INNER_BATCH, device="cuda", mesh=mesh)
        infer_file(wav, pipe, out / f"{tag}_warm")
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        infer_file(wav, pipe, out / tag, dump_logits=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        logits = np.load(out / tag / "logits" / f"{wav.stem}-logits_dict_t.npz")
        logits = np.stack([logits[k] for k in labels], axis=1)
        rttm = _rttm_mask(out / tag / "raw_rttm" / f"{wav.stem}.rttm", labels, len(logits))
        return pipe, wall, launches, logits, rttm

    _, wall0, ref_launches, ref, ref_rttm = serve(None, "meshless")
    _launched(ref_launches, keys, f"tensor_seq {label} meshless")
    tol = limit * (max(1.0, float(np.abs(ref).max())) if atol_scale else 1.0)
    paths, walls = {}, {"meshless": wall0}
    for shape in meshes:
        tag = "x".join(map(str, shape))
        pipe, walls[tag], launches, logits, rttm = serve(mesh_of(shape), tag)
        per = shape[1] * shape[2]
        want = {k: ref_launches[k] * per for k in ref_launches}
        if launches != want:
            raise AssertionError(f"tensor_seq {label} {tag}: launches {launches}, want {want}")
        err = check_close(f"tensor_seq {label} {tag} logits against meshless",
                          torch.from_numpy(logits), torch.from_numpy(ref), tol)
        diff = rttm != ref_rttm
        far = diff & (np.abs(ref) > tol)
        if far.any():
            raise AssertionError(f"tensor_seq {label} {tag}: {int(far.sum())} RTTM frames "
                                 f"differ from meshless away from the threshold")
        chunks = torch.randn((INNER_BATCH, model.config.audio.chunk_duration_f),
                             generator=torch.Generator().manual_seed(3)).mul_(0.1)
        for i in range(shape[0]):
            members = list(pipe.members[i].flat)
            got = run_members(pipe._pool, [lambda m=m: m.apply(chunks.to(m.device)).cpu()
                                           for m in members], pipe._groups)
            if not all(torch.equal(x, got[0]) for x in got[1:]):
                raise AssertionError(f"tensor_seq {label} {tag}: the members of data "
                                     f"coordinate {i} end in different bits")
        paths[f"tensor_seq {label} {tag}"] = launches
        print(f"check tensor_seq {label} {tag} [{card}]: logits {err:.3e} from meshless "
              f"(limit {tol:.3e}), {int(diff.sum())} RTTM frames differ, all near the "
              f"threshold; {pipe.members.size} members bit-identical within each coordinate; "
              f"launches {launches}", flush=True)
        del pipe
        torch.cuda.empty_cache()
    audio_s = len(ref) * 0.02
    print(f"tensor_seq {label} walls [{card}] over {audio_s:.1f} s of audio, one run each "
          "after a warm-up (not a scaling figure): " + ", ".join(
              f"{k} {v:.4f} s" for k, v in walls.items()), flush=True)
    return paths


def phase_tensor_seq(card: str) -> dict:
    """Tensor and sequence parallelism in serving on the one card, every
    member of a mesh naming cuda:0 (a thread and a stream each):

    1. the serving slice (full-width Whisper-base ``surgical_hydra``, bf16,
       seed-0 weights, the ~600 s WAV, inner batch 64) meshless and over each
       of TENSOR_SEQ_MESHES (``_mesh_serving``: logits within the card's bf16
       rule of meshless, RTTMs equal but near the threshold, members
       bit-identical, launches seq x model times meshless);
    2. the same in f32 at TENSOR_SEQ_F32_MESH, within LOGITS_F32_ATOL x
       max(1, max|logit|) of the meshless f32 run;
    3. HuBERT-base and WavLM-base (bf16) at model=2 over TENSOR_SEQ_FAMILY_S
       seconds.

    Returns the launch counts by path. The flash forward at a seq member's
    unequal lengths is checked and timed by ``flash_unequal_checks``."""
    import dataclasses
    import warnings

    import torch

    from segma_tpu_torch.inference import _load_mono
    from segma_tpu_torch.models import Models
    from segma_tpu_torch.utils.encoders import MultiLabelEncoder

    paths: dict[str, dict] = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cfg, model, wav_dir, _, _ = _serving_wav(tmp)
        wav = wav_dir / "smoke.wav"
        chunks = _two_chunks(_load_mono(wav))
        limit = _bf16_limit("surgical_hydra", cfg, chunks)
        paths.update(_mesh_serving(card, "surgical_hydra", model, wav, tmp / "bf16",
                                   TENSOR_SEQ_MESHES, limit, SERVE_LAUNCH_KEYS))
        del model
        cfg32 = _train_precision(cfg, "f32")
        model = Models["surgical_hydra"](MultiLabelEncoder(cfg32.data.classes), cfg32,
                                         device="cuda", generator=torch.Generator().manual_seed(0))
        paths.update(_mesh_serving(card, "surgical_hydra f32", model, wav, tmp / "f32",
                                   (TENSOR_SEQ_F32_MESH,), LOGITS_F32_ATOL,
                                   ("logmel", "flash_attn_fwd_f32"), atol_scale=True))
        del model
        torch.cuda.empty_cache()
        fam_wav = tmp / "family.wav"
        write_wav(fam_wav, int(TENSOR_SEQ_FAMILY_S * 16_000), seed=7)
        fam_chunks = _two_chunks(_load_mono(fam_wav))
        for name in ("surgical_hubert_hydra", "surgical_wavlm_hydra"):
            if name == "surgical_hubert_hydra":
                fcfg = surgical_hubert_hydra_config(Path("data/baby_train"))
            else:
                fcfg = family_config(name, "data/baby_train")
            fcfg = dataclasses.replace(fcfg, model=dataclasses.replace(
                fcfg.model, config=dataclasses.replace(fcfg.model.config,
                                                       wav_encoder=f"{name}_random")))
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # random encoder weights, on purpose
                fmodel = Models[name](MultiLabelEncoder(fcfg.data.classes), fcfg, device="cuda",
                                      generator=torch.Generator().manual_seed(0))
            flimit = _bf16_limit(name, fcfg, fam_chunks)
            # WavLM's gated-bias attention serves through its own kernel
            keys = (("flash_attn_fwd",) if name == "surgical_hubert_hydra"
                    else ("wavlm_attn_fwd",))
            paths.update(_mesh_serving(card, name, fmodel, fam_wav, tmp / name, ((1, 1, 2),),
                                       flimit, keys))
            del fmodel
            torch.cuda.empty_cache()
    return paths


TRAIN_TP_STEPS = 3  # steps each rank takes; replicated leaves compared after them
TRAIN_TP_BATCH = 32  # the training slice's batch: 32 crops of 4 s
TRAIN_TP_WAV_S = 60.0  # the WAV the gathered checkpoint serves, meshless
TRAIN_TP_LR = 1e-3
# the gates of a training mesh against this process's meshless steps: in
# f32 each step's loss at JAX's rtol and the first step's gradients at the
# CPU tests' pin (max |mesh - meshless| <= 1e-4 x max(1, max |meshless|));
# in bf16 the mesh no further from the meshless bf16 step than
# TRAIN_TP_BF16_FACTOR times the bf16 step is from the f32 step on the same
# weights and batch (each step's loss against the largest such distance up
# to that step; each leaf's gradient in the L2 norm, plus the f32 pin)
TRAIN_TP_F32_RTOL = 1e-5
TRAIN_TP_GRAD_ATOL = 1e-4
TRAIN_TP_BF16_FACTOR = 3.0
# (label, model, precision, (data, seq, model)) of each world on the one card,
# and the four-card worlds (NCCL, one rank per card)
TRAIN_TP_RUNS = (("hubert bf16", "surgical_hubert_hydra", "bf16", (2, 1, 2)),
                 ("whisper bf16", "surgical_hydra", "bf16", (1, 2, 2)),
                 ("hubert f32", "surgical_hubert_hydra", "f32", (1, 1, 2)))
TRAIN_TP_CARD_RUNS = (("hubert bf16", "surgical_hubert_hydra", "bf16", (2, 1, 2)),
                      ("whisper bf16", "surgical_hydra", "bf16", (1, 2, 2)))
# one rank of a training mesh (argv: backend, then a config and an out dir
# for each mesh in turn, one world for all): TRAIN_TP_STEPS steps of
# Trainer.train_step on its data coordinate's block of <out>/batch.npz;
# reports each step's loss, the step walls, its launches, sha256 of each
# replicated parameter after the steps and of the gathered trainable tree,
# where its time went, and over gloo the refusal of a Trainer asked for
# train.dispatch=epoch first; checks that the gathered tree holds its own
# blocks; rank 0 writes the first step's gradients, gathered whole, to
# <out>/grads.pt and the gathered tree as a checkpoint to <out>/ckpt
TENSOR_TRAIN_CHILD = (
    "import time\n"
    "t_start = time.perf_counter()\n"
    "import dataclasses, hashlib, json, sys, warnings\n"
    "import numpy as np, torch\n"
    "import chip_smoke\n"
    "from segma_tpu_torch import checkpoint\n"
    "from segma_tpu_torch.config import load_config\n"
    "from segma_tpu_torch.parallel import distributed\n"
    "from segma_tpu_torch.train import Trainer, deterministic_cudnn\n"
    "backend, runs = sys.argv[1], sys.argv[2:]\n"
    "assert distributed.maybe_init_distributed('cuda', backend=backend)\n"
    "world = distributed.current_world()\n"
    "digest = lambda t: hashlib.sha256(t.float().cpu().numpy().tobytes()).hexdigest()\n"
    "for cfg_path, out in zip(runs[::2], runs[1::2]):\n"
    "    times = {'start': time.perf_counter() - t_start}\n"
    "    t0 = time.perf_counter()\n"
    "    cfg = load_config(cfg_path)\n"
    "    with warnings.catch_warnings():\n"
    "        warnings.simplefilter('ignore')  # random encoder weights, on purpose\n"
    "        model = checkpoint.build_model(cfg, device='cuda')\n"
    "    if hasattr(model.module, 'dropout'):\n"
    "        model.module.dropout = 0.0\n"
    "    times['build'] = time.perf_counter() - t0\n"
    "    refusal = None\n"
    "    if backend == 'gloo':  # epoch dispatch over gloo ranks on a card: refused\n"
    "        epoch = dataclasses.replace(cfg, train=dataclasses.replace(\n"
    "            cfg.train, dispatch='epoch', data_cache='device'))\n"
    "        try:\n"
    "            Trainer(model, epoch, out + '/refused', device='cuda')\n"
    "        except ValueError as e:\n"
    "            refusal = str(e)\n"
    "        assert refusal is not None, 'epoch dispatch over gloo on a card was not refused'\n"
    "    t0 = time.perf_counter()\n"
    "    trainer = Trainer(model, cfg, out + '/run', device='cuda')\n"
    "    del model\n"
    "    times['trainer'] = time.perf_counter() - t0\n"
    "    d, data = trainer.coordinate\n"
    "    b = np.load(out + '/batch.npz')\n"
    "    n = len(b['x']) // data\n"
    "    batch = {k: torch.from_numpy(b[k][d * n:(d + 1) * n]).cuda() for k in ('x', 'y')}\n"
    "    trainer.generator.manual_seed(1)\n"
    "    chip_smoke.reset_launches()\n"
    "    walls, losses = [], []\n"
    "    for _ in range(chip_smoke.TRAIN_TP_STEPS):\n"
    "        torch.cuda.synchronize()\n"
    "        t0 = time.perf_counter()\n"
    "        with deterministic_cudnn(True):  # as a seeded fit runs\n"
    "            loss, per_label = trainer.train_step(batch, trainer.generator)\n"
    "        torch.cuda.synchronize()\n"
    "        walls.append(time.perf_counter() - t0)\n"
    "        losses.append(float(loss))\n"
    "        if len(losses) == 1:  # the first step's gradients, whole (a collective)\n"
    "            grads = trainer.blocks.gather({k: p.grad.detach() for k, p in\n"
    "                                           trainer.model.module.named_parameters()\n"
    "                                           if p.requires_grad and p.grad is not None})\n"
    "            if world.rank == 0:\n"
    "                torch.save({k: v.float().cpu() for k, v in grads.items()}, out + '/grads.pt')\n"
    "            del grads\n"
    "    launches = chip_smoke.read_launches()\n"
    "    t0 = time.perf_counter()\n"
    "    member = trainer.model.module\n"
    "    named = {k: p.detach() for k, p in member.named_parameters() if p.requires_grad}\n"
    "    whole = trainer.blocks.gather(named)\n"
    "    g = trainer.blocks.group\n"
    "    for k, dim in trainer.blocks.dims.items():\n"
    "        if k in named:\n"
    "            w = named[k].shape[dim]\n"
    "            assert torch.equal(whole[k].narrow(dim, g.rank * w, w), named[k]), k\n"
    "    tree = checkpoint.flax_split(trainer.model, trainer.blocks)[0]\n"
    "    if world.rank == 0:\n"
    "        checkpoint.save_params(out + '/ckpt', tree, {'epoch': 0, 'frozen_fingerprint':\n"
    "                               trainer.frozen_fp})\n"
    "    times['trees'] = time.perf_counter() - t0\n"
    "    report = {'rank': world.rank, 'coordinate': list(trainer.mesh.coordinate),\n"
    "              'losses': losses, 'walls': walls, 'launches': launches, 'times': times,\n"
    "              'sharded': sorted(trainer.blocks.dims),\n"
    "              'replicated': {k: digest(v) for k, v in named.items()\n"
    "                             if k not in trainer.blocks.dims},\n"
    "              'whole': {k: digest(v) for k, v in whole.items()},\n"
    "              'peak_gb': torch.cuda.max_memory_allocated() / 1e9, 'refusal': refusal}\n"
    "    open(f'{out}/rank{world.rank}.json', 'w').write(json.dumps(report))\n"
    "    del trainer, member, named, whole, tree\n"
    "    torch.cuda.empty_cache()\n"
    "    torch.cuda.reset_peak_memory_stats()\n"
    "distributed.destroy()\n"
)


def _train_tp_config(name: str, precision: str, shape: tuple[int, int, int], tmp: Path):
    """The training slice's HuBERT-base config, or the serving slice's
    Whisper-base one, at ``precision`` over the mesh ``shape``."""
    import dataclasses

    from segma_tpu_torch.config import MeshConfig

    if name == "surgical_hubert_hydra":
        cfg = surgical_hubert_hydra_config(tmp / "data", precision=precision)
    else:
        cfg = _train_precision(surgical_hydra_config(), precision)
    d, s, m = shape
    return dataclasses.replace(cfg, mesh=MeshConfig(data=d, seq=s, model=m),
                               train=dataclasses.replace(cfg.train, lr=TRAIN_TP_LR, seed=0))


def _train_tp_meshless(cfg, batch: dict) -> dict:
    """This process's meshless steps over the whole batch from the same
    seed-0 weights: each step's loss, the first step's gradients (on the
    host, f32), the walls, the launches."""
    import warnings

    import torch

    from segma_tpu_torch import checkpoint
    from segma_tpu_torch.train import deterministic_cudnn, make_optimizer, make_train_step

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # random encoder weights, on purpose
        model = checkpoint.build_model(cfg, device="cuda")
    if hasattr(model.module, "dropout"):
        model.module.dropout = 0.0
    step = make_train_step(model, make_optimizer(model, cfg.train.lr))
    gen = torch.Generator("cuda").manual_seed(1)
    x = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    walls, losses = [], []
    reset_launches()
    for _ in range(TRAIN_TP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with deterministic_cudnn(True):
            loss, _ = step(x, gen)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(loss))
        if len(losses) == 1:
            grads = {k: p.grad.detach().float().cpu() for k, p in model.module.named_parameters()
                     if p.requires_grad and p.grad is not None}
    out = {"losses": losses, "grads": grads, "walls": walls, "launches": read_launches(),
           "n_layers": sum(1 for m in model.module.modules()
                           if type(m).__name__ in ("HubertTransformerLayer", "EncoderLayer"))}
    del model
    torch.cuda.empty_cache()
    return out


def _start_tp_world(runs, tmp: Path, backend: str = "gloo", own_cards: bool = False) -> dict:
    """The training meshes ``runs`` ((label, model, precision, shape), all of
    one size), one after the other in one world of ``TENSOR_TRAIN_CHILD``
    ranks (gloo ranks on cuda:0, or NCCL ranks on cards of their own):
    write each mesh's config and batch, and start the world's ranks."""
    n = int(np.prod(runs[0][3]))
    args, prepared = [backend], []
    for label, name, precision, shape in runs:
        out = tmp / label.replace(" ", "_")
        out.mkdir(parents=True)
        cfg = _train_tp_config(name, precision, shape, tmp)
        if name == "surgical_hubert_hydra":
            from segma_tpu_torch.models.hubert.builders import HUBERT_CONV_SETTINGS as conv
        else:
            from segma_tpu_torch.models.whisper.builders import WHISPER_CONV_SETTINGS as conv
        n_windows = conv.n_windows(cfg.audio.chunk_duration_f, strict=cfg.audio.strict_frames)
        rng = np.random.default_rng(29)
        t = np.arange(64_000) / 16_000
        x = (0.1 * rng.standard_normal((TRAIN_TP_BATCH, 64_000))
             + 0.3 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)
        y = (rng.random((TRAIN_TP_BATCH, n_windows, len(TRAIN_CLASSES))) > 0.6).astype(
            np.float32)
        np.savez(out / "batch.npz", x=x, y=y)
        args += [str(write_config(out / "cfg.json", cfg)), str(out)]
        prepared.append((label, name, precision, shape, out, cfg, {"x": x, "y": y}))
    tag = f"tp_world{n}_{backend}"
    where = f"cuda:0 to cuda:{n - 1}" if own_cards else "cuda:0"
    return {"procs": _ranks(["-c", TENSOR_TRAIN_CHILD, *args], tmp / f"cwd_{tag}", tmp, tag, n,
                            own_cards),
            "t0": time.perf_counter(), "tmp": tmp, "tag": tag, "n": n, "backend": backend,
            "where": where, "prepared": prepared}


def _join_tp_world(card: str, world: dict) -> None:
    """Wait for a world's ranks (once): each must exit 0."""
    if "wall" in world:
        return
    _wait_ranks(world["procs"], world["tmp"], world["tag"], 0)
    world["wall"] = time.perf_counter() - world["t0"]
    print(f"train tensor_seq [{card}]: a world of {world['n']} {world['backend']} ranks on "
          f"{world['where']} ran {[p[0] for p in world['prepared']]}, ended within "
          f"{world['wall']:.1f} s of its start", flush=True)


def _tp_meshless(refs: dict, cfg, name: str, precision: str, batch: dict) -> dict:
    """``_train_tp_meshless`` at ``precision``, once per (model, precision)
    in ``refs``."""
    import torch

    if (name, precision) not in refs:
        refs[name, precision] = _train_tp_meshless(_train_precision(cfg, precision), batch)
        torch.cuda.empty_cache()
    return refs[name, precision]


def _tp_gradient_gate(label: str, precision: str, got: dict, ref: dict, ref32: dict) -> str:
    """The first step's gradients of a mesh (gathered whole) against the
    meshless step's, leaf by leaf (TRAIN_TP_GRAD_ATOL in f32; in bf16 the L2
    norm against TRAIN_TP_BF16_FACTOR times the bf16 step's own distance from
    the f32 step, plus the f32 pin). Returns a summary; raises naming the
    leaves that miss."""
    import torch

    if set(got) != set(ref):
        raise AssertionError(f"train tensor_seq {label}: gradients of {sorted(set(got) ^ set(ref))[:5]} "
                             f"on one side only")
    norm = lambda t: float(torch.linalg.vector_norm(t.double()))  # noqa: E731
    err, lim = {}, {}
    for k, g in ref.items():
        pin = TRAIN_TP_GRAD_ATOL * max(1.0, float(ref32[k].abs().max()))
        if precision == "f32":
            err[k], lim[k] = float((got[k] - g).abs().max()), pin
        else:
            err[k] = norm(got[k] - g)
            lim[k] = TRAIN_TP_BF16_FACTOR * norm(g - ref32[k]) + pin
    bad = [k for k in ref if not err[k] <= lim[k]]
    if bad:
        raise AssertionError(f"train tensor_seq {label}: first-step gradients off the meshless "
                             f"step's at {len(bad)} leaves: "
                             + ", ".join(f"{k} {err[k]:.3e} > {lim[k]:.3e}" for k in bad[:5]))
    worst = max(ref, key=lambda k: err[k] / lim[k])
    kind = "max abs" if precision == "f32" else "L2"
    # the gate's reach: where the meshless gradient itself is within the
    # limit, a gradient doubled (a sum where a block was due) would pass
    size = {k: float(g.abs().max()) if precision == "f32" else norm(g) for k, g in ref.items()}
    blind = [k for k in ref if size[k] <= lim[k]]
    return (f"first-step gradients of {len(ref)} leaves within their limits ({kind}; worst "
            f"{worst} {err[worst]:.3e} of {lim[worst]:.3e}); a doubled gradient would pass at "
            f"{len(blind)} leaves" + (f" ({', '.join(blind[:4])}"
                                     + (", ..." if len(blind) > 4 else "") + ")" if blind else ""))


def _tp_loss_limits(precision: str, ref: dict, ref32: dict) -> tuple[list[float], str]:
    """Each step's limit on |mesh loss - meshless loss|: f32 at
    TRAIN_TP_F32_RTOL; bf16 TRAIN_TP_BF16_FACTOR times the largest distance
    of the bf16 meshless losses from the f32 ones up to that step (the
    trajectories part as the steps go)."""
    if precision == "f32":
        return [TRAIN_TP_F32_RTOL * abs(x) for x in ref["losses"]], f"rtol {TRAIN_TP_F32_RTOL}"
    yard = np.maximum.accumulate([abs(a - b) for a, b in zip(ref["losses"], ref32["losses"])])
    return ([TRAIN_TP_BF16_FACTOR * float(y) for y in yard],
            f"{TRAIN_TP_BF16_FACTOR} x the bf16 meshless losses' distance from the f32 ones, "
            + ", ".join(f"{y:.3e}" for y in yard))


def _finish_tp_world(card: str, world: dict, refs: dict | None = None) -> dict:
    """Wait for a world of ``_start_tp_world``, then hold each of its meshes
    to this process's meshless steps (cached in ``refs`` by model and
    precision). Gates: each step's loss (``_tp_loss_limits``); the first
    step's gradients
    (``_tp_gradient_gate``); every replicated leaf and the gathered tree the
    same bits on every rank (each rank checked its own blocks in it); flash
    backward launches per rank = layers x steps; launches on every rank.
    Returns, by label, the launch counts summed over the ranks, the first
    rank's checkpoint and the config."""
    import torch

    refs = {} if refs is None else refs
    n, backend, where, prepared = world["n"], world["backend"], world["where"], world["prepared"]
    _join_tp_world(card, world)
    results = {}
    for label, name, precision, shape, out, cfg, batch in prepared:
        ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(n)]
        ref = _tp_meshless(refs, cfg, name, precision, batch)
        ref32 = _tp_meshless(refs, cfg, name, "f32", batch)
        steps = range(TRAIN_TP_STEPS)
        d_loss = [max(abs(r["losses"][i] - ref["losses"][i]) for r in ranks) for i in steps]
        limits, rule = _tp_loss_limits(precision, ref, ref32)
        for i in steps:
            if not d_loss[i] <= limits[i]:
                raise AssertionError(f"train tensor_seq {label}: step {i + 1}'s loss "
                                     f"{ranks[0]['losses'][i]} against meshless "
                                     f"{ref['losses'][i]}: {d_loss[i]:.3e} > {limits[i]:.3e}")
        grads = _tp_gradient_gate(label, precision, torch.load(out / "grads.pt"), ref["grads"],
                                  ref32["grads"])
        for r, rep in enumerate(ranks):
            if tuple(rep["coordinate"]) != tuple(int(c) for c in np.unravel_index(r, shape)):
                raise AssertionError(f"train tensor_seq {label}: rank {r} at "
                                     f"{rep['coordinate']}")
            for key in ("replicated", "whole"):
                if rep[key] != ranks[0][key]:
                    bad = [k for k in rep[key] if rep[key][k] != ranks[0][key].get(k)]
                    raise AssertionError(f"train tensor_seq {label}: rank {r}'s {key} leaves "
                                         f"differ from rank 0's: {bad[:5]}")
        bwd = "flash_attn_bwd" if precision == "bf16" else "flash_attn_bwd_f32"
        want_bwd = ref["n_layers"] * TRAIN_TP_STEPS if name == "surgical_hubert_hydra" else 0
        for r, rep in enumerate(ranks):
            if rep["launches"][bwd] != want_bwd or rep["launches"][bwd] != ref["launches"][bwd]:
                raise AssertionError(f"train tensor_seq {label}: rank {r} launched {bwd} "
                                     f"{rep['launches'][bwd]} times, not {want_bwd}")
        keys = (("flash_attn_fwd", "flash_attn_bwd") if name == "surgical_hubert_hydra"
                else ("logmel", "flash_attn_fwd"))
        if precision == "f32":
            keys = tuple(k + "_f32" if k.startswith("flash") else k for k in keys)
        for rep in ranks:
            _launched(rep["launches"], keys, f"train tensor_seq {label} rank {rep['rank']}")
        if backend == "gloo":  # epoch dispatch refused on every rank, saying why
            from segma_tpu_torch.parallel.mesh import EPOCH_GLOO_CARD

            for rep in ranks:
                if EPOCH_GLOO_CARD not in (rep["refusal"] or ""):
                    raise AssertionError(f"train tensor_seq {label} rank {rep['rank']}: "
                                         f"refusal {rep['refusal']!r}")
            print(f"check train tensor_seq {label} refusal [{card}]: train.dispatch=epoch over "
                  f"{n} gloo ranks on {where} refused by each rank's Trainer before any work: "
                  f"{ranks[0]['refusal']}", flush=True)
        warm = float(np.median([w for rep in ranks for w in rep["walls"][1:]]))
        warm_ref = float(np.median(ref["walls"][1:]))
        times = {k: max(rep["times"][k] for rep in ranks) for k in ranks[0]["times"]}
        print(f"check train tensor_seq {label} [{card}]: {n} {backend} ranks on {where} at "
              f"(data, seq, model) {shape}, {TRAIN_TP_BATCH} crops of 4 s: losses "
              + ", ".join(f"{x:.6f}" for x in ranks[0]["losses"]) + " against meshless "
              + ", ".join(f"{x:.6f}" for x in ref["losses"]) + " (off by "
              + ", ".join(f"{x:.3e}" for x in d_loss) + "; limits "
              + ", ".join(f"{x:.3e}" for x in limits) + f", {rule}); "
              f"{grads}; {len(ranks[0]['replicated'])} replicated and "
              f"{len(ranks[0]['whole'])} gathered leaves the same bits on every rank after "
              f"{TRAIN_TP_STEPS} steps ({len(ranks[0]['sharded'])} sharded entries, each rank's "
              f"blocks in the gathered tree); {bwd} {ranks[0]['launches'][bwd]} per rank; warm "
              f"step {warm * 1e3:.1f} ms (median over ranks; steps "
              + ", ".join(f"{w * 1e3:.1f}" for w in ranks[0]["walls"])
              + f" ms on rank 0) against meshless {warm_ref * 1e3:.1f} ms; peak "
              f"{max(r['peak_gb'] for r in ranks):.2f} GB a rank; slowest rank's seconds: "
              + ", ".join(f"{k} {v:.1f}" for k, v in times.items()), flush=True)
        results[label] = {"launches": {k: sum(rep["launches"][k] for rep in ranks)
                                       for k in ranks[0]["launches"]},
                          "ckpt": out / "ckpt", "cfg": cfg}
    return results


def _serve_gathered(card: str, label: str, cfg, ckpt: Path, tmp: Path,
                    kernel: str = "flash_attn_fwd") -> dict:
    """A mesh's gathered checkpoint served meshless: ``load_model_for_inference``
    (the frozen fingerprint checked), its trainable tree bit-equal to the
    file's, TRAIN_TP_WAV_S seconds served with finite logits, ``kernel``
    launched. Returns the serving run's launches."""
    import dataclasses

    import torch

    from segma_tpu_torch import checkpoint
    from segma_tpu_torch.inference import InferencePipeline, _load_mono

    cfg = dataclasses.replace(cfg, mesh=dataclasses.replace(cfg.mesh, data=-1, seq=1, model=1))
    model = checkpoint.load_model_for_inference(cfg, ckpt, device="cuda")
    tree = checkpoint.load_params(ckpt, checkpoint.flax_split(model)[0])
    n = _same_tree(checkpoint.flax_split(model)[0], tree, f"{label} served tree")
    wav = tmp / "served.wav"
    write_wav(wav, int(TRAIN_TP_WAV_S * 16_000), seed=9)
    reset_launches()
    logits = InferencePipeline(model, batch_size=INNER_BATCH, device="cuda").logits_for_audio(
        _load_mono(wav))
    torch.cuda.synchronize()
    launches = read_launches()
    if not np.isfinite(logits).all() or logits.shape[-1] != len(TRAIN_CLASSES):
        raise AssertionError(f"{label}: served logits {logits.shape}, finite "
                             f"{np.isfinite(logits).all()}")
    _launched(launches, (kernel,), f"{label} served")
    print(f"check train tensor_seq {label} [{card}]: the gathered checkpoint loads meshless "
          f"(fingerprint checked, {n} trainable leaves bit-equal to the file) and serves "
          f"{TRAIN_TP_WAV_S:.0f} s: logits {logits.shape} finite, launches {launches}", flush=True)
    del model
    torch.cuda.empty_cache()
    return launches


def phase_train_tensor_seq(card: str) -> dict:
    """Training under tensor and sequence parallelism on the one card: each
    world of TRAIN_TP_RUNS as gloo ranks on cuda:0 in child processes (full
    widths, seed-0 weights, dropout 0, the training slice's batch of 32
    crops of 4 s, TRAIN_TP_STEPS steps of ``Trainer.train_step``), against
    this process's meshless steps (``_finish_tp_world``'s gates; the meshes
    of four ranks share one world, which runs at once with the world of two,
    so their steps' walls overlap): HuBERT-base
    bf16 at (2, 1, 2), Whisper-base ``surgical_hydra`` bf16 at (1, 2, 2)
    (log-mel and the flash forward at 750 | 1500 without autograd; the
    layer mix, the BiLSTM and the heads trained), HuBERT-base f32 at (1, 1,
    2); then the first world's gathered checkpoint served meshless
    (``_serve_gathered``). Returns the launch counts by path (each world's
    summed over its ranks)."""
    paths: dict[str, dict] = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # the worlds run at once (the phase's time), their steps overlapping
        sizes = sorted({int(np.prod(r[3])) for r in TRAIN_TP_RUNS}, reverse=True)
        worlds = [_start_tp_world([r for r in TRAIN_TP_RUNS if int(np.prod(r[3])) == size], tmp)
                  for size in sizes]
        results, refs = {}, {}
        try:
            for world in worlds:  # every world ends before the meshless steps run
                _join_tp_world(card, world)
            for world in worlds:
                results.update(_finish_tp_world(card, world, refs))
        finally:
            for proc in (p for world in worlds for p in world["procs"]):
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for label, got in results.items():
            paths[f"train tensor_seq {label}"] = got["launches"]
        first = results[TRAIN_TP_RUNS[0][0]]
        paths["train tensor_seq served"] = _serve_gathered(
            card, f"{TRAIN_TP_RUNS[0][0]} {TRAIN_TP_RUNS[0][3]}", first["cfg"], first["ckpt"],
            tmp)
    return paths


def phase_parallel_cards(card: str) -> dict:
    """Data parallelism across the visible cards, when there are several
    (on one card it prints that it is skipped and returns no path; the
    two-replica and world-of-one checks of ``phase_parallel`` stand in):

    1. serving: the serving slice through ``run_inference_on_audios`` with
       ``mesh`` off and auto (one replica per card, a peer copy of each
       block to its card and of its logits back): logits bit-equal where the
       blocks are whole inner batches (else within LOGITS_ATOL), launches
       equal; one run's wall each (not a scaling study: one run, one host);
       a request through ``serve_forever(mesh="auto")``; with four cards,
       the serving slice over each of TENSOR_SEQ_CARD_MESHES (tensor and
       sequence parallelism, ``_mesh_serving``'s gates) and a request
       through ``serve_forever`` over (2, 1, 2);
    2. training, HuBERT-base widths at PARALLEL_LAYERS layers, 8 crops a
       card: one f32 step of an NCCL world of one rank per card against one
       process's global-batch step (``_world_step``), and ``_cards_fits``;
       with four cards, training under tensor and sequence parallelism:
       TRAIN_TP_CARD_RUNS as NCCL ranks on cards of their own with
       ``phase_train_tensor_seq``'s gates (``_finish_tp_world``), and
       ``cli.train`` started plainly with ``mesh.model=2`` (step and epoch
       dispatch) and with ``mesh.seq=2 mesh.model=2`` (``_cards_tp_cli``);
    3. epoch dispatch under tensor and sequence parallelism
       (``_cards_epoch_worlds``, ``_finish_epoch_world``'s gates):
       TRAIN_EPOCH_CARD_RUNS as NCCL ranks on cards of their own, each
       mesh fitted under step and under epoch dispatch from the device
       cache, bit for bit; the two-rank meshes from two cards, the
       four-rank ones with four.

    The epoch-dispatch worlds run first, then 1 and 2; the phase prints the
    wall of each piece. Returns the launch counts of the serving and
    training paths."""
    import dataclasses

    import torch

    from segma_tpu_torch.inference import _load_mono
    from segma_tpu_torch.parallel import auto_mesh, make_mesh, replicate

    n = torch.cuda.device_count()
    if n < 2:
        print(f"parallel cards [{card}]: skipped, {n} card visible", flush=True)
        return {}
    paths: dict[str, dict] = {}
    walls: dict[str, float] = {}
    t_piece = [time.perf_counter()]

    def piece(name: str) -> None:
        now = time.perf_counter()
        walls[name] = now - t_piece[0]
        t_piece[0] = now

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        root = tmp / "data"
        write_dataset(root, TRAIN_CLASSES, (max(TRAIN_FILES, n), max(VAL_FILES, n), TEST_FILES),
                      TRAIN_FILE_S)
        write_hubert_snapshot(tmp / "hubert4", seed=16,
                              dims=dict(HUBERT_BASE, num_hidden_layers=PARALLEL_LAYERS))
        piece("data")
        # epoch dispatch under tensor and sequence parallelism first: the
        # step's graph holds the layers' NCCL collectives
        paths.update(_cards_epoch_worlds(card, root, tmp / "epoch_worlds", n))
        piece("epoch dispatch worlds")
        cfg, model, wav_dir, audio_s, n_chunks = _serving_wav(tmp)
        mesh = auto_mesh(cfg, torch.device("cuda"))
        replicate(model, mesh)  # the other cards' first use, untimed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        replicate(model, mesh)
        torch.cuda.synchronize()
        copy_s = time.perf_counter() - t0
        label = f"auto, {n} cards"
        serve = _serve_paths(card, cfg, model, wav_dir, tmp / "serve", audio_s,
                             {"off": ("off", True), label: ("auto", _whole_batches(n_chunks, n))},
                             f"{n} cards, one run each after a warm-up: not a scaling study; "
                             f"the auto run includes copying the model to the other cards, "
                             f"{copy_s:.4f} s alone")
        paths.update({f"parallel serve cards {k}": v for k, v in serve.items()})
        paths["parallel serve cards request"] = _serve_request(card, cfg, model, tmp, "auto",
                                                               f"{mesh.shape['data']} cards")
        if n >= 4:  # tensor and sequence parallelism across four cards
            cards = [f"cuda:{i}" for i in range(4)]

            def on_cards(shape):
                d, s, m = shape
                return make_mesh(devices=cards[: d * s * m], data=d, seq=s, model=m)

            limit = _bf16_limit("surgical_hydra", cfg,
                                _two_chunks(_load_mono(wav_dir / "smoke.wav")))
            tp = _mesh_serving(card, "surgical_hydra 4 cards", model, wav_dir / "smoke.wav",
                               tmp / "tp", TENSOR_SEQ_CARD_MESHES, limit, SERVE_LAUNCH_KEYS,
                               mesh_of=on_cards)
            paths.update({f"parallel serve cards {k}": v for k, v in tp.items()})
            paths["parallel serve cards request 2x1x2"] = _serve_request(
                card, cfg, model, tmp, on_cards((2, 1, 2)), "(2, 1, 2) over 4 cards", near=limit)
        del model
        torch.cuda.empty_cache()
        piece("serving")

        cfg = surgical_hubert_hydra_config(root, precision="f32")
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, config=dataclasses.replace(cfg.model.config,
                                                  wav_encoder=str(tmp / "hubert4"))))
        _world_step(card, cfg, write_config(tmp / "step.json", cfg), tmp, n, "nccl",
                    own_cards=True)
        piece("world step")
        cli_cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, precision="bf16", batch_size=8 * n, max_epochs=PARALLEL_CLI_EPOCHS,
            data_cache="device"))
        _cards_fits(card, write_config(tmp / "cli.json", cli_cfg), tmp, n)
        piece("data-parallel fits")
        if n >= 4:  # training under tensor and sequence parallelism across four cards
            runs = [(f"{label} 4 cards", *rest) for label, *rest in TRAIN_TP_CARD_RUNS]
            got = _finish_tp_world(card, _start_tp_world(runs, tmp / "tp_train", backend="nccl",
                                                           own_cards=True))
            for label, result in got.items():
                paths[f"parallel train cards tensor_seq {label}"] = result["launches"]
            piece("tensor_seq step worlds")
            _cards_tp_cli(card, root, tmp / "tp_cli", tmp / "hubert4")
            piece("cli.train")
    print(f"parallel cards walls [{card}]: " + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items())
          + f"; total {sum(walls.values()):.1f} s", flush=True)
    return paths


def _cards_tp_cli(card: str, root: Path, tmp: Path, hubert: Path) -> None:
    """``python -m segma_tpu_torch.cli.train`` run plainly on four cards with
    ``mesh.model=2`` (HuBERT-base's widths at PARALLEL_LAYERS layers, the
    snapshot ``hubert``, the training slice's two epochs: the auto-resolved
    (2, 1, 2)), with ``mesh.seq=2 mesh.model=2``
    (Whisper-base ``surgical_hydra``, one epoch: (1, 2, 2)), and with
    ``mesh.model=2 train.dispatch=epoch train.data_cache=device`` (HuBERT-base
    again, the step captured as a CUDA graph): four NCCL ranks, exit 0, each
    epoch logged once, ``last/`` holding the whole tree."""
    import dataclasses

    from segma_tpu_torch import checkpoint

    tmp.mkdir(parents=True, exist_ok=True)
    snapshot = hubert
    hubert = surgical_hubert_hydra_config(root)
    hubert = dataclasses.replace(hubert, model=dataclasses.replace(
        hubert.model, config=dataclasses.replace(hubert.model.config, wav_encoder=str(snapshot))))
    whisper = _train_precision(surgical_hydra_config(), "bf16")
    whisper = dataclasses.replace(
        whisper, data=dataclasses.replace(whisper.data, dataset_path=str(root)),
        train=dataclasses.replace(whisper.train, batch_size=TRAIN_TP_BATCH, max_epochs=1, seed=0))
    q_proj = "encoder/layers_0/attention/q_proj/kernel"
    for label, cfg, extra, q in (
            ("hubert", hubert, ["mesh.model=2"], q_proj),
            ("whisper", whisper, ["mesh.seq=2", "mesh.model=2"], "layer_mix/layer_weights"),
            ("hubert_epoch", hubert, ["mesh.model=2", "train.dispatch=epoch",
                                      "train.data_cache=device"], q_proj)):
        out = tmp / label
        log = tmp / f"{label}.log"
        cfg_path = write_config(tmp / f"{label}.json", cfg)
        wall = _wait(_child(["-m", "segma_tpu_torch.cli.train", "-c", str(cfg_path),
                             f"model.chkp_path={out}", *extra], tmp / f"cwd_{label}", log),
                     log, f"cards cli.train {label}", 0)
        text = log.read_text()
        if "4 cards visible" not in text or "ranks exited with [0, 0, 0, 0]" not in text:
            raise AssertionError(f"cards cli.train {label}: not 4 ranks:\n{text[-3000:]}")
        (run,) = out.iterdir()
        epochs = _epochs(_records(run / "metrics.jsonl"))
        if [r["epoch"] for r in epochs] != list(range(cfg.train.max_epochs)):
            raise AssertionError(f"cards cli.train {label}: epochs {[r['epoch'] for r in epochs]}")
        tree = checkpoint.msgpack_restore((run / "checkpoints" / "last" / "params.msgpack")
                                          .read_bytes())
        leaf = tree
        for part in q.split("/"):
            leaf = leaf[part]
        print(f"check parallel train cards cli.train {label} [{card}]: {' '.join(extra)} as 4 "
              f"NCCL ranks, exit 0 in {wall:.1f} s; epochs "
              + ", ".join(f"{r['epoch']}: loss {r['train/loss']:.4f}, train "
                          f"{r['train_time_s']:.2f} s" for r in epochs)
              + f"; last/ {q} {tuple(np.asarray(leaf).shape)} (the whole leaf)", flush=True)


# epoch dispatch under tensor and sequence parallelism, NCCL ranks on cards of
# their own: (label, model, precision, (data, seq, model)); the two-rank
# worlds need two cards (and run at once on cards 0-1 and 2-3 where four
# are visible), the others four
TRAIN_EPOCH_CARD_RUNS = (("hubert bf16", "surgical_hubert_hydra", "bf16", (1, 1, 2)),
                         ("hubert f32", "surgical_hubert_hydra", "f32", (1, 1, 2)),
                         ("hubert bf16", "surgical_hubert_hydra", "bf16", (2, 1, 2)),
                         ("whisper bf16", "surgical_hydra", "bf16", (1, 2, 2)))
TRAIN_EPOCH_EPOCHS = 3  # epoch 0 warms up and captures, 1 is timed, 2 runs under the profiler
# the attention layers whose flash backward a step launches (Whisper's encoder is frozen)
TRAIN_EPOCH_LAYERS = {"surgical_hubert_hydra": HUBERT_BASE["num_hidden_layers"],
                      "surgical_hydra": 0}
TRAIN_EPOCH_STEPS = 8  # steps an epoch: data.dataset_multiplier 2 over the slice's 8 files
# one rank of an epoch-dispatch world (argv: the card's line, then a config
# and an out dir for each mesh in turn, one NCCL world for all): each mesh's
# seeded fit under step dispatch, then under epoch dispatch, from the device
# cache (``_dispatch_fit``: the second epoch's steps timed by CUDA events,
# the third profiled); rank 0's fits write <out>/<dispatch>/checkpoints;
# each rank reports each fit's history, step losses (rank 0), launches,
# graphs, readings and sha256 of its trainable parameters to
# <out>/rank<r>.json
TENSOR_EPOCH_CHILD = (
    "import dataclasses, faulthandler, hashlib, json, sys, warnings\n"
    "from pathlib import Path\n"
    "import chip_smoke\n"
    "from segma_tpu_torch.config import load_config\n"
    "from segma_tpu_torch.data import SegmaFileDataset\n"
    "from segma_tpu_torch.parallel import distributed\n"
    "assert distributed.maybe_init_distributed('cuda', backend='nccl')\n"
    "world = distributed.current_world()\n"
    "digest = lambda t: hashlib.sha256(t.float().numpy().tobytes()).hexdigest()\n"
    "card, runs = sys.argv[1], sys.argv[2:]\n"
    "for cfg_path, out in zip(runs[::2], runs[1::2]):\n"
    "    base = load_config(cfg_path)\n"
    "    ds = SegmaFileDataset.from_config(base)\n"
    "    ds.load(use_cache=False)\n"
    "    report = {'rank': world.rank}\n"
    "    for dispatch in ('step', 'epoch'):\n"
    "        cfg = dataclasses.replace(base, train=dataclasses.replace(base.train,\n"
    "                                                                 dispatch=dispatch))\n"
    "        with warnings.catch_warnings():\n"
    "            warnings.simplefilter('ignore')  # random encoder weights, on purpose\n"
    "            run = chip_smoke._dispatch_fit(\n"
    "                card, f'{Path(out).name} {dispatch} rank {world.rank}', cfg, ds,\n"
    "                Path(out) / dispatch, timed_epoch=1, profile_epoch=2)\n"
    "        report[dispatch] = {\n"
    "            'history': [{k: v for k, v in h.items() if 'time' not in k and\n"
    "                         k != 'samples_per_s'} for h in run['history']],\n"
    "            'steps': [(r['step'], r['train/loss_step']) for r in run['records']\n"
    "                      if 'train/loss_step' in r],\n"
    "            'params': {k: digest(v) for k, v in run['params'].items()},\n"
    "            'adam': {k: {n: digest(t) for n, t in state.items()}\n"
    "                     for k, state in run['adam'].items()},\n"
    "            **{k: run[k] for k in ('launches', 'graphs', 'sharded', 'coordinate',\n"
    "                                   'steps_ms', 'warm_ms', 'n_steps', 'peak', 'busy_ms',\n"
    "                                   'wall_ms')}}\n"
    "    Path(out, f'rank{world.rank}.json').write_text(json.dumps(report))\n"
    "faulthandler.dump_traceback_later(120, exit=True)  # a leaving rank that hangs fails\n"
    "distributed.destroy()\n"
)


def _epoch_world_config(name: str, precision: str, shape: tuple[int, int, int], root: Path):
    """The training slice's HuBERT-base config, or the serving slice's
    Whisper-base one, over ``root`` at ``precision`` and the mesh ``shape``:
    batch 32, seed 0, the device cache, TRAIN_EPOCH_EPOCHS epochs of
    TRAIN_EPOCH_STEPS steps, every step's loss logged."""
    import dataclasses

    from segma_tpu_torch.config import MeshConfig

    if name == "surgical_hubert_hydra":
        cfg = surgical_hubert_hydra_config(root, precision=precision)
    else:
        cfg = _train_precision(surgical_hydra_config(), precision)
    chunks = TRAIN_FILES * TRAIN_FILE_S / 4.0
    d, s, m = shape
    return dataclasses.replace(
        cfg, mesh=MeshConfig(data=d, seq=s, model=m),
        data=dataclasses.replace(cfg.data, dataset_path=str(root), dataset_multiplier=(
            TRAIN_EPOCH_STEPS * TRAIN_TP_BATCH / chunks)),
        train=dataclasses.replace(cfg.train, batch_size=TRAIN_TP_BATCH, seed=0,
                                  max_epochs=TRAIN_EPOCH_EPOCHS, data_cache="device",
                                  log_every_n_steps=1))


def _start_epoch_world(card: str, runs, root: Path, tmp: Path, cards: list[int]) -> dict:
    """The meshes ``runs`` ((label, model, precision, shape), each of
    len(cards) devices), one after the other in one world of
    ``TENSOR_EPOCH_CHILD`` ranks, rank r on card ``cards[r]``."""
    n = len(cards)
    args, prepared = [card], []
    for label, name, precision, shape in runs:
        out = tmp / f"{label.replace(' ', '_')}_{'x'.join(map(str, shape))}"
        out.mkdir(parents=True)
        cfg = _epoch_world_config(name, precision, shape, root)
        args += [str(write_config(out / "cfg.json", cfg)), str(out)]
        prepared.append((f"{label} {shape}", name, precision, shape, out, cfg))
    tag = f"epoch_world_cards{'_'.join(map(str, cards))}"
    port = _free_port()
    procs = [_child(["-c", TENSOR_EPOCH_CHILD, *args], tmp / f"cwd_{tag}" / f"rank{r}",
                    tmp / f"{tag}{r}.log", _rank_env(r, n, port, cards[r])) for r in range(n)]
    return {"procs": procs, "t0": time.perf_counter(), "tmp": tmp, "tag": tag, "n": n,
            "cards": cards, "prepared": prepared}


def _finish_epoch_world(card: str, world: dict, tmp: Path) -> dict:
    """Wait for a world of ``_start_epoch_world`` (every rank exit 0), then
    hold each mesh's epoch-dispatch fit to its step-dispatch fit: each
    step's loss and ``last/``'s params.msgpack and opt_state.msgpack bytes
    equal; on every rank the same history, launch counts (a replay counts
    its captured launches) and parameter and AdamW bits under both
    dispatches, and the flash backward launched layers x steps times; every
    replicated parameter the same bits on every rank, each sharded block on
    the ranks of its model coordinate; then the epoch fit's gathered
    ``last/`` served meshless (``_serve_gathered``). Prints the warm
    step's median and p10 to p90 (CUDA events) and the device-busy share
    under each dispatch. Returns the launch counts by path, each summed
    over the ranks."""
    import torch

    n = world["n"]
    _wait_ranks(world["procs"], world["tmp"], world["tag"], 0)
    wall = time.perf_counter() - world["t0"]
    print(f"train epoch dispatch [{card}]: a world of {n} nccl ranks on cards {world['cards']} "
          f"ran {[p[0] for p in world['prepared']]}, ended within {wall:.1f} s of its start",
          flush=True)
    paths = {}
    for label, name, precision, shape, out, cfg in world["prepared"]:
        what = f"train epoch dispatch {label}"
        ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(n)]
        lasts = {d: out / d / "checkpoints" / "last" for d in ("step", "epoch")}
        for f in ("params.msgpack", "opt_state.msgpack"):
            if (lasts["step"] / f).read_bytes() != (lasts["epoch"] / f).read_bytes():
                raise AssertionError(f"{what}: last/{f} differs between the dispatches")
        steps = ranks[0]["step"]["steps"]
        if len(steps) != TRAIN_EPOCH_EPOCHS * TRAIN_EPOCH_STEPS:
            raise AssertionError(f"{what}: {len(steps)} step losses logged")
        if ranks[0]["epoch"]["steps"] != steps:
            raise AssertionError(f"{what}: the step losses differ between the dispatches")
        layers = TRAIN_EPOCH_LAYERS[name]
        bwd = "flash_attn_bwd" if precision == "bf16" else "flash_attn_bwd_f32"
        for rep in ranks:
            r, a, b = rep["rank"], rep["step"], rep["epoch"]
            if b["graphs"] != [True] or a["graphs"]:
                raise AssertionError(f"{what} rank {r}: graphs {a['graphs']}, {b['graphs']}")
            for key in ("history", "launches", "params", "adam", "coordinate"):
                if a[key] != b[key]:
                    raise AssertionError(f"{what} rank {r}: {key} differs between the dispatches")
            if a["history"] != ranks[0]["step"]["history"]:
                raise AssertionError(f"{what} rank {r}: another history than rank 0's")
            if b["launches"][bwd] != layers * len(steps):
                raise AssertionError(f"{what} rank {r}: {bwd} launched {b['launches'][bwd]} "
                                     f"times, not {layers} layers x {len(steps)} steps")
            for k, h in b["params"].items():
                # sharded blocks agree along data and seq, replicated leaves everywhere
                twin = next(t for t in ranks if k not in b["sharded"]
                            or t["epoch"]["coordinate"][2] == b["coordinate"][2])
                if h != twin["epoch"]["params"][k]:
                    raise AssertionError(f"{what} rank {r}: {k} differs from rank "
                                         f"{twin['rank']}'s")
        keys = (("flash_attn_fwd", "flash_attn_bwd") if name == "surgical_hubert_hydra"
                else ("logmel", "flash_attn_fwd"))
        if precision == "f32":
            keys = tuple(k + "_f32" if k.startswith("flash") else k for k in keys)
        for rep in ranks:
            _launched(rep["epoch"]["launches"], keys, f"{what} rank {rep['rank']}")
        readings = []
        for d in ("step", "epoch"):
            q = np.percentile([x for rep in ranks for x in rep[d]["steps_ms"]], [10, 50, 90])
            busy = [rep[d]["busy_ms"] / rep[d]["wall_ms"] for rep in ranks]
            readings.append(
                f"{d} dispatch: warm step {q[1]:.3f} ms (median of every rank's epoch-1 "
                f"step-to-step gaps, CUDA events; p10 {q[0]:.3f}, p90 {q[2]:.3f}; epoch train "
                f"time over steps {np.median([rep[d]['warm_ms'] for rep in ranks]):.3f} ms), "
                f"device busy {100 * min(busy):.1f}% to {100 * max(busy):.1f}% of the profiled "
                f"epoch's wall, peak {max(rep[d]['peak'] for rep in ranks) / 2**30:.2f} GiB a "
                f"rank")
        n_leaves = len(ranks[0]["epoch"]["params"])
        print(f"check {what} [{card}]: {n} NCCL ranks at (data, seq, model) {shape}, "
              f"{TRAIN_EPOCH_EPOCHS} epochs of {TRAIN_EPOCH_STEPS} steps of {TRAIN_TP_BATCH} "
              f"crops from the device cache: epoch dispatch (one graph captured, the layers' "
              f"collectives and the data group's mean in it) bit-equal to step dispatch: "
              f"{len(steps)} step losses, every rank's epochs, last/ params and opt_state "
              f"bytes, {n_leaves} parameters and their AdamW moments on each rank; replicated "
              f"leaves the same bits on every rank ({len(ranks[0]['epoch']['sharded'])} "
              f"sharded); launches equal, {bwd} {ranks[0]['epoch']['launches'][bwd]} per rank "
              f"({layers} layers x {len(steps)} steps); " + "; ".join(readings), flush=True)
        for d in ("step", "epoch"):
            paths[f"parallel train cards tensor_seq {d} {label}"] = {
                k: sum(rep[d]["launches"][k] for rep in ranks) for k in ranks[0][d]["launches"]}
        paths[f"parallel train cards tensor_seq epoch {label} served"] = _serve_gathered(
            card, f"epoch dispatch {label}", cfg, lasts["epoch"], tmp,
            "flash_attn_fwd_f32" if precision == "f32" else "flash_attn_fwd")
        torch.cuda.empty_cache()
    return paths


def _cards_epoch_worlds(card: str, root: Path, tmp: Path, n_cards: int) -> dict:
    """TRAIN_EPOCH_CARD_RUNS that fit on ``n_cards`` cards: the two-rank
    worlds at once on cards (0, 1) and (2, 3), or one after the other on
    two cards; then the four-rank meshes in one world on four."""
    two = [r for r in TRAIN_EPOCH_CARD_RUNS if int(np.prod(r[3])) == 2]
    four = [r for r in TRAIN_EPOCH_CARD_RUNS if int(np.prod(r[3])) == 4]
    paths = {}
    worlds = []
    try:
        if n_cards >= 4:
            worlds = [_start_epoch_world(card, [run], root, tmp / f"w2_{i}", [2 * i, 2 * i + 1])
                      for i, run in enumerate(two)]
            for world in worlds:
                paths.update(_finish_epoch_world(card, world, tmp))
            worlds = [_start_epoch_world(card, four, root, tmp / "w4", [0, 1, 2, 3])]
            paths.update(_finish_epoch_world(card, worlds[0], tmp))
        else:
            worlds = [_start_epoch_world(card, two[:1], root, tmp / "w2_0", [0, 1])]
            paths.update(_finish_epoch_world(card, worlds[0], tmp))
    finally:
        for proc in (p for world in worlds for p in world["procs"]):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return paths


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
        if rank < 15 or any(k in e.key for k in ("flash_", "logmel_", "lstm_fwd")):
            print(f"profile {label} kernel: {e.self_device_time_total / 1e3:9.2f} ms "
                  f"{e.count:6d}x #{rank + 1} {e.key[:100]}", flush=True)
    return [e.key for e in ranked]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
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
    rows.append(lstm_checks(card))
    with torch.inference_mode():
        wavlm_row = wavlm_attn_checks(card)
    wavlm_row["large"] = wavlm_large_steps(card)
    with torch.inference_mode():
        fast = fast_context_kernel_times(card)
        unequal = flash_unequal_checks(card)
    for row in rows:  # a seq member's query block against its group's keys
        if row["name"] in unequal:
            row["unequal_lengths"] = unequal[row["name"]]
    for row in rows:
        if row["name"] in fast:
            row["fast_context"] = fast[row["name"]]
    torch.cuda.empty_cache()
    walls = {"build and kernels": time.perf_counter() - t_start}

    def phase(fn):
        t0 = time.perf_counter()
        out = fn(card)
        torch.cuda.empty_cache()
        walls[fn.__name__] = time.perf_counter() - t0
        return out

    serve = phase(phase_slice)
    train = phase(phase_train)
    workflow = phase(phase_workflow)
    reference = phase(phase_reference_models)
    train_cli = phase(phase_train_cli)
    device_cache = phase(phase_device_cache)
    families = phase(phase_model_families)
    parallel = phase(phase_parallel)
    tensor_seq = phase(phase_tensor_seq)
    train_tp = phase(phase_train_tensor_seq)
    parallel.update(phase(phase_parallel_cards))
    # the f32 phases run under PyTorch's defaults, which let cuDNN take TF32:
    # the f32 model itself keeps its convolutions and LSTM in IEEE f32
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    print("f32 phases: PyTorch's default flags, allow_tf32 True for cuDNN, False for matmul",
          flush=True)
    live = phase(phase_serve)
    export = phase(phase_export)
    serve_f32 = phase(phase_serve_f32)
    train_f32 = phase(phase_train_f32)
    print(f"phase walls [{card}]: " + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items())
          + f"; total {time.perf_counter() - t_start:.1f} s", flush=True)
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
        row["launches_train_cli"] = train_cli[row["name"]]
        row["launches_device_cache"] = device_cache["device_cache epoch"][row["name"]]
        row["launches_model_families"] = sum(path[row["name"]]
                                             for path in families["launches"].values())
    for name in SERVE_LAUNCH_KEYS:  # the live-serving paths, all of them together
        by_name[name]["launches_live_serving"] = sum(path[name] for path in live.values())
    for row in rows:  # the data-parallel paths, serving and training
        for kind in ("serve", "train"):
            row[f"launches_parallel_{kind}"] = sum(
                counts[row["name"]] for path, counts in parallel.items()
                if path.startswith(f"parallel {kind}"))
        # epoch dispatch under tensor and sequence parallelism across cards:
        # every rank's replays of every mesh, and the served checkpoints
        row["launches_parallel_train_epoch"] = sum(
            counts[row["name"]] for path, counts in parallel.items()
            if path.startswith("parallel train cards tensor_seq epoch"))
        # the tensor- and sequence-parallel serving paths, every mesh together
        row["launches_tensor_seq"] = sum(counts[row["name"]] for counts in tensor_seq.values())
        # training under tensor and sequence parallelism: every rank of every
        # world, and the gathered checkpoint served
        row["launches_train_tensor_seq"] = sum(counts[row["name"]]
                                               for counts in train_tp.values())
    by_name["logmel"]["vad_train"] = families["logmel"]
    # the artifacts' runs: the bf16 one in its loader child, the f32 one here
    for name, path in (("logmel", "export child bf16"), ("flash_attn_fwd", "export child bf16"),
                       ("flash_attn_fwd_f32", "export f32"), ("lstm_fwd", "export child bf16")):
        by_name[name]["launches_export"] = export[path][name]
    print(json.dumps({"kernels": rows}), flush=True)
    paths = {"serve": serve, "train": train, "workflow_resume": workflow["resume"],
             "workflow_predict": workflow["predict"], "serve_f32": serve_f32,
             "train_f32": train_f32,
             **{f"reference {label}": counts for label, counts in reference.items()},
             "train_cli": train_cli, **device_cache,
             **{f"families {label}": counts for label, counts in families["launches"].items()},
             **{f"live serve {label}": counts for label, counts in live.items()},
             **export, **parallel, **tensor_seq, **train_tp}
    print(f"kernels: {json.dumps(paths)}", flush=True)
    # WavLM's gated-bias attention, with its launches on every path that ran it
    wavlm_row["launches"] = {label: counts.get("wavlm_attn_fwd", 0)
                             for label, counts in paths.items() if isinstance(counts, dict)}
    print(json.dumps({"wavlm_attn": wavlm_row}), flush=True)
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
