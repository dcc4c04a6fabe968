"""Kernel 1: the fused Whisper log-mel (``csrc/logmel.cu``) and its plain
version.

Counterpart of ``segma_tpu/ops/pallas_melspec.py``. Both functions here take
(B, T) f32 waveforms and return the UN-clamped log10-mel (B, T // 160, 80):
center reflect padding, Hann-windowed 400-point DFT at hop 160, power, slaney
mel projection, ``log10(max(., 1e-10))``, with Whisper's last frame dropped.
The per-example max-8 clamp and ``(x + 4) / 4`` are applied by ``finish``.

``log10_mel`` launches the CUDA kernel for a CUDA tensor and takes the plain
version only for a CPU tensor.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from segma_tpu_torch.ops import _build
from segma_tpu_torch.ops.melspec import HOP_LENGTH, N_FFT, N_MELS, dft_basis, mel_filterbank

N_BINS_PAD = 224  # the kernel walks the 201 bins in 7 chunks of 32

launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)


def _n_frames(t: int) -> int:
    return t // HOP_LENGTH  # frames after Whisper's drop-last


def _reflect_pad(wav: torch.Tensor) -> torch.Tensor:
    half = N_FFT // 2
    return F.pad(wav[:, None, :], (half, half), mode="reflect")[:, 0, :]


@lru_cache(maxsize=8)
def _plain_tables(device: torch.device) -> tuple[torch.Tensor, ...]:
    cos_b, sin_b = dft_basis()
    fb = mel_filterbank()
    return tuple(torch.from_numpy(a).to(device) for a in (cos_b, sin_b, fb))


@lru_cache(maxsize=8)
def _kernel_tables(device: torch.device) -> tuple[torch.Tensor, ...]:
    """Basis (400, 224) x2 and filterbank (224, 80), zero-padded past bin 201."""
    cos_b, sin_b = dft_basis()
    fb = mel_filterbank()
    pad = N_BINS_PAD - cos_b.shape[1]
    cos_p = np.pad(cos_b, ((0, 0), (0, pad)))
    sin_p = np.pad(sin_b, ((0, 0), (0, pad)))
    fb_p = np.pad(fb, ((0, pad), (0, 0)))
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a)).to(device)
        for a in (cos_p, sin_p, fb_p)
    )


def log10_mel_plain(wav: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: strided frames, basis matmul, power, mel matmul.

    Runs in f32; on a card it is exact f32 only with
    ``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's default)."""
    wav = wav.float()
    n_frames = _n_frames(wav.shape[1])
    frames = _reflect_pad(wav).unfold(1, N_FFT, HOP_LENGTH)[:, :n_frames]
    cos_b, sin_b, fb = _plain_tables(wav.device)
    re = frames @ cos_b
    im = frames @ sin_b
    mel = (re * re + im * im) @ fb
    return torch.log10(torch.clamp(mel, min=1e-10))


def log10_mel_cuda(wav: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on a (B, T) f32 CUDA waveform."""
    global launches
    if not wav.is_cuda:
        raise ValueError("log10_mel_cuda needs a CUDA tensor")
    if wav.dtype != torch.float32 or wav.dim() != 2:
        raise ValueError(f"expected (B, T) float32, got {tuple(wav.shape)} {wav.dtype}")
    b, t = wav.shape
    if t <= N_FFT // 2:
        raise ValueError(f"waveform of {t} samples is too short to reflect-pad")
    n_frames = _n_frames(t)
    padded = _reflect_pad(wav).contiguous()
    cos_p, sin_p, fb_p = _kernel_tables(wav.device)
    out = torch.empty((b, n_frames, N_MELS), dtype=torch.float32, device=wav.device)
    lib = _build.library()
    err = lib.segma_logmel(
        padded.data_ptr(), cos_p.data_ptr(), sin_p.data_ptr(), fb_p.data_ptr(),
        out.data_ptr(), b, padded.shape[1], n_frames,
        torch.cuda.current_stream(wav.device).cuda_stream,
    )
    _build.check(err, "segma_logmel")
    launches += 1
    return out


def log10_mel(wav: torch.Tensor) -> torch.Tensor:
    """Kernel for a CUDA tensor, plain version for a CPU tensor."""
    if wav.is_cuda:
        return log10_mel_cuda(wav.float())
    return log10_mel_plain(wav)


def finish(log_spec: torch.Tensor) -> torch.Tensor:
    """Clamp to 8 below the per-example max, then ``(x + 4) / 4``."""
    max_per_ex = log_spec.amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, max_per_ex - 8.0)
    return (log_spec + 4.0) / 4.0


def log_mel_spectrogram_plain(wav: torch.Tensor) -> torch.Tensor:
    """The whole plain log-mel, on whatever device ``wav`` lies."""
    return finish(log10_mel_plain(wav))
