"""Kernel 1: the fused Whisper log-mel (``csrc/logmel.cu``) and its plain
version.

Counterpart of ``segma_tpu/ops/pallas_melspec.py``. Both functions here take
(B, T) f32 waveforms and return the UN-clamped log10-mel (B, T // 160, 80):
center reflect padding, Hann-windowed 400-point DFT at hop 160, power, slaney
mel projection, ``log10(max(., 1e-10))``, with Whisper's last frame dropped.
The per-example max-8 clamp and ``(x + 4) / 4`` are applied by ``finish``.

``log10_mel`` is the registered op ``segma_tpu_torch::log10_mel``: its CUDA
implementation launches the kernel, its CPU one is the plain version, and its
fake one gives the shape, so ``torch.export`` records it as one node of a
program, which launches the kernel when it runs on the card. The kernel reads the waveform unpadded (it
reflects the edges as it loads) and runs the DFT as 3xTF32 products: the
tables it reads are built here (``_kernel_tables``), with the TF32 split
(``split_tf32``) and the sparse filterbank (``mel_bin_tables``) that the
CPU tests check.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from segma_tpu_torch.ops import _build, cached_constant, count_launch, launch_counts
from segma_tpu_torch.ops.melspec import HOP_LENGTH, N_FFT, N_MELS, dft_basis, mel_filterbank

N_BINS = 200  # bins 0..199: bin 200 (like bin 0) has no weight in the filterbank
N_CHUNK_BINS = 40  # the kernel's bin chunk: its products are re and im of 40 bins
MEL_FIRST, MEL_LAST = 1 << 8, 1 << 9  # a run's first and last bin (csrc/logmel.cu)



def _n_frames(t: int) -> int:
    return t // HOP_LENGTH  # frames after Whisper's drop-last


def _reflect_pad(wav: torch.Tensor) -> torch.Tensor:
    half = N_FFT // 2
    return F.pad(wav[:, None, :], (half, half), mode="reflect")[:, 0, :]


_tables: dict[tuple[str, torch.device], tuple[torch.Tensor, ...]] = {}


def __getattr__(name: str) -> int:
    """``logmel.launches``: the kernel's count in ``ops.launch_counts``."""
    if name == "launches":
        return launch_counts()["logmel"]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _plain_tables(device: torch.device) -> tuple[torch.Tensor, ...]:
    """The DFT basis (cos, sin) and the filterbank on ``device``."""
    return cached_constant(_tables, ("plain", device), lambda: tuple(
        torch.from_numpy(a).to(device) for a in (*dft_basis(), mel_filterbank())))


def tf32_round(a: np.ndarray) -> np.ndarray:
    """f32 rounded to TF32 (10 mantissa bits, to nearest, ties away from zero),
    as the kernel's ``cvt.rna.tf32.f32`` does: the low 13 bits become zero."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split_tf32(a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The 3xTF32 split: ``hi = tf32(a)``, ``lo = tf32(a - hi)``."""
    a = np.asarray(a, dtype=np.float32)
    hi = tf32_round(a)
    return hi, tf32_round(a - hi)


def mel_runs() -> list[tuple[int, int, np.ndarray]]:
    """The slaney filterbank as one run of bins per mel: (mel, first bin,
    weights), the bins of each filter being contiguous."""
    fb = mel_filterbank()
    runs = []
    for m in range(fb.shape[1]):
        nz = np.flatnonzero(fb[:, m])
        if len(nz) == 0 or nz[-1] - nz[0] + 1 != len(nz) or nz[-1] >= N_BINS:
            raise ValueError(f"mel {m}: bins {nz} are not one run below {N_BINS}")
        runs.append((m, int(nz[0]), fb[nz[0] : nz[-1] + 1, m].copy()))
    return runs


def mel_bin_tables() -> tuple[np.ndarray, np.ndarray]:
    """The kernel's sparse filterbank, walked bin by bin.

    ``meta`` and ``weights`` are (chunks, 2, 40): for each chunk of 40 bins
    and each parity of mel, the weight of bin k in the one mel of that parity
    whose run holds it (0 where none does), and that mel's index with
    MEL_FIRST at its run's first bin and MEL_LAST at its last. Each bin feeds
    at most two filters, mels m and m + 1, so a lane that handles one parity
    sums one run at a time, carrying it across a chunk edge."""
    n_chunks = N_BINS // N_CHUNK_BINS
    meta = np.zeros((n_chunks, 2, N_CHUNK_BINS), np.int32)
    weights = np.zeros((n_chunks, 2, N_CHUNK_BINS), np.float32)
    for m, k0, w in mel_runs():
        for i, wi in enumerate(w):
            ch, col = divmod(k0 + i, N_CHUNK_BINS)
            if weights[ch, m % 2, col] != 0:
                raise ValueError(f"bin {k0 + i} feeds two mels of parity {m % 2}")
            weights[ch, m % 2, col] = wi
            meta[ch, m % 2, col] = (
                m | (MEL_FIRST if i == 0 else 0) | (MEL_LAST if i == len(w) - 1 else 0)
            )
    return meta, weights


def kernel_basis() -> np.ndarray:
    """The basis as the kernel reads it: (2, 400, 400) f32, the TF32 ``hi``
    and ``lo`` parts of bins 0..199, bins-major (a TF32 wgmma reads B K-major
    only), each part in chunks of 40 cos rows followed by the same 40 bins'
    sin rows, so that one product's 80 columns give re and im of 40 bins."""
    cos_b, sin_b = dft_basis()
    n_chunks = N_BINS // N_CHUNK_BINS
    rows = np.stack([cos_b[:, :N_BINS].T, sin_b[:, :N_BINS].T])  # (2, 200, 400)
    rows = rows.reshape(2, n_chunks, N_CHUNK_BINS, N_FFT).transpose(1, 0, 2, 3)
    return np.stack(split_tf32(rows.reshape(2 * N_BINS, N_FFT)))


def kernel_colsums() -> np.ndarray:
    """(5, 80) f32: per chunk of 40 bins, the column sums over the 400
    samples of the f32 cos and then sin basis (``dft_basis``), summed in
    float64. The kernel takes each frame's mean out of its samples before the
    products and adds mean x column sum back: the DFT is linear."""
    cos_b, sin_b = dft_basis()
    sums = np.stack([b[:, :N_BINS].astype(np.float64).sum(0) for b in (cos_b, sin_b)])
    n_chunks = N_BINS // N_CHUNK_BINS
    return sums.reshape(2, n_chunks, N_CHUNK_BINS).transpose(1, 0, 2).reshape(
        n_chunks, 2 * N_CHUNK_BINS).astype(np.float32)


def _kernel_tables(device: torch.device) -> tuple[torch.Tensor, ...]:
    """``kernel_basis``, the sparse filterbank's ``meta`` and ``weights``
    (``mel_bin_tables``) and ``kernel_colsums``, on ``device``."""
    return cached_constant(_tables, ("kernel", device), lambda: tuple(
        torch.from_numpy(np.ascontiguousarray(a)).to(device)
        for a in (kernel_basis(), *mel_bin_tables(), kernel_colsums())))


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


def launch(lib, wav: torch.Tensor) -> torch.Tensor:
    """Launch ``segma_logmel`` of the kernel library ``lib`` on a contiguous
    (B, T) f32 CUDA waveform, T > 200, on the waveform's card whatever the
    thread's current device; not counted (``logmel_ablations.py`` launches
    its variants of the kernel through it)."""
    b, t = wav.shape
    n_frames = _n_frames(t)
    basis, meta, weights, colsum = _kernel_tables(wav.device)
    out = torch.empty((b, n_frames, N_MELS), dtype=torch.float32, device=wav.device)
    with torch.cuda.device(wav.device):
        err = lib.segma_logmel(
            wav.data_ptr(), basis.data_ptr(), meta.data_ptr(), weights.data_ptr(),
            colsum.data_ptr(), out.data_ptr(), b, t, n_frames,
            torch.cuda.current_stream(wav.device).cuda_stream,
        )
    _build.check(err, "segma_logmel")
    return out


def log10_mel_cuda(wav: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on a (B, T) f32 CUDA waveform."""
    if not wav.is_cuda:
        raise ValueError("log10_mel_cuda needs a CUDA tensor")
    if wav.dtype != torch.float32 or wav.dim() != 2:
        raise ValueError(f"expected (B, T) float32, got {tuple(wav.shape)} {wav.dtype}")
    b, t = wav.shape
    if t <= N_FFT // 2:
        raise ValueError(f"waveform of {t} samples is too short to reflect-pad")
    if b == 0:
        raise ValueError("empty batch")
    # read unpadded: the kernel reflects the edges as it loads
    out = launch(_build.library(), wav.contiguous())
    count_launch("logmel")
    return out


@torch.library.custom_op("segma_tpu_torch::log10_mel", mutates_args=(), device_types="cpu")
def log10_mel(wav: torch.Tensor) -> torch.Tensor:
    """Un-clamped log10-mel of (B, T) waveforms: the kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    return log10_mel_plain(wav)


@log10_mel.register_kernel("cuda")
def _log10_mel_cuda(wav):
    return log10_mel_cuda(wav.float())


@log10_mel.register_fake
def _log10_mel_fake(wav):
    return wav.new_empty((wav.shape[0], _n_frames(wav.shape[1]), N_MELS), dtype=torch.float32)


def finish(log_spec: torch.Tensor) -> torch.Tensor:
    """Clamp to 8 below the per-example max, then ``(x + 4) / 4``."""
    max_per_ex = log_spec.amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, max_per_ex - 8.0)
    return (log_spec + 4.0) / 4.0


def log_mel_spectrogram_plain(wav: torch.Tensor) -> torch.Tensor:
    """The whole plain log-mel, on whatever device ``wav`` lies."""
    return finish(log10_mel_plain(wav))

