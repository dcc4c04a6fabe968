"""The chip's peaks and the kernels' bounds, frozen for the benchmark.

Copied from ``chip_smoke.py`` at the commit that added this benchmark:
``PEAK_*`` (lines 232-235), ``bound_ms`` (lines 384-387), ``logmel_bounds``
(lines 476-500; its bound, without the design floors, and the slaney
filterbank's non-zero count frozen as ``MEL_NONZERO``, which
``segma_tpu_torch.ops.melspec.mel_filterbank()`` gave: 391 of 201 x 80),
the bf16 flash forward's bound (``flash_checks``, lines 678-680, and
``flash_unequal_checks``, line 5036; the bf16-product bound, at unequal
query and key lengths too, with the log-sum-exp's bytes where the call
writes it) and the bf16 backward's
(``time_flash_bwd``, lines 755-757). Each bound counts each input byte read
once and each output byte written once.
"""

from __future__ import annotations

import math

# Published H100 SXM peaks (dense): f32 outside the tensor cores, TF32 and
# bf16 tensor cores, HBM3 bandwidth. A card set below 700 W runs slower.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

MEL_NONZERO = 391  # non-zero weights of the 201 x 80 slaney filterbank
N_FFT, HOP, N_BINS, N_MELS = 400, 160, 201, 80


def bound_ms(flops: float, peak_flops: float, n_bytes: float) -> tuple[float, str]:
    t_ops = flops / peak_flops
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def logmel_bound_ms(b: int, t: int) -> float:
    """One launch of the log-mel on a (b, t) f32 waveform: the larger of the
    bytes (the waveform read once, the (b, t // 160, 80) f32 log-mel written
    once) at HBM rate and the operations the function needs at the f32 peak:
    per frame the window (400), a 400-point real FFT (2.5 N log2 N), the
    power (3 per bin, 201 bins) and the sparse mel (2 per non-zero weight)."""
    frames = b * (t // HOP)
    frame_ops = float(N_FFT + 2.5 * N_FFT * math.log2(N_FFT) + 3 * N_BINS + 2 * MEL_NONZERO)
    n_bytes = b * t * 4 + frames * N_MELS * 4
    return bound_ms(frames * frame_ops, PEAK_F32_FLOPS, n_bytes)[0]


def flash_fwd_bound_ms(b: int, s_q: int, s_kv: int, h: int, d: int, lse: bool = False) -> float:
    """The bf16 forward on q (b, s_q, h, d) against k, v (b, s_kv, h, d): two
    products of 2 s_q s_kv d per (batch, head) at the bf16 peak, or q, k, v
    read and the output written once in bf16 (and the (b, h, s_q) f32
    log-sum-exp written)."""
    flops = 4 * b * h * s_q * s_kv * d
    n_bytes = 2 * b * h * d * (2 * s_q + 2 * s_kv) + (4 * b * h * s_q if lse else 0)
    return bound_ms(flops, PEAK_BF16_FLOPS, n_bytes)[0]


def flash_bwd_bound_ms(b: int, s: int, h: int, d: int) -> float:
    """The bf16 backward (dq, dk, dv): five S x S x D products per (batch,
    head) at the bf16 peak, or q, k, v, out, dO read and dq, dk, dv written
    once in bf16, with the f32 log-sum-exp read."""
    flops = 10 * b * h * s * s * d
    n_bytes = 8 * b * s * h * d * 2 + b * h * s * 4
    return bound_ms(flops, PEAK_BF16_FLOPS, n_bytes)[0]
