"""4-bit block-ADPCM transport for the host-to-device copy (counterpart of
``segma_tpu/ops/adpcm.py``).

0.547 bytes per sample (4-bit residuals and 3 header bytes per 64-sample
block) against int16's 2 and mu-law's 1, with a decode that is a parallel
vector op on the device:

- the waveform is split into independent 64-sample blocks;
- per block the host stores the exact first sample (int16), a header byte
  (a quarter-octave residual scale index and a predictor-order bit) and 64
  closed-loop quantized residuals (4-bit two's complement, two per byte) of
  a first- or second-order predictor, whichever leaves the smaller
  open-loop residual for that block;
- the device rebuilds every block with cumsums over the block axis (one for
  first order, two for second order): no sequential scan and no dependency
  across blocks.

The encoder quantizes against its own reconstruction, so the device output
is bit-exact to the encoder's prediction chain, and an all-zero byte buffer
decodes to silence: zero padding of the transport buffer is safe.

Lossy, like mu-law: about 40 dB round-trip SNR on speech-like signals, 29 dB
on pure high tones, 16 dB on white noise. It is an opt-in throughput
transport (``--transport adpcm``) for serving real audio, not for parity
runs. Quantizing a pure tone gives harmonically correlated distortion that a
model trained on noise-free sines can mis-detect; validate thresholds on
real data before serving a lossy transport.

``adpcm_decode`` is the device decode in torch ops, bit-exact with the numpy
``adpcm_decode_np``: the cumsums run in int32 and the scale to [-1, 1] is a
multiplication by 2**-15, which is exact.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from segma_tpu_torch.ops import cached_constant

BLOCK = 64  # samples per independent block
HEADER_BYTES = 3  # x0 (int16 LE) + scale index (uint8)
PAYLOAD_BYTES = BLOCK // 2  # two 4-bit residuals per byte
BYTES_PER_BLOCK = HEADER_BYTES + PAYLOAD_BYTES  # 35

# quarter-octave residual scales; index 53 (scale 9742) already covers the
# largest int16 first difference
SCALE_TABLE = np.rint(2.0 ** (np.arange(64) / 4.0)).astype(np.int32)


def n_blocks(n_samples: int) -> int:
    return -(-n_samples // BLOCK)


def encoded_nbytes(n_samples: int) -> int:
    return n_blocks(n_samples) * BYTES_PER_BLOCK


def adpcm_encode(audio: np.ndarray) -> np.ndarray:
    """Encode (..., n) float32 [-1, 1] or int16 PCM -> (..., nb*35) uint8.

    Vectorized across blocks; the closed-loop recurrence runs over the 64
    in-block positions only."""
    if audio.dtype == np.int16:
        x = audio.astype(np.int32)
    else:
        x = np.rint(np.clip(audio.astype(np.float64), -1.0, 1.0) * 32767.0).astype(np.int32)
    lead = x.shape[:-1]
    n = x.shape[-1]
    nb = n_blocks(n)
    pad = nb * BLOCK - n
    if pad:
        x = np.concatenate([x, np.zeros((*lead, pad), np.int32)], axis=-1)
    blocks = x.reshape(-1, nb, BLOCK)

    x0 = blocks[:, :, 0]
    # per-block predictor order: second order (x[i] ~ 2x[i-1] - x[i-2]) wins
    # on tonal blocks, first order on noise-like ones
    d1 = np.diff(blocks, axis=2, prepend=x0[:, :, None])
    r2 = np.diff(d1, axis=2, prepend=np.zeros_like(x0[:, :, None]))
    m1 = np.abs(d1).max(axis=2)
    m2 = np.abs(r2).max(axis=2)
    order2 = m2 < m1
    # residual scale: the smallest table entry with 7*scale >= the largest
    # open-loop residual (closed-loop residuals may clip at +-8/7: bounded)
    max_res = np.where(order2, m2, m1)
    e = np.searchsorted(SCALE_TABLE, -(-max_res // 7)).astype(np.int32)
    e = np.clip(e, 0, len(SCALE_TABLE) - 1)
    scale = SCALE_TABLE[e]

    nibs = np.empty((blocks.shape[0], nb, BLOCK), np.uint8)
    pred_x = x0.copy()
    pred_d = np.zeros_like(x0)  # stays 0 for first-order blocks
    inv_scale = (1.0 / scale).astype(np.float32)
    for i in range(BLOCK):
        r = (blocks[:, :, i] - (pred_x + pred_d)).astype(np.float32)
        q = np.clip(np.rint(r * inv_scale), -8, 7).astype(np.int32)
        step = q * scale
        pred_d = pred_d + np.where(order2, step, 0)
        pred_x = pred_x + np.where(order2, pred_d, step)
        nibs[:, :, i] = (q & 15).astype(np.uint8)

    out = np.empty((blocks.shape[0], nb, BYTES_PER_BLOCK), np.uint8)
    x0_u = (x0 & 0xFFFF).astype(np.uint16)
    out[:, :, 0] = (x0_u & 0xFF).astype(np.uint8)
    out[:, :, 1] = (x0_u >> 8).astype(np.uint8)
    out[:, :, 2] = (e | (order2.astype(np.int32) << 7)).astype(np.uint8)
    out[:, :, HEADER_BYTES:] = nibs[:, :, 0::2] | (nibs[:, :, 1::2] << 4)
    return out.reshape(*lead, nb * BYTES_PER_BLOCK)


_scale_tables: dict[torch.device, torch.Tensor] = {}


def _scale_table(device: torch.device) -> torch.Tensor:
    return cached_constant(_scale_tables, device, lambda: torch.from_numpy(SCALE_TABLE).to(device))


def adpcm_decode(data: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Decode (..., nb*35) uint8 -> (..., n_samples) float32 in [-1, 1], on
    ``data``'s device. Bit-exact with ``adpcm_decode_np``."""
    lead = data.shape[:-1]
    nb = data.shape[-1] // BYTES_PER_BLOCK
    b = data.reshape(*lead, nb, BYTES_PER_BLOCK).to(torch.int32)
    x0 = b[..., 0] | (b[..., 1] << 8)
    x0 = torch.where(x0 >= 32768, x0 - 65536, x0)
    hdr = b[..., 2]
    scale = _scale_table(data.device)[(hdr & 63).long()]
    order2 = (hdr >> 7) == 1
    payload = b[..., HEADER_BYTES:]
    nibs = torch.stack([payload & 15, (payload >> 4) & 15], dim=-1).reshape(*lead, nb, BLOCK)
    q = (nibs ^ 8) - 8  # sign-extend 4-bit two's complement
    # int32 sums, as numpy's and XLA's: torch would promote an integer cumsum to int64
    c1 = torch.cumsum(q * scale[..., None], dim=-1, dtype=torch.int32)  # first order
    c2 = torch.cumsum(c1, dim=-1, dtype=torch.int32)  # second order: integrate twice
    x = x0[..., None] + torch.where(order2[..., None], c2, c1)
    flat = x.reshape(*lead, nb * BLOCK)[..., :n_samples]
    return flat.to(torch.float32) * (1.0 / 32768.0)


@dataclass
class AdpcmAudio:
    """A file encoded once to the ADPCM transport (on the prefetch thread);
    the pipeline pads its *bytes* with zero blocks, which decode to silence,
    so dispatch encodes nothing. Slicing at a multiple of BLOCK samples is
    exact (blocks are independent): every model's chunk stride is a multiple
    of 64, which the segmented long-file dispatch relies on."""

    data: np.ndarray  # (n_blocks * BYTES_PER_BLOCK,) uint8
    n_samples: int  # the waveform's length in samples

    def block_slice(self, start_sample: int, n_blocks_out: int) -> np.ndarray:
        """Encoded bytes of ``n_blocks_out`` blocks from ``start_sample`` (a
        multiple of BLOCK); zero blocks past the end."""
        if start_sample % BLOCK:
            raise ValueError(
                f"ADPCM slice start {start_sample} is not a multiple of "
                f"{BLOCK}; re-run with an int16 transport for this geometry"
            )
        b0 = start_sample // BLOCK
        out = np.zeros(n_blocks_out * BYTES_PER_BLOCK, np.uint8)
        src = self.data[b0 * BYTES_PER_BLOCK : (b0 + n_blocks_out) * BYTES_PER_BLOCK]
        out[: src.shape[0]] = src
        return out


def adpcm_encode_audio(audio: np.ndarray) -> AdpcmAudio:
    """Encode one decoded file for padded dispatch later."""
    return AdpcmAudio(adpcm_encode(audio), int(audio.shape[-1]))


def adpcm_decode_np(data: np.ndarray, n_samples: int) -> np.ndarray:
    """The plain numpy decode that ``adpcm_decode`` is held to."""
    lead = data.shape[:-1]
    nb = data.shape[-1] // BYTES_PER_BLOCK
    b = data.reshape(*lead, nb, BYTES_PER_BLOCK).astype(np.int32)
    x0 = b[..., 0] | (b[..., 1] << 8)
    x0 = np.where(x0 >= 32768, x0 - 65536, x0)
    hdr = b[..., 2]
    scale = SCALE_TABLE[hdr & 63]
    order2 = (hdr >> 7) == 1
    payload = b[..., HEADER_BYTES:]
    nibs = np.stack([payload & 15, (payload >> 4) & 15], axis=-1).reshape(*lead, nb, BLOCK)
    q = (nibs ^ 8) - 8
    c1 = np.cumsum(q * scale[..., None], axis=-1)
    c2 = np.cumsum(c1, axis=-1)
    x = x0[..., None] + np.where(order2[..., None], c2, c1)
    flat = x.reshape(*lead, nb * BLOCK)[..., :n_samples]
    return flat.astype(np.float32) / 32768.0
