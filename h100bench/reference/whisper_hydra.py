"""Plain ``surgical_hydra`` over the Whisper encoder, in f32, and the
serving path's frame grid worked out again from the audio.

The model (segma's ``surgical_hydra``, Whisper-base encoder as published):
each 4 s chunk zero-padded to Whisper's 30 s; Whisper's log-mel (periodic
Hann STFT of 400 at hop 160, centred with reflect padding, the last frame
dropped, power through the slaney mel filterbank of 80, log10 clamped at
1e-10, each example's max - 8 floor, (x + 4) / 4); two convolutions (k3,
then k3 stride 2) with exact GELU; the sinusoid positions; pre-LayerNorm
layers (q, k, v and out projections, k without bias, 64-wide heads, an
exact-GELU MLP); the final LayerNorm on the last layer's output; the
softmax-weighted sum of the layers' outputs; a BiLSTM over all positions,
of which the chunk's frames are kept; one linear head per label.

The grid (segma's serving geometry): frames every 320 samples; a 4 s chunk
of 64000 samples gives 64000 // 321 = 199 frames (segma counts a step of
321 where a kernel is even), so chunks start every 199 x 320 samples; a
file of n samples has its whole chunks' frames, and for a tail of at least
400 samples tail // 321 more, its chunk zero-padded.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from h100bench.reference.common import Cast, ieee_f32, layer_norm, softmax_mix

SR = 16_000
N_FFT, HOP, N_MELS = 400, 160, 80
CHUNK = 64_000
FRAME = 320
CONTEXT = 480_000  # Whisper's 30 s
TAIL_MIN = 400


def n_windows(samples: int) -> int:
    return samples // (FRAME + 1)


WINDOWS = n_windows(CHUNK)  # 199
STRIDE = WINDOWS * FRAME  # 63680


def grid(n: int) -> tuple[int, int]:
    """(whole chunks, frames) of a file of ``n`` samples."""
    whole = (n - CHUNK) // STRIDE + 1 if n >= CHUNK else 0
    tail = n - whole * STRIDE
    return whole, whole * WINDOWS + (n_windows(tail) if tail >= TAIL_MIN else 0)


def slaney_filterbank() -> np.ndarray:
    """(201, 80) slaney-scale, slaney-normalised triangular filters over
    0 to 8 kHz (librosa's ``filters.mel(sr=16000, n_fft=400, n_mels=80)``,
    transposed)."""

    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        lin = f / (200.0 / 3)
        log = 15.0 + np.log(np.maximum(f, 1e-9) / 1000.0) / (np.log(6.4) / 27)
        return np.where(f >= 1000.0, log, lin)

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        return np.where(m >= 15.0, 1000.0 * np.exp((np.log(6.4) / 27) * (m - 15.0)),
                        (200.0 / 3) * m)

    freqs = np.linspace(0, SR / 2, N_FFT // 2 + 1)
    hz = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(SR / 2), N_MELS + 2))
    fb = np.zeros((N_FFT // 2 + 1, N_MELS))
    for m in range(N_MELS):
        lo, mid, hi = hz[m], hz[m + 1], hz[m + 2]
        up = (freqs - lo) / (mid - lo)
        down = (hi - freqs) / (hi - mid)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down)) * 2.0 / (hi - lo)
    return fb.astype(np.float32)


def sinusoids(length: int, channels: int) -> torch.Tensor:
    """Whisper's position table: [sin | cos], log-spaced timescales up to 10000."""
    inc = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return torch.from_numpy(np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32))


def chunks(n: int) -> int:
    """The chunks a file of ``n`` samples needs (padding not counted)."""
    return -(-grid(n)[1] // WINDOWS)


def model(sd: dict, config: dict, device, precision: str = "f32") -> "WhisperHydra":
    """The reference of a configuration file (its encoder widths, BiLSTM and
    labels), from the seeded state dict."""
    program = config["program"]
    return WhisperHydra(sd, config["encoder"], program["model"]["config"]["lstm"],
                        len(program["data"]["classes"]), device, precision)


class WhisperHydra:
    """The model on ``device`` from the state dict ``sd`` (names of the
    port's module, which is where the seeded weights were named), at the
    published widths ``enc`` (Hugging Face keys) and the BiLSTM ``lstm``."""

    def __init__(self, sd: dict, enc: dict, lstm: dict, n_labels: int, device,
                 precision: str = "f32") -> None:
        self.sd = {k: v.to(device=device, dtype=torch.float32) for k, v in sd.items()}
        self.enc, self.n_labels, self.device = enc, n_labels, torch.device(device)
        self.cast = Cast(precision)
        self.window = torch.hann_window(N_FFT, periodic=True, device=device)
        self.fb = torch.from_numpy(slaney_filterbank()).to(device)
        self.pos = sinusoids(enc["max_source_positions"], enc["d_model"]).to(device)
        self.lstm = torch.nn.LSTM(enc["d_model"], lstm["hidden_size"], lstm["num_layers"],
                                  bidirectional=lstm["bidirectional"], batch_first=True).to(device)
        with torch.no_grad():
            for name, p in self.lstm.named_parameters():
                p.copy_(self.cast(self.sd[f"lstm_shared.lstm.{name}"]))

    def log_mel(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, 480000) -> (B, 80, 3000)."""
        spec = torch.stft(wav, N_FFT, HOP, window=self.window, center=True, pad_mode="reflect",
                          return_complex=True)[..., :-1]
        power = spec.real.square() + spec.imag.square()  # (B, 201, 3000)
        mel = torch.log10(torch.clamp(torch.matmul(self.fb.t(), power), min=1e-10))
        mel = torch.maximum(mel, mel.amax(dim=(1, 2), keepdim=True) - 8.0)
        return (mel + 4.0) / 4.0

    def encoder_layers(self, mel: torch.Tensor) -> list[torch.Tensor]:
        sd, c = self.sd, self.cast
        x = F.gelu(c.conv1d(mel, sd["encoder.conv1.weight"], sd["encoder.conv1.bias"], padding=1))
        x = F.gelu(c.conv1d(x, sd["encoder.conv2.weight"], sd["encoder.conv2.bias"], stride=2,
                            padding=1))
        x = x.transpose(1, 2) + self.pos[: x.shape[2]]
        b, s, d = x.shape
        heads = self.enc["encoder_attention_heads"]
        hd = d // heads
        outs = []
        for i in range(self.enc["encoder_layers"]):
            p = f"encoder.layers.{i}"
            h = layer_norm(x, sd, f"{p}.self_attn_layer_norm")
            q = c.linear(h, sd[f"{p}.self_attn.q_proj.weight"], sd[f"{p}.self_attn.q_proj.bias"])
            k = c.linear(h, sd[f"{p}.self_attn.k_proj.weight"])
            v = c.linear(h, sd[f"{p}.self_attn.v_proj.weight"], sd[f"{p}.self_attn.v_proj.bias"])
            split = lambda t: t.view(b, s, heads, hd).transpose(1, 2)  # noqa: E731
            a = c.attention(split(q), split(k), split(v), hd**-0.5).transpose(1, 2).reshape(b, s, d)
            x = x + c.linear(a, sd[f"{p}.self_attn.out_proj.weight"],
                             sd[f"{p}.self_attn.out_proj.bias"])
            h = layer_norm(x, sd, f"{p}.final_layer_norm")
            h = F.gelu(c.linear(h, sd[f"{p}.fc1.weight"], sd[f"{p}.fc1.bias"]))
            x = x + c.linear(h, sd[f"{p}.fc2.weight"], sd[f"{p}.fc2.bias"])
            outs.append(x)
        outs[-1] = layer_norm(x, sd, "encoder.layer_norm")
        return outs

    @torch.no_grad()
    def chunk_logits(self, chunks: torch.Tensor) -> torch.Tensor:
        """(B, 64000) f32 chunks -> (B, 199, labels) logits, in IEEE f32."""
        with ieee_f32():
            wav = F.pad(chunks, (0, CONTEXT - chunks.shape[1]))
            mixed = softmax_mix(torch.stack(self.encoder_layers(self.log_mel(wav))),
                                self.sd["layer_mix.layer_weights"])
            out, _ = self.lstm(self.cast(mixed))
            out = out[:, :WINDOWS]
            return self.cast.linear(out, self.sd["heads.heads.weight"],
                                    self.sd["heads.heads.bias"])

    def file_logits(self, pcm: np.ndarray, batch: int = 16) -> torch.Tensor:
        """(frames, labels) f32 logits of a whole file of int16 samples."""
        n = pcm.shape[0]
        whole, frames = grid(n)
        n_chunks = -(-frames // WINDOWS)
        audio = torch.from_numpy(pcm.astype(np.float32) / 32768.0).to(self.device)
        audio = F.pad(audio, (0, max(0, (n_chunks - 1) * STRIDE + CHUNK - n)))
        out = []
        for lo in range(0, n_chunks, batch):
            idx = torch.arange(lo, min(n_chunks, lo + batch), device=self.device)
            starts = idx * STRIDE
            chunks = audio[starts[:, None] + torch.arange(CHUNK, device=self.device)[None, :]]
            out.append(self.chunk_logits(chunks).reshape(-1, self.n_labels))
        return torch.cat(out)[:frames]
