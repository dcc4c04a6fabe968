"""Whisper audio encoder in PyTorch (counterpart of
``segma_tpu/models/whisper/encoder.py``).

Two convs (k3/s1, k3/s2) with exact GELU, sinusoidal position table, pre-LN
transformer layers (MHA with q/v/out bias and bias-free k, LayerNorm eps
1e-5), final LayerNorm. Hidden states follow HF indexing:

    hidden_states[0]   = conv + positions output
    hidden_states[i]   = output of layer i           (1 <= i < n_layers)
    hidden_states[n]   = LayerNorm(output of layer n)

Parameters are kept in f32 and cast to the compute dtype where they are
used, as flax does with ``dtype=bf16``; LayerNorm statistics run in f32.
Self-attention goes through ``ops.attention.attention_core``: the CUDA flash
kernel on the card, the plain version on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from segma_tpu_torch.models.layers import linear
from segma_tpu_torch.ops.attention import attention_core


@dataclass(frozen=True)
class WhisperEncoderConfig:
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 6
    ffn_dim: int = 2048
    n_mels: int = 80
    max_positions: int = 1500

    @classmethod
    def tiny(cls) -> "WhisperEncoderConfig":
        return cls(d_model=384, n_heads=6, n_layers=4, ffn_dim=1536)

    @classmethod
    def base(cls) -> "WhisperEncoderConfig":
        return cls(d_model=512, n_heads=8, n_layers=6, ffn_dim=2048)


def sinusoidal_positions(length: int, channels: int) -> np.ndarray:
    """Whisper's sinusoid table: [sin | cos] halves, log-spaced timescales."""
    assert channels % 2 == 0
    log_timescale_increment = np.log(10000.0) / (channels // 2 - 1)
    inv_timescales = np.exp(
        -log_timescale_increment * np.arange(channels // 2, dtype=np.float64)
    )
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate(
        [np.sin(scaled_time), np.cos(scaled_time)], axis=1
    ).astype(np.float32)


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm computed in f32, returned in ``x``'s dtype."""
    return F.layer_norm(
        x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps
    ).to(x.dtype)


class MultiHeadAttention(nn.Module):
    """Transformer MHA: q scaled by head_dim**-0.5; Whisper's k_proj has no bias."""

    def __init__(self, d_model: int, n_heads: int, k_bias: bool = False) -> None:
        super().__init__()
        self.n_heads = n_heads
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(d_model, d_model, bias=k_bias)
        self.v_proj = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d_model = x.shape
        head_dim = d_model // self.n_heads

        def split(t: torch.Tensor) -> torch.Tensor:
            return t.view(b, s, self.n_heads, head_dim)

        out = attention_core(
            split(linear(x, self.q_proj)),
            split(linear(x, self.k_proj)),
            split(linear(x, self.v_proj)),
            sm_scale=head_dim**-0.5,
            dtype=x.dtype,
        )
        return linear(out.reshape(b, s, d_model), self.out_proj)


class EncoderLayer(nn.Module):
    """Pre-LN transformer block (self-attention + exact-GELU MLP)."""

    def __init__(self, cfg: WhisperEncoderConfig) -> None:
        super().__init__()
        self.self_attn_layer_norm = nn.LayerNorm(cfg.d_model, eps=1e-5)
        self.self_attn = MultiHeadAttention(cfg.d_model, cfg.n_heads)
        self.final_layer_norm = nn.LayerNorm(cfg.d_model, eps=1e-5)
        self.fc1 = nn.Linear(cfg.d_model, cfg.ffn_dim)
        self.fc2 = nn.Linear(cfg.ffn_dim, cfg.d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(layer_norm(x, self.self_attn_layer_norm))
        h = layer_norm(x, self.final_layer_norm)
        h = linear(F.gelu(linear(h, self.fc1)), self.fc2)
        return x + h


class WhisperEncoder(nn.Module):
    """(B, n_mels, frames) log-mel -> (last hidden state, hidden states)."""

    def __init__(self, cfg: WhisperEncoderConfig, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.conv1 = nn.Conv1d(cfg.n_mels, cfg.d_model, 3, padding=1)
        self.conv2 = nn.Conv1d(cfg.d_model, cfg.d_model, 3, stride=2, padding=1)
        self.embed_positions = nn.Parameter(
            torch.from_numpy(sinusoidal_positions(cfg.max_positions, cfg.d_model)),
            requires_grad=False,
        )
        self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.n_layers))
        self.layer_norm = nn.LayerNorm(cfg.d_model, eps=1e-5)

    def _conv(self, x: torch.Tensor, conv: nn.Conv1d) -> torch.Tensor:
        return F.gelu(F.conv1d(
            x, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
            stride=conv.stride, padding=conv.padding,
        ))

    def forward(
        self, mel: torch.Tensor, output_hidden_states: bool = False
    ) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
        x = self._conv(mel.to(self.dtype), self.conv1)
        x = self._conv(x, self.conv2).transpose(1, 2)  # (B, frames/2, d_model)
        x = x + self.embed_positions[: x.shape[1]].to(self.dtype)
        hidden_states = [x]
        for layer in self.layers:
            x = layer(x)
            hidden_states.append(x)
        x = layer_norm(x, self.layer_norm)
        hidden_states[-1] = x  # HF: the final entry carries the last LayerNorm
        return x, (tuple(hidden_states) if output_hidden_states else ())
