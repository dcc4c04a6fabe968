"""HuBERT (wav2vec2-style) encoder in PyTorch (counterpart of
``segma_tpu/models/hubert/encoder.py``).

- feature extractor: 7 bias-free strided convs (k/s: 10/5, 3/2 x4, 2/2 x2),
  GroupNorm with one group per channel on the first conv only (statistics in
  f32, eps 1e-5), exact GELU; rf_step 320 samples (20 ms);
- feature projection: LayerNorm(512) -> Linear(768);
- positional conv embedding: grouped conv (k=128, groups=16, padding 64 on
  both sides) with the last frame dropped, exact GELU, added, then LayerNorm;
- post-norm transformer layers; the hidden states are the INPUT of each
  layer plus the final output (HF indexing, n_layers + 1 entries).

Parameters are kept in f32 and cast to the compute dtype where they are
used, as flax does with ``dtype=bf16``. Self-attention is the Whisper port's
``MultiHeadAttention`` with a k bias, so it runs the flash kernels on the
card.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from segma_tpu_torch.models.whisper.encoder import MultiHeadAttention, layer_norm, linear


@dataclass(frozen=True)
class HubertEncoderConfig:
    hidden_size: int = 768
    n_layers: int = 12
    n_heads: int = 12
    ffn_dim: int = 3072
    conv_dim: tuple[int, ...] = (512,) * 7
    conv_kernels: tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_strides: tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16

    @classmethod
    def base(cls) -> "HubertEncoderConfig":
        return cls()


def _conv(x: torch.Tensor, conv: nn.Conv1d) -> torch.Tensor:
    """``conv`` applied in ``x``'s dtype (weights cast where used)."""
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv1d(
        x, conv.weight.to(x.dtype), bias, stride=conv.stride, padding=conv.padding,
        groups=conv.groups,
    )


class FeatureExtractor(nn.Module):
    """Raw waveform (B, T) -> (B, frames, conv_dim[-1]) conv features."""

    def __init__(self, cfg: HubertEncoderConfig, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        c_in = 1
        for i, (dim, k, s) in enumerate(zip(cfg.conv_dim, cfg.conv_kernels, cfg.conv_strides)):
            setattr(self, f"conv_{i}", nn.Conv1d(c_in, dim, k, stride=s, bias=False))
            c_in = dim
        self.group_norm = nn.GroupNorm(cfg.conv_dim[0], cfg.conv_dim[0], eps=1e-5)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = wav[:, None, :].to(self.dtype)  # (B, 1, T)
        for i in range(len(self.cfg.conv_dim)):
            x = _conv(x, getattr(self, f"conv_{i}"))
            if i == 0:
                # one group per channel: per-channel statistics over time
                gn = self.group_norm
                x = F.group_norm(x.float(), gn.num_groups, gn.weight, gn.bias, gn.eps).to(x.dtype)
            x = F.gelu(x)
        return x.transpose(1, 2)


class HubertTransformerLayer(nn.Module):
    """Post-norm block: x + attn -> LN -> x + ff -> LN."""

    def __init__(self, cfg: HubertEncoderConfig) -> None:
        super().__init__()
        self.attention = MultiHeadAttention(cfg.hidden_size, cfg.n_heads, k_bias=True)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.intermediate_dense = nn.Linear(cfg.hidden_size, cfg.ffn_dim)
        self.output_dense = nn.Linear(cfg.ffn_dim, cfg.hidden_size)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = layer_norm(x + self.attention(x), self.layer_norm)
        h = linear(F.gelu(linear(x, self.intermediate_dense)), self.output_dense)
        return layer_norm(x + h, self.final_layer_norm)


class HubertTransformer(nn.Module):
    """Conv features -> (last hidden state, hidden states)."""

    def __init__(self, cfg: HubertEncoderConfig, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.feature_layer_norm = nn.LayerNorm(cfg.conv_dim[-1], eps=1e-5)
        self.feature_projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)
        self.pos_conv = nn.Conv1d(
            cfg.hidden_size, cfg.hidden_size, cfg.pos_conv_kernel,
            padding=cfg.pos_conv_kernel // 2, groups=cfg.pos_conv_groups,
        )
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.layers = nn.ModuleList(HubertTransformerLayer(cfg) for _ in range(cfg.n_layers))

    def forward(
        self, feats: torch.Tensor, output_hidden_states: bool = False
    ) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
        x = layer_norm(feats.to(self.dtype), self.feature_layer_norm)
        x = linear(x, self.feature_projection)
        pos = _conv(x.transpose(1, 2), self.pos_conv).transpose(1, 2)
        if self.cfg.pos_conv_kernel % 2 == 0:  # SamePad: drop the extra frame
            pos = pos[:, :-1, :]
        x = layer_norm(x + F.gelu(pos), self.layer_norm)
        hidden_states = []
        for layer in self.layers:
            hidden_states.append(x)
            x = layer(x)
        hidden_states.append(x)
        return x, (tuple(hidden_states) if output_hidden_states else ())
