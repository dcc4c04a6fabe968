"""HuBERT (wav2vec2-style) encoder in PyTorch (counterpart of
``segma_tpu/models/hubert/encoder.py``).

- feature extractor: 7 strided convs (k/s: 10/5, 3/2 x4, 2/2 x2), bias-free
  unless ``conv_bias``, exact GELU; rf_step 320 samples (20 ms). HF's
  ``feat_extract_norm="group"``: GroupNorm with one group per channel on the
  first conv only; ``"layer"``: a LayerNorm over the channels after every
  conv (statistics in f32, eps 1e-5, both);
- feature projection: LayerNorm(512) -> Linear(768);
- positional conv embedding: grouped conv (k=128, groups=16, padding 64 on
  both sides) with the last frame dropped, exact GELU, added, then LayerNorm;
- post-norm transformer layers; the hidden states are the INPUT of each
  layer plus the final output (HF indexing, n_layers + 1 entries).

``stable_layer_norm`` (HF's ``do_stable_layer_norm``, the Large models'
layout): pre-norm layers, ``x + attn(LN(x))`` then ``x + ffn(LN(x))``; the
positional conv is added without a LayerNorm, and the encoder's
``layer_norm`` is applied after the last layer. The hidden states are then
each layer's un-normed input and the normed final output, as HF returns
them.

Parameters are kept in f32 and cast to the compute dtype where they are
used, as flax does with ``dtype=bf16``. Self-attention is the Whisper port's
``MultiHeadAttention`` with a k bias, so it runs the flash kernels on the
card.

``remat=True`` (``train.remat``) recomputes each transformer layer in the
backward pass (``torch.utils.checkpoint``, the role of flax's ``nn.remat``):
a layer's activations are not kept, and its forward, the flash forward
among it, runs again under autograd. The layers draw no dropout, so no RNG
state is saved for the recompute (``preserve_rng_state=False``: reading the
CUDA RNG state is not allowed while a CUDA graph captures the step); a layer
that took the training ``torch.Generator`` would need its state saved and
restored around the recompute.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from segma_tpu_torch.models.layers import row_linear
from segma_tpu_torch.models.whisper.encoder import MultiHeadAttention, layer_norm, linear
from segma_tpu_torch.parallel.collectives import SOLO, enter


FEAT_EXTRACT_NORMS = ("group", "layer")


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
    feat_extract_norm: str = "group"  # FEAT_EXTRACT_NORMS
    conv_bias: bool = False
    stable_layer_norm: bool = False

    def __post_init__(self) -> None:
        if self.feat_extract_norm not in FEAT_EXTRACT_NORMS:
            raise ValueError(f"feat_extract_norm must be one of {FEAT_EXTRACT_NORMS}, "
                             f"got {self.feat_extract_norm!r}")

    @classmethod
    def base(cls) -> "HubertEncoderConfig":
        return cls()


def _conv(x: torch.Tensor, conv: nn.Conv1d) -> torch.Tensor:
    """``conv`` applied in ``x``'s dtype (weights cast where used)."""
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv1d(
        x, conv.weight.to(x.dtype), bias, stride=conv.stride, padding=conv.padding,
        dilation=conv.dilation, groups=conv.groups,
    )


class FeatureExtractor(nn.Module):
    """Raw waveform (B, T) -> (B, frames, conv_dim[-1]) conv features."""

    def __init__(self, cfg: HubertEncoderConfig, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        c_in = 1
        for i, (dim, k, s) in enumerate(zip(cfg.conv_dim, cfg.conv_kernels, cfg.conv_strides)):
            setattr(self, f"conv_{i}", nn.Conv1d(c_in, dim, k, stride=s, bias=cfg.conv_bias))
            if cfg.feat_extract_norm == "layer":
                setattr(self, f"layer_norm_{i}", nn.LayerNorm(dim, eps=1e-5))
            c_in = dim
        if cfg.feat_extract_norm == "group":
            self.group_norm = nn.GroupNorm(cfg.conv_dim[0], cfg.conv_dim[0], eps=1e-5)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = wav[:, None, :].to(self.dtype)  # (B, 1, T)
        for i in range(len(self.cfg.conv_dim)):
            x = _conv(x, getattr(self, f"conv_{i}"))
            if self.cfg.feat_extract_norm == "layer":  # over the channels, every conv
                x = layer_norm(x.transpose(1, 2), getattr(self, f"layer_norm_{i}")).transpose(1, 2)
            elif i == 0:
                # one group per channel: per-channel statistics over time
                gn = self.group_norm
                x = F.group_norm(x.float(), gn.num_groups, gn.weight, gn.bias, gn.eps).to(x.dtype)
            x = F.gelu(x)
        return x.transpose(1, 2)


class HubertTransformerLayer(nn.Module):
    """Post-norm block: x + attn -> LN -> x + ff -> LN; under
    ``stable_layer_norm`` pre-norm: x + attn(LN(x)) -> x + ff(LN(x)). Under
    tensor parallelism ``intermediate_dense`` holds the member's block of
    output features (its input a ``collectives.enter``) and ``output_dense``
    is row-parallel (``models.layers.row_linear``). WavLM's layer is this
    block with its own attention."""

    model_group = SOLO

    def __init__(self, cfg: HubertEncoderConfig, attention: nn.Module | None = None) -> None:
        super().__init__()
        self.stable = cfg.stable_layer_norm
        self.attention = (MultiHeadAttention(cfg.hidden_size, cfg.n_heads, k_bias=True)
                          if attention is None else attention)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.intermediate_dense = nn.Linear(cfg.hidden_size, cfg.ffn_dim)
        self.output_dense = nn.Linear(cfg.ffn_dim, cfg.hidden_size)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)

    def feed_forward(self, x: torch.Tensor) -> torch.Tensor:
        model = self.model_group
        return row_linear(F.gelu(linear(enter(x, model), self.intermediate_dense)),
                          self.output_dense, model)

    def block(self, x: torch.Tensor, attend) -> torch.Tensor:
        """``x`` through ``attend`` (the attention on its input) and the MLP."""
        if self.stable:
            x = x + attend(layer_norm(x, self.layer_norm))
            return x + self.feed_forward(layer_norm(x, self.final_layer_norm))
        x = layer_norm(x + attend(x), self.layer_norm)
        return layer_norm(x + self.feed_forward(x), self.final_layer_norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x, self.attention)


class HubertTransformer(nn.Module):
    """Conv features -> (last hidden state, hidden states)."""

    def __init__(self, cfg: HubertEncoderConfig, dtype: torch.dtype = torch.bfloat16,
                 remat: bool = False) -> None:
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.remat = remat
        self.feature_layer_norm = nn.LayerNorm(cfg.conv_dim[-1], eps=1e-5)
        self.feature_projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)
        self.pos_conv = nn.Conv1d(
            cfg.hidden_size, cfg.hidden_size, cfg.pos_conv_kernel,
            padding=cfg.pos_conv_kernel // 2, groups=cfg.pos_conv_groups,
        )
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.layers = nn.ModuleList(HubertTransformerLayer(cfg) for _ in range(cfg.n_layers))

    def embed(self, feats: torch.Tensor) -> torch.Tensor:
        """Conv features -> the first layer's input: projection, positional
        conv, LayerNorm (none under ``stable_layer_norm``)."""
        x = layer_norm(feats.to(self.dtype), self.feature_layer_norm)
        x = linear(x, self.feature_projection)
        pos = _conv(x.transpose(1, 2), self.pos_conv).transpose(1, 2)
        if self.cfg.pos_conv_kernel % 2 == 0:  # SamePad: drop the extra frame
            pos = pos[:, :-1, :]
        x = x + F.gelu(pos)
        return x if self.cfg.stable_layer_norm else layer_norm(x, self.layer_norm)

    def final(self, x: torch.Tensor) -> torch.Tensor:
        """The last layer's output -> the encoder's: LayerNorm under
        ``stable_layer_norm``, as it is."""
        return layer_norm(x, self.layer_norm) if self.cfg.stable_layer_norm else x

    def forward(
        self, feats: torch.Tensor, output_hidden_states: bool = False
    ) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
        x = self.embed(feats)
        hidden_states = []
        remat = self.remat and torch.is_grad_enabled()
        for layer in self.layers:
            hidden_states.append(x)
            if remat:
                x = torch.utils.checkpoint.checkpoint(layer, x, use_reentrant=False,
                                                      preserve_rng_state=False)
            else:
                x = layer(x)
        x = self.final(x)
        hidden_states.append(x)
        return x, (tuple(hidden_states) if output_hidden_states else ())
