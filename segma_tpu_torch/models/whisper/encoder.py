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

A module copy that ``parallel.sharding.shard_params`` made for one member of
a mesh carries its groups (``model_group``, ``seq_group``); every other
module has the group of one, and runs as it always did.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from segma_tpu_torch.models.layers import linear, row_linear
from segma_tpu_torch.ops.attention import attention_core
from segma_tpu_torch.parallel.collectives import SOLO, enter, gather

_seq_degrade_warned: set = set()


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
    """Transformer MHA: q scaled by head_dim**-0.5; Whisper's k_proj has no bias.

    Under tensor parallelism (``parallel.sharding``: ``model_group`` set, q,
    k and v holding the member's block of output features, ``out_proj`` its
    block of input features) each member attends its own heads and
    ``out_proj`` sums the members' partial products, its bias added once.
    When the heads do not divide over the group but the features do (JAX
    shards features, not heads), q, k and v are gathered over the group,
    every member attends all heads, and keeps its block of the output's
    features for ``out_proj``. Under sequence parallelism (``seq_group``)
    the member's rows attend to the keys and values gathered over the
    group's time blocks. Under autograd the input's gradient is summed over
    ``model`` (``collectives.enter``) and a gathered block's over its group
    (``collectives.gather``)."""

    model_group = SOLO

    def __init__(self, d_model: int, n_heads: int, k_bias: bool = False) -> None:
        super().__init__()
        self.n_heads = n_heads
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(d_model, d_model, bias=k_bias)
        self.v_proj = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, x: torch.Tensor, seq_group=SOLO) -> torch.Tensor:
        b, s, d_model = x.shape
        head_dim = d_model // self.n_heads
        model = self.model_group
        x = enter(x, model)
        q, k, v = (linear(x, p) for p in (self.q_proj, self.k_proj, self.v_proj))
        gathered = self.n_heads % model.size != 0
        if gathered:
            q, k, v = (gather(t, model, dim=2) for t in (q, k, v))
        if seq_group.size > 1:
            k, v = (gather(t, seq_group, dim=1) for t in (k, v))
        heads = q.shape[2] // head_dim

        def split(t: torch.Tensor) -> torch.Tensor:
            return t.view(b, t.shape[1], heads, head_dim)

        out = attention_core(
            split(q), split(k), split(v), sm_scale=head_dim**-0.5, dtype=x.dtype,
        ).reshape(b, s, heads * head_dim)
        if gathered:
            width = out.shape[2] // model.size
            out = out[..., model.rank * width : (model.rank + 1) * width]
        return row_linear(out, self.out_proj, model)


class EncoderLayer(nn.Module):
    """Pre-LN transformer block (self-attention + exact-GELU MLP); under
    tensor parallelism fc1 holds the member's block of output features (its
    input a ``collectives.enter``) and fc2 is row-parallel."""

    model_group = SOLO

    def __init__(self, cfg: WhisperEncoderConfig) -> None:
        super().__init__()
        self.self_attn_layer_norm = nn.LayerNorm(cfg.d_model, eps=1e-5)
        self.self_attn = MultiHeadAttention(cfg.d_model, cfg.n_heads)
        self.final_layer_norm = nn.LayerNorm(cfg.d_model, eps=1e-5)
        self.fc1 = nn.Linear(cfg.d_model, cfg.ffn_dim)
        self.fc2 = nn.Linear(cfg.ffn_dim, cfg.d_model)

    def forward(self, x: torch.Tensor, seq_group=SOLO) -> torch.Tensor:
        x = x + self.self_attn(layer_norm(x, self.self_attn_layer_norm), seq_group)
        h = enter(layer_norm(x, self.final_layer_norm), self.model_group)
        h = row_linear(F.gelu(linear(h, self.fc1)), self.fc2, self.model_group)
        return x + h


class WhisperEncoder(nn.Module):
    """(B, n_mels, frames) log-mel -> (last hidden state, hidden states).

    Under sequence parallelism (``seq_group``, set by ``parallel.sharding``)
    the conv front end runs whole on every member, as JAX anchors it, and
    each member keeps its block of the positions' time axis (``time_group``):
    the layers' LayerNorms and MLPs are pointwise over time, attention
    gathers the keys, and the hidden states stay local (the caller gathers
    them)."""

    seq_group = SOLO

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

    def time_group(self, n_mel_frames: int):
        """The group the time axis splits over for ``n_mel_frames`` of
        log-mel: ``seq_group`` when it divides the encoder's positions, else
        the group of one, with a warning, as JAX's ``shard_time_axis`` then
        replicates the work."""
        group, n = self.seq_group, (n_mel_frames + 1) // 2  # conv2: k3, s2, pad 1
        if n % group.size == 0:
            return group
        if (n, group.size) not in _seq_degrade_warned:
            _seq_degrade_warned.add((n, group.size))
            warnings.warn(
                f"sequence parallelism disabled for {n} positions: not divisible by mesh "
                f"seq={group.size}; every member of the seq group computes the whole axis",
                stacklevel=2,
            )
        return SOLO

    def forward(
        self, mel: torch.Tensor, output_hidden_states: bool = False
    ) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
        x = self._conv(mel.to(self.dtype), self.conv1)
        x = self._conv(x, self.conv2).transpose(1, 2)  # (B, frames/2, d_model)
        x = x + self.embed_positions[: x.shape[1]].to(self.dtype)
        seq = self.time_group(mel.shape[-1])
        if seq.size > 1:
            n = x.shape[1] // seq.size
            x = x[:, seq.rank * n : (seq.rank + 1) * n]
        hidden_states = [x]
        for layer in self.layers:
            x = layer(x, seq)
            hidden_states.append(x)
        x = layer_norm(x, self.layer_norm)
        hidden_states[-1] = x  # HF: the final entry carries the last LayerNorm
        return x, (tuple(hidden_states) if output_hidden_states else ())
