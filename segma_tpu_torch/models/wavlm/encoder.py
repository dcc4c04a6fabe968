"""WavLM encoder in PyTorch (counterpart of ``segma_tpu/models/wavlm/encoder.py``).

HuBERT's skeleton (``models/hubert/encoder.py``: the conv feature extractor,
the projection, the positional conv, post-norm layers with exact GELU and
eps 1e-5, or under ``stable_layer_norm`` pre-norm layers and the LayerNorm
conv front end of WavLM-Large) with WavLM's gated relative position bias in
every attention, as HF's ``WavLMModel``:

- T5-style bucketed relative positions (``relative_position_buckets``:
  320 buckets, max distance 800) embedded to a per-head bias by layer 0's
  ``rel_attn_embed``, a bare (buckets, heads) parameter; every later layer
  reuses layer 0's bias;
- each layer gates the bias per head and query from its own input: an
  8-wide projection of each head's slice, summed in pairs of 4, a sigmoid
  in f32, ``a * (b * const - 1) + 2`` with a learned per-head ``const``;
- q scaled by head_dim**-0.5 in the compute dtype, the scores and the bias
  in f32, the softmax in f32 and then cast: plain torch ops, as in JAX,
  where this attention is XLA and reaches no Pallas kernel.

Two paths, chosen by ``ops.attention.wavlm_kernel_path``. On the card, in
bf16, at head dim 64 and unrecorded by autograd (serving, validation,
exported programs) the attention is the op ``segma_tpu_torch::wavlm_attn_fwd``
(``csrc/flash_attn.cu``'s bias kernel, one launch a layer): as the bucket
depends on j - i alone, layer 0 gathers each head's (2T - 1) row of biases
once, ``rel[h, T - 1 + j - i]``, and hands it down the layers; such a call
over more than ``WAVLM_MAX_LEN`` (4096) frames, a chunk of about 82 s,
raises a ValueError rather than falling back to the plain path. Otherwise
(training, f32, the CPU) the attention is plain torch over the (H, T, T)
bias: the bucket table is built in numpy and held on the device as a
one-hot (T * T, buckets) f32 matrix, one buffer per (length, device), so
that a step captured in a CUDA graph copies nothing from the host; the bias
is that matrix times ``rel_attn_embed`` (exact: one product of 1 per row),
and its gradient a product too, summed in one fixed order; a gather's
backward would scatter-add into the table. Each layer's gate and attention
core are the span ``model.rel_attention`` (CUDA-event timed).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from segma_tpu_torch import telemetry
from segma_tpu_torch.models.base import no_tf32
from segma_tpu_torch.models.hubert.encoder import (
    HubertEncoderConfig,
    HubertTransformer,
    HubertTransformerLayer,
)
from segma_tpu_torch.models.layers import row_linear
from segma_tpu_torch.models.whisper.encoder import linear
from segma_tpu_torch.ops import cached_constant
from segma_tpu_torch.ops.attention import wavlm_attn_op, wavlm_kernel_path
from segma_tpu_torch.parallel.collectives import SOLO, enter, gather


@dataclass(frozen=True)
class WavLMEncoderConfig(HubertEncoderConfig):
    num_buckets: int = 320
    max_distance: int = 800

    @classmethod
    def base(cls) -> "WavLMEncoderConfig":
        return cls()


@lru_cache(maxsize=8)
def relative_position_buckets(
    length: int, num_buckets: int = 320, max_distance: int = 800
) -> np.ndarray:
    """(length, length) int32 T5-style bucket ids (a copy of JAX's)."""
    ctx = np.arange(length)[:, None]
    mem = np.arange(length)[None, :]
    return _buckets(mem - ctx, num_buckets, max_distance)


def relative_position_row(length: int, num_buckets: int = 320,
                          max_distance: int = 800) -> np.ndarray:
    """(2 length - 1,) int32 bucket ids of the differences j - i from
    -(length - 1) to length - 1: entry length - 1 + j - i is row i, column
    j of ``relative_position_buckets``."""
    return _buckets(np.arange(-(length - 1), length), num_buckets, max_distance)


def _buckets(rel: np.ndarray, num_buckets: int, max_distance: int) -> np.ndarray:
    half = num_buckets // 2
    buckets = (rel > 0).astype(np.int64) * half
    rel = np.abs(rel)
    max_exact = half // 2
    is_small = rel < max_exact
    with np.errstate(divide="ignore"):
        large = max_exact + (
            np.log(np.maximum(rel, 1) / max_exact)
            / math.log(max_distance / max_exact)
            * (half - max_exact)
        ).astype(np.int64)
    large = np.minimum(large, half - 1)
    buckets += np.where(is_small, rel, large)
    return buckets.astype(np.int32)


class WavLMAttention(nn.Module):
    """MHA with the gated relative position bias added to the scores; under
    tensor parallelism head-parallel as ``whisper.encoder.MultiHeadAttention``."""

    model_group = SOLO

    def __init__(self, cfg: WavLMEncoderConfig, has_relative_position_bias: bool) -> None:
        super().__init__()
        d, self.n_heads = cfg.hidden_size, cfg.n_heads
        self.num_buckets, self.max_distance = cfg.num_buckets, cfg.max_distance
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)
        self.gru_rel_pos_linear = nn.Linear(d // self.n_heads, 8)
        self.gru_rel_pos_const = nn.Parameter(torch.ones(1, self.n_heads, 1, 1))
        if has_relative_position_bias:  # flax's param: no ``.weight``
            self.rel_attn_embed = nn.Parameter(torch.zeros(cfg.num_buckets, self.n_heads))
        self._buckets: dict[tuple[int, torch.device], torch.Tensor] = {}
        self._rows: dict[tuple[int, torch.device], torch.Tensor] = {}

    def bucket_onehot(self, length: int, device: torch.device) -> torch.Tensor:
        """(length * length, buckets) f32 one-hot of the bucket ids on
        ``device``, uploaded once."""
        def make() -> torch.Tensor:
            ids = relative_position_buckets(length, self.num_buckets, self.max_distance)
            onehot = np.eye(self.num_buckets, dtype=np.float32)[ids.reshape(-1)]
            return torch.from_numpy(onehot).to(device)

        return cached_constant(self._buckets, (length, torch.device(device)), make)

    def bucket_row(self, length: int, device: torch.device) -> torch.Tensor:
        """(2 length - 1,) int64 bucket ids of j - i on ``device``, uploaded once."""
        def make() -> torch.Tensor:
            ids = relative_position_row(length, self.num_buckets, self.max_distance)
            return torch.from_numpy(ids.astype(np.int64)).to(device)

        return cached_constant(self._rows, (length, torch.device(device)), make)

    def forward(
        self, x: torch.Tensor, position_bias: torch.Tensor | None
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(B, T, D) in the compute dtype, layer 0's bias (None in layer 0
        itself) -> (output, bias). The bias is the (H, T, T) f32 tensor on
        the plain path and the (H, 2T - 1) f32 rows on the kernel's. Under
        tensor parallelism H is the member's heads, whose columns of
        ``rel_attn_embed`` and ``gru_rel_pos_const`` (replicated, as in JAX)
        it takes; those two and the gate's projection enter each member's
        work through ``collectives.enter``, so that their gradients, each
        member's of its own heads, are summed over ``model``, as is ``x``'s."""
        b, t, d = x.shape
        h = self.n_heads
        hd = d // h
        model = self.model_group
        if position_bias is None:  # layer 0 chooses the path; the others take its bias's
            recorded = torch.is_grad_enabled() and (
                x.requires_grad or any(p.requires_grad for p in self.parameters()))
            fused = wavlm_kernel_path(x, hd, recorded)
        else:
            fused = position_bias.dim() == 2
        x = enter(x, model)
        q, k, v = (linear(x, p) for p in (self.q_proj, self.k_proj, self.v_proj))
        gathered = h % model.size != 0  # heads that do not divide: every member takes all
        if gathered:
            q, k, v = (gather(y, model, dim=2) for y in (q, k, v))
        n = h if gathered else h // model.size
        heads = slice(0, h) if gathered else slice(model.rank * n, (model.rank + 1) * n)
        if position_bias is None:
            if not hasattr(self, "rel_attn_embed"):
                raise ValueError("the first layer must own the relative position embedding")
            embed = enter(self.rel_attn_embed, model)[:, heads]
            if fused:
                position_bias = embed.index_select(0, self.bucket_row(t, x.device)).t().contiguous()
            else:
                with no_tf32():
                    bias = self.bucket_onehot(t, x.device) @ embed
                position_bias = bias.view(t, t, n).permute(2, 0, 1)
        with telemetry.span("model.rel_attention", cuda_time=True):
            gate_proj = self.gru_rel_pos_linear
            proj = F.linear(x.view(b, t, h, hd)[:, :, heads].transpose(1, 2),
                            enter(gate_proj.weight, model).to(x.dtype),
                            enter(gate_proj.bias, model).to(x.dtype))
            gates = torch.sigmoid(proj.view(b, n, t, 2, 4).sum(-1).float())  # (B, H, T, 2)
            gate_a, gate_b = gates[..., 0:1], gates[..., 1:2]
            const = enter(self.gru_rel_pos_const, model)[:, heads]
            gate_out = gate_a * (gate_b * const - 1.0) + 2.0  # (B, H, T, 1)
            if fused:
                out = wavlm_attn_op(q.view(b, t, n, hd), k.view(b, t, n, hd),
                                    v.view(b, t, n, hd), gate_out.view(b, n, t),
                                    position_bias, hd**-0.5).reshape(b, t, n * hd)
            else:
                q = (q.view(b, t, n, hd) * hd**-0.5).transpose(1, 2)
                k = k.view(b, t, n, hd).transpose(1, 2)
                v = v.view(b, t, n, hd).transpose(1, 2)
                with no_tf32():  # f32 scores of the compute-dtype q and k
                    scores = q.float() @ k.float().transpose(-1, -2)
                attn = torch.softmax(scores + gate_out * position_bias[None], dim=-1).to(x.dtype)
                out = (attn @ v).transpose(1, 2).reshape(b, t, n * hd)
        if gathered:
            width = d // model.size
            out = out[..., model.rank * width : (model.rank + 1) * width]
        return row_linear(out, self.out_proj, model), position_bias


class WavLMTransformerLayer(HubertTransformerLayer):
    """HuBERT's block (post-norm, or pre-norm under ``stable_layer_norm``;
    tensor-parallel alike) with WavLM's attention, its bias passed along."""

    def __init__(self, cfg: WavLMEncoderConfig, has_relative_position_bias: bool) -> None:
        super().__init__(cfg, WavLMAttention(cfg, has_relative_position_bias))

    def forward(
        self, x: torch.Tensor, position_bias: torch.Tensor | None
    ) -> tuple[torch.Tensor, torch.Tensor]:
        bias = [position_bias]

        def attend(h: torch.Tensor) -> torch.Tensor:
            out, bias[0] = self.attention(h, bias[0])
            return out

        return self.block(x, attend), bias[0]


class WavLMTransformer(HubertTransformer):
    """Conv features -> (last hidden state, hidden states: the input of each
    layer and the final output). ``remat`` recomputes each layer in the
    backward pass, as HuBERT's does."""

    def __init__(self, cfg: WavLMEncoderConfig, dtype: torch.dtype = torch.bfloat16,
                 remat: bool = False) -> None:
        super().__init__(cfg, dtype, remat)
        self.layers = nn.ModuleList(
            WavLMTransformerLayer(cfg, has_relative_position_bias=i == 0)
            for i in range(cfg.n_layers))

    def forward(
        self, feats: torch.Tensor, output_hidden_states: bool = False
    ) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
        x = self.embed(feats)
        hidden_states = []
        position_bias = None
        remat = self.remat and torch.is_grad_enabled()
        for layer in self.layers:
            hidden_states.append(x)
            if remat:
                x, position_bias = torch.utils.checkpoint.checkpoint(
                    layer, x, position_bias, use_reentrant=False, preserve_rng_state=False)
            else:
                x, position_bias = layer(x, position_bias)
        x = self.final(x)
        hidden_states.append(x)
        return x, (tuple(hidden_states) if output_hidden_states else ())
