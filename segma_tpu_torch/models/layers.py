"""Shared building blocks (counterpart of ``segma_tpu/models/layers.py``)."""

from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn

from segma_tpu_torch.config import LSTMConfig


class MLPHead(nn.Module):
    """Linear stack with ReLU between layers, final f32 linear classifier."""

    def __init__(
        self, in_features: int, hidden: Sequence[int], n_out: int,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        sizes = [in_features, *hidden]
        self.hidden = nn.ModuleList(nn.Linear(a, b) for a, b in zip(sizes, sizes[1:]))
        self.out = nn.Linear(sizes[-1], n_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from segma_tpu_torch.models.whisper.encoder import linear

        x = x.to(self.dtype)
        for layer in self.hidden:
            x = torch.relu(linear(x, layer))
        return self.out(x.float())


class HydraHeads(nn.Module):
    """Per-label binary heads fused into one f32 Linear(n_labels):
    (B, T, d) -> (B, T, n_labels) raw logits."""

    def __init__(self, in_features: int, n_labels: int) -> None:
        super().__init__()
        self.heads = nn.Linear(in_features, n_labels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.heads(x.float())


class BiLSTM(nn.Module):
    """Multi-layer (optionally bidirectional) LSTM, batch first, in f32.

    One ``torch.nn.LSTM`` (cuDNN on the card); its gate order i, f, g, o and
    parameter names ``weight_ih_l{n}[_reverse]`` are what the weight bridge
    (``convert.flax_to_torch``) fills. Dropout applies in training only, and
    this port serves.
    """

    def __init__(self, input_size: int, cfg: LSTMConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.lstm = nn.LSTM(
            input_size, cfg.hidden_size, num_layers=cfg.num_layers,
            bidirectional=cfg.bidirectional, dropout=cfg.dropout, batch_first=True,
        )

    def forward(self, x: torch.Tensor, keep: int | None = None) -> torch.Tensor:
        """``keep``: return ``out[:, :keep]`` only, as the JAX module does.

        The JAX module saves work by running the last layer's forward
        direction on ``x[:, :keep]``; the result is the same rows. Here cuDNN
        runs both directions of a layer in one call, so the whole sequence
        runs and is sliced."""
        out, _ = self.lstm(x.float())
        return out[:, :keep] if keep is not None else out

    @property
    def out_features(self) -> int:
        return self.cfg.hidden_size * (2 if self.cfg.bidirectional else 1)


class LayerWeightedSum(nn.Module):
    """Weighted reduction over a stack of encoder hidden states.

    ``weighted``: learnable weights through a softmax; ``average``: fixed
    uniform average. Input (L, B, T, D) -> output (B, T, D).
    """

    def __init__(self, n_layers: int, reduction: str = "weighted") -> None:
        super().__init__()
        if reduction not in ("weighted", "average"):
            raise ValueError(
                f"reduction must be 'average' or 'weighted', got {reduction!r}"
            )
        self.reduction = reduction
        self.layer_weights = nn.Parameter(torch.ones(n_layers) / n_layers)

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        if self.reduction == "weighted":
            w = torch.softmax(self.layer_weights, dim=0)
        else:
            w = torch.full_like(self.layer_weights, 1.0 / self.layer_weights.numel())
        return torch.einsum("l,lbtd->btd", w.to(hidden_states.dtype), hidden_states)
