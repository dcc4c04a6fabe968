"""The BiLSTM's forward as a registered op, ``segma_tpu_torch::lstm``.

Not a kernel of the port: its implementation is ``torch.lstm`` (cuDNN on
the card), the call ``torch.nn.LSTM.forward`` makes. ``models.layers.BiLSTM``
takes it under a ``torch.export`` trace only, so that the program records
the LSTM as one node whose shape the fake implementation gives at once:
traced as ``aten.lstm``, the shapes come from its decomposition, one cell
step at a time, which made the LSTM most of a program's export time (1500
Whisper frames, two directions per layer).
"""

from __future__ import annotations

import warnings

import torch


@torch.library.custom_op("segma_tpu_torch::lstm", mutates_args=())
def lstm(
    x: torch.Tensor, weights: list[torch.Tensor], num_layers: int, bidirectional: bool,
    train: bool,
) -> torch.Tensor:
    """Batch-first LSTM from zero states on ``torch.nn.LSTM``'s flat weights
    (four per layer and direction, biases included), without dropout;
    ``train`` is the module's ``training`` flag, as ``nn.LSTM.forward``
    passes it. Returns the outputs."""
    dirs = 2 if bidirectional else 1
    h0 = x.new_zeros(num_layers * dirs, x.shape[0], weights[1].shape[1])
    with warnings.catch_warnings():
        # an exported program holds each weight on its own, not as a slice of
        # the module's flat buffer: cuDNN packs them per call
        warnings.filterwarnings("ignore", message="RNN module weights")
        out, _, _ = torch.lstm(x, (h0, h0), weights, True, num_layers, 0.0, train,
                               bidirectional, True)
    return out


@lstm.register_fake
def _lstm_fake(x, weights, num_layers, bidirectional, train):
    dirs = 2 if bidirectional else 1
    return x.new_empty((x.shape[0], x.shape[1], dirs * weights[1].shape[1]))
