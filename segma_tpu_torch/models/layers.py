"""Shared building blocks (counterpart of ``segma_tpu/models/layers.py``)."""

from __future__ import annotations

import warnings
from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from segma_tpu_torch import telemetry
from segma_tpu_torch.config import LSTMConfig
from segma_tpu_torch.models.base import no_tf32
from segma_tpu_torch.ops import rnn
from segma_tpu_torch.parallel.collectives import SOLO, enter, reduce_sum


class MLPHead(nn.Module):
    """Linear stack with ReLU between layers, final f32 linear classifier.

    The layers are ``Dense_0`` ... ``Dense_{n}``, flax's names for the
    unnamed ``nn.Dense`` children of the JAX ``MLPHead``; the hidden ones
    compute in ``dtype``, the last in IEEE f32 (``no_tf32``)."""

    def __init__(
        self, in_features: int, hidden: Sequence[int], n_out: int,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        self.n_hidden = len(hidden)
        sizes = [in_features, *hidden, n_out]
        for i, (a, b) in enumerate(zip(sizes, sizes[1:])):
            self.add_module(f"Dense_{i}", nn.Linear(a, b))

    @property
    def hidden(self) -> list[nn.Linear]:
        return [getattr(self, f"Dense_{i}") for i in range(self.n_hidden)]

    @property
    def out(self) -> nn.Linear:
        return getattr(self, f"Dense_{self.n_hidden}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for layer in self.hidden:
            x = torch.relu(linear(x, layer))
        with no_tf32():
            return self.out(x.float())


def linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """``layer`` applied in ``x``'s dtype (weights cast where used), as
    flax's ``nn.Dense(dtype=...)`` computes with f32 parameters."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


def row_linear(x: torch.Tensor, layer: nn.Linear, group) -> torch.Tensor:
    """A row-parallel ``layer`` (JAX's ``P("model", None)`` kernel): its
    weight holds this member's block of input features, ``x`` the matching
    block. The members' partial products are summed in f32 over ``group``
    (``collectives.reduce_sum``: the gradient reaches each member's partial
    unchanged), the whole bias added once after the sum, and the result cast
    to ``x``'s dtype. A group of one is ``linear``."""
    if group.size == 1:
        return linear(x, layer)
    out = reduce_sum(F.linear(x, layer.weight.to(x.dtype)).float(), group)
    if layer.bias is not None:
        out = out + layer.bias.float()
    return out.to(x.dtype)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout with the keep mask drawn from ``generator`` (flax's
    ``nn.Dropout`` semantics: kept values scaled by 1 / (1 - rate))."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class HydraHeads(nn.Module):
    """Per-label binary heads fused into one f32 Linear(n_labels), in IEEE
    f32 (``no_tf32``): (B, T, d) -> (B, T, n_labels) raw logits."""

    def __init__(self, in_features: int, n_labels: int) -> None:
        super().__init__()
        self.heads = nn.Linear(in_features, n_labels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with no_tf32():
            return self.heads(x.float())


class BiLSTM(nn.Module):
    """Multi-layer (optionally bidirectional) LSTM, batch first, in IEEE f32
    whatever the model's dtype and the caller's TF32 flags (``no_tf32``).

    One ``torch.nn.LSTM`` holds the weights; its gate order i, f, g, o and
    parameter names ``weight_ih_l{n}[_reverse]`` are what the weight bridge
    (``convert.flax_to_torch``) fills. A flax ``OptimizedLSTMCell`` has one
    bias per gate where torch has two, ``bias_ih`` and ``bias_hh``: here
    ``bias_hh`` carries it, and ``bias_ih`` stays zero and takes no gradient,
    so the optimizer updates and decays the one bias as optax does. cuDNN
    takes both biases or none, so ``bias_ih`` stays a parameter of the LSTM.

    Inference on a card (``train=False``, no gradient wanted: under
    ``SegmentationModel.apply``'s ``inference_mode`` or validation's
    ``no_grad``) runs the port's kernel, ``ops.rnn.lstm_cuda``: an f32 GEMM
    and one launch of ``csrc/lstm_fwd.cu`` per layer, for a hidden size the
    kernel takes (``ops.rnn.kernel_path``). Every other call is
    ``torch.lstm`` (cuDNN on the card): training, a call that wants a
    gradient, the CPU. Dropout (``cfg.dropout``) applies between layers with
    ``train=True``, its masks drawn from the caller's generator; the layers
    then run one ``torch.lstm`` call each. Under a ``torch.export`` trace the
    LSTM is the registered op ``ops.rnn.lstm``, which routes the same way when
    the program runs and gives the trace its shape at once (``aten.lstm`` is
    traced one cell step at a time).
    """

    def __init__(self, input_size: int, cfg: LSTMConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.lstm = nn.LSTM(
            input_size, cfg.hidden_size, num_layers=cfg.num_layers,
            bidirectional=cfg.bidirectional, batch_first=True,
        )
        with torch.no_grad():
            for name, p in self.lstm.named_parameters():
                if name.startswith("bias_ih"):
                    p.zero_()
                    p.requires_grad_(False)

    def forward(
        self, x: torch.Tensor, keep: int | None = None, train: bool = False,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """``keep``: return ``out[:, :keep]`` only, as the JAX module does.

        The JAX module saves work by running the last layer's forward
        direction on ``x[:, :keep]``; the result is the same rows. Here both
        directions of a layer run in one call (one kernel launch, or one
        cuDNN call), so the whole sequence runs and is sliced."""
        x = x.float()
        with no_tf32(), telemetry.span("model.bilstm", cuda_time=True):
            if train and self.cfg.dropout > 0 and self.cfg.num_layers > 1:
                if generator is None:
                    raise ValueError("training with dropout needs a torch.Generator")
                for layer in range(self.cfg.num_layers):
                    if layer:
                        x = dropout(x, self.cfg.dropout, generator)
                    x = self._layer(x, layer)
                out = x
            elif torch.compiler.is_compiling():  # the module's own call, as one op
                out = rnn.lstm(x, self.weights, self.cfg.num_layers, self.cfg.bidirectional,
                               train)
            elif self.takes_kernel(x, train):
                out = rnn.lstm_cuda(x, self.weights, self.cfg.num_layers, self.cfg.bidirectional)
            else:
                out, _ = self.lstm(x)
        return out[:, :keep] if keep is not None else out

    def takes_kernel(self, x: torch.Tensor, train: bool) -> bool:
        """Whether a call on ``x`` runs the kernel (``ops.rnn.kernel_path``):
        a gradient is wanted where autograd records and ``x`` or a weight
        requires one."""
        needs_grad = torch.is_grad_enabled() and (
            x.requires_grad or any(w.requires_grad for w in self.weights))
        return rnn.kernel_path(x.device, self.cfg.hidden_size, train, needs_grad)

    @property
    def weights(self) -> list[torch.Tensor]:
        """The LSTM's flat weights, four per layer and direction."""
        return [getattr(self.lstm, n) for n in self.lstm._flat_weights_names]

    def _layer(self, x: torch.Tensor, layer: int) -> torch.Tensor:
        """Layer ``layer`` of the LSTM alone, on its own weights."""
        suffixes = [f"l{layer}"] + ([f"l{layer}_reverse"] if self.cfg.bidirectional else [])
        weights = [getattr(self.lstm, f"{kind}_{s}") for s in suffixes
                   for kind in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
        h0 = x.new_zeros(len(suffixes), x.shape[0], self.cfg.hidden_size)
        with warnings.catch_warnings():
            # cuDNN packs one layer's weights per call: they are a slice of the
            # LSTM's flat buffer, not a buffer of their own
            warnings.filterwarnings("ignore", message="RNN module weights")
            out, _, _ = torch.lstm(x, (h0, h0), weights, True, 1, 0.0, True,
                                   self.cfg.bidirectional, True)
        return out

    @property
    def out_features(self) -> int:
        return self.cfg.hidden_size * (2 if self.cfg.bidirectional else 1)


class LayerWeightedSum(nn.Module):
    """Weighted reduction over a stack of encoder hidden states.

    ``weighted``: learnable weights through a softmax; ``average``: fixed
    uniform average, which has no parameter (the JAX tree then has no
    ``layer_mix``). Input (L, B, T, D) -> output (B, T, D).
    """

    def __init__(self, n_layers: int, reduction: str = "weighted") -> None:
        super().__init__()
        if reduction not in ("weighted", "average"):
            raise ValueError(
                f"reduction must be 'average' or 'weighted', got {reduction!r}"
            )
        self.reduction = reduction
        weights = torch.ones(n_layers) / n_layers
        if reduction == "weighted":
            self.layer_weights = nn.Parameter(weights)
        else:  # a constant, as in flax: no parameter, nothing in the state_dict
            self.register_buffer("layer_weights", weights, persistent=False)

    def forward(self, hidden_states: torch.Tensor, time_group=SOLO) -> torch.Tensor:
        """``time_group``: the group over whose members the time axis of
        ``hidden_states`` is split (the Whisper encoder's under sequence
        parallelism); the weights' gradient, each member's of its time
        block, is then summed over it (``collectives.enter``)."""
        if self.reduction == "weighted":
            w = torch.softmax(enter(self.layer_weights, time_group), dim=0)
        else:
            w = torch.full_like(self.layer_weights, 1.0 / self.layer_weights.numel())
        return torch.einsum("l,lbtd->btd", w.to(hidden_states.dtype), hidden_states)
