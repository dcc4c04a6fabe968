"""The BiLSTM's forward: the recurrence's CUDA kernel (``csrc/lstm_fwd.cu``)
with its plain version, and the registered op ``segma_tpu_torch::lstm``.

The kernel path (``lstm_cuda``) runs a layer as one f32 GEMM, every step's
input projection of both directions at once (``input_gates``: x W_ih^T +
b_ih + b_hh, TF32 off, as cuDNN computes it), then one launch of the
kernel, which runs the recurrence over all the steps of both directions.
``lstm_plain`` is the same decomposition in PyTorch operations, one step at a
time. Both are inference alone: the kernel has no backward. ``kernel_path``
is the rule ``models.layers.BiLSTM`` routes by: a card, no training, no
gradient wanted, and a hidden size the kernel takes (``supports``); every
other call, training and the CPU among them, is ``torch.lstm`` (cuDNN on
the card).

The op is the module's LSTM as one node of a ``torch.export`` program:
``BiLSTM`` calls it under a trace only, so that the program records the LSTM
with the shape its fake implementation gives at once (traced as
``aten.lstm``, the shapes come from its decomposition, one cell step at a
time, which made the LSTM most of a program's export time: 1500 Whisper
frames, two directions per layer). When the program runs, its CUDA
implementation takes the kernel by the same rule, its CPU one is
``torch.lstm``.
"""

from __future__ import annotations

import warnings

import torch

from segma_tpu_torch import no_tf32
from segma_tpu_torch.ops import _build, count_launch, launch_counts

# the kernel's hidden sizes (the instantiations csrc/lstm_fwd.cu builds): two
# CTAs of H / 2 units each, in warps of 8 units
HIDDEN_STEP = 16
HIDDEN_MAX = 256


def __getattr__(name: str) -> int:
    """``rnn.launches``: the kernel's count in ``ops.launch_counts``."""
    if name == "launches":
        return launch_counts()["lstm_fwd"]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def supports(hidden: int) -> bool:
    """The kernel's size rule: a hidden size that is a multiple of 16, up to 256."""
    return 0 < hidden <= HIDDEN_MAX and hidden % HIDDEN_STEP == 0


def kernel_path(device: torch.device, hidden: int, train: bool, needs_grad: bool) -> bool:
    """Whether an LSTM call runs the kernel: on a card, not training (no
    dropout, nothing kept for a backward), no gradient wanted, a hidden size
    the kernel takes."""
    return device.type == "cuda" and not train and not needs_grad and supports(hidden)


def _layer_weights(weights: list[torch.Tensor], layer: int, dirs: int) -> list[list[torch.Tensor]]:
    """Layer ``layer``'s (w_ih, w_hh, b_ih, b_hh) per direction, from
    ``torch.nn.LSTM``'s flat weights."""
    return [weights[4 * (layer * dirs + d) : 4 * (layer * dirs + d + 1)] for d in range(dirs)]


def input_gates(x: torch.Tensor, layer: list[list[torch.Tensor]]) -> torch.Tensor:
    """(B, T, dirs, 4H) f32: every step's input projection of each direction,
    both biases added, as one GEMM; TF32 off."""
    w = torch.cat([w_ih for w_ih, _, _, _ in layer])
    b = torch.cat([b_ih + b_hh for _, _, b_ih, b_hh in layer])
    with no_tf32():
        g = torch.addmm(b, x.reshape(-1, x.shape[-1]), w.t())
    return g.view(x.shape[0], x.shape[1], len(layer), -1)


def launch(lib, gates: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """Launch ``segma_lstm_fwd`` of the kernel library ``lib``: contiguous
    (B, T, dirs, 4H) f32 gates and (dirs, 4H, H) f32 recurrent weights on one
    card, B and T at least 1; returns (B, T, dirs * H). On the tensors' card
    whatever the thread's current device; not counted."""
    b, t, dirs, _ = gates.shape
    hidden = w_hh.shape[-1]
    out = torch.empty((b, t, dirs * hidden), dtype=torch.float32, device=gates.device)
    with torch.cuda.device(gates.device):
        err = lib.segma_lstm_fwd(gates.data_ptr(), w_hh.data_ptr(), out.data_ptr(), b, t, hidden,
                                 dirs, torch.cuda.current_stream(gates.device).cuda_stream)
    _build.check(err, "segma_lstm_fwd")
    return out


def lstm_cuda(
    x: torch.Tensor, weights: list[torch.Tensor], num_layers: int, bidirectional: bool,
) -> torch.Tensor:
    """The kernel path: batch-first LSTM from zero states on
    ``torch.nn.LSTM``'s flat weights, without dropout, on a (B, T, I) f32
    CUDA tensor; each layer one ``input_gates`` GEMM and one launch."""
    hidden = weights[1].shape[1]
    if not supports(hidden):
        raise ValueError(f"the LSTM kernel takes a hidden size that is a multiple of "
                         f"{HIDDEN_STEP} up to {HIDDEN_MAX}, not {hidden}")
    if not x.is_cuda or x.dtype != torch.float32 or x.dim() != 3:
        raise ValueError(f"expected a (B, T, I) float32 CUDA tensor, got {tuple(x.shape)} "
                         f"{x.dtype} on {x.device}")
    dirs = 2 if bidirectional else 1
    if x.shape[0] == 0 or x.shape[1] == 0:
        return x.new_empty((x.shape[0], x.shape[1], dirs * hidden))
    lib = _build.library()
    for layer in range(num_layers):
        ws = _layer_weights(weights, layer, dirs)
        w_hh = torch.stack([w for _, w, _, _ in ws])
        x = launch(lib, input_gates(x, ws), w_hh)
        count_launch("lstm_fwd")
    return x


def lstm_plain(
    x: torch.Tensor, weights: list[torch.Tensor], num_layers: int, bidirectional: bool,
) -> torch.Tensor:
    """Plain PyTorch version of ``lstm_cuda``, on any device: each layer's
    ``input_gates``, then the steps one at a time, both directions batched
    (the reverse one walks T - 1 down to 0)."""
    dirs = 2 if bidirectional else 1
    b, t = x.shape[:2]
    for layer in range(num_layers):
        ws = _layer_weights(weights, layer, dirs)
        gates = input_gates(x, ws)
        w_hh = torch.stack([w for _, w, _, _ in ws])  # (dirs, 4H, H)
        hidden = w_hh.shape[-1]
        h = x.new_zeros((dirs, b, hidden))
        c = torch.zeros_like(h)
        out = x.new_empty((b, t, dirs, hidden))
        times = [[n if d == 0 else t - 1 - n for d in range(dirs)] for n in range(t)]
        with no_tf32():
            for n in range(t):
                z = torch.stack([gates[:, times[n][d], d] for d in range(dirs)])
                z = z + torch.bmm(h, w_hh.transpose(1, 2))
                i, f, g, o = z.chunk(4, dim=-1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                h = torch.sigmoid(o) * torch.tanh(c)
                for d in range(dirs):
                    out[:, times[n][d], d] = h[d]
        x = out.reshape(b, t, dirs * hidden)
    return x


def torch_lstm(
    x: torch.Tensor, weights: list[torch.Tensor], num_layers: int, bidirectional: bool,
    train: bool,
) -> torch.Tensor:
    """``torch.lstm`` from zero states, without dropout: the call
    ``torch.nn.LSTM.forward`` makes (``train`` its ``training`` flag)."""
    dirs = 2 if bidirectional else 1
    h0 = x.new_zeros(num_layers * dirs, x.shape[0], weights[1].shape[1])
    with warnings.catch_warnings():
        # an exported program holds each weight on its own, not as a slice of
        # the module's flat buffer: cuDNN packs them per call
        warnings.filterwarnings("ignore", message="RNN module weights")
        out, _, _ = torch.lstm(x, (h0, h0), weights, True, num_layers, 0.0, train,
                               bidirectional, True)
    return out


@torch.library.custom_op("segma_tpu_torch::lstm", mutates_args=(), device_types="cpu")
def lstm(
    x: torch.Tensor, weights: list[torch.Tensor], num_layers: int, bidirectional: bool,
    train: bool,
) -> torch.Tensor:
    """Batch-first LSTM from zero states on ``torch.nn.LSTM``'s flat weights
    (four per layer and direction, biases included), without dropout;
    ``train`` as ``BiLSTM.forward``'s. Returns the outputs: ``torch.lstm``
    on the CPU, the kernel on a card where ``kernel_path`` takes the call."""
    return torch_lstm(x, weights, num_layers, bidirectional, train)


@lstm.register_kernel("cuda")
def _lstm_cuda(x, weights, num_layers, bidirectional, train):
    if kernel_path(x.device, weights[1].shape[1], train, needs_grad=False):
        return lstm_cuda(x, weights, num_layers, bidirectional)
    return torch_lstm(x, weights, num_layers, bidirectional, train)


@lstm.register_fake
def _lstm_fake(x, weights, num_layers, bidirectional, train):
    dirs = 2 if bidirectional else 1
    return x.new_empty((x.shape[0], x.shape[1], dirs * weights[1].shape[1]))
