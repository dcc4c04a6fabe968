"""What the plain references share: IEEE f32 on the card, the precision
control, and the operations they are written in.

The references are plain PyTorch and NumPy. They import nothing of the
program, of JAX or of the JAX package, and take from the benchmark only the
inputs it made: the seeded state dict, the WAV files and their labels.

``Cast`` is where a reference's products take their operands: ``exact``
keeps f32; ``fp8`` rounds each operand to float8 e4m3 with a per-tensor
scale, and in training also the gradient that reaches each product from
above, which is the precision control (the nearest precision below the
configurations' bf16, in the backward as in the forward).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # float8 e4m3's largest finite value


@contextlib.contextmanager
def ieee_f32():
    """cuBLAS and cuDNN without TF32 while open, the flags restored after."""
    mm, cd = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = mm, cd


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale that maps its
    largest magnitude to 448, back in x's dtype."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = FP8_MAX / amax
    return ((x * scale).to(torch.float8_e4m3fn).to(x.dtype)) / scale


class _RoundGrad(torch.autograd.Function):
    """The identity, whose backward rounds the incoming gradient to fp8."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return fp8_round(grad)


class Cast:
    """The operands of every product: exact, or rounded to fp8. In fp8 the
    product's backward takes the rounded operands autograd saved and the
    output's gradient rounded too, so both of its products (the input's
    gradient and the weight's) take fp8 operands."""

    def __init__(self, precision: str = "f32") -> None:
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision must be 'f32' or 'fp8', got {precision!r}")
        self.precision = precision

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.precision == "f32":
            return x
        return x + (fp8_round(x) - x).detach()

    def grad(self, y: torch.Tensor) -> torch.Tensor:
        """A product's output, its gradient rounded on the way back."""
        if self.precision == "f32" or not y.requires_grad:
            return y
        return _RoundGrad.apply(y)

    def linear(self, x, w, b=None):
        if self.precision == "f32":
            return F.linear(x, w, b)
        y = self.grad(F.linear(self(x), self(w)))
        return y if b is None else y + b

    def conv1d(self, x, w, b=None, **kw):
        if self.precision == "f32":
            return F.conv1d(x, w, b, **kw)
        y = self.grad(F.conv1d(self(x), self(w), None, **kw))
        return y if b is None else y + b[:, None]

    def attention(self, q, k, v, scale: float):
        """softmax(q kᵀ scale) v over (B, H, S, D)."""
        scores = self.grad(torch.matmul(self(q), self(k).transpose(-1, -2))) * scale
        return self.grad(torch.matmul(self(torch.softmax(scores, dim=-1)), self(v)))


def layer_norm(x, sd: dict, prefix: str, eps: float = 1e-5):
    return F.layer_norm(x, x.shape[-1:], sd[f"{prefix}.weight"], sd[f"{prefix}.bias"], eps)


def softmax_mix(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """sum_l softmax(weights)_l stacked[l] over (L, ...)."""
    w = torch.softmax(weights, dim=0)
    return (w.view(-1, *([1] * (stacked.dim() - 1))) * stacked).sum(0)


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """max(x, 0) - x t + log(1 + exp(-|x|)), elementwise."""
    return torch.clamp(logits, min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def read_wav_int16(path) -> np.ndarray:
    """A 16-bit mono WAV's samples."""
    import wave

    with wave.open(str(path), "rb") as w:
        if w.getsampwidth() != 2 or w.getnchannels() != 1:
            raise ValueError(f"{path}: not 16-bit mono")
        return np.frombuffer(w.readframes(w.getnframes()), dtype="<i2")


def wav_frames(path) -> int:
    import wave

    with wave.open(str(path), "rb") as w:
        return w.getnframes()
