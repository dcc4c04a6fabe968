"""Kernel 2: flash attention forward (``csrc/flash_attn.cu``) and its plain
version.

Counterpart of ``segma_tpu/ops/attention.py``. ``attention_core`` takes
(B, S, H, D) head-split activations, the JAX layout. For a CUDA tensor it
launches the kernel (bf16, head_dim 64) for every sequence length, and
raises on what the kernel does not take; for a CPU tensor it runs the plain
version, which matches ``_einsum_core``.
"""

from __future__ import annotations

import math

import torch

from segma_tpu_torch.ops import _build

HEAD_DIM = 64  # the kernel's head dim (Whisper, HuBERT)

launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)


def attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float,
    dtype: torch.dtype,
) -> torch.Tensor:
    """f32 scores, softmax, cast to ``dtype``, weighted sum of v."""
    scores = torch.einsum("bqhd,bkhd->bhqk", (q * sm_scale).float(), k.float())
    attn = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", attn.float(), v.float()).to(dtype)


def flash_attn_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float
) -> torch.Tensor:
    """Launch the kernel on contiguous (B, S, H, 64) bf16 CUDA tensors."""
    global launches
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda:
            raise ValueError(f"flash_attn_fwd: {name} is not a CUDA tensor")
        if x.dtype != torch.bfloat16:
            raise ValueError(f"flash_attn_fwd: {name} is {x.dtype}, needs bfloat16")
        if x.shape != q.shape or x.dim() != 4:
            raise ValueError(f"flash_attn_fwd: {name} has shape {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"flash_attn_fwd: {name} is not contiguous")
    b, s, h, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"flash_attn_fwd: head_dim {d} != {HEAD_DIM}")
    out = torch.empty_like(q)
    lib = _build.library()
    err = lib.segma_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h,
        sm_scale * math.log2(math.e),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "segma_flash_attn_fwd")
    launches += 1
    return out


def attention_core(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, sm_scale: float,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """softmax(q kᵀ sm_scale) v over (B, S, H, D); returns ``dtype``."""
    if q.is_cuda:
        if dtype != torch.bfloat16:
            raise ValueError(
                f"attention on the card runs in bfloat16 only, got {dtype}"
            )
        return flash_attn_fwd(q, k, v, sm_scale)
    return attention_plain(q, k, v, sm_scale, dtype)
