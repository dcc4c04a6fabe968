"""Kernel 2: flash attention forward and backward, with their plain versions.

bf16 inputs go to ``csrc/flash_attn.cu`` and ``csrc/flash_attn_bwd.cu``
(wgmma), f32 inputs to ``csrc/flash_attn_f32.cu`` (IEEE f32 on the CUDA
cores) and ``csrc/flash_attn_bwd_f32.cu`` (3xTF32 on wgmma): the JAX package
runs its Pallas kernel in the model's dtype, bf16 or f32.

Counterpart of ``segma_tpu/ops/attention.py``. ``attention_core`` takes
(B, S, H, D) head-split activations, the JAX layout. For a CUDA tensor it
goes through ``FlashAttention``, an autograd function whose forward launches
the forward kernel (saving the per-row log-sum-exp) and whose backward
launches the backward kernels; it runs for every sequence length in bf16 or
f32 at head_dim 64 and raises on what the kernels do not take. For a CPU
tensor it runs the plain version, which matches ``_einsum_core`` and is
differentiated by autograd.
"""

from __future__ import annotations

import math

import torch

from segma_tpu_torch.ops import _build

HEAD_DIM = 64  # the kernels' head dim (Whisper, HuBERT)

# launches since the last reset (chip_smoke.py reads them): the bf16 forward
# and backward (each backward runs the dq and the dkv kernel), then the f32 ones
launches = 0
bwd_launches = 0
launches_f32 = 0
bwd_launches_f32 = 0
BWD_ROWS = 128  # rows of a backward work item (BR of csrc/flash_attn_bwd.cu and _f32.cu)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _f32(x: torch.Tensor) -> torch.Tensor:
    """At least f32: bf16 and f32 to f32, f64 stays f64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float,
    dtype: torch.dtype,
) -> torch.Tensor:
    """f32 scores, softmax, cast to ``dtype``, weighted sum of v."""
    scores = torch.einsum("bqhd,bkhd->bhqk", _f32(q * sm_scale), _f32(k))
    attn = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", _f32(attn), _f32(v)).to(dtype)


def attention_lse_plain(q: torch.Tensor, k: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """(B, H, S) f32 log-sum-exp of each row of the scaled scores."""
    scores = torch.einsum("bqhd,bkhd->bhqk", _f32(q), _f32(k)) * sm_scale
    return torch.logsumexp(scores, dim=-1)


def attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor, sm_scale: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in f32 by the kernels' formulas, step by step: P from
    the log-sum-exp, dV = Pᵀ dO, dP = dO Vᵀ, D = rowsum(dO ∘ O),
    dS = P ∘ (dP − D), dQ = dS K scale, dK = dSᵀ Q scale."""
    q, k, v, out, dout, lse = map(_f32, (q, k, v, out, dout, lse))
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * sm_scale
    p = torch.exp(scores - lse[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout, v)
    di = (dout * out).sum(-1).transpose(1, 2)  # (B, H, S)
    ds = p * (dp - di[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k) * sm_scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q) * sm_scale
    return dq, dk, dv


def _check_inputs(name: str, **tensors: torch.Tensor) -> tuple[int, int, int]:
    """Raise unless every tensor is a contiguous, 16-byte aligned (B, S, H,
    64) CUDA tensor of one shape and one dtype, bfloat16 or float32; return
    (B, S, H)."""
    first = next(iter(tensors.values()))
    shape, dtype = first.shape, first.dtype
    for arg, x in tensors.items():
        if not x.is_cuda:
            raise ValueError(f"{name}: {arg} is not a CUDA tensor")
        if x.dtype not in KERNEL_DTYPES:
            raise ValueError(f"{name}: {arg} is {x.dtype}, needs bfloat16 or float32")
        if x.dtype != dtype:
            raise ValueError(f"{name}: {arg} is {x.dtype}, the others {dtype}")
        if x.shape != shape or x.dim() != 4:
            raise ValueError(f"{name}: {arg} has shape {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} is not 16-byte aligned")
    b, s, h, d = shape
    if d != HEAD_DIM:
        raise ValueError(f"{name}: head_dim {d} != {HEAD_DIM}")
    return b, s, h


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def flash_attn_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float,
    with_lse: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on contiguous (B, S, H, 64) CUDA tensors:
    the bf16 kernel for bf16 inputs, the f32 kernel for f32 ones. ``with_lse``:
    also return the (B, H, S) f32 log-sum-exp."""
    global launches, launches_f32
    b, s, h = _check_inputs("flash_attn_fwd", q=q, k=k, v=v)
    f32 = q.dtype == torch.float32
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if with_lse else None
    lib = _build.library()
    entry = "segma_flash_attn_fwd_f32" if f32 else "segma_flash_attn_fwd"
    err = getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None, b, s, h,
        sm_scale * math.log2(math.e), _stream(q),
    )
    _build.check(err, entry)
    if f32:
        launches_f32 += 1
    else:
        launches += 1
    return (out, lse) if with_lse else out


def flash_attn_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor, sm_scale: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernels (the dq pass, then the dk/dv pass) on
    contiguous (B, S, H, 64) CUDA tensors of one dtype, bf16 or f32, and the
    forward's (B, H, S) f32 lse."""
    global bwd_launches, bwd_launches_f32
    b, s, h = _check_inputs("flash_attn_bwd", q=q, k=k, v=v, out=out, dout=dout)
    f32 = q.dtype == torch.float32
    if lse.shape != (b, h, s) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(
            f"flash_attn_bwd: lse must be contiguous ({b}, {h}, {s}) float32, "
            f"got {tuple(lse.shape)} {lse.dtype}"
        )
    lib = _build.library()
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    # each row's (lse log2(e), rowsum(dout * out)), written by the dq pass for
    # the dk/dv pass, padded to whole work items of BWD_ROWS rows
    s_pad = -(-s // BWD_ROWS) * BWD_ROWS
    pairs = torch.empty((b, h, s_pad, 2), dtype=torch.float32, device=q.device)
    entry = "segma_flash_attn_bwd_f32" if f32 else "segma_flash_attn_bwd"
    err = getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), pairs.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, s, h, sm_scale * math.log2(math.e), sm_scale, _stream(q),
    )
    _build.check(err, entry)
    if f32:
        bwd_launches_f32 += 1
    else:
        bwd_launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """softmax(q kᵀ sm_scale) v with the kernels forward and backward.

    On CPU tensors (the tests) the same two steps run their plain versions:
    ``attention_plain`` with ``attention_lse_plain``, and
    ``attention_bwd_plain``."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale: float):
        if q.is_cuda:
            out, lse = flash_attn_fwd(q, k, v, sm_scale, with_lse=True)
        else:
            out = attention_plain(q, k, v, sm_scale, q.dtype)
            lse = attention_lse_plain(q, k, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        if q.is_cuda:
            grads = flash_attn_bwd(q, k, v, out, lse, dout, ctx.sm_scale)
        else:
            grads = attention_bwd_plain(q, k, v, out, lse, dout, ctx.sm_scale)
        dq, dk, dv = (g.to(q.dtype) for g in grads)
        return dq, dk, dv, None


def attention_core(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, sm_scale: float,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """softmax(q kᵀ sm_scale) v over (B, S, H, D); returns ``dtype``.

    On the card, ``dtype`` is bfloat16 or float32 (the inputs' dtype); a
    call that autograd records goes through ``FlashAttention``, one that it
    does not (serving) launches the forward kernel alone, without the
    log-sum-exp."""
    if q.is_cuda:
        if dtype not in KERNEL_DTYPES:
            raise ValueError(
                f"attention on the card runs in bfloat16 or float32, got {dtype}"
            )
        if q.dtype != dtype:
            raise ValueError(f"attention on the card: inputs are {q.dtype}, dtype is {dtype}")
        if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
            return FlashAttention.apply(q, k, v, sm_scale)
        return flash_attn_fwd(q, k, v, sm_scale)
    return attention_plain(q, k, v, sm_scale, dtype)
