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
differentiated by autograd. The forward also takes Sq query rows against
Skv keys, Sq ≠ Skv: a member of a sequence-parallel group attends its block
of the time axis to the keys gathered from the group. The backward takes
one length, and no trained path needs another: only the Whisper encoder
splits time over ``seq``, and it is always frozen (it runs without
autograd, JAX's ``stop_gradient``), so such a call is served, or run
without autograd in training, and a recorded one raises.

The forward is the registered op ``segma_tpu_torch::flash_attn_fwd`` (and
``::flash_attn_fwd_lse``, with the log-sum-exp): its CUDA implementation
launches the kernel, its CPU one is the plain version, and its fake one
gives the shapes, so ``torch.export`` records the op as one node of a
program and the program launches the kernel when it runs. A call that
autograd does not record (serving, and every exported program) goes through
the op; ``FlashAttention.forward`` calls it too.

WavLM's attention, with its gated relative-position bias added to every
score, is the op ``segma_tpu_torch::wavlm_attn_fwd`` (forward only, bf16,
head dim 64, self-attention): the bias kernel of ``csrc/flash_attn.cu`` on
the card, ``wavlm_attention_plain`` on the CPU. ``wavlm_kernel_path`` says
when ``models/wavlm`` calls it; elsewhere that attention stays plain torch.
"""

from __future__ import annotations

import math

import torch

from segma_tpu_torch.ops import _build, count_launch, launch_counts

HEAD_DIM = 64  # the kernels' head dim (Whisper, HuBERT)

# the wrappers' launch counters (``ops.launch_counts``) under the names this
# module gave them: ``attention.launches`` reads the bf16 forward's count
_COUNTERS = {"launches": "flash_attn_fwd", "bwd_launches": "flash_attn_bwd",
             "launches_f32": "flash_attn_fwd_f32", "bwd_launches_f32": "flash_attn_bwd_f32"}
BWD_ROWS = 128  # rows of a backward work item (BR of csrc/flash_attn_bwd.cu and _f32.cu)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _f32(x: torch.Tensor) -> torch.Tensor:
    """At least f32: bf16 and f32 to f32, f64 stays f64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float,
    dtype: torch.dtype,
) -> torch.Tensor:
    """f32 scores, softmax, cast to ``dtype``, weighted sum of v: q of (B,
    Sq, H, D) against k and v of (B, Skv, H, D)."""
    scores = torch.einsum("bqhd,bkhd->bhqk", _f32(q * sm_scale), _f32(k))
    attn = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", _f32(attn), _f32(v)).to(dtype)


def attention_lse_plain(q: torch.Tensor, k: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """(B, H, Sq) f32 log-sum-exp of each row of the scaled scores."""
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


def _check_inputs(
    name: str, keys: tuple[str, ...] = (), **tensors: torch.Tensor
) -> tuple[int, int, int]:
    """Raise unless every tensor is a contiguous, 16-byte aligned (B, S, H,
    64) CUDA tensor of one shape and one dtype, bfloat16 or float32, except
    that the tensors named in ``keys`` share a length S of their own (the
    keys'); return (B, S, H) of the first tensor."""
    for arg, x in tensors.items():
        if x.dim() != 4:
            raise ValueError(f"{name}: {arg} has shape {tuple(x.shape)}")
    first = next(iter(tensors.values()))
    shape, dtype = first.shape, first.dtype
    s_kv = tensors[keys[0]].shape[1] if keys else shape[1]
    for arg, x in tensors.items():
        if not x.is_cuda:
            raise ValueError(f"{name}: {arg} is not a CUDA tensor")
        if x.dtype not in KERNEL_DTYPES:
            raise ValueError(f"{name}: {arg} is {x.dtype}, needs bfloat16 or float32")
        if x.dtype != dtype:
            raise ValueError(f"{name}: {arg} is {x.dtype}, the others {dtype}")
        if x.shape != (shape[0], s_kv if arg in keys else shape[1], *shape[2:]):
            raise ValueError(f"{name}: {arg} has shape {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} is not 16-byte aligned")
    b, s, h, d = shape
    if d != HEAD_DIM:
        raise ValueError(f"{name}: head_dim {d} != {HEAD_DIM}")
    return b, s, h


def __getattr__(name: str) -> int:
    if name in _COUNTERS:
        return launch_counts()[_COUNTERS[name]]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def flash_attn_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float,
    with_lse: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on contiguous CUDA tensors, q of (B, Sq, H,
    64) and k, v of (B, Skv, H, 64) (Sq = Skv in self-attention; a seq
    member's query block against its group's keys otherwise): the bf16
    kernel for bf16 inputs, the f32 kernel for f32 ones; returns (B, Sq, H,
    64). ``with_lse``: also return the (B, H, Sq) f32 log-sum-exp. The launch
    runs on the tensors' card, whatever the thread's current device: the
    library sizes its grid and sets its shared memory on the current one."""
    b, s, h = _check_inputs("flash_attn_fwd", ("k", "v"), q=q, k=k, v=v)
    s_kv = k.shape[1]
    f32 = q.dtype == torch.float32
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if with_lse else None
    lib = _build.library()
    entry = "segma_flash_attn_fwd_f32" if f32 else "segma_flash_attn_fwd"
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None, b, s, s_kv, h,
            sm_scale * math.log2(math.e), _stream(q),
        )
    _build.check(err, entry)
    count_launch("flash_attn_fwd_f32" if f32 else "flash_attn_fwd")
    return (out, lse) if with_lse else out


def flash_attn_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor, sm_scale: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernels (the dq pass, then the dk/dv pass) on
    contiguous (B, S, H, 64) CUDA tensors of one dtype, bf16 or f32, and the
    forward's (B, H, S) f32 lse, on the tensors' card."""
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
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), pairs.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, s, h, sm_scale * math.log2(math.e), sm_scale, _stream(q),
        )
    _build.check(err, entry)
    count_launch("flash_attn_bwd_f32" if f32 else "flash_attn_bwd")
    return dq, dk, dv


@torch.library.custom_op("segma_tpu_torch::flash_attn_fwd", mutates_args=(), device_types="cpu")
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """softmax(q kᵀ sm_scale) v in q's dtype: the plain version on the CPU."""
    return attention_plain(q, k, v, sm_scale, q.dtype)


@flash_fwd_op.register_kernel("cuda")
def _flash_fwd_cuda(q, k, v, sm_scale):
    return flash_attn_fwd(q, k, v, sm_scale)


@flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, sm_scale):
    return torch.empty_like(q)


@torch.library.custom_op(
    "segma_tpu_torch::flash_attn_fwd_lse", mutates_args=(), device_types="cpu"
)
def flash_fwd_lse_op(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """(output, (B, H, S) f32 log-sum-exp): the plain versions on the CPU."""
    return attention_plain(q, k, v, sm_scale, q.dtype), attention_lse_plain(q, k, sm_scale)


@flash_fwd_lse_op.register_kernel("cuda")
def _flash_fwd_lse_cuda(q, k, v, sm_scale):
    return flash_attn_fwd(q, k, v, sm_scale, with_lse=True)


@flash_fwd_lse_op.register_fake
def _flash_fwd_lse_fake(q, k, v, sm_scale):
    b, s, h, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, h, s), dtype=torch.float32)


WAVLM_MAX_LEN = 4096  # BIAS_MAX_S of csrc/flash_attn.cu: the staged rel rows' room


def relative_bias(rel: torch.Tensor, length: int) -> torch.Tensor:
    """(H, 2T - 1) rows -> the (H, T, T) bias: entry (h, i, j) is
    ``rel[h, T - 1 + j - i]``."""
    pos = torch.arange(length, device=rel.device)
    return rel[:, (length - 1) + pos[None, :] - pos[:, None]]


def wavlm_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, gate: torch.Tensor, rel: torch.Tensor,
    sm_scale: float,
) -> torch.Tensor:
    """softmax(q kᵀ sm_scale + gate[b, h, i] rel[h, T - 1 + j - i]) v over
    (B, T, H, D) q, k, v, the (B, H, T) f32 gate and the (H, 2T - 1) f32
    rows: f32 scores of q scaled in its dtype, the f32 softmax cast to q's
    dtype for the product with v, as ``models/wavlm``'s plain attention."""
    bias = relative_bias(rel, q.shape[1])
    scores = torch.einsum("bqhd,bkhd->bhqk", _f32(q * sm_scale), _f32(k))
    attn = torch.softmax(scores + gate[..., None] * bias[None], dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", _f32(attn), _f32(v)).to(q.dtype)


def wavlm_attn_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, gate: torch.Tensor, rel: torch.Tensor,
    sm_scale: float,
) -> torch.Tensor:
    """Launch the bias kernel on contiguous bf16 (B, T, H, 64) CUDA tensors
    q, k, v, the contiguous (B, H, T) f32 gate and (H, 2T - 1) f32 rows, on
    their card; returns (B, T, H, 64) bf16."""
    b, s, h = _check_inputs("wavlm_attn_fwd", q=q, k=k, v=v)
    if q.dtype != torch.bfloat16:
        raise ValueError(f"wavlm_attn_fwd: q is {q.dtype}, needs bfloat16")
    if s > WAVLM_MAX_LEN:
        raise ValueError(f"wavlm_attn_fwd: length {s} > {WAVLM_MAX_LEN}")
    for arg, x, shape in (("gate", gate, (b, h, s)), ("rel", rel, (h, 2 * s - 1))):
        if (tuple(x.shape) != shape or x.dtype != torch.float32 or not x.is_contiguous()
                or x.device != q.device):
            raise ValueError(f"wavlm_attn_fwd: {arg} must be contiguous {shape} float32 on "
                             f"{q.device}, got {tuple(x.shape)} {x.dtype} on {x.device}")
    out = torch.empty_like(q)
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.segma_wavlm_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), gate.data_ptr(),
            rel.data_ptr(), b, s, h, sm_scale * math.log2(math.e), _stream(q))
    _build.check(err, "segma_wavlm_attn_fwd")
    count_launch("wavlm_attn_fwd")
    return out


@torch.library.custom_op("segma_tpu_torch::wavlm_attn_fwd", mutates_args=(), device_types="cpu")
def wavlm_attn_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, gate: torch.Tensor,
                  rel: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """WavLM's gated-bias attention in q's dtype: the plain version on the CPU."""
    return wavlm_attention_plain(q, k, v, gate, rel, sm_scale)


@wavlm_attn_op.register_kernel("cuda")
def _wavlm_attn_cuda(q, k, v, gate, rel, sm_scale):
    return wavlm_attn_fwd(q, k, v, gate, rel, sm_scale)


@wavlm_attn_op.register_fake
def _wavlm_attn_fake(q, k, v, gate, rel, sm_scale):
    return torch.empty_like(q)


def wavlm_kernel_path(x: torch.Tensor, head_dim: int, recorded: bool) -> bool:
    """Whether WavLM's attention over ``x`` (B, T, D) runs the op: on the
    card, in bf16, at head dim 64, and not ``recorded`` by autograd (serving,
    validation, exported programs). Such a call over more than WAVLM_MAX_LEN
    positions raises a ValueError: the kernel cannot take it, and the plain
    path's (B, H, T, T) f32 scores would not fit either."""
    if not (x.is_cuda and x.dtype == torch.bfloat16 and head_dim == HEAD_DIM and not recorded):
        return False
    if x.shape[1] > WAVLM_MAX_LEN:
        raise ValueError(f"WavLM's bf16 attention on the card takes up to WAVLM_MAX_LEN = "
                         f"{WAVLM_MAX_LEN} positions, not {x.shape[1]}: serve shorter chunks")
    return True


class FlashAttention(torch.autograd.Function):
    """softmax(q kᵀ sm_scale) v with the kernels forward and backward.

    On CPU tensors (the tests) the same two steps run their plain versions:
    ``attention_plain`` with ``attention_lse_plain``, and
    ``attention_bwd_plain``."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale: float):
        out, lse = flash_fwd_lse_op(q, k, v, sm_scale)
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
    """softmax(q kᵀ sm_scale) v over q of (B, Sq, H, D) and k, v of (B,
    Skv, H, D); returns (B, Sq, H, D) in ``dtype``. Sq ≠ Skv (a seq member's
    query block against its group's keys) is served only: a recorded call
    raises, as the backward kernels take one length.

    On the card, ``dtype`` is bfloat16 or float32 (the inputs' dtype); a
    call that autograd records goes through ``FlashAttention``, one that it
    does not (serving, an exported program) through the forward op alone,
    without the log-sum-exp. On the CPU a recorded call runs the plain
    version under autograd, and an unrecorded one the op's plain version."""
    recorded = torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v))
    if recorded and q.shape[1] != k.shape[1]:
        raise NotImplementedError(
            f"attention with {q.shape[1]} query rows against {k.shape[1]} keys under autograd: "
            "unequal lengths are not trainable, as the backward kernels take one length; no "
            "trained path needs them: only the Whisper encoder splits time over mesh.seq, "
            "and it is frozen, as in JAX")
    if q.is_cuda:
        if dtype not in KERNEL_DTYPES:
            raise ValueError(
                f"attention on the card runs in bfloat16 or float32, got {dtype}"
            )
        if q.dtype != dtype:
            raise ValueError(f"attention on the card: inputs are {q.dtype}, dtype is {dtype}")
        if recorded:
            return FlashAttention.apply(q, k, v, sm_scale)
        return flash_fwd_op(q, k, v, sm_scale)
    if recorded or q.dtype != dtype:
        return attention_plain(q, k, v, sm_scale, dtype)
    return flash_fwd_op(q, k, v, sm_scale)
