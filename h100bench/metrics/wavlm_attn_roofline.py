"""wavlm_attn_roofline: WavLM's gated-bias attention forward against its
bound (``bound_ms``) at the shapes each call of the op
``segma_tpu_torch::wavlm_attn_fwd`` recorded, over the device time of the
kernels launched under those calls. A program without the op (an older
commit, or a cell without WavLM) has no such calls: None."""

from h100bench.harness.trace import roofline_share
from h100bench.metrics.roofs import PEAK_BF16_FLOPS, bound_ms

OP = "segma_tpu_torch::wavlm_attn_fwd"


def wavlm_attn_bound_ms(b: int, s: int, h: int, d: int) -> float:
    """The larger of two times: the two products, 4 b h s² d operations, at
    the bf16 peak; and the bytes, q, k and v read and the output written
    once in bf16 (8 b s h d), the (b, h, s) f32 gate and the (h, 2s - 1) f32
    rows read once, at HBM rate."""
    flops = 4 * b * h * s * s * d
    n_bytes = 8 * b * s * h * d + 4 * b * h * s + 4 * h * (2 * s - 1)
    return bound_ms(flops, PEAK_BF16_FLOPS, n_bytes)[0]


def bound_s(shapes):
    b, s, h, d = shapes[0]
    return wavlm_attn_bound_ms(b, s, h, d) * 1e-3


def read(run, outcome):
    return None if run.op_trace is None else roofline_share(run.op_trace, {OP: bound_s})
