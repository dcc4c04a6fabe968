"""flash_fwd_roofline (``flash_fwd_roofline.serve``,
``flash_fwd_roofline.train``): the bf16 attention forward's bound
(``roofs.flash_fwd_bound_ms``) at the shapes each call of the op
``segma_tpu_torch::flash_attn_fwd`` recorded, and with its log-sum-exp at
those each ``segma_tpu_torch::flash_attn_fwd_lse`` call recorded (the
training forward), over the device time of the kernels launched under
those calls."""

from h100bench.harness.trace import roofline_share
from h100bench.metrics.roofs import flash_fwd_bound_ms


def bound_s(shapes, lse: bool = False):
    (b, s_q, h, d), (_, s_kv, _, _) = shapes[0], shapes[1]
    return flash_fwd_bound_ms(b, s_q, s_kv, h, d, lse=lse) * 1e-3


OPS = {"segma_tpu_torch::flash_attn_fwd": bound_s,
       "segma_tpu_torch::flash_attn_fwd_lse": lambda shapes: bound_s(shapes, lse=True)}


def read(run, outcome):
    return None if run.op_trace is None else roofline_share(run.op_trace, OPS)
