"""flash_bwd_roofline: the bf16 attention backward's bound
(``roofs.flash_bwd_bound_ms``) at the output gradient's shape each
``FlashAttentionBackward`` autograd node recorded, over the device time of
the kernels launched under those nodes."""

from h100bench.harness.trace import roofline_share
from h100bench.metrics.roofs import flash_bwd_bound_ms

NODE = "FlashAttentionBackward"


def bound_s(shapes):
    b, s, h, d = shapes[0]
    return flash_bwd_bound_ms(b, s, h, d) * 1e-3


def read(run, outcome):
    return None if run.op_trace is None else roofline_share(run.op_trace, {NODE: bound_s})
