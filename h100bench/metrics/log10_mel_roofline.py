"""log10_mel_roofline: the log-mel's bound (``roofs.logmel_bound_ms``) at
the input shape each call of the op ``segma_tpu_torch::log10_mel`` recorded,
over the device time of the kernels launched under those calls."""

from h100bench.harness.trace import roofline_share
from h100bench.metrics.roofs import logmel_bound_ms

OP = "segma_tpu_torch::log10_mel"


def bound_s(shapes):
    b, t = shapes[0]
    return logmel_bound_ms(b, t) * 1e-3


def read(run, outcome):
    return None if run.op_trace is None else roofline_share(run.op_trace, {OP: bound_s})
