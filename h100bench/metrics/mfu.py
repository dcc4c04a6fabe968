"""mfu (``mfu.serve``, ``mfu.train``): the operations of the work done in
the traced window's device slice (the chunks served, or the crops stepped,
as the driver counted them), by the benchmark's count from the
configuration's published widths (the ``flops`` of the configuration's
``models/<family>.py``; padding not counted), over the slice's seconds, the
cards and the bf16 dense peak."""

from h100bench.harness import manifest as mf
from h100bench.metrics.roofs import PEAK_BF16_FLOPS


def read(run, outcome):
    if not run.device_work or run.device_trace is None:
        return None
    flops = mf.family_module(run.config).flops(run.config, run.device_work)
    if not flops:
        return None
    t = run.device_trace
    return 100.0 * flops / (t.window_s * len(t.device) * PEAK_BF16_FLOPS)
