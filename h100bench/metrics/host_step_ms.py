"""host_step_ms (``host_step_ms.train``): the median duration, in ms, of the
program's ``train.step`` spans in the device slice: the host's time to
enqueue one training step (forward, backward and AdamW launched, nothing
waited for)."""

from h100bench.harness.spans import device_slice_recording, median_ms


def read(run, outcome):
    rec = device_slice_recording(run)
    return None if rec is None else median_ms(rec, "train.step")
