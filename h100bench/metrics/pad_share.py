"""pad_share (``pad_share.serve``): 100 x the padded chunks over the chunks
dispatched, from the program's counters ``serve.chunks_padded`` and
``serve.chunks_real`` over the device slice (each dispatch's bucket, a power
of two, less the chunks its files need)."""

from h100bench.harness.spans import device_slice_recording


def value(rec):
    real = rec.counters.get("serve.chunks_real", 0)
    padded = rec.counters.get("serve.chunks_padded", 0)
    return 100.0 * padded / (real + padded) if real + padded else None


def read(run, outcome):
    rec = device_slice_recording(run)
    return None if rec is None else value(rec)
