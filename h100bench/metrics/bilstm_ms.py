"""bilstm_ms (``bilstm_ms.serve``): the device time of the BiLSTM, in ms per
chunk served: the program's ``model.bilstm`` spans in the device slice,
each timed on the card by the CUDA events it records around the LSTM's work
on its stream, over the slice's ``serve.chunks_real``. Padded chunks run
the LSTM too, so padding shows here as well as in ``pad_share``.

An upper bound: the time between the two events is the stream's, and holds
any idle of the stream between them (a host late to enqueue the LSTM's
kernels after the encoder's), not the LSTM's kernels alone. The device
slice keeps no correlation ids, so the kernels the span launched cannot be
summed; where it does, this reads their durations instead."""

from h100bench.harness.spans import device_slice_recording


def value(rec):
    real = rec.counters.get("serve.chunks_real", 0)
    times = [s.cuda_ns for s in rec.named("model.bilstm")]
    if not real or not times or None in times:
        return None
    return sum(times) * 1e-6 / real


def read(run, outcome):
    rec = device_slice_recording(run)
    return None if rec is None else value(rec)
