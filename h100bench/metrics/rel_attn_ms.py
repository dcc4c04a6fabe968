"""rel_attn_ms (``rel_attn_ms.serve``): the device time of WavLM's gated
attention, in ms per chunk served: the program's ``model.rel_attention``
spans in the device slice (each layer's gate and attention core), each
timed on the card by the CUDA events it records around that work on its
stream, over the slice's ``serve.chunks_real``. Padded chunks run it too.

An upper bound, as ``bilstm_ms.serve`` is: the time between the two events
is the stream's, and holds any idle of the stream between them, not the
span's kernels alone. A program without the span (an older commit) gives
None."""

from h100bench.harness.spans import device_slice_recording


def value(rec):
    real = rec.counters.get("serve.chunks_real", 0)
    times = [s.cuda_ns for s in rec.named("model.rel_attention")]
    if not real or not times or None in times:
        return None
    return sum(times) * 1e-6 / real


def read(run, outcome):
    rec = device_slice_recording(run)
    return None if rec is None else value(rec)
