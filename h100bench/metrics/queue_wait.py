"""queue_wait (``queue_wait.serve``): 100 x the seconds the dispatching
thread waited for the prefetch thread's next file (the program's
``serve.queue_wait`` spans) over the device slice's wall."""

from h100bench.harness.spans import device_slice_recording, time_share


def read(run, outcome):
    rec = device_slice_recording(run)
    return None if rec is None else time_share(run.device_trace, rec, "serve.queue_wait")
