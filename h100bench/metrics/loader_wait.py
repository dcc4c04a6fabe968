"""loader_wait (``loader_wait.train``): 100 x the seconds the training
thread waited for the loader's next batch (the program's
``train.loader_wait`` spans) over the device slice's wall."""

from h100bench.harness.spans import device_slice_recording, time_share


def read(run, outcome):
    rec = device_slice_recording(run)
    return None if rec is None else time_share(run.device_trace, rec, "train.loader_wait")
