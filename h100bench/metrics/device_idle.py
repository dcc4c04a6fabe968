"""device_idle (``device_idle.serve``, ``device_idle.train``): the share of
the traced window's device slice (device activity traced alone, so the host
runs at its own speed) in which no device activity ran, from the union of
each card's intervals, averaged over the cell's cards."""

from h100bench.harness.trace import busy_shares


def read(run, outcome):
    if run.device_trace is None:
        return None
    shares = busy_shares(run.device_trace)
    return 100.0 * (1.0 - sum(shares.values()) / len(shares))
