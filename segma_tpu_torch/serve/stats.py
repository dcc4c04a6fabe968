"""Serving observability: thread-safe counters and Prometheus rendering.

A copy of ``segma_tpu/serve/stats.py``: the metric names and the exposition
are the serving contract (``tests/test_torch_serve.py``).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover — typing only
    from segma_tpu_torch.serve.service import SegmentationService


class _Stats:
    """Thread-safe serving counters + latency reservoir for ``/metrics``."""

    def __init__(self, window: int = 1024) -> None:
        self._lock = threading.Lock()
        self.requests = 0
        self.errors = 0
        self.audio_seconds = 0.0
        self.started = time.monotonic()
        self._lat = collections.deque(maxlen=window)

    def record(self, latency_s: float, audio_s: float) -> None:
        with self._lock:
            self.requests += 1
            self.audio_seconds += audio_s
            self._lat.append(latency_s)

    def record_error(self) -> None:
        with self._lock:
            self.errors += 1

    def samples(
        self, service: "SegmentationService", labels: dict[str, str]
    ) -> list[tuple[str, str, dict[str, str], float | int]]:
        """(metric, prom_type, labels, value) rows for one service."""
        with self._lock:
            lat = sorted(self._lat)
            requests, errors = self.requests, self.errors
            audio_s = self.audio_seconds
        rows = [
            ("segma_requests_total", "counter", labels, requests),
            ("segma_request_errors_total", "counter", labels, errors),
            ("segma_audio_seconds_total", "counter", labels, round(audio_s, 3)),
            (
                "segma_uptime_seconds",
                "gauge",
                labels,
                round(time.monotonic() - self.started, 3),
            ),
            (
                "segma_batch_dispatches_total",
                "counter",
                labels,
                service._batcher.dispatches if service._batcher else requests,
            ),
        ]
        for p in (0.5, 0.9, 0.99):
            if lat:
                v = lat[min(len(lat) - 1, int(p * len(lat)))]
                rows.append(
                    (
                        "segma_request_latency_seconds",
                        "summary",
                        {**labels, "quantile": str(p)},
                        round(v, 4),
                    )
                )
        return rows

    def render(self, service: "SegmentationService") -> bytes:
        """Prometheus text exposition for a single unlabeled service."""
        return render_metrics([(None, service)])


def render_metrics(
    entries: list[tuple[str | None, "SegmentationService"]],
) -> bytes:
    """Prometheus text format over one or more services.

    A ``None`` label renders bare samples (single-model server); a name
    adds ``{model="<name>"}`` so one bundle server exposes per-model
    series. ``# TYPE`` headers appear once per metric as the exposition
    format requires, whatever the service count.
    """
    rows: list[tuple[str, str, dict[str, str], float | int]] = []
    for name, service in entries:
        labels = {} if name is None else {"model": name}
        rows.extend(service.stats.samples(service, labels))
    order = list(dict.fromkeys(m for m, _, _, _ in rows))
    lines: list[str] = []
    for metric in order:
        group = [r for r in rows if r[0] == metric]
        lines.append(f"# TYPE {metric} {group[0][1]}")
        for _, _, labels, value in group:
            lab = (
                "{"
                + ",".join(f'{k}="{v}"' for k, v in labels.items())
                + "}"
                if labels
                else ""
            )
            lines.append(f"{metric}{lab} {value}")
    # process-level host memory gauge: a long-lived server needs an
    # alertable RSS signal so operators recycle before the OOM killer does
    from segma_tpu_torch.utils import host_rss_gb

    lines.append("# TYPE segma_host_rss_bytes gauge")
    lines.append(f"segma_host_rss_bytes {int(host_rss_gb() * 1e9)}")
    return ("\n".join(lines) + "\n").encode()
