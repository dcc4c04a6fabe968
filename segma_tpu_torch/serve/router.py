"""Model routing for the HTTP server (counterpart of
``segma_tpu/serve/router.py``): the name -> service table, the default
model, and the models, metrics and health payloads. A server fronts one
live model; bundles of exported artifacts and their hot reload
(``bundle_reloader``, ``_warm_stream_programs``) wait for the export slice.
"""

from __future__ import annotations

import json
import threading
from pathlib import Path
from typing import Any, Callable

from segma_tpu_torch.serve.service import MAX_STREAM_SESSIONS, SegmentationService
from segma_tpu_torch.serve.stats import render_metrics
from segma_tpu_torch.streaming import EXPORT_SLICE

BUNDLE_SLICE = (
    "bundles of exported artifacts are not ported yet: ROADMAP.md Queue 1, "
    "'Export, bundles and the remaining CLIs'"
)


class ModelRouter:
    """Request routing across the models of one server process. ``?model=``
    on ``/v1/segment``, ``/v1/stream/start`` and ``/v1/stream/ws`` selects;
    omitted, the default model serves. No bundle reloader is ported, so
    POST /admin/reload answers 409 as the JAX server does without one."""

    reloader: Callable | None = None

    def __init__(self, services: dict[str, SegmentationService], default: str) -> None:
        if default not in services:
            raise KeyError(f"default model {default!r} not in {sorted(services)}")
        self.services = services
        self.default = default

    @classmethod
    def single(cls, service: SegmentationService) -> "ModelRouter":
        name = service.model_name.split(" (")[0]
        return cls({name: service}, name)

    def get(self, name: str | None = None) -> SegmentationService:
        name = name or self.default
        try:
            return self.services[name]
        except KeyError:
            raise KeyError(f"unknown model {name!r} (serving: {sorted(self.services)})") from None

    def service_for_sid(self, sid: str) -> SegmentationService:
        """The service owning a streaming session (push and flush carry only
        the sid; the model was chosen at /v1/stream/start)."""
        for svc in self.services.values():
            with svc._streams_lock:
                if sid in svc._streams:
                    return svc
        raise KeyError(sid)

    def reload(self) -> bytes:
        """Re-scan a bundle (POST /admin/reload): without a reloader, as
        every server of the port is, it raises as the JAX package's does."""
        raise ValueError("hot reload is only available under --bundle serving")

    def models_payload(self) -> bytes:
        """GET /v1/models: the catalog — name, labels, streaming."""
        models = {
            name: {"model": svc.model_name, "labels": svc.labels,
                   "sample_rate": svc.sample_rate, "streaming": True}
            for name, svc in self.services.items()
        }
        return json.dumps({"default": self.default, "models": models}).encode()

    def metrics_payload(self) -> bytes:
        if len(self.services) == 1:
            return render_metrics([(None, self.get())])
        return render_metrics(sorted(self.services.items()))

    def health_payload(self) -> bytes:
        payload = json.loads(self.get().health())
        if len(self.services) > 1:
            payload["models"] = sorted(self.services)
            payload["default"] = self.default
        return json.dumps(payload).encode()


def _warm_stream_programs(pipeline: Any, batching: bool) -> None:
    """Warm an artifact's streaming programs: waits for the export slice."""
    raise NotImplementedError(EXPORT_SLICE)


def bundle_reloader(
    bundle: Path | str,
    default_model: str | None = None,
    thresholds: dict | None = None,
    transport: str = "int16",
    batch_window_ms: float = 0.0,
    max_batch: int = 8,
    device_lock: threading.Lock | None = None,
    max_sessions: int = MAX_STREAM_SESSIONS,
) -> Callable:
    """The bundle scan behind ``--bundle`` and POST /admin/reload: waits for
    the export slice."""
    raise NotImplementedError(BUNDLE_SLICE)
