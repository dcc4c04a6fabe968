"""Model routing and bundle hot reload for the HTTP server (counterpart of
``segma_tpu/serve/router.py``).

One server process fronts a single model or a bundle directory of exported
artifacts (``segma_tpu_torch.bundle``); the router owns the name -> service
table, the default election, and the ``POST /admin/reload`` rescan that
swaps the table at once under load.
"""

from __future__ import annotations

import json
import threading
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from segma_tpu_torch.serve.service import MAX_STREAM_SESSIONS, SegmentationService
from segma_tpu_torch.serve.stats import render_metrics


class ModelRouter:
    """Request routing across the models of one server process.

    Single-model serving wraps its one service; bundle serving (``--bundle``)
    holds one service per artifact, all sharing one device lock.
    ``?model=`` on ``/v1/segment``, ``/v1/stream/start`` and ``/v1/stream/ws``
    selects; omitted, the default model serves."""

    def __init__(
        self,
        services: dict[str, SegmentationService],
        default: str,
        reloader: Callable | None = None,
    ) -> None:
        if default not in services:
            raise KeyError(f"default model {default!r} not in {sorted(services)}")
        self.services = services
        self.default = default
        # the hot-reload hook (bundle serving only): current services ->
        # (services, default, report). Services swapped out are retired, not
        # dropped: their open streaming sessions drain through service_for_sid
        self.reloader = reloader
        self._retired: list[SegmentationService] = []
        self._swap_lock = threading.Lock()

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
        the sid; the model was chosen at /v1/stream/start). Retired services
        are searched too, so that open sessions drain across a reload."""
        for svc in [*self.services.values(), *self._retired]:
            with svc._streams_lock:
                if sid in svc._streams:
                    return svc
        raise KeyError(sid)

    def reload(self) -> bytes:
        """Re-scan the bundle and swap the routing table (POST
        /admin/reload). New and changed artifacts are loaded and warmed;
        unchanged ones keep their service (and its metrics); removed or
        replaced ones take no new requests, but their open streaming
        sessions drain to completion."""
        if self.reloader is None:
            raise ValueError("hot reload is only available under --bundle serving")
        with self._swap_lock:
            new_services, default, report = self.reloader(self.services)
            old = self.services
            # one assignment each: readers never see a half-built table
            self.services = new_services
            self.default = default
            retiring = [svc for name, svc in old.items() if new_services.get(name) is not svc]
            # keep the retired services that still have sessions, evicting
            # stale ones first, so that an abandoned session (a client that
            # vanished without a flush) cannot pin its service for ever
            kept_retired = []
            for svc in (*self._retired, *retiring):
                with svc._streams_lock:
                    svc._evict_stale_streams()
                    if svc._streams:
                        kept_retired.append(svc)
            self._retired = kept_retired
            return json.dumps(report).encode()

    def models_payload(self) -> bytes:
        """GET /v1/models: the catalog — name, labels, provenance."""
        models = {}
        for name, svc in self.services.items():
            entry: dict[str, Any] = {
                "model": svc.model_name,
                "labels": svc.labels,
                "sample_rate": svc.sample_rate,
                "streaming": not svc.exported or svc.pipeline.supports_streaming,
            }
            if svc.exported:
                m = svc.pipeline.manifest
                entry.update(
                    transport=m.get("transport"),
                    framework_version=m.get("framework_version"),
                    model_version=m.get("model_version"),
                    created_at=m.get("created_at"),
                )
            models[name] = entry
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
    """Run an artifact's streaming programs once before traffic (the batched
    buckets only when micro-batching will use them)."""
    if not pipeline.supports_streaming:
        return
    chunk_f = int(pipeline.manifest["chunk_duration_f"])
    pipeline.stream_fn.call(np.zeros(chunk_f, np.float32))
    if pipeline.stream_i16_fn is not None:
        pipeline.stream_i16_fn.call(np.zeros(chunk_f, np.int16))
    if batching:
        bdt = pipeline.stream_batch_dtype
        for b, fn in sorted((pipeline.stream_batch_fns or {}).items()):
            fn.call(np.zeros((b, chunk_f), bdt))
    if pipeline.device.type == "cuda":
        torch.cuda.synchronize(pipeline.device)


def bundle_reloader(
    bundle: Path | str,
    default_model: str | None = None,
    thresholds: dict | None = None,
    transport: str = "int16",
    batch_window_ms: float = 0.0,
    max_batch: int = 8,
    device_lock: threading.Lock | None = None,
    max_sessions: int = MAX_STREAM_SESSIONS,
    device: str | torch.device = "cuda",
) -> Callable:
    """The bundle scan behind ``--bundle`` and POST /admin/reload:
    ``rescan(current_services) -> (services, default, report)``. Services
    whose artifact manifest is unchanged are reused; new or re-exported
    artifacts get new services, warmed under the shared device lock before
    they route. A scan that fails raises and changes nothing."""
    shared_lock = device_lock or threading.Lock()

    def rescan(current: dict) -> tuple[dict, str, dict]:
        from segma_tpu_torch.bundle import load_bundle

        manifest, pipelines = load_bundle(bundle, default=default_model, device=device)
        services: dict[str, SegmentationService] = {}
        added: list[str] = []
        replaced: list[str] = []
        kept: list[str] = []
        for name, pipe in pipelines.items():
            prev = current.get(name)
            if prev is not None and prev.exported and prev.pipeline.manifest == pipe.manifest:
                services[name] = prev
                kept.append(name)
                continue
            svc = SegmentationService(
                pipe, thresholds, transport=transport, batch_window_ms=batch_window_ms,
                max_batch=max_batch, device_lock=shared_lock, max_sessions=max_sessions,
            )
            warm = np.zeros(int(pipe.manifest["chunk_duration_f"]), np.int16)
            with shared_lock:  # in-flight requests share the device
                pipe.segment(warm, svc.thresholds)
                _warm_stream_programs(pipe, batch_window_ms > 0)
            services[name] = svc
            (replaced if name in current else added).append(name)
        report = {
            "default": manifest["default"],
            "added": sorted(added),
            "replaced": sorted(replaced),
            "kept": sorted(kept),
            "removed": sorted(set(current) - set(pipelines)),
        }
        return services, manifest["default"], report

    return rescan
