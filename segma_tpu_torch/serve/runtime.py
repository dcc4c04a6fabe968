"""Process lifecycle: the signal-aware serve loop, the RSS watchdog and the
entry point (counterpart of ``segma_tpu/serve/runtime.py``).

``serve_forever`` loads a live model, an exported artifact or a bundle of
artifacts on the card, warms it up (the kernel and WAV reader builds, one
forward and decode) before it accepts traffic, binds the server and runs
until SIGTERM/SIGINT, with a graceful drain and an optional RSS self-recycle
(exit 75). A live model serves over the config's mesh (``mesh="auto"`` with
several cards, as JAX's ``serve/runtime.py`` builds it from the config, or a
``parallel.Mesh`` of any (data, seq, model) shape): one-shot and
micro-batched requests split their windows over ``data``, each coordinate's
members splitting the model over ``seq`` and ``model``; streaming sessions
run on the first card, as artifacts and bundles do (JAX's ``streaming.py``
and ``export.py`` stay on one device too).
"""

from __future__ import annotations

import threading
import time
from http.server import ThreadingHTTPServer
from pathlib import Path
from typing import Any

import numpy as np
import torch

from segma_tpu_torch import resolve_device
from segma_tpu_torch.inference import InferencePipeline, resolve_mesh
from segma_tpu_torch.parallel.mesh import Mesh, describe
from segma_tpu_torch.serve.http import make_server
from segma_tpu_torch.serve.router import ModelRouter, _warm_stream_programs, bundle_reloader
from segma_tpu_torch.serve.service import MAX_STREAM_SESSIONS, SegmentationService
from segma_tpu_torch.streaming import StreamingSegmenter
from segma_tpu_torch.utils import host_rss_gb
from segma_tpu_torch.utils.logging import log

def _start_rss_watchdog(
    server: ThreadingHTTPServer, limit_gb: float, poll_s: float = 10.0
) -> dict:
    """Graceful self-recycle for a long-lived server: when RSS crosses
    ``limit_gb``, stop accepting, drain in-flight requests and let the
    process exit (75) for the orchestrator to restart it, instead of the OOM
    killer resetting clients mid-reply. Returns a state dict whose ``fired``
    key records whether the watchdog tripped."""
    state = {"fired": False}

    def watch() -> None:
        while True:
            time.sleep(poll_s)
            rss = host_rss_gb()
            if rss > limit_gb:
                log(f"host RSS {rss:.2f} GB > --max-rss-gb {limit_gb:g}: "
                    "draining and exiting for an orchestrator restart")
                state["fired"] = True
                server.shutdown()
                return

    threading.Thread(target=watch, daemon=True).start()
    return state


def _serve_until_signalled(server: ThreadingHTTPServer, max_rss_gb: float = 0.0) -> None:
    """serve_forever with graceful termination.

    SIGTERM stops accepting, then ``_Server.drain()`` waits for in-flight
    requests to finish replying (handler threads are daemon: the stdlib's
    close joins nothing) and force-closes long-lived WebSocket sessions.
    ``shutdown()`` runs on a helper thread: it blocks until the serve loop
    exits, and the signal fires on the loop's thread. ``max_rss_gb`` > 0
    arms the RSS watchdog (exit 75 when it fires)."""
    import signal

    def _term(signum, frame):
        log("SIGTERM: draining in-flight requests and shutting down")
        threading.Thread(target=server.shutdown, daemon=True).start()

    try:
        prev = signal.signal(signal.SIGTERM, _term)
    except ValueError:  # not the main thread (library or test embedding)
        prev = None
    watchdog = _start_rss_watchdog(server, max_rss_gb) if max_rss_gb > 0 else None
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)
        # the accept loop stopping does not finish in-flight replies: wait
        # for them, then force-close long-lived WebSocket sessions
        if hasattr(server, "drain"):
            server.drain()
    if watchdog is not None and watchdog["fired"]:
        raise SystemExit(75)  # EX_TEMPFAIL: restart me


def warm_up(service: SegmentationService, batching: bool = False) -> None:
    """Build what the first request would otherwise build inside a request
    thread: the CUDA kernels and the WAV reader; then one forward and decode
    of a zero chunk through the one-shot path and the streaming forward (an
    artifact's stream programs, its batched ones too under ``batching``)."""
    from segma_tpu_torch.ops import _build

    pipeline = service.pipeline
    _build.host_library()
    if pipeline.device.type == "cuda":
        _build.library()
    if service.exported:
        warm = np.zeros(int(pipeline.manifest["chunk_duration_f"]), np.int16)
        pipeline.segment(warm, service.thresholds)
        _warm_stream_programs(pipeline, batching)
        return
    warm = np.zeros(pipeline.model.config.audio.chunk_duration_f, np.int16)
    with torch.inference_mode():
        lg, tf = pipeline.logits_for_audio_async(warm)
        if lg is not None:
            pipeline.decode_intervals(lg, service.thresholds, valid_frames=tf)
        seg = StreamingSegmenter(pipeline.model, service.thresholds)
        seg.push(warm)
        seg.flush()
    if pipeline.device.type == "cuda":
        torch.cuda.synchronize(pipeline.device)


def serve_forever(
    config: Any = None,
    checkpoint: Path | str | None = None,
    host: str = "127.0.0.1",
    port: int = 8000,
    thresholds: dict | None = None,
    batch_size: int = 64,
    batch_window_ms: float = 0.0,
    max_batch: int = 8,
    transport: str = "int16",
    artifact: Path | str | None = None,
    bundle: Path | str | None = None,
    default_model: str | None = None,
    max_body_mb: float = 512.0,
    mesh: Any = "auto",
    max_sessions: int = MAX_STREAM_SESSIONS,
    max_rss_gb: float = 0.0,
    device: str | torch.device | None = "cuda",
) -> None:
    """Load the model and serve until interrupted (the CLI's entry point).

    One of: ``config`` (a ``Config`` or a YAML path) and ``checkpoint``
    (None: the random weights of ``train.seed``) for a live model;
    ``artifact``, an exported artifact directory; or ``bundle``, a directory
    of artifacts served behind one port (``?model=<name>``; POST
    /admin/reload re-scans it). Everything runs on ``device``; a live
    model's ``mesh`` ("auto", "off", None or a ``parallel.Mesh``, as
    ``inference.resolve_mesh`` takes it) spreads one-shot requests over the
    mesh's cards. Artifacts and bundles serve on ``device`` alone."""
    dev = resolve_device(device)
    if not (mesh in ("auto", "off", None) or isinstance(mesh, Mesh)):
        raise ValueError(f"mesh must be 'auto', 'off', None or a Mesh, got {mesh!r}")
    max_body_bytes = int(max_body_mb * (1 << 20))
    if bundle is not None:
        from segma_tpu_torch.ops import _build

        _build.host_library()
        if dev.type == "cuda":
            _build.library()
        rescan = bundle_reloader(
            bundle, default_model=default_model, thresholds=thresholds, transport=transport,
            batch_window_ms=batch_window_ms, max_batch=max_batch, max_sessions=max_sessions,
            device=dev,
        )
        log("loading the bundle's artifacts (load and warm)...")
        services, default, _ = rescan({})
        router = ModelRouter(services, default, reloader=rescan)
        server = make_server(router, host, port, max_body_bytes)
        log(f"serving bundle [{', '.join(sorted(services))}] (default {default}) on "
            f"http://{host}:{server.server_address[1]}")
        _serve_until_signalled(server, max_rss_gb)
        return

    if artifact is not None:
        from segma_tpu_torch.export import ExportedPipeline

        pipeline = ExportedPipeline.load(artifact, device=dev)
    else:
        from segma_tpu_torch.checkpoint import load_model_for_inference
        from segma_tpu_torch.config import Config, load_config

        cfg = config if isinstance(config, Config) else load_config(config)
        model = load_model_for_inference(cfg, checkpoint, device=dev)
        pipeline = InferencePipeline(
            model, batch_size=batch_size, device=dev,
            transport="adpcm" if transport == "adpcm" else "auto",
            mesh=resolve_mesh(mesh, cfg, dev),
        )
        if pipeline.mesh is not None:
            log(f"serving over the mesh {pipeline.mesh.shape} on "
                f"{', '.join(str(m.device) for m in pipeline.members.flat)}: "
                f"{describe(pipeline.mesh)}")
    service = SegmentationService(
        pipeline, thresholds, transport=transport, batch_window_ms=batch_window_ms,
        max_batch=max_batch, max_sessions=max_sessions,
    )
    log("warming up (kernel builds, one forward)...")
    warm_up(service, batch_window_ms > 0)
    server = make_server(service, host, port, max_body_bytes)
    log(f"serving {service.model_name} on http://{host}:{server.server_address[1]}")
    _serve_until_signalled(server, max_rss_gb)
