"""HTTP serving for segmentation (counterpart of ``segma_tpu/serve``).

One live :class:`~segma_tpu_torch.inference.InferencePipeline` on the card,
an exported :class:`~segma_tpu_torch.export.ExportedPipeline`, or a bundle of
artifacts (one service each, chosen with ``?model=<name>``) is fronted by a
threading HTTP server:

- ``GET  /healthz``            liveness + model/device info
- ``GET  /metrics``            Prometheus text: request/error counters,
  audio-seconds processed, latency quantiles, batch dispatches
- ``GET  /v1/models``          catalog of served models (an artifact's provenance too)
- ``POST /v1/segment``         one audio body -> intervals
  - body: a RIFF/WAVE file, or raw 16 kHz mono int16 PCM with
    ``Content-Type: audio/l16`` (big-endian per RFC 2586; append
    ``;endianness=little`` for s16le streams)
  - query: ``uri=<name>`` (labels the output), ``format=json|rttm``
- ``POST /v1/stream/start``    open an online-segmentation session
- ``POST /v1/stream/<sid>/push``  raw PCM16 samples -> intervals
  finalized so far (same ``audio/l16`` semantics; octet-stream defaults to
  little-endian)
- ``POST /v1/stream/<sid>/flush`` process the tail, close open runs, end
  the session. Sessions idle > 10 min are evicted.
- ``GET  /v1/stream/ws``       the same session over one WebSocket
- ``POST /admin/reload``       re-scan the bundle: new and re-exported
  artifacts are loaded and warmed before they route, unchanged ones keep
  their service, old sessions drain; 409 without a bundle

The HTTP layer is multi-threaded so upload and WAV decode of request i+1
overlap device compute of request i; device work is serialized by a lock,
or grouped by the micro-batchers (``--batch-window-ms``). Responses equal
``run_inference_on_audios``'s on the same audio: the same forward, packed
run-length decode and interval math run underneath.
"""

from segma_tpu_torch.serve.http import _make_handler, _Server, make_server
from segma_tpu_torch.serve.router import (
    ModelRouter,
    _warm_stream_programs,
    bundle_reloader,
)
from segma_tpu_torch.serve.runtime import (
    _serve_until_signalled,
    _start_rss_watchdog,
    serve_forever,
)
from segma_tpu_torch.serve.service import (
    MAX_BODY_BYTES,
    MAX_STREAM_SESSIONS,
    SegmentationService,
    SessionLimitError,
    _MicroBatcher,
)
from segma_tpu_torch.serve.stats import _Stats, render_metrics

__all__ = [
    "MAX_BODY_BYTES",
    "MAX_STREAM_SESSIONS",
    "ModelRouter",
    "SegmentationService",
    "SessionLimitError",
    "bundle_reloader",
    "make_server",
    "render_metrics",
    "serve_forever",
]
