"""The HTTP/WebSocket layer: request handler, threaded server, drain (a
copy of ``segma_tpu/serve/http.py``: the routes, status codes and JSON keys
are the same).

Routes are documented on the package docstring
(:mod:`segma_tpu_torch.serve`). The handler is multi-threaded so upload + WAV
decode of request i+1 overlap device compute of request i; device work
itself is serialized inside the service layer.
"""

from __future__ import annotations

import json
import struct
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any
from urllib.parse import parse_qs, urlparse

from segma_tpu_torch import ws
from segma_tpu_torch.serve.router import ModelRouter
from segma_tpu_torch.serve.service import (
    MAX_BODY_BYTES,
    SegmentationService,
    SessionLimitError,
)
from segma_tpu_torch.streaming import StreamFlushedError


def _make_handler(
    router: ModelRouter, max_body_bytes: int = MAX_BODY_BYTES
) -> type[BaseHTTPRequestHandler]:
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _body_length(self) -> int | None:
            """Content-Length, bounded; None means an error reply (400/413)
            was already sent."""
            try:
                length = int(self.headers.get("Content-Length", 0))
                if length < 0:
                    raise ValueError(length)
            except ValueError:
                # a garbage header must get a clean 400, not an unhandled
                # exception that drops the connection without a response
                self.close_connection = True
                self._error(400, "invalid Content-Length header")
                return None
            if length > max_body_bytes:
                # the body was never read: this keep-alive connection is
                # now mid-upload and unusable — close it after replying
                self.close_connection = True
                self._error(
                    413,
                    f"body of {length} bytes exceeds the "
                    f"{max_body_bytes} byte cap",
                )
                return None
            return length

        def _reply(self, code: int, payload: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def _error(self, code: int, message: str) -> None:
            self._reply(
                code, json.dumps({"error": message}).encode(), "application/json"
            )

        def _stream_route(self, url) -> None:
            """POST /v1/stream/start | /v1/stream/<sid>/push | .../flush."""
            parts = url.path.split("/")  # ['', 'v1', 'stream', ...]
            t0 = time.monotonic()
            if parts[3:] == ["start"]:
                # drain any request body: leaving unread bytes on a
                # keep-alive connection desyncs the NEXT request (its
                # request line would be parsed out of this body)
                length = self._body_length()
                if length is None:
                    return
                if length:
                    self.rfile.read(length)
                model = parse_qs(url.query).get("model", [None])[0]
                try:
                    service = router.get(model)
                except KeyError as e:
                    self._error(404, str(e))
                    return
                try:
                    sid = service.stream_start()
                    self._reply(
                        200,
                        json.dumps({"session": sid}).encode(),
                        "application/json",
                    )
                except SessionLimitError as e:
                    service.stats.record_error()
                    self._error(429, str(e))
                except ValueError as e:  # exported artifact: batch-only
                    service.stats.record_error()
                    self._error(400, str(e))
                except Exception as e:  # noqa: BLE001 — keep the server alive
                    service.stats.record_error()
                    self._error(500, f"{type(e).__name__}: {e}")
                return
            if len(parts) != 5 or parts[4] not in ("push", "flush"):
                self._error(404, f"unknown path {url.path!r}")
                return
            sid, op = parts[3], parts[4]
            try:
                service = router.service_for_sid(sid)
            except KeyError:
                router.get().stats.record_error()
                self._error(404, "unknown or expired stream session")
                return
            length = self._body_length()
            if length is None:
                service.stats.record_error()
                return
            try:
                body = self.rfile.read(length)
                if op == "push":
                    intervals = service.stream_push(
                        sid, body, self.headers.get("Content-Type", "")
                    )
                    audio_s = (length / 2) / service.sample_rate
                else:
                    intervals = service.stream_flush(sid)
                    audio_s = 0.0
                self._reply(
                    200,
                    service.to_json(sorted(intervals), sid),
                    "application/json",
                )
                service.stats.record(time.monotonic() - t0, audio_s)
            except KeyError:
                # session raced away (second flush / TTL eviction) between
                # the router lookup and the operation
                service.stats.record_error()
                self._error(404, "unknown or expired stream session")
            except Exception as e:  # noqa: BLE001 — keep the server alive
                service.stats.record_error()
                if isinstance(e, StreamFlushedError):
                    # racing flush on the same session -> client conflict
                    self._error(409, str(e))
                elif isinstance(e, ValueError):
                    self._error(400, str(e))
                else:  # e.g. a CUDA error (device failure)
                    self._error(500, f"{type(e).__name__}: {e}")

        def _ws_route(self, url) -> None:
            """GET /v1/stream/ws — WebSocket streaming session.

            Binary frames carry raw s16le PCM pushes; each push is answered
            with a text frame of newly finalized intervals. A text "flush"
            frame (or a close frame) processes the tail, answers with the
            final intervals, and ends the session. Per-push overhead drops
            from a full HTTP request to a 2-14 byte frame header."""
            key = self.headers.get("Sec-WebSocket-Key")
            if (
                key is None
                or self.headers.get("Upgrade", "").lower() != "websocket"
            ):
                self._error(400, "websocket upgrade required")
                return
            try:
                service = router.get(parse_qs(url.query).get("model", [None])[0])
            except KeyError as e:
                self._error(404, str(e))
                return
            try:
                sid = service.stream_start()
            except SessionLimitError as e:
                self._error(429, str(e))
                return
            except ValueError as e:  # exported artifact: batch-only
                self._error(400, str(e))
                return
            self.send_response(101)
            self.send_header("Upgrade", "websocket")
            self.send_header("Connection", "Upgrade")
            self.send_header("Sec-WebSocket-Accept", ws.accept_key(key))
            self.end_headers()
            self.close_connection = True
            # register for the drain path (graceful shutdown force-closes
            # long-lived WS sockets instead of waiting them out), and reap
            # dead peers: a socket idle past the session TTL raises
            # timeout -> OSError -> discard below
            self.server.ws_conns.add(self.connection)
            self.connection.settimeout(SegmentationService.STREAM_TTL_S)

            def send(opcode: int, payload: bytes) -> None:
                self.wfile.write(ws.encode_frame(opcode, payload))
                self.wfile.flush()

            def finish(close_payload: bytes = b"") -> None:
                try:
                    intervals = service.stream_flush(sid)
                    send(ws.OP_TEXT, service.to_json(sorted(intervals), sid))
                except KeyError:
                    pass  # session already flushed/evicted
                # echo the peer's close code only when it is well-formed
                # (RFC 6455 §5.5.1: a close payload is empty or >= 2 bytes)
                send(
                    ws.OP_CLOSE,
                    close_payload[:2] if len(close_payload) >= 2 else b"",
                )

            try:
                while True:
                    op, payload = ws.read_frame(self.rfile)
                    t0 = time.monotonic()
                    if op == ws.OP_PING:
                        send(ws.OP_PONG, payload)
                    elif op == ws.OP_CLOSE:
                        finish(payload)
                        return
                    elif op == ws.OP_BINARY:
                        intervals = service.stream_push(
                            sid, payload, "audio/l16;endianness=little"
                        )
                        send(ws.OP_TEXT, service.to_json(sorted(intervals), sid))
                        service.stats.record(
                            time.monotonic() - t0,
                            (len(payload) / 2) / service.sample_rate,
                        )
                    elif op == ws.OP_TEXT and payload.strip() == b"flush":
                        finish()
                        return
                    else:
                        raise ws.WebSocketError(
                            f"unexpected frame opcode {op:#x}"
                        )
            except (ConnectionError, ws.WebSocketError, OSError):
                # peer vanished or spoke garbage: drop the session quietly
                service.stats.record_error()
                service.stream_discard(sid)
            except KeyError:
                service.stats.record_error()  # session evicted mid-stream
            except Exception as e:  # noqa: BLE001 — keep the server alive
                # bad payload (odd byte count -> ValueError) or a device
                # failure mid-push: tell the peer while the socket may
                # still be writable, then drop the session. Without this
                # the handler thread would die with a traceback and the
                # session would leak until TTL eviction.
                service.stats.record_error()
                try:
                    send(
                        ws.OP_CLOSE,
                        struct.pack("!H", 1011)
                        + f"{type(e).__name__}: {e}".encode()[:120],
                    )
                except Exception:  # noqa: BLE001 — socket already gone
                    pass
                service.stream_discard(sid)
            finally:
                self.server.ws_conns.discard(self.connection)

        def do_GET(self):  # noqa: N802 (http.server API)
            url = urlparse(self.path)
            if url.path == "/v1/stream/ws":
                # long-lived: NOT counted in-flight — the drain path
                # force-closes the registered socket instead of waiting
                self._ws_route(url)
                return
            with self.server.track_inflight():
                self._get_inner(url)

        def _get_inner(self, url) -> None:
            path = url.path
            if path == "/healthz":
                self._reply(200, router.health_payload(), "application/json")
            elif path == "/metrics":
                self._reply(
                    200,
                    router.metrics_payload(),
                    "text/plain; version=0.0.4",
                )
            elif path == "/v1/models":
                self._reply(200, router.models_payload(), "application/json")
            else:
                self._error(404, f"unknown path {self.path!r}")

        def do_POST(self):  # noqa: N802
            with self.server.track_inflight():
                self._post_inner(urlparse(self.path))

        def _post_inner(self, url) -> None:
            if url.path.startswith("/v1/stream"):
                self._stream_route(url)
                return
            if url.path == "/admin/reload":
                length = self._body_length()
                if length is None:
                    return
                if length:
                    self.rfile.read(length)  # drain (reloads take no body)
                if router.reloader is None:
                    self._error(
                        409,
                        "hot reload is only available under --bundle serving",
                    )
                    return
                try:
                    self._reply(200, router.reload(), "application/json")
                except Exception as e:  # noqa: BLE001 — a failed rescan
                    # (torn artifact, bad bundle.json) leaves the previous
                    # routing table untouched; report it, keep serving
                    self._error(500, f"{type(e).__name__}: {e}")
                return
            if url.path != "/v1/segment":
                self._error(404, f"unknown path {self.path!r}")
                return
            q = parse_qs(url.query)
            uri = q.get("uri", ["audio"])[0]
            fmt = q.get("format", ["json"])[0]
            try:
                service = router.get(q.get("model", [None])[0])
            except KeyError as e:
                self._error(404, str(e))
                return
            length = self._body_length()
            if length is None:
                service.stats.record_error()
                return
            t0 = time.monotonic()
            try:
                body = self.rfile.read(length)
                audio = service._audio_from_body(
                    body, self.headers.get("Content-Type", "")
                )
                intervals = service.segment_audio(audio)
                if fmt == "rttm":
                    self._reply(200, service.to_rttm(intervals, uri), "text/plain")
                else:
                    self._reply(
                        200, service.to_json(intervals, uri), "application/json"
                    )
                n = audio.n_samples if hasattr(audio, "n_samples") else audio.size
                service.stats.record(
                    time.monotonic() - t0, n / service.sample_rate
                )
            except ValueError as e:
                service.stats.record_error()
                self._error(400, str(e))
            except Exception as e:  # noqa: BLE001 — keep the server alive
                service.stats.record_error()
                self._error(500, f"{type(e).__name__}: {e}")

    return Handler


class _Server(ThreadingHTTPServer):
    """ThreadingHTTPServer + real drain support.

    ``daemon_threads`` stays True (an idle keep-alive connection must not
    be able to block process exit), so stdlib ``server_close`` joins
    nothing — instead requests are COUNTED: ``drain()`` waits for the
    in-flight count to reach zero (bounded by ``grace_s``) and then
    force-closes registered long-lived WebSocket sockets, whose handlers
    exit via their normal disconnect path (session discarded)."""

    daemon_threads = True

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self.ws_conns: set = set()

    def track_inflight(self) -> Any:
        import contextlib

        @contextlib.contextmanager
        def cm():
            with self._inflight_lock:
                self._inflight += 1
            try:
                yield
            finally:
                with self._inflight_lock:
                    self._inflight -= 1

        return cm()

    def inflight(self) -> int:
        with self._inflight_lock:
            return self._inflight

    def drain(self, grace_s: float = 30.0) -> None:
        """Let in-flight requests finish (up to ``grace_s``), then
        force-close long-lived WS sessions so nothing outlives us."""
        import socket as _socket

        deadline = time.monotonic() + grace_s
        while time.monotonic() < deadline and self.inflight() > 0:
            time.sleep(0.05)
        for conn in list(self.ws_conns):
            try:
                conn.shutdown(_socket.SHUT_RDWR)
            except OSError:
                pass


def make_server(
    service: SegmentationService | ModelRouter,
    host: str = "127.0.0.1",
    port: int = 8000,
    max_body_bytes: int = MAX_BODY_BYTES,
) -> ThreadingHTTPServer:
    """Bind (but do not start) the HTTP server; ``port=0`` picks a free one.

    Accepts one :class:`SegmentationService` (wrapped into a single-model
    router) or a :class:`ModelRouter` over a bundle's services.
    """
    router = (
        service
        if isinstance(service, ModelRouter)
        else ModelRouter.single(service)
    )
    return _Server((host, port), _make_handler(router, max_body_bytes))
