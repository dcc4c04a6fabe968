"""Python client for the serving API — stdlib + numpy only (a copy of
``segma_tpu/client.py``).

Everything the HTTP/WS API of ``segma_tpu_torch.serve`` offers, wrapped so
callers never hand-roll requests:

    from segma_tpu_torch.client import SegmaClient

    client = SegmaClient("http://localhost:8000")
    client.health()                       # liveness + model info
    client.segment("meeting.wav")         # -> [Interval(start_s, end_s, label)]
    client.segment(samples, uri="mic")    # numpy float/-1..1 or int16

    with client.stream() as session:      # online segmentation (HTTP)
        for chunk in mic:
            print(session.push(chunk))    # newly finalized intervals
    print(session.intervals)              # everything incl. the flush

    with client.stream_ws() as session:   # same, over one WebSocket
        ...

Transport notes: ndarray inputs ship as raw s16le PCM
(``audio/l16;endianness=little``) — 2 bytes/sample, decoded on the
server's device path; file/bytes inputs ship verbatim as WAV. Streaming
pushes are raw PCM16 by protocol (the ``serve`` package docstring).
"""

from __future__ import annotations

import json
import socket
from http.client import HTTPConnection
from pathlib import Path
from typing import Iterator, NamedTuple
from urllib.parse import urlencode, urlparse

import numpy as np


class Interval(NamedTuple):
    """One decoded segment, in seconds (matches the JSON wire format)."""

    start_s: float
    end_s: float
    label: str


class SegmaClientError(RuntimeError):
    """Non-2xx reply; carries the HTTP status and the server's message."""

    def __init__(self, status: int, message: str) -> None:
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
        self.message = message


def _to_pcm16(samples: np.ndarray) -> bytes:
    if samples.dtype == np.int16:
        return samples.astype("<i2").tobytes()
    if np.issubdtype(samples.dtype, np.floating):
        return (
            (np.clip(samples, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()
        )
    raise TypeError(
        f"expected int16 or float waveform, got dtype {samples.dtype}"
    )


def _intervals(payload: bytes) -> list[Interval]:
    return [
        Interval(iv["start_s"], iv["end_s"], iv["label"])
        for iv in json.loads(payload)["intervals"]
    ]


class SegmaClient:
    """Client over one serving endpoint (single-model or bundle).

    ``model`` pins every request to one bundle model (per-call ``model=``
    arguments override it); leave None for the server's default election.
    """

    L16 = "audio/l16;endianness=little"

    def __init__(
        self,
        base_url: str = "http://127.0.0.1:8000",
        model: str | None = None,
        timeout_s: float = 300.0,
    ) -> None:
        u = urlparse(base_url)
        if u.scheme != "http" or not u.hostname:
            raise ValueError(f"expected an http://host:port URL, got {base_url!r}")
        self.host = u.hostname
        self.port = u.port or 80
        self.model = model
        self.timeout_s = timeout_s

    # -- plumbing -----------------------------------------------------------------
    def _request(
        self,
        method: str,
        path: str,
        body: bytes = b"",
        ctype: str = "application/octet-stream",
        query: dict | None = None,
        conn: HTTPConnection | None = None,
    ) -> bytes:
        """One request; raises :class:`SegmaClientError` on non-2xx."""
        q = {k: v for k, v in (query or {}).items() if v is not None}
        if q:
            path = f"{path}?{urlencode(q)}"
        own = conn is None
        if own:
            conn = HTTPConnection(self.host, self.port, timeout=self.timeout_s)
        try:
            headers = {"Content-Type": ctype} if method == "POST" else {}
            conn.request(method, path, body=body or None, headers=headers)
            resp = conn.getresponse()
            payload = resp.read()
            if not 200 <= resp.status < 300:
                try:
                    message = json.loads(payload)["error"]
                except Exception:  # noqa: BLE001 — non-JSON error body
                    message = payload.decode(errors="replace")[:200]
                raise SegmaClientError(resp.status, message)
            return payload
        finally:
            if own:
                conn.close()

    def _audio_body(
        self, audio: str | Path | bytes | bytearray | np.ndarray
    ) -> tuple[bytes, str]:
        if isinstance(audio, (str, Path)):
            return Path(audio).read_bytes(), "application/octet-stream"
        if isinstance(audio, (bytes, bytearray)):
            return bytes(audio), "application/octet-stream"
        if isinstance(audio, np.ndarray):
            return _to_pcm16(audio), self.L16
        raise TypeError(
            "audio must be a WAV path, WAV bytes, or a numpy waveform"
        )

    # -- one-shot endpoints ---------------------------------------------------------
    def health(self) -> dict:
        return json.loads(self._request("GET", "/healthz"))

    def models(self) -> dict:
        """The bundle catalog (GET /v1/models)."""
        return json.loads(self._request("GET", "/v1/models"))

    def metrics(self) -> str:
        """Prometheus text exposition (GET /metrics)."""
        return self._request("GET", "/metrics").decode()

    def reload(self) -> dict:
        """Hot-reload a bundle server (POST /admin/reload)."""
        return json.loads(self._request("POST", "/admin/reload"))

    def segment(
        self,
        audio: str | Path | bytes | bytearray | np.ndarray,
        uri: str = "audio",
        model: str | None = None,
        rttm: bool = False,
    ) -> list[Interval] | str:
        """One audio -> intervals (or the RTTM text when ``rttm=True``).

        ``audio``: WAV path, WAV bytes, or a numpy waveform (float in
        [-1, 1] or int16 at the model's sample rate).
        """
        body, ctype = self._audio_body(audio)
        payload = self._request(
            "POST",
            "/v1/segment",
            body,
            ctype,
            query={
                "uri": uri,
                "model": model or self.model,
                "format": "rttm" if rttm else "json",
            },
        )
        return payload.decode() if rttm else _intervals(payload)

    # -- streaming ------------------------------------------------------------------
    def stream(self, model: str | None = None) -> "StreamSession":
        """Open an online-segmentation session (HTTP transport)."""
        payload = self._request(
            "POST",
            "/v1/stream/start",
            query={"model": model or self.model},
        )
        return StreamSession(self, json.loads(payload)["session"])

    def stream_ws(self, model: str | None = None) -> "WSStreamSession":
        """Open an online-segmentation session over one WebSocket
        connection (2-14 byte frame overhead per push instead of a full
        HTTP request)."""
        return WSStreamSession(self, model or self.model)


class StreamSession:
    """One HTTP streaming session; context-managed (``__exit__`` flushes).

    One keep-alive connection carries every push (connection churn off
    the hot path). ``intervals`` accumulates everything finalized so far.
    """

    def __init__(self, client: SegmaClient, session_id: str) -> None:
        self.client = client
        self.session_id = session_id
        self.intervals: list[Interval] = []
        self._closed = False
        self._conn = HTTPConnection(
            client.host, client.port, timeout=client.timeout_s
        )

    def push(self, samples: np.ndarray) -> list[Interval]:
        """Feed more samples; returns newly finalized intervals."""
        payload = self.client._request(
            "POST",
            f"/v1/stream/{self.session_id}/push",
            _to_pcm16(samples),
            SegmaClient.L16,
            conn=self._conn,
        )
        out = _intervals(payload)
        self.intervals.extend(out)
        return out

    def flush(self) -> list[Interval]:
        """Process the tail, close open runs, end the session."""
        if self._closed:
            return []
        self._closed = True
        try:
            payload = self.client._request(
                "POST",
                f"/v1/stream/{self.session_id}/flush",
                conn=self._conn,
            )
        finally:
            self._conn.close()
        out = _intervals(payload)
        self.intervals.extend(out)
        return out

    def __enter__(self) -> "StreamSession":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.flush()
        else:  # don't mask the caller's exception with a flush failure
            self._closed = True
            self._conn.close()


class WSStreamSession:
    """One WebSocket streaming session (GET /v1/stream/ws upgrade)."""

    def __init__(self, client: SegmaClient, model: str | None) -> None:
        from base64 import b64encode
        from os import urandom

        from segma_tpu_torch import ws

        self._ws = ws
        self.intervals: list[Interval] = []
        self._closed = False
        path = "/v1/stream/ws"
        if model:
            path += f"?{urlencode({'model': model})}"
        key = b64encode(urandom(16)).decode()
        self._sock = socket.create_connection(
            (client.host, client.port), timeout=client.timeout_s
        )
        self._f = self._sock.makefile("rwb")
        self._f.write(
            f"GET {path} HTTP/1.1\r\n"
            f"Host: {client.host}:{client.port}\r\n"
            "Upgrade: websocket\r\nConnection: Upgrade\r\n"
            f"Sec-WebSocket-Key: {key}\r\n"
            "Sec-WebSocket-Version: 13\r\n\r\n".encode()
        )
        self._f.flush()
        status = self._f.readline()
        headers: dict[bytes, bytes] = {}
        while True:
            line = self._f.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            k, _, v = line.partition(b":")
            headers[k.strip().lower()] = v.strip()
        if b" 101 " not in status:
            # the server answered with a plain HTTP error (404/400/429)
            body = self._f.read(int(headers.get(b"content-length", 0)))
            self._sock.close()
            try:
                message = json.loads(body)["error"]
            except Exception:  # noqa: BLE001 — non-JSON error body
                message = body.decode(errors="replace")[:200]
            code = int(status.split()[1]) if len(status.split()) > 1 else 500
            raise SegmaClientError(code, message)
        expect = ws.accept_key(key).encode()
        if headers.get(b"sec-websocket-accept") != expect:
            self._sock.close()
            raise SegmaClientError(101, "bad Sec-WebSocket-Accept from server")

    @staticmethod
    def _close_error(payload: bytes) -> SegmaClientError:
        import struct

        code = (
            struct.unpack("!H", payload[:2])[0] if len(payload) >= 2 else 1005
        )
        message = payload[2:].decode(errors="replace") or "server closed"
        return SegmaClientError(code, message)

    def push(self, samples: np.ndarray) -> list[Interval]:
        ws = self._ws
        self._f.write(ws.mask_frame(ws.OP_BINARY, _to_pcm16(samples)))
        self._f.flush()
        op, payload = ws.read_frame(self._f, require_mask=False)
        if op == ws.OP_CLOSE:
            self._closed = True
            self._sock.close()
            raise self._close_error(payload)
        out = _intervals(payload)
        self.intervals.extend(out)
        return out

    def flush(self) -> list[Interval]:
        if self._closed:
            return []
        self._closed = True
        ws = self._ws
        out: list[Interval] = []
        try:
            self._f.write(ws.mask_frame(ws.OP_TEXT, b"flush"))
            self._f.flush()
            op, payload = ws.read_frame(self._f, require_mask=False)
            if op == ws.OP_TEXT:
                out = _intervals(payload)
                # the close frame follows the final intervals
                self._ws.read_frame(self._f, require_mask=False)
            # op == OP_CLOSE: session already gone (evicted/raced) — the
            # close IS the reply; nothing more to read
        finally:
            self._sock.close()
        self.intervals.extend(out)
        return out

    def __enter__(self) -> "WSStreamSession":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.flush()
        else:
            self._closed = True
            self._sock.close()


def iter_wav_chunks(
    path: Path | str, chunk_s: float = 0.5, sample_rate: int = 16_000
) -> Iterator[np.ndarray]:
    """Yield a WAV file as push-sized int16 chunks (simulates a live
    source for the streaming examples/benchmarks)."""
    from segma_tpu_torch.inference import _load_mono

    pcm = _load_mono(Path(path), "int16", expect_sr=sample_rate)
    step = int(chunk_s * sample_rate)
    for i in range(0, len(pcm), step):
        yield pcm[i : i + step]
