"""Minimal RFC 6455 WebSocket framing for the streaming endpoint (a copy of
``segma_tpu/ws.py``; the stdlib and numpy).

Dependency-free (the environment ships no websocket library): just the
server side of the protocol — handshake accept key, frame decode (client
frames are masked), frame encode (server frames are not). Used by
``segma_tpu_torch.serve`` for ``GET /v1/stream/ws``; per-push overhead drops from
a full HTTP request/response (headers, connection churn) to one 2-14 byte
frame header each way.

Only what the streaming endpoint needs is implemented: single-frame
messages up to ``MAX_FRAME_BYTES`` (64 MiB — a hostile length claim must
not make the server buffer it), opcodes text/binary/close/ping/pong, no
extensions, no fragmentation (a fragmented client frame raises — pushes
are far below frame-size limits).
"""

from __future__ import annotations

import hashlib
import struct
from base64 import b64encode
from typing import Any

GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

# A client frame header can claim up to 2**63-1 payload bytes; accepting
# the claim verbatim would make the server buffer (and allocate) whatever a
# hostile peer writes. Streaming pushes are ~32 KB (500 ms of PCM16); 64 MiB
# leaves three orders of magnitude of headroom while bounding memory.
MAX_FRAME_BYTES = 1 << 26

# opcodes (RFC 6455 §5.2)
OP_CONT = 0x0
OP_TEXT = 0x1
OP_BINARY = 0x2
OP_CLOSE = 0x8
OP_PING = 0x9
OP_PONG = 0xA


class WebSocketError(ValueError):
    """Protocol violation — the connection should be closed."""


def accept_key(client_key: str) -> str:
    """Sec-WebSocket-Accept for a client's Sec-WebSocket-Key (§4.2.2)."""
    digest = hashlib.sha1((client_key.strip() + GUID).encode()).digest()
    return b64encode(digest).decode()


def encode_frame(opcode: int, payload: bytes) -> bytes:
    """One unmasked (server->client) frame, FIN set."""
    head = bytes([0x80 | (opcode & 0x0F)])
    n = len(payload)
    if n < 126:
        head += bytes([n])
    elif n < 1 << 16:
        head += bytes([126]) + struct.pack("!H", n)
    else:
        head += bytes([127]) + struct.pack("!Q", n)
    return head + payload


def read_frame(rfile: Any, require_mask: bool = True) -> tuple[int, bytes]:
    """Read one complete frame from a file-like socket stream.

    Returns (opcode, unmasked payload). ``require_mask=True`` enforces the
    server-side rule that client frames are masked (§5.1); pass False when
    reading server frames from the client side. Raises ``WebSocketError``
    on protocol violations and ``ConnectionError`` on EOF mid-frame.
    """
    head = rfile.read(2)
    if len(head) < 2:
        raise ConnectionError("websocket peer closed mid-frame")
    fin = head[0] & 0x80
    if head[0] & 0x70:
        raise WebSocketError("RSV bits set without negotiated extension")
    opcode = head[0] & 0x0F
    if not fin or opcode == OP_CONT:
        raise WebSocketError("fragmented frames are not supported")
    masked = head[1] & 0x80
    if require_mask and not masked:
        raise WebSocketError("client frames must be masked (RFC 6455 §5.1)")
    n = head[1] & 0x7F
    if n in (126, 127):
        width = 2 if n == 126 else 8
        ext = rfile.read(width)
        if len(ext) < width:
            raise ConnectionError("websocket peer closed mid-frame")
        n = struct.unpack("!H" if width == 2 else "!Q", ext)[0]
    if n > MAX_FRAME_BYTES:
        raise WebSocketError(
            f"frame payload of {n} bytes exceeds the {MAX_FRAME_BYTES} cap"
        )
    mask = rfile.read(4) if masked else b""
    payload = rfile.read(n)
    if len(payload) < n or (masked and len(mask) < 4):
        raise ConnectionError("websocket peer closed mid-frame")
    # unmask: XOR with the 4-byte mask cycled over the payload
    return opcode, (_unmask(payload, mask) if masked else payload)


def _unmask(payload: bytes, mask: bytes) -> bytes:
    if not payload:
        return b""
    # vectorized XOR (numpy) — pure-python byte loops are slow at PCM sizes
    import numpy as np

    data = np.frombuffer(payload, np.uint8)
    key = np.frombuffer((mask * (len(payload) // 4 + 1))[: len(payload)], np.uint8)
    return (data ^ key).tobytes()


def mask_frame(opcode: int, payload: bytes, mask: bytes = b"\x12\x34\x56\x78") -> bytes:
    """One masked (client->server) frame — for tests and client helpers."""
    head = bytes([0x80 | (opcode & 0x0F)])
    n = len(payload)
    if n < 126:
        head += bytes([0x80 | n])
    elif n < 1 << 16:
        head += bytes([0x80 | 126]) + struct.pack("!H", n)
    else:
        head += bytes([0x80 | 127]) + struct.pack("!Q", n)
    return head + mask + _unmask(payload, mask)  # XOR is its own inverse
