"""WebSocket streaming-ASR server over StreamingTranscriber, stdlib only (own
copy of ``audax/cli/stream_server.py``).

The reference's UI was a record-then-transcribe Streamlit page
(AB/UI/Asmo.py); this is the live counterpart: clients hold a WebSocket,
push raw PCM as binary frames, and receive finalized segments as JSON text
frames while audio is still arriving. The WebSocket layer (RFC 6455
handshake + frame codec) is first-party — no external server framework —
as in the JAX package.

Protocol (per connection):
  * connect  GET /ws?stream=<id>   (id defaults to a per-connection name)
  * client -> server  binary frames: float32 little-endian PCM @ 16 kHz
  * client -> server  text "flush": emit the trailing partial window
  * server -> client  text frames: {"stream", "index", "text",
                                    "audio_seconds"} per finalized chunk
  * ping/pong and close handled per RFC 6455.

One shared StreamingTranscriber batches chunks across ALL connections
(fixed-slot device batches, infer/streaming.py), so N clients share one
device batch.
"""

from __future__ import annotations

import base64
import hashlib
import json
import socket
import socketserver
import struct
import threading
from typing import Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np

from audax_torch.core.logging import get_logger

log = get_logger("audax_torch.stream_server")

__all__ = ["serve_streaming", "ws_handshake_accept", "read_frame",
           "write_frame"]

_WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
OP_TEXT, OP_BINARY, OP_CLOSE, OP_PING, OP_PONG = 0x1, 0x2, 0x8, 0x9, 0xA


def ws_handshake_accept(key: str) -> str:
    digest = hashlib.sha1((key + _WS_GUID).encode()).digest()
    return base64.b64encode(digest).decode()


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        part = sock.recv(n - len(buf))
        if not part:
            raise ConnectionError("socket closed mid-frame")
        buf += part
    return buf


def read_frame(sock: socket.socket, on_control=None) -> Tuple[int, bytes]:
    """Read one complete MESSAGE (merging continuation fragments).

    Control frames (opcode >= 8) may legally arrive BETWEEN fragments of a
    data message (RFC 6455 §5.4); they are dispatched to ``on_control``
    immediately (never merged into the data payload). Without a handler, a
    control frame is returned directly when no data fragments are pending,
    and answered inline is the caller's job.
    """
    opcode = None
    payload = b""
    while True:
        b0, b1 = _recv_exact(sock, 2)
        fin = b0 & 0x80
        op = b0 & 0x0F
        masked = b1 & 0x80
        length = b1 & 0x7F
        if length == 126:
            (length,) = struct.unpack(">H", _recv_exact(sock, 2))
        elif length == 127:
            (length,) = struct.unpack(">Q", _recv_exact(sock, 8))
        mask = _recv_exact(sock, 4) if masked else b""
        data = _recv_exact(sock, length) if length else b""
        if masked and data:
            # vectorized unmask: the per-byte Python loop costs ~64k
            # iterations per 1 s PCM frame per client on the hot path
            arr = np.frombuffer(data, np.uint8)
            mk = np.frombuffer((mask * (len(data) // 4 + 1))[: len(data)],
                               np.uint8)
            data = (arr ^ mk).tobytes()
        if op >= OP_CLOSE:                       # control frame
            if on_control is not None:
                on_control(op, data)
                if op == OP_CLOSE:
                    return op, data              # connection is ending
                continue                         # keep reading the message
            if opcode is None:
                return op, data
            continue                             # no handler: drop mid-msg
        if op != 0:                              # first fragment's opcode
            opcode = op
        payload += data
        if fin:
            return opcode or 0, payload


def write_frame(sock: socket.socket, opcode: int, payload: bytes) -> None:
    header = bytes([0x80 | opcode])
    n = len(payload)
    if n < 126:
        header += bytes([n])
    elif n < (1 << 16):
        header += bytes([126]) + struct.pack(">H", n)
    else:
        header += bytes([127]) + struct.pack(">Q", n)
    sock.sendall(header + payload)


class _Hub:
    """Shared transcriber + per-stream connection registry + one lock.

    The hub lock guards the transcriber and the registry ONLY — socket
    sends happen outside it under per-connection locks, so one stalled
    client's full TCP buffer cannot freeze every other connection."""

    def __init__(self, transcriber):
        self.st = transcriber
        self.lock = threading.Lock()
        #: stream_id -> (socket, per-connection send lock)
        self.conns: Dict[str, Tuple[socket.socket, threading.Lock]] = {}

    def pump(self) -> None:
        """Run device steps for all pending chunks, dispatch segments."""
        with self.lock:
            segments = self.st.drain()
            targets = [(seg, self.conns.get(seg.stream_id))
                       for seg in segments]
        for seg, conn in targets:
            if conn is None:
                continue
            sock, send_lock = conn
            try:
                with send_lock:
                    write_frame(sock, OP_TEXT, json.dumps({
                        "stream": seg.stream_id, "index": seg.index,
                        "text": seg.text,
                        "audio_seconds": seg.audio_seconds,
                    }).encode())
            except OSError:
                with self.lock:
                    if self.conns.get(seg.stream_id, (None,))[0] is sock:
                        self.conns.pop(seg.stream_id, None)


class _Handler(socketserver.BaseRequestHandler):
    def handle(self) -> None:  # noqa: C901 - protocol state machine
        sock = self.request
        hub: _Hub = self.server.hub                     # type: ignore
        # --- HTTP upgrade handshake ---
        data = b""
        while b"\r\n\r\n" not in data:
            part = sock.recv(4096)
            if not part:
                return
            data += part
        head = data.split(b"\r\n\r\n", 1)[0].decode("latin-1")
        lines = head.split("\r\n")
        path = lines[0].split(" ")[1] if " " in lines[0] else "/"
        headers = {}
        for line in lines[1:]:
            if ":" in line:
                k, v = line.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        key = headers.get("sec-websocket-key")
        if not key or "websocket" not in headers.get("upgrade", "").lower():
            sock.sendall(b"HTTP/1.1 400 Bad Request\r\n\r\n")
            return
        sock.sendall((
            "HTTP/1.1 101 Switching Protocols\r\n"
            "Upgrade: websocket\r\nConnection: Upgrade\r\n"
            f"Sec-WebSocket-Accept: {ws_handshake_accept(key)}\r\n\r\n"
        ).encode())

        qs = parse_qs(urlparse(path).query)
        stream_id = qs.get("stream", [f"conn-{self.client_address[1]}"])[0]
        send_lock = threading.Lock()
        # a finite socket timeout bounds BOTH a stalled recv and a sendall
        # into a full client TCP buffer (a 0-timeout stall would otherwise
        # hang this handler forever)
        sock.settimeout(300.0)
        with hub.lock:
            hub.conns[stream_id] = (sock, send_lock)
        log.info("stream %s connected", stream_id)
        closing = False
        leftover = bytearray()       # partial float32 across binary frames

        def on_control(op, data):
            nonlocal closing
            with send_lock:             # sends serialize with pump()
                if op == OP_PING:
                    write_frame(sock, OP_PONG, data)
                elif op == OP_CLOSE:
                    write_frame(sock, OP_CLOSE, data[:2])
                    closing = True

        try:
            while not closing:
                opcode, payload = read_frame(sock, on_control)
                if opcode == OP_CLOSE or closing:
                    break
                if opcode == OP_BINARY:
                    # buffer byte-level: a float32 split across two WS
                    # MESSAGES must not kill the session
                    leftover += payload
                    n = (len(leftover) // 4) * 4
                    if n:
                        samples = np.frombuffer(bytes(leftover[:n]),
                                                dtype="<f4")
                        del leftover[:n]
                        with hub.lock:
                            hub.st.feed(stream_id, samples)
                elif opcode == OP_TEXT and payload == b"flush":
                    with hub.lock:
                        hub.st.flush(stream_id)
                hub.pump()
        except (ConnectionError, OSError):
            pass
        finally:
            with hub.lock:
                # pop/evict only if WE are still the registered connection:
                # a reconnect with the same stream id must not have its
                # fresh state clobbered by the stale handler's cleanup
                if hub.conns.get(stream_id, (None,))[0] is sock:
                    hub.conns.pop(stream_id, None)
                    # evict the ring buffer + queued chunks: nothing else
                    # removes them, and a long-running server would pin one
                    # window-sized float32 buffer per past connection
                    hub.st.remove(stream_id)
            log.info("stream %s disconnected", stream_id)


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


def serve_streaming(transcriber, *, host: str = "127.0.0.1",
                    port: int = 8765) -> _Server:
    """Create (not start) the WebSocket server; call ``serve_forever()`` on
    the result, or drive it from a thread (tests do)."""
    server = _Server((host, port), _Handler)
    server.hub = _Hub(transcriber)                      # type: ignore
    return server
