"""Networking: message framing protocol + connection pool.

Parity target: the Rust ``networking`` crate — app-level message framing
with serde + a connection pool for telemetry/updates (reference:
src/networking/src/lib.rs:13-21, protocol.rs, connection_pool.rs). Not a
collective-comms layer (the reference has none either — SURVEY.md
section 2.10); device-to-device traffic would ride torch.distributed.

Frame format: magic u16 | version u8 | kind u8 | length u32 | payload —
payload is JSON for control frames, raw bytes for blobs.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
from typing import Any, Dict, List, Optional, Tuple

from trackiellm_tpu_torch.utils.errors import ErrorCode, TrackieError

MAGIC = 0x544B  # "TK"
VERSION = 1
HEADER = struct.Struct("<HBBI")
MAX_FRAME = 16 * (1 << 20)

KIND_JSON = 0
KIND_BLOB = 1
KIND_PING = 2
KIND_PONG = 3


def encode_frame(payload: Any, kind: int = KIND_JSON) -> bytes:
    if kind == KIND_JSON:
        body = json.dumps(payload, separators=(",", ":")).encode()
    else:
        body = bytes(payload)
    if len(body) > MAX_FRAME:
        raise TrackieError(ErrorCode.INVALID_ARGUMENT, "frame too large")
    return HEADER.pack(MAGIC, VERSION, kind, len(body)) + body


class FrameDecoder:
    """Incremental decoder: feed bytes, pop complete frames."""

    def __init__(self):
        self._buf = bytearray()

    def feed(self, data: bytes) -> List[Tuple[int, Any]]:
        self._buf.extend(data)
        frames: List[Tuple[int, Any]] = []
        while len(self._buf) >= HEADER.size:
            magic, version, kind, length = HEADER.unpack(
                self._buf[:HEADER.size])
            if magic != MAGIC or version != VERSION:
                raise TrackieError(ErrorCode.FFI_ERROR,
                                   f"bad frame header {magic:#x}/{version}")
            if length > MAX_FRAME:
                raise TrackieError(ErrorCode.FFI_ERROR, "oversized frame")
            total = HEADER.size + length
            if len(self._buf) < total:
                break
            body = bytes(self._buf[HEADER.size:total])
            del self._buf[:total]
            if kind == KIND_JSON:
                frames.append((kind, json.loads(body or b"null")))
            else:
                frames.append((kind, body))
        return frames


class PooledConnection:
    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.decoder = FrameDecoder()

    def send(self, payload: Any, kind: int = KIND_JSON) -> None:
        self.sock.sendall(encode_frame(payload, kind))

    def recv_frame(self, timeout: float = 5.0) -> Optional[Tuple[int, Any]]:
        self.sock.settimeout(timeout)
        while True:
            frames = self.decoder.feed(b"")
            if frames:
                return frames[0]
            try:
                data = self.sock.recv(65536)
            except socket.timeout:
                return None
            if not data:
                return None
            frames = self.decoder.feed(data)
            if frames:
                return frames[0]

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class ConnectionPool:
    """Keyed connection reuse with a per-host cap (parity:
    connection_pool.rs)."""

    def __init__(self, max_per_host: int = 2, connect_timeout: float = 3.0):
        self.max_per_host = max_per_host
        self.connect_timeout = connect_timeout
        self._idle: Dict[Tuple[str, int], List[PooledConnection]] = {}
        self._lock = threading.Lock()
        self.created = 0

    def acquire(self, host: str, port: int) -> PooledConnection:
        key = (host, port)
        with self._lock:
            pool = self._idle.get(key, [])
            if pool:
                return pool.pop()
        sock = socket.create_connection((host, port),
                                        timeout=self.connect_timeout)
        self.created += 1
        return PooledConnection(sock)

    def release(self, host: str, port: int, conn: PooledConnection) -> None:
        key = (host, port)
        with self._lock:
            pool = self._idle.setdefault(key, [])
            if len(pool) < self.max_per_host:
                pool.append(conn)
                return
        conn.close()

    def close_all(self) -> None:
        with self._lock:
            for pool in self._idle.values():
                for conn in pool:
                    conn.close()
            self._idle.clear()
