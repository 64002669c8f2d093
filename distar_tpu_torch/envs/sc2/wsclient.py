"""A blocking RFC 6455 websocket client over the standard library.

The SC2 binary serves its API at ``ws://host:port/sc2api``. The JAX
package dials it with the ``websocket-client`` package; the port carries
this client instead, so the SC2 stack needs no package beyond protobuf.
It keeps the distinctions ``RemoteController._connect`` draws:

- a refused or reset TCP dial raises ``OSError`` (dial again);
- an HTTP answer other than 101 raises ``WebSocketBadStatusException``
  with its ``status_code`` (a booting binary answers 404: dial again);
- a server that closes the connection before it answers the handshake
  raises ``WebSocketConnectionClosedException`` (another controller owns
  the endpoint).

After the handshake, ``send(bytes)`` writes one masked binary frame and
``recv() -> bytes`` reads one message (fragments joined, pings answered).
A close frame reads as ``b""``, as websocket-client's ``recv`` returns an
empty string; a connection dropped without one raises
``WebSocketConnectionClosedException``, and a read past the timeout
``WebSocketTimeoutException``. ``protocol.StarcraftProtocol`` maps both
onto its ``ConnectionError`` by those class names.
"""
from __future__ import annotations

import base64
import hashlib
import os
import socket
import struct
from typing import Optional
from urllib.parse import urlsplit

_WS_MAGIC = b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
_OP_CONT, _OP_TEXT, _OP_BINARY, _OP_CLOSE, _OP_PING, _OP_PONG = 0, 1, 2, 8, 9, 10
_MAX_HEADER_BYTES = 65536


class WebSocketException(Exception):
    pass


class WebSocketBadStatusException(WebSocketException):
    def __init__(self, message: str, status_code: int):
        super().__init__(message)
        self.status_code = status_code


class WebSocketConnectionClosedException(WebSocketException):
    pass


class WebSocketTimeoutException(WebSocketException):
    pass


def _mask(payload: bytes, key: bytes) -> bytes:
    n = len(payload)
    if not n:
        return b""
    stream = (key * (n // 4 + 1))[:n]
    return (int.from_bytes(payload, "big") ^ int.from_bytes(stream, "big")).to_bytes(n, "big")


class WebSocket:
    """One client connection; build it with ``create_connection``."""

    def __init__(self, sock: socket.socket, buffered: bytes = b""):
        self._sock = sock
        self._buf = buffered
        self.connected = True

    # ------------------------------------------------------------ reading
    def _fill(self, n: int) -> bytes:
        while len(self._buf) < n:
            try:
                chunk = self._sock.recv(max(65536, n - len(self._buf)))
            except socket.timeout as e:
                raise WebSocketTimeoutException(str(e) or "timed out") from e
            if not chunk:
                self.connected = False
                raise WebSocketConnectionClosedException(
                    "Connection to remote host was lost.")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def _read_frame(self):
        b1, b2 = self._fill(2)
        length = b2 & 0x7F
        if length == 126:
            (length,) = struct.unpack(">H", self._fill(2))
        elif length == 127:
            (length,) = struct.unpack(">Q", self._fill(8))
        key = self._fill(4) if b2 & 0x80 else b""
        payload = self._fill(length)
        if key:
            payload = _mask(payload, key)
        return bool(b1 & 0x80), b1 & 0x0F, payload

    def recv(self) -> bytes:
        parts = []
        while True:
            fin, opcode, payload = self._read_frame()
            if opcode == _OP_PING:
                self._send_frame(_OP_PONG, payload)
                continue
            if opcode == _OP_PONG:
                continue
            if opcode == _OP_CLOSE:
                try:
                    self._send_frame(_OP_CLOSE, payload[:2])
                except OSError:
                    pass
                self.connected = False
                return b""
            if opcode in (_OP_TEXT, _OP_BINARY, _OP_CONT):
                parts.append(payload)
                if fin:
                    return b"".join(parts)

    # ------------------------------------------------------------ writing
    def _send_frame(self, opcode: int, payload: bytes) -> None:
        n = len(payload)
        header = bytes([0x80 | opcode])
        if n < 126:
            header += bytes([0x80 | n])
        elif n < 2 ** 16:
            header += bytes([0x80 | 126]) + struct.pack(">H", n)
        else:
            header += bytes([0x80 | 127]) + struct.pack(">Q", n)
        key = os.urandom(4)
        try:
            self._sock.sendall(header + key + _mask(payload, key))
        except socket.timeout as e:
            raise WebSocketTimeoutException(str(e) or "timed out") from e

    def send(self, payload: bytes) -> None:
        if not self.connected:
            raise WebSocketConnectionClosedException("socket is already closed.")
        self._send_frame(_OP_BINARY, bytes(payload))

    def close(self) -> None:
        if self._sock is None:
            return
        if self.connected:
            try:
                self._send_frame(_OP_CLOSE, struct.pack(">H", 1000))
            except OSError:
                pass
        self.connected = False
        try:
            self._sock.close()
        except OSError:
            pass
        self._sock = None


def _read_response_head(sock: socket.socket) -> "tuple[bytes, bytes]":
    data = b""
    while b"\r\n\r\n" not in data:
        if len(data) > _MAX_HEADER_BYTES:
            raise WebSocketException("handshake response headers too long")
        try:
            chunk = sock.recv(4096)
        except socket.timeout as e:
            raise WebSocketTimeoutException(str(e) or "timed out") from e
        if not chunk:
            raise WebSocketConnectionClosedException(
                "Connection to remote host was lost.")
        data += chunk
    head, _, rest = data.partition(b"\r\n\r\n")
    return head, rest


def create_connection(url: str, timeout: Optional[float] = None) -> WebSocket:
    """Dial ``url`` (``ws://host:port/path``) and run the opening handshake."""
    parts = urlsplit(url)
    if parts.scheme != "ws":
        raise ValueError(f"only ws:// URLs are supported, got {url!r}")
    host = parts.hostname
    port = parts.port or 80
    path = (parts.path or "/") + (f"?{parts.query}" if parts.query else "")
    sock = socket.create_connection((host, port), timeout=timeout)
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        key = base64.b64encode(os.urandom(16)).decode("ascii")
        host_header = f"[{host}]" if ":" in host else host
        request = (
            f"GET {path} HTTP/1.1\r\n"
            f"Host: {host_header}:{port}\r\n"
            "Upgrade: websocket\r\n"
            "Connection: Upgrade\r\n"
            f"Sec-WebSocket-Key: {key}\r\n"
            "Sec-WebSocket-Version: 13\r\n\r\n"
        )
        sock.sendall(request.encode("latin-1"))
        head, rest = _read_response_head(sock)
        lines = head.decode("latin-1").split("\r\n")
        status_fields = lines[0].split(" ", 2)
        try:
            status = int(status_fields[1])
        except (IndexError, ValueError):
            raise WebSocketException(f"malformed handshake status line: {lines[0]!r}")
        if status != 101:
            raise WebSocketBadStatusException(
                f"Handshake status {status} {status_fields[2] if len(status_fields) > 2 else ''}",
                status,
            )
        headers = {}
        for line in lines[1:]:
            name, _, value = line.partition(":")
            headers[name.strip().lower()] = value.strip()
        expected = base64.b64encode(
            hashlib.sha1(key.encode("ascii") + _WS_MAGIC).digest()).decode("ascii")
        if headers.get("sec-websocket-accept") != expected:
            raise WebSocketException("handshake answered with a wrong Sec-WebSocket-Accept")
    except BaseException:
        sock.close()
        raise
    return WebSocket(sock, rest)
