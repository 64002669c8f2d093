"""Websocket request/response protocol for talking to the SC2 binary.

Counterpart of ``distar_tpu.envs.sc2.protocol``.

Role parity with the reference StarcraftProtocol (reference: distar/pysc2/
lib/protocol.py:72-192): synchronous write-request/read-response over one
websocket, status tracking from every response, request-id counting,
connection/protocol error taxonomy, optional packet logging.

The socket is duck-typed (``send(bytes)``/``recv() -> bytes``/``close()``),
so both a real ``websocket-client`` connection and an in-process test
transport satisfy it.
"""
from __future__ import annotations

import itertools
import logging
import os
import socket as _socket
import sys
import time
from typing import Optional

from .proto import Status, sc_pb

# set DISTAR_SC2_VERBOSE_PROTOCOL=N to print N lines per packet (-1 = all),
# the role of the reference's --sc2_verbose_protocol absl flag
VERBOSE = int(os.environ.get("DISTAR_SC2_VERBOSE_PROTOCOL", "0"))
MAX_WIDTH = int(os.environ.get("COLUMNS", 200))


class ConnectionError(Exception):  # noqa: A001 - mirrors the reference name
    """Failed to read/write a message, details in the error string."""


class ProtocolError(Exception):
    """SC2 responded with an error message likely due to a bad request or bug."""


def _translate_socket_errors(fn):
    def wrapped(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except ConnectionError:
            raise
        except _socket.error as e:
            raise ConnectionError(f"Socket error: {e}")
        except Exception as e:  # websocket-client exception classes
            name = type(e).__name__
            if "ConnectionClosed" in name:
                raise ConnectionError(
                    "Connection already closed. SC2 probably crashed. "
                    "Check the error log."
                )
            if "Timeout" in name:
                raise ConnectionError("Websocket timed out.")
            raise

    return wrapped


class StarcraftProtocol:
    """Synchronous request/response protocol over one websocket."""

    def __init__(self, sock):
        self._status = Status.launched
        self._sock = sock
        self._count = itertools.count(1)

    @property
    def status(self) -> Status:
        return self._status

    def close(self) -> None:
        if self._sock:
            try:
                self._sock.close()
            except Exception:
                pass
            self._sock = None
        self._status = Status.quit

    def read(self):
        """Read a Response, validate, track status (reference :92-113)."""
        if VERBOSE:
            self._log("-------------- Reading response --------------")
            start = time.time()
        response = self._read()
        if VERBOSE:
            self._log(
                f"-------------- Read {response.WhichOneof('response')} in "
                f"{1000 * (time.time() - start):.1f} msec --------------\n"
                f"{self._packet_str(response)}"
            )
        if not response.HasField("status"):
            raise ProtocolError("Got an incomplete response without a status.")
        prev_status = self._status
        self._status = Status(response.status)
        if response.error:
            err = (
                "Error in RPC response (likely a bug). "
                f"Prev status: {prev_status}, new status: {self._status}, error:\n"
                + "\n".join(response.error)
            )
            logging.error(err)
            raise ProtocolError(err)
        return response

    def write(self, request) -> None:
        if VERBOSE:
            self._log(
                f"-------------- Writing request: {request.WhichOneof('request')} "
                f"--------------\n{self._packet_str(request)}"
            )
        self._write(request)

    def send_req(self, request):
        self.write(request)
        return self.read()

    def send(self, **kwargs):
        """Build a Request from a single kwarg, send it, return the matching
        sub-response (reference :129-153)."""
        assert len(kwargs) == 1, "Must make a single request."
        name = next(iter(kwargs))
        req = sc_pb.Request(**kwargs)
        req.id = next(self._count)
        try:
            res = self.send_req(req)
        except ConnectionError as e:
            raise ConnectionError(f"Error during {name}: {e}")
        if res.HasField("id") and res.id != req.id:
            raise ConnectionError(
                f"Error during {name}: Got a response with a different id"
            )
        return getattr(res, name)

    # ------------------------------------------------------------- internals
    def _packet_str(self, packet) -> str:
        packet_str = str(packet).strip()
        if VERBOSE <= 0:
            return packet_str
        lines = packet_str.split("\n")
        count = len(lines)
        lines = [line[:MAX_WIDTH] for line in lines[: VERBOSE + 1]]
        if count > VERBOSE + 1:
            lines[-1] = f"***** {count - VERBOSE} lines skipped *****"
        return "\n".join(lines)

    def _log(self, s: str) -> None:
        sys.stderr.write(s + "\n")
        sys.stderr.flush()

    @_translate_socket_errors
    def _read(self):
        response_str = self._sock.recv()
        if not response_str:
            raise ProtocolError("Got an empty response from SC2.")
        return sc_pb.Response.FromString(response_str)

    @_translate_socket_errors
    def _write(self, request) -> None:
        self._sock.send(request.SerializeToString())
