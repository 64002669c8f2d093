"""portpicker shim: the real package when installed, stdlib fallback else.

Counterpart of ``distar_tpu.envs.sc2.portpicker_compat``.

The image this repo targets does not ship ``portpicker``; its hard import
made every sc2 client/launcher module (and the replay-decoder tests relying
on them) fail to import. The fallback picks a free port by binding port 0 —
the same OS mechanism portpicker uses, minus its cross-process reservation
bookkeeping, which the single-host launch paths here don't depend on.
"""
from __future__ import annotations

import socket

try:  # pragma: no cover - depends on optional dep
    from portpicker import pick_unused_port, return_port
except ImportError:

    def pick_unused_port() -> int:
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    def return_port(port: int) -> None:
        return None
