"""Coordinator-backed service discovery: register, keep the lease, read.

Counterpart of ``distar_tpu.comm.discovery``. A service process registers
its endpoint under a token with a lease and keeps it alive from a daemon
thread, registering again when the broker answers a heartbeat with False
(it lost the records across a restart); consumers read the live fleet
back with the non-consuming ``peers`` route. Lease-expired endpoints are
evicted broker-side, so a fresh read never holds a process that stopped
heartbeating. ``serve.fleet.discovery.register_gateway`` (token
``serve_gateway``) wraps this module.

After such a re-registration the keep-alive also asks every telemetry
shipper of the process to resend its whole snapshot
(``obs.shipper.request_resync_all``), so the restarted broker does not show
the source stale until the next ship. A coordinator address list (the HA
client) is ROADMAP Queue 1 item 11 and raises in ``coordinator_request``.
"""
from __future__ import annotations

import threading
from typing import List, Optional, Tuple


def _norm_addr(coordinator_addr) -> Tuple[str, Optional[int]]:
    """``(host, port)``, ``"host:port"`` or an address list
    (``"h1:p1,h2:p2"``) -> the pair ``coordinator_request`` takes
    (``port=None`` marks the list)."""
    if isinstance(coordinator_addr, str):
        if "," in coordinator_addr:
            return coordinator_addr, None
        host, _, port = coordinator_addr.rpartition(":")
        return host or "127.0.0.1", int(port)
    host, port = coordinator_addr
    if port is None or (isinstance(host, str) and "," in host):
        return str(host), None
    return host, int(port)


def register_endpoint(coordinator_addr: Tuple[str, int], token: str, host: str, port: int,
                      meta: Optional[dict] = None, lease_s: Optional[float] = None,
                      heartbeat_interval_s: Optional[float] = None,
                      stop_event: Optional[threading.Event] = None) -> threading.Thread:
    """Register ``host:port`` under ``token`` and keep its lease alive from
    a daemon thread. The first register is synchronous and raises on
    failure (a member that cannot reach its broker fails at start-up, not
    silently undiscovered); later heartbeats never raise. Returns the
    started thread; set its ``stop_event`` to end the keep-alive."""
    from .coordinator import coordinator_request

    chost, cport = _norm_addr(coordinator_addr)
    body = {"token": token, "ip": host, "port": port, "meta": meta or {}}
    if lease_s:
        body["lease_s"] = lease_s
    coordinator_request(chost, cport, "register", body)
    interval = heartbeat_interval_s or (max(1.0, lease_s / 3.0) if lease_s else 10.0)
    stop = stop_event or threading.Event()

    def beat():
        while not stop.wait(interval):
            try:
                hb = {"ip": host, "port": port}
                if lease_s:
                    hb["lease_s"] = lease_s
                alive = coordinator_request(chost, cport, "heartbeat", hb)
                if not (alive or {}).get("info", False):
                    # the broker lost our records (restart): register again,
                    # and nudge this process's telemetry shippers to re-ship
                    # their full snapshot
                    coordinator_request(chost, cport, "register", body)
                    from ..obs.shipper import request_resync_all

                    request_resync_all("heartbeat")
            except Exception:  # noqa: BLE001 - a keep-alive must never crash its process
                continue

    t = threading.Thread(target=beat, name=f"{token}-heartbeat", daemon=True)
    t.stop_event = stop  # type: ignore[attr-defined]
    t.start()
    return t


def unregister_endpoint(coordinator_addr: Tuple[str, int], host: str, port: int) -> int:
    """Graceful departure: drop this endpoint from the broker now instead
    of when its lease lapses, the first step of every drain. Returns the
    number of records removed; raises ``CommError`` on an unreachable
    broker (drains treat that as best-effort: the lease still lapses)."""
    from .coordinator import coordinator_request

    chost, cport = _norm_addr(coordinator_addr)
    reply = coordinator_request(chost, cport, "unregister", {"ip": host, "port": port})
    return int(reply.get("info") or 0)


def start_refresh(coordinator_addr: Tuple[str, int], token: str, apply_fn, interval_s: float = 5.0,
                  stop_event: Optional[threading.Event] = None) -> threading.Thread:
    """Live membership, client side: every ``interval_s`` re-read the fleet
    under ``token`` and hand the records to ``apply_fn(records)``, so joins
    and drains reach a long-lived client without a restart. A failed read
    keeps the previous view and ``apply_fn``'s exceptions are swallowed: a
    refresher never takes its client down. Returns the daemon thread; set
    its ``stop_event`` to end it."""
    stop = stop_event or threading.Event()

    def loop():
        while not stop.wait(interval_s):
            try:
                apply_fn(discover_endpoints(coordinator_addr, token))
            except Exception:  # noqa: BLE001 - keep serving on a stale view
                continue

    t = threading.Thread(target=loop, name=f"{token}-refresh", daemon=True)
    t.stop_event = stop  # type: ignore[attr-defined]
    t.start()
    return t


def discover_endpoints(coordinator_addr: Tuple[str, int], token: str) -> List[dict]:
    """The live fleet under ``token``: the coordinator's ``peers`` read.
    Returns the raw records (``{"ip", "port", "meta", "ts"}``), possibly
    none; the caller decides whether an empty fleet is an error."""
    from .coordinator import coordinator_request

    host, port = _norm_addr(coordinator_addr)
    reply = coordinator_request(host, port, "peers", {"token": token})
    return list(reply.get("info") or [])
