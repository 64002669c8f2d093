"""Gateway fleet discovery: ``serve_gateway`` registrations and the map.

Counterpart of ``distar_tpu.serve.fleet.discovery``. Every serving gateway
(``bin/serve.py --coordinator-addr``, or the mock ``fleet.gateway_proc``)
registers its framed-TCP data-plane address with the coordinator under
the ``serve_gateway`` token, with a meta block the rest of the fleet plans
against:

  players    list of player ids this gateway serves (one entry for a
             single-model gateway, several behind a ``GatewayMux``)
  slots      engine batch lanes = max live sessions
  http_port  the HTTP/JSON frontend (``/serve/status``)
  version    boot model version name (the live generation is in status)

The TCP address is the gateway's identity: a restarted gateway on the same
address keeps its ring segment, so routing finds sessions where they were
pinned. Liveness is the lease: a gateway that stops heartbeating is
evicted broker-side and drops out of freshly discovered maps.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

#: coordinator token serving gateways register under
GATEWAY_TOKEN = "serve_gateway"


def register_gateway(coordinator_addr: Tuple[str, int], host: str, port: int,
                     meta: Optional[dict] = None, lease_s: Optional[float] = None,
                     heartbeat_interval_s: Optional[float] = None,
                     stop_event: Optional[threading.Event] = None,
                     target=None) -> threading.Thread:
    """Register one gateway's TCP data-plane endpoint under
    ``GATEWAY_TOKEN`` and keep its lease alive (``comm.discovery``).
    Returns the heartbeat thread; its ``stop_event`` ends the keep-alive.

    The thread's ``deregister()`` leaves the fleet: it stops the keep-alive
    and unregisters the endpoint, once however often it is called, and
    never raises (an unreachable coordinator lets the lease lapse instead).
    With ``target`` (a gateway or a mux) it becomes ``target.deregister``,
    the hook ``begin_drain`` calls first, so a draining gateway leaves
    discovery before it sheds instead of a lease later."""
    from ...comm.discovery import register_endpoint, unregister_endpoint

    beat = register_endpoint(
        coordinator_addr, GATEWAY_TOKEN, host, port, meta=meta, lease_s=lease_s,
        heartbeat_interval_s=heartbeat_interval_s, stop_event=stop_event,
    )
    once = threading.Lock()

    def deregister() -> None:
        if not once.acquire(blocking=False):
            return
        beat.stop_event.set()
        try:
            unregister_endpoint(coordinator_addr, host, port)
        except Exception:  # noqa: BLE001 - best effort; the lease still lapses
            pass

    beat.deregister = deregister  # type: ignore[attr-defined]
    if target is not None:
        target.deregister = deregister
    return beat


class GatewayMap:
    """Ordered gateway address list + per-gateway meta.

    The stable membership a router hashes over. Addresses are data-plane ``host:port`` identities;
    ``meta`` keeps whatever each gateway advertised at registration (empty
    for maps built from a plain address list)."""

    def __init__(self, addrs: Sequence[str], meta: Optional[Dict[str, dict]] = None):
        self.addrs = list(dict.fromkeys(a.strip() for a in addrs if a.strip()))
        if not self.addrs:
            raise ValueError("gateway map needs at least one 'host:port' address")
        self.meta: Dict[str, dict] = {a: dict((meta or {}).get(a) or {})
                                      for a in self.addrs}

    def __len__(self) -> int:
        return len(self.addrs)

    def __contains__(self, addr: str) -> bool:
        return addr in self.meta

    @classmethod
    def parse(cls, spec: str) -> "GatewayMap":
        """``"h1:p1,h2:p2,..."`` -> map (a single address is a 1-gateway map)."""
        return cls(str(spec).split(","))

    @classmethod
    def discover(cls, coordinator_addr: Tuple[str, int],
                 token: str = GATEWAY_TOKEN) -> "GatewayMap":
        """Build the map from the coordinator's live ``serve_gateway``
        registrations (lease-evicted gateways never appear). Raises
        ``ValueError`` when no gateway has registered yet."""
        from ...comm.discovery import discover_endpoints

        records = discover_endpoints(coordinator_addr, token)
        meta: Dict[str, dict] = {}
        for r in records:
            meta[f"{r['ip']}:{r['port']}"] = dict(r.get("meta") or {})
        if not meta:
            host, port = coordinator_addr
            raise ValueError(
                f"no {token!r} registrations at coordinator {host}:{port} "
                "(are the gateways up, and started with --coordinator-addr?)"
            )
        addrs = sorted(meta)
        return cls(addrs, meta=meta)

    def players(self) -> List[str]:
        """Every player id any gateway in the map advertises."""
        out: List[str] = []
        for addr in self.addrs:
            for p in self.meta.get(addr, {}).get("players") or []:
                if p not in out:
                    out.append(p)
        return out

    def http_addr(self, addr: str) -> Optional[str]:
        """The gateway's HTTP/JSON surface (``host:http_port``) when its
        registration advertised one (the status side channel)."""
        http_port = self.meta.get(addr, {}).get("http_port")
        if not http_port:
            return None
        host = addr.rpartition(":")[0] or "127.0.0.1"
        return f"{host}:{http_port}"
