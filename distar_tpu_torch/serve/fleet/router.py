"""Session-affinity routing over the gateway fleet.

Counterpart of ``distar_tpu.serve.fleet.router``. Sticky LSTM carries live
server-side (``SessionTable``), so load balancing cannot be per request: a
session pinned to gateway A must keep hitting A or its carry restarts from
zero. ``FleetRouter`` pins every session to a gateway over a
consistent-hash ring (``replay.sharding.HashRing``: md5, identical across
processes; growing the fleet from N to N+1 gateways remaps about 1/(N+1)
of fresh sessions).

On gateway death the pin moves to a survivor (``distar_fleet_reroutes_
total``) and the session re-materializes from a zero carry there, seen
when the per-episode ``session_step`` in an answer runs backwards and
counted in ``distar_fleet_session_migrations_total``.

Canary rollout: ``set_canary(addrs, pct)`` splits the fleet into a stable
and a canary pool, and ``pct``% of NEW sessions (a deterministic hash
split, so every router instance agrees) pin to canary gateways. Existing
sessions never move: affinity outranks canary.

Two deployment shapes, same code:

  * in-client library: ``FleetClient`` speaks the whole ``ServeClient``
    surface and routes client-side, with no proxy hop on the data path;
  * standalone process: ``python -m distar_tpu_torch.serve.fleet.router``
    fronts the fleet behind one address (``RouterGatewayAdapter`` behind
    the stock ``ServeTCPServer``/``ServeHTTPServer``).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ...obs import (
    annotate,
    finish_trace,
    get_registry,
    is_trace,
    join_trace,
    start_trace,
    tracing_enabled,
)
from ...replay.sharding import HashRing, stable_hash
from ...resilience import CircuitOpenError, RetryableError, RetryPolicy
from ..errors import CapacityError, DrainingError, ServeError
from .discovery import GatewayMap

#: exceptions that mean "this gateway is unreachable", never an application
#: answer — the router marks the gateway down and re-routes; typed
#: ``ServeError`` answers (sheds, unknown version...) pass through untouched
TRANSPORT_ERRORS = (ConnectionError, OSError, CircuitOpenError, RetryableError,
                    ValueError)


def _split_addr(addr: str) -> Tuple[str, int]:
    host, _, port = addr.rpartition(":")
    return host or "127.0.0.1", int(port)


class FleetRouter:
    """Pure routing state — gateway membership, session pins, down-list,
    canary split. No sockets: ``FleetClient`` (or any other transport) asks
    it where a session lives and reports gateway failures back."""

    def __init__(self, gateway_map: GatewayMap, vnodes: int = 128,
                 down_ttl_s: float = 10.0):
        self.map = gateway_map
        self.vnodes = int(vnodes)
        self.down_ttl_s = float(down_ttl_s)
        self._pins: Dict[str, str] = {}
        self._steps: Dict[str, int] = {}  # last seen session_step per session
        self._down: Dict[str, float] = {}  # addr -> retry-after monotonic ts
        self._canary_addrs: List[str] = []
        self._canary_pct: float = 0.0
        self._rings: Dict[frozenset, HashRing] = {}
        self._lock = threading.RLock()
        reg = get_registry()
        self._c_migrations = reg.counter(
            "distar_fleet_session_migrations_total",
            "sessions whose server-side carry re-materialized from zero "
            "(session_step ran backwards after a re-route or gateway restart)",
        )
        self._c_reroutes = reg.counter(
            "distar_fleet_reroutes_total",
            "session pins moved off an unreachable gateway to a survivor",
        )
        self._c_routed = {
            pool: reg.counter(
                "distar_fleet_routed_sessions_total",
                "new sessions pinned to a gateway, by routing pool", pool=pool)
            for pool in ("stable", "canary")
        }
        self._g_live = reg.gauge(
            "distar_fleet_gateways_live", "gateways currently routable")
        self._g_pinned = reg.gauge(
            "distar_fleet_sessions_pinned", "sessions holding a gateway pin")
        self._g_canary = reg.gauge(
            "distar_fleet_canary_pct",
            "percent of new sessions routed to the canary pool")
        self._g_live.set(len(self.map))

    # ------------------------------------------------------------- membership
    def live_addrs(self) -> List[str]:
        with self._lock:
            now = time.monotonic()
            live = [a for a in self.map.addrs if self._down.get(a, 0.0) <= now]
            self._g_live.set(len(live))
            return live

    def mark_down(self, addr: str, ttl_s: Optional[float] = None) -> None:
        """A transport failure was observed against ``addr``: keep new work
        off it for ``ttl_s`` (it is re-offered after — a restarted gateway
        on the same address rejoins automatically)."""
        with self._lock:
            self._down[addr] = time.monotonic() + (
                self.down_ttl_s if ttl_s is None else float(ttl_s))
        get_registry().counter(
            "distar_fleet_gateway_failures_total",
            "transport failures that marked a gateway down", gateway=addr,
        ).inc()

    def note_ok(self, addr: str) -> None:
        """A call against ``addr`` succeeded — clear any down mark early."""
        with self._lock:
            self._down.pop(addr, None)

    def mark_draining(self, addr: str, ttl_s: float = 60.0) -> None:
        """The gateway answered ``DrainingError``: it is retiring
        gracefully. Route new work AND existing pins off it (the re-pin is
        the migration; the retiring gateway finishes its in-flight work
        itself). A long TTL, not a permanent mark: the next membership
        refresh drops the address entirely, and a re-offer against a
        still-draining gateway just observes the drain again — harmless."""
        with self._lock:
            self._down[addr] = time.monotonic() + float(ttl_s)
        get_registry().counter(
            "distar_fleet_drains_observed_total",
            "DrainingError answers that moved routing off a retiring gateway",
            gateway=addr,
        ).inc()

    def refresh(self, gateway_map: GatewayMap) -> None:
        """Install a freshly discovered map (lease-evicted gateways are
        gone from it). Pins to departed gateways re-route on next use."""
        with self._lock:
            self.map = gateway_map
            self._rings.clear()
            self._down = {a: t for a, t in self._down.items()
                          if a in gateway_map.meta}
            self._canary_addrs = [a for a in self._canary_addrs
                                  if a in gateway_map.meta]

    # ----------------------------------------------------------------- canary
    def set_canary(self, addrs: Sequence[str], pct: float) -> None:
        """Route ``pct``% of NEW sessions to the canary gateways. Existing
        pins never move (affinity outranks canary). The split is a
        deterministic hash of the session id, so every router instance in
        the fleet sends the same sessions to the same pool."""
        with self._lock:
            self._canary_addrs = [a for a in addrs if a in self.map.meta]
            self._canary_pct = max(0.0, min(100.0, float(pct)))
            if not self._canary_addrs:
                self._canary_pct = 0.0
            self._g_canary.set(self._canary_pct)

    def clear_canary(self) -> None:
        self.set_canary([], 0.0)

    def canary_config(self) -> Tuple[List[str], float]:
        with self._lock:
            return list(self._canary_addrs), self._canary_pct

    def is_canary_session(self, session_id: str) -> bool:
        """Deterministic canary membership (cross-process stable — md5, not
        ``hash()``), evaluated against the CURRENT percent."""
        with self._lock:
            pct = self._canary_pct
        if pct <= 0.0:
            return False
        return (stable_hash(f"canary/{session_id}") % 10000) < pct * 100.0

    # ---------------------------------------------------------------- routing
    def _ring(self, addrs: List[str]) -> HashRing:
        key = frozenset(addrs)
        ring = self._rings.get(key)
        if ring is None:
            ring = self._rings[key] = HashRing(sorted(addrs), vnodes=self.vnodes)
        return ring

    def gateway_for(self, session_id: str) -> str:
        """The gateway this session lives on: its pin when that gateway is
        routable, else a survivor (counted re-route), else — for a fresh
        session — a ring pick from its pool (the canary split applies only
        here, to NEW sessions)."""
        with self._lock:
            now = time.monotonic()
            live = [a for a in self.map.addrs if self._down.get(a, 0.0) <= now]
            if not live:
                raise ServeError(
                    f"no routable gateway (fleet of {len(self.map)}, all down)")
            pinned = self._pins.get(session_id)
            if pinned is not None:
                if pinned in live and pinned in self.map.meta:
                    return pinned
                # pinned gateway unreachable: move to a survivor — the
                # session's carry re-materializes from zero over there
                addr = self._pick(session_id, live)
                self._pins[session_id] = addr
                self._c_reroutes.inc()
                return addr
            addr = self._pick(session_id, live)
            self._pins[session_id] = addr
            self._g_pinned.set(len(self._pins))
            pool = ("canary" if self._canary_pct > 0.0
                    and addr in self._canary_addrs else "stable")
            self._c_routed[pool].inc()
            return addr

    def _pick(self, session_id: str, live: List[str]) -> str:
        """Ring pick within the session's pool (caller holds the lock)."""
        canary_live = [a for a in self._canary_addrs if a in live]
        if canary_live and self.is_canary_session(session_id):
            return self._ring(canary_live).lookup(session_id)
        stable = [a for a in live if a not in self._canary_addrs] or live
        return self._ring(stable).lookup(session_id)

    def spill_over(self, session_id: str, addr: str) -> bool:
        """A FRESH session (no server-side carry yet) was capacity-shed at
        its ring-picked gateway: move its pin to the next live gateway so
        the fleet's free slots absorb it — arrival admission becomes a
        fleet-wide property, not a per-gateway accident of the hash split
        (and a just-joined gateway actually receives the overflow that
        triggered the scale-up). Sessions with a materialized carry NEVER
        move this way — affinity outranks capacity. Returns False when
        there is nowhere else to try (the shed then passes through)."""
        now = time.monotonic()
        with self._lock:
            if self._steps.get(session_id, 0) > 0:
                return False  # carry materialized: affinity wins
            live = [a for a in self.map.addrs if self._down.get(a, 0.0) <= now]
            if len(live) <= 1:
                return False
            cur = self._pins.get(session_id, addr)
            i = live.index(cur) if cur in live else -1
            nxt = live[(i + 1) % len(live)]
            if nxt == cur:
                return False
            self._pins[session_id] = nxt
        get_registry().counter(
            "distar_fleet_capacity_spillovers_total",
            "fresh sessions re-pinned past a capacity-full gateway to the "
            "next live one",
        ).inc()
        return True

    def note_step(self, session_id: str, step: Optional[int]) -> None:
        """Feed every answer's ``session_step`` back: when it runs backwards
        the server-side carry restarted from zero — one migration."""
        if step is None:
            return
        with self._lock:
            last = self._steps.get(session_id, 0)
            if last > 0 and int(step) <= last:
                self._c_migrations.inc()
            self._steps[session_id] = int(step)

    def reset_steps(self, session_id: str) -> None:
        """Episode boundary: the server restarts the counter with the carry
        — a step of 1 after this is NOT a migration."""
        with self._lock:
            self._steps.pop(session_id, None)

    def unpin(self, session_id: str) -> None:
        with self._lock:
            self._pins.pop(session_id, None)
            self._steps.pop(session_id, None)
            self._g_pinned.set(len(self._pins))

    def pins_on(self, addr: str) -> List[str]:
        with self._lock:
            return [sid for sid, a in self._pins.items() if a == addr]

    def stats(self) -> dict:
        with self._lock:
            now = time.monotonic()
            per_gateway: Dict[str, int] = {a: 0 for a in self.map.addrs}
            for a in self._pins.values():
                per_gateway[a] = per_gateway.get(a, 0) + 1
            return {
                "gateways": list(self.map.addrs),
                "down": sorted(a for a, t in self._down.items() if t > now),
                "pinned_sessions": len(self._pins),
                "pins_per_gateway": per_gateway,
                "canary": {"addrs": list(self._canary_addrs),
                           "pct": self._canary_pct},
            }


class FleetClient:
    """The whole fleet behind the ``ServeClient`` surface.

    Per-gateway ``ServeClient``s are dialed lazily, each under a SHORT
    retry policy — the rotation is the real retry: when a gateway's budget
    is exhausted the router marks it down, re-pins the affected sessions to
    survivors and the call is re-issued there, all inside the caller's
    timeout. Typed ``ServeError`` answers pass through untouched (sheds are
    application backpressure, not gateway death).

    ``player`` stamps every request for multiplexed gateways
    (``serve.mux.GatewayMux``); a single-model gateway ignores the field,
    so the same client speaks to both generations of server.
    """

    def __init__(self, gateway_map: Optional[GatewayMap] = None,
                 router: Optional[FleetRouter] = None,
                 coordinator_addr: Optional[Tuple[str, int]] = None,
                 timeout_s: float = 30.0, player: Optional[str] = None,
                 retry_policy: Optional[RetryPolicy] = None,
                 client_factory: Optional[Callable[[str], Any]] = None,
                 down_ttl_s: float = 10.0, transport: str = "auto",
                 refresh_s: float = 10.0):
        self.transport = transport
        if router is None:
            if gateway_map is None:
                if coordinator_addr is None:
                    raise ValueError(
                        "FleetClient needs a gateway_map, a router, or a "
                        "coordinator_addr to discover one")
                gateway_map = GatewayMap.discover(coordinator_addr)
            router = FleetRouter(gateway_map, down_ttl_s=down_ttl_s)
        self.router = router
        self.timeout_s = float(timeout_s)
        self.player = player
        # fail FAST per gateway: the router's re-route is the patience
        self._policy = retry_policy or RetryPolicy(
            max_attempts=2, backoff_base_s=0.1, backoff_max_s=0.5,
            deadline_s=max(5.0, timeout_s / 2.0))
        self._client_factory = client_factory
        self._clients: Dict[str, Any] = {}
        self._lock = threading.Lock()
        # live membership: with a coordinator in hand, re-discover the fleet
        # every refresh_s so joins and drains become visible without a
        # restart (comm.discovery.start_refresh)
        self._refresher = None
        if coordinator_addr is not None and refresh_s > 0:
            from ...comm.discovery import start_refresh
            from .discovery import GATEWAY_TOKEN

            self._refresher = start_refresh(
                coordinator_addr, GATEWAY_TOKEN, self._apply_records,
                interval_s=refresh_s)

    def _apply_records(self, records) -> None:
        """Fold a freshly discovered fleet into the live router. An empty
        read is kept OUT (indistinguishable from a restarting broker that
        lost its records — a stale map beats an empty one). A departed
        address that still holds session pins gets the drain handoff:
        those sessions are ENDED there best-effort (a draining gateway
        still answers ``end``, so its residency actually reaches zero and
        it can exit; a crashed one ignores us harmlessly) before their
        next step re-pins them to a survivor. Clients held against
        departed gateways are then closed."""
        meta = {f"{r['ip']}:{r['port']}": dict(r.get("meta") or {})
                for r in records}
        if not meta:
            return
        departed = [a for a in self.router.map.addrs if a not in meta]
        pinned = {a: self.router.pins_on(a) for a in departed}
        self.router.refresh(GatewayMap(sorted(meta), meta=meta))
        for addr in departed:
            with self._lock:
                client = self._clients.get(addr)
            if client is not None and pinned.get(addr):
                self._drain_handoff(addr, client, pinned[addr],
                                    mark=False)
        with self._lock:
            dead = [a for a in self._clients if a not in meta]
            closed = [self._clients.pop(a) for a in dead]
        for c in closed:
            try:
                c.close()
            except Exception:  # noqa: BLE001 - teardown best-effort
                pass

    # ------------------------------------------------------------ connections
    def _dial(self, addr: str):
        if self._client_factory is not None:
            return self._client_factory(addr)
        from ..tcp_frontend import ServeClient

        host, port = _split_addr(addr)
        # transport negotiates per gateway: colocated members of a mixed
        # fleet ride shm, remote ones fall out to framed TCP naturally
        return ServeClient(host, port, timeout_s=self.timeout_s,
                           retry_policy=self._policy, transport=self.transport)

    def _client_for(self, addr: str):
        with self._lock:
            client = self._clients.get(addr)
        if client is not None:
            return client
        client = self._dial(addr)  # TRANSPORT_ERRORS propagate to the caller
        with self._lock:
            held = self._clients.setdefault(addr, client)
        if held is not client:
            client.close()
        return held

    def _gateway_failed(self, addr: str) -> None:
        with self._lock:
            client = self._clients.pop(addr, None)
        if client is not None:
            try:
                client.close()
            except Exception:  # noqa: BLE001 - already failed; best-effort
                pass
        self.router.mark_down(addr)

    def _player(self, player: Optional[str]) -> Optional[str]:
        return self.player if player is None else player

    # -------------------------------------------------------------- data path
    def act(self, session_id: str, obs, timeout_s: Optional[float] = None,
            want_teacher: bool = False, player: Optional[str] = None,
            trace: Optional[dict] = None) -> dict:
        """One agent step with affinity + failover: served by the session's
        pinned gateway, re-routed to a survivor when that gateway is
        unreachable (the carry re-materializes from zero over there —
        counted). Raises typed ``ServeError``s exactly like a direct
        ``ServeClient``. ``trace`` supplies a caller-minted span for the
        lane (re-route/retry time annotates it; finished here)."""
        req = {"session_id": session_id, "obs": obs, "want_teacher": want_teacher}
        if trace is not None:
            req["trace_ctx"] = trace
        out = self.act_many([req], timeout_s=timeout_s, player=player)[0]
        if isinstance(out, ServeError):
            raise out
        return out

    def act_many(self, requests, timeout_s: Optional[float] = None,
                 player: Optional[str] = None) -> list:
        """One cycle across the fleet: lanes group by their sessions'
        gateways, one ``act_many`` frame per gateway, per-lane results
        merged back in request order (dicts or typed ``ServeError``
        instances — the gateway contract). A gateway that fails mid-cycle
        is marked down, its lanes re-pin to survivors and re-issue; only
        when no routable gateway remains do those lanes come back as
        ``ServeError`` values."""
        requests = list(requests)
        player = self._player(player)
        # per-lane client spans, minted BEFORE routing so fleet-level work —
        # re-routes, drain handoffs, capacity spill-overs — is attributed
        # (``retry_s``) to the request that paid for it; the per-gateway
        # ServeClient stamps the compact wire field from the same context,
        # so the winning gateway's span joins under this lane's span
        if tracing_enabled():
            for r in requests:
                if r.get("trace_ctx") is None:
                    r["trace_ctx"] = start_trace(
                        "serve_client", session=r.get("session_id", "?"))
        results: List[Any] = [None] * len(requests)
        lanes = list(range(len(requests)))
        spills: Dict[int, int] = {}  # per-lane capacity spill-overs this call
        # every lane traverses at most the whole fleet once, plus one pick
        for _ in range(len(self.router.map) + 1):
            if not lanes:
                break
            round_t0 = time.monotonic()

            def _note_retry(idxs) -> None:
                # the re-route IS the retry: wall-clock this round burned
                # before the lane re-issues lands on its span as retry_s
                spent = time.monotonic() - round_t0
                for i in idxs:
                    annotate(requests[i].get("trace_ctx"), "retry_s", spent)

            by_addr: Dict[str, List[int]] = {}
            for i in lanes:
                try:
                    addr = self.router.gateway_for(requests[i]["session_id"])
                except ServeError as e:  # no routable gateway at all
                    results[i] = e
                    continue
                by_addr.setdefault(addr, []).append(i)
            retry: List[int] = []
            for addr, idxs in by_addr.items():
                try:
                    client = self._client_for(addr)
                    entries = client.act_many(
                        [requests[i] for i in idxs], timeout_s=timeout_s,
                        player=player)
                except TRANSPORT_ERRORS:
                    self._gateway_failed(addr)
                    _note_retry(idxs)
                    retry.extend(idxs)
                    continue
                self.router.note_ok(addr)
                handoff: List[int] = []
                for i, entry in zip(idxs, entries):
                    if isinstance(entry, DrainingError):
                        # graceful retirement, not backpressure: this lane's
                        # session migrates to a survivor (the re-route
                        # path), it does not bounce back to the caller
                        handoff.append(i)
                        continue
                    if (isinstance(entry, CapacityError)
                            and spills.get(i, 0) < len(self.router.map) - 1
                            and self.router.spill_over(
                                requests[i]["session_id"], addr)):
                        # fresh session, full gateway, fleet not full:
                        # re-pinned to the next live gateway and re-issued
                        # (a fleet-wide-full session runs out of spills and
                        # sheds through typed, exactly as before)
                        spills[i] = spills.get(i, 0) + 1
                        _note_retry([i])
                        retry.append(i)
                        continue
                    results[i] = entry
                    if isinstance(entry, dict):
                        self.router.note_step(
                            requests[i]["session_id"], entry.get("session_step"))
                if handoff:
                    self._drain_handoff(
                        addr, client, [requests[i]["session_id"] for i in handoff])
                    _note_retry(handoff)
                    retry.extend(handoff)
            lanes = retry
        for i in lanes:  # passes exhausted with gateways still failing
            if results[i] is None:
                results[i] = ServeError("gateway fleet unreachable for lane")
        # lane spans resolve with the FINAL outcome (a shed that spilled to
        # a survivor and succeeded records ok, not the intermediate shed)
        for r, entry in zip(requests, results):
            ctx = r.get("trace_ctx")
            if not is_trace(ctx):
                continue
            if isinstance(entry, ServeError):
                entry.trace_id = ctx["trace_id"]
                finish_trace(ctx, "client_done",
                             outcome="shed" if entry.shed else "error")
            else:
                finish_trace(ctx, "client_done")
        return results

    def _drain_handoff(self, addr: str, client, session_ids,
                       mark: bool = True) -> None:
        """A gateway is retiring under these sessions: take routing off it
        (``mark=False`` when a membership refresh already removed it), then
        END each session there (freeing its slot, so the retiring process's
        ``resident_sessions`` actually drains to zero) before the caller's
        next step re-pins it to a survivor — where the carry
        re-materializes from zero and the migration is counted exactly
        (session_step runs backwards)."""
        if mark:
            self.router.mark_draining(addr)
        ended = 0
        for sid in session_ids:
            try:
                if client.end(sid, player=self.player):
                    ended += 1
            except Exception:  # noqa: BLE001 - the drain timeout frees it anyway
                pass
        if ended:
            get_registry().counter(
                "distar_fleet_drain_handoff_sessions_total",
                "sessions ended on a draining gateway before re-pinning to "
                "a survivor (exact-accounting half of a graceful migration)",
            ).inc(ended)

    # -------------------------------------------------------- session control
    def _routed_call(self, addr: str, opname: str, fn: Callable):
        """One control-plane call against a specific gateway; transport
        failure marks it down and surfaces typed (control ops don't blind-
        re-route: the caller re-issues and routing picks a survivor)."""
        try:
            client = self._client_for(addr)
            result = fn(client)
        except ServeError:
            raise  # typed application answer — the gateway is fine
        except TRANSPORT_ERRORS as e:
            self._gateway_failed(addr)
            raise ServeError(f"gateway {addr} unreachable for {opname}: {e!r}") from e
        self.router.note_ok(addr)
        return result

    def reserve(self, session_ids, player: Optional[str] = None) -> Dict[str, int]:
        """Bulk pre-allocation, grouped by each session's gateway. Exact
        capacity holds PER GATEWAY (each ``SessionTable.reserve`` is
        all-or-nothing); across gateways a later group's ``CapacityError``
        propagates with earlier groups already reserved — callers treat it
        as job-start failure exactly like the single-gateway contract."""
        player = self._player(player)
        out: Dict[str, int] = {}
        by_addr: Dict[str, List[str]] = {}
        for sid in session_ids:
            by_addr.setdefault(self.router.gateway_for(sid), []).append(sid)
        for addr, sids in by_addr.items():
            out.update(self._routed_call(
                addr, "reserve", lambda c, s=sids: c.reserve(s, player=player)))
        return out

    def hidden(self, session_id: str, player: Optional[str] = None):
        addr = self.router.gateway_for(session_id)
        return self._routed_call(
            addr, "hidden",
            lambda c: c.hidden(session_id, player=self._player(player)))

    def reset(self, session_id: str, player: Optional[str] = None) -> bool:
        addr = self.router.gateway_for(session_id)
        self.router.reset_steps(session_id)
        return self._routed_call(
            addr, "reset",
            lambda c: c.reset(session_id, player=self._player(player)))

    def end(self, session_id: str, player: Optional[str] = None) -> bool:
        try:
            addr = self.router.gateway_for(session_id)
            return self._routed_call(
                addr, "end",
                lambda c: c.end(session_id, player=self._player(player)))
        finally:
            self.router.unpin(session_id)

    # ------------------------------------------------------------ fleet admin
    def _broadcast(self, opname: str, fn: Callable) -> Dict[str, Any]:
        """Run a control op against every LIVE gateway; per-gateway results
        (``ServeError`` values for the unreachable) keyed by address."""
        out: Dict[str, Any] = {}
        for addr in self.router.live_addrs():
            try:
                out[addr] = self._routed_call(addr, opname, fn)
            except ServeError as e:
                out[addr] = e
        return out

    def set_teacher(self, params, player: Optional[str] = None) -> bool:
        p = self._player(player)
        replies = self._broadcast(
            "set_teacher", lambda c: c.set_teacher(params, player=p))
        return all(v is True for v in replies.values())

    def load(self, version: str, source: Optional[str] = None, params=None,
             activate: bool = False, player: Optional[str] = None) -> Dict[str, Any]:
        """Fleet-wide best-effort load. For an all-or-nothing rollout with
        ack and rollback use ``fleet.rollout``."""
        p = self._player(player)
        return self._broadcast(
            "load", lambda c: c.load(version, source=source, params=params,
                                     activate=activate, player=p))

    def swap(self, version: str, player: Optional[str] = None) -> Dict[str, Any]:
        p = self._player(player)
        return self._broadcast("swap", lambda c: c.swap(version, player=p))

    def status(self) -> dict:
        per_gateway: Dict[str, Any] = {}
        for addr in self.router.map.addrs:
            try:
                per_gateway[addr] = self._routed_call(
                    addr, "status", lambda c: c.status())
            except ServeError as e:
                per_gateway[addr] = {"error": str(e)}
        return {"router": self.router.stats(), "gateways": per_gateway}

    def ping(self) -> bool:
        return all(not isinstance(v, ServeError)
                   for v in self._broadcast("ping", lambda c: c.ping()).values())

    def close(self) -> None:
        if self._refresher is not None:
            self._refresher.stop_event.set()
            self._refresher = None
        with self._lock:
            clients, self._clients = list(self._clients.values()), {}
        for c in clients:
            try:
                c.close()
            except Exception:  # noqa: BLE001 - teardown best-effort
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class RouterGatewayAdapter:
    """``FleetClient`` behind the gateway method surface, so the stock
    ``ServeTCPServer``/``ServeHTTPServer`` can front a whole fleet as a
    thin standalone router process (for callers that can't mount the
    client library). ``resolve`` forwards each request's ``player`` field
    through to multiplexed gateways."""

    def __init__(self, fleet: FleetClient, player: Optional[str] = None):
        self.fleet = fleet
        self._player = player

    def resolve(self, player: Optional[str]) -> "RouterGatewayAdapter":
        if player is None or player == self._player:
            return self
        return RouterGatewayAdapter(self.fleet, player=player)

    def _join(self, wire):
        """A remote caller's wire trace field becomes this router process's
        own span (name ``router``) — the hop between client and gateway is
        then visible in the waterfall instead of folded into 'network'."""
        if wire is None or not tracing_enabled():
            return None
        return join_trace(wire, "router")

    def act(self, session_id: str, obs, timeout_s=None, want_teacher=False,
            trace=None):
        return self.fleet.act(session_id, obs, timeout_s=timeout_s,
                              want_teacher=want_teacher, player=self._player,
                              trace=self._join(trace))

    def act_many(self, requests, timeout_s=None):
        requests = list(requests)
        for r in requests:
            wire = r.get("trace")
            ctx = self._join(wire)
            if ctx is not None:
                r["trace_ctx"] = ctx
        return self.fleet.act_many(requests, timeout_s=timeout_s,
                                   player=self._player)

    def reserve_sessions(self, session_ids):
        return self.fleet.reserve(session_ids, player=self._player)

    def session_hidden(self, session_id: str):
        return self.fleet.hidden(session_id, player=self._player)

    def set_teacher(self, params):
        return self.fleet.set_teacher(params, player=self._player)

    def reset_session(self, session_id: str) -> bool:
        return self.fleet.reset(session_id, player=self._player)

    def end_session(self, session_id: str) -> bool:
        return self.fleet.end(session_id, player=self._player)

    def load_version(self, version, source=None, params=None, activate=False):
        replies = self.fleet.load(version, source=source, params=params,
                                  activate=activate, player=self._player)
        return {a: (v if not isinstance(v, ServeError) else {"error": str(v)})
                for a, v in replies.items()}

    def activate_version(self, version):
        replies = self.fleet.swap(version, player=self._player)
        errors = {a: str(v) for a, v in replies.items()
                  if isinstance(v, ServeError)}
        if errors:
            raise ServeError(f"swap failed on {sorted(errors)}: {errors}")
        return max((int(v) for v in replies.values()), default=0)

    def status(self) -> dict:
        return self.fleet.status()


def main(argv=None) -> int:
    """Standalone router: ``python -m distar_tpu_torch.serve.fleet.router``.

    Fronts the gateway fleet (static ``--gateways`` list or coordinator
    ``--discover``) behind one TCP + one HTTP address. Prints a parseable
    ``SERVE-ROUTER <host> <tcp_port> <http_port>`` line once serving, then
    runs until SIGTERM/SIGINT or stdin EOF."""
    import argparse
    import signal
    import sys

    from ..http_frontend import ServeHTTPServer
    from ..tcp_frontend import ServeTCPServer

    p = argparse.ArgumentParser(description="standalone serve-fleet router")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0, help="TCP data plane")
    p.add_argument("--http-port", type=int, default=0)
    p.add_argument("--gateways", default="",
                   help="static 'h1:p1,h2:p2' gateway list")
    p.add_argument("--discover", default="",
                   help="coordinator host:port to discover the fleet from")
    p.add_argument("--timeout-s", type=float, default=30.0)
    p.add_argument("--refresh-s", type=float, default=10.0,
                   help="re-discover cadence when using --discover")
    args = p.parse_args(argv)
    if bool(args.gateways) == bool(args.discover):
        p.error("exactly one of --gateways / --discover")

    coordinator = None
    if args.discover:
        host, _, port = args.discover.rpartition(":")
        coordinator = (host or "127.0.0.1", int(port))
        gateway_map = GatewayMap.discover(coordinator)
    else:
        gateway_map = GatewayMap.parse(args.gateways)
    fleet = FleetClient(gateway_map=gateway_map, timeout_s=args.timeout_s)
    adapter = RouterGatewayAdapter(fleet)
    tcp = ServeTCPServer(adapter, host=args.host, port=args.port).start()
    http = ServeHTTPServer(adapter, host=args.host, port=args.http_port).start()
    print(f"SERVE-ROUTER {tcp.host} {tcp.port} {http.port}", flush=True)

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())

    if coordinator is not None:
        # live membership through comm.discovery's refresh loop, and the
        # canary split the rollout controller publishes
        # (canary_start/promote)
        from ...comm.discovery import start_refresh
        from .discovery import GATEWAY_TOKEN
        from .rollout import fetch_canary

        def apply_records(records):
            fleet._apply_records(records)
            cfg = fetch_canary(coordinator)
            if cfg is not None:
                fleet.router.set_canary(cfg.get("addrs") or [],
                                        float(cfg.get("pct") or 0.0))

        start_refresh(coordinator, GATEWAY_TOKEN, apply_records,
                      interval_s=args.refresh_s, stop_event=stop)
    try:
        import select

        while not stop.is_set():
            ready, _, _ = select.select([sys.stdin], [], [], 0.5)
            if ready and not sys.stdin.buffer.read(1):
                break
    except (OSError, ValueError, KeyboardInterrupt):
        pass
    tcp.stop()
    http.stop()
    fleet.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
