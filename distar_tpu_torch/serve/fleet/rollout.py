"""Fleet-wide model rollout: all-or-nothing hot swap and canary rollout.

Counterpart of ``distar_tpu.serve.fleet.rollout``. The gateway's hot-swap
contract (activate at a flush boundary, no in-flight loss) lifted to the
fleet:

  * ``FleetRollout.rollout(version, ...)``: an all-or-nothing generation
    bump. Phase 1 loads and warms the version on every gateway and
    collects acks; any NACK aborts with nothing activated anywhere (a
    loaded but inactive version is inert). Phase 2 activates gateway by
    gateway; a NACK there rolls every gateway already swapped back to the
    version it was serving, so the fleet never settles split.
    ``distar_fleet_rollouts_total{outcome}`` counts the outcomes.

  * canary: ``canary_start(version, canary_addrs, pct)`` activates the new
    generation on a subset of gateways only and sends ``pct``% of NEW
    sessions there (``FleetRouter``'s deterministic hash split), through a
    ``router=`` handle for an in-process router and by publishing the
    config to the coordinator (``serve_canary`` token) for polling ones
    (the standalone router applies it; an in-client router calls
    ``fetch_canary``). ``compare()`` reads both pools' request outcomes
    and latency tails from gateway ``status``; ``promote()`` is a normal
    rollout that then clears the canary config. Existing sessions never
    migrate for a canary.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ...obs import get_registry
from ..errors import ServeError
from .discovery import GatewayMap
from .router import TRANSPORT_ERRORS, _split_addr

#: coordinator token the live canary config is published under (a kv record,
#: not an endpoint: latest-timestamp record wins, pct=0 means no canary)
CANARY_TOKEN = "serve_canary"


def publish_canary(coordinator_addr: Tuple[str, int], addrs: Sequence[str],
                   pct: float, version: str = "") -> None:
    """Publish (or clear, with ``pct=0``) the fleet's canary config. Routers
    polling ``fetch_canary`` converge on it within their refresh cadence."""
    from ...comm.coordinator import coordinator_request

    host, port = coordinator_addr
    coordinator_request(host, port, "register", {
        "token": CANARY_TOKEN, "ip": "canary", "port": 0,
        "meta": {"addrs": list(addrs), "pct": float(pct), "version": version},
    })


def fetch_canary(coordinator_addr: Tuple[str, int]) -> Optional[dict]:
    """The latest published canary config (``{"addrs", "pct", "version"}``),
    or None when nothing was ever published."""
    from ...comm.discovery import discover_endpoints

    records = discover_endpoints(coordinator_addr, CANARY_TOKEN)
    if not records:
        return None
    latest = max(records, key=lambda r: r.get("ts", 0.0))
    return dict(latest.get("meta") or {})


class FleetRollout:
    """Rollout controller over a gateway map (discovered or static)."""

    def __init__(self, gateway_map: GatewayMap, timeout_s: float = 60.0,
                 client_factory: Optional[Callable[[str], Any]] = None,
                 coordinator_addr: Optional[Tuple[str, int]] = None):
        self.map = gateway_map
        self.timeout_s = float(timeout_s)
        self.coordinator_addr = coordinator_addr
        self._client_factory = client_factory
        self._clients: Dict[str, Any] = {}
        self._c_rollouts = {
            outcome: get_registry().counter(
                "distar_fleet_rollouts_total",
                "fleet-wide rollout attempts by outcome", outcome=outcome)
            for outcome in ("ok", "load_nack", "rolled_back",
                            "rollback_failed", "compare_gated")
        }

    # ------------------------------------------------------------------ plumbing
    def _client(self, addr: str):
        client = self._clients.get(addr)
        if client is None:
            if self._client_factory is not None:
                client = self._client_factory(addr)
            else:
                from ..tcp_frontend import ServeClient

                host, port = _split_addr(addr)
                client = ServeClient(host, port, timeout_s=self.timeout_s)
            self._clients[addr] = client
        return client

    def close(self) -> None:
        clients, self._clients = list(self._clients.values()), {}
        for c in clients:
            try:
                c.close()
            except Exception:  # noqa: BLE001 - teardown best-effort
                pass

    def fleet_status(self, addrs: Optional[Sequence[str]] = None) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        for addr in addrs or self.map.addrs:
            try:
                out[addr] = self._client(addr).status()
            except (ServeError,) + TRANSPORT_ERRORS as e:
                out[addr] = {"error": repr(e)}
        return out

    # ------------------------------------------------------------------ rollout
    def rollout(self, version: str, source: Optional[str] = None, params=None,
                addrs: Optional[Sequence[str]] = None,
                player: Optional[str] = None) -> dict:
        """Atomic fleet-wide generation bump; see module docstring. Returns
        ``{"ok", "outcome", "acks", "generations"|"rollback"}`` — never
        raises for per-gateway NACKs (the verdict is the return value)."""
        targets = list(addrs or self.map.addrs)
        t0 = time.perf_counter()
        # what each gateway serves NOW — the rollback target
        prev: Dict[str, Optional[str]] = {}
        for addr in targets:
            st = self.fleet_status([addr])[addr]
            if "error" in st:
                self._c_rollouts["load_nack"].inc()
                return {"ok": False, "outcome": "load_nack", "phase": "status",
                        "acks": {addr: st["error"]}}
            # the rollback target must be what THIS player serves: on a
            # multiplexed gateway the top-level registry is the default
            # player's (e.g. the teacher's), not the player being rolled
            if player is not None and (st.get("players") or {}).get(player):
                st = st["players"][player]
            prev[addr] = (st.get("registry") or {}).get("current")

        # phase 1: load + warm everywhere; a loaded version is inert until
        # activated, so any NACK aborts with the fleet untouched
        acks: Dict[str, Any] = {}
        nack = False
        for addr in targets:
            try:
                acks[addr] = self._client(addr).load(
                    version, source=source, params=params, activate=False,
                    player=player)
            except (ServeError,) + TRANSPORT_ERRORS as e:
                acks[addr] = {"error": repr(e)}
                nack = True
        if nack:
            self._c_rollouts["load_nack"].inc()
            return {"ok": False, "outcome": "load_nack", "phase": "load",
                    "acks": acks}

        # phase 2: activate gateway by gateway; NACK -> roll the already-
        # swapped prefix back to what it was serving
        generations: Dict[str, int] = {}
        swapped: List[str] = []
        for addr in targets:
            try:
                generations[addr] = self._client(addr).swap(version, player=player)
                swapped.append(addr)
            except (ServeError,) + TRANSPORT_ERRORS as e:
                rollback: Dict[str, Any] = {}
                failed = False
                for done in swapped:
                    target = prev[done]
                    try:
                        if target is None:
                            raise ServeError(
                                "no previous version to roll back to")
                        rollback[done] = self._client(done).swap(
                            target, player=player)
                    except (ServeError,) + TRANSPORT_ERRORS as re:
                        rollback[done] = {"error": repr(re)}
                        failed = True
                outcome = "rollback_failed" if failed else "rolled_back"
                self._c_rollouts[outcome].inc()
                return {"ok": False, "outcome": outcome, "phase": "swap",
                        "failed_gateway": addr, "error": repr(e),
                        "acks": acks, "rollback": rollback}
        self._c_rollouts["ok"].inc()
        return {"ok": True, "outcome": "ok", "acks": acks,
                "generations": generations,
                "elapsed_s": round(time.perf_counter() - t0, 4)}

    # ------------------------------------------------------------------- canary
    def canary_start(self, version: str, canary_addrs: Sequence[str],
                     pct: float, source: Optional[str] = None, params=None,
                     router=None, player: Optional[str] = None) -> dict:
        """Activate ``version`` on the canary gateways only (atomic within
        the subset) and direct ``pct``% of NEW sessions there — via the
        given in-process ``router`` and/or the coordinator-published config
        every polling router converges on."""
        canary_addrs = [a for a in canary_addrs if a in self.map.meta]
        if not canary_addrs:
            raise ValueError("canary_start: no valid canary gateway addresses")
        verdict = self.rollout(version, source=source, params=params,
                               addrs=canary_addrs, player=player)
        if not verdict["ok"]:
            return verdict
        if router is not None:
            router.set_canary(canary_addrs, pct)
        if self.coordinator_addr is not None:
            publish_canary(self.coordinator_addr, canary_addrs, pct, version)
        return {**verdict, "canary": {"addrs": canary_addrs, "pct": pct,
                                      "version": version}}

    def _fetch_divergence(self, window_s: float = 600.0) -> Optional[float]:
        """Freshest ``distar_distill_kl`` value from the coordinator's
        ``/timeseries`` (the distillation learner ships it with its
        telemetry): the divergence-vs-teacher leg of the canary compare.
        None when no coordinator is configured or no distillation learner
        ever shipped."""
        if self.coordinator_addr is None:
            return None
        import json
        import urllib.request

        host, port = self.coordinator_addr
        url = (f"http://{host}:{port}/timeseries"
               f"?name=distar_distill_kl&window_s={window_s:g}")
        try:
            with urllib.request.urlopen(url, timeout=5.0) as resp:
                body = json.loads(resp.read())
        except (OSError, ValueError):
            return None
        best = None
        for st in (body.get("stats") or {}).values():
            last = (st or {}).get("last")
            if isinstance(last, (int, float)):
                ts = (st or {}).get("last_ts", 0.0)
                if best is None or ts > best[0]:
                    best = (ts, float(last))
        return best[1] if best else None

    def compare(self, canary_addrs: Sequence[str],
                baseline: Optional[dict] = None,
                divergence: Optional[float] = None,
                max_divergence: Optional[float] = None,
                min_fps_ratio: float = 0.9,
                shed_slack: float = 0.01,
                latency_ratio: float = 1.5,
                win_rate: Optional[dict] = None,
                win_rate_fn: Optional[Callable[[], dict]] = None,
                min_win_rate: Optional[float] = None) -> dict:
        """Canary vs stable, from each gateway's own request accounting:
        cumulative outcome counters, shed rate and latency tails per pool,
        plus the two distillation-tier axes — **frames/s-per-slot** (ok
        requests per second per session slot, the serve-side throughput a
        cheaper student must not lose; measurable when ``baseline`` is a
        previous ``compare()`` snapshot to diff the lifetime counters
        against) and **divergence-vs-teacher** (``divergence=`` explicit,
        else the freshest ``distar_distill_kl`` from the coordinator).

        The third distillation axis is **win_rate**: head-to-head episodes
        of the canary (home) vs the stable policy
        (``envs.jaxenv.head_to_head``). Pass a ready-made summary via ``win_rate=`` or a zero-arg
        callable via ``win_rate_fn=`` (evaluated here, so the episode cost lands inside
        the compare step that reports it); ``min_win_rate`` turns the
        column into a gate — a canary that loses the head-to-head cannot
        promote.

        The returned ``verdict`` block is the promote/abort evidence the
        gated :meth:`promote` consumes: ``promote`` is True only when every
        measurable check passes; each failure lands in ``reasons``."""
        canary_set = set(canary_addrs)
        pools: Dict[str, dict] = {
            "stable": {"gateways": 0, "requests": {}, "shed_rate": 0.0,
                       "latency_p99_s": 0.0, "slots": 0},
            "canary": {"gateways": 0, "requests": {}, "shed_rate": 0.0,
                       "latency_p99_s": 0.0, "slots": 0},
        }
        for addr, st in self.fleet_status().items():
            pool = pools["canary" if addr in canary_set else "stable"]
            if "error" in st:
                pool.setdefault("unreachable", []).append(addr)
                continue
            pool["gateways"] += 1
            pool["slots"] += (st.get("sessions") or {}).get("num_slots", 0)
            for k, v in (st.get("requests") or {}).items():
                pool["requests"][k] = pool["requests"].get(k, 0.0) + v
            pool["shed_rate"] += st.get("shed_rate", 0.0)
            pool["latency_p99_s"] = max(
                pool["latency_p99_s"], (st.get("latency_s") or {}).get("p99", 0.0))
        for pool in pools.values():
            if pool["gateways"]:
                pool["shed_rate"] = round(pool["shed_rate"] / pool["gateways"], 6)
        out: Dict[str, Any] = dict(pools)
        out["ts"] = time.time()
        if baseline is not None and baseline.get("ts"):
            elapsed = max(out["ts"] - baseline["ts"], 1e-9)
            for name, pool in pools.items():
                prev = (baseline.get(name) or {}).get("requests") or {}
                ok_delta = pool["requests"].get("ok", 0.0) - prev.get("ok", 0.0)
                if pool["slots"]:
                    pool["fps_per_slot"] = round(
                        ok_delta / elapsed / pool["slots"], 6)
        if divergence is None:
            divergence = self._fetch_divergence()
        if divergence is not None:
            out["divergence"] = divergence
        if win_rate is None and win_rate_fn is not None:
            win_rate = win_rate_fn()
        if win_rate is not None:
            out["win_rate"] = dict(win_rate)

        reasons = []
        canary, stable = pools["canary"], pools["stable"]
        if canary.get("unreachable"):
            reasons.append(f"canary gateways unreachable: {canary['unreachable']}")
        if not canary["gateways"]:
            reasons.append("no reachable canary gateway")
        if canary["shed_rate"] > stable["shed_rate"] + shed_slack:
            reasons.append(
                f"canary shed_rate {canary['shed_rate']} > stable "
                f"{stable['shed_rate']} + {shed_slack}")
        if (canary["latency_p99_s"] and stable["latency_p99_s"]
                and canary["latency_p99_s"] > latency_ratio * stable["latency_p99_s"]):
            reasons.append(
                f"canary p99 {canary['latency_p99_s']:.4f}s > "
                f"{latency_ratio}x stable {stable['latency_p99_s']:.4f}s")
        c_fps, s_fps = canary.get("fps_per_slot"), stable.get("fps_per_slot")
        if c_fps is not None and s_fps and c_fps < min_fps_ratio * s_fps:
            reasons.append(
                f"canary fps_per_slot {c_fps} < {min_fps_ratio}x stable {s_fps}")
        if (max_divergence is not None and divergence is not None
                and divergence > max_divergence):
            reasons.append(
                f"divergence vs teacher {divergence:.4f} > "
                f"max_divergence {max_divergence}")
        if min_win_rate is not None:
            wr = (win_rate or {}).get("win_rate")
            if wr is None:
                reasons.append(
                    f"win_rate gate requested (min {min_win_rate}) but no "
                    "head-to-head result supplied")
            elif wr < min_win_rate:
                reasons.append(
                    f"canary win_rate {wr:.3f} < min_win_rate {min_win_rate} "
                    f"({win_rate.get('wins')}W/{win_rate.get('losses')}L/"
                    f"{win_rate.get('draws')}D over "
                    f"{win_rate.get('episodes')} episodes)")
        out["verdict"] = {"promote": not reasons, "reasons": reasons}
        return out

    def promote(self, version: str, source: Optional[str] = None, params=None,
                router=None, player: Optional[str] = None,
                verdict: Optional[dict] = None) -> dict:
        """The canary graduated: atomic fleet-wide rollout of ``version``,
        then clear the canary split (pins stay — sessions already on canary
        gateways are now on the fleet generation anyway). Pass a
        :meth:`compare` result (or its ``verdict`` block) as ``verdict`` to
        GATE the promotion on the compare evidence: a failing verdict
        refuses with ``outcome="compare_gated"`` and touches nothing — the
        canary keeps serving its split until an operator decides."""
        if verdict is not None:
            v = verdict.get("verdict", verdict)
            if not v.get("promote", True):
                self._c_rollouts["compare_gated"].inc()
                return {"ok": False, "outcome": "compare_gated",
                        "reasons": list(v.get("reasons", []))}
        verdict = self.rollout(version, source=source, params=params,
                               player=player)
        if verdict["ok"]:
            if router is not None:
                router.clear_canary()
            if self.coordinator_addr is not None:
                publish_canary(self.coordinator_addr, [], 0.0, version)
        return verdict


def main(argv=None) -> int:
    """Operator CLI: ``python -m distar_tpu_torch.serve.fleet.rollout <cmd>``.

    ``status`` prints per-gateway serving state; ``rollout`` drives the
    atomic fleet-wide swap; ``canary`` activates a subset + publishes the
    routing split to the coordinator; ``promote`` graduates it. Exit 0 only
    when the fleet converged (rollback leaves exit 1 with the verdict
    printed as JSON)."""
    import argparse
    import json

    p = argparse.ArgumentParser(description="serve-fleet rollout controller")
    p.add_argument("command", choices=("status", "rollout", "canary", "promote"))
    p.add_argument("--gateways", default="", help="static 'h1:p1,h2:p2' list")
    p.add_argument("--discover", default="",
                   help="coordinator host:port to discover gateways from")
    p.add_argument("--version", default="", help="registry version name")
    p.add_argument("--source", default="", help="checkpoint storage URL")
    p.add_argument("--canary-addrs", default="",
                   help="canary: comma list of gateway addrs to canary; "
                        "promote: gate on compare() over these addrs "
                        "(shed/latency/divergence — a failing verdict "
                        "refuses with outcome=compare_gated)")
    p.add_argument("--canary-pct", type=float, default=10.0)
    p.add_argument("--max-divergence", type=float, default=None,
                   help="promote gating: refuse when the freshest "
                        "distar_distill_kl at the coordinator exceeds "
                        "this (the student drifted too far from the teacher)")
    p.add_argument("--player", default="", help="multiplexed gateways: player id")
    p.add_argument("--timeout-s", type=float, default=60.0)
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
    ctl = FleetRollout(gateway_map, timeout_s=args.timeout_s,
                       coordinator_addr=coordinator)
    player = args.player or None
    try:
        if args.command == "status":
            print(json.dumps(ctl.fleet_status(), default=str, indent=1))
            return 0
        if not args.version or not args.source:
            p.error(f"{args.command} requires --version and --source")
        if args.command == "rollout":
            verdict = ctl.rollout(args.version, source=args.source, player=player)
        elif args.command == "canary":
            addrs = [a for a in args.canary_addrs.split(",") if a.strip()]
            verdict = ctl.canary_start(args.version, addrs, args.canary_pct,
                                       source=args.source, player=player)
        else:  # promote
            gate = None
            addrs = [a for a in args.canary_addrs.split(",") if a.strip()]
            if addrs:
                gate = ctl.compare(addrs, max_divergence=args.max_divergence)
            verdict = ctl.promote(args.version, source=args.source,
                                  player=player, verdict=gate)
        print(json.dumps(verdict, default=str))
        return 0 if verdict.get("ok") else 1
    finally:
        ctl.close()


if __name__ == "__main__":
    raise SystemExit(main())
