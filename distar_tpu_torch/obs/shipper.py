"""Telemetry shipping: fleet processes push registry snapshots to the broker.

Counterpart of ``distar_tpu.obs.shipper``, with its wire. The Prometheus
``/metrics`` route is pull-based and per process; following the
centralized-actor-telemetry design of SEED RL (PAPERS.md), every fleet
process instead runs a ``TelemetryShipper``: a background thread that
periodically snapshots the local ``MetricsRegistry`` and pushes the flat
dict to the coordinator through the comm serializer (``POST
/coordinator/telemetry`` with an ``application/x-distar-serialized`` body,
the data plane's pickle+LZ4 codec, byte for byte the JAX package's). The
coordinator's ``TelemetryIngest`` folds each message into the shared
``TimeSeriesStore`` as per-source series with last-seen tracking, and the
tail-sampled span records and latency exemplars riding it into the trace
store: one place that sees the whole fleet, which the rules engine
(``obs/health.py``) evaluates. Either package's shipper ships to either
package's coordinator.

Both ends also work in process (``ingest=`` instead of an address), so the
all-in-one launcher and the tests run the same path minus the socket.
"""
from __future__ import annotations

import threading
import time
import weakref
from typing import Optional, Tuple

from .registry import MetricsRegistry, get_registry
from .timeseries import TimeSeriesStore

SERIALIZED_CONTENT_TYPE = "application/x-distar-serialized"

# every running shipper in this process, so a broker restart/failover can
# nudge them all to re-ship immediately (weak: a dropped shipper unregisters
# itself by dying)
_ACTIVE_LOCK = threading.Lock()
_ACTIVE_SHIPPERS: "weakref.WeakSet" = weakref.WeakSet()


def request_resync_all(reason: str) -> int:
    """Ask every active shipper in this process to re-ship its full registry
    snapshot NOW (out of cycle) — called when discovery's heartbeat learns
    the broker lost our records (``reason="heartbeat"``) and when the HA
    client fails over to a new primary (``reason="failover"``). A restarted
    or newly-promoted broker would otherwise show every source stale until
    the next natural ship interval. Returns the number of shippers nudged."""
    with _ACTIVE_LOCK:
        shippers = list(_ACTIVE_SHIPPERS)
    for s in shippers:
        s.request_resync(reason)
    return len(shippers)


def _install_failover_hook() -> None:
    """Where the JAX package subscribes, once, to the HA client's
    coordinator failovers (``comm.ha.add_failover_listener``) so shippers
    resync the moment a new primary is adopted. The port has no HA client
    yet (``comm/ha.py``, ROADMAP Queue 1 item 11), so this subscribes
    nothing; discovery's heartbeat resync still reaches every shipper
    through ``request_resync_all``."""


class TelemetryIngest:
    """Coordinator-side sink: fold shipped snapshots into the fleet store.

    Messages may additionally carry ``traces`` (tail-sampled span records
    from the shipper process's ``TraceBuffer``) and ``exemplars`` (its
    latency-exemplar snapshot); both fold into the shared trace machinery
    (``obs/tracestore.py``) when a ``TraceIngest`` is attached, so the
    coordinator serves ``GET /traces`` for the whole fleet and its health
    rules can name offending trace_ids in alert events."""

    def __init__(self, store: TimeSeriesStore, registry: Optional[MetricsRegistry] = None,
                 traces=None):
        self.store = store
        self._registry = registry
        self.traces = traces  # Optional[tracestore.TraceIngest]
        # source -> the service endpoint ("ip:port") the shipper declared;
        # how coordinator lease evictions map back to TSDB sources
        self._endpoints: dict = {}
        self._lock = threading.Lock()

    def ingest(self, msg: dict) -> int:
        """Fold one shipped message ``{source, ts, snapshot, interval_s?,
        endpoint?, traces?, exemplars?}`` into per-source series; returns
        the number of scalars recorded. ``endpoint`` (the shipper's
        registered service address) links the source to its coordinator
        lease, so a lease eviction can reclaim the series
        (``evict_endpoint``) — and the source's traces with them."""
        if not isinstance(msg, dict) or not isinstance(msg.get("snapshot"), dict):
            raise ValueError("telemetry message must be {source, ts, snapshot}")
        source = str(msg.get("source") or "unknown")
        ts = float(msg.get("ts") or time.time())
        endpoint = msg.get("endpoint")
        if endpoint:
            with self._lock:
                self._endpoints[source] = str(endpoint)
        n = self.store.record_snapshot(msg["snapshot"], ts=ts, source=source)
        if self.traces is not None and msg.get("traces"):
            self.traces.ingest(source, msg["traces"])
        if msg.get("exemplars"):
            from .tracestore import get_exemplar_store

            get_exemplar_store().merge(msg["exemplars"])
        reg = self._registry or get_registry()
        reg.counter(
            "distar_telemetry_ingest_total", "shipped snapshots ingested", source=source
        ).inc()
        return n

    def evict_endpoint(self, endpoint: str) -> int:
        """A registered endpoint left the broker (lease expiry or graceful
        unregister): reclaim every TSDB series its shipped sources hold, so
        membership churn frees series-cap room instead of exhausting it.
        Returns the number of series evicted."""
        with self._lock:
            sources = [s for s, e in self._endpoints.items() if e == endpoint]
            for s in sources:
                del self._endpoints[s]
        if self.traces is not None:
            for s in sources:
                self.traces.evict_source(s)
        return sum(self.store.evict_source(s) for s in sources)

    def evict_source(self, source: str) -> int:
        """Direct source eviction (callers that track membership themselves,
        e.g. the autoscaler's member probes)."""
        with self._lock:
            self._endpoints.pop(source, None)
        if self.traces is not None:
            self.traces.evict_source(source)
        return self.store.evict_source(source)

    def sources(self) -> dict:
        return self.store.sources()


class TelemetryShipper:
    """Background thread pushing registry snapshots to the coordinator.

    ``coordinator_addr=(host, port)`` ships over HTTP with the comm
    serializer as the body codec; ``ingest=TelemetryIngest`` short-circuits
    in-process. Shipping is best-effort: a dead broker counts an error and
    the loop keeps going — telemetry must never take the fleet down with it.
    """

    def __init__(self, source: str,
                 coordinator_addr: Optional[Tuple[str, int]] = None,
                 ingest: Optional[TelemetryIngest] = None,
                 interval_s: float = 5.0,
                 registry: Optional[MetricsRegistry] = None,
                 timeout_s: float = 5.0,
                 endpoint: Optional[str] = None):
        assert (coordinator_addr is None) != (ingest is None), \
            "exactly one of coordinator_addr / ingest"
        assert interval_s > 0
        if coordinator_addr is not None and (
                coordinator_addr[1] is None or "," in str(coordinator_addr[0])):
            raise NotImplementedError(
                f"telemetry to a coordinator address list {coordinator_addr[0]!r}: the HA "
                "client (comm/ha.py) is not ported yet (ROADMAP Queue 1 item 11)")
        self.source = str(source)
        self.interval_s = interval_s
        self._addr = coordinator_addr
        self._ingest = ingest
        self._registry = registry
        self._timeout_s = timeout_s
        #: the service endpoint ("ip:port") this process registered under a
        #: coordinator lease, if any — stamped on every message so the
        #: broker can reclaim this source's series when the lease goes
        self.endpoint = endpoint
        self._stop = threading.Event()
        self._wake = threading.Event()  # out-of-cycle ship trigger (resync)
        self._pending_lock = threading.Lock()
        self._resync_reasons: list = []
        self._thread: Optional[threading.Thread] = None

    def request_resync(self, reason: str) -> None:
        """Schedule an immediate full-snapshot ship (every ship already IS a
        full registry snapshot — a resync is simply an out-of-cycle one) and
        count it under ``distar_obs_shipper_resyncs_total{reason}`` once it
        lands."""
        with self._pending_lock:
            if reason not in self._resync_reasons:
                self._resync_reasons.append(reason)
        self._wake.set()

    # ------------------------------------------------------------------- wire
    def _message(self) -> dict:
        reg = self._registry or get_registry()
        msg = {
            "source": self.source,
            "ts": time.time(),
            "interval_s": self.interval_s,
            "snapshot": reg.snapshot(),
        }
        if self.endpoint:
            msg["endpoint"] = self.endpoint
        # tail-sampled trace records + latency exemplars ride the same
        # periodic push (best-effort like the rest of telemetry: a lost
        # POST loses the batch, never blocks the role)
        from .tracestore import get_exemplar_store, get_trace_buffer

        traces = get_trace_buffer().unshipped()
        if traces:
            msg["traces"] = traces
        exemplars = get_exemplar_store().snapshot()
        if exemplars:
            msg["exemplars"] = exemplars
        return msg

    def ship_once(self) -> int:
        """Snapshot + push one message; returns scalars shipped. Raises on
        transport failure (the loop catches; direct callers see the error)."""
        msg = self._message()
        reg = self._registry or get_registry()
        if self._ingest is not None:
            n = self._ingest.ingest(msg)
        else:
            # lazy comm import: obs must stay importable without the comm
            # package fully initialised (comm itself imports obs)
            import urllib.error
            import urllib.request

            from ..comm import serializer
            from ..resilience import CommError

            host, port = self._addr
            req = urllib.request.Request(
                f"http://{host}:{port}/coordinator/telemetry",
                data=serializer.dumps(msg),
                headers={"Content-Type": SERIALIZED_CONTENT_TYPE},
                method="POST",
            )
            try:
                with urllib.request.urlopen(req, timeout=self._timeout_s) as resp:
                    reply = resp.read()
                import json

                decoded = json.loads(reply)
            except (urllib.error.URLError, ConnectionError, TimeoutError,
                    OSError, ValueError) as e:
                raise CommError(
                    f"telemetry ship @ {host}:{port} failed: {e!r}",
                    op="telemetry_ship", cause=e,
                ) from e
            if decoded.get("code") != 0:
                raise RuntimeError(f"telemetry ingest rejected: {decoded!r}")
            n = int(decoded.get("info") or 0)
        reg.counter(
            "distar_telemetry_ships_total", "snapshots shipped to the coordinator"
        ).inc()
        return n

    # ---------------------------------------------------------------- control
    def start(self) -> "TelemetryShipper":
        if self._thread is not None:
            return self
        self._stop.clear()

        def run():
            from ..resilience import (
                CircuitBreaker, CircuitOpenError, CommError, RetryPolicy, retry_call,
            )

            reg = self._registry or get_registry()
            errors = reg.counter(
                "distar_telemetry_ship_errors_total", "failed telemetry pushes"
            )
            # quick in-tick retry for blips; the breaker turns a dead broker
            # into cheap fail-fast ticks (no connect timeout per interval)
            # until it answers again — shipping must never stall the role
            policy = RetryPolicy(max_attempts=2, backoff_base_s=0.2,
                                 deadline_s=self._timeout_s)
            breaker = CircuitBreaker(op="telemetry_ship",
                                     reset_after_s=4 * self.interval_s)
            prev_failed = False
            while True:
                self._wake.wait(self.interval_s)
                self._wake.clear()
                if self._stop.is_set():
                    break
                with self._pending_lock:
                    reasons, self._resync_reasons = self._resync_reasons, []
                try:
                    retry_call(self.ship_once, op="telemetry_ship",
                               policy=policy, breaker=breaker)
                    if prev_failed and "recovered" not in reasons:
                        # first successful ship after an outage is itself a
                        # resync: the broker just regained this source
                        reasons.append("recovered")
                    prev_failed = False
                    for reason in reasons:
                        reg.counter(
                            "distar_obs_shipper_resyncs_total",
                            "full-snapshot re-ships after broker restart "
                            "or failover", reason=reason,
                        ).inc()
                except (CommError, CircuitOpenError):
                    errors.inc()
                    prev_failed = True
                except Exception:
                    # anything else (rejected ingest, codec bug): counted,
                    # never propagated — telemetry must not take the fleet
                    # down with it
                    errors.inc()
                    prev_failed = True
                if prev_failed and reasons:
                    # a requested resync is still owed: re-queue it so the
                    # next successful ship counts it
                    with self._pending_lock:
                        for reason in reasons:
                            if reason not in self._resync_reasons:
                                self._resync_reasons.append(reason)

        self._thread = threading.Thread(target=run, daemon=True, name="obs-shipper")
        self._thread.start()
        with _ACTIVE_LOCK:
            _ACTIVE_SHIPPERS.add(self)
        if self._addr is not None:
            _install_failover_hook()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        with _ACTIVE_LOCK:
            _ACTIVE_SHIPPERS.discard(self)
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
