"""The port's fleet trace store and waterfall against the JAX package's, on
the CPU: ``TraceIngest`` bounded per source and evicted with the source,
equal to the JAX store on one script; shipped traces leaving with their
member; a firing alert naming its exemplar trace; ``build_waterfall``,
``render_waterfall`` and ``render_listing`` equal on the JAX tests' records
(and on a mixed tree with orphans, retries, skew and failures); then the
acceptance drill of tests/test_trace_fleet.py on the port's stack: two
gateway processes (one slowed) ship their spans to the port's coordinator,
a slow request's waterfall is retrieved from ``/trace/<id>`` (and through
the JAX package's ``tools/opsctl.py trace``), and the latency rule fires off
shipped telemetry with an exemplar that resolves.
"""
import json
import os
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

from distar_tpu import obs as jobs
from distar_tpu_torch import obs
from distar_tpu_torch.obs import (
    ExemplarStore,
    FlightRecorder,
    MetricsRegistry,
    TraceBuffer,
    TraceIngest,
    build_waterfall,
    render_listing,
    render_waterfall,
    set_exemplar_store,
    set_flight_recorder,
    set_registry,
    set_trace_buffer,
    set_tracing,
)
from distar_tpu_torch.obs.tracestore import _listing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _tracing_on():
    prev = set_tracing(True)
    yield
    set_tracing(prev)


@pytest.fixture
def registry():
    reg, jreg = MetricsRegistry(), jobs.MetricsRegistry()
    prev, jprev = set_registry(reg), jobs.set_registry(jreg)
    yield reg
    set_registry(prev)
    jobs.set_registry(jprev)


@pytest.fixture
def buffer(registry):
    buf = TraceBuffer(random_one_in=1)
    prev = set_trace_buffer(buf)
    yield buf
    set_trace_buffer(prev)


@pytest.fixture
def exemplars(registry):
    store = ExemplarStore()
    prev = set_exemplar_store(store)
    yield store
    set_exemplar_store(prev)


@pytest.fixture
def recorder():
    rec = FlightRecorder()
    prev = set_flight_recorder(rec)
    yield rec
    set_flight_recorder(prev)


def _count(registry, name, **labels):
    return registry.counter(name, **labels).value


def ingest_script(lib, registry):
    ing = lib.TraceIngest(max_per_source=4, max_sources=2, registry=registry)
    recs = [{"trace_id": f"t{i}", "span_id": f"s{i}", "name": "n" if i % 2 else "m", "ts": float(i),
             "dur_s": 0.01 * i, "outcome": "ok" if i != 3 else "shed", **({"skew": True} if i == 5 else {})}
            for i in range(6)]
    out = [ing.ingest("a", recs), ing.stats(), ing.ingest("b", recs[:2] + ["junk", {"no": "id"}]),
           ing.ingest("c", recs[:3]), ing.ingest("b", "not a list")]
    out += [ing.query(), ing.query(name="n"), ing.query(min_ms=10.0), ing.query(outcome="shed"),
            ing.query(limit=2), ing.get("t1"), ing.get("t5"), ing.get("none")]
    out += [ing.evict_source("a"), ing.evict_source("zzz"), ing.stats(), ing.query()]
    return out, registry.snapshot()


def test_trace_ingest_equals_jax(registry):
    assert ingest_script(obs, registry) == ingest_script(jobs, jobs.get_registry())
    assert ingest_script(obs, MetricsRegistry())[0][0] == 6


def test_trace_ingest_bounded_and_evicted(registry):
    ing = TraceIngest(max_per_source=4, max_sources=2, registry=registry)
    recs = [{"trace_id": f"t{i}", "span_id": f"s{i}", "name": "n", "ts": float(i), "dur_s": 0.01 * i,
             "outcome": "ok"} for i in range(6)]
    assert ing.ingest("a", recs) == 6
    assert ing.stats()["records"] == 4
    assert _count(registry, "distar_tracebuf_dropped_total", reason="evicted") == 2
    ing.ingest("b", recs[:2])
    assert ing.ingest("c", recs[:3]) == 0
    assert _count(registry, "distar_tracebuf_dropped_total", reason="ingest_cap") == 3
    assert ing.evict_source("a") == 4
    assert ing.stats()["sources"] == 1
    rows = ing.query(min_ms=10.0)
    assert all(r["dur_ms"] >= 10.0 for r in rows)
    spans = ing.get("t1")
    assert spans and spans[0]["source"] == "b"


def test_shipped_traces_evicted_with_member_departure(registry):
    from distar_tpu_torch.obs import TelemetryIngest, TimeSeriesStore

    traces = TraceIngest(registry=registry)
    ingest = TelemetryIngest(TimeSeriesStore(), registry=registry, traces=traces)
    ingest.ingest({"source": "gw-1", "ts": time.time(), "snapshot": {"distar_x": 1.0},
                   "endpoint": "127.0.0.1:9999",
                   "traces": [{"trace_id": "t1", "span_id": "s1", "name": "serve_request", "ts": 0.0,
                               "dur_s": 0.1, "outcome": "ok"}]})
    assert traces.get("t1")
    assert ingest.evict_endpoint("127.0.0.1:9999") >= 1
    assert traces.get("t1") == []
    assert traces.stats()["sources"] == 0


def test_alert_event_names_exemplar_trace(registry, exemplars, recorder):
    from distar_tpu_torch.obs import FleetHealth, HealthRule

    fh = FleetHealth(rules=[HealthRule(name="lat_slo", metric="distar_serve_request_latency_seconds_p99",
                                       agg="last", op=">", threshold=0.01, window_s=60.0, for_count=1)],
                     registry=registry, recorder=recorder)
    exemplars.note("distar_serve_request_latency_seconds", "deadbeef01020304", 0.5)
    fh.store.record("distar_serve_request_latency_seconds_p99", 0.5, source="gw")
    events = fh.evaluator.evaluate_once()
    firing = [e for e in events if e["state"] == "firing"]
    assert firing and firing[0]["exemplar_trace_id"] == "deadbeef01020304"
    alerts = recorder.events(kind="alert")
    assert alerts and alerts[-1]["exemplar_trace_id"] == "deadbeef01020304"


# ------------------------------------------------------------ waterfall analyzer
T = 1000.0
CLIENT_SERVER = [
    {"trace_id": "T", "span_id": "c", "name": "serve_client", "ts": T, "dur_s": 0.100, "outcome": "ok",
     "hops": [], "source": "client"},
    {"trace_id": "T", "span_id": "g", "parent_span_id": "c", "name": "serve_request", "ts": T + 0.010,
     "dur_s": 0.080, "outcome": "ok", "hops": [], "annot": {"queue_s": 0.050, "service_s": 0.030},
     "source": "gw"},
]
SKEWED = [
    {"trace_id": "T", "span_id": "a", "name": "client", "ts": 100.0, "dur_s": 0.01, "outcome": "ok", "hops": []},
    {"trace_id": "T", "span_id": "b", "parent_span_id": "a", "name": "server", "ts": 99.0, "dur_s": 0.005,
     "outcome": "ok", "hops": []},
]
MIXED = [
    {"trace_id": "M", "span_id": "r", "name": "trajectory", "ts": T, "dur_s": 0.5, "outcome": "ok",
     "hops": [{"hop": "adapter_push"}, {"hop": "learner_pull"}], "pid": 11},
    {"trace_id": "M", "span_id": "p", "parent_span_id": "r", "name": "replay_insert", "ts": T + 0.1,
     "dur_s": 0.2, "outcome": "ok", "hops": [], "annot": {"blocked_s": 0.05, "retry_s": 0.02}, "source": "rs"},
    {"trace_id": "M", "span_id": "q", "parent_span_id": "r", "name": "sample", "ts": T + 0.31, "dur_s": 0.15,
     "outcome": "error", "hops": [], "source": "learner"},
    {"trace_id": "M", "span_id": "x", "parent_span_id": "q", "name": "deep", "ts": T + 0.32, "dur_s": 0.2,
     "outcome": "shed", "hops": [], "source": "learner"},
    {"trace_id": "M", "span_id": "o", "parent_span_id": "missing", "name": "orphan", "ts": T + 0.2,
     "dur_s": 0.01, "outcome": "ok", "hops": [], "skew": True},
    {"no": "span_id"},
    "garbage",
]


@pytest.mark.parametrize("records", [CLIENT_SERVER, SKEWED, MIXED, []], ids=["client_server", "skewed",
                                                                          "mixed", "empty"])
def test_waterfall_and_renders_equal_jax(records):
    report = build_waterfall(records)
    assert report == jobs.build_waterfall(records)
    if records:
        assert render_waterfall(report) == jobs.render_waterfall(report)
        assert render_waterfall(report, width=8) == jobs.render_waterfall(report, width=8)
    rows = [_listing(r, "src") for r in records if isinstance(r, dict) and "trace_id" in r]
    assert rows == [jobs.tracestore._listing(r, "src") for r in records if isinstance(r, dict) and "trace_id" in r]
    assert render_listing(rows) == jobs.render_listing(rows)


def test_waterfall_decomposition_and_critical_path():
    report = build_waterfall(CLIENT_SERVER)
    assert report["trace_id"] == "T" and not report["skewed"]
    assert report["critical_path"] == ["c", "g"]
    seg = {(s["name"], s["kind"]): s["seconds"] for s in report["segments"]}
    assert seg[("serve_request", "queue")] == pytest.approx(0.050)
    assert seg[("serve_request", "service")] == pytest.approx(0.030)
    assert seg[("serve_client", "network/other")] == pytest.approx(0.020, abs=1e-6)
    md = render_waterfall(report)
    assert "serve_request" in md and "critical path" in md
    assert report["segments"][0]["kind"] == "queue"


def test_waterfall_flags_skewed_child():
    assert build_waterfall(SKEWED)["skewed"] is True
    assert build_waterfall(MIXED)["skewed"] is True
    assert build_waterfall(MIXED)["critical_path"] == ["r", "p"]


def test_kept_spans_and_span_errors_reach_the_flight_recorder(registry, buffer, exemplars, recorder):
    ctx = obs.start_trace("trajectory")
    obs.mark_hop(ctx, "adapter_push")
    obs.finish_trace(ctx)
    with pytest.raises(RuntimeError):
        with obs.Span("collate", trace=ctx):
            raise RuntimeError("x")
    span = recorder.events(kind="span")
    assert span and span[-1]["trace_id"] == ctx["trace_id"] and "adapter_push" in span[-1]["hops"]
    err = recorder.events(kind="span_error")
    assert err and err[-1]["error"] == "RuntimeError" and err[-1]["trace_id"] == ctx["trace_id"]


# --------------------------------------------------------------- E2E acceptance
def test_e2e_two_gateway_fleet_waterfall_and_exemplar_alert(registry, buffer, exemplars, recorder, tmp_path):
    """Two gateway processes of the port (one slowed), a coordinator of the
    port: client spans (this process) and gateway spans (shipped over
    telemetry) join under one trace id in the coordinator's trace store; a
    slow request's waterfall comes back from ``/trace/<id>`` and from the
    JAX package's ``opsctl trace``; the latency rule fires off shipped
    telemetry with an exemplar that resolves."""
    from distar_tpu_torch.comm.coordinator import CoordinatorServer
    from distar_tpu_torch.obs import HealthRule, get_exemplar_store, init_fleet_health, set_fleet_health
    from distar_tpu_torch.serve.fleet import FleetClient, GatewayMap

    prev_fleet = set_fleet_health(None)
    fleet_health = init_fleet_health(rules=[HealthRule(
        name="serve_latency_slo", metric="distar_serve_request_latency_seconds_p99", agg="last", op=">",
        threshold=0.01, window_s=120.0, for_count=2, summary="serving SLO breached")],
        start=False, registry=registry)
    coord = CoordinatorServer()
    coord.start()
    caddr = f"{coord.host}:{coord.port}"
    procs, addrs = [], []
    try:
        for delay in (0.0, 0.03):  # the second gateway is the slow one
            proc = subprocess.Popen(
                [sys.executable, "-m", "distar_tpu_torch.serve.fleet.gateway_proc", "--port", "0",
                 "--http-port", "0", "--slots", "16", "--mock-delay-s", str(delay), "--coordinator", caddr,
                 "--telemetry-interval-s", "0.5", "--lease-s", "60", "--trace-keep-one-in", "1"],
                cwd=REPO, stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
                env={**os.environ, "DISTAR_TRACE": "1"})
            parts = proc.stdout.readline().split()
            assert parts and parts[0] == "SERVE-GATEWAY", parts
            addrs.append(f"{parts[1]}:{parts[2]}")
            procs.append(proc)
        obs_tree = {"x": np.zeros((4, 4), np.float32)}
        fc = FleetClient(gateway_map=GatewayMap.parse(",".join(addrs)), timeout_s=15.0)
        # a request is slow by the gateway that served it (the session's
        # pin), not by the client's clock: on a loaded host a request to
        # the fast gateway can take 20 ms too
        slow_tids, fast = [], 0
        for i in range(20):
            sid = f"e2e-{i}"
            slowed = fc.router.gateway_for(sid) == addrs[1]
            for _step in range(2):
                t0 = time.perf_counter()
                out = fc.act(sid, obs_tree)
                if slowed:
                    assert time.perf_counter() - t0 >= 0.03, "the slowed gateway answered inside its delay"
                    slow_tids.append(out["trace_id"])
                else:
                    fast += 1
            fc.end(sid)
        assert slow_tids, "no slow requests against the slowed gateway"
        assert fast, "no fast requests: the other gateway served nothing"
        fc.close()
        deadline = time.time() + 20.0
        joined = None
        while time.time() < deadline and joined is None:
            joined = next((tid for tid in slow_tids if fleet_health.traces.get(tid)), None)
            time.sleep(0.25)
        assert joined, "no slow trace's gateway span ever shipped"

        with urllib.request.urlopen(f"http://{caddr}/trace/{joined}", timeout=10) as resp:
            body = json.loads(resp.read())
        names = {s["name"] for s in body["spans"]}
        assert "serve_client" in names and "serve_request" in names
        assert len({s["trace_id"] for s in body["spans"]}) == 1
        assert {s["source"] for s in body["spans"]} >= {"local"} and len({s["source"] for s in body["spans"]}) == 2
        wf = body["waterfall"]
        assert "service" in {s["kind"] for s in wf["segments"]}
        assert wf["critical_path"][0] == next(s["span_id"] for s in body["spans"] if s["name"] == "serve_client")
        gw_span = next(s for s in body["spans"] if s["name"] == "serve_request")
        assert "service_s" in (gw_span.get("annot") or {})
        with urllib.request.urlopen(f"http://{caddr}/traces?min_ms=20&limit=200", timeout=10) as resp:
            listed = json.loads(resp.read())
        assert joined in {r["trace_id"] for r in listed["traces"]}
        sources = {r["source"] for r in listed["traces"]} - {"local"}
        assert any(s.startswith("gateway:") for s in sources)

        env = {"PYTHONPATH": ".", "PATH": "/usr/bin:/bin:/usr/local/bin", "JAX_PLATFORMS": "cpu",
               "HOME": str(tmp_path)}
        shown = subprocess.run([sys.executable, "tools/opsctl.py", "trace", "--addr", caddr, "--id", joined],
                               capture_output=True, text=True, timeout=60, env=env, cwd=REPO)
        assert shown.returncode == 0, shown.stdout + shown.stderr
        assert "serve_request" in shown.stdout and "critical path" in shown.stdout

        deadline = time.time() + 15.0
        while time.time() < deadline and get_exemplar_store().lookup(
                "distar_serve_request_latency_seconds_p99") is None:
            time.sleep(0.25)
        deadline = time.time() + 15.0
        firing = []
        while time.time() < deadline and not firing:
            firing = [e for e in fleet_health.evaluator.evaluate_once() if e["state"] == "firing"]
            if not firing:
                time.sleep(0.5)
        assert firing, "latency SLO alert never fired off shipped telemetry"
        exemplar = firing[0].get("exemplar_trace_id")
        assert exemplar, "firing alert carries no exemplar trace_id"
        with urllib.request.urlopen(f"http://{caddr}/trace/{exemplar}", timeout=10) as resp:
            assert json.loads(resp.read())["spans"]
        gateways = {s for s in fleet_health.store.sources() if s.startswith("gateway:")}
        assert len(gateways) == 2, fleet_health.store.sources()
    finally:
        for proc in procs:
            try:
                proc.stdin.close()
                proc.wait(timeout=10)
            except Exception:  # noqa: BLE001 - reaped below
                proc.kill()
        coord.stop()
        fleet_health.stop()
        set_fleet_health(prev_fleet)
