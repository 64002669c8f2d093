"""The port's fleet health (``distar_tpu_torch.obs``: the time-series store,
the rulebook and its evaluator, the telemetry shipper and ingest, the
flight recorder and the HTTP routes) against the JAX package's, on the CPU.

Almost all of it is host code with no RNG, so wherever time can be pinned
the two are held EQUAL: the same ``record``/``record_snapshot`` script with
pinned ``ts`` (and a pinned wall clock for ``age_s`` and the ``points``
window) gives the same queries, points, sources and stats; the rulebook is
equal field by field for every subset of roles; scripted
``evaluate_once(now=...)`` passes give the same transitions and alerts; a
message one package's shipper sends ingests into the other's store, in
process and over each package's coordinator, to the same series; the same
GET script answers the same status codes and bodies (wall-clock fields
aside) from both coordinators and both serve frontends; ``tools/opsctl.py
status`` exits alike against both; and flight bundles carry the same keys
(their ``versions`` name each package's stack). Then every test of
tests/test_obs_health.py, run on the port, and the roles that dump a
bundle on SIGTERM, pinned as processes of both launchers.
"""
import json
import math
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from argparse import Namespace

import pytest
import torch  # noqa: F401 - loaded in every process of the port: flight bundles name its version

from distar_tpu import obs as jobs
from distar_tpu.comm import CoordinatorServer as JCoordinatorServer
from distar_tpu_torch import obs
from distar_tpu_torch.comm import CoordinatorServer
from distar_tpu_torch.obs import (
    FleetHealth,
    FlightRecorder,
    HealthEvaluator,
    HealthRule,
    MetricsRegistry,
    TelemetryIngest,
    TelemetryShipper,
    TimeSeriesStore,
    default_rulebook,
    set_fleet_health,
    set_flight_recorder,
    set_registry,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = 1_700_000_000.0
ROLES = ("learner", "actor", "coordinator", "trace", "serve", "replay", "distill", "arena")
#: the fields of a route's body that read the wall clock, or a host
WALL = ("ts", "age_s", "since_ts", "pid", "last_ts", "first_ts")


def same(a, b, path="") -> None:
    """Structural equality with NaN equal to NaN."""
    if isinstance(a, dict) and isinstance(b, dict):
        assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
        for k in a:
            same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        assert len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        pass
    else:
        assert a == b, (path, a, b)


def strip_wall(obj):
    """``obj`` without the fields that read the wall clock."""
    if isinstance(obj, dict):
        return {k: strip_wall(v) for k, v in obj.items() if k not in WALL}
    if isinstance(obj, list):
        return [strip_wall(v) for v in obj]
    return obj


@pytest.fixture
def registry():
    reg, jreg = MetricsRegistry(), jobs.MetricsRegistry()
    prev, jprev = set_registry(reg), jobs.set_registry(jreg)
    yield reg
    set_registry(prev)
    jobs.set_registry(jprev)


@pytest.fixture
def jregistry(registry):
    return jobs.get_registry()


@pytest.fixture
def recorder():
    rec, jrec = FlightRecorder(), jobs.FlightRecorder()
    prev, jprev = set_flight_recorder(rec), jobs.set_flight_recorder(jrec)
    yield rec
    set_flight_recorder(prev)
    jobs.set_flight_recorder(jprev)


@pytest.fixture
def fleet(registry, recorder):
    """A process fleet-health handle with fast cadences, not started (tests
    drive sampling and evaluation unless they start it)."""
    fh = FleetHealth(rules=default_rulebook(stall_window_s=0.6), registry=registry,
                     sample_interval_s=0.05, eval_interval_s=0.05, recorder=recorder)
    prev = set_fleet_health(fh)
    yield fh
    fh.stop()
    set_fleet_health(prev)


@pytest.fixture
def fleets(registry, recorder):
    """The port's and the JAX package's process fleet-health handles, on the
    same rulebook, not started."""
    fh = FleetHealth(rules=default_rulebook(), registry=registry, recorder=recorder)
    jfh = jobs.FleetHealth(rules=jobs.default_rulebook(), registry=jobs.get_registry(),
                           recorder=jobs.get_flight_recorder())
    prev, jprev = set_fleet_health(fh), jobs.set_fleet_health(jfh)
    yield fh, jfh
    fh.stop()
    jfh.stop()
    set_fleet_health(prev)
    jobs.set_fleet_health(jprev)


@pytest.fixture
def clock(monkeypatch):
    """The wall clock pinned at ``clock[0]`` (``age_s``, the ``points``
    window, ``since_ts``)."""
    now = [T0]
    monkeypatch.setattr(time, "time", lambda: now[0])
    return now


def _get(host, port, path):
    try:
        with urllib.request.urlopen(f"http://{host}:{port}{path}", timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


# ------------------------------------------------------- equal to the JAX package
def store_script(lib):
    """Writes and reads of one store: wraparound, labelled families, several
    sources, non-numeric snapshot values, the series cap and an eviction."""
    store = lib.TimeSeriesStore(points_per_series=4, max_series=6)
    out = {"recorded": []}
    for i in range(10):
        out["recorded"].append(store.record("distar_x_total", float(i), ts=T0 - 20 + i))
    for i, v in enumerate([5.0, 1.0, math.nan, 3.0]):
        store.record("distar_q_depth{token=a}", v, ts=T0 - 10 + i, source="co")
    store.record("distar_q_depth{token=b}", 7.0, ts=T0 - 10, source="co")
    out["snap"] = store.record_snapshot({"distar_env_steps_total": 4.0, "distar_loss": math.inf,
                                         "distar_note": "text", "distar_none": None},
                                        ts=T0 - 5, source="actor:1")
    out["snap2"] = store.record_snapshot({"distar_env_steps_total": 9.0, "distar_new_series": 1.0,
                                          "distar_another": 2.0}, ts=T0 - 1, source="actor:1")
    out["refused"] = store.record("distar_past_cap", 1.0, ts=T0)
    out["names"] = store.names()
    out["names_co"] = store.names("co")
    out["family"] = store.matching_names("distar_q_depth")
    out["family_co"] = store.matching_names("distar_q_depth", source="co")
    for name, window in (("distar_x_total", 100.0), ("distar_x_total", 1.5),
                         ("distar_q_depth{token=a}", 60.0), ("distar_q_depth{token=b}", 60.0),
                         ("distar_env_steps_total", 10.0), ("distar_loss", 10.0), ("nope", 10.0)):
        out[f"query {name} {window}"] = store.query(name, window_s=window)
    out["query source"] = store.query("distar_env_steps_total", window_s=60.0, source="actor:1")
    out["query wrong source"] = store.query("distar_env_steps_total", window_s=60.0, source="co")
    out["points"] = store.points("distar_x_total", window_s=15.0)
    out["points limit"] = store.points("distar_env_steps_total", window_s=60.0, limit=1)
    out["sources"] = store.sources()
    out["stats"] = store.stats()
    out["evicted"] = store.evict_source("co")
    out["sources after"] = store.sources()
    out["stats after"] = store.stats()
    out["refused after"] = store.record("distar_past_cap", 1.0, ts=T0)
    return out


def test_store_script_equals_jax(registry, clock):
    same(store_script(obs), store_script(jobs))
    got = store_script(obs)
    assert got["recorded"] == [True] * 10 and got["refused"] is False and got["refused after"] is True
    assert got["stats"]["dropped_series"] == 2 and got["evicted"] == 2
    assert registry.snapshot()["distar_obs_series_evicted_total"] == 4.0  # two scripts


def test_registry_sampler_equals_jax(registry, jregistry, clock):
    for reg in (registry, jregistry):
        reg.counter("distar_env_steps_total").inc(3)
        reg.gauge("distar_learner_loss").set(0.5)
        reg.histogram("distar_serve_request_latency_seconds").observe(0.25)
    stores = []
    for lib, reg in ((obs, registry), (jobs, jregistry)):
        store = lib.TimeSeriesStore()
        sampler = lib.RegistrySampler(store, registry=reg, source="me")
        counts = [sampler.sample_once(ts=T0), sampler.sample_once(ts=T0 + 1)]
        stores.append((counts, {n: store.query(n, window_s=10.0, source="me") for n in store.names()}))
    same(*stores)
    assert registry.snapshot()["distar_tsdb_samples_total"] == 2.0


def test_default_rulebook_equals_jax_for_every_role_subset():
    import itertools

    subsets = [c for r in range(len(ROLES) + 1) for c in itertools.combinations(ROLES, r)]
    for sub in subsets:
        assert [vars(r) for r in default_rulebook(sub)] == [vars(r) for r in jobs.default_rulebook(sub)], sub
    kw = dict(slo_e2e_s=3.0, queue_saturation=10.0, shed_rate_per_s=1.0, stall_window_s=2.0,
              slo_serve_latency_s=0.5)
    assert [vars(r) for r in default_rulebook(**kw)] == [vars(r) for r in jobs.default_rulebook(**kw)]
    assert len(subsets) == 256 and len(default_rulebook()) == 16


def evaluator_script(lib, registry, recorder):
    """Scripted passes over every op and aggregate, a family with several
    sources, debounce, recovery and a transition callback."""
    store = lib.TimeSeriesStore()
    rules = [
        lib.HealthRule(name="loss_nan", metric="distar_learner_loss", op="nonfinite", window_s=60.0,
                       for_count=2, clear_count=2),
        lib.HealthRule(name="step_stall", metric="distar_learner_iterations_total", op="stalled",
                       window_s=10.0, for_count=2, clear_count=2),
        lib.HealthRule(name="sat", metric="distar_coordinator_queue_depth", agg="last", op=">=",
                       threshold=384.0, for_count=1, severity="warning"),
        lib.HealthRule(name="kl_up", metric="distar_distill_kl", op="trending_up", threshold=0.0,
                       window_s=60.0, for_count=3),
        lib.HealthRule(name="shed", metric="distar_serve_shed_total", agg="rate", op=">", threshold=5.0,
                       window_s=30.0, for_count=1),
        lib.HealthRule(name="low", metric="distar_perf_mfu", agg="min", op="<", threshold=0.02,
                       source="learner:0", for_count=1),
        lib.HealthRule(name="mean_le", metric="distar_x", agg="mean", op="<=", threshold=1.0, for_count=1,
                       clear_count=1),
    ]
    seen = []
    ev = lib.HealthEvaluator(store, rules, recorder=recorder, registry=registry)
    ev.add_transition_callback(seen.append)
    ev.add_transition_callback(lambda e: 1 / 0)  # a broken callback never stops the watchdog
    out = []

    def feed(name, values, t0, source="local", dt=1.0):
        for i, v in enumerate(values):
            store.record(name, v, ts=t0 + i * dt, source=source)

    def step(now):
        out.append(ev.evaluate_once(now=now))
        out.append(ev.alerts())

    feed("distar_learner_loss", [0.5, 0.4, 0.3], T0)
    feed("distar_learner_iterations_total", [1, 2, 3], T0)
    feed("distar_coordinator_queue_depth{token=a}", [10.0, 10.0], T0, source="co")
    feed("distar_coordinator_queue_depth{token=b}", [400.0, 401.0], T0, source="co")
    feed("distar_coordinator_queue_depth{token=b}", [2.0, 3.0], T0, source="co2")
    feed("distar_distill_kl", [0.5, 0.6, 0.7], T0)
    feed("distar_serve_shed_total", [0.0, 100.0], T0)
    feed("distar_perf_mfu", [0.5, 0.01], T0, source="learner:0")
    feed("distar_perf_mfu", [0.001], T0, source="learner:1")
    feed("distar_x", [1.0, 1.0], T0)
    step(T0 + 3)
    feed("distar_learner_loss", [math.nan], T0 + 103)
    feed("distar_learner_iterations_total", [3, 3, 3], T0 + 100)
    feed("distar_distill_kl", [0.8, 0.9], T0 + 3)
    feed("distar_x", [5.0], T0 + 3)
    for k in range(3):
        step(T0 + 104 + k)
    feed("distar_learner_loss", [0.2, 0.2], T0 + 110)
    feed("distar_learner_iterations_total", [4, 5, 6], T0 + 110)
    feed("distar_distill_kl", [0.1], T0 + 110)
    for k in range(3):
        step(T0 + 113 + k)
    out.append(ev.overall_state())
    out.append(seen)
    out.append(recorder.events(kind="alert"))
    out.append(registry.snapshot())
    return out


def test_evaluator_transitions_and_alerts_equal_jax(registry, jregistry, recorder, clock):
    got = evaluator_script(obs, registry, recorder)
    want = evaluator_script(jobs, jregistry, jobs.get_flight_recorder())
    same(strip_wall(got[:-2]), strip_wall(want[:-2]))  # the events' seq and ts aside
    same([strip_wall({k: v for k, v in e.items() if k != "seq"}) for e in got[-2]],
         [strip_wall({k: v for k, v in e.items() if k != "seq"}) for e in want[-2]])
    same(got[-1], want[-1])
    firing = [e["rule"] for batch in got[:-4:2] for e in batch if e["state"] == "firing"]
    assert sorted(firing) == ["kl_up", "loss_nan", "low", "mean_le", "sat", "shed", "step_stall"]
    assert got[-4] == "firing"


def shipped_message(lib, registry, source="actor:1"):
    """One message a shipper of ``lib`` builds from ``registry``, with a
    trace record and an exemplar riding it."""
    registry.counter("distar_env_steps_total").inc(7)
    registry.gauge("distar_dataloader_occupancy").set(5.0)
    registry.histogram("distar_serve_request_latency_seconds").observe(0.5)
    buf = lib.TraceBuffer(random_one_in=1, registry=registry)
    buf.add({"trace_id": "t-1", "span_id": "s1", "name": "serve_request", "ts": T0, "dur_s": 0.1,
             "outcome": "ok", "hops": []})
    prev_buf, prev_ex = lib.set_trace_buffer(buf), lib.set_exemplar_store(lib.ExemplarStore())
    lib.note_exemplar("distar_serve_request_latency_seconds", "t-1", 0.5)
    try:
        return lib.TelemetryShipper(source, ingest=lib.TelemetryIngest(lib.TimeSeriesStore()),
                                    registry=registry, endpoint="127.0.0.1:9")._message()
    finally:
        lib.set_trace_buffer(prev_buf)
        lib.set_exemplar_store(prev_ex)


def folded(lib, fleet, msgs):
    """What a package's fleet store, trace store and exemplars hold after
    ingesting ``msgs``."""
    return {"series": {(s, n): fleet.store.query(n, window_s=60.0, source=s)
                       for s in fleet.store.sources() for n in fleet.store.names(s)},
            "sources": fleet.store.sources(), "traces": fleet.traces.query(limit=50),
            "stats": fleet.traces.stats(),
            "exemplar": lib.get_exemplar_store().lookup("distar_serve_request_latency_seconds_p99")}


@pytest.fixture
def exemplars():
    prev, jprev = obs.set_exemplar_store(obs.ExemplarStore()), jobs.set_exemplar_store(jobs.ExemplarStore())
    yield
    obs.set_exemplar_store(prev)
    jobs.set_exemplar_store(jprev)


def test_shipped_messages_ingest_across_packages_in_process(registry, jregistry, fleets, exemplars, clock):
    fh, jfh = fleets
    msgs = [shipped_message(obs, registry, "actor:port"), shipped_message(jobs, jregistry, "actor:jax")]
    same(strip_wall({k: v for k, v in msgs[0].items() if k != "source"}),
         strip_wall({k: v for k, v in msgs[1].items() if k != "source"}))
    for m in msgs:
        assert fh.ingest.ingest(m) == jfh.ingest.ingest(m)
    same(folded(obs, fh, msgs), folded(jobs, jfh, msgs))
    evicted = fh.ingest.evict_endpoint("127.0.0.1:9")
    assert evicted == jfh.ingest.evict_endpoint("127.0.0.1:9") > 0 and not fh.store.sources()
    same(folded(obs, fh, msgs), folded(jobs, jfh, msgs))


@pytest.mark.parametrize("shipper_lib, server_lib", [("port", "jax"), ("jax", "port"), ("port", "port")])
def test_shipped_messages_ingest_across_packages_over_http(registry, jregistry, fleets, exemplars,
                                                           shipper_lib, server_lib):
    """The wire: one package's shipper POSTs serialized snapshots to the
    other package's coordinator; the store it lands in equals what the
    same message ingested in process gives."""
    fh, jfh = fleets
    ship_mod, reg = (obs, registry) if shipper_lib == "port" else (jobs, jregistry)
    server_cls, target = (CoordinatorServer, fh) if server_lib == "port" else (JCoordinatorServer, jfh)
    registry.gauge("distar_dataloader_occupancy").set(5.0)
    jregistry.gauge("distar_dataloader_occupancy").set(5.0)
    srv = server_cls()
    srv.start()
    try:
        ship = ship_mod.TelemetryShipper("learner:MP0", coordinator_addr=(srv.host, srv.port), interval_s=99,
                                         registry=reg, endpoint="127.0.0.1:7")
        assert ship.ship_once() >= 1
        q = target.store.query("distar_dataloader_occupancy", source="learner:MP0", window_s=60.0)
        assert q["last"] == 5.0 and target.store.sources()["learner:MP0"]["age_s"] < 30.0
        assert reg.snapshot()["distar_telemetry_ships_total"] == 1.0
        # the server's lease eviction path reclaims the shipped source
        srv.coordinator.register("t", "127.0.0.1", 7)
        srv.coordinator.unregister("127.0.0.1", 7)
        assert "learner:MP0" not in target.store.sources()
    finally:
        srv.stop()


def test_shipper_loop_counts_errors_resyncs_and_recovers(registry, fleet):
    """A dead broker counts errors and never stalls the loop; the first ship
    after the outage counts a resync, as does a requested one."""
    ship = TelemetryShipper("actor:2", coordinator_addr=("127.0.0.1", 1), interval_s=0.05, registry=registry,
                            timeout_s=0.2).start()
    try:
        deadline = time.time() + 10
        while time.time() < deadline and not registry.snapshot().get("distar_telemetry_ship_errors_total"):
            time.sleep(0.05)
        assert registry.snapshot()["distar_telemetry_ship_errors_total"] >= 1
        srv = CoordinatorServer()
        srv.start()
        try:
            ship._addr = (srv.host, srv.port)
            assert obs.shipper.request_resync_all("heartbeat") >= 1
            deadline = time.time() + 20
            key = "distar_obs_shipper_resyncs_total{reason=heartbeat}"
            while time.time() < deadline and not registry.snapshot().get(key):
                time.sleep(0.05)
            snap = registry.snapshot()
            assert snap[key] == 1.0 and snap["distar_obs_shipper_resyncs_total{reason=recovered}"] == 1.0
            assert "actor:2" in fleet.store.sources()
            # an HA address list: the dead first address is rotated past
            from distar_tpu_torch.comm import ha
            from distar_tpu_torch.resilience import CommError

            listed = TelemetryShipper("actor:3", coordinator_addr=(f"127.0.0.1:1,{srv.host}:{srv.port}", None),
                                      interval_s=99, registry=registry)
            with pytest.raises(CommError):
                listed.ship_once()
            assert listed.ship_once() >= 1 and "actor:3" in fleet.store.sources()
            ha.reset_targets()
        finally:
            srv.stop()
    finally:
        ship.stop()


def route_script(host, port):
    paths = ["/healthz", "/alerts", "/timeseries", "/timeseries?name=distar_learner_loss&window_s=60",
             "/timeseries?name=distar_learner_loss&source=learner:0", "/timeseries?name=nope",
             "/timeseries?name=x&window_s=abc", "/traces", "/traces?name=serve_request&min_ms=10&limit=5",
             "/traces?outcome=error", "/trace/t-1", "/trace/none", "/healthz/", "/nothing"]
    out = []
    for p in paths:
        try:
            with urllib.request.urlopen(f"http://{host}:{port}{p}", timeout=10) as r:
                status, body = r.status, r.read()
        except urllib.error.HTTPError as e:
            status, body = e.code, e.read()
        out.append((p, status, strip_wall(json.loads(body)) if body else None))
    return out


def feed_fleet(fh):
    fh.ingest.ingest({"source": "learner:0", "ts": T0 - 5, "endpoint": "127.0.0.1:5",
                      "snapshot": {"distar_learner_loss": 0.5, "distar_learner_iterations_total": 3.0},
                      "traces": [{"trace_id": "t-1", "span_id": "a", "name": "serve_request", "ts": T0 - 6,
                                  "dur_s": 0.05, "outcome": "ok", "hops": []},
                                 {"trace_id": "t-1", "span_id": "b", "parent_span_id": "a",
                                  "name": "gateway", "ts": T0 - 5.99, "dur_s": 0.03, "outcome": "ok",
                                  "hops": [], "annot": {"queue_s": 0.01, "service_s": 0.02}}]})
    fh.ingest.ingest({"source": "learner:0", "ts": T0 - 1,
                      "snapshot": {"distar_learner_loss": math.nan, "distar_learner_iterations_total": 3.0}})
    for k in range(3):
        fh.evaluator.evaluate_once(now=T0 + k)


@pytest.mark.parametrize("surface", ["coordinator", "serve_frontend"])
def test_health_routes_answer_like_the_jax_packages(registry, recorder, fleets, clock, surface):
    """The same GET script against the port's and the JAX package's HTTP
    surface, over the same ingested fleet: the same status codes and bodies
    (wall-clock fields aside), 503 while a rule fires, 400 without a name,
    404 for an unknown trace."""
    fh, jfh = fleets
    feed_fleet(fh)
    feed_fleet(jfh)
    if surface == "coordinator":
        servers = [CoordinatorServer(), JCoordinatorServer()]
        for s in servers:
            s.start()
        stop = [s.stop for s in servers]
    else:
        from distar_tpu import serve as jserve
        from distar_tpu_torch import serve as pserve

        stop, servers = [], []
        for lib in (pserve, jserve):
            gw = lib.InferenceGateway(lib.MockModelEngine(2), max_delay_s=0.001).start()
            http = lib.ServeHTTPServer(gw).start()
            servers.append(http)
            stop += [http.stop, lambda gw=gw: gw.drain_and_stop(5.0)]
    try:
        got, want = (route_script(s.host, s.port) for s in servers)
    finally:
        for fn in stop:
            fn()
    same(got, want)
    status = {p: st for p, st, _ in got}
    assert status["/healthz"] == 503 and status["/timeseries"] == 400 and status["/trace/none"] == 404
    assert status["/timeseries?name=x&window_s=abc"] == 500 and status["/nothing"] == 404
    body = dict((p, b) for p, _, b in got)
    assert body["/healthz"]["firing"] == ["learner_loss_nonfinite", "learner_step_stall"]
    assert body["/trace/t-1"]["waterfall"]["critical_path"] == ["a", "b"]


def test_opsctl_status_exits_alike_against_both_coordinators(registry, recorder, fleets, capsys):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import opsctl
    finally:
        sys.path.pop(0)
    fh, jfh = fleets
    rcs = []
    for firing in (False, True):
        if firing:
            for f in fleets:
                f.ingest.ingest({"source": "learner:0", "ts": time.time(),
                                 "snapshot": {"distar_learner_loss": math.nan}})
                f.evaluator.evaluate_once()
                f.evaluator.evaluate_once()
        for cls in (CoordinatorServer, JCoordinatorServer):
            srv = cls()
            srv.start()
            try:
                rc = opsctl.cmd_status(Namespace(addr=f"{srv.host}:{srv.port}", replay_addrs=""))
            finally:
                srv.stop()
            rcs.append(rc)
        capsys.readouterr()
    assert rcs[0] == rcs[1] and rcs[2] == rcs[3] and rcs[0] != rcs[2], rcs


def test_flight_bundle_keys_equal_jax(registry, recorder, tmp_path, clock):
    paths = []
    for lib, rec, reg in ((obs, recorder, registry), (jobs, jobs.get_flight_recorder(), jobs.get_registry())):
        reg.counter("distar_env_steps_total").inc(3)
        rec.record("alert", rule="r", state="firing")
        paths.append(rec.dump(str(tmp_path / lib.__name__), reason="test", config={"a": 1},
                              extra={"note": "x"}))
    got, want = (json.load(open(p)) for p in paths)
    assert set(got) == set(want) == {"ts", "reason", "pid", "versions", "config", "events",
                                     "registry_snapshot", "note"}
    same({k: v for k, v in got.items() if k != "versions"}, {k: v for k, v in want.items() if k != "versions"})
    assert {"python", "platform", "torch", "numpy"} <= set(got["versions"]) and "jax" not in got["versions"]
    assert os.path.basename(paths[0]) == os.path.basename(paths[1])


# ------------------------------------------------- tests/test_obs_health.py on the port
def test_ring_buffer_wraparound_and_windowed_queries():
    store = TimeSeriesStore(points_per_series=4)
    t0 = 1000.0
    for i in range(10):
        store.record("distar_x_total", float(i), ts=t0 + i)
    q = store.query("distar_x_total", window_s=100.0)
    assert q["count"] == 4
    assert q["min"] == 6.0 and q["max"] == 9.0 and q["last"] == 9.0
    assert q["mean"] == pytest.approx(7.5)
    assert q["rate"] == pytest.approx(1.0)
    q2 = store.query("distar_x_total", window_s=1.5)
    assert q2["count"] == 2 and q2["min"] == 8.0
    assert store.query("nope") is None


def test_store_window_stats_and_family_matching():
    store = TimeSeriesStore()
    t0 = 2000.0
    for i, v in enumerate([5.0, 1.0, 3.0]):
        store.record("distar_q_depth{token=a}", v, ts=t0 + i)
    store.record("distar_q_depth{token=b}", 7.0, ts=t0)
    store.record("distar_other", 1.0, ts=t0)
    assert store.matching_names("distar_q_depth") == ["distar_q_depth{token=a}", "distar_q_depth{token=b}"]
    q = store.query("distar_q_depth{token=a}", window_s=100.0)
    assert (q["last"], q["min"], q["max"]) == (3.0, 1.0, 5.0)
    assert store.query("distar_q_depth{token=b}", window_s=100.0)["rate"] is None


def test_store_series_cap_refuses_new_series_only():
    store = TimeSeriesStore(points_per_series=8, max_series=2)
    assert store.record("a", 1.0)
    assert store.record("b", 1.0)
    assert not store.record("c", 1.0)
    assert store.record("a", 2.0)
    assert store.stats()["dropped_series"] == 1


def _feed(store, name, values, t0=1000.0, dt=1.0):
    for i, v in enumerate(values):
        store.record(name, v, ts=t0 + i * dt)


def test_rule_state_machine_debounce_nan_loss_and_stall(registry, recorder):
    store = TimeSeriesStore()
    rules = [
        HealthRule(name="loss_nan", metric="distar_learner_loss", op="nonfinite", for_count=2, clear_count=2),
        HealthRule(name="step_stall", metric="distar_learner_iterations_total", op="stalled", window_s=10.0,
                   for_count=2, clear_count=2),
    ]
    ev = HealthEvaluator(store, rules, recorder=recorder, registry=registry)
    _feed(store, "distar_learner_loss", [0.5, 0.4, 0.3])
    _feed(store, "distar_learner_iterations_total", [1, 2, 3])
    ev.evaluate_once()
    states = ev.alerts()["rules"]
    assert states["loss_nan"]["state"] == "ok" and states["step_stall"]["state"] == "ok"
    _feed(store, "distar_learner_loss", [float("nan")], t0=1103.0)
    _feed(store, "distar_learner_iterations_total", [3, 3, 3], t0=1100.0)
    ev.evaluate_once()
    states = ev.alerts()["rules"]
    assert states["loss_nan"]["state"] == "warning" and states["step_stall"]["state"] == "warning"
    ev.evaluate_once()
    ev.evaluate_once()
    alerts = ev.alerts()
    assert set(alerts["firing"]) == {"loss_nan", "step_stall"}
    firing_events = [e for e in alerts["history"] if e["state"] == "firing"]
    assert sorted(e["rule"] for e in firing_events) == ["loss_nan", "step_stall"]
    assert alerts["rules"]["loss_nan"]["fired_count"] == 1
    assert alerts["rules"]["step_stall"]["fired_count"] == 1
    assert math.isnan(alerts["rules"]["loss_nan"]["value"])
    assert alerts["rules"]["step_stall"]["value"] == 0.0
    _feed(store, "distar_learner_loss", [0.2, 0.2], t0=1110.0)
    _feed(store, "distar_learner_iterations_total", [4, 5, 6], t0=1110.0)
    ev.evaluate_once()
    assert ev.alerts()["rules"]["loss_nan"]["state"] == "firing"
    ev.evaluate_once()
    states = ev.alerts()["rules"]
    assert states["loss_nan"]["state"] == "ok" and states["step_stall"]["state"] == "ok"
    kinds = [e["kind"] for e in recorder.events()]
    assert kinds.count("alert") == len(ev.alerts()["history"])


#: a learner's shipped ``distar_learner_iterations_total`` (seconds from its
#: first ship, value) from a loaded host: eight ships of 0 while it waits
#: for the actor's first trajectories, then its two steps and its exit
WAITING_LEARNER = [(0.0, 0.0), (1.003, 0.0), (2.017, 0.0), (3.027, 0.0), (4.039, 0.0), (5.055, 0.0),
                   (6.122, 0.0), (7.135, 0.0), (8.144, 1.0), (8.775, 2.0)]


@pytest.mark.parametrize("lib_name", ["port", "jax"])
def test_stall_fires_on_a_learner_waiting_for_its_first_batch(lib_name, registry, recorder, clock):
    """The ships of a learner that waits for data, evaluated as the
    coordinator does (every 2 s, the stock rulebook): both packages fire
    ``learner_step_stall`` on the flat zeros and hold it firing until the
    second evaluation after the counter moves, so a ``/healthz`` read just
    after the learner's exit may still list it."""
    lib = {"port": obs, "jax": jobs}[lib_name]
    store = lib.TimeSeriesStore()
    ev = lib.HealthEvaluator(store, lib.default_rulebook(("learner",)),
                             registry=lib.get_registry(), recorder=lib.get_flight_recorder())
    states, ships, t = [], list(WAITING_LEARNER), 0.5
    while t < 14.0:
        while ships and ships[0][0] <= t:
            ts, v = ships.pop(0)
            store.record("distar_learner_iterations_total", v, ts=T0 + ts, source="learner:MP0:0")
        clock[0] = T0 + t
        ev.evaluate_once(now=T0 + t)
        states.append((t, ev.alerts()["rules"]["learner_step_stall"]["state"]))
        t += 2.0
    assert states == [(0.5, "ok"), (2.5, "warning"), (4.5, "warning"), (6.5, "firing"),
                      (8.5, "firing"), (10.5, "ok"), (12.5, "ok")], states


def test_rule_no_data_is_not_a_breach(registry):
    store = TimeSeriesStore()
    ev = HealthEvaluator(store, [HealthRule(name="r", metric="distar_never_registered", op="stalled")],
                         registry=registry)
    ev.evaluate_once()
    st = ev.alerts()["rules"]["r"]
    assert st["state"] == "ok" and st["no_data"]


def test_threshold_and_family_rules(registry):
    store = TimeSeriesStore()
    _feed(store, "distar_coordinator_queue_depth{token=a}", [10.0, 10.0])
    _feed(store, "distar_coordinator_queue_depth{token=b}", [400.0, 401.0])
    ev = HealthEvaluator(store, [HealthRule(name="sat", metric="distar_coordinator_queue_depth", agg="last",
                                            op=">=", threshold=384.0, for_count=1)], registry=registry)
    ev.evaluate_once()
    st = ev.alerts()["rules"]["sat"]
    assert st["state"] == "firing" and st["value"] == 401.0
    assert st["series"].endswith("{token=b}")


def test_shipper_roundtrip_in_process(registry):
    store = TimeSeriesStore()
    ingest = TelemetryIngest(store, registry=registry)
    registry.counter("distar_env_steps_total").inc(7)
    ship = TelemetryShipper("actor:1", ingest=ingest, interval_s=99, registry=registry)
    assert ship.ship_once() >= 1
    q = store.query("distar_env_steps_total", source="actor:1", window_s=60.0)
    assert q["last"] == 7.0
    assert "actor:1" in store.sources()


def test_shipper_roundtrip_through_serializer_and_coordinator(registry, fleet):
    registry.gauge("distar_dataloader_occupancy").set(5.0)
    srv = CoordinatorServer()
    srv.start()
    try:
        ship = TelemetryShipper("learner:MP0", coordinator_addr=(srv.host, srv.port), interval_s=99,
                                registry=registry)
        assert ship.ship_once() >= 1
        q = fleet.store.query("distar_dataloader_occupancy", source="learner:MP0", window_s=60.0)
        assert q["last"] == 5.0
        assert fleet.store.sources()["learner:MP0"]["age_s"] < 30.0
        assert registry.snapshot()["distar_telemetry_ships_total"] == 1.0
    finally:
        srv.stop()


def test_flight_recorder_ring_and_bundle_on_exception(tmp_path, registry, recorder):
    registry.counter("distar_env_steps_total").inc(3)
    for i in range(600):
        recorder.record("tick", i=i)
    assert len(recorder.events()) == 512
    assert recorder.events()[0]["i"] == 88
    recorder.install_crash_hook(str(tmp_path), config={"exp": "t"}, registry=registry, handle_sigterm=False)
    try:
        try:
            raise ValueError("injected crash")
        except ValueError:
            hook, prev = sys.excepthook, recorder._prev_excepthook
            recorder._prev_excepthook = lambda *a: None
            try:
                hook(*sys.exc_info())
            finally:
                recorder._prev_excepthook = prev
    finally:
        recorder.uninstall_crash_hook()
    with open(recorder.last_dump_path) as f:
        bundle = json.load(f)
    assert bundle["reason"] == "unhandled:ValueError"
    assert bundle["config"] == {"exp": "t"}
    assert bundle["registry_snapshot"]["distar_env_steps_total"] == 3.0
    assert "python" in bundle["versions"]
    crash = [e for e in bundle["events"] if e["kind"] == "crash"]
    assert len(crash) == 1 and "injected crash" in crash[0]["traceback"]


def test_injected_stall_and_nan_fire_exactly_one_alert_each_via_http(registry, recorder, fleet, tmp_path):
    srv = CoordinatorServer()
    srv.start()
    try:
        loss = registry.gauge("distar_learner_loss")
        iters = registry.counter("distar_learner_iterations_total")
        loss.set(0.5)
        for _ in range(3):
            iters.inc()
            fleet.sampler.sample_once()
            time.sleep(0.02)
        fleet.start()
        loss.set(float("nan"))
        deadline = time.time() + 20
        firing = []
        while time.time() < deadline:
            _status, alerts = _get(srv.host, srv.port, "/alerts")
            firing = alerts["firing"]
            if {"learner_loss_nonfinite", "learner_step_stall"} <= set(firing):
                break
            time.sleep(0.05)
        assert {"learner_loss_nonfinite", "learner_step_stall"} <= set(firing)
        time.sleep(0.3)
        _status, alerts = _get(srv.host, srv.port, "/alerts")
        for rule in ("learner_loss_nonfinite", "learner_step_stall"):
            assert alerts["rules"][rule]["fired_count"] == 1
            assert len([e for e in alerts["history"] if e["rule"] == rule and e["state"] == "firing"]) == 1
        status, hz = _get(srv.host, srv.port, "/healthz")
        assert status == 503 and hz["status"] == "firing"
        status, ts = _get(srv.host, srv.port, "/timeseries?name=distar_learner_loss&window_s=60")
        assert status == 200 and ts["points"]["local"]
        recorder.install_crash_hook(str(tmp_path), registry=registry, handle_sigterm=False)
        try:
            try:
                raise RuntimeError("simulated crash")
            except RuntimeError:
                prev = recorder._prev_excepthook
                recorder._prev_excepthook = lambda *a: None
                try:
                    sys.excepthook(*sys.exc_info())
                finally:
                    recorder._prev_excepthook = prev
        finally:
            recorder.uninstall_crash_hook()
        with open(recorder.last_dump_path) as f:
            bundle = json.load(f)
        alert_rules = {e.get("rule") for e in bundle["events"]
                       if e["kind"] == "alert" and e.get("state") == "firing"}
        assert {"learner_loss_nonfinite", "learner_step_stall"} <= alert_rules
        assert "distar_learner_iterations_total" in bundle["registry_snapshot"]
    finally:
        srv.stop()


def test_serve_frontend_answers_health_routes(registry, fleet):
    from distar_tpu_torch.serve import InferenceGateway, MockModelEngine, ServeHTTPServer

    gw = InferenceGateway(MockModelEngine(2), max_delay_s=0.001)
    gw.start()
    http = ServeHTTPServer(gw).start()
    try:
        fleet.sampler.sample_once()
        status, hz = _get(http.host, http.port, "/healthz")
        assert status == 200 and hz["status"] == "ok"
        status, alerts = _get(http.host, http.port, "/alerts")
        assert status == 200 and "rules" in alerts
        status, _err = _get(http.host, http.port, "/timeseries")
        assert status == 400
    finally:
        http.stop()
        gw.drain_and_stop(5.0)


def test_healthz_sources_staleness(registry, fleet):
    fleet.stale_after_s = 0.05
    fleet.ingest.ingest({"source": "actor:9", "ts": time.time() - 10.0,
                         "snapshot": {"distar_env_steps_total": 1.0}})
    assert fleet.healthz()["sources"]["actor:9"]["stale"] is True
    fleet.ingest.ingest({"source": "actor:9", "ts": time.time(), "snapshot": {"distar_env_steps_total": 2.0}})
    assert fleet.healthz()["sources"]["actor:9"]["stale"] is False


# -------------------------------------------------- the roles that dump on SIGTERM
#: role -> (extra flags, dumps a bundle on SIGTERM), the same in both launchers
SIGTERM_ROLES = {
    "coordinator": ((), True),
    "coordinator --arena-store": (("--arena-store", "{tmp}/arena.pkl"), False),
    "league": ((), False),
    "replay": (("--replay-spill-dir", "{tmp}/spill"), True),
}


def role_process(lib, role, tmp):
    flags, _ = SIGTERM_ROLES[role]
    module = "distar_tpu_torch.bin.rl_train" if lib == "port" else "distar_tpu.bin.rl_train"
    argv = [sys.executable, "-m", module, "--type", role.split()[0], "--port", "0", "--save-path", str(tmp),
            *[f.format(tmp=tmp) for f in flags]]
    if lib == "jax":
        argv += ["--platform", "cpu"]
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.Popen(argv, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env=env)


def test_sigterm_bundle_roles_are_the_jax_launchers(tmp_path):
    """Each role as a process of both launchers, SIGTERMed once serving: the
    same roles write a flight bundle (the signal event and a registry
    snapshot in it) under ``<save-path>/flight``; the port's roles exit 0."""
    procs = {}
    for lib in ("port", "jax"):
        for role in SIGTERM_ROLES:
            d = tmp_path / lib / role.replace(" ", "_").replace("-", "")
            d.mkdir(parents=True)
            procs[(lib, role)] = (role_process(lib, role, d), d)
    got = {}
    try:
        for (lib, role), (proc, d) in procs.items():
            lines = []
            deadline = time.time() + 120
            while time.time() < deadline:
                ln = proc.stdout.readline()
                lines.append(ln)
                if " serving on " in ln or not ln:
                    break
            assert any(" serving on " in ln for ln in lines), (lib, role, "".join(lines))
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=60)
            out = "".join(lines) + proc.stdout.read()
            if lib == "port":
                assert rc == 0, (role, out)
            bundles = sorted((d / "flight").glob("flight_*.json")) if (d / "flight").exists() else []
            got[(lib, role)] = bool(bundles)
            if bundles:
                bundle = json.load(open(bundles[0]))
                assert bundle["reason"] == f"signal:{int(signal.SIGTERM)}", bundle["reason"]
                assert [e for e in bundle["events"] if e["kind"] == "signal"]
                assert isinstance(bundle["registry_snapshot"], dict)
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for role, (_, dumps) in SIGTERM_ROLES.items():
        assert got[("port", role)] == got[("jax", role)] == dumps, (role, got)
