"""The port's coordinator HA (``distar_tpu_torch.comm.ha``) against the JAX
package's, on the CPU.

* A counterpart of each test of tests/test_coordinator_ha.py: address
  parsing, the journal (snapshots, compaction, a torn tail, a corrupt
  record, a corrupt snapshot), the monotonic lease sweep and re-aged
  replays, ambiguous-ack typing, epoch fencing, ``not_leader`` redirects,
  failover listeners, the route sets (``tools/lint_ha_routes.py`` run
  unedited over the port's files), the shipper's resync, an HA pair failing
  over end to end and a cold restart replaying the journal.
* Parity: one scripted sequence of routes (register, heartbeat, ask,
  strike, unregister, arena_report and the four ``league_*`` routes) goes
  through a journaled JAX coordinator and a journaled port coordinator
  over HTTP, with the record clock taken from the script; after a cold
  restart of each, ``state_snapshot()``, the arena's ratings and payoff
  and the league's ``state_digest`` are equal. A journal directory the JAX
  ``HAState`` wrote (a snapshot holding JAX league objects and the records
  after it) replays in the port to the JAX replay's state.
* The HA pair as processes: ``rl_train --type coordinator --journal-dir``
  as primary and ``--ha-role standby``, a client on the address list, the
  primary SIGKILLed, the standby promoted and serving what was acked.
"""
import os
import shutil
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from distar_tpu import arena as jarena
from distar_tpu import obs as jobs
from distar_tpu.comm import Coordinator as JCoordinator
from distar_tpu.comm import CoordinatorServer as JCoordinatorServer
from distar_tpu.comm import coordinator as jcoord
from distar_tpu.comm import ha as jha
from distar_tpu.league import runtime as jruntime
from distar_tpu.league.runtime import runner as jrunner
from distar_tpu.league.runtime import service as jservice
from distar_tpu_torch import arena as parena
from distar_tpu_torch import obs as pobs
from distar_tpu_torch.comm import Coordinator, CoordinatorServer, coordinator_request, discovery, ha
from distar_tpu_torch.comm import coordinator as coordinator_mod
from distar_tpu_torch.league import runtime as pruntime
from distar_tpu_torch.league.runtime import runner as prunner
from distar_tpu_torch.league.runtime import service as pservice
from distar_tpu_torch.resilience import CommError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
ROSTER = ("MP0", "EP0", "ME0")


@pytest.fixture(autouse=True)
def _fresh_targets():
    ha.reset_targets()
    jha.reset_targets()
    yield
    ha.reset_targets()
    jha.reset_targets()


@pytest.fixture
def registry():
    preg, jreg = pobs.MetricsRegistry(), jobs.MetricsRegistry()
    pprev, jprev = pobs.set_registry(preg), jobs.set_registry(jreg)
    yield preg
    pobs.set_registry(pprev)
    jobs.set_registry(jprev)


@pytest.fixture
def hosted():
    """The process-global arena-store and league-service slots of both
    packages, cleared on teardown."""
    yield
    for lib in (parena, jarena):
        lib.set_arena_store(None)
    for lib in (pruntime, jruntime):
        lib.set_league_service(None)


# ------------------------------------------------------------- address parsing
def test_parse_addrs_forms():
    assert ha.parse_addrs("h1:1,h2:2") == (("h1", 1), ("h2", 2))
    assert ha.parse_addrs("h1:1") == (("h1", 1),)
    assert ha.parse_addrs(("h1", 9)) == (("h1", 9),)
    assert ha.parse_addrs([("a", 1), "b:2"]) == (("a", 1), ("b", 2))
    assert ha.parse_addrs(":7") == (("127.0.0.1", 7),)  # default host
    with pytest.raises(ValueError):
        ha.parse_addrs("")
    with pytest.raises(ValueError):
        ha.parse_addrs("a:1,b:x")  # a list that does not parse raises
    assert ha.format_addrs((("a", 1), ("b", 2))) == "a:1,b:2"
    for spec in ("h1:1,h2:2", ("h1", 9), [("a", 1), "b:2"], ":7"):
        assert ha.parse_addrs(spec) == jha.parse_addrs(spec)


def test_discovery_norm_addr():
    assert discovery._norm_addr(("h", 5)) == ("h", 5)
    assert discovery._norm_addr("h:5") == ("h", 5)
    # HA comma specs come back with port=None, the request layer's marker
    assert discovery._norm_addr("a:1,b:2") == ("a:1,b:2", None)
    assert discovery._norm_addr(("a:1,b:2", None)) == ("a:1,b:2", None)


# ------------------------------------------------------------------ journaling
def test_journal_roundtrip_snapshot_and_compaction(tmp_path):
    root = str(tmp_path / "j")
    j = ha.Journal(root, snapshot_every=4)
    for i in range(3):
        j.append("register", {"token": "t", "ip": f"10.0.0.{i}", "port": i})
    j.snapshot({"state": {"marker": 3}})
    for i in range(3, 6):
        j.append("register", {"token": "t", "ip": f"10.0.0.{i}", "port": i})
    j.close()

    j2 = ha.Journal(root)
    base, records = j2.recover()
    assert base is not None and base["state"]["marker"] == 3
    # only the tail after the snapshot replays; seq continues where it left off
    assert [r["body"]["port"] for r in records] == [3, 4, 5]
    assert j2.seq == 6
    # the JAX package reads the port's directory the same way
    jbase, jrecords = jha.Journal(root).recover()
    assert jbase == base and jrecords == records
    # compaction keeps at most the two newest snapshots
    j2.snapshot({"state": 1})
    j2.snapshot({"state": 2})
    j2.snapshot({"state": 3})
    snaps = [f for f in os.listdir(root) if f.startswith("snap.")]
    assert len(snaps) <= 2
    j2.close()


def test_journal_torn_tail_discarded(tmp_path):
    root = str(tmp_path / "j")
    j = ha.Journal(root)
    j.append("register", {"token": "t", "ip": "a", "port": 1})
    j.append("register", {"token": "t", "ip": "b", "port": 2})
    j.close()
    seg = sorted(p for p in os.listdir(root) if p.startswith("wal."))[0]
    path = os.path.join(root, seg)
    # tear the last record mid-payload: the crash-before-ack shape
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 3)
    base, records = ha.Journal(root).recover()
    assert base is None
    assert [r["body"]["ip"] for r in records] == ["a"]


def test_journal_corrupt_record_stops_scan(tmp_path):
    root = str(tmp_path / "j")
    j = ha.Journal(root)
    j.append("register", {"token": "t", "ip": "a", "port": 1})
    size_after_first = os.path.getsize(os.path.join(root, sorted(os.listdir(root))[0]))
    j.append("register", {"token": "t", "ip": "b", "port": 2})
    j.close()
    path = os.path.join(root, sorted(os.listdir(root))[0])
    # flip a payload bit inside the second record: the CRC mismatch stops
    # the scan there without touching the first record
    with open(path, "r+b") as f:
        f.seek(size_after_first + ha._FRAME.size + 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))
    _, records = ha.Journal(root).recover()
    assert [r["body"]["ip"] for r in records] == ["a"]


def test_journal_corrupt_snapshot_raises(tmp_path):
    root = str(tmp_path / "j")
    j = ha.Journal(root)
    j.append("register", {"token": "t", "ip": "a", "port": 1})
    j.snapshot({"state": 1})
    j.close()
    snap = [p for p in os.listdir(root) if p.startswith("snap.")][0]
    with open(os.path.join(root, snap), "r+b") as f:
        f.seek(8)
        f.write(b"\xff\xff")
    with pytest.raises(ha.JournalCorruptError):
        ha.Journal(root).recover()
    # a coordinator does not start empty on it either
    with pytest.raises(ha.JournalCorruptError):
        ha.HAState(Coordinator(), root, role="primary", arena_store_fn=lambda: None).boot()


# -------------------------------------------------- monotonic lease regression
class _WallJump:
    """time-module shim: the wall clock jumped ``offset_s`` into the future,
    the monotonic clock untouched: the clock step lease sweeping must
    ignore."""

    def __init__(self, offset_s: float):
        self._offset = offset_s

    def time(self):
        return time.time() + self._offset

    def __getattr__(self, name):
        return getattr(time, name)


def test_lease_sweep_survives_wall_clock_jump(monkeypatch):
    co = Coordinator(default_lease_s=1000.0)
    co.register("svc", "10.0.0.1", 1)
    # a 2-hour step forward: wall-clock leases would evict everything
    monkeypatch.setattr(coordinator_mod, "time", _WallJump(7200.0))
    co._last_sweep = float("-inf")  # defeat the sweep's rate limit
    assert [r["ip"] for r in co.peers("svc")] == ["10.0.0.1"]
    # eviction still works on monotonic passage
    co._leases["10.0.0.1:1"] = time.monotonic() - 1.0
    co._last_sweep = float("-inf")
    assert co.peers("svc") == []


def test_replayed_lease_is_reaged_not_refreshed():
    co = Coordinator(default_lease_s=30.0)
    # replaying a record journaled 29 s ago leaves ~1 s of lease, not 30
    co.apply_register("svc", "10.0.0.1", 1, record_ts=time.time() - 29.0)
    remaining = co._leases["10.0.0.1:1"] - time.monotonic()
    assert 0.0 < remaining < 2.0
    # and one whose lease already lapsed during the outage is born expired
    co.apply_register("svc", "10.0.0.2", 2, record_ts=time.time() - 60.0)
    assert co._leases["10.0.0.2:2"] < time.monotonic()
    co._last_sweep = float("-inf")
    assert {r["ip"] for r in co.peers("svc")} == {"10.0.0.1"}
    # a replayed heartbeat is re-aged the same way
    co.apply_heartbeat("10.0.0.1", 1, record_ts=time.time() - 10.0)
    assert 18.0 < co._leases["10.0.0.1:1"] - time.monotonic() < 21.0


# ------------------------------------------------------- ambiguous-ack typing
def test_is_ambiguous_classification():
    # a refused or unresolvable connection never carried the request
    assert not ha.is_ambiguous(ConnectionRefusedError())
    assert not ha.is_ambiguous(CommError("x", cause=ConnectionRefusedError()))
    err = CommError("x")
    err.__cause__ = ConnectionRefusedError()
    assert not ha.is_ambiguous(err)
    # timeouts, resets and truncated replies may have been applied
    assert ha.is_ambiguous(TimeoutError())
    assert ha.is_ambiguous(CommError("x", cause=TimeoutError()))
    assert ha.is_ambiguous(CommError("x"))


def test_failover_idempotent_retried_once_nonidempotent_typed(monkeypatch):
    calls = []

    def flaky_once(host, port, route, body, timeout):
        calls.append((host, port))
        if len(calls) == 1:
            # a death mid-flight: ambiguous (not a refused connection)
            raise CommError("reset", cause=TimeoutError())
        return {"code": 0, "info": True, "epoch": 1}

    monkeypatch.setattr(coordinator_mod, "_coordinator_request_once", flaky_once)
    # an idempotent route: the ambiguous failure rotates and is retried,
    # exactly one more attempt, on the standby
    r = coordinator_request("a:1,b:2", None, "register", {"token": "t", "ip": "x", "port": 1})
    assert r["code"] == 0
    assert calls == [("a", 1), ("b", 2)]

    # a non-idempotent draw (``ask``, ``league_ask``): the same failure
    # raises typed instead of retrying into a possible second pop
    for route in ("ask", "league_ask"):
        calls.clear()
        ha.reset_targets()
        with pytest.raises(ha.AmbiguousAckError) as ei:
            coordinator_request("a:1,b:2", None, route, {"token": "t"})
        assert len(calls) == 1
        assert ei.value.route == route


def test_failover_refused_connection_is_not_ambiguous(monkeypatch):
    calls = []

    def down_then_up(host, port, route, body, timeout):
        calls.append((host, port))
        if host == "a":
            raise CommError("refused", cause=ConnectionRefusedError())
        return {"code": 0, "info": None, "epoch": 1}

    monkeypatch.setattr(coordinator_mod, "_coordinator_request_once", down_then_up)
    # ``ask`` against a dead primary is safe to retry: the request never
    # left this process, so the pop cannot have been applied
    r = coordinator_request("a:1,b:2", None, "ask", {"token": "t"})
    assert r["code"] == 0 and calls == [("a", 1), ("b", 2)]


# --------------------------------------------------------------- epoch fencing
def test_stale_epoch_reply_is_fenced(monkeypatch):
    targets = ha.targets_for(ha.parse_addrs("a:1,b:2"))
    targets.note_epoch(5)

    def deposed(host, port, route, body, timeout):
        return {"code": 0, "info": [], "epoch": 3}

    monkeypatch.setattr(coordinator_mod, "_coordinator_request_once", deposed)
    with pytest.raises(ha.StaleEpochError):
        coordinator_mod._failover_request_once(targets, "peers", {}, 5.0)
    # the deposed answerer was rotated away from
    assert targets.active() == ("b", 2)


def test_not_leader_redirect_follows_hint(monkeypatch):
    targets = ha.targets_for(ha.parse_addrs("a:1,b:2"))

    def standby(host, port, route, body, timeout):
        return {"code": 2, "info": "not_leader", "leader": "b:2", "epoch": 4}

    monkeypatch.setattr(coordinator_mod, "_coordinator_request_once", standby)
    with pytest.raises(ha.NotLeaderError):
        coordinator_mod._failover_request_once(targets, "peers", {}, 5.0)
    assert targets.active() == ("b", 2)
    assert targets.max_epoch == 4


def test_failover_notifies_listeners():
    targets = ha.targets_for(ha.parse_addrs("a:1,b:2"))
    hits = []
    listener = hits.append
    ha.add_failover_listener(listener)
    try:
        targets.rotate(("a", 1))
    finally:
        ha.remove_failover_listener(listener)
    assert hits and hits[0] is targets


# ----------------------------------------------------------- route-set lint
def test_lint_ha_routes_clean(monkeypatch):
    """``tools/lint_ha_routes.py`` unedited over the port: its
    ``server_routes`` and ``route_sets`` read the port's files, and the
    port's route sets are the JAX package's."""
    sys.path.insert(0, TOOLS)
    try:
        import lint_ha_routes
    finally:
        sys.path.remove(TOOLS)
    co_py = os.path.join(REPO, "distar_tpu_torch", "comm", "coordinator.py")
    ha_py = os.path.join(REPO, "distar_tpu_torch", "comm", "ha.py")
    routes, sets = lint_ha_routes.server_routes(co_py), lint_ha_routes.route_sets(ha_py)
    assert routes == lint_ha_routes.server_routes() and sets == lint_ha_routes.route_sets()
    monkeypatch.setattr(lint_ha_routes, "server_routes", lambda: routes)
    monkeypatch.setattr(lint_ha_routes, "route_sets", lambda: sets)
    assert lint_ha_routes.lint() == []


def test_route_sets_invariants():
    assert not (ha.JOURNALED_ROUTES & ha.EPHEMERAL_ROUTES)
    assert ha.DURABLE_ROUTES <= ha.JOURNALED_ROUTES
    assert "ask" not in ha.IDEMPOTENT_ROUTES and "league_ask" not in ha.IDEMPOTENT_ROUTES
    for name in ("JOURNALED_ROUTES", "EPHEMERAL_ROUTES", "DURABLE_ROUTES", "IDEMPOTENT_ROUTES", "LEAD_ROUTE"):
        assert getattr(ha, name) == getattr(jha, name), name


# ------------------------------------------------------------ shipper resync
def test_shipper_resync_counted():
    from distar_tpu_torch.obs import MetricsRegistry, TelemetryIngest, TelemetryShipper, TimeSeriesStore
    from distar_tpu_torch.obs import shipper as shipper_mod

    reg = MetricsRegistry()
    reg.counter("x_total", "seed one counter so snapshots are non-empty").inc()
    ingest = TelemetryIngest(TimeSeriesStore())
    s = TelemetryShipper("t-ha", ingest=ingest, interval_s=60.0, registry=reg)
    s.start()
    try:
        assert shipper_mod.request_resync_all("heartbeat") >= 1
        c = reg.counter("distar_obs_shipper_resyncs_total",
                        "full-snapshot re-ships after broker restart or failover", reason="heartbeat")
        deadline = time.time() + 5.0
        while c.value < 1 and time.time() < deadline:
            time.sleep(0.05)
        assert c.value >= 1, "resync never shipped/counted"
        # the failover hook (installed by a shipper given an address): a
        # client-side rotation resyncs every shipper
        shipper_mod._install_failover_hook()
        targets = ha.targets_for(ha.parse_addrs("a:1,b:2"))
        targets.rotate(("a", 1))
        f = reg.counter("distar_obs_shipper_resyncs_total",
                        "full-snapshot re-ships after broker restart or failover", reason="failover")
        deadline = time.time() + 5.0
        while f.value < 1 and time.time() < deadline:
            time.sleep(0.05)
        assert f.value >= 1, "the failover hook did not resync"
    finally:
        s.stop()


def test_shipper_ships_to_the_primary_of_an_address_list(tmp_path, registry):
    """``TelemetryShipper`` given an address list ships to its believed
    primary and follows a standby's ``not_leader`` hint."""
    from distar_tpu_torch.obs import MetricsRegistry, TelemetryShipper

    co1, srv1, ha1 = _spawn("primary", 0, str(tmp_path / "j1"))
    addr1 = f"127.0.0.1:{srv1.port}"
    co2, srv2, ha2 = _spawn("standby", 0, str(tmp_path / "j2"), peers=[addr1])
    addr2 = f"127.0.0.1:{srv2.port}"
    try:
        reg = MetricsRegistry()
        reg.counter("x_total", "seed").inc()
        ship = TelemetryShipper("ha-src", coordinator_addr=(f"{addr2},{addr1}", None), interval_s=60.0,
                                registry=reg)
        with pytest.raises(CommError, match="not_leader"):
            ship.ship_once()  # the standby answers first, with its hint
        assert ha.targets_for(ha.parse_addrs(f"{addr2},{addr1}")).active() == ("127.0.0.1", srv1.port)
        assert ship.ship_once() == 1
        assert reg.snapshot()["distar_telemetry_ships_total"] == 1.0
    finally:
        for srv, st in ((srv1, ha1), (srv2, ha2)):
            srv.stop()
            st.stop()


# ------------------------------------------------- end-to-end warm standby
def _spawn(role, port, journal_dir, peers=(), grace=0.8):
    co = Coordinator(default_lease_s=5.0)
    srv = CoordinatorServer(coordinator=co, port=port)
    state = ha.HAState(co, journal_dir, advertise=f"127.0.0.1:{srv.port}", role=role, peers=list(peers),
                       takeover_grace_s=grace, arena_store_fn=lambda: None)
    state.boot()
    srv.attach_ha(state)
    srv.start()
    return co, srv, state


def test_ha_pair_failover_end_to_end(tmp_path):
    co1, srv1, ha1 = _spawn("primary", 0, str(tmp_path / "j1"))
    addr1 = f"127.0.0.1:{srv1.port}"
    co2, srv2, ha2 = _spawn("standby", 0, str(tmp_path / "j2"), peers=[addr1])
    addr2 = f"127.0.0.1:{srv2.port}"
    spec = f"{addr1},{addr2}"
    try:
        time.sleep(0.3)
        # replies are stamped with epoch and role; the standby replicates
        # before the ack
        r = coordinator_request(spec, None, "register", {"token": "t", "ip": "10.0.0.1", "port": 1})
        assert r["code"] == 0 and r["role"] == "primary"
        assert int(r["epoch"]) >= 1
        deadline = time.time() + 2.0
        while not co2.peers("t") and time.time() < deadline:
            time.sleep(0.05)
        assert co2.peers("t"), "standby did not replicate the register"

        # a standby addressed directly answers the typed not_leader envelope
        host, port = addr2.split(":")
        reply = coordinator_mod._coordinator_request_once(host, int(port), "register",
                                                          {"token": "x", "ip": "z", "port": 9}, 5.0)
        assert reply["code"] == 2 and reply["info"] == "not_leader"
        assert reply["leader"] == addr1
        # its GET /coordinator/ha says so too
        st = ha.probe_ha_status(addr2)
        assert st["role"] == "standby" and st["leader"] == addr1 and st["seq"] == ha2.journal.seq

        # a pop on the primary; the pop itself replicates (no resurrection)
        got = coordinator_request(spec, None, "ask", {"token": "t"})
        assert got["info"]["ip"] == "10.0.0.1"
        coordinator_request(spec, None, "register", {"token": "t", "ip": "10.0.0.2", "port": 2})

        # the SIGKILL shape: stop the primary without a parting snapshot
        epoch_before = ha2.epoch
        srv1.stop()
        ha1._stop.set()
        deadline = time.time() + 10.0
        while ha2.role != "primary" and time.time() < deadline:
            time.sleep(0.05)
        assert ha2.role == "primary", "standby never promoted"
        assert ha2.epoch > epoch_before

        # the address-list client follows leadership with no code change
        r = coordinator_request(spec, None, "peers", {"token": "t"})
        assert r["role"] == "primary"
        assert [p["ip"] for p in r["info"]] == ["10.0.0.2"]
    finally:
        for srv, st in ((srv1, ha1), (srv2, ha2)):
            try:
                srv.stop()
            except Exception:
                pass
            st.stop()


def test_cold_restart_replays_journal_exactly(tmp_path):
    root = str(tmp_path / "j")
    co1, srv1, ha1 = _spawn("primary", 0, root)
    spec = f"127.0.0.1:{srv1.port}"
    try:
        host, port = spec.split(":")
        for i in range(4):
            coordinator_request(host, int(port), "register", {"token": "q", "ip": f"10.1.0.{i}", "port": i})
        got = coordinator_request(host, int(port), "ask", {"token": "q"})
        assert got["info"]["ip"] == "10.1.0.0"
    finally:
        srv1.stop()
        ha1._stop.set()  # crash-stop: no final snapshot

    co2 = Coordinator(default_lease_s=5.0)
    ha2 = ha.HAState(co2, root, advertise="127.0.0.1:1", role="primary", arena_store_fn=lambda: None)
    ha2.boot()
    try:
        ips = [r["ip"] for r in co2.peers("q")]
        assert ips == ["10.1.0.1", "10.1.0.2", "10.1.0.3"], "replay must rebuild the queue minus the acked pop"
        # the restarted primary leads a new epoch (fencing the old one out)
        assert ha2.epoch > ha1.epoch - 1
    finally:
        ha2.stop()


# ------------------------------------------------------- parity with the JAX HA
class ScriptClock:
    """Stands for the ``time`` module where the coordinator, the journal
    and the league service read it: wall and monotonic time are the
    script's, so both packages journal and replay the same record times."""

    def __init__(self, now: float = 1.7e9, mono: float = 1000.0):
        self.now, self.mono = now, mono

    def time(self):
        return self.now

    def monotonic(self):
        return self.mono

    def step(self, s: float = 1.0):
        self.now += s
        self.mono += s

    def __getattr__(self, name):
        return getattr(time, name)


PACKAGES = {
    "port": dict(co=Coordinator, server=CoordinatorServer, request=coordinator_request, ha=ha,
                 arena=parena, runtime=pruntime, runner=prunner),
    "jax": dict(co=JCoordinator, server=JCoordinatorServer, request=jcoord.coordinator_request, ha=jha,
                arena=jarena, runtime=jruntime, runner=jrunner),
}


@pytest.fixture
def clock(monkeypatch):
    c = ScriptClock()
    for mod in (coordinator_mod, jcoord, ha, jha, pservice, jservice):
        monkeypatch.setattr(mod, "time", c)
    return c


def _control_plane(lib):
    """A fresh broker, arena store and league service of ``lib``, the
    store and service hosted (the process's own)."""
    pk = PACKAGES[lib]
    store = pk["arena"].ArenaStore()
    pk["arena"].set_arena_store(store)
    np.random.seed(5)
    service = pk["runtime"].LeagueService(pk["runner"].league_cfg(ROSTER), seed=7, lease_s=5.0, job_ttl_s=60.0)
    pk["runtime"].set_league_service(service)
    return pk["co"](default_lease_s=30.0), store, service


def _boot(lib, root, co, store, service):
    st = PACKAGES[lib]["ha"].HAState(co, root, role="primary", arena_store_fn=lambda: store,
                                     league_service_fn=lambda: service)
    return st.boot()


def _route_script(lib, call, clock, snapshot=None):
    """The scripted routes through ``call(route, body)``, the clock one
    second on before each; ``snapshot()`` (when given) runs halfway.
    Returns the replies."""
    replies = []

    def go(route, body):
        clock.step()
        replies.append((route, call(route, body)))
        return replies[-1][1]

    go("register", {"token": "actor", "ip": "10.0.0.1", "port": 1, "meta": {"k": 1}, "lease_s": 20.0})
    go("register", {"token": "actor", "ip": "10.0.0.2", "port": 2})
    go("register", {"token": "replay_shard", "ip": "10.0.0.3", "port": 3, "lease_s": 4.0})
    go("heartbeat", {"ip": "10.0.0.1", "port": 1, "lease_s": 25.0})
    go("ask", {"token": "actor"})
    go("ask", {"token": "none"})  # empty: not journaled
    for _ in range(2):
        go("strike", {"ip": "10.0.0.2", "port": 2})
    go("unregister", {"ip": "10.0.0.3", "port": 3})
    matches = [{"key": f"a{i}", "home": "MP0:1", "away": "idle", "round": 0,
                "winner": ("home", "away", "draw")[i % 3], "game_steps": 5 + i, "duration_s": 0.1} for i in range(4)]
    go("arena_report", {"matches": matches})
    go("arena_report", {"matches": matches[:2]})  # a resend: duplicates
    for i, pid in enumerate(ROSTER):
        go("league_register", {"player_id": pid, "learner_id": f"L{i}"})
    if snapshot is not None:
        snapshot()
    for i, pid in enumerate(ROSTER):
        job = go("league_ask", {"player_id": pid, "learner_id": f"L{i}"})["info"]
        ms = [{"key": f"{job['job_id']}e{e}", "home": pid, "away": job["player_ids"][1], "round": 0,
               "winner": ("home", "away", "draw")[(i + e) % 3], "game_steps": 9 + e, "duration_s": 0.5}
              for e in range(2)]
        go("league_report", {"job_id": job["job_id"], "learner_id": f"L{i}", "matches": ms})
    for i, pid in enumerate(ROSTER):
        go("league_train_info", {"player_id": pid, "learner_id": f"L{i}", "seq": 0, "train_steps": 3,
                                 "generation_path": f"/ckpt/{pid}_g0.ckpt"})
    go("league_train_info", {"player_id": "MP0", "learner_id": "L0", "seq": 0, "train_steps": 3})  # dup seq
    go("heartbeat", {"ip": "10.0.0.1", "port": 1})
    return replies


def _state(co, store, service):
    return {"coordinator": co.state_snapshot(), "ratings": store.ratings_snapshot(),
            "payoff": store.payoff_snapshot(), "league": service.state_digest()}


def _run_journaled(lib, root, clock, snapshot_at_half=False):
    """The route script through a journaled coordinator of ``lib`` over
    HTTP, then a crash-stop (no parting snapshot). Returns the replies and
    the live state."""
    pk = PACKAGES[lib]
    co, store, service = _control_plane(lib)
    srv = pk["server"](coordinator=co, port=0)
    st = _boot(lib, root, co, store, service)
    srv.attach_ha(st)
    srv.start()
    try:
        def call(route, body):
            reply = pk["request"]("127.0.0.1", srv.port, route, body)
            assert reply["code"] == 0 and reply["role"] == "primary", reply
            return reply

        snap = (lambda: st.journal.snapshot(st._state_blob())) if snapshot_at_half else None
        replies = _route_script(lib, call, clock, snapshot=snap)
        live = _state(co, store, service)
    finally:
        srv.stop()
        st.stop()  # the journal closed, no parting snapshot
    return replies, live


def _cold_restart(lib, root):
    co, store, service = _control_plane(lib)
    st = _boot(lib, root, co, store, service)
    try:
        return _state(co, store, service)
    finally:
        st.stop()


def test_route_script_replays_to_the_jax_state(tmp_path, clock, registry, hosted):
    """The same routes through a journaled JAX and port coordinator give
    the same replies; after a cold restart of each, the broker snapshot,
    the arena's ratings and payoff and the league digest are equal (and
    the restarted broker holds what the live one did)."""
    got = {}
    for lib in ("port", "jax"):
        clock.now, clock.mono = 1.7e9, 1000.0
        replies, live = _run_journaled(lib, str(tmp_path / lib), clock)
        clock.step(2.0)
        got[lib] = (replies, live, _cold_restart(lib, str(tmp_path / lib)))
    (preplies, plive, prestart), (jreplies, jlive, jrestart) = got["port"], got["jax"]
    assert [(r, {k: v for k, v in p.items() if k != "epoch"}) for r, p in preplies] == \
        [(r, {k: v for k, v in p.items() if k != "epoch"}) for r, p in jreplies]
    assert prestart == jrestart
    assert plive == jlive
    for side in (prestart, plive):
        assert side["coordinator"]["strikes"] == {"10.0.0.2:2": 2}
        assert side["ratings"] == plive["ratings"] and side["league"] == plive["league"]
    # the reference's replay re-ages each lease from its record's time: by
    # the restart 10.0.0.1's registered lease (20 s) has lapsed, so the
    # replayed heartbeat's sweep evicts it and the replayed ``ask`` pops
    # 10.0.0.2, which the live broker still holds (kept in the port,
    # ROADMAP Queue 3)
    assert [r["ip"] for r in plive["coordinator"]["records"]["actor"]] == ["10.0.0.2"]
    assert prestart["coordinator"]["records"] == {}
    assert plive["league"]["job_seq"] == 3 and len(plive["league"]["minted"]) == 3
    assert plive["ratings"]["duplicates_total"] >= 2


def test_a_jax_written_journal_replays_in_the_port(tmp_path, clock, registry, hosted):
    """A journal directory the JAX ``HAState`` wrote (a snapshot with the
    JAX package's league and arena objects halfway, the records after it)
    boots the port's ``HAState`` to the state the JAX replay reaches."""
    root = str(tmp_path / "jax")
    _, live = _run_journaled("jax", root, clock, snapshot_at_half=True)
    assert any(f.startswith("snap.") for f in os.listdir(root))
    clock.step(2.0)
    shutil.copytree(root, str(tmp_path / "copy"))
    want = _cold_restart("jax", str(tmp_path / "copy"))
    got = _cold_restart("port", root)
    assert got == want
    assert got["league"] == live["league"] and got["ratings"] == live["ratings"]


def test_apply_record_routes_like_the_jax_one(registry, hosted):
    """``apply_record`` outside an ``HAState``: broker routes, an arena
    report into the given store, league routes through the given service
    with the record's clock, ``__lead__`` and unknown routes skipped (the
    skip counted), as in the JAX package."""
    out = {}
    for lib in ("port", "jax"):
        pk = PACKAGES[lib]
        co, store, service = _control_plane(lib)
        t0 = round(time.time())
        recs = [{"route": "register", "ts": t0, "body": {"token": "t", "ip": "a", "port": 1}},
                {"route": "__lead__", "ts": t0, "body": {"epoch": 3}},
                {"route": "arena_report", "ts": t0 + 1, "body": {"matches": [
                    {"key": "k", "home": "MP0:1", "away": "idle", "round": 0, "winner": "home",
                     "game_steps": 3, "duration_s": 0.1}]}},
                {"route": "league_register", "ts": t0 + 2, "body": {"player_id": "MP0", "learner_id": "L"}},
                {"route": "league_ask", "ts": t0 + 3, "body": {"player_id": "MP0", "learner_id": "L"}},
                {"route": "nope", "ts": t0 + 4, "body": {}}]
        for rec in recs:
            pk["ha"].apply_record(co, rec, arena_store=store, league_service=service)
        snap = (pobs if lib == "port" else jobs).get_registry().snapshot()
        out[lib] = ([r["ip"] for r in co.peers("t")], store.matches_total, service.state_digest(),
                    snap.get("distar_coordinator_ha_apply_skips_total{route=nope}"))
    assert out["port"] == out["jax"]
    assert out["port"][0] == ["a"] and out["port"][1] == 1 and out["port"][3] == 1.0


# ------------------------------------------------------- the HA pair as processes
def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _coordinator_process(tmp_path, name, argv):
    log = open(str(tmp_path / f"{name}.log"), "w")
    proc = subprocess.Popen([sys.executable, "-u", "-m", "distar_tpu_torch.bin.rl_train", "--type", "coordinator",
                             "--no-health", *argv], cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
                            env={**os.environ, "PYTHONPATH": REPO})
    return proc, str(tmp_path / f"{name}.log")


def _wait_for(log, text, proc, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        body = open(log).read()
        if text in body:
            return body
        assert proc.poll() is None, body
        time.sleep(0.05)
    raise AssertionError(f"no {text!r} in {open(log).read()}")


def test_rl_train_ha_pair_fails_over_as_processes(tmp_path):
    """``rl_train --type coordinator --journal-dir`` as the primary and
    ``--ha-role standby --ha-peers <primary>``; a client on the address
    list registers; the primary is SIGKILLed; the standby promotes within
    its grace (plus the feed's probe) and serves the acked register; its
    SIGTERM journals a last snapshot and exits 0."""
    p1, p2 = free_port(), free_port()
    primary, log1 = _coordinator_process(tmp_path, "primary", ["--port", str(p1), "--journal-dir",
                                                               str(tmp_path / "j1")])
    standby = None
    try:
        assert "coordinator HA: role=primary epoch=1" in _wait_for(log1, "coordinator serving on", primary)
        standby, log2 = _coordinator_process(tmp_path, "standby", [
            "--port", str(p2), "--journal-dir", str(tmp_path / "j2"), "--ha-role", "standby",
            "--ha-peers", f"127.0.0.1:{p1}", "--ha-takeover-grace-s", "1.0"])
        assert "coordinator HA: role=standby" in _wait_for(log2, "coordinator serving on", standby)
        spec = f"127.0.0.1:{p1},127.0.0.1:{p2}"
        deadline = time.monotonic() + 20
        while (ha.probe_ha_status(f"127.0.0.1:{p1}") or {}).get("followers") != 1:
            assert time.monotonic() < deadline, "the standby never attached to the feed"
            time.sleep(0.05)
        assert coordinator_request(spec, None, "register", {"token": "t", "ip": "10.0.0.7", "port": 7})["code"] == 0
        primary.kill()
        primary.wait(timeout=10)
        t0 = time.monotonic()
        while (ha.probe_ha_status(f"127.0.0.1:{p2}") or {}).get("role") != "primary":
            assert time.monotonic() - t0 < 20, "the standby never promoted"
            time.sleep(0.05)
        reply = coordinator_request(spec, None, "peers", {"token": "t"})
        assert reply["role"] == "primary" and reply["epoch"] == 2
        assert [r["port"] for r in reply["info"]] == [7]
        standby.send_signal(signal.SIGTERM)
        assert standby.wait(timeout=30) == 0
        assert "coordinator journal snapshotted on shutdown" in open(log2).read()
        assert any(f.startswith("snap.") for f in os.listdir(str(tmp_path / "j2")))
    finally:
        for proc in (primary, standby):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()


def test_coordinator_ha_route_answers_like_the_jax_one(tmp_path):
    """``GET /coordinator/ha`` answers the status (404 without HA) on both
    packages' servers, with the same keys."""
    out = {}
    for lib in ("port", "jax"):
        pk = PACKAGES[lib]
        srv = pk["server"](coordinator=pk["co"](), port=0)
        srv.start()
        try:
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/coordinator/ha", timeout=10)
            assert err.value.code == 404
        finally:
            srv.stop()
        co = pk["co"]()
        srv = pk["server"](coordinator=co, port=0)
        st = pk["ha"].HAState(co, str(tmp_path / lib), advertise=f"127.0.0.1:{srv.port}", role="primary",
                              arena_store_fn=lambda: None, league_service_fn=lambda: None).boot()
        srv.attach_ha(st)
        assert srv.ha is st
        srv.start()
        try:
            status = pk["ha"].probe_ha_status(f"127.0.0.1:{srv.port}")
        finally:
            srv.stop()
            st.stop()
        out[lib] = status
    assert out["port"].keys() == out["jax"].keys()
    for key in ("role", "epoch", "seq", "journal_lag_records", "followers"):
        assert out["port"][key] == out["jax"][key], key


def test_auto_role_with_no_live_peer_leads_journaled(tmp_path):
    """``--ha-role auto`` whose peers answer nothing starts as the JAX one
    does: it leads (epoch 1), journaled; a second boot on the same journal
    leads the next epoch."""
    dead = f"127.0.0.1:{free_port()}"
    for epoch in (1, 2):
        st = ha.HAState(Coordinator(), str(tmp_path / "j"), role="auto", peers=[dead],
                        arena_store_fn=lambda: None, league_service_fn=lambda: None).boot()
        try:
            assert (st.role, st.epoch) == ("primary", epoch)
            assert st.journal.seq == epoch  # its leadership record, journaled
        finally:
            st.stop()


def test_a_compacted_journal_refuses_a_replay_from_its_first_record(tmp_path, registry, hosted):
    """``replay_control_plane(wal_only=True)`` needs every record from the
    first: a journal whose oldest segments were compacted away raises
    ``JournalCorruptError`` (it does not replay a partial history), while
    the ``HAState`` boot replays it from its newest snapshot."""
    root = str(tmp_path / "j")
    j = ha.Journal(root)
    for i in range(3):
        j.append("register", {"token": "t", "ip": f"10.0.0.{i}", "port": i})
        j.snapshot({"coordinator": {}, "arena": None, "league": None})
    j.close()
    assert not os.path.exists(os.path.join(root, "wal.0000000000000001.log"))
    with pytest.raises(ha.JournalCorruptError):
        prunner.replay_control_plane(root, ROSTER, wal_only=True)
    _, _, info = prunner.replay_control_plane(root, ROSTER)
    assert info["records"] == 0
