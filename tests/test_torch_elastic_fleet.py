"""The port's elastic fleet (``distar_tpu_torch.fleet``) against the JAX
package's, on the CPU.

* The autoscaler tests of tests/test_elastic_fleet.py (hysteresis, cooldown
  and limits; no data, no action; the coordinator's ``GET /autoscaler``
  route): the JAX and the port autoscaler are given the same TSDB series,
  each in its own package's store, and must decide the same way at every
  evaluation and report the same status.
* The four pinning tests: refusals in band on a small host, disjoint
  cores on a many-core one, this process pinned to its own mask, and
  ``pin_fleet``'s refusal; each plan equal to the JAX package's.
* The supervisor with real members: the port's ``gateway_proc`` and
  ``replay.server`` started by ``gateway_cmd``/``replay_cmd``, a crashed
  member respawned under its budget, a drain through the member's admin
  route, ``MemberProbe`` folding member status into the store, the
  exports of ``fleet/__init__.py`` equal to the JAX package's.
"""
import json
import os
import time
import urllib.error
import urllib.request

import pytest

from distar_tpu import fleet as jfleet
from distar_tpu.comm.coordinator import Coordinator as JCoordinator
from distar_tpu.comm.coordinator import CoordinatorServer as JCoordinatorServer
from distar_tpu.obs import TimeSeriesStore as JTimeSeriesStore
from distar_tpu_torch import fleet as pfleet
from distar_tpu_torch.comm.coordinator import Coordinator, CoordinatorServer
from distar_tpu_torch.fleet import pinning
from distar_tpu_torch.obs import TimeSeriesStore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _StubFleet:
    def draining_addrs(self):
        return []

    gave_up = False


class _StubSupervisor:
    def __init__(self, fleets):
        self._fleets = dict(fleets)
        self.calls = []

    def fleets(self):
        return sorted(self._fleets)

    def fleet(self, name):
        return _StubFleet()

    def actual(self, name):
        return self._fleets[name]

    def scale_up(self, name, n=1):
        self._fleets[name] += n
        self.calls.append(("up", name, n))
        return [f"new{i}" for i in range(n)]

    def scale_down(self, name, n=1):
        self._fleets[name] -= n
        self.calls.append(("down", name, n))
        return [f"old{i}" for i in range(n)]


def _pair(fleets, policy_kw, **scaler_kw):
    """The same autoscaler in both packages: (lib, store, supervisor,
    scaler) for the port and the JAX package."""
    out = []
    for lib, store_cls in ((pfleet, TimeSeriesStore), (jfleet, JTimeSeriesStore)):
        store, sup = store_cls(), _StubSupervisor(fleets)
        policy = lib.ScalePolicy(name="res", fleet="gateway", signal=lib.SIG_GW_ACTIVE,
                                 divide_by=lib.SIG_GW_SLOTS, **policy_kw)
        out.append((lib, store, sup, lib.Autoscaler(store, sup, policies=[policy], **scaler_kw)))
    return out


def _feed(pair, active, slots, ts, source="gateway:a"):
    for lib, store, _, _ in pair:
        store.record(lib.SIG_GW_ACTIVE, float(active), ts=ts, source=source)
        store.record(lib.SIG_GW_SLOTS, float(slots), ts=ts, source=source)


def _evaluate(pair, now):
    """Both autoscalers at ``now``: the decisions, equal but for their wall
    stamps."""
    got = [[{k: v for k, v in d.items() if k != "ts"} for d in scaler.evaluate_once(now=now)]
           for _, _, _, scaler in pair]
    assert got[0] == got[1], got
    return got[0]


def _status(scaler):
    st = scaler.status()
    st.pop("ts")
    for d in [st["last_decision"]] + st["decisions"]:
        if d:
            d.pop("ts")
    return st


def test_autoscaler_hysteresis_cooldown_and_limits():
    pair = _pair({"gateway": 1}, dict(up_when=0.85, down_when=0.30, for_count=2),
                 limits={"gateway": (1, 2)}, cooldown_s=50.0)
    wall = time.time()
    _feed(pair, 8, 8, wall)
    t = 1000.0
    # hysteresis: one breached evaluation is not enough
    assert _evaluate(pair, t) == []
    decisions = _evaluate(pair, t + 1)
    assert [d["direction"] for d in decisions] == ["up"]
    assert pair[0][2].calls == pair[1][2].calls == [("up", "gateway", 1)]
    assert "res=" in decisions[0]["reason"]
    # cooldown: still breached, no second action inside the window
    _feed(pair, 16, 16, wall + 1)
    assert _evaluate(pair, t + 2) == []
    assert _evaluate(pair, t + 3) == []
    # max limit: past cooldown, at the cap, no action either
    assert _evaluate(pair, t + 60) == []
    assert _evaluate(pair, t + 61) == []
    assert pair[0][2].actual("gateway") == 2
    # load drop: down needs its own streak, then acts once, floor-clamped
    _feed(pair, 2, 16, wall + 2)
    assert _evaluate(pair, t + 120) == []
    down = _evaluate(pair, t + 121)
    assert [d["direction"] for d in down] == ["down"]
    assert pair[0][2].actual("gateway") == 1
    # at the floor: even a sustained down-breach cannot go below min
    assert _evaluate(pair, t + 200) == []
    assert _evaluate(pair, t + 201) == []
    assert pair[0][2].actual("gateway") == pair[1][2].actual("gateway") == 1
    st = pair[0][3].status()
    assert st["last_decision"]["direction"] == "down"
    assert st["policies"]["res"]["value"] == pytest.approx(2 / 16)
    assert _status(pair[0][3]) == _status(pair[1][3])


def test_autoscaler_no_data_is_no_action():
    pair = _pair({"gateway": 1}, dict(up_when=0.85, down_when=0.30, for_count=1))
    assert _evaluate(pair, 0.0) == []
    assert pair[0][2].calls == pair[1][2].calls == []


def test_default_policies_and_exports_are_the_jax_packages():
    assert pfleet.__all__ == jfleet.__all__
    for name in pfleet.__all__:
        if name.startswith("SIG_"):
            assert getattr(pfleet, name) == getattr(jfleet, name)
    assert [vars(p) for p in pfleet.default_policies()] == [vars(p) for p in jfleet.default_policies()]


def test_coordinator_autoscaler_route():
    """``GET /autoscaler`` answers the installed autoscaler's status on the
    port's coordinator as on the JAX one (404 with none installed)."""
    got = {}
    for lib, co_cls, srv_cls in ((pfleet, Coordinator, CoordinatorServer),
                                 (jfleet, JCoordinator, JCoordinatorServer)):
        store = TimeSeriesStore() if lib is pfleet else JTimeSeriesStore()
        scaler = lib.Autoscaler(store, _StubSupervisor({"gateway": 2}), policies=[
            lib.ScalePolicy(name="res", fleet="gateway", signal=lib.SIG_GW_ACTIVE, divide_by=lib.SIG_GW_SLOTS,
                            up_when=0.85, down_when=0.30)])
        prev = lib.set_autoscaler(scaler)
        co = srv_cls(co_cls())
        co.start()
        try:
            with urllib.request.urlopen(f"http://{co.host}:{co.port}/autoscaler", timeout=5) as resp:
                body = json.loads(resp.read())
            assert body["fleets"]["gateway"]["actual"] == 2
            assert "res" in body["policies"]
            body.pop("ts")
            got[lib.__name__] = body
        finally:
            lib.set_autoscaler(prev)
            co.stop()
        # with no autoscaler installed the route 404s
        co2 = srv_cls(co_cls())
        co2.start()
        try:
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(f"http://{co2.host}:{co2.port}/autoscaler", timeout=5)
            assert ei.value.code == 404
        finally:
            co2.stop()
    assert got["distar_tpu_torch.fleet"] == got["distar_tpu.fleet"]


# ---------------------------------------------------------------- pinning
def _plans_equal(monkeypatch, cores, *args, **kw):
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(cores), raising=False)
    p, j = pinning.plan(*args, **kw), jfleet.pinning.plan(*args, **kw)
    assert vars(p) == vars(j)
    return p


def test_pinning_refuses_honestly_on_small_hosts(monkeypatch):
    p = _plans_equal(monkeypatch, {0}, 2)
    assert not p.pinned and "time-share" in p.refused_reason
    prov = p.provenance()
    assert prov["pinned"] is False and prov["host_cores"] == 1
    assert prov["tool"] == "tools/pin.py"
    assert not pinning.scaling_valid(prov)


def test_pinning_plans_disjoint_cores_on_multicore(monkeypatch):
    p = _plans_equal(monkeypatch, {0, 1, 2, 3}, 3, reserve_client=1)
    assert p.pinned and p.host_cores == 4
    flat = [c for cores in p.assignments for c in cores]
    assert len(flat) == len(set(flat)) == 3  # one core each, disjoint
    assert p.client_cores and not (set(p.client_cores) & set(flat))
    prov = p.provenance({"pid1": [0], "pid2": [1], "pid3": [2]})
    assert pinning.scaling_valid(prov)
    assert pinning.scaling_valid(prov, min_cores=4)
    assert not pinning.scaling_valid(prov, min_cores=5)


def test_pin_pid_self_roundtrip():
    """The harness pins this process to its own current mask (a no-op) and
    reads it back; where the platform cannot set an affinity it says so."""
    if not pinning.can_pin():
        assert not pinning.pin_pid(0, [0])
        return
    cores = sorted(os.sched_getaffinity(0))
    assert pinning.pin_pid(0, cores)  # pin to the full current mask: no-op
    assert sorted(os.sched_getaffinity(0)) == cores


def test_pin_fleet_refusal_is_inband_on_this_host(monkeypatch):
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: {0}, raising=False)
    prov = pinning.pin_fleet([os.getpid()])
    assert prov["pinned"] is False and "refused_reason" in prov
    assert prov == jfleet.pinning.pin_fleet([os.getpid()])


# ------------------------------------------------------------- the supervisor
def _wait(cond, what, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.05)


def test_supervisor_spawns_respawns_and_drains_port_members(tmp_path, monkeypatch):
    """``gateway_cmd`` and ``replay_cmd`` start the port's modules; a member
    killed from outside is respawned under its budget, a scale-down drains
    the newest member through its admin route until it exits, and
    ``MemberProbe`` records each member's status under ``<fleet>:<addr>``."""
    monkeypatch.chdir(REPO)  # members run ``python -m distar_tpu_torch...``
    gateways = pfleet.SubprocessFleet("gateway", "gateway", pfleet.gateway_cmd(slots=4), drain_timeout_s=10.0)
    replay = pfleet.SubprocessFleet("replay", "replay", pfleet.replay_cmd(spill_root=str(tmp_path / "spill")),
                                    drain_timeout_s=10.0)
    sup = pfleet.FleetSupervisor(watch_interval_s=0.1).add_fleet(gateways).add_fleet(replay)
    assert "distar_tpu_torch.serve.fleet.gateway_proc" in gateways.build_cmd(0)
    assert "distar_tpu_torch.replay.server" in replay.build_cmd(0)
    try:
        assert len(sup.scale_up("gateway", 2)) == 2 and len(sup.scale_up("replay", 1)) == 1
        assert sup.actual("gateway") == 2 and sup.actual("replay") == 1
        member = replay.members()[0]
        assert member.http_addr and member.meta["index"] == "0"
        store = TimeSeriesStore()
        probe = pfleet.MemberProbe(store, sup)
        assert probe.collect_once() == 3
        assert len(probe.member_sources("gateway")) == 2
        src = probe.member_sources("gateway")[0]
        assert store.query(pfleet.SIG_GW_SLOTS, source=src)["last"] == 4.0
        # a shard makes its tables at its first insert: none yet, no capacity
        assert store.query(pfleet.SIG_RP_CAPACITY, source=probe.member_sources("replay")[0])["last"] == 0.0
        sup.start()
        member.proc.kill()
        _wait(lambda: sup.actual("replay") == 1 and replay.members()[0] is not member, "no respawn")
        assert replay.members()[0].meta["index"] == "1"
        newest = max(gateways.active_members(), key=lambda m: m.started_ts)
        assert sup.scale_down("gateway", 1) == [newest.addr]
        _wait(lambda: newest.proc.poll() is not None, "the drained gateway did not exit")
        _wait(lambda: sup.actual("gateway") == 1 and not gateways.draining_addrs(), "the drain did not finish")
        assert sup.status()["gateway"]["active"] == 1
        # a drained member's series go with it
        assert probe.collect_once() == 2
        assert len(probe.member_sources("gateway")) == 1
    finally:
        sup.stop()
    assert sup.actual("gateway") == sup.actual("replay") == 0
