"""The port's serving fleet (``serve/fleet/``) against the JAX package's, on
the CPU: hash-ring owners and the canary split equal the JAX package's;
re-route on gateway death with migrations counted; typed sheds pass
through; all-or-nothing rollouts (success, a load NACK, a swap NACK rolled
back), a canary then promote; each package's ``FleetClient`` over the
other's gateways and coordinator; ``bin/serve.py --coordinator-addr`` as a
process that registers and, on SIGTERM, deregisters before exiting 0; and
two port gateways serving a SMALL_MODEL checkpoint behind ``FleetClient``.

Tolerances: the mock engines answer exactly, so those answers are held
equal. The SMALL_MODEL fleet's answers are held bit-equal to an in-process
port gateway fed the same sessions in the same order (same weights and
seed), and their action-type logits and the sessions' LSTM carries within
atol 2e-4 / rtol 1e-3 (tests/test_torch_serve.py) of the JAX gateway fed
the same sessions: the other heads depend on the Gumbel draws, which the
two packages make from different generators. Every subprocess and socket
has its own time limit."""
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from conftest import SMALL_MODEL

from distar_tpu import serve as jserve
from distar_tpu.comm import coordinator as jcoord
from distar_tpu.replay import sharding as jsharding
from distar_tpu.serve import fleet as jfleet
from distar_tpu_torch import serve as pserve
from distar_tpu_torch.comm import coordinator as pcoord
from distar_tpu_torch.obs import get_registry
from distar_tpu_torch.replay import sharding as psharding
from distar_tpu_torch.serve import fleet as pfleet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDS = [f"sess-{i}" for i in range(2000)]
TOL = dict(atol=2e-4, rtol=1e-3)
# the JAX reference gateway's first act compiles its forward
JAX_ACT_TIMEOUT_S = 300.0
LIBS = {"port": (pserve, pfleet), "jax": (jserve, jfleet)}


def _obs(i=0):
    return {"x": np.full((2, 2), float(i), dtype=np.float32)}


def _count(name):
    return get_registry().snapshot().get(name, 0.0)


# ----------------------------------------------------------------- affinity
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6])
def test_hash_ring_owners_equal_the_jax_package(n):
    addrs = [f"10.0.0.{i}:{7000 + i}" for i in range(n)]
    ours, theirs = psharding.HashRing(addrs), jsharding.HashRing(addrs)
    assert [ours.lookup(s) for s in SIDS] == [theirs.lookup(s) for s in SIDS]
    assert psharding.stable_hash("x") == jsharding.stable_hash("x")
    router = pfleet.FleetRouter(pfleet.GatewayMap(addrs))
    jrouter = jfleet.FleetRouter(jfleet.GatewayMap(addrs))
    picked = [router.gateway_for(s) for s in SIDS[:500]]
    assert picked == [jrouter.gateway_for(s) for s in SIDS[:500]]
    assert picked == [psharding.HashRing(sorted(addrs)).lookup(s) for s in SIDS[:500]]


@pytest.mark.parametrize("pct", [10.0, 33.0, 50.0])
def test_canary_split_equals_the_jax_package(pct):
    addrs = ["10.0.0.1:1", "10.0.0.2:2", "10.0.0.3:3"]
    router = pfleet.FleetRouter(pfleet.GatewayMap(addrs))
    jrouter = jfleet.FleetRouter(jfleet.GatewayMap(addrs))
    for r in (router, jrouter):
        r.set_canary([addrs[0]], pct)
    split = [router.is_canary_session(s) for s in SIDS]
    assert split == [jrouter.is_canary_session(s) for s in SIDS]
    assert abs(sum(split) / len(SIDS) - pct / 100) < 0.05
    routed = [router.gateway_for(s) for s in SIDS[:600]]
    assert routed == [jrouter.gateway_for(s) for s in SIDS[:600]]
    assert all((a == addrs[0]) == c for a, c in zip(routed, split))
    router.clear_canary()
    assert router.canary_config() == ([], 0.0)


# ------------------------------------------------------------- mock fleets
class _Fleet:
    """N in-process mock gateways behind TCP servers, from one package."""

    def __init__(self, n, slots=8, version="v1", lib="port"):
        serve = LIBS[lib][0]
        self.gateways = []
        for _ in range(n):
            params = {"version": version, "bias": 0.0}
            gw = serve.InferenceGateway(serve.MockModelEngine(slots, params=params), max_batch=slots,
                                        max_delay_s=0.002, idle_ttl_s=300.0)
            gw.load_version(version, params=params, activate=True)
            self.gateways.append(gw.start())
        self.servers = [serve.ServeTCPServer(gw, port=0).start() for gw in self.gateways]
        self.addrs = [f"{s.host}:{s.port}" for s in self.servers]

    def close(self):
        for s in self.servers:
            s.stop()
        for gw in self.gateways:
            gw.drain_and_stop(2.0)


def test_reroute_on_gateway_death_counts_migrations_and_zero_carry():
    fleet = _Fleet(2, slots=16)
    fc = pfleet.FleetClient(gateway_map=pfleet.GatewayMap(fleet.addrs), timeout_s=5.0, down_ttl_s=60.0)
    try:
        sids = [f"d-{i}" for i in range(10)]
        for _ in range(3):
            assert all(isinstance(r, dict) for r in fc.act_many([{"session_id": s, "obs": _obs()}
                                                                 for s in sids]))
        pins = fc.router.stats()["pins_per_gateway"]
        victim_idx = 0 if pins[fleet.addrs[0]] >= pins[fleet.addrs[1]] else 1
        victim = fleet.addrs[victim_idx]
        victims = set(fc.router.pins_on(victim))
        assert victims
        migrations = _count("distar_fleet_session_migrations_total")
        reroutes = _count("distar_fleet_reroutes_total")
        fleet.servers[victim_idx].stop()
        res = fc.act_many([{"session_id": s, "obs": _obs()} for s in sids], timeout_s=10.0)
        assert all(isinstance(r, dict) for r in res), res
        assert _count("distar_fleet_session_migrations_total") - migrations == len(victims)
        assert _count("distar_fleet_reroutes_total") - reroutes == len(victims)
        assert [r["session_step"] for r in res] == [1 if s in victims else 4 for s in sids]
        fc.act_many([{"session_id": s, "obs": _obs()} for s in sids])
        assert _count("distar_fleet_session_migrations_total") - migrations == len(victims)
        assert victim in fc.router.stats()["down"]
    finally:
        fc.close()
        fleet.close()


def test_typed_sheds_pass_through_without_reroute():
    fleet = _Fleet(1, slots=2)
    fc = pfleet.FleetClient(gateway_map=pfleet.GatewayMap(fleet.addrs), timeout_s=2.0)
    try:
        fc.act("a", _obs())
        fc.act("b", _obs())
        with pytest.raises(pserve.ServeError) as e:
            fc.act("c", _obs())  # no slot, nothing evictable
        assert e.value.shed and fc.router.stats()["down"] == []
    finally:
        fc.close()
        fleet.close()


class _SwapNack:
    """A client that NACKs activation (a wedged gateway)."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def swap(self, version, player=None):
        raise pserve.ServeError("injected swap NACK")


class _LoadNack(_SwapNack):
    def swap(self, version, player=None):
        return self._inner.swap(version, player=player)

    def load(self, version, source=None, params=None, activate=False, player=None):
        raise pserve.ServeError("injected load NACK")


def _controller(fleet, nack_cls=None, nack_idx=None):
    def factory(addr):
        host, _, port = addr.rpartition(":")
        client = pserve.ServeClient(host, int(port), timeout_s=5.0)
        return nack_cls(client) if nack_cls is not None and addr == fleet.addrs[nack_idx] else client

    return pfleet.FleetRollout(pfleet.GatewayMap(fleet.addrs), timeout_s=5.0, client_factory=factory)


def _current(ctl):
    return [st["registry"]["current"] for st in ctl.fleet_status().values()]


def test_rollout_ok_then_a_load_nack_leaves_the_fleet_untouched():
    fleet = _Fleet(3)
    ctl, ctl2 = _controller(fleet), _controller(fleet, _LoadNack, 1)
    try:
        verdict = ctl.rollout("v2", params={"version": "v2", "bias": 1.0})
        assert verdict["ok"] and sorted(verdict["generations"]) == sorted(fleet.addrs)
        verdict = ctl2.rollout("v3", params={"version": "v3", "bias": 2.0})
        assert not verdict["ok"] and verdict["outcome"] == "load_nack" and verdict["phase"] == "load"
        assert _current(ctl) == ["v2"] * 3
    finally:
        ctl.close()
        ctl2.close()
        fleet.close()


def test_rollout_swap_nack_rolls_the_swapped_prefix_back():
    fleet = _Fleet(3)
    ctl, ctl2 = _controller(fleet), _controller(fleet, _SwapNack, 2)
    try:
        assert ctl.rollout("v2", params={"version": "v2", "bias": 1.0})["ok"]
        verdict = ctl2.rollout("v3", params={"version": "v3", "bias": 2.0})
        assert not verdict["ok"] and verdict["outcome"] == "rolled_back"
        assert verdict["failed_gateway"] == fleet.addrs[2]
        assert set(verdict["rollback"]) == set(fleet.addrs[:2])
        assert _current(ctl) == ["v2"] * 3
        before = _count('distar_fleet_rollouts_total{outcome=rolled_back}')
        assert ctl2.rollout("v4", params={"version": "v4", "bias": 0.0})["outcome"] == "rolled_back"
        assert _count('distar_fleet_rollouts_total{outcome=rolled_back}') == before + 1
    finally:
        ctl.close()
        ctl2.close()
        fleet.close()


def test_canary_then_promote_with_monotone_version_streams():
    fleet = _Fleet(3, slots=64)
    fc = pfleet.FleetClient(gateway_map=pfleet.GatewayMap(fleet.addrs), timeout_s=5.0)
    ctl = _controller(fleet)
    try:
        canary = fleet.addrs[0]
        assert ctl.canary_start("v2", [canary], 33.0, params={"version": "v2", "bias": 1.0},
                                router=fc.router)["ok"]
        streams = {f"cs-{i}": [] for i in range(60)}
        for _ in range(3):
            for s, r in zip(streams, fc.act_many([{"session_id": s, "obs": _obs()} for s in streams])):
                streams[s].append(r["version"])
        on_canary = {s for s in streams if fc.router.gateway_for(s) == canary}
        assert on_canary == {s for s in streams if fc.router.is_canary_session(s)}
        for s, versions in streams.items():
            assert set(versions) == ({"v2"} if s in on_canary else {"v1"})
        compare = ctl.compare([canary])
        assert compare["canary"]["gateways"] == 1 and compare["stable"]["gateways"] == 2
        assert compare["verdict"]["promote"], compare["verdict"]
        assert ctl.promote("v2", params={"version": "v2", "bias": 1.0}, router=fc.router)["ok"]
        assert fc.router.canary_config() == ([], 0.0)
        for _ in range(2):
            for s, r in zip(streams, fc.act_many([{"session_id": s, "obs": _obs()} for s in streams])):
                streams[s].append(r["version"])
        for versions in streams.values():
            first = versions.index("v2")
            assert set(versions[:first]) <= {"v1"} and set(versions[first:]) == {"v2"}
        gated = ctl.promote("v3", verdict={"verdict": {"promote": False, "reasons": ["x"]}})
        assert gated["outcome"] == "compare_gated" and _current(ctl) == ["v2"] * 3
    finally:
        ctl.close()
        fc.close()
        fleet.close()


@pytest.mark.parametrize("client_lib", ["port", "jax"])
def test_fleet_client_over_the_other_packages_gateways(client_lib):
    """The client's package runs the coordinator and the router; the other
    package runs the gateways and registers them there."""
    gateway_lib = "jax" if client_lib == "port" else "port"
    fleet_mod = LIBS[client_lib][1]
    srv = (pcoord if client_lib == "port" else jcoord).CoordinatorServer(port=0)
    srv.start()
    fleet = _Fleet(2, slots=16, lib=gateway_lib)
    beats, fc = [], None
    try:
        coord = (srv.host, srv.port)
        for addr in fleet.addrs:
            host, _, port = addr.rpartition(":")
            beats.append(LIBS[gateway_lib][1].register_gateway(coord, host, int(port), meta={"slots": 8},
                                                               lease_s=60.0))
        fc = fleet_mod.FleetClient(coordinator_addr=coord, timeout_s=5.0, refresh_s=0)
        assert sorted(fc.router.map.addrs) == sorted(fleet.addrs)
        sids = [f"x-{i}" for i in range(12)]
        for step in (1, 2):
            res = fc.act_many([{"session_id": s, "obs": _obs(1)} for s in sids])
            assert [r["session_step"] for r in res] == [step] * len(sids)
            assert all(float(r["action"]) == 4.0 for r in res)
        ring = psharding.HashRing(sorted(fleet.addrs))
        assert {s: fc.router.gateway_for(s) for s in sids} == {s: ring.lookup(s) for s in sids}
        assert fc.ping() and set(fc.status()["gateways"]) == set(fleet.addrs)
    finally:
        if fc is not None:
            fc.close()
        for b in beats:
            b.stop_event.set()
        fleet.close()
        srv.stop()


def test_standalone_router_and_mock_gateway_processes():
    """Two ``fleet.gateway_proc`` processes registered at a coordinator,
    fronted by ``python -m distar_tpu_torch.serve.fleet.router``."""
    srv = pcoord.CoordinatorServer(port=0)
    srv.start()
    procs = []
    try:
        coord = f"{srv.host}:{srv.port}"
        for _ in range(2):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "distar_tpu_torch.serve.fleet.gateway_proc", "--coordinator", coord,
                 "--slots", "8"], cwd=REPO, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True))
        lines = [p.stdout.readline().split() for p in procs]
        assert all(ln[0] == "SERVE-GATEWAY" for ln in lines), lines
        router = subprocess.Popen([sys.executable, "-m", "distar_tpu_torch.serve.fleet.router", "--discover",
                                   coord, "--refresh-s", "0.5"], cwd=REPO, stdin=subprocess.PIPE,
                                  stdout=subprocess.PIPE, text=True)
        procs.append(router)
        parts = router.stdout.readline().split()
        assert parts[0] == "SERVE-ROUTER", parts
        c = pserve.ServeClient(parts[1], int(parts[2]), timeout_s=10.0)
        res = c.act_many([{"session_id": f"r{i}", "obs": _obs(2)} for i in range(6)])
        assert [float(r["action"]) for r in res] == [8.0] * 6
        assert set(c.status()["gateways"]) == {f"{ln[1]}:{ln[2]}" for ln in lines}
        c.close()
    finally:
        for p in procs:
            p.stdin.close()  # stdin EOF ends each process
        for p in procs:
            try:
                assert p.wait(timeout=20) == 0
            finally:
                p.kill()
                p.stdout.close()
        srv.stop()


def test_bin_serve_registers_and_deregisters_on_sigterm():
    srv = pcoord.CoordinatorServer(port=0)
    srv.start()
    proc = None
    try:
        coord = (srv.host, srv.port)
        proc = subprocess.Popen(
            [sys.executable, "-m", "distar_tpu_torch.bin.serve", "--mock", "--host", "127.0.0.1",
             "--http-port", "0", "--tcp-port", "0", "--coordinator-addr", f"{srv.host}:{srv.port}",
             "--lease-s", "60"], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        line = proc.stdout.readline()
        assert f"registered@{srv.host}:{srv.port}" in line and "transport=auto" in line, line
        tcp = int(line.split("tcp=")[1].split()[0].rsplit(":", 1)[1])
        gm = pfleet.GatewayMap.discover(coord)
        assert gm.addrs == [f"127.0.0.1:{tcp}"] and gm.meta[gm.addrs[0]]["mock"] is True
        c = pserve.ServeClient("127.0.0.1", tcp)
        assert c.transport_active == "shm" and c.act("s", {"x": np.ones(2)})["session_step"] == 1
        c.close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        # gone at once, not 60 s later when the lease would lapse
        assert pcoord.coordinator_request(srv.host, srv.port, "peers",
                                          {"token": pfleet.GATEWAY_TOKEN})["info"] == []
        assert "drained; bye" in proc.stdout.read()
    finally:
        if proc is not None:
            proc.kill()
            proc.stdout.close()
        srv.stop()


def test_drain_leaves_discovery_and_sessions_move():
    """A gateway told to drain unregisters first (its deregister hook);
    the client's next step moves its sessions to the survivor."""
    srv = pcoord.CoordinatorServer(port=0)
    srv.start()
    fleet = _Fleet(2, slots=16)
    fc = None
    try:
        coord = (srv.host, srv.port)
        for gw, addr in zip(fleet.gateways, fleet.addrs):
            host, _, port = addr.rpartition(":")
            pfleet.register_gateway(coord, host, int(port), lease_s=60.0, target=gw)
        fc = pfleet.FleetClient(coordinator_addr=coord, timeout_s=5.0, refresh_s=0)
        sids = [f"m-{i}" for i in range(10)]
        fc.act_many([{"session_id": s, "obs": _obs()} for s in sids])
        on_first = set(fc.router.pins_on(fleet.addrs[0]))
        assert on_first
        fleet.gateways[0].begin_drain()
        assert pfleet.GatewayMap.discover(coord).addrs == [fleet.addrs[1]]
        migrations = _count("distar_fleet_session_migrations_total")
        res = fc.act_many([{"session_id": s, "obs": _obs()} for s in sids])
        assert all(isinstance(r, dict) for r in res), res
        assert [r["session_step"] for r in res] == [1 if s in on_first else 2 for s in sids]
        assert _count("distar_fleet_session_migrations_total") - migrations == len(on_first)
        assert fleet.gateways[0].resident_sessions() == 0  # the handoff ended them there
    finally:
        if fc is not None:
            fc.close()
        fleet.close()
        srv.stop()


def test_a_cycle_lands_in_one_flush_however_slow_its_admission():
    """The lanes of one ``act_many`` enter the batcher together: an
    admission slower than ``max_delay_s`` between lanes (a loaded host)
    does not split the cycle across flushes, so a flush's noise draw covers
    the whole cycle as it would on an idle host."""
    engine = pserve.MockModelEngine(4)
    gw = pserve.InferenceGateway(engine, max_delay_s=0.02).start()
    acquire = gw.sessions.acquire

    def slow_acquire(session_id):
        time.sleep(0.05)
        return acquire(session_id)

    gw.sessions.acquire = slow_acquire
    try:
        out = gw.act_many([{"session_id": f"s{i}", "obs": {"x": np.ones(1)}} for i in range(3)])
        assert [o["session_step"] for o in out] == [1, 1, 1]
        assert engine.forward_calls == 1
    finally:
        gw.drain_and_stop(5)


@pytest.mark.parametrize("kind", ["gateway", "mux"])
def test_register_gateway_installs_one_idempotent_deregister(kind):
    """``register_gateway(..., target=)`` makes the target's drain leave
    discovery once, however often it drains, and a coordinator gone by the
    time of the drain raises nothing (the lease lapses instead)."""
    srv = pcoord.CoordinatorServer(port=0)
    srv.start()
    gw = pserve.InferenceGateway(pserve.MockModelEngine(2), max_delay_s=0.005)
    target = gw if kind == "gateway" else pserve.GatewayMux({"MP0": gw})
    target.start()
    try:
        coord = (srv.host, srv.port)
        beat = pfleet.register_gateway(coord, "127.0.0.1", 5555, lease_s=60.0, target=target)
        assert target.deregister is beat.deregister
        assert pfleet.GatewayMap.discover(coord).addrs == ["127.0.0.1:5555"]
        before = _count("distar_coordinator_unregisters_total")
        target.begin_drain()
        assert beat.stop_event.is_set()
        assert pcoord.coordinator_request(srv.host, srv.port, "peers",
                                          {"token": pfleet.GATEWAY_TOKEN})["info"] == []
        target.begin_drain()
        beat.deregister()
        assert _count("distar_coordinator_unregisters_total") - before == 1
        other = pfleet.register_gateway(coord, "127.0.0.1", 5556, lease_s=60.0)
        srv.stop()
        other.deregister()  # the coordinator is gone: no raise
        assert other.stop_event.is_set()
    finally:
        target.drain_and_stop(5)
        srv.stop()


# --------------------------------------------------------- SMALL_MODEL fleet
def test_small_model_fleet_answers_like_the_jax_gateway(tmp_path):
    import jax

    from distar_tpu.actor.inference import BatchedInference as JaxBatchedInference
    from distar_tpu.model import Model as JModel
    from distar_tpu.model.config import default_model_config as jax_default_config
    from distar_tpu.utils import checkpoint as jckpt
    from distar_tpu.utils import deep_merge_dicts as jax_merge
    from distar_tpu_torch.actor import BatchedInference
    from distar_tpu_torch.bin import serve as serve_bin
    from distar_tpu_torch.lib import features as F
    from distar_tpu_torch.model import Model, default_model_config, init_params
    from distar_tpu_torch.model.convert import params_to_flax
    from distar_tpu_torch.utils import checkpoint as ckpt
    from distar_tpu_torch.utils import deep_merge_dicts

    torch.set_num_threads(1)
    slots, n_sessions, n_steps = 4, 6, 2
    cfg = deep_merge_dicts(default_model_config(), SMALL_MODEL)
    model = Model(cfg)
    init_params(model, 3)
    path = str(tmp_path / "small.ckpt")
    ckpt.save_checkpoint(path, {"params": params_to_flax(model), "opt_state": ()})
    args = serve_bin.parser().parse_args(["--checkpoint", path, "--device", "cpu", "--slots", str(slots),
                                          "--max-delay-ms", "20", "--config", json.dumps({"model": SMALL_MODEL})])
    srv = pcoord.CoordinatorServer(port=0)
    srv.start()
    stack, beats, fc = [], [], None
    try:
        coord = (srv.host, srv.port)
        for _ in range(2):
            gw = serve_bin.build_gateway(args).start()
            tcp = pserve.ServeTCPServer(gw, port=0).start()
            stack += [gw, tcp]
            beats.append(pfleet.register_gateway(coord, tcp.host, tcp.port, lease_s=60.0))
        fc = pfleet.FleetClient(coordinator_addr=coord, timeout_s=60.0, refresh_s=0)
        rng = np.random.default_rng(4)
        obs = [[F.random_step_data(rng) for _ in range(n_steps)] for _ in range(n_sessions)]
        # half the sessions on each gateway's share of the ring (its ports
        # are drawn at random), within its slots: a fresh session past a
        # full gateway would spill to the other (FleetRouter.spill_over)
        ring = psharding.HashRing(sorted(f"{t.host}:{t.port}" for t in stack[1::2]))
        share = {a: [] for a in ring.nodes}
        for i in range(1000):
            share[ring.lookup(f"s{i}")].append(i)
        sids = [f"s{i}" for i in sorted(i for ids in share.values() for i in ids[:n_sessions // 2])]
        assert len(sids) == n_sessions
        served = [fc.act_many([{"session_id": s, "obs": obs[i][t]} for i, s in enumerate(sids)])
                  for t in range(n_steps)]
        hidden = {s: fc.hidden(s) for s in sids}
        owners = {s: fc.router.gateway_for(s) for s in sids}
        assert len(set(owners.values())) == 2
        assert owners == {s: psharding.HashRing(sorted(owners.values())).lookup(s) for s in sids}

        # the port: per gateway, an in-process gateway fed its sessions in
        # order, with the same weights and seed: bit-equal
        state = {k: v.clone() for k, v in model.state_dict().items()}
        for addr in set(owners.values()):
            mine = [i for i, s in enumerate(sids) if owners[s] == addr]
            ref = pserve.InferenceGateway(pserve.BatchedInferenceEngine(BatchedInference(
                Model(cfg), slots, seed=args.seed, device="cpu")), max_delay_s=0.02).start()
            stack.append(ref)
            ref.load_version("v1", params=state, activate=True)
            for t in range(n_steps):
                want = ref.act_many([{"session_id": sids[i], "obs": obs[i][t]} for i in mine])
                for i, w in zip(mine, want):
                    g = served[t][i]
                    assert (g["model_version"], g["session_step"]) == ("v1", t + 1)
                    for part in ("action_info", "action_logp", "logit"):
                        for k, v in w[part].items():
                            np.testing.assert_array_equal(g[part][k], v)

        # the JAX package: one gateway on the same checkpoint, with a lane
        # for every session, fed each fleet gateway's sessions in order; the
        # action-type logits and the carries within TOL (a lane's logits and
        # carry depend on its own inputs only)
        jm = JModel(jax_merge(jax_default_config(), SMALL_MODEL))
        jparams = jax.tree.map(np.asarray, jckpt.load_params(path))
        jgw = jserve.InferenceGateway(jserve.BatchedInferenceEngine(
            JaxBatchedInference(jm, jparams, n_sessions, seed=0)), max_delay_s=0.02).start()
        stack.append(jgw)
        jgw.load_version("v1", params=jparams, activate=True)
        for addr in set(owners.values()):
            mine = [i for i, s in enumerate(sids) if owners[s] == addr]
            for t in range(n_steps):
                # the first call compiles the JAX forward, which on a loaded
                # host runs past the gateway's 10 s default: a timeout that
                # covers the compile (nothing compared changes)
                want = jgw.act_many([{"session_id": sids[i], "obs": obs[i][t]} for i in mine],
                                    timeout_s=JAX_ACT_TIMEOUT_S)
                for i, w in zip(mine, want):
                    np.testing.assert_allclose(served[t][i]["logit"]["action_type"],
                                               np.asarray(w["logit"]["action_type"]), **TOL)
            for i in mine:
                for (h, c), (jh, jc) in zip(hidden[sids[i]], jgw.session_hidden(sids[i])):
                    np.testing.assert_allclose(h, np.asarray(jh), **TOL)
                    np.testing.assert_allclose(c, np.asarray(jc), **TOL)
    finally:
        if fc is not None:
            fc.close()
        for b in beats:
            b.stop_event.set()
        while stack:
            part = stack.pop()
            part.drain_and_stop() if hasattr(part, "drain_and_stop") else part.stop()
        srv.stop()
