"""The port's replay shard fleet and the launcher's replay surface on the
CPU: the port's ``ShardMap`` sends every key where the JAX one does, the
fan-in serves every shard (a JAX server among them) and tags
``info["shard"]``, a stalled shard blocks only itself, a shard stopped and
restarted on its spill directory recovers, discovery goes through the
port's ``CoordinatorServer``; ``bin/rl_train.py --type all --replay`` in
its three layouts, and the roles as processes: ``--type replay`` with a
spill directory, SIGKILLed and restarted on it, recovering every
acknowledged, unsampled insert, while a learner and an actor on
``--replay-addr`` run on and exit 0."""
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

import distar_tpu.replay as jr
from distar_tpu_torch import replay as pr
from distar_tpu_torch.bin import rl_train
from distar_tpu_torch.comm import Coordinator, CoordinatorServer
from distar_tpu_torch.learner.rl_dataloader import ReplayDataLoader
from distar_tpu_torch.obs import get_registry
from test_torch_rl_loop import LEAGUE_CFG

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(**kw):
    cfg = dict(sampler="uniform", samples_per_insert=None, max_size=512)
    cfg.update(kw)
    return cfg


def _fleet(pkgs, table=None, spill_dirs=None):
    """One server per entry of ``pkgs`` ("port" or "jax"), each over its own
    store; returns the servers and the port's ``ShardMap`` over them."""
    servers = []
    for i, name in enumerate(pkgs):
        pkg = pr if name == "port" else jr
        spill = pkg.SpillRing(spill_dirs[i]) if spill_dirs else None
        store = pkg.ReplayStore(table_factory=lambda n, pkg=pkg: pkg.TableConfig(**(table or _cfg())),
                                spill=spill, shard_id=f"s{i}", recover_encoded=True)
        store.recover()
        servers.append(pkg.ReplayServer(store, port=0).start())
    return servers, pr.ShardMap([f"{s.host}:{s.port}" for s in servers])


def test_shard_map_routes_every_key_where_the_jax_one_does():
    addrs = [f"10.0.0.{i}:{7000 + i}" for i in range(5)]
    mine, theirs = pr.ShardMap(addrs), jr.ShardMap(addrs)
    keys = [(t, f"{k:x}-{i}") for t in ("MP0", "HP1") for i, k in enumerate(range(300))]
    assert [mine.shard_for(t, k) for t, k in keys] == [theirs.shard_for(t, k) for t, k in keys]
    assert len({mine.shard_for(t, k) for t, k in keys}) == 5
    assert pr.ShardMap.parse(" a:1, b:2 ,a:1").addrs == jr.ShardMap.parse(" a:1, b:2 ,a:1").addrs == ["a:1", "b:2"]
    with pytest.raises(ValueError):
        pr.ShardMap.parse(" , ")


def test_fanin_serves_every_shard_and_tags_info():
    """Two port shards and a JAX one: inserts routed by the ring, the
    round-robin fan-in touches each, and a priority update goes back to
    exactly the shard that served the item."""
    servers, shard_map = _fleet(["port", "jax", "port"])
    ic, sc = pr.ShardedInsertClient(shard_map), pr.ShardedSampleClient(shard_map)
    try:
        for i in range(30):
            ic.insert("MP0", {"i": i}, timeout_s=5.0)
        sizes = [s.store.table("MP0").size() for s in servers]
        assert sum(sizes) == 30 and min(sizes) > 0
        seen = set()
        for _ in range(9):
            items, info = sc.sample("MP0", batch_size=2, timeout_s=5.0)
            assert len(items) == 2 and all("seq" in d for d in info)
            seen.update(d["shard"] for d in info)
        assert seen == set(shard_map.addrs)
        applied = sc.update_priorities("MP0", {info[0]["seq"]: 7.0}, info=info[:1])
        assert applied == 1
        owner = servers[shard_map.addrs.index(info[0]["shard"])]
        assert owner.store.table("MP0")._items[info[0]["seq"]].priority == 7.0
        loader = ReplayDataLoader(sc, "MP0", batch_size=2)
        assert loader.token == "MP0" and sc.sharded
    finally:
        ic.close()
        sc.close()
        for s in servers:
            s.stop()


def test_a_stalled_shard_blocks_only_itself():
    """A shard whose limiter cannot admit a sample (nothing inserted there)
    is skipped: the fan-in answers from the fed shard well within its
    timeout."""
    servers, shard_map = _fleet(["port", "port"], table=_cfg(samples_per_insert=1.0, error_buffer=8.0))
    direct = pr.InsertClient(servers[0].host, servers[0].port)
    sc = pr.ShardedSampleClient(shard_map)
    try:
        for i in range(6):
            direct.insert("MP0", i, timeout_s=5.0)
        for _ in range(3):
            t0 = time.monotonic()
            items, info = sc.sample("MP0", batch_size=2, timeout_s=10.0)
            assert time.monotonic() - t0 < 8.0
            assert {d["shard"] for d in info} == {f"{servers[0].host}:{servers[0].port}"}
    finally:
        direct.close()
        sc.close()
        for s in servers:
            s.stop()


def test_a_shard_restarted_on_its_spill_recovers(tmp_path):
    """Stop one of two shards with items acknowledged and unsampled (fifo:
    resident means unsampled); the fan-in keeps sampling the survivor;
    a new store on the victim's spill directory and port recovers its
    items, and the fan-in reaches them again."""
    dirs = [str(tmp_path / "a"), str(tmp_path / "b")]
    table = _cfg(sampler="fifo")
    servers, shard_map = _fleet(["port", "port"], table=table, spill_dirs=dirs)
    ic, sc = pr.ShardedInsertClient(shard_map), pr.ShardedSampleClient(shard_map)
    try:
        for i in range(12):
            ic.insert("MP0", {"i": i}, timeout_s=5.0)
        victim = servers[1]
        resident = sorted(it.data["i"] for it in victim.store.table("MP0")._items.values())
        assert resident
        host, port = victim.host, victim.port
        victim.stop()  # no flush: the spill's blobs are what survives
        items, info = sc.sample("MP0", batch_size=1, timeout_s=10.0)
        assert info[0]["shard"] == f"{servers[0].host}:{servers[0].port}"
        store = pr.ReplayStore(table_factory=lambda n: pr.TableConfig(**table), spill=pr.SpillRing(dirs[1]),
                               shard_id="s1", recover_encoded=True)
        assert store.recover() == len(resident)
        servers[1] = pr.ReplayServer(store, host=host, port=port).start()
        sc.close()
        sc = pr.ShardedSampleClient(pr.ShardMap([f"{host}:{port}"]))
        items, info = sc.sample("MP0", batch_size=len(resident), timeout_s=10.0)
        assert sorted(it["i"] for it in items) == resident
    finally:
        ic.close()
        sc.close()
        for s in servers:
            s.stop()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_discovery_through_the_port_coordinator(pkg):
    """Shards registered with the port's ``register_shard`` on the port's
    ``CoordinatorServer`` are read back by either package's ``discover``."""
    mod = pr if pkg == "port" else jr
    co = CoordinatorServer(coordinator=Coordinator())
    co.start()
    beats = []
    try:
        with pytest.raises(ValueError, match="no 'replay_shard' registrations"):
            mod.ShardMap.discover((co.host, co.port))
        beats.append(pr.register_shard((co.host, co.port), "10.0.0.1", 7000, meta={"admin_port": 9000},
                                       lease_s=30.0))
        beats.append(pr.register_shard((co.host, co.port), "10.0.0.2", 7000, lease_s=30.0))
        m = mod.ShardMap.discover((co.host, co.port))
        assert m.addrs == ["10.0.0.1:7000", "10.0.0.2:7000"]
        assert mod.ShardMap.discover((co.host, co.port)).addrs == m.addrs  # non-destructive
    finally:
        for b in beats:
            b.stop_event.set()
        co.stop()


# ---------------------------------------------------------------- launcher
SIZES = ["--env-num", "1", "--traj-len", "2", "--batch-size", "2", "--episode-game-loops", "60"]


@pytest.mark.parametrize("layout", [[], ["--replay-shards", "2"], ["--replay-fast-path"]],
                         ids=["one_server", "two_shards", "fast_path"])
def test_rl_train_all_replay_layouts(tmp_path, monkeypatch, capsys, layout):
    """``--type all --replay`` in each layout ends with ``rl_train done``:
    the store's inserts are the actor's acknowledged pushes, the learner's
    batches its samples (uniform, spi 2)."""
    monkeypatch.setenv("DISTAR_EXPERIMENTS_ROOT", str(tmp_path))
    pushed = lambda: sum(v for k, v in get_registry().snapshot().items()  # noqa: E731
                         if k.startswith("distar_actor_replay_pushed_total"))
    pushed0 = pushed()
    loop = rl_train.main(["--type", "all", "--replay", "--device", "cpu", "--iters", "2",
                          "--replay-sampler", "uniform", "--replay-spi", "2", *SIZES, *layout])
    out = capsys.readouterr().out
    assert "rl_train done: 2 iters" in out and loop.learner.last_iter.val == 2
    assert np.isfinite(loop.learner.variable_record.get("total_loss").avg)
    stores = loop.replay_stores
    assert len(stores) == (2 if layout == ["--replay-shards", "2"] else 1)
    assert bool(loop.replay_servers) != (layout == ["--replay-fast-path"])
    inserts = sum(s.table("MP0").limiter.state()["inserts"] for s in stores if "MP0" in s.tables())
    samples = sum(s.table("MP0").limiter.state()["samples"] for s in stores if "MP0" in s.tables())
    assert inserts == pushed() - pushed0 >= 2 and samples >= 2 * 2
    if layout == ["--replay-shards", "2"]:
        assert all(s.table("MP0").limiter.state()["inserts"] > 0 for s in stores if "MP0" in s.tables())
    if layout == ["--replay-fast-path"]:
        with pytest.raises(RuntimeError, match="no in-process replay store"):
            pr.local_store()  # the launcher cleared its registration


def _http_json(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return json.loads(resp.read())


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_rl_train_replay_role_killed_and_restarted_recovers(tmp_path):
    """``--type replay`` on a spill directory with an actor on
    ``--replay-addr``: once the limiter parks the actor (fifo, spi 1, a
    batch of 2: four inserts acknowledged and none sampled), SIGKILL the
    store and start it again on the same port and directory: it recovers
    the four. A learner on ``--replay-addr`` then trains 2 steps (exit 0,
    ``learner done``), and SIGTERM ends the actor, the store, the
    coordinator and the league with exit 0."""
    env = dict(os.environ, PYTHONPATH=REPO, DISTAR_EXPERIMENTS_ROOT=str(tmp_path), OMP_NUM_THREADS="1")
    cfg = json.dumps({"league": LEAGUE_CFG["league"]})
    spill, port = str(tmp_path / "spill"), _free_port()
    procs, logs = {}, {}

    def start(name, role, *flags):
        logs[name] = tmp_path / f"{name}.log"
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "distar_tpu_torch.bin.rl_train", "--type", role, "--device", "cpu", *flags],
            cwd=REPO, env=env, stdout=open(logs[name], "w"), stderr=subprocess.STDOUT)

    def line(name, prefix, timeout=120):
        deadline = time.time() + timeout
        while time.time() < deadline:
            for ln in logs[name].read_text().splitlines():
                if ln.startswith(prefix):
                    return ln
            assert procs[name].poll() is None, logs[name].read_text()[-3000:]
            time.sleep(0.1)
        raise AssertionError(logs[name].read_text()[-3000:])

    store_flags = ("--port", str(port), "--replay-spill-dir", spill, "--metrics-port", "0", "--batch-size", "2")
    try:
        start("coordinator", "coordinator", "--port", "0")
        start("league", "league", "--port", "0", "--config", cfg)
        start("store", "replay", *store_flags)
        co = line("coordinator", "coordinator serving on ").rsplit(" ", 1)[1]
        lg = line("league", "league serving on ").rsplit(" ", 1)[1]
        admin = line("store", "replay admin on ").split()[-1].rsplit("/replay/stats", 1)[0]
        line("store", "replay store serving on ")
        replay = ("--replay-addr", f"127.0.0.1:{port}")
        start("actor", "actor", "--coordinator-addr", co, "--league-addr", lg, *replay, *SIZES)
        deadline = time.time() + 180
        while True:
            st = _http_json(f"{admin}/replay/stats")
            lim = st.get("tables", {}).get("MP0", {}).get("limiter", {})
            if lim.get("inserts", 0) >= 4 and not lim.get("can_insert", True):
                break
            assert time.time() < deadline and procs["actor"].poll() is None, logs["actor"].read_text()[-3000:]
            time.sleep(0.2)
        acked_unsampled = st["tables"]["MP0"]["size"]
        assert acked_unsampled == lim["inserts"] == 4 and lim["samples"] == 0 and st["spill"]["live"] == 4

        procs["store"].kill()
        procs["store"].wait(timeout=30)
        start("store2", "replay", *store_flags)
        recovered = line("store2", f"replay shard :{port}: recovered ")
        assert f"recovered {acked_unsampled} acked trajectories" in recovered, recovered
        line("store2", "replay store serving on ")
        start("learner", "learner", "--coordinator-addr", co, "--league-addr", lg, *replay, "--iters", "2",
              "--save-path", str(tmp_path / "learner"), *SIZES)
        assert procs["learner"].wait(timeout=240) == 0, logs["learner"].read_text()[-3000:]
        assert "learner done: 2 iters" in logs["learner"].read_text()
        for name in ("actor", "store2", "coordinator", "league"):
            assert procs[name].poll() is None, logs[name].read_text()[-3000:]
            procs[name].send_signal(signal.SIGTERM)
            assert procs[name].wait(timeout=60) == 0, logs[name].read_text()[-3000:]
        assert "Traceback" not in logs["actor"].read_text() + logs["store2"].read_text()
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
