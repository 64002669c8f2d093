"""The port's replay store on the CPU, beside the JAX package's: the same
script of inserts, priority updates and samples through both stores gives
the same sampled sequence, ``info`` dicts and limiter state (uniform,
prioritized and fifo, a clock injected for staleness); each package
recovers the other's spill directory, a corrupt blob is skipped and
counted; each package's clients talk to the other's server over TCP and
over shared-memory rings, errors come back typed, a retried insert after a
lost ack applies once, a drain refuses new inserts and serves the rest;
``ReplayDataLoader`` collates a sample bit-equal to the JAX one; and the
RL learner's step with prefetch on is bit-equal to the step without it.

Every comparison is exact (``==`` on the records, ``np.array_equal`` on the
arrays): the store's arithmetic is host Python in both packages."""
import json
import os
import time
import urllib.request

import numpy as np
import pytest
import torch
from conftest import SMALL_MODEL

import distar_tpu.replay as jr
from distar_tpu.resilience import RetryableError as JaxRetryableError
from distar_tpu.learner.rl_dataloader import ReplayDataLoader as JaxReplayDataLoader
from distar_tpu_torch import replay as pr
from distar_tpu_torch.comm import shm_ring
from distar_tpu_torch.comm.serializer import Opaque, maybe_decode
from distar_tpu_torch.learner import RLLearner, random_rl_batch
from distar_tpu_torch.learner.hooks import LambdaHook
from distar_tpu_torch.learner.prefetch import DevicePrefetcher
from distar_tpu_torch.learner.rl_dataloader import ReplayDataLoader
from distar_tpu_torch.obs import get_registry
from distar_tpu_torch.resilience import NO_RETRY, RetryableError, RetryPolicy
from test_rl_dataloader import tiny_traj
from test_torch_actor import assert_tree_equal

torch.set_num_threads(1)

PKGS = {"port": pr, "jax": jr}


class Clock:
    """``time.time`` for both stores (each calls it through the ``time``
    module): advanced by the script, so staleness is exact."""

    def __init__(self):
        self.now = 1_000_000.0

    def __call__(self):
        return self.now


def _script(sampler, seed=0, n=60):
    """A seeded mix of inserts (random priorities), priority updates of
    seqs that may or may not be live, samples of 1-3 items, and clock
    steps."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        r = rng.random()
        if r < 0.45:
            ops.append(("insert", round(float(rng.uniform(0.1, 5.0)), 3)))
        elif r < 0.6 and sampler == "prioritized":
            ops.append(("update", {int(s): round(float(rng.uniform(0.1, 9.0)), 3)
                                   for s in rng.integers(0, 30, size=3)}))
        elif r < 0.9:
            ops.append(("sample", int(rng.integers(1, 4))))
        else:
            ops.append(("tick", float(rng.integers(1, 4))))
    return ops


def _run_script(pkg, sampler, ops, clock, monkeypatch):
    """The script through one package's store; every outcome recorded
    (an inadmissible op records its typed error's code)."""
    monkeypatch.setattr(time, "time", clock)
    spi = 1.0 if sampler == "fifo" else 2.0
    cfg = pkg.TableConfig(max_size=6, sampler=sampler, samples_per_insert=spi, min_size_to_sample=2,
                          error_buffer=3.0, max_staleness_s=7.0, seed=5, priority_exponent=0.8)
    store = pkg.ReplayStore(table_factory=lambda name: cfg)
    out = []
    for i, (op, arg) in enumerate(ops):
        try:
            if op == "insert":
                out.append(("insert", store.insert("T", {"i": i}, priority=arg, timeout_s=0.0)))
            elif op == "update":
                out.append(("update", store.update_priorities("T", arg)))
            elif op == "sample":
                got = store.sample("T", batch_size=arg, timeout_s=0.0)
                out.append(("sample", [s.data["i"] for s in got], [s.info() for s in got]))
            else:
                clock.now += arg
        except pkg.ReplayError as e:
            out.append((op, "error", e.code))
        out.append(("state", store.table("T").limiter.state()))
    stats = store.stats()["tables"]["T"]
    return out, {k: stats[k] for k in ("size", "max_size", "occupancy", "sampler")}


@pytest.mark.parametrize("sampler", ["uniform", "prioritized", "fifo"])
def test_store_samples_the_jax_sequence(sampler, monkeypatch):
    ops = _script(sampler, seed={"uniform": 1, "prioritized": 2, "fifo": 3}[sampler])
    got = _run_script(pr, sampler, ops, Clock(), monkeypatch)
    want = _run_script(jr, sampler, ops, Clock(), monkeypatch)
    assert got == want
    samples = [rec for rec in got[0] if rec[0] == "sample" and rec[1] != "error"]
    assert len(samples) >= 5 and any(rec[0] == "sample" and rec[1] == "error" for rec in got[0])
    if sampler != "fifo":  # with replacement: some item sampled twice
        assert any(d["sample_count"] > 1 for rec in samples for d in rec[2])


def test_limiter_errors_are_the_jax_ones():
    for pkg in PKGS.values():
        with pytest.raises(ValueError, match="fifo"):
            pkg.TableConfig(sampler="fifo", samples_per_insert=2.0)
        store = pkg.ReplayStore(table_factory=lambda name: pkg.TableConfig(
            sampler="uniform", samples_per_insert=2.0, error_buffer=2.0))
        assert store.table("T").limiter.max_sample_batch() == 4.0
        with pytest.raises(pkg.InvalidBatchError, match="can never be admitted"):
            store.sample("T", batch_size=5, timeout_s=30.0)
    lims = [pkg.RateLimiter(samples_per_insert=3.0, min_size_to_sample=2, error_buffer=4.0) for pkg in PKGS.values()]
    for lim in lims:
        lim.commit_insert(5)
        lim.commit_sample(7)
    assert lims[0].state() == lims[1].state()
    assert [lim.max_sample_batch() for lim in lims] == [7.0, 7.0]


# ------------------------------------------------------------------- spill
def _traj_item(rng):
    return [{"obs": rng.standard_normal((3, 4)).astype(np.float32), "n": int(rng.integers(0, 9)),
             "s": "x" * int(rng.integers(1, 5))} for _ in range(3)]


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_spill_written_by_one_package_is_recovered_by_the_other(tmp_path, writer, reader):
    rng = np.random.default_rng(7)
    items = [_traj_item(rng) for _ in range(5)]
    w, r = PKGS[writer], PKGS[reader]
    cfg = lambda name: w.TableConfig(sampler="uniform", samples_per_insert=None)  # noqa: E731
    store = w.ReplayStore(table_factory=cfg, spill=w.SpillRing(str(tmp_path), max_items=64, manifest_every=2))
    for i, item in enumerate(items):
        store.insert("MP0" if i % 2 else "HP0", item, priority=1.0 + i, timeout_s=1.0)
    store.sample("HP0", batch_size=1)  # the first sample releases its blob: not recovered
    store._spill.flush()
    live = sorted(os.listdir(tmp_path))
    assert "MANIFEST" in live and len(live) == 5  # four blobs and the manifest

    back = r.ReplayStore(table_factory=lambda name: r.TableConfig(sampler="fifo", samples_per_insert=None),
                         spill=r.SpillRing(str(tmp_path), max_items=64))
    assert back.recover() == 4
    got = {name: [(it.data, it.priority) for it in back.table(name)._items.values()] for name in back.tables()}
    assert sorted(got) == ["HP0", "MP0"] and len(got["HP0"]) == 2
    assert [p for _, p in got["MP0"]] == [2.0, 4.0]
    assert {p for _, p in got["HP0"]} < {1.0, 3.0, 5.0}
    for data, prio in got["HP0"] + got["MP0"]:  # priority 1 + i names item i
        assert_tree_equal(data, items[int(prio) - 1])
    # the key sequence continues past the highest key on disk
    top = max(int(n[:-len(".spill")].rsplit("-", 1)[1]) for n in live if n.endswith(".spill"))
    assert back._spill.reserve_key("MP0") == f"MP0-{top + 1:012d}"


def test_spill_recovers_encoded_payloads_and_skips_a_corrupt_blob(tmp_path):
    """``recover_encoded``: items come back as ``Opaque`` payloads that
    decode to the inserted objects; a blob with a flipped byte is skipped,
    unlinked and counted."""
    rng = np.random.default_rng(8)
    items = [_traj_item(rng) for _ in range(3)]
    store = pr.ReplayStore(table_factory=lambda n: pr.TableConfig(samples_per_insert=None),
                           spill=pr.SpillRing(str(tmp_path)))
    for item in items:
        store.insert("T", item)
    blob = tmp_path / f"T-{1:012d}.spill"
    raw = bytearray(blob.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    blob.write_bytes(bytes(raw))
    corrupt = lambda: get_registry().snapshot().get("distar_replay_spill_corrupt_total", 0.0)  # noqa: E731
    before = corrupt()
    back = pr.ReplayStore(table_factory=lambda n: pr.TableConfig(samples_per_insert=None),
                          spill=pr.SpillRing(str(tmp_path)), recover_encoded=True)
    assert back.recover() == 2 and corrupt() == before + 1
    assert not blob.exists()
    data = [it.data for it in back.table("T")._items.values()]
    assert all(isinstance(d, Opaque) for d in data)
    for d, item in zip(data, (items[0], items[2])):
        assert_tree_equal(maybe_decode(d), item)
    # the local client decodes them for the learner
    got, info = pr.LocalReplayClient(back).sample("T", batch_size=1)
    assert isinstance(got[0], list) and info[0]["seq"] in (0, 1)


def test_insert_spills_before_the_ack_and_releases_on_a_timeout(tmp_path):
    spill = pr.SpillRing(str(tmp_path))
    store = pr.ReplayStore(table_factory=lambda n: pr.TableConfig(
        samples_per_insert=1.0, min_size_to_sample=1, error_buffer=1.0), spill=spill)
    store.insert("T", {"a": 1}, timeout_s=1.0)
    store.insert("T", {"a": 2}, timeout_s=1.0)
    assert spill.live_count() == 2
    with pytest.raises(pr.RateLimitTimeout):
        store.insert("T", {"a": 3}, timeout_s=0.05)
    assert spill.live_count() == 2  # the refused insert's blob released


# -------------------------------------------------------------------- wire
def _pair(server_pkg, spill=None, **table):
    pkg = PKGS[server_pkg]
    cfg = dict(sampler="fifo", samples_per_insert=None)
    cfg.update(table)
    store = pkg.ReplayStore(table_factory=lambda name: pkg.TableConfig(**cfg), spill=spill)
    return store, pkg.ReplayServer(store, port=0).start()


TRANSPORTS = ["tcp"] + (["shm"] if shm_ring.shm_available() else [])


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("client_pkg,server_pkg", [("port", "jax"), ("jax", "port")])
def test_clients_talk_to_the_other_packages_server(client_pkg, server_pkg, transport):
    rng = np.random.default_rng(9)
    items = [_traj_item(rng) for _ in range(4)]
    store, server = _pair(server_pkg)
    cpkg = PKGS[client_pkg]
    ins = cpkg.InsertClient(server.host, server.port, transport=transport)
    smp = cpkg.SampleClient(server.host, server.port, transport=transport)
    try:
        seqs = [ins.insert("MP0", item, priority=2.0) for item in items]
        assert seqs == [0, 1, 2, 3]
        assert ins.transport_active == transport and ins.ping()
        got, info = smp.sample("MP0", batch_size=3, timeout_s=10.0)
        assert smp.transport_active == transport
        for g, item in zip(got, items):
            assert_tree_equal(g, item)
        assert [d["seq"] for d in info] == [0, 1, 2] and all(d["priority"] == 2.0 for d in info)
        assert smp.tables() == ["MP0"] and smp.stats()["tables"]["MP0"]["size"] == 1
        assert server.transport_counts()[transport] == 2
    finally:
        ins.close()
        smp.close()
        server.stop()


@pytest.mark.parametrize("client_pkg,server_pkg", [("port", "jax"), ("jax", "port"), ("port", "port")])
def test_errors_come_back_typed(client_pkg, server_pkg):
    cpkg = PKGS[client_pkg]
    spkg = PKGS[server_pkg]
    store = spkg.ReplayStore()  # no factory: unknown tables stay unknown
    store.create_table("T", spkg.TableConfig(sampler="uniform", samples_per_insert=2.0, error_buffer=2.0))
    server = spkg.ReplayServer(store, port=0).start()
    client = cpkg.SampleClient(server.host, server.port, retry_policy=NO_RETRY, transport="tcp")
    try:
        with pytest.raises(cpkg.UnknownTableError):
            client.sample("nope", batch_size=1, timeout_s=0.1)
        with pytest.raises(cpkg.InvalidBatchError):
            client.sample("T", batch_size=5, timeout_s=0.1)
        with pytest.raises(cpkg.RateLimitTimeout) as err:
            client.sample("T", batch_size=1, timeout_s=0.1)
        assert isinstance(err.value, RetryableError if client_pkg == "port" else JaxRetryableError)
        assert err.value.side == "sample" and err.value.state["inserts"] == 0
    finally:
        client.close()
        server.stop()


def test_error_wire_dicts_are_the_jax_ones():
    for cls in ("UnknownTableError", "InvalidBatchError", "StoreDrainingError", "ItemCorruptError"):
        wire = getattr(pr, cls)("why").to_wire()
        assert wire == getattr(jr, cls)("why").to_wire()
        assert type(pr.error_from_wire(wire)).__name__ == type(jr.error_from_wire(wire)).__name__ == cls
    wire = {"code": "rate_limited", "side": "insert", "timeout_s": 2.0, "state": {"inserts": 3}}
    got, want = pr.error_from_wire(wire), jr.error_from_wire(wire)
    assert (str(got), got.side, got.state) == (str(want), want.side, want.state)
    assert type(pr.error_from_wire({"code": "new"})) is pr.ReplayError


def test_retried_insert_after_a_lost_ack_applies_once(tmp_path):
    """The server commits (table and spill), the connection dies before the
    ack: the client's retry carries the same idempotency key and gets the
    original seq, one item, one blob."""
    spill = pr.SpillRing(str(tmp_path))
    store, server = _pair("port", spill=spill)
    original = server._send_counted
    dropped = []

    def drop_first_ack(conn, obj, compress, codec="lz4"):
        if not dropped and isinstance(obj, dict) and "seq" in obj:
            dropped.append(obj["seq"])
            conn.close()
            raise ConnectionError("ack dropped after the commit")
        return original(conn, obj, compress, codec)

    server._send_counted = drop_first_ack
    client = pr.InsertClient(server.host, server.port, transport="tcp",
                             retry_policy=RetryPolicy(max_attempts=4, backoff_base_s=0.01, deadline_s=10.0))
    try:
        assert client.insert("T", {"v": 1}, timeout_s=5.0) == dropped[0] == 0
        assert store.table("T").size() == 1 and spill.live_count() == 1
        assert client.insert("T", {"v": 2}, timeout_s=5.0) == 1  # a new insert is not deduplicated
    finally:
        client.close()
        server.stop()


def _http(url, data=None):
    req = urllib.request.Request(url, data=data, method="POST" if data is not None else "GET")
    with urllib.request.urlopen(req, timeout=10) as resp:
        return resp.read().decode()


def test_drain_refuses_new_inserts_and_serves_the_rest():
    store, server = _pair("port", sampler="uniform")
    admin = pr.ReplayAdminServer(store, port=0, server=server).start()
    ins = pr.InsertClient(server.host, server.port, retry_policy=NO_RETRY)
    smp = jr.SampleClient(server.host, server.port, retry_policy=NO_RETRY)
    try:
        ins.insert("T", {"v": 1})
        ins.insert("T", {"v": 2})
        stats = json.loads(_http(f"http://{admin.host}:{admin.port}/replay/stats"))
        assert stats["tables"]["T"]["size"] == 2 and sum(stats["transports"].values()) == 1  # the sampler dials lazily
        assert "distar_replay_inserts_total" in _http(f"http://{admin.host}:{admin.port}/metrics")
        drained = json.loads(_http(f"http://{admin.host}:{admin.port}/drain", data=b"{}"))
        assert drained == {"code": 0, "info": {"draining": True, "resident": 2}}
        with pytest.raises(pr.StoreDrainingError):
            ins.insert("T", {"v": 3})
        items, _ = smp.sample("T", batch_size=2, timeout_s=5.0)
        assert sorted(i["v"] for i in items) in ([1, 1], [1, 2], [2, 2])
    finally:
        ins.close()
        smp.close()
        admin.stop()
        server.stop()


def test_replay_server_process_prints_the_jax_line_and_recovers(tmp_path):
    """``python -m distar_tpu_torch.replay.server`` (the standalone shard):
    its first line is ``REPLAY-SHARD host port recovered=N``; on stdin EOF
    it exits 0; a restart on its spill recovers what was acknowledged."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    argv = [sys.executable, "-m", "distar_tpu_torch.replay.server", "--spill-dir", str(tmp_path),
            "--sampler", "fifo"]
    env = dict(os.environ, PYTHONPATH=repo)
    for run, recovered in ((0, 0), (1, 2)):
        proc = subprocess.Popen(argv, cwd=repo, env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                text=True)
        try:
            head = proc.stdout.readline().split()
            assert head[0] == "REPLAY-SHARD" and head[3] == f"recovered={recovered}", head
            if run == 0:
                with jr.InsertClient(head[1], int(head[2])) as client:
                    client.insert("T", {"v": 1})
                    client.insert("T", {"v": 2})
            proc.stdin.close()
            assert proc.wait(timeout=30) == 0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


# ---------------------------------------------------------- data loader
def test_replay_dataloader_collates_the_jax_batch(monkeypatch):
    """Two stores, the same seed and inserts: the port's and the JAX
    package's loaders sample the same items and collate them bit-equal;
    ``update_priorities`` reaches the table."""
    monkeypatch.setattr(time, "time", Clock())  # staleness in the sample info
    batches = {}
    for name, loader_cls in (("port", ReplayDataLoader), ("jax", JaxReplayDataLoader)):
        store = pr.ReplayStore(table_factory=lambda n: pr.TableConfig(sampler="prioritized",
                                                                      samples_per_insert=None, seed=3))
        rng = np.random.default_rng(4)
        for i in range(6):
            traj = tiny_traj(sun=int(rng.integers(0, 4)), done=bool(i % 2))
            traj[0]["model_last_iter"] = float(i)
            store.insert("MP0", traj, priority=float(rng.uniform(0.5, 3.0)))
        loader = loader_cls(pr.LocalReplayClient(store), "MP0", batch_size=3)
        batches[name] = (next(loader), next(loader), [dict(d) for d in loader.last_sample_info])
        assert loader.update_priorities({loader.last_sample_info[0]["seq"]: 9.0}) == 1
        assert store.table("MP0")._items[loader.last_sample_info[0]["seq"]].priority == 9.0
    for got, want in zip(batches["port"][:2], batches["jax"][:2]):
        assert_tree_equal(got, want)
    assert batches["port"][2] == batches["jax"][2]


def test_sharded_loader_routes_priority_updates_by_shard():
    class Fanin:
        sharded = True

        def __init__(self):
            self.calls = []

        def sample(self, table, batch_size, timeout_s):
            return [tiny_traj() for _ in range(batch_size)], [{"seq": i, "shard": "a:1"} for i in range(batch_size)]

        def update_priorities(self, table, updates, info=None):
            self.calls.append((table, updates, info))
            return len(updates)

    fanin = Fanin()
    loader = ReplayDataLoader(fanin, "MP0", batch_size=2)
    next(loader)
    assert loader.update_priorities({1: 2.0}) == 1
    assert fanin.calls == [("MP0", {1: 2.0}, [{"seq": 0, "shard": "a:1"}, {"seq": 1, "shard": "a:1"}])]


# ---------------------------------------------------------------- prefetch
def _rl_learner(depth):
    return RLLearner({"learner": {"batch_size": 2, "unroll_len": 2, "prefetch_depth": depth, "log_freq": 10,
                                  "save_grad": True},
                      "model": SMALL_MODEL}, device="cpu")


def test_rl_step_with_prefetch_is_bit_equal_to_the_step_without():
    """``run()`` with ``learner.prefetch_depth`` 2 (``_place_batch`` on the
    prefetcher's thread) against 0, on the same two batches from the same
    weights: every logged scalar (loss, info, per-parameter gradient norms),
    every gradient and every new parameter bit-equal."""
    rng = np.random.default_rng(21)
    batches = [random_rl_batch(2, 2, rng, hidden_size=32, hidden_layers=1) for _ in range(2)]
    runs = {}
    for depth in (2, 0):
        lrn = _rl_learner(depth)
        grads, real_step = [], lrn.optimizer.step
        lrn.optimizer.step = lambda g, real_step=real_step, grads=grads: (
            grads.append([t.clone() for t in g]), real_step(g))[1]
        logs = []
        lrn.hooks.add(LambdaHook("record", "after_iter", lambda lr, logs=logs: logs.append(dict(lr.last_log))))
        lrn.set_dataloader(iter(batches))
        lrn.run(2)
        assert isinstance(lrn._dataloader, DevicePrefetcher) == (depth == 2)
        runs[depth] = (logs, grads, {n: p.detach().clone() for n, p in lrn.model.named_parameters()})
    (logs2, grads2, params2), (logs0, grads0, params0) = runs[2], runs[0]
    assert len(logs2) == 2 and logs2 == logs0
    assert any(k.startswith("grad_norm/") for k in logs2[0])
    for a, b in zip(grads2, grads0):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(params2[k], params0[k]) for k in params0)


def test_place_batch_keeps_host_fields_on_the_host():
    lrn = _rl_learner(2)
    batch = random_rl_batch(2, 2, np.random.default_rng(0), hidden_size=32, hidden_layers=1)
    batch["trace_span_ids"], batch["trace_age_s"] = ["a", "b"], np.ones(2, np.float32)
    placed = lrn._place_batch(batch)
    assert placed["_on_device"] is True and placed["trace_span_ids"] == ["a", "b"]
    assert isinstance(placed["model_last_iter"], np.ndarray) and isinstance(placed["trace_age_s"], np.ndarray)
    assert placed["reward"]["winloss"].dtype == torch.float32
    assert isinstance(placed["hidden_state"][0][0], torch.Tensor)
