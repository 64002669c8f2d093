"""The port's learner runtime against the JAX package's, on the CPU.

Storage listing and deletion; the ``latest`` pointer (keep, roles, a torn
pointer, the fallback counter), written by either package and read by the
other; the partial restore; the asynchronous writer and ``auto_checkpoint``;
hooks, the supervisor, the prefetcher, the meters and the admin routes;
and the learner state in the JAX package's layout: the optax chain state of
every optimizer config held against optax on the same gradients (rtol 1e-5,
tests/test_torch_train.py's optimizer tolerance), and the RL learner's and
the student's checkpoints crossing both ways bit for bit. The JAX RL and
distillation learners are built once for the module (their init compiles;
their train steps never run here).
"""
import json
import os
import signal
import threading
import time
import types
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from conftest import SMALL_MODEL

from distar_tpu.learner import DistillLearner as JDistillLearner
from distar_tpu.learner import RLLearner as JRLLearner
from distar_tpu.learner.prefetch import DevicePrefetcher as JDevicePrefetcher
from distar_tpu.parallel import GradClipConfig as JClipConfig
from distar_tpu.parallel import build_optimizer as jax_build_optimizer
from distar_tpu.utils import checkpoint as jckpt
from distar_tpu.utils import log as jlog
from distar_tpu.utils import storage as jstorage
from distar_tpu_torch.actor.inference import to_device
from distar_tpu_torch.learner import DistillLearner, RLLearner, SLLearner, fake_sl_batch
from distar_tpu_torch.learner.hooks import (
    Hook,
    HookRegistry,
    LambdaHook,
    LoadCkptHook,
    SaveCkptHook,
    default_hooks,
)
from distar_tpu_torch.learner.prefetch import DevicePrefetcher, place_on
from distar_tpu_torch.model.convert import learner_state_to_flax, load_learner_state, params_to_flax
from distar_tpu_torch.obs import JsonlExporter, MetricsRegistry, set_registry
from distar_tpu_torch.parallel import GradClipConfig, build_optimizer
from distar_tpu_torch.resilience import RestartPolicy, Supervisor, supervise_call
from distar_tpu_torch.utils import AverageMeter, EMAMeter, EasyTimer, ScalarSink, StopWatch, VariableRecord
from distar_tpu_torch.utils import checkpoint as ckpt
from distar_tpu_torch.utils import storage

torch.set_num_threads(1)

B, T = 2, 2


@pytest.fixture
def registry():
    reg = MetricsRegistry()
    prev = set_registry(reg)
    yield reg
    set_registry(prev)


def _state(v=1.0):
    return {"params": {"w": np.full((4, 4), v, np.float32), "b": np.zeros(4, np.float32)},
            "step": np.asarray(3)}


def _leaves(tree, prefix=()):
    """{path: leaf} of a tree of dicts, tuples and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_leaves(v, prefix + (str(k),)))
    return out


def assert_trees_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert set(got) == set(want)
    for k, w in want.items():
        g, w = np.asarray(got[k]), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg="/".join(k))


# --------------------------------------------------------------- storage
@pytest.mark.parametrize("root", ["local", "mem://runtime"])
def test_storage_delete_and_list_match_jax(tmp_path, root):
    base = str(tmp_path) if root == "local" else root
    paths = [f"{base}/ckpt/iteration_{i}.ckpt" for i in (2, 10, 4)]
    for p in paths:
        storage.write_bytes(p, p.encode())
    port_backend, rest = storage.resolve(f"{base}/ckpt/iteration_")
    jax_backend, jrest = jstorage.resolve(f"{base}/ckpt/iteration_")
    listed = list(port_backend.list(rest))
    if root == "local":
        assert listed == list(jax_backend.list(jrest))
    assert listed == sorted(storage.resolve(p)[1] for p in paths)
    storage.delete(paths[0])
    assert not storage.exists(paths[0]) and storage.exists(paths[1])
    assert list(port_backend.list(rest)) == sorted(storage.resolve(p)[1] for p in paths[1:])
    with pytest.raises(FileNotFoundError):
        storage.delete(paths[0])


# --------------------------------------------------- checkpoint manager
def _generation(tmp_path, name, step, v):
    path = str(tmp_path / name)
    ckpt.save_checkpoint(path, _state(v), metadata={"last_iter": step})
    return path


def test_manager_keeps_the_newest_and_isolates_roles(tmp_path):
    teacher = ckpt.CheckpointManager(str(tmp_path), keep=2)
    student = ckpt.CheckpointManager(str(tmp_path), keep=2, role="student")
    paths = [_generation(tmp_path, f"g{i}.ckpt", i, float(i)) for i in range(3)]
    for i, p in enumerate(paths):
        teacher.record(p, step=i)
    student.record(paths[0], step=0)
    assert [g["step"] for g in teacher.generations()] == [2, 1]
    assert [g["path"] for g in student.generations()] == [paths[0]]
    assert student.pointer_path.endswith("latest_student.json")
    # a hand-merged pointer cannot hand the teacher a student's generation
    data = json.loads(storage.read_bytes(teacher.pointer_path))
    data["generations"].insert(0, {"path": paths[0], "step": 9, "role": "student"})
    storage.write_bytes(teacher.pointer_path, json.dumps(data).encode())
    assert teacher.resolve_latest()["step"] == 2
    with pytest.raises(ValueError):
        ckpt.CheckpointManager(str(tmp_path), keep=0)


@pytest.mark.parametrize("torn", [b'{"generations": [{"path": ', b"[1, 2]", b""])
def test_a_torn_pointer_means_no_resume(tmp_path, torn):
    mgr = ckpt.CheckpointManager(str(tmp_path))
    storage.write_bytes(mgr.pointer_path, torn)
    assert mgr.generations() == [] and mgr.resolve_latest() is None and mgr.load_latest() is None


def test_manager_falls_back_past_a_corrupt_generation_and_counts_it(tmp_path, registry):
    mgr = ckpt.CheckpointManager(str(tmp_path))
    old, new = _generation(tmp_path, "a.ckpt", 1, 1.0), _generation(tmp_path, "b.ckpt", 2, 2.0)
    mgr.record(old, step=1)
    mgr.record(new, step=2)
    blob = storage.read_bytes(new)
    storage.write_bytes(new, blob[: len(blob) // 2])  # a torn write
    assert mgr.resolve_latest()["path"] == old
    assert mgr.load_latest()["metadata"]["last_iter"] == 1
    assert registry.snapshot()["distar_resilience_ckpt_fallbacks_total"] == 2


@pytest.mark.parametrize("role", ["", "student"])
def test_pointer_written_by_either_package_is_read_by_the_other(tmp_path, role):
    paths = [_generation(tmp_path, f"g{i}.ckpt", i, float(i)) for i in range(3)]
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jmgr, pmgr = jckpt.CheckpointManager(jdir, keep=2, role=role), ckpt.CheckpointManager(pdir, keep=2, role=role)
    for i, p in enumerate(paths):
        jmgr.record(p, step=i)
        pmgr.record(p, step=i)
    assert ckpt.CheckpointManager(jdir, role=role).generations() == jmgr.generations()
    assert jckpt.CheckpointManager(pdir, role=role).generations() == pmgr.generations()
    strip = [{k: v for k, v in g.items() if k != "ts"} for g in pmgr.generations()]
    assert strip == [{k: v for k, v in g.items() if k != "ts"} for g in jmgr.generations()]
    assert os.path.basename(pmgr.pointer_path) == os.path.basename(jmgr.pointer_path)
    out = jckpt.CheckpointManager(pdir, role=role).load_latest()
    np.testing.assert_array_equal(out["state"]["params"]["w"], np.full((4, 4), 2.0, np.float32))


def test_partial_restore_matches_jax(tmp_path):
    path = str(tmp_path / "c.ckpt")
    ckpt.save_checkpoint(path, {"params": {"w": np.ones(2), "legacy": np.zeros(1)},
                                "opt": ((), (np.int32(3), {"m": np.ones(2)}))})
    target = {"params": {"w": np.zeros(2), "new_head": np.full(3, 9.0)},
              "opt": (optax.EmptyState(), (np.int32(0), {"m": np.zeros(2)}), np.ones(1))}
    got = ckpt.load_checkpoint(path, target=target)["state"]
    want = jckpt.load_checkpoint(path, target=target)["state"]
    assert_trees_equal(got, want)
    assert "legacy" not in got["params"] and isinstance(got["opt"][0], optax.EmptyState)
    np.testing.assert_array_equal(got["params"]["new_head"], np.full(3, 9.0))


# ------------------------------------------------- async writer and crash
def _gated_writer(monkeypatch):
    gate = threading.Event()
    real = ckpt._write_checkpoint

    def gated(path, host_state, metadata):
        assert gate.wait(10.0)
        return real(path, host_state, metadata)

    monkeypatch.setattr(ckpt, "_write_checkpoint", gated)
    return gate


def test_async_checkpointer_publishes_only_durable_bytes(tmp_path, monkeypatch):
    """``save`` returns while the write waits; the host copy is taken
    before that, so a later in-place update does not reach the file; and
    ``on_complete`` fires only once the blob and its manifest verify."""
    gate = _gated_writer(monkeypatch)
    path = str(tmp_path / "a.ckpt")
    seen = []
    live = {"w": torch.ones(8)}
    ck = ckpt.AsyncCheckpointer()
    ck.save(path, live, metadata={"last_iter": 1},
            on_complete=lambda p: seen.append(ckpt.verify_checkpoint(p) and storage.exists(p + ".manifest")))
    live["w"].fill_(-1.0)  # the next step updating in place
    assert seen == [] and not os.path.exists(path)
    gate.set()
    ck.wait()
    assert seen == [True]
    np.testing.assert_array_equal(ckpt.load_checkpoint(path)["state"]["w"], np.ones(8, np.float32))


def test_async_checkpointer_raises_a_failed_write(tmp_path, monkeypatch):
    def boom(path, host_state, metadata):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "_write_checkpoint", boom)
    published = []
    ck = ckpt.AsyncCheckpointer()
    ck.save(str(tmp_path / "x.ckpt"), _state(), on_complete=published.append)
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        ck.wait()
    assert published == []
    ck.wait()  # the error is raised once


def test_auto_checkpoint_saves_on_an_exception_and_reraises():
    saved = []

    @ckpt.auto_checkpoint(lambda: saved.append("save"))
    def run():
        raise RuntimeError("crash mid-run")

    with pytest.raises(RuntimeError, match="crash mid-run"):
        run()
    assert saved == ["save"]
    assert signal.getsignal(signal.SIGTERM) is not None  # handlers restored


def test_auto_checkpoint_saves_on_sigterm_after_the_guarded_span():
    """SIGTERM inside the guard (an optimizer step) waits for the span's
    end, then saves and exits; outside a span it acts at once."""
    events = []
    guard = ckpt.SignalGuard()
    before = signal.getsignal(signal.SIGTERM)

    @ckpt.auto_checkpoint(lambda: events.append("save"), guard=guard)
    def run():
        with guard:
            os.kill(os.getpid(), signal.SIGTERM)
            time.sleep(0.01)
            events.append("step finished")
        events.append("after the span")

    with pytest.raises(SystemExit, match="signal"):
        run()
    assert events == ["step finished", "save"]
    assert signal.getsignal(signal.SIGTERM) is before

    events.clear()

    @ckpt.auto_checkpoint(lambda: events.append("save"), guard=guard)
    def idle():
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(0.01)
        events.append("not reached")

    with pytest.raises(SystemExit):
        idle()
    assert events == ["save"]


# ------------------------------------------------------------------ hooks
def _fake_learner(iter_val=0):
    return types.SimpleNamespace(last_iter=types.SimpleNamespace(val=iter_val), rank=0,
                                 logger=types.SimpleNamespace(info=lambda *a, **k: None))


def test_hooks_run_in_priority_order_and_freq_gates_iter_positions_only():
    reg = HookRegistry()
    order = []
    reg.add(LambdaHook("b", "after_iter", lambda _: order.append("b"), priority=60))
    reg.add(LambdaHook("a", "after_iter", lambda _: order.append("a"), priority=10))
    reg.add(LambdaHook("c", "after_iter", lambda _: order.append("c"), priority=30, freq=2))
    reg.add(LambdaHook("r", "before_run", lambda _: order.append("r"), freq=1000))
    learner = _fake_learner(iter_val=1)
    reg.call("after_iter", learner)
    assert order == ["a", "b"]
    order.clear()
    learner.last_iter.val = 2
    reg.call("after_iter", learner)
    assert order == ["a", "c", "b"]
    order.clear()
    reg.call("before_run", learner)
    assert order == ["r"]


def test_hook_positions_are_validated_and_the_profiler_hook_raises():
    with pytest.raises(ValueError, match="mid_iter"):
        Hook("x", "mid_iter")
    # profile_freq above 0 adds the profiler hook (it raised until obs/profiler.py was ported)
    reg = default_hooks(profile_freq=10, profile_duration=3, profile_logdir="profiles")
    (hook,) = [h for h in reg._hooks["after_iter"] if h.name == "profiler"]
    assert (hook._freq, hook._duration, hook.session.logdir) == (10, 3, "profiles")
    assert not [h for h in default_hooks()._hooks["after_iter"] if h.name == "profiler"]


def test_save_hook_is_rank_gated_and_load_hook_skips_a_missing_path(tmp_path):
    learner = _fake_learner(iter_val=5)
    saved = []
    learner.save = saved.append
    learner.checkpoint_path = lambda: str(tmp_path / "c.ckpt")
    learner.rank = 1
    SaveCkptHook()(learner)
    assert saved == []
    learner.rank = 0
    SaveCkptHook()(learner)
    assert saved == [str(tmp_path / "c.ckpt")]
    learner.cfg = types.SimpleNamespace(learner={"load_path": str(tmp_path / "nope.ckpt")})
    learner.restore = lambda p: pytest.fail("restored a missing path")
    LoadCkptHook()(learner)


# ------------------------------------------------------------- supervisor
def test_supervisor_restarts_a_crashing_task(registry):
    runs, done = [], threading.Event()

    def task(ctx):
        runs.append(1)
        if len(runs) < 3:
            raise RuntimeError("injected crash")
        done.set()
        while not ctx.should_exit:
            time.sleep(0.01)

    sup = Supervisor(policy=RestartPolicy(max_restarts=5, backoff_base_s=0.01, backoff_max_s=0.05))
    sup.add("worker", task).start()
    assert done.wait(5.0)
    sup.stop()
    st = sup.status()["worker"]
    assert len(runs) == 3 and st["restarts"] == 2 and not st["gave_up"] and not st["alive"]
    assert registry.snapshot()["distar_resilience_restarts_total{task=worker}"] == 2


def test_supervisor_gives_up_when_the_budget_is_spent(registry):
    gave = []

    def always_crash(ctx):
        raise RuntimeError("permafail")

    sup = Supervisor(policy=RestartPolicy(max_restarts=2, window_s=60.0, backoff_base_s=0.01,
                                          backoff_max_s=0.02))
    sup.add("worker", always_crash, on_giveup=gave.append).start()
    sup.join(timeout=5.0)
    st = sup.status()["worker"]
    assert st["gave_up"] and st["restarts"] == 2 and len(gave) == 1
    assert registry.snapshot()["distar_resilience_task_giveups_total{task=worker}"] == 1


def test_supervise_call_resumes_then_reraises_past_the_budget(registry):
    attempts, resumed = [], []

    def run():
        attempts.append(1)
        if len(attempts) < 3:
            raise RuntimeError("boom")

    policy = RestartPolicy(max_restarts=5, backoff_base_s=0.0)
    supervise_call(run, op="learner", policy=policy, on_restart=resumed.append, sleep=lambda s: None)
    assert len(attempts) == 3 and len(resumed) == 2

    def always():
        raise RuntimeError("permafail")

    with pytest.raises(RuntimeError, match="permafail"):
        supervise_call(always, op="x", policy=RestartPolicy(max_restarts=2), sleep=lambda s: None)
    snap = registry.snapshot()
    assert snap["distar_resilience_restarts_total{task=x}"] == 2
    assert snap["distar_resilience_task_giveups_total{task=x}"] == 1
    with pytest.raises(SystemExit):
        supervise_call(lambda: (_ for _ in ()).throw(SystemExit(1)), sleep=lambda s: None)


# -------------------------------------------------------------- prefetch
def test_prefetcher_order_and_placing_match_jax():
    batches = [{"i": i} for i in range(5)]
    place = lambda b: {**b, "placed": True}  # noqa: E731
    got = list(DevicePrefetcher(iter(batches), place, depth=2))
    assert got == list(JDevicePrefetcher(iter(batches), place, depth=2))
    assert [b["i"] for b in got] == list(range(5)) and all(b["placed"] for b in got)
    batch = fake_sl_batch(1, 2)
    placed = place_on(batch, torch.device("cpu"))
    want = to_device(batch, "cpu")
    assert all(torch.equal(placed["entity_info"][k], want["entity_info"][k]) for k in want["entity_info"])


def test_prefetcher_raises_the_sources_error_then_ends():
    def source():
        yield {"i": 0}
        raise RuntimeError("producer failed")

    pf = DevicePrefetcher(source(), lambda b: b, depth=2)
    assert next(pf)["i"] == 0
    with pytest.raises(RuntimeError, match="producer failed"):
        next(pf)
    assert pf.failed
    with pytest.raises(StopIteration):
        next(pf)
    with pytest.raises(ValueError):
        DevicePrefetcher(iter([]), lambda b: b, depth=0)


def test_prefetcher_close_stops_the_producer():
    pulled = []

    def endless():
        i = 0
        while True:
            pulled.append(i)
            yield i
            i += 1

    pf = DevicePrefetcher(endless(), lambda b: b, depth=2)
    assert next(pf) == 0
    pf.close()
    assert not pf._thread.is_alive()
    n = len(pulled)
    time.sleep(0.3)
    assert len(pulled) == n and n <= 5  # at most depth + 2 ahead, then nothing


# --------------------------------------------------------- meters and logs
def test_meters_and_record_text_match_jax():
    values = [3.0, -1.5, 2.25, 8.0, 0.5]
    pairs = [(AverageMeter(3), jlog.AverageMeter(3)), (EMAMeter(0.9), jlog.EMAMeter(0.9))]
    for port, ref in pairs:
        for v in values:
            port.update(v)
            ref.update(v)
        assert (port.val, port.avg) == (ref.val, ref.avg)
    port, ref = VariableRecord(4), jlog.VariableRecord(4)
    for i, v in enumerate(values):
        port.update_var({"loss": v, "acc": i / 7})
        ref.update_var({"loss": v, "acc": i / 7})
    assert port.get_vars_text() == ref.get_vars_text()


def test_stopwatch_reports_into_the_registry_and_timer_measures(registry):
    sw = StopWatch(enabled=True)
    for _ in range(3):
        with sw("step"):
            time.sleep(0.002)
    assert sw.report(registry=registry)["step"]["num"] == 3
    assert registry.snapshot()["distar_stopwatch_seconds{region=step}_count"] == 3
    assert sw.report(registry=registry) == {}  # incremental: nothing new
    assert StopWatch(enabled=False).summary() == {}
    t = EasyTimer()
    with t:
        time.sleep(0.02)
    assert t.value > 0.015


def test_scalar_sink_and_jsonl_exporter_write_json_lines(tmp_path, registry):
    sink = ScalarSink(str(tmp_path / "s"), force_jsonl=True)
    sink.add_scalars({"a": 1.5, "b": 2}, global_step=7)
    sink.close()
    sink.close()
    rows = [json.loads(ln) for ln in open(tmp_path / "s" / "scalars.jsonl")]
    assert [(r["step"], r["name"], r["value"]) for r in rows] == [(7, "a", 1.5), (7, "b", 2.0)]
    registry.counter("distar_x_total").inc(3)
    exporter = JsonlExporter(str(tmp_path / "obs"), registry=registry)
    assert exporter.export(step=4) == 1
    row = json.loads(open(tmp_path / "obs" / "scalars.jsonl").readline())
    assert (row["name"], row["value"], row["step"]) == ("distar_x_total", 3.0, 4)


# ------------------------------------------------------------ admin routes
def _post(admin, route, body=None):
    req = urllib.request.Request(f"http://{admin.host}:{admin.port}/learner/{route}",
                                 data=json.dumps(body or {}).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    return json.loads(urllib.request.urlopen(req, timeout=10).read())


def test_admin_routes_queue_and_apply_at_the_boundary(tmp_path):
    lrn = SLLearner({"common": {"save_path": str(tmp_path)},
                     "learner": {"batch_size": 1, "unroll_len": 2, "save_freq": 10 ** 9, "log_freq": 10 ** 9},
                     "model": SMALL_MODEL}, device="cpu")
    admin = lrn.start_admin()
    try:
        lrn.run(1)
        status = _post(admin, "status")
        assert status["code"] == 0 and status["info"]["last_iter"] == 1
        assert "total_loss" in status["info"]["meters"]
        assert _post(admin, "save_ckpt") == {"code": 0, "info": "queued"}
        assert lrn._pending_save
        saves, real_save = [], lrn.save
        lrn.save = lambda path, sync=False: (saves.append((os.path.basename(path), sync)),
                                             real_save(path, sync))
        lrn.run(2)
        # the admin save, synchronous, at the boundary; then the after_run hook's
        assert saves == [("iteration_2.ckpt", True), ("iteration_2.ckpt", False)]
        assert not lrn._pending_save and ckpt.verify_checkpoint(lrn.checkpoint_path())
        assert _post(admin, "update_config", {"config": {}})["code"] == 404  # SL takes no patches
        assert _post(admin, "bogus")["code"] == 404
        # a learner whose run loop is not advancing: the capture times out,
        # answered as an error (as the JAX route answers it)
        profile = _post(admin, "profile", {"steps": 1, "timeout_s": 0.2})
        assert profile["code"] == 1 and "run loop advancing" in profile["info"]
        assert "perf" in _post(admin, "status")["info"]
    finally:
        admin.stop()


# ------------------------------------------ optimizer state, both packages
OPTIMIZERS = {
    "adam": {},
    "adamw_norm": dict(weight_decay=1e-2, clip=dict(type="norm", threshold=1.0)),
    "max_norm": dict(clip=dict(type="max_norm", threshold=0.5, begin_step=1)),
    "momentum_norm": dict(weight_decay=1e-2, clip=dict(type="momentum_norm", threshold=0.5, begin_step=2)),
    "warmup_then_decay": dict(weight_decay=1e-2, warmup_steps=1, decay_boundaries=(1,), decay_rate=0.3),
}


class TinyNet(torch.nn.Module):
    """One module of each kind the layout bridge converts (a Dense kernel
    transposed, a Conv kernel permuted, LayerNorm scale, Embed, a bare
    parameter), under flax's names."""

    def __init__(self):
        super().__init__()
        self.Dense_0 = torch.nn.Linear(6, 5)
        self.block = torch.nn.Module()
        self.block.Conv_0 = torch.nn.Conv2d(3, 4, 3)
        self.block.LayerNorm_0 = torch.nn.LayerNorm(5)
        self.Embed_0 = torch.nn.Embedding(7, 3)
        self.end_embedding = torch.nn.Parameter(torch.randn(1, 5))


@pytest.fixture(scope="module")
def small_model():
    torch.manual_seed(2)
    return TinyNet()


def _jax_tree(x):
    return jax.tree.map(lambda a: np.asarray(a), x)


# a moment summed in another order rounds apart by a few f32 ulps of the
# leaf's scale, which rtol misses where it cancels to near zero
F32_ULPS = 4 * float(np.finfo(np.float32).eps)
# optax corrects the bias in f32: 1 - 0.999^4 rounds 1.5e-5 off, so each
# update (at most about lr) of the four moves its parameter that far apart
BIAS_TOL = 2e-5


@pytest.mark.parametrize("case", sorted(OPTIMIZERS))
def test_optimizer_state_matches_optax_both_ways(small_model, tmp_path, case):
    """Three updates on the same gradients: the port's state in the JAX
    layout against optax's (rtol 1e-5, plus ``F32_ULPS`` of each leaf's
    largest element); written by the port, restored by the JAX package into
    its optax tree, leaf for leaf; then optax's state loaded into a fresh
    port optimizer, one more update on both, the parameters against optax
    (``BIAS_TOL`` of the learning rate an update)."""
    kw = {**dict(learning_rate=1e-2, betas=(0.9, 0.999), eps=1e-8), **OPTIMIZERS[case]}
    clip = kw.pop("clip", None)
    rng = np.random.default_rng(7)
    model = TinyNet()
    model.load_state_dict(small_model.state_dict())
    names = [n for n, _ in model.named_parameters()]
    grads = [[torch.from_numpy((3 * rng.standard_normal(p.shape)).astype(np.float32)) for p in model.parameters()]
             for _ in range(4)]
    opt = jax_build_optimizer(clip=JClipConfig(**clip) if clip else None, **kw)

    @jax.jit
    def jax_step(g, state, p):
        upd, state = opt.update(g, state, p)
        return optax.apply_updates(p, upd), state

    jp = jax.tree.map(jnp.asarray, params_to_flax(model))
    jstate = opt.init(jp)
    topt = build_optimizer(list(model.parameters()), clip=GradClipConfig(**clip) if clip else None, **kw)
    for g in grads[:3]:
        jp, jstate = jax_step(params_to_flax(model, dict(zip(names, g))), jstate, jp)
        topt.step([t.clone() for t in g])
    port = learner_state_to_flax(model, topt)
    want, got = _leaves(_jax_tree(jstate)), _leaves(port["opt_state"])
    assert set(got) == set(want)
    for k, w in want.items():
        assert np.asarray(got[k]).dtype == w.dtype, k
        np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=F32_ULPS * float(np.abs(w).max()),
                                   err_msg="/".join(k))
    # the file: written by the port, restored into optax's own tree
    path = str(tmp_path / "state.ckpt")
    ckpt.save_checkpoint(path, port, metadata={"last_iter": 3})
    restored = jckpt.load_checkpoint(path, target={"params": _jax_tree(jp), "opt_state": _jax_tree(jstate)})
    assert jax.tree.structure(restored["state"]["opt_state"]) == jax.tree.structure(jstate)
    assert_trees_equal(_jax_tree(restored["state"]["opt_state"]), port["opt_state"])
    # optax's state into a fresh port optimizer, then one more update each
    fresh = TinyNet()
    fopt = build_optimizer(list(fresh.parameters()), clip=GradClipConfig(**clip) if clip else None, **kw)
    load_learner_state({"params": _jax_tree(jp), "opt_state": _jax_tree(jstate)}, fresh, fopt)
    assert fopt.count == 3
    jp, jstate = jax_step(params_to_flax(fresh, dict(zip(names, grads[3]))), jstate, jp)
    fopt.step([t.clone() for t in grads[3]])
    want, got = _leaves(_jax_tree(jp)), _leaves(params_to_flax(fresh))
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=4 * BIAS_TOL * kw["learning_rate"],
                                   err_msg="/".join(k))


# ------------------------------- RL and student checkpoints, both packages
def _cfg(root, **learner):
    return {"common": {"save_path": str(root)},
            "learner": {"batch_size": B, "unroll_len": T, "save_freq": 10 ** 9, "log_freq": 10 ** 9,
                        **learner},
            "model": SMALL_MODEL}


@pytest.fixture(scope="module")
def jax_learners(tmp_path_factory):
    """The JAX RL learner (value towers) and the student, built once."""
    root = tmp_path_factory.mktemp("jax_learners")
    return {"rl": JRLLearner(_cfg(root / "rl")), "student": JDistillLearner(_cfg(root / "student"))}


@pytest.mark.parametrize("kind", ["rl", "student"])
def test_learner_checkpoints_cross_both_ways(jax_learners, tmp_path, kind):
    """A port learner trained one step and saved is restored by the JAX
    learner (its leaf check passes) bit for bit; the JAX learner's save of
    it is restored by a fresh port learner bit for bit, step count and
    ``last_iter`` too. The student's generations sit under its role."""
    cls = RLLearner if kind == "rl" else DistillLearner
    port = cls(_cfg(tmp_path / "port"), device="cpu")
    port.run(1)  # the after_run hook saves iteration_1
    path = port.checkpoint_path()
    assert path.endswith(("iteration_1.ckpt" if kind == "rl" else "student_iteration_1.ckpt"))
    role_pointer = "latest_student.json" if kind == "student" else "latest.json"
    assert os.path.exists(tmp_path / "port" / "checkpoints" / role_pointer)
    jl = jax_learners[kind]
    jl.restore(path)
    want = port.state
    assert_trees_equal(_jax_tree(jl.state), want)
    assert jl.last_iter.val == 1
    jpath = str(tmp_path / "jax.ckpt")
    jl.last_iter.update(5)
    jl.save(jpath, sync=True)
    back = cls(_cfg(tmp_path / "back"), device="cpu")
    back.restore(jpath)
    assert_trees_equal(back.state, want)
    assert back.last_iter.val == 5 and back.optimizer.count == 1
    for (n, p), q in zip(port.model.named_parameters(), back.model.parameters()):
        assert torch.equal(p, q), n
    # a checkpoint of the other tier does not fit and names the leaves
    wrong = (DistillLearner if kind == "rl" else RLLearner)(_cfg(tmp_path / "wrong"), device="cpu")
    with pytest.raises(ckpt.CheckpointMismatchError, match="mismatched leaves"):
        wrong.restore(path)


def test_student_resume_reads_only_its_role(tmp_path):
    """One experiment directory, both tiers: the student's generation is
    under its role for the JAX manager too, a fresh student resumes it and
    the teacher finds none of its own."""
    student = DistillLearner(_cfg(tmp_path), device="cpu")
    student.run(1)
    mgr = jckpt.CheckpointManager(str(tmp_path / "checkpoints"), role="student")
    assert [g["path"] for g in mgr.generations()] == [student.checkpoint_path()]
    assert ckpt.CheckpointManager(str(tmp_path / "checkpoints")).generations() == []
    teacher = RLLearner(_cfg(tmp_path), device="cpu")
    assert teacher.resume_latest() is None and teacher.last_iter.val == 0
    fresh = DistillLearner(_cfg(tmp_path), device="cpu")
    assert fresh.resume_latest() == student.checkpoint_path() and fresh.last_iter.val == 1
    assert_trees_equal(fresh.state, student.state)


def test_resume_latest_falls_back_and_counts(tmp_path, registry):
    lrn = RLLearner(_cfg(tmp_path, save_freq=1), device="cpu")
    lrn.run(2)
    first = str(tmp_path / "checkpoints" / "iteration_1.ckpt")
    newest = lrn.checkpoint_path()
    blob = storage.read_bytes(newest)
    storage.write_bytes(newest, blob[:100])
    again = RLLearner(_cfg(tmp_path), device="cpu")
    assert again.resume_latest() == first and again.last_iter.val == 1
    snap = registry.snapshot()
    assert snap["distar_resilience_ckpt_fallbacks_total"] == 1
    assert snap["distar_resilience_resumes_total"] == 1


def test_rl_admin_save_applies_inside_the_step(tmp_path):
    lrn = RLLearner(_cfg(tmp_path), device="cpu")
    lrn.run(1)
    lrn.request_save()
    lrn._train(next(lrn._dataloader))  # the JAX learner saves in _apply_admin_requests
    assert not lrn._pending_save and ckpt.verify_checkpoint(lrn.checkpoint_path())
