"""The port's chaos injector and alert remediation (``distar_tpu_torch.
resilience``) against the JAX package's, on the CPU.

* ``ChaosInjector`` draws its faults from ``random.Random(seed)``, as the
  JAX one does: the same seed and call sequence give the same fault
  schedule and events (``wrap``), the same flipped offsets (``bitflip``)
  and sizes (``truncate``). ``fail_n_calls``, ``patch``/``restore``,
  ``kill_role`` on every handle kind and ``reset_connection`` behave alike.
* ``poison_loss`` and ``poison_module`` on the port's RL learner (a
  SMALL_MODEL ``RLLearner`` on the CPU): the poisoned steps report a
  non-finite loss, ``learner_loss_nonfinite`` fires exactly once on the
  port's fleet health, and ``poison_module`` writes the value into the
  named submodule's first float parameter in place.
* ``AlertRemediator`` and the chaos acceptance tests of
  tests/test_resilience.py (``:412``, ``:587``, ``:653``) on the port's
  stack: its supervisor, coordinator, adapter and checkpoint manager.
"""
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
from conftest import SMALL_MODEL

from distar_tpu.resilience import chaos as jchaos
from distar_tpu_torch import obs
from distar_tpu_torch.comm import Adapter, CoordinatorServer
from distar_tpu_torch.obs import (
    FlightRecorder,
    HealthEvaluator,
    HealthRule,
    MetricsRegistry,
    TimeSeriesStore,
    set_flight_recorder,
    set_registry,
)
from distar_tpu_torch.resilience import (
    NO_RETRY,
    AlertRemediator,
    ChaosInjector,
    CommError,
    RestartPolicy,
    RetryPolicy,
    Supervisor,
    supervise_call,
)
from distar_tpu_torch.utils.checkpoint import (
    CheckpointCorruptError,
    CheckpointManager,
    load_checkpoint,
    save_checkpoint,
)


@pytest.fixture
def chaos():
    """Seeded fault injector; every patch it installed is restored on
    teardown, so faults never leak across tests."""
    inj = ChaosInjector(seed=0)
    yield inj
    inj.restore()


@pytest.fixture
def registry():
    reg = MetricsRegistry()
    prev = set_registry(reg)
    yield reg
    set_registry(prev)


@pytest.fixture
def recorder():
    rec = FlightRecorder()
    prev = set_flight_recorder(rec)
    yield rec
    set_flight_recorder(prev)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _events(inj):
    return [{k: v for k, v in e.items() if k != "ts"} for e in inj.events]


# ------------------------------------------------------- equal to the JAX injector
def wrap_script(cls):
    inj = cls(seed=7)
    calls = []
    fn = inj.wrap(lambda x: calls.append(x) or x, op="rpc", drop_p=0.3, delay_p=0.2, delay_s=0.0,
                  reset_p=0.25)
    outcomes = []
    for i in range(40):
        try:
            outcomes.append(("ok", fn(i)))
        except Exception as e:  # noqa: BLE001 - either package's CommError, and the resets
            outcomes.append((type(e).__name__, i))
    capped = inj.wrap(lambda: 1, op="capped", drop_p=1.0, max_faults=3)
    for _ in range(5):
        try:
            outcomes.append(("ok", capped()))
        except Exception as e:  # noqa: BLE001 - either package's CommError
            outcomes.append((type(e).__name__, None))
    return outcomes, calls, _events(inj)


def test_wrap_fault_schedule_equals_jax(recorder):
    got, want = wrap_script(ChaosInjector), wrap_script(jchaos.ChaosInjector)
    assert got == want
    kinds = {e["kind"] for e in got[2]}
    assert kinds == {"drop", "delay", "reset"}
    assert [o for o, _ in got[0][-5:]] == ["CommError"] * 3 + ["ok"] * 2
    assert len(recorder.events(kind="chaos_drop")) == sum(1 for e in got[2] if e["kind"] == "drop")


def test_file_faults_equal_jax(tmp_path):
    data = bytes(range(256)) * 40
    sizes, flips = [], []
    for cls, tag in ((ChaosInjector, "port"), (jchaos.ChaosInjector, "jax")):
        inj = cls(seed=3)
        a, b = tmp_path / f"{tag}_a.bin", tmp_path / f"{tag}_b.bin"
        a.write_bytes(data)
        b.write_bytes(data)
        sizes.append((inj.truncate(str(a), keep_frac=0.3), a.read_bytes()))
        flips.append((inj.bitflip(str(b), flips=12), b.read_bytes()))
        c = tmp_path / f"{tag}_c.bin"
        c.write_bytes(data)
        inj.corrupt_checkpoint(str(c), mode="bitflip")
        flips.append(c.read_bytes())
        e = tmp_path / f"{tag}_empty.bin"
        e.write_bytes(b"")
        assert inj.bitflip(str(e)) == []
        with pytest.raises(AssertionError):
            inj.corrupt_checkpoint(str(c), mode="shred")
    assert sizes[0] == sizes[1] and sizes[0][0] == int(len(data) * 0.3)
    assert flips[:2] == flips[2:] and flips[0][1] != data


def test_fail_n_calls_patch_and_restore(chaos):
    class Svc:
        def call(self, x):
            return x * 2

    svc = Svc()
    flaky = chaos.fail_n_calls(svc.call, n=2)
    for _ in range(2):
        with pytest.raises(CommError):
            flaky(1)
    assert flaky(3) == 6
    boom = chaos.fail_n_calls(svc.call, n=1, exc_factory=lambda: ValueError("x"), op="svc")
    with pytest.raises(ValueError):
        boom(1)
    original = svc.call
    chaos.patch(svc, "call", lambda x: -1)
    assert svc.call(5) == -1
    chaos.restore()
    assert svc.call(5) == 10 and svc.call == original
    assert [e["kind"] for e in chaos.events] == ["fail_call"] * 3
    assert [e["remaining"] for e in chaos.events] == [1, 0, 0]


def test_kill_role_every_handle_kind(chaos):
    srv = CoordinatorServer()
    srv.start()
    chaos.kill_role(srv, name="coordinator")
    with pytest.raises(OSError):
        socket.create_connection((srv.host, srv.port), timeout=1.0).close()
    proc = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
    chaos.kill_role(proc, name="sleeper")
    assert proc.wait(timeout=10) != 0
    proc = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
    chaos.kill_role(proc.pid, sig=signal.SIGKILL, name="by_pid")
    assert proc.wait(timeout=10) == -signal.SIGKILL
    assert [(e["kind"], e.get("role")) for e in chaos.events] == [
        ("kill_role", "coordinator"), ("kill_role", "sleeper"), ("kill_role", "by_pid")]


def test_reset_connection(chaos):
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(8)
    port = listener.getsockname()[1]
    try:
        assert chaos.reset_connection("127.0.0.1", port, count=3) == 3
        assert chaos.reset_connection("127.0.0.1", _free_port(), count=2, timeout_s=0.5) == 0
    finally:
        listener.close()
    assert [e["count"] for e in chaos.events] == [3, 0]


# ----------------------------------------------------- the learner faults, on the port
@pytest.fixture(scope="module")
def learner(tmp_path_factory):
    from distar_tpu_torch.learner import RLLearner

    return RLLearner({"common": {"save_path": str(tmp_path_factory.mktemp("poison"))},
                      "learner": {"batch_size": 2, "unroll_len": 3, "log_freq": 100}, "model": SMALL_MODEL},
                     device="cpu")


def test_poison_loss_fires_the_nonfinite_rule_exactly_once(chaos, registry, recorder, learner):
    """Three poisoned steps then three clean ones, the port's default
    learner rulebook evaluated after each: one firing of
    ``learner_loss_nonfinite``, back to ok after the clean steps."""
    fh = obs.FleetHealth(rules=obs.default_rulebook(("learner",), stall_window_s=60.0),
                         registry=learner.metrics, recorder=recorder)
    chaos.poison_loss(learner, n=3)
    states = []
    start = learner.last_iter.val
    for k in range(6):
        learner.run(start + k + 1)
        fh.sampler.sample_once()
        fh.evaluator.evaluate_once()
        states.append(fh.evaluator.alerts()["rules"]["learner_loss_nonfinite"]["state"])
    assert states == ["warning", "firing", "firing", "firing", "ok", "ok"], states
    alerts = fh.evaluator.alerts()
    assert alerts["rules"]["learner_loss_nonfinite"]["fired_count"] == 1
    assert [e["state"] for e in alerts["history"] if e["rule"] == "learner_loss_nonfinite"] == [
        "warning", "firing", "ok"]
    assert [e["remaining"] for e in chaos.events] == [2, 1, 0]
    assert learner.metrics.snapshot()["distar_health_alerts_total{rule=learner_loss_nonfinite}"] == 1.0


def test_poison_module_writes_the_parameter_in_place(chaos, learner):
    import torch

    target = next(p for p in learner.model.get_submodule("policy").parameters() if p.is_floating_point())
    chaos.poison_module(learner, "policy", n=1, value=float("inf"))
    before = target.detach().clone()
    learner.run(learner.last_iter.val + 1)
    assert any(p is target for p in learner.model.parameters())  # written in place, not replaced
    assert not torch.isfinite(target).all() and not np.isfinite(learner.last_log["total_loss"])
    assert chaos.events[-1]["kind"] == "poison_module" and chaos.events[-1]["module"] == "policy"
    assert torch.isfinite(before).all()


def test_poison_module_refuses_a_module_without_float_parameters(chaos):
    import torch

    class Toy:
        def __init__(self):
            self.model = torch.nn.Module()
            self.model.add_module("empty", torch.nn.Module())

        def _train(self, data):
            return {"total_loss": 0.0}

    toy = Toy()
    chaos.poison_module(toy, "empty", n=1)
    with pytest.raises(ValueError, match="no float parameters"):
        toy._train(None)
    chaos.restore()
    assert toy._train(None) == {"total_loss": 0.0}


# ------------------------------------------------ tests/test_resilience.py on the port
def test_alert_remediation_restarts_mapped_task(registry, recorder):
    entered = []
    cycle = threading.Event()

    def worker(ctx):
        entered.append(1)
        cycle.set()
        while not ctx.should_exit:
            time.sleep(0.01)

    sup = Supervisor(policy=RestartPolicy(max_restarts=5, backoff_base_s=0.01))
    sup.add("actor", worker)
    sup.start()
    assert cycle.wait(5.0)
    cycle.clear()
    store = TimeSeriesStore()
    store.record_snapshot({"distar_env_steps_total": 100.0}, ts=time.time() - 10, source="actor:1")
    store.record_snapshot({"distar_env_steps_total": 100.0}, ts=time.time(), source="actor:1")
    rule = HealthRule(name="actor_env_starvation", metric="distar_env_steps_total", op="stalled",
                      window_s=60.0, for_count=2)
    ev = HealthEvaluator(store, [rule], registry=registry)
    AlertRemediator(sup, {"actor_env_starvation": "actor"}).attach(ev)
    events = ev.evaluate_once() + ev.evaluate_once()
    assert any(e["state"] == "firing" for e in events)
    assert cycle.wait(5.0)
    sup.stop()
    assert len(entered) == 2
    assert registry.snapshot()["distar_resilience_remediations_total{rule=actor_env_starvation}"] == 1
    assert recorder.events(kind="remediation")
    restarts = recorder.events(kind="task_restart")
    assert len(restarts) == 1 and restarts[0]["reason"] == "remediation:alert:actor_env_starvation"
    # unmapped rules, non-firing states and a retired task remediate nothing
    remediator = AlertRemediator(sup, {"actor_env_starvation": "actor", "x": "gone"})
    remediator.on_event({"rule": "actor_env_starvation", "state": "warning"})
    remediator.on_event({"rule": "other", "state": "firing"})
    remediator.on_event({"rule": "x", "state": "firing"})
    assert registry.snapshot()["distar_resilience_remediations_total{rule=actor_env_starvation}"] == 1


def test_supervisor_records_restarts_and_giveups(registry, recorder):
    def crash(ctx):
        raise RuntimeError("boom")

    sup = Supervisor(policy=RestartPolicy(max_restarts=2, backoff_base_s=0.0))
    sup.add("crashy", crash)
    sup.start()
    sup.join(timeout=10)
    assert sup.status()["crashy"]["gave_up"]
    assert [e["restart_no"] for e in recorder.events(kind="task_restart")] == [1, 2]
    assert recorder.events(kind="task_giveup")[0]["restarts"] == 2
    attempts = []

    def flaky():
        attempts.append(1)
        raise ValueError("again")

    with pytest.raises(ValueError):
        supervise_call(flaky, op="fg", policy=RestartPolicy(max_restarts=1, backoff_base_s=0.0),
                       sleep=lambda s: None)
    fg = [e for e in recorder.events() if e.get("task") == "fg"]
    assert [e["kind"] for e in fg] == ["task_restart", "task_giveup"]


class _ToyLearner:
    """A minimal learner with the real durability contract: it pulls
    batches off the port's adapter and coordinator and checkpoints through
    the port's manifest and ``latest``-pointer machinery."""

    def __init__(self, adapter, ckpt_dir: str, target_steps: int, save_every: int = 5):
        self.adapter = adapter
        self.ckpt_dir = ckpt_dir
        self.target = target_steps
        self.save_every = save_every
        self.mgr = CheckpointManager(ckpt_dir)
        self.step = 0
        self.resumed_from = None
        self.hooks = {}

    def save(self):
        path = os.path.join(self.ckpt_dir, f"step_{self.step}.ckpt")
        save_checkpoint(path, {"w": np.full(4, float(self.step))}, metadata={"step": self.step})
        self.mgr.record(path, step=self.step)

    def resume(self):
        out = self.mgr.load_latest()
        if out is not None:
            self.step = int(out["metadata"]["step"])
            self.resumed_from = out["path"]
        return out

    def run(self):
        while self.step < self.target:
            self.adapter.pull("traj", timeout=30.0)
            self.step += 1
            if self.step % self.save_every == 0:
                self.save()
            hook = self.hooks.pop(self.step, None)
            if hook is not None:
                hook()


def _start_producer(supervisor, port, policy):
    def producer(ctx):
        adapter = Adapter(coordinator_addr=("127.0.0.1", port), request_policy=policy)
        while not ctx.should_exit:
            adapter.push("traj", {"x": np.ones(8, np.float32)}, accept_count=1, timeout_ms=20_000)
            time.sleep(0.01)

    supervisor.add("producer", producer)


def test_chaos_acceptance_fleet_self_heals(tmp_path, chaos, registry, recorder):
    """Mid-run the broker is killed once (restarted with EMPTY state) and the
    newest checkpoint is truncated right before a learner crash-resume; the
    fleet reaches the target step count with no manual intervention."""
    port = _free_port()
    server_box = [CoordinatorServer(port=port)]
    server_box[0].start()
    TARGET, CRASH_AT, BROKER_KILL_AT = 40, 12, 8
    sup = Supervisor(policy=RestartPolicy(max_restarts=10, backoff_base_s=0.05, backoff_max_s=0.3))
    _start_producer(sup, port, RetryPolicy(max_attempts=8, backoff_base_s=0.1, backoff_max_s=0.5,
                                           deadline_s=20.0))
    sup.start()
    learner = _ToyLearner(
        Adapter(coordinator_addr=("127.0.0.1", port),
                request_policy=RetryPolicy(max_attempts=8, backoff_base_s=0.1, backoff_max_s=0.5,
                                           deadline_s=20.0)),
        str(tmp_path), target_steps=TARGET)

    def kill_and_restart_broker():
        chaos.kill_role(server_box[0])
        time.sleep(0.3)
        server_box[0] = CoordinatorServer(port=port)
        server_box[0].start()

    def crash_once():
        raise RuntimeError("chaos: learner killed")

    learner.hooks[BROKER_KILL_AT] = kill_and_restart_broker
    learner.hooks[CRASH_AT] = crash_once

    def on_restart(error):
        gens = learner.mgr.generations()
        if learner.resumed_from is None and gens:
            chaos.truncate(gens[0]["path"])
        learner.resume()

    try:
        supervise_call(learner.run, op="toy_learner",
                       policy=RestartPolicy(max_restarts=5, backoff_base_s=0.05), on_restart=on_restart)
    finally:
        sup.stop()
        server_box[0].stop()
    assert learner.step >= TARGET
    assert learner.resumed_from is not None and learner.resumed_from.endswith("step_5.ckpt")
    snap = registry.snapshot()
    assert snap.get("distar_resilience_ckpt_fallbacks_total", 0) >= 1
    assert any(k.startswith("distar_resilience_retries_total") for k in snap)
    assert recorder.events(kind="retry")
    assert recorder.events(kind="task_restart")
    assert recorder.events(kind="ckpt_fallback")
    assert not sup.status()["producer"]["gave_up"]


def test_chaos_without_resilience_fails(tmp_path, chaos):
    port = _free_port()
    server = CoordinatorServer(port=port)
    server.start()
    producer_error = []

    def fragile_producer():
        adapter = Adapter(coordinator_addr=("127.0.0.1", port), request_policy=NO_RETRY)
        try:
            while True:
                adapter.push("traj", {"x": np.ones(4)}, accept_count=1, timeout_ms=5_000)
                time.sleep(0.01)
        except CommError as e:
            producer_error.append(e)

    t = threading.Thread(target=fragile_producer, daemon=True)
    t.start()
    time.sleep(0.3)
    chaos.kill_role(server)
    t.join(timeout=10.0)
    assert producer_error, "an unsupervised producer should die on the outage"
    assert isinstance(producer_error[0], CommError)
    path = str(tmp_path / "only.ckpt")
    save_checkpoint(path, {"w": np.ones(4)}, metadata={"step": 10})
    chaos.truncate(path)
    with pytest.raises(CheckpointCorruptError):
        load_checkpoint(path)
