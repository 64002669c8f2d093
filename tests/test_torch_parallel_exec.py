"""The port's sharded executor and launchers on gloo ranks, as processes.

``python -m distar_tpu_torch.parallel.executor --host-devices 2``: a run
killed after its first iteration exits 137 leaving a durable sharded
generation (the port's and JAX's verifiers pass it), and ``--resume`` onto
another mesh shape (fsdp=2: the resharding restore) starts from it and
prints its ``REPORT`` line. ``bin.sl_train --mesh dp=2 --host-devices 2
--device cpu`` leaves a sharded generation JAX verifies and restores, and
so does ``--remote --mesh tp=2`` on the trajectories a ``ReplayActor``
pushes (rank 0 pulls each batch, rank 1 trains on it).
``bin.rl_train --type learner --host-devices 2`` under dp=2 (each rank
pulling its own rows) and under tp=2 (rank 0 pulling the whole batch)
trains on an actor's trajectories beside a coordinator, a league and an
actor as processes; ``--host-devices`` refuses every other role.
"""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "DISTAR_PERF_AOT": "0", "PYTHONPATH": REPO}


def _run(argv, timeout=300):
    proc = subprocess.run([sys.executable, "-m", *argv], cwd=REPO, env=ENV, capture_output=True, text=True,
                          timeout=timeout)
    reports = [json.loads(ln[len("REPORT "):]) for ln in proc.stdout.splitlines() if ln.startswith("REPORT ")]
    return proc, reports


def _newest(save):
    from distar_tpu_torch.utils.checkpoint import CheckpointManager

    gens = CheckpointManager(os.path.join(save, "checkpoints")).generations()
    return gens[0] if gens else None


def test_executor_kill_and_resume_onto_another_mesh(tmp_path):
    from distar_tpu.parallel import ckpt as jck
    from distar_tpu_torch.parallel.ckpt import is_sharded_checkpoint
    from distar_tpu_torch.utils.checkpoint import verify_checkpoint

    save = str(tmp_path / "exec")
    base = ["distar_tpu_torch.parallel.executor", "--host-devices", "2", "--iters", "2", "--unroll-len", "1",
            "--save-dir", save]
    proc, reports = _run(base + ["--mesh", "dp=2", "--kill-after", "1"])
    assert proc.returncode == 137, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert not reports
    gen = _newest(save)
    assert gen["step"] == 1 and is_sharded_checkpoint(gen["path"]) and verify_checkpoint(gen["path"])
    jck.verify_sharded(gen["path"])
    assert jck.saved_mesh_shape(gen["path"]) == {"dp": 2, "fsdp": 1, "tp": 1, "sp": 1}
    proc, reports = _run(base + ["--mesh", "fsdp=2", "--resume"])
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    (report,) = reports
    assert report["resumed_from"] == gen["path"] and report["start_iter"] == 1 and report["iters"] == 2
    assert report["mesh"] == {"dp": 1, "fsdp": 2, "tp": 1, "sp": 1} and report["devices"] == 2
    assert report["feeder"]["batches"] == 1 and report["loss"] is not None
    assert "resharding restore" in proc.stdout + proc.stderr
    assert _newest(save)["step"] == 2


def test_sl_train_on_two_ranks_leaves_a_sharded_generation(tmp_path):
    from distar_tpu.parallel import ckpt as jck

    save = str(tmp_path / "sl")
    proc, _ = _run(["distar_tpu_torch.bin.sl_train", "--mesh", "dp=2", "--host-devices", "2", "--device", "cpu",
                    "--iters", "2", "--batch-size", "2", "--traj-len", "2", "--save-path", save, "--no-health"])
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    done = [ln for ln in proc.stdout.splitlines() if ln.startswith("sl_train done:")]
    assert len(done) == 1 and done[0].startswith("sl_train done: 2 iters")  # rank 0 alone prints
    gen = _newest(save)
    assert gen["step"] == 2
    jck.verify_sharded(gen["path"])
    out = jck.restore_sharded(gen["path"])
    assert out["metadata"] == {"last_iter": 2}
    assert out["sharding_layout"]["mesh_shape"] == {"dp": 2, "fsdp": 1, "tp": 1, "sp": 1}


def test_sl_train_remote_on_two_tp_ranks_trains_on_pushed_trajectories(tmp_path):
    """``sl_train --remote --mesh tp=2 --host-devices 2``: the two ranks
    are replicas of one batch block, so rank 0 pulls whole batches of 2
    trajectories and sends them on; 2 steps end in a sharded generation of
    the tp=2 mesh that JAX verifies."""
    from distar_tpu.parallel import ckpt as jck
    from distar_tpu_torch.comm import Adapter, CoordinatorServer
    from distar_tpu_torch.learner.replay_actor import ReplayActor
    from test_torch_sl_runtime import StubDecoder

    co = CoordinatorServer()
    co.start()
    try:
        addr = (co.host, co.port)
        ReplayActor([f"{i}.SC2Replay" for i in range(6)], adapter_factory=lambda: Adapter(coordinator_addr=addr),
                    decoder_factory=lambda: StubDecoder(seed=4), ntasks=1, proc_id=0).run()
        save = str(tmp_path / "sl_tp2")
        proc, _ = _run(["distar_tpu_torch.bin.sl_train", "--remote", "--coordinator-addr", f"{co.host}:{co.port}",
                        "--mesh", "tp=2", "--host-devices", "2", "--device", "cpu", "--iters", "2",
                        "--batch-size", "2", "--traj-len", "4", "--save-path", save, "--no-health"])
    finally:
        co.stop()
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    done = [ln for ln in proc.stdout.splitlines() if ln.startswith("sl_train done:")]
    assert len(done) == 1 and done[0].startswith("sl_train done: 2 iters")
    gen = _newest(save)
    assert gen["step"] == 2
    jck.verify_sharded(gen["path"])
    assert jck.saved_mesh_shape(gen["path"]) == {"dp": 1, "fsdp": 1, "tp": 2, "sp": 1}


@pytest.mark.parametrize("role", ["all", "actor", "league-learner"])
def test_rl_train_host_devices_runs_only_the_learner(role):
    from distar_tpu_torch.bin import rl_train

    with pytest.raises(SystemExit, match="--host-devices runs --type learner"):
        rl_train.main(["--type", role, "--host-devices", "2", "--device", "cpu"])


@pytest.mark.parametrize("mesh,shape", [("dp=2", {"dp": 2, "fsdp": 1, "tp": 1, "sp": 1}),
                                        ("tp=2", {"dp": 1, "fsdp": 1, "tp": 2, "sp": 1})])
def test_rl_train_learner_on_two_ranks_trains_on_the_actors_trajectories(tmp_path, mesh, shape):
    """``--type learner --mesh M --host-devices 2`` against a coordinator,
    a league and an actor as processes: under dp=2 each rank pulls its own
    row of every batch (the multi-host path), under tp=2 rank 0 pulls both
    rows and sends them to rank 1; rank 0 publishes and prints the done
    line, and the run ends with a sharded generation JAX verifies."""
    import time

    from distar_tpu.parallel import ckpt as jck
    from test_torch_rl_loop import LEAGUE_CFG

    env = dict(ENV, DISTAR_EXPERIMENTS_ROOT=str(tmp_path), OMP_NUM_THREADS="1")
    procs, logs = {}, {}

    def start(role, *flags):
        logs[role] = tmp_path / f"{role}.log"
        procs[role] = subprocess.Popen(
            [sys.executable, "-m", "distar_tpu_torch.bin.rl_train", "--type", role, "--device", "cpu",
             "--no-health", *flags], cwd=REPO, env=env, stdout=open(logs[role], "w"), stderr=subprocess.STDOUT)

    def serving(role):
        deadline = time.time() + 120
        while time.time() < deadline:
            for ln in logs[role].read_text().splitlines():
                if ln.startswith(f"{role} serving on "):
                    return ln.rsplit(" ", 1)[1]
            time.sleep(0.1)
        raise AssertionError(logs[role].read_text())

    try:
        start("coordinator", "--port", "0")
        start("league", "--port", "0", "--config", json.dumps({"league": LEAGUE_CFG["league"]}))
        co, lg = serving("coordinator"), serving("league")
        sizes = ("--env-num", "1", "--traj-len", "2", "--batch-size", "2", "--episode-game-loops", "60")
        save = tmp_path / "learner"
        start("learner", "--coordinator-addr", co, "--league-addr", lg, "--iters", "2", "--mesh", mesh,
              "--host-devices", "2", "--save-path", str(save), *sizes)
        start("actor", "--coordinator-addr", co, "--league-addr", lg, "--save-path", str(tmp_path / "actor"),
              *sizes)
        assert procs["learner"].wait(timeout=240) == 0, logs["learner"].read_text()[-3000:]
        done = [ln for ln in logs["learner"].read_text().splitlines() if ln.startswith("learner done:")]
        assert done == ["learner done: 2 iters"]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    gen = _newest(str(save))
    assert gen["step"] == 2
    jck.verify_sharded(gen["path"])
    assert jck.saved_mesh_shape(gen["path"]) == shape
