"""The port's chaos CLI (``distar_tpu_torch/tools/chaos.py``) on the CPU:
the utilities held against the JAX package's ``tools/chaos.py`` on the same
inputs, and the fleet drills at small sizes, each a ``python -m
distar_tpu_torch.tools.chaos`` process whose verdict JSON (the line before
the last) is held as the JAX tests hold theirs (tests/test_serve_fleet.py's
serve drill, tests/test_elastic_fleet.py's elastic drill). The full-size
drills the JAX suite marks ``slow`` are marked ``slow`` here too. The
drills that run a model are in tests/test_torch_chaos_model_drills.py.
"""
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest

from distar_tpu_torch.tools import chaos
from distar_tpu_torch.utils.checkpoint import CheckpointManager, save_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_chaos():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import chaos as jchaos
    finally:
        sys.path.pop(0)
    return jchaos


def run_both(argv, capsys, monkeypatch, jargv=None):
    """(rc, stdout) of the port's CLI in process, then of the JAX one."""
    said = []
    for main, args in ((lambda: chaos.main(argv), argv), (jax_chaos().main, jargv or argv)):
        monkeypatch.setattr(sys, "argv", ["chaos.py", *args])
        capsys.readouterr()
        rc = main()
        said.append((rc, capsys.readouterr().out))
    return said


def drill(*argv, timeout=300):
    """A drill as a process of its own: (exit code, verdict JSON, stdout)."""
    out = subprocess.run([sys.executable, "-m", "distar_tpu_torch.tools.chaos", *argv],
                         cwd=REPO, capture_output=True, text=True, timeout=timeout,
                         env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"))
    lines = out.stdout.strip().splitlines()
    try:
        verdict = json.loads(lines[-2])
    except (IndexError, ValueError):
        verdict = None
    return out.returncode, verdict, out.stdout + out.stderr[-3000:]


@pytest.fixture
def generations(tmp_path):
    """A checkpoint directory with two generations under a latest pointer."""
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    for step in (10, 20):
        path = str(tmp_path / "ckpt" / f"iteration_{step}.ckpt")
        save_checkpoint(path, {"w": np.arange(64, dtype=np.float32) * step})
        mgr.record(path, step=step)
    return tmp_path / "ckpt"


# ------------------------------------------------------------- utilities
@pytest.mark.parametrize("mode", ["truncate", "bitflip"])
def test_corrupt_equals_the_jax_tool(generations, tmp_path, mode, capsys, monkeypatch):
    """The same seed damages a copy of one checkpoint the same way and both
    tools print the same lines (their paths aside)."""
    src = generations / "iteration_20.ckpt"
    a, b = tmp_path / "a.ckpt", tmp_path / "b.ckpt"
    for dst in (a, b):  # the blob and its manifest, which verify reads
        shutil.copy(src, dst)
        shutil.copy(f"{src}.manifest", f"{dst}.manifest")
    flags = ["--mode", mode, "--seed", "3", "--flips", "5", "--frac", "0.4"]
    (rc, out), (jrc, jout) = run_both(["corrupt", "--path", str(a), *flags], capsys, monkeypatch,
                                      ["corrupt", "--path", str(b), *flags])
    assert rc == jrc == 0
    assert out.replace(str(a), "P") == jout.replace(str(b), "P")
    assert a.read_bytes() == b.read_bytes() != src.read_bytes()
    assert "verify_checkpoint: False" in out


def test_latest_equals_the_jax_tool_after_a_corruption(generations, capsys, monkeypatch):
    chaos.main(["corrupt", "--path", str(generations / "iteration_20.ckpt"), "--mode", "truncate"])
    (rc, out), (jrc, jout) = run_both(["latest", "--dir", str(generations)], capsys, monkeypatch)
    assert rc == jrc == 0 and out == jout
    lines = out.splitlines()
    assert lines[0].startswith("LATEST ") and "CORRUPT" in lines[0] and "ok" in lines[1]
    assert json.loads(lines[-1])["resolves_to"].endswith("iteration_10.ckpt")


def test_latest_without_a_pointer_exits_alike(tmp_path, capsys, monkeypatch):
    said = run_both(["latest", "--dir", str(tmp_path)], capsys, monkeypatch)
    assert said[0] == said[1] and said[0][0] == 1


def test_kill_signals_a_process(capsys):
    proc = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
    try:
        assert chaos.main(["kill", "--pid", str(proc.pid), "--signal", "TERM"]) == 0
        assert proc.wait(timeout=30) == -signal.SIGTERM
        assert capsys.readouterr().out.strip() == f"sent SIGTERM to pid {proc.pid}"
    finally:
        if proc.poll() is None:
            proc.kill()


def test_reset_aborts_connections_and_exits_alike(capsys, monkeypatch):
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(8)
    port = srv.getsockname()[1]
    accepted = []
    t = threading.Thread(target=lambda: [accepted.append(srv.accept()) for _ in range(4)], daemon=True)
    t.start()
    try:
        said = run_both(["reset", "--addr", f"127.0.0.1:{port}", "--count", "2"], capsys, monkeypatch)
        assert said[0] == said[1] == (0, f"aborted 2/2 connections to 127.0.0.1:{port} with RST\n")
    finally:
        srv.close()
    closed = socket.socket()
    closed.bind(("127.0.0.1", 0))
    dead = closed.getsockname()[1]
    closed.close()
    said = run_both(["reset", "--addr", f"127.0.0.1:{dead}"], capsys, monkeypatch)
    assert said[0] == said[1] and said[0][0] == 1


def test_subcommands_are_the_jax_tools():
    def names(parser_main):
        import argparse

        seen = {}
        real = argparse.ArgumentParser.parse_args

        def capture(self, args=None, namespace=None):
            sub = next(a for a in self._actions if isinstance(a, argparse._SubParsersAction))
            seen["cmds"] = {name: sorted(opt for act in p._actions for opt in act.option_strings)
                            for name, p in sub.choices.items()}
            raise SystemExit(0)

        argparse.ArgumentParser.parse_args = capture
        try:
            parser_main()
        except SystemExit:
            pass
        finally:
            argparse.ArgumentParser.parse_args = real
        return seen["cmds"]

    port, jax = names(lambda: chaos.main([])), names(jax_chaos().main)
    assert sorted(port) == sorted(jax) and len(port) == 13
    for cmd in port:
        extra = set(port[cmd]) - set(jax[cmd])
        assert set(jax[cmd]) <= set(port[cmd]), cmd
        assert extra <= {"--device"}, (cmd, extra)
    assert {c for c in port if "--device" in port[c]} == {"dynamics-drill", "arena-drill", "multichip-drill"}


# ------------------------------------------------------------- fleet drills
@pytest.mark.parametrize("shards", [1, 3])
def test_replay_drill(tmp_path, shards):
    """At 3 shards the victim's share of the keys depends on the hash ring
    of this run's ports: the JAX default of 50 items leaves it an unsampled
    tail to lose and recover."""
    items = 16 if shards == 1 else 50
    rc, verdict, log = drill("replay-drill", "--dir", str(tmp_path / "spill"), "--items", str(items),
                             "--shards", str(shards))
    assert rc == 0, log
    if shards == 1:
        assert verdict["lost"] == 0 and verdict["acked"] == verdict["sampled_after_restart"] == items
    else:
        assert verdict["lost_fleet_wide"] == 0 and verdict["unreachable_not_owned_by_victim"] == 0
        assert verdict["recovered_from_spill"] == verdict["unreachable_during_outage"] > 0
    assert verdict["events"] == ["kill_role"]


def test_replay_drill_without_spill_demonstrates_the_loss(tmp_path):
    rc, verdict, log = drill("replay-drill", "--dir", str(tmp_path / "spill"), "--items", "8", "--no-spill")
    assert rc == 0, log
    assert verdict["lost"] == verdict["acked"] == 8 and verdict["spill"] is False
    assert "verdict: data loss demonstrated without spill" in log


def test_serve_drill_small():
    rc, verdict, log = drill("serve-drill", "--gateways", "2", "--sessions", "8", "--steps", "4",
                             "--slots", "16")
    assert rc == 0, log
    assert verdict["finished_sessions"] == 8
    assert verdict["migrations"] == verdict["killed"]["pinned"] > 0
    assert verdict["error_leaks"] == 0


def test_shm_drill_small(tmp_path):
    rc, verdict, log = drill("shm-drill", "--dir", str(tmp_path / "spill"), "--items", "40")
    assert rc == 0, log
    assert verdict["lost_acked"] == 0 and verdict["acked"] == 40
    assert verdict["transport_before_kill"] == "shm"
    assert verdict["transport_after_fallback"] == {"insert": "tcp", "sample": "tcp"}


def test_elastic_drill_small(tmp_path):
    rc, verdict, log = drill("elastic-drill", "--dir", str(tmp_path / "spill"), "--items", "16",
                             "--sessions", "10", "--slots", "8", timeout=300)
    assert rc == 0, log
    assert verdict["failures"] == []
    assert verdict["phase_b"]["lost_acked"] == 0
    assert verdict["pinning"]["pinned"] in (True, False)  # in-band either way


#: the drill's one failure that timing alone decides, in both packages: a
#: ``register`` retried after an ambiguous ack (the primary died between
#: applying it and replying) is applied twice, so its item pops twice
POPPED_TWICE = "a queue item was popped twice"


def test_coordinator_drill_small(tmp_path):
    """The payload items are registered under the drill's lease, so a run
    longer than the lease expires them before the drain (both packages):
    the lease here outlasts the run."""
    rc, verdict, log = drill("coordinator-drill", "--dir", str(tmp_path), "--items", "8", "--post-items", "4",
                             "--lease-s", "20")
    assert rc == 0 or verdict["failures"] == [POPPED_TWICE], log
    assert verdict["revived_old_primary_role"] == "standby"
    assert verdict["popped"] >= verdict["acked_items"] >= 8
    assert verdict["epoch_after"] > verdict["epoch_before"]


def test_coordinator_drill_without_ha_demonstrates_the_loss(tmp_path):
    rc, verdict, log = drill("coordinator-drill", "--dir", str(tmp_path), "--no-ha")
    assert rc == 0, log
    assert verdict["lost"] == 10 and verdict["failures"] == []


def test_league_drill_small(tmp_path):
    rc, verdict, log = drill("league-drill", "--dir", str(tmp_path), "--rounds", "6",
                             "--round-sleep-s", "0.1")
    assert rc == 0, log
    assert verdict["failures"] == [] and verdict["victim_acked_rounds"] >= 3
    assert verdict["orphaned_jobs"] >= 1


def test_league_drill_without_a_journal_demonstrates_the_loss(tmp_path):
    rc, verdict, log = drill("league-drill", "--dir", str(tmp_path), "--no-journal")
    assert rc == 0, log
    assert verdict["lost_mints"] > 0 and verdict["seq_watermark_lost"] is True
    assert verdict["failures"] == []


# ------------------------------------------------------ full size: slow
@pytest.mark.slow
def test_chaos_serve_drill_exit_zero():
    rc, verdict, log = drill("serve-drill", "--gateways", "3", "--sessions", "24", "--steps", "6",
                             "--slots", "32")
    assert rc == 0, log
    assert verdict["finished_sessions"] == 24
    assert verdict["migrations"] == verdict["killed"]["pinned"] > 0
    assert verdict["error_leaks"] == 0


@pytest.mark.slow
def test_elastic_drill_exits_zero(tmp_path):
    rc, verdict, log = drill("elastic-drill", "--dir", str(tmp_path / "spill"), "--items", "40",
                             "--sessions", "12", timeout=420)
    assert rc == 0, log
    assert verdict["failures"] == []
    assert verdict["phase_b"]["lost_acked"] == 0
