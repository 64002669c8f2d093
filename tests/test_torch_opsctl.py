"""The port's operator CLI (``distar_tpu_torch/tools/opsctl.py``) against
the JAX package's ``tools/opsctl.py``, on the CPU.

One port coordinator serves every surface an operator probes: fleet health
(a learner's and an actor's shipped series, a firing rule, alert history),
traces, the arena ladder and the league runtime; a port SL learner's admin
API answers ``profile``; a port learner's black-box bundle feeds
``dynamics``. For each of the eight commands both CLIs run in this process
against the same server, with the wall clock pinned, and must exit alike
and print the same lines. ``profile`` reads one live capture through a
caching proxy (two captures measure different times); the replay line of
``dynamics --inspect`` names each package's own stepreplay.
"""
import os
import sys
import threading
import time

import pytest
import torch  # noqa: F401 - loaded before the learner's modules
from conftest import SMALL_MODEL

from distar_tpu_torch import obs
from distar_tpu_torch.arena import ArenaStore, set_arena_store
from distar_tpu_torch.comm import CoordinatorServer
from distar_tpu_torch.league.runtime import LeagueService, set_league_service
from distar_tpu_torch.league.runtime.runner import league_cfg
from distar_tpu_torch.learner import SLLearner
from distar_tpu_torch.obs import FleetHealth, MetricsRegistry, default_rulebook
from distar_tpu_torch.tools import opsctl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = 1_700_000_000.0

torch.set_num_threads(1)


def jax_opsctl():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import opsctl as jopsctl
    finally:
        sys.path.pop(0)
    return jopsctl


def run_both(argv, capsys, monkeypatch):
    """(rc, stdout lines) of the port's CLI, then of the JAX one."""
    jmain = jax_opsctl().main
    said = []
    for main in (lambda: opsctl.main(argv), jmain):
        monkeypatch.setattr(sys, "argv", ["opsctl.py", *argv])
        capsys.readouterr()
        try:
            rc = main()
        except SystemExit as e:
            rc = e.code
        said.append((rc, capsys.readouterr().out.splitlines()))
    return said


@pytest.fixture(scope="module")
def surfaces(tmp_path_factory):
    """A port coordinator with fleet health, traces, an arena ladder and a
    league service, all holding data."""
    reg = MetricsRegistry()
    prev_reg = obs.set_registry(reg)
    fh = FleetHealth(rules=default_rulebook(stall_window_s=60.0), registry=reg)
    prev_fh = obs.set_fleet_health(fh)
    store = ArenaStore()
    set_arena_store(store)
    service = LeagueService(league_cfg(["MP0", "EP0"]), seed=0)
    set_league_service(service)
    srv = CoordinatorServer()
    srv.start()
    for i in range(4):
        fh.ingest.ingest({"source": "learner:MP0:0", "ts": T0 - 30 + i, "snapshot": {
            "distar_learner_iterations_total": float(i), "distar_learner_loss": 1.0 / (i + 1),
            "distar_learner_step_seconds_p50": 0.25, "distar_perf_step_seconds{token=sllearner}": 0.25,
            "distar_perf_mfu{token=sllearner}": 0.0}})
        fh.ingest.ingest({"source": "actor:1", "ts": T0 - 30 + i, "snapshot": {
            "distar_env_steps_total": 10.0 * i, "distar_actor_env_steps_per_s": 5.0},
            "traces": [{"trace_id": f"t-{i}", "span_id": f"s{i}", "name": "serve_request",
                        "ts": T0 - 30 + i, "dur_s": 0.05 * (i + 1), "outcome": "shed" if i == 3 else "ok",
                        "hops": []}]})
    fh.ingest.ingest({"source": "learner:MP0:0", "ts": T0 - 1, "snapshot": {
        "distar_learner_loss": float("nan")}})
    for _ in range(3):
        fh.evaluator.evaluate_once(now=T0)
    store.report_batch([{"key": f"MP0|EP0|r0e{i}", "home": "MP0", "away": "EP0", "round": 0,
                         "winner": ("home", "away", "draw")[i % 3], "game_steps": 8, "duration_s": 0.1}
                        for i in range(6)])
    service.register_learner({"player_id": "MP0", "learner_id": "MP0-learner"}, now=T0)
    service.ask_job({"player_id": "MP0", "learner_id": "MP0-learner"}, now=T0)
    yield f"{srv.host}:{srv.port}"
    srv.stop()
    set_arena_store(None)
    set_league_service(None)
    obs.set_fleet_health(prev_fh)
    obs.set_registry(prev_reg)


COMMANDS = [
    ["status"],
    ["status", "--replay-addrs", ""],
    ["tail-alerts", "--once"],
    ["query", "--name", "distar_learner_loss", "--tail", "5"],
    ["query", "--name", "distar_env_steps_total", "--source", "actor:1", "--json"],
    ["trace", "--limit", "10"],
    ["trace", "--outcome", "shed"],
    ["trace", "--min-ms", "500"],
    ["trace", "--id", "t-2"],
    ["trace", "--id", "no-such-trace"],
    ["arena"],
    ["arena", "--json"],
    ["league"],
]


@pytest.mark.parametrize("argv", COMMANDS, ids=[" ".join(c) for c in COMMANDS])
def test_commands_print_what_the_jax_cli_prints(surfaces, argv, capsys, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: T0)
    (rc, lines), (jrc, jlines) = run_both([*argv, "--addr", surfaces], capsys, monkeypatch)
    assert rc == jrc, (rc, jrc, lines, jlines)
    assert lines == jlines
    assert lines, argv


def test_status_exits_two_while_a_rule_fires(surfaces, capsys, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: T0)
    (rc, lines), (jrc, _) = run_both(["status", "--addr", surfaces], capsys, monkeypatch)
    assert rc == jrc == 2
    assert any("learner_loss_nonfinite" in ln for ln in lines)


def test_an_unreachable_address_exits_alike(capsys, monkeypatch):
    said = run_both(["status", "--addr", "127.0.0.1:9"], capsys, monkeypatch)
    assert said[0] == said[1]
    assert isinstance(said[0][0], str) and "failed" in said[0][0]


@pytest.fixture(scope="module")
def bundle_dir(tmp_path_factory):
    from distar_tpu_torch.resilience.chaos import ChaosInjector

    root = tmp_path_factory.mktemp("dyn")
    prev = os.environ.get("DISTAR_EXPERIMENTS_ROOT")
    os.environ["DISTAR_EXPERIMENTS_ROOT"] = str(root)
    try:
        learner = SLLearner({"common": {"save_path": str(root / "exp")},
                             "learner": {"batch_size": 2, "unroll_len": 2, "save_freq": 10 ** 6,
                                         "log_freq": 10, "dynamics": {"every_n": 1}},
                             "model": SMALL_MODEL}, device="cpu")
        inj = ChaosInjector()
        inj.poison_module(learner, "core_lstm", n=1)
        learner.run(1)
        inj.restore()
    finally:
        if prev is None:
            os.environ.pop("DISTAR_EXPERIMENTS_ROOT")
        else:
            os.environ["DISTAR_EXPERIMENTS_ROOT"] = prev
    return root / "exp"


@pytest.mark.parametrize("extra", [[], ["--json"], ["--inspect", "step0"], ["--inspect", "step0", "--json"],
                                   ["--inspect", "nope"]], ids=["list", "list-json", "inspect",
                                                                "inspect-json", "inspect-none"])
def test_dynamics_prints_what_the_jax_cli_prints(bundle_dir, extra, capsys, monkeypatch):
    (rc, lines), (jrc, jlines) = run_both(["dynamics", "--dir", str(bundle_dir), *extra], capsys, monkeypatch)
    assert rc == jrc and len(lines) == len(jlines) and lines
    for a, b in zip(lines, jlines):
        if "replay:" in a:  # each package names its own stepreplay
            assert a.replace("python -m distar_tpu_torch.tools.stepreplay", "python tools/stepreplay.py") == b
        else:
            assert a == b


def test_dynamics_on_an_empty_directory_exits_alike(tmp_path, capsys, monkeypatch):
    said = run_both(["dynamics", "--dir", str(tmp_path)], capsys, monkeypatch)
    assert said[0] == said[1] and said[0][0] == 1


def test_profile_prints_what_the_jax_cli_prints(tmp_path, capsys, monkeypatch):
    """Both CLIs ask for a 1-step capture of one running CPU learner,
    through a proxy that forwards the first POST to the learner's admin API
    and answers the second with the same capture: the same exit code and
    the same lines."""
    import http.server
    import urllib.request

    monkeypatch.setenv("DISTAR_EXPERIMENTS_ROOT", str(tmp_path))
    lrn = SLLearner({"common": {"save_path": str(tmp_path / "exp")},
                     "learner": {"batch_size": 2, "unroll_len": 2, "save_freq": 10 ** 9, "log_freq": 100},
                     "model": SMALL_MODEL}, device="cpu")
    admin = lrn.start_admin(port=0)
    captured = []

    class Proxy(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            if not captured:
                req = urllib.request.Request(f"http://{admin.host}:{admin.port}{self.path}", data=b"{}",
                                             method="POST", headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=150) as r:
                    captured.append(r.read())
            self.send_response(200)
            self.send_header("Content-Length", str(len(captured[0])))
            self.end_headers()
            self.wfile.write(captured[0])

        def log_message(self, *a):
            pass

    proxy = http.server.HTTPServer(("127.0.0.1", 0), Proxy)
    threading.Thread(target=proxy.serve_forever, daemon=True).start()
    loop = threading.Thread(target=lambda: lrn.run(10 ** 6), daemon=True)
    loop.start()
    try:
        (rc, lines), (jrc, jlines) = run_both(
            ["profile", "--addr", f"127.0.0.1:{proxy.server_address[1]}", "--steps", "1", "--timeout", "120"],
            capsys, monkeypatch)
    finally:
        proxy.shutdown()
        lrn.request_stop()
        loop.join(60)
        admin.stop()
    assert rc == jrc == 0
    assert lines[0].startswith("| bucket |")
    assert lines == jlines
