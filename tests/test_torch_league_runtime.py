"""The port's league runtime (``distar_tpu_torch.league.runtime``) against
the JAX package's, on the CPU.

* ``LeagueService`` is host code whose every mutating route takes ``now``
  and draws from its own ``random.Random(seed)``: the port's and the JAX
  one run the same scripted sequence with pinned ``now`` (``np.random``
  seeded before each side, as the players' own draws use it) and give the
  same replies — jobs by branch, reports, mints, resets — and the same
  ``state_digest``; the port's loads a resume file the JAX league wrote
  (``utils.pickles``) and matchmakes on from it as the JAX one does.
* Mirrors of every test of tests/test_league_runtime.py, apart from the
  ``comm.ha.apply_record`` replay (the coordinator's HA, ROADMAP Queue 1
  item 11); ``build_actor_fleets`` raises naming item 10 (``fleet/``), where
  the JAX test spawns fleets.
* The loop: the live self-play slot is re-read every window; a frozen
  opponent is a port ``Model`` loaded from the job's checkpoint; one
  league learner runs in process against a control plane over HTTP.
* ``rl_train --type league-run --smoke-model --device cpu --journal-dir
  none`` runs two learner processes to ``LEAGUE-RUN-DONE`` with ``ok``.
"""
import json
import os
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from conftest import SMALL_MODEL

from distar_tpu import arena as jarena
from distar_tpu import obs as jobs
from distar_tpu.comm import coordinator as jcoord
from distar_tpu.league import remote as jremote
from distar_tpu.league import runtime as jruntime
from distar_tpu.league.runtime import runner as jrunner
from distar_tpu_torch import obs as pobs
from distar_tpu_torch.arena import ArenaStore, set_arena_store
from distar_tpu_torch.bin import rl_train
from distar_tpu_torch.comm import Coordinator, CoordinatorServer
from distar_tpu_torch.league.remote import RemoteLeagueService
from distar_tpu_torch.league.runtime import (
    BRANCHES,
    LeagueService,
    PayoffReassigner,
    get_league_service,
    set_league_service,
)
from distar_tpu_torch.league.runtime.reassign import _largest_remainder
from distar_tpu_torch.league.runtime.runner import (
    LeagueLearnerLoop,
    LeaguePublisher,
    LeagueRunner,
    build_actor_fleets,
    league_actor_cmd,
    league_cfg,
)
from distar_tpu_torch.model import Model, default_model_config, init_params
from distar_tpu_torch.model.convert import params_to_flax
from distar_tpu_torch.utils import deep_merge_dicts
from distar_tpu_torch.utils.checkpoint import save_checkpoint

torch.set_num_threads(1)

ROSTER = ("MP0", "EP0", "ME0")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = ["--batch-size", "2", "--traj-len", "3", "--jaxenv-units", "2", "--jaxenv-episode-len", "8"]


@pytest.fixture
def registry():
    preg, jreg = pobs.MetricsRegistry(), jobs.MetricsRegistry()
    pprev, jprev = pobs.set_registry(preg), jobs.set_registry(jreg)
    yield preg
    pobs.set_registry(pprev)
    jobs.set_registry(jprev)


@pytest.fixture
def arena_global():
    """The process-global arena-store and league-service slots of both
    packages, cleared on teardown."""
    yield
    set_arena_store(None)
    jarena.set_arena_store(None)
    set_league_service(None)
    jruntime.set_league_service(None)


def _service(seed: int = 7, lease_s: float = 5.0, job_ttl_s: float = 60.0, lib=None):
    mod = lib or __import__("distar_tpu_torch.league.runtime", fromlist=["LeagueService"])
    return mod.LeagueService(league_cfg(ROSTER), seed=seed, lease_s=lease_s, job_ttl_s=job_ttl_s)


def _drive(svc, extra_asks: int = 0):
    """A scripted mutation sequence with pinned ``now``: registrations, asks
    with their reports (every winner), a replayed report, train-infos with
    mints (the exploiters' resets among them), a duplicate seq, a lapsed
    lease and an expired assignment. Returns every reply, in order."""
    replies = []

    def call(method, body, ts):
        replies.append((method, getattr(svc, method)(body, now=ts)))
        return replies[-1][1]

    for i, pid in enumerate(ROSTER):
        call("register_learner", {"player_id": pid, "learner_id": f"L{i}"}, 10.0 + i)
    for i in range(9 + extra_asks):
        pid = ROSTER[i % 3]
        job = call("ask_job", {"player_id": pid, "learner_id": f"L{i % 3}"}, 20.0 + i)
        matches = [{"key": f"{job['job_id']}e{e}", "home": pid, "away": job["player_ids"][1], "round": 0,
                    "winner": ("home", "away", "draw")[(i + e) % 3], "game_steps": 9 + e, "duration_s": 0.5}
                   for e in range(2)]
        body = {"job_id": job["job_id"], "learner_id": f"L{i % 3}", "matches": matches}
        call("report", body, 30.0 + i)
        if i == 4:
            call("report", body, 30.5 + i)  # a replayed report
    for r in range(2):
        for i, pid in enumerate(ROSTER):
            call("train_info", {"player_id": pid, "learner_id": f"L{i}", "seq": r, "train_steps": 3,
                                "generation_path": f"/ckpt/{pid}_g{r}.ckpt"}, 40.0 + 3 * r + i)
    call("train_info", {"player_id": "MP0", "learner_id": "L0", "seq": 1, "train_steps": 3}, 50.0)
    call("ask_job", {"player_id": "MP0", "learner_id": "L0"}, 51.0)  # never reported
    call("ask_job", {"player_id": "nope"}, 52.0)
    call("ask_job", {"player_id": "EP0", "learner_id": "L1"}, 200.0)  # expires the unreported job
    replies.append(("status", svc.status(now=201.0)))
    return replies


def _both(seed=23, extra_asks=0):
    """The scripted sequence through the port's service and the JAX one,
    each on an arena store of its own package."""
    out = []
    for lib, store_mod in ((None, None), (jruntime, jarena)):
        store = (store_mod.ArenaStore if store_mod else ArenaStore)()
        (store_mod.set_arena_store if store_mod else set_arena_store)(store)
        svc = _service(seed=seed, lib=lib)
        np.random.seed(5)
        out.append((svc, store, _drive(svc, extra_asks)))
    return out


# ------------------------------------------------------ against the JAX service
def test_service_equals_the_jax_service_on_a_scripted_sequence(registry, arena_global):
    (port, pstore, got), (jax_svc, jstore, want) = _both()
    assert len(got) == len(want) > 30
    for (m, a), (_, b) in zip(got, want):
        assert a == b, m
    assert port.state_digest() == jax_svc.state_digest()
    assert port.jobs_by_branch == jax_svc.jobs_by_branch
    assert sum(port.jobs_by_branch.values()) == port.state_digest()["job_seq"]
    assert port.orphans_total == 1
    assert pstore.ratings_snapshot() == jstore.ratings_snapshot()
    assert pstore.duplicates_total == jstore.duplicates_total == 2
    # the league-side payoffs agree too
    for pid in ROSTER:
        assert port.league.active_players[pid].total_game_count == \
            jax_svc.league.active_players[pid].total_game_count
        assert port.league.active_players[pid].payoff.get_text() == \
            jax_svc.league.active_players[pid].payoff.get_text()


def test_service_loads_a_resume_file_the_jax_league_wrote(registry, arena_global, tmp_path):
    (_, _, _), (jax_svc, _, _) = _both(seed=5)
    path = str(tmp_path / "league.resume")
    jax_svc.league.save_resume(path)
    port = _service(seed=77)
    port.league.load_resume(path)
    assert port.state_digest() == jax_svc.state_digest()
    assert type(port.league.active_players["MP0"]).__module__ == "distar_tpu_torch.league.player"
    # and matchmakes on from where the JAX service left off
    for i, pid in enumerate(ROSTER * 3):
        a = port.ask_job({"player_id": pid}, now=300.0 + i)
        b = jax_svc.ask_job({"player_id": pid}, now=300.0 + i)
        assert a == b
    assert port.state_digest() == jax_svc.state_digest()


def test_service_state_blob_crosses_nothing_but_round_trips(registry, arena_global):
    (port, _, _), (jax_svc, _, _) = _both(seed=9)
    other = _service(seed=99)  # a wrong seed: load_state must overwrite the RNG
    other.load_state(port.state_blob())
    assert other.state_digest() == port.state_digest() == jax_svc.state_digest()


# --------------------------------------------------------------- matchmaking
def test_branch_distribution_matches_configured_probs(registry, arena_global):
    n = 400
    expected = {
        "MP0": {"sp": 0.5, "pfsp": 0.5},
        "EP0": {"pfsp": 1.0},
        "ME0": {"vs_main": 0.3, "pfsp": 0.5, "eval": 0.2},
    }
    sequences = {}
    for pid, probs in expected.items():
        svc = _service(seed=11)
        counts = {b: 0 for b in BRANCHES}
        seq = []
        for i in range(n):
            job = svc.ask_job({"player_id": pid}, now=1000.0 + i)
            counts[job["branch"]] += 1
            seq.append((job["branch"], tuple(job["player_ids"])))
        sequences[pid] = seq
        for branch, p in probs.items():
            assert abs(counts[branch] / n - p) < 0.09, (pid, branch, counts)
        for branch in set(BRANCHES) - set(probs):
            assert counts[branch] == 0, (pid, branch, counts)
    for pid in expected:
        svc2 = _service(seed=11)
        replay = [(j["branch"], tuple(j["player_ids"]))
                  for j in (svc2.ask_job({"player_id": pid}, now=1000.0 + i) for i in range(n))]
        assert replay == sequences[pid]


def test_ask_job_shapes_and_unknown_player(registry, arena_global):
    svc = _service()
    job = svc.ask_job({"player_id": "ME0", "learner_id": "L1"}, now=1.0)
    assert job["job_id"] == "J1"
    assert job["player_ids"][0] == "ME0"
    assert job["branch"] in BRANCHES
    if job["branch"] == "eval":
        assert job["send_data_players"] == []
    assert svc.ask_job({"player_id": "nope"}, now=2.0) is None
    status = svc.status(now=3.0)
    assert status["assignments_pending"] == 1
    assert status["assignments"]["J1"]["learner_id"] == "L1"


def test_pfsp_weights_agree_with_arena_preview(registry, arena_global):
    store = ArenaStore()
    set_arena_store(store)
    recs = []
    for i, (away, winner) in enumerate(
            [("MP0H1", "home")] * 6 + [("MP0H1", "away")] * 2 + [("EP0H1", "home")] * 3
            + [("EP0H1", "draw")] * 3 + [("ME0H1", "away")] * 5):
        recs.append({"key": f"m{i}", "home": "MP0", "away": away, "round": 0, "winner": winner,
                     "game_steps": 10, "duration_s": 1.0})
    assert store.report_batch(recs)["applied"] == len(recs)
    svc = _service()
    candidates = ["EP0H1", "ME0H1", "MP0H1"]
    weights = svc.pfsp_weights("MP0", candidates)
    row = store.pfsp_preview(["MP0"] + candidates)["MP0"]
    assert weights == [row[c] for c in candidates]
    assert sum(weights) > 0
    set_arena_store(None)
    assert svc.pfsp_weights("MP0", candidates) == pytest.approx([1 / 3] * 3)
    assert svc.pfsp_weights("MP0", []) == []


# ------------------------------------------------------------------- minting
def test_snapshot_minting_idempotent(registry, arena_global):
    svc = _service()
    svc.register_learner({"player_id": "MP0", "learner_id": "L1"}, now=1.0)
    hist0 = len(svc.league.historical_players)
    body = {"player_id": "MP0", "learner_id": "L1", "seq": 0, "train_steps": 5,
            "generation_path": "/ckpt/gen1.ckpt"}
    first = svc.train_info(dict(body), now=2.0)
    assert first["minted"] and first["snapshot_id"]
    minted_id = first["snapshot_id"]
    assert svc.league.historical_players[minted_id].checkpoint_path == "/ckpt/gen1.ckpt"
    again = svc.train_info({**body, "seq": 1}, now=3.0)
    assert not again["minted"] and again["snapshot_id"] == minted_id
    assert len(svc.league.historical_players) == hist0 + 1
    dup = svc.train_info({**body, "seq": 1}, now=4.0)
    assert dup == {"ok": True, "duplicate": True}
    assert svc.league.active_players["MP0"].total_agent_step == 10
    nxt = svc.train_info({**body, "seq": 2, "generation_path": "/ckpt/gen2.ckpt"}, now=5.0)
    assert nxt["minted"] and nxt["snapshot_id"] != minted_id


def test_main_exploiter_reset_rolls_back_to_teacher(registry, arena_global):
    svc = LeagueService(league_cfg(ROSTER, teacher_path="/ckpt/teacher.ckpt"), seed=3)
    svc.register_learner({"player_id": "ME0", "learner_id": "L1"}, now=1.0)
    out = svc.train_info({"player_id": "ME0", "learner_id": "L1", "seq": 0,
                          "generation_path": "/ckpt/me0g1.ckpt"}, now=2.0)
    assert out["minted"]
    assert out["reset_checkpoint_path"] == "/ckpt/teacher.ckpt"
    assert svc.league.active_players["ME0"].checkpoint_path == "/ckpt/teacher.ckpt"


# ------------------------------------------------- leases, freeze, expiry
def test_freeze_is_derived_and_thaws_on_reregister(registry, arena_global):
    svc = _service(lease_s=5.0)
    svc.register_learner({"player_id": "MP0", "learner_id": "L1"}, now=100.0)
    assert svc.status(now=101.0)["frozen_players"] == []
    st = svc.status(now=120.0)
    assert st["frozen_players"] == ["MP0"]
    assert st["active_learners"] == 0
    reply = svc.register_learner({"player_id": "MP0", "learner_id": "L1"}, now=121.0)
    assert reply["registered"] and reply["train_seq"] == -1
    assert svc.status(now=122.0)["frozen_players"] == []
    assert svc.register_learner({"player_id": "XX9"}, now=123.0)["registered"] is False


def test_assignment_expiry_prunes_inside_journaled_routes(registry, arena_global):
    svc = _service(job_ttl_s=60.0)
    svc.ask_job({"player_id": "MP0"}, now=100.0)
    assert svc.status(now=400.0)["assignments_pending"] == 1  # read-only
    svc.ask_job({"player_id": "EP0"}, now=400.0)  # a mutating route: prunes
    st = svc.status(now=401.0)
    assert st["assignments_pending"] == 1
    assert st["orphaned_jobs"] == 1
    out = svc.report({"job_id": "J1", "matches": []}, now=402.0)
    assert out["completed"] is False


def test_report_dedups_league_payoff_by_match_key(registry, arena_global):
    store = ArenaStore()
    set_arena_store(store)
    svc = _service()
    job = svc.ask_job({"player_id": "MP0"}, now=1.0)
    away = job["player_ids"][1]
    matches = [{"key": f"{job['job_id']}e0", "home": "MP0", "away": away, "round": 0, "winner": "home",
                "game_steps": 8, "duration_s": 1.0}]
    out = svc.report({"job_id": job["job_id"], "matches": matches}, now=2.0)
    assert out["completed"] and out["applied"] == 1
    games0 = svc.league.active_players["MP0"].total_game_count
    out2 = svc.report({"job_id": job["job_id"], "matches": matches}, now=3.0)
    assert out2["duplicates"] == 1
    assert svc.league.active_players["MP0"].total_game_count == games0


# ----------------------------------------------------------------- durability
def test_state_blob_reconstructs_digest(registry, arena_global):
    """The snapshot path of recovery (state_blob/load_state) lands on an
    identical structural digest; the journal-replay path is the
    coordinator's HA (ROADMAP Queue 1 item 11)."""
    store = ArenaStore()
    set_arena_store(store)
    svc_a = _service(seed=23)
    _drive(svc_a)
    digest_a = svc_a.state_digest()
    assert digest_a["job_seq"] == 11
    assert len(digest_a["minted"]) == 6
    svc_b = _service(seed=99)
    svc_b.load_state(svc_a.state_blob())
    assert svc_b.state_digest() == digest_a


def test_league_save_resume_carries_runtime_state(registry, arena_global, tmp_path):
    store = ArenaStore()
    set_arena_store(store)
    svc_a = _service(seed=5)
    _drive(svc_a)
    path = str(tmp_path / "league.resume")
    svc_a.league.save_resume(path)
    svc_b = _service(seed=77)
    svc_b.league.load_resume(path)
    assert svc_b.state_digest() == svc_a.state_digest()
    job_a = svc_a.ask_job({"player_id": "MP0"}, now=260.0)
    job_b = svc_b.ask_job({"player_id": "MP0"}, now=260.0)
    assert (job_a["branch"], job_a["player_ids"], job_a["job_id"]) == \
        (job_b["branch"], job_b["player_ids"], job_b["job_id"])


def test_league_role_resumes_and_autosaves(registry, tmp_path, capsys):
    """``--type league --league-resume``: a resume file the JAX league wrote
    is loaded on start, and the league journals back to it."""
    from distar_tpu.league import League as JaxLeague

    path = str(tmp_path / "league.resume")
    jleague = JaxLeague(league_cfg(ROSTER))
    jleague.active_players["MP0"].total_agent_step = 1234
    jleague.save_resume(path)
    before = os.path.getmtime(path)
    args = rl_train.parser().parse_args(["--type", "league", "--league-resume", path,
                                         "--league-autosave-s", "0.05", "--device", "cpu"])
    import signal
    import threading
    import time

    said = []

    def stop_soon():
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            said.append(capsys.readouterr().out)
            if "league serving on" in "".join(said) and os.path.getmtime(path) > before:
                break
            time.sleep(0.05)
        os.kill(os.getpid(), signal.SIGTERM)

    stopper = threading.Thread(target=stop_soon, daemon=True)
    stopper.start()
    rl_train.run_league(args)
    stopper.join(timeout=30)
    said.append(capsys.readouterr().out)
    assert f"league resumed from {path}" in "".join(said)
    assert os.path.getmtime(path) > before
    from distar_tpu_torch.league import League

    league = League(league_cfg(ROSTER))
    league.load_resume(path)
    assert league.active_players["MP0"].total_agent_step == 1234


# ------------------------------------------------------------------ wire plane
@pytest.mark.parametrize("server_lib,client_lib", [("port", "port"), ("port", "jax"), ("jax", "port")])
def test_remote_league_service_roundtrip(registry, arena_global, server_lib, client_lib):
    """Every league route over a real CoordinatorServer through the proxy
    the learners use, each package's proxy against each package's server."""
    if server_lib == "port":
        store, svc = ArenaStore(), _service()
        set_arena_store(store)
        set_league_service(svc)
        server = CoordinatorServer(coordinator=Coordinator(), port=0)
    else:
        jarena.set_arena_store(jarena.ArenaStore())
        jruntime.set_league_service(_service(lib=jruntime))
        server = jcoord.CoordinatorServer(coordinator=jcoord.Coordinator(), port=0)
    server.start()
    try:
        cls = RemoteLeagueService if client_lib == "port" else jremote.RemoteLeagueService
        remote = cls(f"127.0.0.1:{server.port}")
        reply = remote.register_learner("MP0", learner_id="L1")
        assert reply["registered"] and reply["train_seq"] == -1
        job = remote.ask_job("MP0", learner_id="L1")
        assert job and job["job_id"] == "J1"
        out = remote.report(job["job_id"], [
            {"key": "J1e0", "home": "MP0", "away": job["player_ids"][1], "round": 0, "winner": "home",
             "game_steps": 4, "duration_s": 0.1}], learner_id="L1")
        assert out["completed"] and out["applied"] == 1
        info = remote.train_info("MP0", seq=0, train_steps=2, generation_path="/ckpt/g1.ckpt",
                                 learner_id="L1")
        assert info["minted"]
        status = remote.status()
        assert status["snapshot_mints"] == 1
        assert status["jobs_by_branch"][job["branch"]] == 1
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/league/status", timeout=5) as resp:
            got = json.loads(resp.read())
        assert got["snapshot_mints"] == 1
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/arena/ratings", timeout=5) as resp:
            assert json.loads(resp.read())["matches_total"] == 1
    finally:
        server.stop()


# --------------------------------------------------------------- elastic half
def test_largest_remainder_exact_and_deterministic():
    out = _largest_remainder({"a": 0.0, "b": 0.25, "c": 0.25}, 6, 1)
    assert sum(out.values()) == 6
    assert out == {"a": 1, "b": 3, "c": 2}
    assert _largest_remainder({"a": 1.0, "b": 1.0}, 0, 0) == {"a": 0, "b": 0}
    assert _largest_remainder({"a": 0.0, "b": 0.0}, 4, 1) == {"a": 2, "b": 2}
    assert _largest_remainder({}, 5, 1) == {}
    out = _largest_remainder({"a": 100.0, "b": 0.0}, 3, 1)
    assert out["b"] >= 1 and sum(out.values()) == 3
    from distar_tpu.league.runtime.reassign import _largest_remainder as jax_lr

    for w, total, floor in (({"a": 0.3, "b": 0.2, "c": 0.5}, 11, 2), ({"x": 0.1, "y": 0.7}, 7, 0)):
        assert _largest_remainder(w, total, floor) == jax_lr(w, total, floor)


class _FakeSupervisor:
    def __init__(self, fleets):
        self._fleets = dict(fleets)
        self.calls = []

    def fleets(self):
        return sorted(self._fleets)

    def actual(self, name):
        return self._fleets[name]

    def scale_up(self, name, n=1):
        self._fleets[name] += n
        self.calls.append(("up", name, n))

    def scale_down(self, name, n=1):
        self._fleets[name] -= n
        self.calls.append(("down", name, n))


class _FakeService:
    def __init__(self):
        self.moved = 0

    def note_reassignment(self, n=1):
        self.moved += n


def test_payoff_reassigner_moves_capacity_to_uncertain_pairs():
    sup = _FakeSupervisor({"actors-MP0": 4, "actors-EP0": 1, "actors-ME0": 1})
    svc = _FakeService()
    cells = [{"a": "MP0", "b": "MP0H1", "games": 9, "win_rate": 1.0},
             {"a": "EP0", "b": "MP0H1", "games": 4, "win_rate": 0.5}]
    r = PayoffReassigner(sup, {"actors-MP0": "MP0", "actors-EP0": "EP0", "actors-ME0": "ME0"},
                         total_actors=6, min_actors=1, payoff_fn=lambda: {"cells": cells}, service=svc)
    assert r.learning_weights() == {"actors-MP0": 0.0, "actors-EP0": 0.25, "actors-ME0": 0.25}
    deltas = r.step()
    assert deltas == {"actors-MP0": -3, "actors-EP0": 2, "actors-ME0": 1}
    assert sup._fleets == {"actors-MP0": 1, "actors-EP0": 3, "actors-ME0": 2}
    assert sup.calls[0][0] == "down"
    assert svc.moved == 3
    assert all(d == 0 for d in r.step().values())


def test_payoff_reassigner_reads_the_hosted_store_and_counts_on_the_service(registry, arena_global):
    store = ArenaStore(anchors=())
    set_arena_store(store)
    store.report_batch([{"key": f"k{i}", "home": "MP0", "away": "EP0H1", "round": 0,
                         "winner": "home" if i % 2 else "away", "game_steps": 3, "duration_s": 0.1}
                        for i in range(4)])
    svc = _service()
    sup = _FakeSupervisor({"actors-MP0": 1, "actors-EP0": 3})
    r = PayoffReassigner(sup, {"actors-MP0": "MP0", "actors-EP0": "EP0"}, total_actors=4, min_actors=1,
                         service=svc)
    assert r.learning_weights() == {"actors-MP0": 0.25, "actors-EP0": 0.25}
    assert r.step() == {"actors-MP0": 1, "actors-EP0": -1}
    assert svc.reassignments_total == 1
    assert registry.counter("distar_league_reassignments_total", "").value == 1


def test_league_publisher_publishes_and_ignores_unknown_players():
    from distar_tpu_torch.serve.mux import GatewayMux
    from distar_tpu_torch.serve.registry import ModelRegistry

    loaded = []

    def load_fn(source):
        loaded.append(source)
        return {"w": source}

    gw = SimpleNamespace(registry=ModelRegistry(load_fn=load_fn))
    pub = LeaguePublisher(GatewayMux({"MP0": gw}))
    assert pub.publish("MP0", "gen1", "/ckpt/g1.ckpt")
    gen, version, params = gw.registry.current()
    assert version == "gen1" and params == {"w": "/ckpt/g1.ckpt"}
    assert pub.published == {"MP0": "gen1"}
    assert pub.publish("EP0H1", "gen1", "/ckpt/x.ckpt") is False
    assert loaded == ["/ckpt/g1.ckpt"]


def test_build_actor_fleets_and_the_journal_name_their_items(tmp_path):
    """The JAX runner's actor-slot fleets need ``fleet/`` (ROADMAP Queue 1
    item 10) and its journal the coordinator's HA (item 11); the member
    command is ported as it is."""
    with pytest.raises(NotImplementedError, match="item 10"):
        build_actor_fleets(("MP0", "EP0"), actors_per_player=2)
    with pytest.raises(NotImplementedError, match="item 10"):
        LeagueRunner(("MP0",), actors_per_player=1)
    with pytest.raises(NotImplementedError, match="item 11"):
        LeagueRunner(("MP0",), journal_dir=str(tmp_path))
    with pytest.raises(NotImplementedError, match="--journal-dir none"):
        rl_train.main(["--type", "league-run", "--device", "cpu"])
    build = league_actor_cmd("MP0")
    assert build(0)[1:3] == jrunner.league_actor_cmd("MP0")(0)[1:3]
    assert build(0)[-1] == jrunner.league_actor_cmd("MP0")(0)[-1]
    assert league_cfg(ROSTER) == jrunner.league_cfg(ROSTER)


# -------------------------------------------------------------------- the loop
def test_self_play_opponent_resolves_live_model_each_window():
    """Live self-play (away == home) re-reads the learner's model at every
    rollout window, so the away seat follows its updates."""
    learner = SimpleNamespace(model="m1")
    loop = LeagueLearnerLoop("MP0", remote=None, learner=learner, loader=None, learner_id="L1")
    assert loop.opponent_model() is None  # before the first job: the loader's frozen initial policy
    job = {"job_id": "J1", "player_ids": ["MP0", "MP0"], "checkpoint_paths": ["", ""], "branch": "sp"}
    assert loop._resolve_opponent(job) == "MP0"
    assert loop.opponent_model() == "m1"
    learner.model = "m2"
    assert loop.opponent_model() == "m2"
    # an unpublished opponent: None again
    job = {"job_id": "J2", "player_ids": ["MP0", "EP0H1"], "checkpoint_paths": ["", ""], "branch": "pfsp"}
    assert loop._resolve_opponent(job) == "EP0H1"
    assert loop.opponent_model() is None


def test_frozen_opponent_is_a_model_loaded_once_per_job(tmp_path):
    cfg = deep_merge_dicts(default_model_config(), SMALL_MODEL)
    cfg.use_value_network = True
    home, snap = Model(cfg), Model(cfg)
    init_params(home, 0)
    init_params(snap, 4)
    path = str(tmp_path / "snap.ckpt")
    save_checkpoint(path, {"params": params_to_flax(snap)["params"], "opt_state": ()})
    loop = LeagueLearnerLoop("MP0", remote=None, learner=SimpleNamespace(model=home, device=torch.device("cpu")),
                             loader=None)
    loop._resolve_opponent({"job_id": "J1", "player_ids": ["MP0", "MP0H1"], "checkpoint_paths": ["", path]})
    opp = loop.opponent_model()
    assert opp is loop.opponent_model()  # one model for the job, not one per window
    assert opp is not home and not any(p.requires_grad for p in opp.parameters())
    for (name, a), b in zip(opp.state_dict().items(), snap.state_dict().values()):
        assert torch.equal(a, b), name


def test_league_learner_runs_in_process_against_a_control_plane(registry, arena_global, tmp_path, capsys):
    """``--type league-learner`` in this process against a league-run
    control plane over HTTP: one round of ask -> Anakin windows with the
    away seat -> RL step -> report -> generation -> train-info, the first
    window pure; the service minted a snapshot from its generation."""
    runner = LeagueRunner(("MP0", "EP0"), save_path=str(tmp_path))
    addr = runner.start_control_plane()
    try:
        out = rl_train.main(["--type", "league-learner", "--player-id", "MP0", "--coordinator-addr", addr,
                             "--league-rounds", "1", "--smoke-model", "--device", "cpu", "--save-path",
                             str(tmp_path), "--no-supervise"] + SIZES)
        said = capsys.readouterr().out
        assert "league-learner MP0 device purity: {'pure': True, 'offending': []}" in said
        assert out["jobs"] == 1 and out["mints"] == 1 and out["iters"] == 1
        assert out["rounds"][0]["matches"] >= 1
        status = get_league_service().status()
        assert status["snapshot_mints"] == 1 and status["assignments_pending"] == 0
        minted = next(iter(status["minted"].values()))
        assert os.path.exists(get_league_service().league.historical_players[minted].checkpoint_path)
        assert runner.store.matches_total == out["rounds"][0]["matches"]
        assert os.path.isdir(os.path.join(str(tmp_path), "MP0", "checkpoints"))
    finally:
        runner.shutdown()


def test_league_run_on_the_cpu(tmp_path, capfd, monkeypatch):
    """``rl_train --type league-run``: the control plane in this process and
    a learner process per player (MP0, EP0), two rounds each; LEAGUE-RUN-DONE
    with ``ok``: every learner at rc 0, snapshots minted, off-diagonal
    payoff cells with games, no orphaned job. The runner gives each learner
    its share of the cores (with a thread per core each, two processes on
    the CPU took about 240 s here, 12-16 s with their share)."""
    monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    digest = rl_train.main(["--type", "league-run", "--smoke-model", "--device", "cpu", "--league-players",
                            "MP0,EP0", "--league-rounds", "2", "--journal-dir", "none", "--save-path",
                            str(tmp_path)] + SIZES)
    out = capfd.readouterr().out
    assert digest["ok"] and digest["learner_rc"] == {"MP0": 0, "EP0": 0}
    assert digest["snapshot_mints"] >= 1 and digest["off_diagonal_pairs"] >= 1 and digest["orphaned_jobs"] == 0
    line = next(ln for ln in out.splitlines() if ln.startswith("LEAGUE-RUN-DONE "))
    assert json.loads(line[len("LEAGUE-RUN-DONE "):]) == digest
    for pid in ("MP0", "EP0"):
        assert f"league-learner {pid} device purity: {{'pure': True, 'offending': []}}" in out
        assert f"league-learner {pid}: round 2/2" in out
    assert os.path.exists(os.path.join(str(tmp_path), "arena_store.pkl"))
    assert get_league_service() is None  # the control plane is gone


def test_league_runner_gives_each_learner_its_share_of_the_cores(monkeypatch):
    monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    cores = len(os.sched_getaffinity(0))
    assert LeagueRunner(("MP0", "EP0", "ME0"))._learner_env()["OMP_NUM_THREADS"] == str(max(1, cores // 3))
    assert LeagueRunner(("MP0",), env={"OMP_NUM_THREADS": "5"})._learner_env()["OMP_NUM_THREADS"] == "5"
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    assert LeagueRunner(("MP0", "EP0"))._learner_env()["OMP_NUM_THREADS"] == "2"
