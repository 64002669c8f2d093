"""The port's arena (``distar_tpu_torch.arena``) against the JAX package's,
on the CPU.

* The store is host code with no RNG of its own: the port's ``ArenaStore``
  and the JAX one take the same scripted report sequence (duplicates,
  every winner, both seatings) and are held EQUAL after every batch — the
  schedule (``next_match``), the ratings and payoff snapshots, the PFSP
  preview and the dedup counts. The port's store loads a ledger the JAX
  store wrote (``utils.pickles`` maps its module paths) and carries on as
  the JAX store does.
* The evaluator: the port's ``ArenaEvaluator`` and the JAX one rate the
  same SMALL_MODEL generation (port weights carried to JAX through
  ``params_to_flax``) against the anchors over three scheduled batches.
  The port draws an assignment's scenarios from a ``torch.Generator``
  (ROADMAP Queue 3 item 16), so the test hands it the JAX-made ones by
  replacing ``evaluator.assignment_scenarios``, and it hands the model
  player the Gumbel draws JAX derives for its seat (``jax_gumbel_noise``,
  as tests/test_torch_anakin.py does). Winners and game steps must be
  equal, match by match.
* Mirrors of every test of tests/test_arena.py on the port, the e2e's
  ratings, payoff, restart and HTTP surfaces and its TSDB scoreboard
  (the JAX package's ``opsctl arena`` against the port's coordinator,
  reading the series the port's fleet health sampled) among them.
"""
import json
import math
import os
import sys
import time
import urllib.request
from argparse import Namespace

import jax
import numpy as np
import pytest
import torch
from conftest import SMALL_MODEL
from test_torch_model import jax_gumbel_noise

from distar_tpu import arena as jarena
from distar_tpu import obs as jobs
from distar_tpu.envs import jaxenv as J
from distar_tpu.utils import checkpoint as jckpt
from distar_tpu_torch import arena as parena
from distar_tpu_torch import obs as pobs
from distar_tpu_torch.arena import evaluator as pevaluator
from distar_tpu_torch.arena import (
    ANCHORS,
    ArenaEvaluator,
    ArenaStore,
    match_key,
    match_seed,
    set_arena_store,
    wilson_interval,
)
from distar_tpu_torch.envs import jaxenv as P
from distar_tpu_torch.envs.jaxenv.scenario import Scenario
from distar_tpu_torch.league.elo import DRAW, WIN, ELORating
from distar_tpu_torch.league.payoff import Payoff
from distar_tpu_torch.model import Model, default_model_config, init_params
from distar_tpu_torch.model.convert import params_to_flax
from distar_tpu_torch.utils import deep_merge_dicts
from distar_tpu_torch.utils.checkpoint import CheckpointManager, save_checkpoint

torch.set_num_threads(1)

TINY_ENV = P.EnvConfig(units_per_squad=2)
# accounting-only scenario: outcome content doesn't matter, speed does
TINY_SCN = P.ScenarioConfig(units_per_squad=2, min_units=2, max_units=2, episode_len=12)
# separating scenario: open terrain + long-enough timeout so attack_nearest
# actually converts engagements (the JAX e2e's config)
FIGHT = dict(units_per_squad=2, min_units=2, max_units=2, episode_len=96, spawn_margin=50.0,
             spawn_spread=4.0, mirror_types=True, blocked_frac=0.0)
FIGHT_SCN = P.ScenarioConfig(**FIGHT)


@pytest.fixture
def registry():
    """A fresh metrics registry in each package."""
    preg, jreg = pobs.MetricsRegistry(), jobs.MetricsRegistry()
    pprev, jprev = pobs.set_registry(preg), jobs.set_registry(jreg)
    yield preg
    pobs.set_registry(pprev)
    jobs.set_registry(jprev)


@pytest.fixture
def arena_global():
    """The process-global arena-store slots of both packages, cleared on
    teardown."""
    yield
    set_arena_store(None)
    jarena.set_arena_store(None)


def _recs(home, away, rnd, winners, base=0, steps=10):
    return [{"key": match_key(home, away, rnd, base + i), "home": home, "away": away, "round": rnd,
             "winner": w, "game_steps": steps + i, "duration_s": 0.1 * (i + 1)}
            for i, w in enumerate(winners)]


def _script(rng):
    """A report sequence: batches on scheduled and unscheduled pairs, every
    winner, both seatings, with replayed batches (duplicates) mixed in."""
    players = ["main:300", "main:200", "main:100", "EP0H1"]
    batches = []
    for b in range(24):
        pool = players + list(ANCHORS)
        home, away = rng.choice(len(pool), 2, replace=False)
        winners = [("home", "away", "draw")[int(w)] for w in rng.integers(0, 3, int(rng.integers(1, 6)))]
        batches.append(_recs(pool[home], pool[away], int(rng.integers(0, 4)), winners))
        if b % 5 == 4:
            batches.append(batches[-2])  # a replayed batch: all duplicates
    return players, batches


def _same_store(port, jax_store, players):
    assert port.ratings_snapshot() == jax_store.ratings_snapshot()
    assert port.payoff_snapshot() == jax_store.payoff_snapshot()
    for roster in (players, players[1:], []):
        assert port.next_match(roster, episodes=4) == jax_store.next_match(roster, episodes=4)
    assert port.pfsp_preview(players + list(ANCHORS)) == jax_store.pfsp_preview(players + list(ANCHORS))
    assert (port.matches_total, port.duplicates_total) == (jax_store.matches_total, jax_store.duplicates_total)
    assert port.players() == jax_store.players()


# ------------------------------------------------------------- against the JAX store
def test_store_equals_the_jax_store_on_a_scripted_sequence(registry, arena_global):
    port, jax_store = ArenaStore(anchor_period=3), jarena.ArenaStore(anchor_period=3)
    players, batches = _script(np.random.default_rng(0))
    _same_store(port, jax_store, players)
    for recs in batches:
        assert port.report_batch(recs) == jax_store.report_batch(recs)
        _same_store(port, jax_store, players)
    assert port.duplicates_total > 0
    # the scheduler driven by its own assignments, reported in both
    for _ in range(6):
        a = port.next_match(players, episodes=3)
        assert a == jax_store.next_match(players, episodes=3)
        recs = _recs(a["home"], a["away"], a["round"], ["home", "draw", "away"])
        assert port.report_batch(recs) == jax_store.report_batch(recs)
    _same_store(port, jax_store, players)
    # the same gauges, with the same values
    names = {"distar_arena_rating_elo", "distar_arena_rating_trueskill", "distar_arena_matches_applied",
             "distar_arena_duplicates", "distar_arena_pairs", "distar_arena_main_rating",
             "distar_arena_main_rating_inverted"}
    scrape = [{k: v for k, v in reg.snapshot().items() if k.split("{")[0] in names}
              for reg in (registry, jobs.get_registry())]
    assert len(scrape[0]) > 7 and scrape[0] == scrape[1]


def test_store_loads_a_ledger_the_jax_store_wrote(registry, arena_global, tmp_path):
    jax_store = jarena.ArenaStore(path=str(tmp_path / "arena.journal"))
    players, batches = _script(np.random.default_rng(1))
    for recs in batches:
        jax_store.report_batch(recs)
    jax_store.save()
    port = ArenaStore(path=str(tmp_path / "arena.journal"))
    assert port.maybe_load()
    assert type(port.elo).__module__ == "distar_tpu_torch.league.elo"
    assert all(type(p).__module__ == "distar_tpu_torch.league.payoff" for p in port.payoffs.values())
    _same_store(port, jax_store, players)
    # idempotency survives the crossing: the seen-key set came along
    assert port.report_batch(batches[0]) == {"applied": 0, "duplicates": len(batches[0])}
    jax_store.report_batch(batches[0])
    more = _recs("main:300", "idle", 7, ["home", "home", "away"])
    assert port.report_batch(more) == jax_store.report_batch(more)
    _same_store(port, jax_store, players)
    # and the port's own journal round-trips
    port.save(str(tmp_path / "port.journal"))
    again = ArenaStore(path=str(tmp_path / "port.journal"))
    assert again.maybe_load()
    assert again.ratings_snapshot() == port.ratings_snapshot()


# ---------------------------------------------------------- against the JAX evaluator
def _flax_weights(seed):
    model = Model(deep_merge_dicts(default_model_config(), SMALL_MODEL))
    init_params(model, seed)
    return model, params_to_flax(model)


def test_evaluator_matches_the_jax_evaluator_on_jax_scenarios(registry, arena_global, tmp_path, monkeypatch):
    scn = dict(FIGHT, episode_len=16)
    jscn, pscn = J.ScenarioConfig(**scn), P.ScenarioConfig(**scn)
    model, flax = _flax_weights(3)
    ckpt_dir = str(tmp_path / "ckpt")
    os.makedirs(ckpt_dir)
    path = os.path.join(ckpt_dir, "gen_100.ckpt")
    jckpt.save_checkpoint(path, flax)
    jckpt.CheckpointManager(ckpt_dir).record(path, step=100)

    seen = []

    def jax_scenarios(seed, episodes, scenario_cfg, device):
        keys = jax.random.split(jax.random.PRNGKey(seed), episodes)
        seen.append(seed)
        return Scenario.from_numpy(jax.tree.map(np.asarray, jax.vmap(J.ScenarioGenerator(jscn).generate)(keys)),
                                   device=device)

    real_h2h = pevaluator.head_to_head

    class Fed:
        """A model player fed the Gumbel draws JAX's head_to_head derives
        for its seat at each step."""

        def __init__(self, policy, keys, seat):
            self.policy, self.keys, self.seat, self.t = policy, keys, seat, 0

        def init_carry(self, batch, device=None):
            return self.policy.init_carry(batch, device)

        def __call__(self, obs, carry, generator=None):
            k = jax.random.split(self.keys[self.t])[self.seat]
            self.t += 1
            return self.policy(obs, carry, noise=jax_gumbel_noise(k, model.cfg, obs["entity_num"].shape[0]))

    def fed_h2h(a, b, seed=0, scenarios=None, **kw):
        keys = jax.random.split(jax.random.PRNGKey(seed), scenarios.batch_size)
        steps = jax.random.split(jax.random.fold_in(keys[0], 0x5eed), kw["scenario_cfg"].episode_len)
        a, b = (Fed(p, steps, seat) if isinstance(p, P.ModelPolicy) else p for seat, p in enumerate((a, b)))
        return real_h2h(a, b, seed=seed, scenarios=scenarios, **kw)

    monkeypatch.setattr(pevaluator, "assignment_scenarios", jax_scenarios)
    monkeypatch.setattr(pevaluator, "head_to_head", fed_h2h)
    kw = dict(store=None, episodes=4, roles=("",))
    port = ArenaEvaluator(ckpt_dir, SMALL_MODEL, env_cfg=TINY_ENV, scenario_cfg=pscn, device="cpu",
                          **{**kw, "store": ArenaStore()})
    jax_ev = jarena.ArenaEvaluator(ckpt_dir, SMALL_MODEL, env_cfg=J.EnvConfig(units_per_squad=2),
                                   scenario_cfg=jscn, **{**kw, "store": jarena.ArenaStore()})
    played = []
    for _ in range(3):
        got, want = port.evaluate_once(), jax_ev.evaluate_once()
        assert got["assignment"] == want["assignment"]
        assert [(m["winner"], m["game_steps"]) for m in got["result"]["matches"]] == \
            [(m["winner"], int(m["game_steps"])) for m in want["result"]["matches"]]
        assert got["ack"] == want["ack"]
        played.append((got["assignment"]["home"], got["assignment"]["away"]))
    assert "main:100" in {p for pair in played for p in pair}  # the model played
    assert len(seen) == 3
    assert port.store.ratings_snapshot() == jax_ev.store.ratings_snapshot()
    art, jart = port.artifact(), jax_ev.artifact()
    assert set(art) == set(jart) and art["device"] == "cpu"
    assert [{k: v for k, v in e.items() if k != "duration_s"} for e in art["ledger"]] == \
        [{k: v for k, v in e.items() if k != "duration_s"} for e in jart["ledger"]]


def test_skill_block_matches_jax():
    ratings = {"players": {"main:100": {"elo": 990.0, "anchor": False, "games": 4},
                           "main:200": {"elo": 1010.0, "anchor": False, "games": 6},
                           "idle": {"elo": 950.0, "anchor": True}, "attack_nearest": {"elo": 1050.0,
                                                                                      "anchor": True}}}
    from distar_tpu.arena.evaluator import _skill_block as jax_skill_block

    assert pevaluator._skill_block(ratings) == jax_skill_block(ratings)
    assert pevaluator._skill_block(ratings)["anchor_relative"] == 10.0
    assert pevaluator._skill_block({"players": {}}) is None


# ------------------------------------------------------------ ladder closed forms
def test_wilson_interval_closed_form():
    # no data -> the uninformative full interval
    assert wilson_interval(0, 0, 0) == (0.0, 1.0)
    z, n, p = 1.96, 10.0, 0.8
    denom = 1 + z * z / n
    center = (p + z * z / (2 * n)) / denom
    half = z * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / denom
    lo, hi = wilson_interval(8, 0, 2)
    assert lo == pytest.approx(center - half)
    assert hi == pytest.approx(center + half)
    # draws count half a win: 4W/4D/2L has the same p-hat as 6W/4L
    assert wilson_interval(4, 4, 2) == wilson_interval(6, 0, 4)
    lo, hi = wilson_interval(3, 0, 0)
    assert 0.0 <= lo < 1.0 and hi == 1.0
    assert wilson_interval(7, 2, 3) == jarena.wilson_interval(7, 2, 3)


def test_elo_first_game_closed_form():
    elo = ELORating()
    elo.update("a", "b", WIN)
    r = elo.ratings(start_from_zero=False)
    assert r["a"] == pytest.approx(1022.0)
    assert r["b"] == pytest.approx(978.0)


def test_elo_refit_counts_draws_as_half():
    elo = ELORating()
    for _ in range(50):
        elo.update("a", "b", WIN)
    for _ in range(50):
        elo.update("a", "b", DRAW)
    refit = elo.refit()
    gap = refit["a"] - refit["b"]
    expected = 1.0 / (1.0 + 10 ** (-gap / 400.0))
    assert expected == pytest.approx(0.75, abs=1e-3)
    assert gap == pytest.approx(400.0 * math.log10(3.0), abs=1.0)


def test_payoff_prior_below_min_games():
    p = Payoff(min_win_rate_games=5)
    for _ in range(4):
        p.update("opp", {"winrate": 1.0})
    assert p.win_rate_opponent("opp") == 0.5
    assert p.win_rate_opponent("opp", use_prior=False) == 1.0
    p.update("opp", {"winrate": 1.0})
    assert p.win_rate_opponent("opp") == 1.0


def test_payoff_decay_closed_form():
    d, n = 0.9, 10
    p = Payoff(decay=d)
    assert p.decayed_win_rate("opp") == 0.5
    for _ in range(n):
        p.update("opp", {"winrate": 1.0})
    expected_games = (1 - d ** n) / (1 - d)
    assert p._decayed["opp"]["games"] == pytest.approx(expected_games)
    assert p.decayed_win_rate("opp") == pytest.approx(1.0)
    p.update("opp", {"winrate": 0.0})
    games = expected_games * d + 1.0
    wins = expected_games * d
    assert p.decayed_win_rate("opp") == pytest.approx(wins / games)
    assert p.decayed_win_rate("opp") < 1.0


# ----------------------------------------------------------------- match identity
def test_match_key_and_seed_determinism():
    assert match_key("a", "b", 3, 1) == "a|b|r3e1"
    assert match_seed("a", "b", 0) == match_seed("b", "a", 0)
    assert match_seed("a", "b", 0) != match_seed("a", "b", 1)
    assert match_seed("main:1", "idle", 4) == jarena.match_seed("main:1", "idle", 4)


# --------------------------------------------------------------------- scheduling
def test_scheduler_is_pure_in_reported_state(registry):
    store = ArenaStore()
    players = ["main:2", "main:1"]
    first = store.next_match(players, episodes=4)
    assert store.next_match(players, episodes=4) == first
    assert store.next_match(players, episodes=4) == first
    assert {first["home"], first["away"]} == {"main:2", ANCHORS[0]}
    assert first["round"] == 0
    assert first["seed"] == match_seed(first["home"], first["away"], 0)


def test_scheduler_widest_ci_and_anchor_floor(registry):
    store = ArenaStore(anchor_period=4)
    players = ["main:1"]

    def play(a, winner="home", episodes=4):
        return store.report_batch(_recs(a["home"], a["away"], a["round"], [winner] * episodes))

    a0 = store.next_match(players)
    assert {a0["home"], a0["away"]} == {"main:1", "attack_nearest"}
    assert play(a0) == {"applied": 4, "duplicates": 0}
    a1 = store.next_match(players)
    assert {a1["home"], a1["away"]} == {"attack_nearest", "idle"}
    play(a1)
    a2 = store.next_match(players)
    assert {a2["home"], a2["away"]} == {"idle", "main:1"}
    play(a2)
    store.report_batch(_recs("idle", "main:1", 9, ["draw"] * 4))
    a3 = store.next_match(players)
    assert {a3["home"], a3["away"]} == {"idle", "main:1"}
    assert a3["round"] == 10


def test_report_batch_dedups_by_key(registry):
    store = ArenaStore()
    recs = _recs("a", "b", 0, ["home"] * 3, steps=5)
    assert store.report_batch(recs) == {"applied": 3, "duplicates": 0}
    assert store.report_batch(recs) == {"applied": 0, "duplicates": 3}
    assert store.matches_total == 3
    assert store.duplicates_total == 3
    assert store.ratings_snapshot()["players"]["a"]["games"] == 3
    assert store.elo.game_count == 3


def test_store_durability_roundtrip(registry, tmp_path):
    path = str(tmp_path / "arena.journal")
    store = ArenaStore(path=path)
    recs = _recs("a", "b", 0, ["draw", "home", "home", "home"], steps=7)
    store.report_batch(recs)
    store.save()
    fresh = ArenaStore(path=path)
    assert fresh.maybe_load()
    assert fresh.ratings_snapshot() == store.ratings_snapshot()
    assert fresh.payoff_snapshot() == store.payoff_snapshot()
    assert fresh.report_batch(recs) == {"applied": 0, "duplicates": 4}
    assert fresh.next_match(["a", "b"]) == store.next_match(["a", "b"])
    assert not ArenaStore(path=str(tmp_path / "absent")).maybe_load()


def test_store_autosave_journals_on_its_thread(registry, tmp_path):
    path = str(tmp_path / "auto.journal")
    store = ArenaStore()
    store.report_batch(_recs("a", "b", 0, ["home"]))
    assert store.start_autosave(path, interval_s=0.05) == path
    try:
        deadline = time.monotonic() + 10.0
        while not os.path.exists(path) and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        store.stop_autosave()
    assert os.path.exists(path)
    fresh = ArenaStore(path=path)
    assert fresh.maybe_load() and fresh.matches_total == 1
    assert registry.counter("distar_arena_autosaves_total", "arena journals written").value >= 1


def test_pfsp_preview_matches_hand_computed_variance_weights(registry):
    store = ArenaStore(anchors=())
    for i in range(4):  # A beats B 3-1
        store.report_batch(_recs("A", "B", i, ["home" if i else "away"], steps=5))
    for i in range(2):  # A draws C twice
        store.report_batch(_recs("A", "C", i, ["draw"], steps=5))
    snap = store.payoff_snapshot()
    pv = snap["pfsp_preview"]
    wb, wc = 0.75 * 0.25, 0.5 * 0.5
    assert pv["A"]["B"] == pytest.approx(wb / (wb + wc))
    assert pv["A"]["C"] == pytest.approx(wc / (wb + wc))
    wa, wc = 0.25 * 0.75, 0.5 * 0.5
    assert pv["B"]["A"] == pytest.approx(wa / (wa + wc))
    assert pv["B"]["C"] == pytest.approx(wc / (wa + wc))
    assert snap["pfsp_weighting"] == "variance"
    for row in pv.values():
        assert sum(row.values()) == pytest.approx(1.0)


# ------------------------------------------------------- head_to_head match stats
def test_default_rulebook_carries_arena_rules():
    rules = {r.name: r for r in pobs.default_rulebook()}
    reg = rules["arena_rating_regression"]
    assert reg.metric == "distar_arena_main_rating_inverted"
    assert reg.op == "trending_up"
    stall = rules["arena_match_stall"]
    assert stall.metric == "distar_arena_matches_applied"
    assert stall.op == "stalled"
    assert vars(reg) == vars({r.name: r for r in jobs.default_rulebook()}["arena_rating_regression"])


def test_head_to_head_reports_per_match_stats(registry):
    res = P.head_to_head(P.attack_nearest_policy(), P.idle_policy(), episodes=4, seed=3, env_cfg=TINY_ENV,
                         scenario_cfg=TINY_SCN, device="cpu")
    assert len(res["matches"]) == 4
    counts = {"home": 0, "away": 0, "draw": 0}
    for m in res["matches"]:
        counts[m["winner"]] += 1
        assert m["draw"] == (m["winner"] == "draw")
        assert 0 < m["game_steps"] <= TINY_SCN.episode_len
    assert counts["home"] == res["wins"]
    assert counts["away"] == res["losses"]
    assert counts["draw"] == res["draws"]
    assert res["mean_game_steps"] == pytest.approx(np.mean([m["game_steps"] for m in res["matches"]]))
    assert res["duration_s"] > 0.0


# ------------------------------------------------------- chaos drill in-process twin
def test_evaluator_kill_restart_twin(registry, tmp_path):
    """An evaluator that dies mid-batch loses nothing: the restarted one
    re-receives the identical assignment, and a replayed ack dedups."""
    store = ArenaStore(path=str(tmp_path / "journal"))
    ckpt = str(tmp_path / "ckpt")  # empty -> anchors-only roster
    os.makedirs(ckpt)

    def make_eval():
        return ArenaEvaluator(ckpt, model_cfg={}, store=store, episodes=3, env_cfg=TINY_ENV,
                              scenario_cfg=TINY_SCN, device="cpu")

    ev1 = make_eval()
    first = ev1.evaluate_once()
    assert first["ack"] == {"applied": 3, "duplicates": 0}
    doomed = store.next_match(ev1.refresh_roster(), episodes=3)
    assert store.matches_total == 3
    ev2 = make_eval()
    second = ev2.evaluate_once()
    assert second["assignment"] == doomed
    assert second["ack"] == {"applied": 3, "duplicates": 0}
    assert store.matches_total == 6
    assert store.duplicates_total == 0
    replay = _recs(doomed["home"], doomed["away"], doomed["round"], ["draw"] * 3, steps=1)
    assert store.report_batch(replay) == {"applied": 0, "duplicates": 3}
    assert store.matches_total == 6
    # the same assignment replays the same episodes
    again = make_eval()
    store2 = ArenaStore()
    again.store = store2
    assert again.evaluate_once()["result"]["matches"] == first["result"]["matches"]


def test_evaluator_needs_exactly_one_plane(tmp_path):
    with pytest.raises(ValueError, match="exactly one"):
        ArenaEvaluator(str(tmp_path), {}, device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        ArenaEvaluator(str(tmp_path), {}, store=ArenaStore(), coordinator_addr=("h", 1), device="cpu")
    with pytest.raises(KeyError, match="unknown arena anchor"):
        parena.anchor_policy("nobody")


# ------------------------------------------------------------------ e2e acceptance
def _save_generations(ckpt_dir, model, steps):
    mgr = CheckpointManager(ckpt_dir)
    base = {k: v.clone() for k, v in model.state_dict().items()}
    for g, step in enumerate(steps):
        model.load_state_dict({k: v + 0.01 * g if v.is_floating_point() else v for k, v in base.items()})
        path = os.path.join(ckpt_dir, f"gen_{step}.ckpt")
        save_checkpoint(path, params_to_flax(model))
        mgr.record(path, step=step)


def test_arena_e2e_generations_vs_anchors(registry, arena_global, tmp_path, capsys):
    """Three toy checkpoint generations + two scripted anchors play a
    scheduled arena on the port's jaxenv; attack_nearest out-rates idle
    with confidence; the matrix is non-trivial; ratings survive a
    coordinator restart; GET /arena/ratings and /arena/payoff serve them
    over a real CoordinatorServer, and ``opsctl arena`` renders the
    scoreboard from the TSDB series the port's fleet health sampled."""
    from distar_tpu_torch.comm.coordinator import CoordinatorServer

    fh = pobs.FleetHealth(rules=pobs.default_rulebook(), registry=registry)
    prev_fh = pobs.set_fleet_health(fh)

    journal = str(tmp_path / "arena.journal")
    ckpt_dir = str(tmp_path / "ckpt")
    os.makedirs(ckpt_dir)
    store = ArenaStore(path=journal)
    set_arena_store(store)
    srv = CoordinatorServer()
    srv.start()
    try:
        ev_a = ArenaEvaluator(ckpt_dir, model_cfg=SMALL_MODEL, store=store, episodes=16, env_cfg=TINY_ENV,
                              scenario_cfg=FIGHT_SCN, device="cpu")
        for _ in range(3):
            out = ev_a.evaluate_once()
            assert {out["assignment"]["home"], out["assignment"]["away"]} == set(ANCHORS)
            assert out["ack"]["duplicates"] == 0
        model, _ = _flax_weights(1)
        _save_generations(ckpt_dir, model, steps=(100, 200, 300))
        ev_b = ArenaEvaluator(ckpt_dir, model_cfg=SMALL_MODEL, store=store, episodes=4, env_cfg=TINY_ENV,
                              scenario_cfg=FIGHT_SCN, device="cpu")
        played = []
        for _ in range(4):
            out = ev_b.evaluate_once()
            played.append((out["assignment"]["home"], out["assignment"]["away"]))
            assert out["ack"]["duplicates"] == 0
        met = {p for pair in played for p in pair}
        assert {"main:100", "main:200", "main:300"} <= met

        assert store.matches_total == 3 * 16 + 4 * 4
        assert store.duplicates_total == 0
        ratings = store.ratings_snapshot()
        atk, idl = ratings["players"]["attack_nearest"], ratings["players"]["idle"]
        assert atk["elo"] > idl["elo"]
        assert atk["trueskill_exposed"] > idl["trueskill_exposed"]
        payoff = store.payoff_snapshot()
        cell = next(c for c in payoff["cells"] if {c["a"], c["b"]} == set(ANCHORS))
        assert cell["games"] == 48
        atk_low = cell["wilson_low"] if cell["a"] == "attack_nearest" else 1.0 - cell["wilson_high"]
        assert atk_low > 0.5
        assert sum(1 for c in payoff["cells"] if c["games"]) >= 4

        store.save()
        fresh = ArenaStore(path=journal)
        assert fresh.maybe_load()
        assert fresh.ratings_snapshot() == ratings
        assert fresh.payoff_snapshot() == payoff

        def get(route):
            with urllib.request.urlopen(f"http://{srv.host}:{srv.port}{route}", timeout=10) as r:
                return json.loads(r.read().decode())

        assert get("/arena/ratings") == ratings
        served = get("/arena/payoff")
        assert served == payoff
        wrs, opps = [], []
        for c in served["cells"]:
            if "attack_nearest" in (c["a"], c["b"]):
                wr = c["win_rate"] if c["a"] == "attack_nearest" else 1.0 - c["win_rate"]
                opps.append(c["b"] if c["a"] == "attack_nearest" else c["a"])
                wrs.append(wr)
        raw = [w * (1.0 - w) for w in wrs]
        for opp, r in zip(opps, raw):
            assert served["pfsp_preview"]["attack_nearest"][opp] == pytest.approx(r / sum(raw))
        art = ev_b.artifact(ratings=ratings)
        assert art["arena"]["player"] == "main:300" and art["batches"] == 4
        assert registry.counter("distar_arena_eval_batches_total", "").value == 3 + 4

        # the scoreboard from TSDB series: sample the registry into the fleet
        # store (what the coordinator's sampler thread does), then render it
        # with the JAX package's opsctl against the port's server
        fh.sampler.sample_once()
        fh.sampler.sample_once()
        sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
        try:
            import opsctl
        finally:
            sys.path.pop(0)
        capsys.readouterr()
        assert opsctl.cmd_arena(Namespace(addr=f"{srv.host}:{srv.port}", window=600.0, json=False)) == 0
        out = capsys.readouterr().out
        assert "attack_nearest" in out and "idle" in out
        assert "rating trajectories (TSDB):" in out
        assert "pfsp preview" in out
        opsctl._print_arena_digest(f"{srv.host}:{srv.port}")
        assert "arena: 64 matches" in capsys.readouterr().out
    finally:
        srv.stop()
        set_arena_store(None)
        pobs.set_fleet_health(prev_fh)
        fh.stop()
