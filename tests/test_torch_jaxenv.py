"""The port's micro-battle world (``distar_tpu_torch.envs.jaxenv``) against
the JAX package's, on the CPU.

Scenarios are made by the JAX package (threefry functions of a key, which a
``torch.Generator`` cannot reproduce) and fed to both worlds through
``Scenario.from_numpy``; actions are drawn with numpy from a seed, in the
real action layout, junk included (out-of-range slots, end tokens, action
types past the vocabulary). Tolerances, stated per check:

* the semantic LUT, the micro legal mask, ``reset``, integer and bool state
  leaves, rewards, ``done``, ``winner`` and every observation leaf: exact;
* float state leaves within FLOAT_TOL = 1e-5 absolute (measured: every
  float leaf bit-equal at every step, held by ``test_float_leaves_are_bit_equal``);
* the scripted head-to-heads: winners and game steps exact (the model
  policy, with JAX's Gumbel draws handed in, is held in
  tests/test_torch_anakin.py beside the Anakin windows it shares weights
  with).
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distar_tpu.envs import jaxenv as J
from distar_tpu_torch.envs import jaxenv as P
from distar_tpu_torch.envs.jaxenv import core as pcore
from distar_tpu_torch.envs.jaxenv.scenario import Scenario
from distar_tpu_torch.lib import actions as ACT
from distar_tpu_torch.lib import features as F

torch.set_num_threads(1)

FLOAT_TOL = 1e-5
LANES, STEPS = 8, 32
FLOAT_LEAVES = ("pos", "health", "max_health", "cooldown", "order_pos", "dmg_dealt", "kills")
# (units per squad, scenario knobs): the launcher's jaxenv defaults (4 units,
# 32 steps) and the JAX package's default squad of 8 with walls
CONFIGS = {
    "u4": (4, dict(max_units=4, episode_len=STEPS)),
    "u8": (8, dict(episode_len=STEPS, spawn_margin=40.0)),
}


def cfgs(name):
    u, kw = CONFIGS[name]
    return (J.EnvConfig(units_per_squad=u), J.ScenarioConfig(units_per_squad=u, **kw),
            P.EnvConfig(units_per_squad=u), P.ScenarioConfig(units_per_squad=u, **kw))


def jax_scenarios(scn_cfg, key, n):
    return J.ScenarioGenerator(scn_cfg).batch(key, n)


def to_port(jscn):
    return Scenario.from_numpy(jax.tree.map(np.asarray, jscn))


def random_actions(rng, B, N):
    """Seeded actions in the contract layout: half the action types from the
    micro vocabulary, half from anywhere (a few past its ends); pointer
    slots, targets and locations partly out of range."""
    micro = np.asarray(pcore.MICRO_ACTION_TYPES)
    at = np.where(rng.random(B) < 0.5, micro[rng.integers(0, len(micro), B)],
                  rng.integers(-2, ACT.NUM_ACTIONS + 2, B))
    action = {
        "action_type": at,
        "delay": rng.integers(0, 128, B),
        "queued": rng.integers(0, 2, B),
        "selected_units": rng.integers(-1, N + 2, (B, F.MAX_SELECTED_UNITS_NUM)),
        "target_unit": rng.integers(-1, N + 2, B),
        "target_location": rng.integers(-5, F.SPATIAL_SIZE[0] * F.SPATIAL_SIZE[1] + 5, B),
    }
    sun = rng.integers(0, N + 3, B)
    return {k: v.astype(np.int32) for k, v in action.items()}, sun.astype(np.int32)


def port_action(action):
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in action.items()}


def state_mismatches(jstate, pstate):
    """Leaf names of an EnvState where the two worlds differ: exact for
    integer and bool leaves, FLOAT_TOL for float ones."""
    bad = []
    for f in pstate._fields:
        if f == "scenario":
            continue
        a, b = np.asarray(getattr(jstate, f)), getattr(pstate, f).numpy()
        if a.dtype != b.dtype or a.shape != b.shape:
            bad.append((f, "dtype/shape", a.dtype, b.dtype))
        elif f in FLOAT_LEAVES:
            if not np.allclose(a, b, rtol=0.0, atol=FLOAT_TOL):
                bad.append((f, float(np.abs(a - b).max())))
        elif not np.array_equal(a, b):
            bad.append((f, "differs"))
    return bad


def obs_mismatches(jobs, pobs):
    """Observation leaves that differ in value, shape or dtype (entity_num:
    int32 on the JAX device, the contract's int64 in the port)."""
    bad = []
    for section in ("spatial_info", "scalar_info", "entity_info"):
        for k, v in jobs[section].items():
            a, b = np.asarray(v), pobs[section][k].numpy()
            if a.dtype != b.dtype or a.shape != b.shape or not np.array_equal(a, b):
                bad.append(f"{section}/{k}")
    if not np.array_equal(np.asarray(jobs["entity_num"]), pobs["entity_num"].numpy()):
        bad.append("entity_num")
    return bad


# ------------------------------------------------------------------- LUTs
def test_action_semantics_and_micro_mask_match_jax():
    np.testing.assert_array_equal(pcore.ACTION_SEMANTIC, J.core.ACTION_SEMANTIC)
    np.testing.assert_array_equal(pcore._SEM_TO_KIND, J.core._SEM_TO_KIND)
    np.testing.assert_array_equal(P.micro_legal_mask(), J.micro_legal_mask())
    assert (pcore.WINNER_NONE, pcore.WINNER_HOME, pcore.WINNER_AWAY, pcore.WINNER_DRAW) == (
        J.core.WINNER_NONE, J.core.WINNER_HOME, J.core.WINNER_AWAY, J.core.WINNER_DRAW)
    from distar_tpu.envs.jaxenv import scenario as jscn
    from distar_tpu_torch.envs.jaxenv import scenario as pscn

    for name in ("CATALOG_DENSE_TYPES", "CATALOG_HEALTH", "CATALOG_DAMAGE", "CATALOG_RANGE",
                 "CATALOG_SPEED", "CATALOG_COOLDOWN"):
        np.testing.assert_array_equal(getattr(pscn, name), getattr(jscn, name), err_msg=name)
    assert (pscn.MAP_H, pscn.MAP_W, pscn.CELL, pscn.GRID_H, pscn.GRID_W) == (
        jscn.MAP_H, jscn.MAP_W, jscn.CELL, jscn.GRID_H, jscn.GRID_W)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reset_matches_jax_leaf_by_leaf(name):
    jec, jsc, pec, _ = cfgs(name)
    jscn = jax_scenarios(jsc, jax.random.PRNGKey(11), LANES)
    jstate = jax.vmap(partial(J.reset, jec))(jscn)
    pstate = P.reset(pec, to_port(jscn))
    assert state_mismatches(jstate, pstate) == []
    for f in P.Scenario._fields:
        np.testing.assert_array_equal(getattr(pstate.scenario, f).numpy(), np.asarray(getattr(jscn, f)))


# ---------------------------------------------------------------- episodes
@pytest.fixture(scope="module")
def episodes():
    """32 steps on 8 lanes in both worlds per config and away mode (the
    scripted opponent, or seeded explicit actions), compared at every step:
    returns {(config, mode): [per-step problem lists]} and the float leaves'
    largest difference."""
    out, float_diff, finished = {}, {}, {}
    for name in sorted(CONFIGS):
        jec, jsc, pec, _ = cfgs(name)
        N = jec.num_units
        jscn = jax_scenarios(jsc, jax.random.PRNGKey(23), LANES)
        jstep_scripted = jax.jit(jax.vmap(partial(J.step, jec)))
        jstep_explicit = jax.jit(jax.vmap(partial(J.step, jec)))
        jobserve = jax.jit(jax.vmap(partial(J.observe, jec), in_axes=(0, None)), static_argnums=1)
        for mode in ("scripted", "explicit"):
            rng = np.random.default_rng(7 if mode == "scripted" else 8)
            js = jax.vmap(partial(J.reset, jec))(jscn)
            ps = P.reset(pec, to_port(jscn))
            problems, fd = [], 0.0
            for t in range(STEPS):
                a_home, sun_home = random_actions(rng, LANES, N)
                if mode == "scripted":
                    js, jrew, jdone, jwin = jstep_scripted(js, a_home, sun_home)
                    ps, prew, pdone, pwin = P.step(pec, ps, port_action(a_home), torch.from_numpy(sun_home))
                else:
                    a_away, sun_away = random_actions(rng, LANES, N)
                    js, jrew, jdone, jwin = jstep_explicit(js, a_home, sun_home, a_away, sun_away)
                    ps, prew, pdone, pwin = P.step(pec, ps, port_action(a_home), torch.from_numpy(sun_home),
                                                   port_action(a_away), torch.from_numpy(sun_away))
                bad = state_mismatches(js, ps)
                for k in ("battle", "winloss"):
                    if not np.array_equal(np.asarray(jrew[k]), prew[k].numpy()):
                        bad.append(f"reward/{k}")
                if not np.array_equal(np.asarray(jdone), pdone.numpy()):
                    bad.append("done")
                if not np.array_equal(np.asarray(jwin), pwin.numpy()):
                    bad.append("winner")
                for team in (0, 1):
                    bad += [f"team {team} obs {leaf}"
                            for leaf in obs_mismatches(jobserve(js, team), P.observe(pec, ps, team))]
                if bad:
                    problems.append((t, bad))
                fd = max([fd] + [float(np.abs(np.asarray(getattr(js, f)) - getattr(ps, f).numpy()).max())
                                 for f in FLOAT_LEAVES])
            out[(name, mode)] = problems
            float_diff[(name, mode)] = fd
            finished[(name, mode)] = int(ps.done.sum())
    return out, float_diff, finished


@pytest.mark.parametrize("mode", ["scripted", "explicit"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_episode_matches_jax_at_every_step(episodes, name, mode):
    """State (ints and bools exact, floats within FLOAT_TOL), rewards, done,
    winner and both teams' observations, every step of 32 on 8 lanes."""
    problems, _, finished = episodes
    assert problems[(name, mode)] == []
    assert finished[(name, mode)] > 0  # episodes end inside the 32 steps (timeout included)


def test_float_leaves_are_bit_equal(episodes):
    """The measurement behind FLOAT_TOL: positions, health, cooldowns,
    orders, damage and kills come out bit-equal to JAX's (the same f32
    operations in the same order; damage sums are of whole numbers)."""
    _, float_diff, _ = episodes
    assert all(d == 0.0 for d in float_diff.values()), float_diff


# ------------------------------------------------------------- host env
def test_host_env_round_trip_matches_jax():
    """Both host envs on one pinned JAX-made scenario, both agents acting
    (an attack order, then seeded random actions): observations (the
    contract's host dtypes, entity_num int64), rewards, done and info
    equal at every step."""
    jec, jsc, pec, psc = cfgs("u4")
    key = jax.random.PRNGKey(3)
    jscn = J.ScenarioGenerator(jsc).generate(key)
    jenv = J.JaxMicroBattleEnv(jec, jsc, scenario=jscn)
    penv = P.JaxMicroBattleEnv(pec, psc, scenario=to_port(jax.tree.map(lambda x: x[None], jscn)),
                               device="cpu")
    rng = np.random.default_rng(5)

    def same_obs(jo, po):
        for agent in (0, 1):
            for section in ("spatial_info", "scalar_info", "entity_info"):
                for k, v in jo[agent][section].items():
                    w = po[agent][section][k]
                    assert v.dtype == w.dtype and np.array_equal(v, w), (agent, section, k)
            assert po[agent]["entity_num"].dtype == np.int64
            for k in ("entity_num", "game_loop", "action_result", "battle_score", "opponent_battle_score"):
                assert np.array_equal(jo[agent][k], po[agent][k]), (agent, k)

    jo, po = jenv.reset(), penv.reset()
    same_obs(jo, po)
    n0 = int(po[0]["entity_num"])
    su = np.zeros(F.MAX_SELECTED_UNITS_NUM, np.int64)
    su[1] = n0  # one unit, then the end token
    attack = {"action_type": np.asarray(3), "delay": np.asarray(1), "queued": np.asarray(0),
              "selected_units": su, "target_unit": np.asarray(max(n0 - 1, 0)),
              "target_location": np.asarray(0)}
    done = False
    for t in range(jsc.episode_len):
        if t < 4:
            actions = {0: attack}
        else:
            a, sun = random_actions(rng, 2, jec.num_units)
            actions = {i: {k: v[i] for k, v in a.items()} for i in (0, 1)}
            actions[1]["selected_units_num"] = sun[1]
        jo, jr, jd, ji = jenv.step(actions)
        po, pr, pd, pi = penv.step(actions)
        same_obs(jo, po)
        assert (jr, jd, ji) == (pr, pd, pi)
        done = pd
        if done:
            break
    assert done
    assert pr[0] == -pr[1]


def test_host_observation_contract_leaf_by_leaf():
    """The port's host env gives the contract's keys, shapes and dtypes
    (``fake_step_data``), entity_num int64, and MockEnv's aux keys."""
    env = P.JaxMicroBattleEnv(P.EnvConfig(units_per_squad=2), P.ScenarioConfig(units_per_squad=2, max_units=2),
                              seed=1, device="cpu")
    obs = env.reset()
    ref = F.fake_step_data(rng=np.random.default_rng(0))
    for agent in (0, 1):
        for section in ("spatial_info", "scalar_info", "entity_info"):
            assert sorted(obs[agent][section]) == sorted(ref[section])
            for k, rv in ref[section].items():
                v = obs[agent][section][k]
                assert (v.shape, v.dtype) == (rv.shape, rv.dtype), (section, k)
        assert obs[agent]["entity_num"].dtype == np.int64 and int(obs[agent]["entity_num"]) >= 1
        for k in ("game_loop", "action_result", "battle_score", "opponent_battle_score"):
            assert k in obs[agent]


def test_episode_digest_matches_jax():
    """``episode_digest`` hashes the same bytes in the same order: on the
    scenario the JAX digest draws from its seed, both give one sha256."""
    seed, units, steps = 17, 2, 24
    jsc = J.ScenarioConfig(units_per_squad=units, min_units=1, max_units=units, episode_len=steps,
                           spawn_margin=30.0, spawn_spread=6.0)
    psc = P.ScenarioConfig(units_per_squad=units, min_units=1, max_units=units, episode_len=steps,
                           spawn_margin=30.0, spawn_spread=6.0)
    want = J.episode_digest(seed=seed, env_cfg=J.EnvConfig(units_per_squad=units), scenario_cfg=jsc,
                            max_steps=steps)
    _, k = jax.random.split(jax.random.PRNGKey(seed))
    jscn = J.ScenarioGenerator(jsc).generate(k)
    got = P.episode_digest(env_cfg=P.EnvConfig(units_per_squad=units), scenario_cfg=psc, max_steps=steps,
                           scenario=to_port(jax.tree.map(lambda x: x[None], jscn)), device="cpu")
    assert got == want
    again = P.episode_digest(seed=4, env_cfg=P.EnvConfig(units_per_squad=units), scenario_cfg=psc,
                             max_steps=steps, device="cpu")
    assert again == P.episode_digest(seed=4, env_cfg=P.EnvConfig(units_per_squad=units), scenario_cfg=psc,
                                     max_steps=steps, device="cpu")


# ------------------------------------------------------------- scenarios
@pytest.mark.parametrize("mirror", [False, True])
def test_scenario_generator_draws_in_range(mirror):
    """The port's own draws (a torch.Generator, not threefry): in the JAX
    package's ranges, walls carved away from both spawns, and the same
    batch again from the same seed."""
    cfg = P.ScenarioConfig(units_per_squad=6, min_units=2, max_units=5, mirror_types=mirror,
                           mirror_spawns=not mirror, blocked_frac=0.5)
    gen = P.ScenarioGenerator(cfg)
    scn = gen.batch(64, torch.Generator().manual_seed(3))
    again = gen.batch(64, torch.Generator().manual_seed(3))
    assert all(torch.equal(a, b) for a, b in zip(scn, again))
    assert scn.pos_home.shape == (64, 6, 2) and scn.terrain.shape == (64, 19, 20)
    for n in (scn.n_home, scn.n_away):
        assert int(n.min()) >= 2 and int(n.max()) <= 5
    assert int(scn.type_home.max()) < 4 and int(scn.type_away.min()) >= 0
    for pos in (scn.pos_home, scn.pos_away):
        assert float(pos[..., 0].min()) >= 1.0 and float(pos[..., 0].max()) <= 159.0
        assert float(pos[..., 1].min()) >= 1.0 and float(pos[..., 1].max()) <= 151.0
    if mirror:
        assert torch.equal(scn.n_home, scn.n_away) and torch.equal(scn.type_home, scn.type_away)
    # every spawned unit stands on a passable cell
    state = P.reset(P.EnvConfig(units_per_squad=6), scn)
    cell = torch.div(state.pos, 8, rounding_mode="floor").long()
    ok = scn.terrain.reshape(64, -1).gather(1, cell[..., 1] * 20 + cell[..., 0])
    assert bool(ok[state.alive].all())
    assert 0.2 < float((~scn.terrain).float().mean()) < 0.5  # walls remain away from the spawns


# -------------------------------------------------------------- win rate
H2H_CFG = dict(units_per_squad=2, min_units=2, max_units=2, episode_len=160, spawn_margin=50.0,
               spawn_spread=4.0, mirror_types=True, blocked_frac=0.0)


@pytest.mark.parametrize("pair", ["attack-idle", "idle-attack", "attack-attack"])
def test_head_to_head_scripted_matches_jax(pair):
    """The scripted policies on the same JAX-made scenario set: every
    match's winner and game steps, and the summary, equal."""
    pol = {"attack": (J.attack_nearest_policy, P.attack_nearest_policy),
           "idle": (J.idle_policy, P.idle_policy)}
    a, b = pair.split("-")
    jsc, psc = J.ScenarioConfig(**H2H_CFG), P.ScenarioConfig(**H2H_CFG)
    keys = jax.random.split(jax.random.PRNGKey(5), 8)
    want = J.head_to_head(pol[a][0](), pol[b][0](), keys=keys, env_cfg=J.EnvConfig(units_per_squad=2),
                          scenario_cfg=jsc)
    got = P.head_to_head(pol[a][1](), pol[b][1](), scenarios=to_port(jax.vmap(J.ScenarioGenerator(jsc).generate)(keys)),
                         env_cfg=P.EnvConfig(units_per_squad=2), scenario_cfg=psc)
    for k in ("win_rate", "wins", "losses", "draws", "episodes", "matches", "mean_game_steps"):
        assert got[k] == want[k], k
    if pair == "attack-idle":
        assert got["win_rate"] > 0.5


def test_head_to_head_draws_its_own_scenarios_and_sets_the_gauge():
    from distar_tpu_torch.obs import get_registry

    kw = dict(episodes=6, seed=9, env_cfg=P.EnvConfig(units_per_squad=2),
              scenario_cfg=P.ScenarioConfig(**H2H_CFG), device="cpu")
    res = P.head_to_head(P.attack_nearest_policy(), P.idle_policy(), **kw)
    assert res["episodes"] == 6 and len(res["matches"]) == 6
    assert res["wins"] + res["losses"] + res["draws"] == 6 and res["duration_s"] >= 0.0
    again = P.head_to_head(P.attack_nearest_policy(), P.idle_policy(), **kw)
    assert {k: v for k, v in again.items() if k != "duration_s"} == {
        k: v for k, v in res.items() if k != "duration_s"}
    assert get_registry().snapshot()["distar_env_head2head_win_rate"] == res["win_rate"]


def test_fleet_compare_win_rate_verdict_from_port_episodes():
    """``FleetRollout.compare()``'s win-rate column from the port's
    ``head_to_head`` (the scripted policies as mock engines, the gateways'
    status patched), gating the promote verdict both ways."""
    from distar_tpu_torch.serve.fleet import FleetRollout, GatewayMap

    ctl = FleetRollout(GatewayMap(["127.0.0.1:9001", "127.0.0.1:9002"]), timeout_s=1.0)
    healthy = {"requests": {"ok": 10.0}, "shed_rate": 0.0, "latency_s": {"p99": 0.01},
               "sessions": {"num_slots": 4}}
    ctl.fleet_status = lambda: {"127.0.0.1:9001": dict(healthy), "127.0.0.1:9002": dict(healthy)}
    kw = dict(episodes=8, seed=5, env_cfg=P.EnvConfig(units_per_squad=2),
              scenario_cfg=P.ScenarioConfig(**H2H_CFG), device="cpu")
    good = ctl.compare(["127.0.0.1:9001"], min_win_rate=0.5,
                       win_rate_fn=lambda: P.head_to_head(P.attack_nearest_policy(), P.idle_policy(), **kw))
    assert good["win_rate"]["episodes"] == 8 and good["win_rate"]["win_rate"] > 0.5
    assert good["verdict"]["promote"] is True, good["verdict"]
    bad = ctl.compare(["127.0.0.1:9001"], min_win_rate=0.5,
                      win_rate_fn=lambda: P.head_to_head(P.idle_policy(), P.attack_nearest_policy(), **kw))
    assert bad["win_rate"]["win_rate"] < 0.5
    assert bad["verdict"]["promote"] is False
    assert any("win" in r for r in bad["verdict"]["reasons"]), bad["verdict"]
