"""The port's proto feature transforms (``distar_tpu_torch/envs/features.py``)
against the JAX package's, on the CPU.

* Counterparts of tests/test_proto_features.py on the port's modules.
* Parity: ``transform_obs`` (with and without the opponent's observation),
  ``born_locations``, ``transform_action``, ``reverse_raw_action``,
  ``extract_z``, ``compute_battle_score`` and ``unpack_feature_layer`` on
  ``build_parity_fixtures()`` (the JAX package's, and the port's, which must
  be the same inputs) and on observations captured from a seeded fake game
  (real s2api protos, which the two packages share): every array equal in
  value and dtype, every scalar equal in value and type.
"""
import numpy as np
import pytest

from distar_tpu.envs import dummy_obs as jax_dummy
from distar_tpu.envs import features as jax_features
from distar_tpu.envs.sc2.fake_sc2 import FakeGameCore as JaxFakeGameCore
from distar_tpu_torch.envs import dummy_obs
from distar_tpu_torch.envs import features as port_features
from distar_tpu_torch.envs.dummy_obs import (build_dummy_game_info, build_dummy_obs, make_effect,
                                             make_passenger, make_raw_action, make_unit)
from distar_tpu_torch.envs.features import Effects, ProtoFeatures, compute_battle_score
from distar_tpu_torch.envs.sc2.fake_sc2 import FakeGameCore
from distar_tpu_torch.lib import actions as ACT
from distar_tpu_torch.lib import features as F


@pytest.fixture
def feat():
    return ProtoFeatures(build_dummy_game_info())


DRONE = ACT.UNIT_TYPES[10]


# -------------------------------------------------------------- counterparts
def test_transform_obs_shapes_and_schema(feat):
    units = [make_unit(100 + i, DRONE, x=5 + i, y=7) for i in range(5)]
    out = feat.transform_obs(build_dummy_obs(units=units))
    assert int(out["entity_num"]) == 5
    for k in F.SPATIAL_INFO:
        want = (F.EFFECT_LENGTH,) if k.startswith("effect_") else F.SPATIAL_SIZE
        assert out["spatial_info"][k].shape == tuple(want), k
    for k in F.ENTITY_INFO:
        assert out["entity_info"][k].shape == (F.MAX_ENTITY_NUM,), k
    for k in F.SCALAR_INFO:
        assert k in out["scalar_info"], k


def test_unit_type_remap_and_y_flip(feat):
    out = feat.transform_obs(build_dummy_obs(units=[make_unit(1, DRONE, x=3, y=10)]))
    assert int(out["entity_info"]["unit_type"][0]) == 10
    assert int(out["entity_info"]["y"][0]) == 110
    assert int(out["entity_info"]["x"][0]) == 3
    assert out["entity_info"]["health_ratio"][0] == pytest.approx(0.5, abs=1e-3)


def test_bow_vectors_and_upgrades(feat):
    units = [make_unit(i, DRONE) for i in range(3)] + [make_unit(50, ACT.UNIT_TYPES[20], alliance=4)]
    out = feat.transform_obs(build_dummy_obs(units=units, upgrade_ids=[ACT.UPGRADES[5]]))
    assert int(out["scalar_info"]["unit_counts_bow"][10]) == 3
    assert int(out["scalar_info"]["unit_type_bool"][10]) == 1
    assert int(out["scalar_info"]["enemy_unit_type_bool"][20]) == 1
    assert int(out["scalar_info"]["upgrades"][5]) == 1
    assert out["scalar_info"]["agent_statistics"][0] == pytest.approx(np.log1p(500))


def test_cargo_passengers_become_entities(feat):
    carrier = make_unit(1, DRONE, passengers=[make_passenger(2, ACT.UNIT_TYPES[11])])
    out = feat.transform_obs(build_dummy_obs(units=[carrier]))
    assert int(out["entity_num"]) == 2
    assert int(out["entity_info"]["is_in_cargo"][1]) == 1
    assert out["game_info"]["tags"] == [1, 2]


def test_effect_coordinates_flat_flipped(feat):
    out = feat.transform_obs(build_dummy_obs(effects=[make_effect(Effects.PsiStorm, [(4, 20)])]))
    assert int(out["spatial_info"]["effect_PsiStorm"][0]) == 4 + (120 - 20) * F.SPATIAL_SIZE[1]
    own_zone = make_effect(Effects.LiberatorDefenderZone, [(1, 1)], owner=1)
    out2 = feat.transform_obs(build_dummy_obs(effects=[own_zone]))
    assert int(out2["spatial_info"]["effect_LiberatorDefenderZone"][0]) == 0


def test_battle_score(feat):
    obs = build_dummy_obs(killed_minerals=100.0, killed_vespene=40.0)
    assert compute_battle_score(obs) == pytest.approx(100 + 1.5 * 40)


def test_value_feature_from_opponent(feat):
    obs = build_dummy_obs(units=[make_unit(1, DRONE, alliance=1)])
    opp = build_dummy_obs(units=[make_unit(9, ACT.UNIT_TYPES[30], alliance=1, x=50, y=60)], player_id=2)
    vf = feat.transform_obs(obs, opponent_obs=opp)["value_feature"]
    assert int(vf["total_unit_count"]) == 2
    assert int(vf["enemy_unit_counts_bow"][30]) == 1
    assert vf["own_units_spatial"].shape == F.SPATIAL_SIZE
    assert int(vf["unit_alliance"][0]) == 1 and int(vf["unit_alliance"][1]) == 0


def test_transform_action_roundtrip(feat):
    tags = [111, 222, 333]
    attack_pt = ACT.FUNC_ID_TO_ACTION_TYPE[2]
    action = {
        "action_type": np.asarray(attack_pt), "delay": np.asarray(3), "queued": np.asarray(1),
        "selected_units": np.asarray([0, 2] + [3] * 62), "target_unit": np.asarray(0),
        "target_location": np.asarray(5 + 10 * F.SPATIAL_SIZE[1]),
    }
    cmd = feat.transform_action(action, tags)
    assert cmd["ability_id"] == ACT.ACTIONS[attack_pt]["general_ability_id"]
    assert cmd["unit_tags"] == [111, 333]
    garbage = dict(action, selected_units=np.asarray([0, 3] + [1] * 62))
    assert feat.transform_action(garbage, tags)["unit_tags"] == [111]
    assert feat.transform_action(action, tags, selected_units_num=1)["unit_tags"] == [111]
    assert cmd["queue_command"] is True
    assert cmd["target_world_space_pos"] == (5.0, 120.0 - 10.0)


def test_reverse_raw_action(feat):
    tags = [111, 222, 333]
    attack_gab = ACT.ACTIONS[ACT.FUNC_ID_TO_ACTION_TYPE[2]]["general_ability_id"]
    raw = make_raw_action(attack_gab, unit_tags=[222, 111], target_pos=(5, 110), queue_command=True)
    out = feat.reverse_raw_action(raw, tags)
    a = out["action"]
    assert int(a["action_type"]) == ACT.FUNC_ID_TO_ACTION_TYPE[2]
    assert a["selected_units"][:3].tolist() == [1, 0, 3]
    assert int(out["selected_units_num"]) == 3
    assert int(a["queued"]) == 1
    assert int(a["target_location"]) == (120 - 110) * F.SPATIAL_SIZE[1] + 5
    assert out["mask"]["target_location"] == 1.0 and out["mask"]["target_unit"] == 0.0
    assert not out["invalid"]


def test_reverse_raw_action_unit_variant(feat):
    out = feat.reverse_raw_action(make_raw_action(3674, unit_tags=[111], target_unit_tag=333), [111, 222, 333])
    assert int(out["action"]["action_type"]) == ACT.FUNC_ID_TO_ACTION_TYPE[3]
    assert int(out["action"]["target_unit"]) == 2
    assert out["mask"]["target_unit"] == 1.0 and out["mask"]["target_location"] == 0.0


def test_reverse_raw_action_cancel_slot_and_clamp(feat):
    out = feat.reverse_raw_action(make_raw_action(313, unit_tags=[111]), [111])
    assert int(out["action"]["action_type"]) == ACT.GAB_KIND_TO_ACTION[(3671, "quick")]
    assert not out["invalid"]
    out2 = feat.reverse_raw_action(make_raw_action(3674, unit_tags=[111], target_pos=(5, 0)), [111])
    assert int(out2["action"]["target_location"]) == (120 - 1) * F.SPATIAL_SIZE[1] + 5


def test_reverse_raw_action_invalid(feat):
    unk = feat.reverse_raw_action(make_raw_action(999999, unit_tags=[111]), [111])
    assert int(unk["action"]["action_type"]) == 0
    assert unk["invalid"] and unk["mask"]["action_type"] == 0.0
    assert feat.reverse_raw_action(make_raw_action(6, unit_tags=[111]), [111])["invalid"]


def test_agent_consumes_proto_obs(feat):
    from distar_tpu_torch.actor.agent import Agent

    out = feat.transform_obs(build_dummy_obs(units=[make_unit(1, DRONE)]))
    model_in = Agent("MP0", traj_len=4).pre_process(out)
    assert model_in["scalar_info"]["beginning_order"].shape == (20,)
    assert model_in["entity_num"] == out["entity_num"]


def test_fake_server_exercises_rich_obs_paths():
    game = FakeGameCore(end_at=10_000, map_size=(120, 120), n_units=6)
    game.advance(150)
    feats = ProtoFeatures(game.build_game_info())
    out = feats.transform_obs(game.build_observation(1), padding_spatial=True)
    ent, n = out["entity_info"], int(out["entity_num"])
    assert n == 2 * 6 + 2
    for key in ("order_length", "order_progress_0", "order_id_1", "buff_id_0", "is_in_cargo", "addon_unit_type"):
        assert (np.asarray(ent[key])[:n] > 0).any(), key
    assert (np.asarray(out["spatial_info"]["effect_CorrosiveBile"]) > 0).any()
    assert np.asarray(out["scalar_info"]["upgrades"]).sum() >= 2


# ------------------------------------------------------------------ parity
def assert_same(got, want, path="out"):
    """Equal in structure, value and type: arrays by dtype, shape and
    bytes; Python scalars by type and value."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got, key=str) == sorted(want, key=str), path
        for k in want:
            assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes(), path
    else:
        assert type(got) is type(want) and got == want, path


@pytest.fixture(scope="module")
def fixtures():
    return jax_dummy.build_parity_fixtures(), dummy_obs.build_parity_fixtures()


def _both(game_info):
    return jax_features.ProtoFeatures(game_info), port_features.ProtoFeatures(game_info)


def test_the_ports_parity_fixtures_are_the_jax_ones(fixtures):
    """Same inputs on both sides: the port's fixtures transform to the JAX
    fixtures' outputs (they are namespaces, compared through the
    transforms), and the Z stream is equal as is."""
    jfx, pfx = fixtures
    want = jax_features.ProtoFeatures(jfx["game_info"]).transform_obs(jfx["obs"], opponent_obs=jfx["opponent_obs"])
    got = port_features.ProtoFeatures(pfx["game_info"]).transform_obs(pfx["obs"], opponent_obs=pfx["opponent_obs"])
    assert_same(got, want)
    assert_same(pfx["z_stream"], jfx["z_stream"])
    assert [k for k, _ in pfx["actions"]] == [k for k, _ in jfx["actions"]]


@pytest.mark.parametrize("opponent", [False, True])
@pytest.mark.parametrize("padding_spatial", [True, False])
def test_transform_obs_matches_jax_on_the_parity_fixtures(fixtures, opponent, padding_spatial):
    jfx, _ = fixtures
    jf, pf = _both(jfx["game_info"])
    kw = dict(padding_spatial=padding_spatial, opponent_obs=jfx["opponent_obs"] if opponent else None)
    assert_same(pf.transform_obs(jfx["obs"], **kw), jf.transform_obs(jfx["obs"], **kw))
    assert_same(pf.transform_obs(jfx["first_obs"]), jf.transform_obs(jfx["first_obs"]))
    assert pf.born_locations(jfx["first_obs"]) == jf.born_locations(jfx["first_obs"])


@pytest.mark.parametrize("index", range(9))
def test_reverse_raw_action_matches_jax_on_the_parity_fixtures(fixtures, index):
    jfx, _ = fixtures
    jf, pf = _both(jfx["game_info"])
    tags = jf.transform_obs(jfx["obs"])["game_info"]["tags"]
    _, raw = jfx["actions"][index]
    assert_same(pf.reverse_raw_action(raw, tags), jf.reverse_raw_action(raw, tags))


def test_extract_z_and_battle_score_match_jax(fixtures):
    jfx, _ = fixtures
    jf, _ = _both(jfx["game_info"])
    home, away = jf.born_locations(jfx["first_obs"])
    for args in ((jfx["z_stream"], home, away), (jfx["z_stream"],), (jfx["z_stream"], home, away, False, 3)):
        assert_same(port_features.extract_z(*args), jax_features.extract_z(*args))
    for obs in (jfx["obs"], jfx["opponent_obs"], jfx["first_obs"]):
        assert_same(port_features.compute_battle_score(obs), jax_features.compute_battle_score(obs))


def _random_actions(seed, n, n_tags):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        sel = rng.integers(0, n_tags + 3, F.MAX_SELECTED_UNITS_NUM)
        sel[rng.integers(0, 8)] = n_tags  # an end token somewhere early
        out.append(({
            "action_type": np.asarray(rng.integers(0, ACT.NUM_ACTIONS)),
            "delay": np.asarray(rng.integers(0, 128)),
            "queued": np.asarray(rng.integers(0, 2)),
            "selected_units": sel,
            "target_unit": np.asarray(rng.integers(-1, n_tags + 2)),
            "target_location": np.asarray(rng.integers(0, F.SPATIAL_SIZE[0] * F.SPATIAL_SIZE[1])),
        }, None if rng.random() < 0.5 else np.asarray([rng.integers(0, 10)])))
    return out


def test_transform_action_matches_jax_on_every_action_type():
    """400 seeded actions over all 327 action types, with and without the
    sampler's ``selected_units_num``."""
    game = FakeGameCore(seed=5)
    jf, pf = _both(game.build_game_info())
    tags = list(range(5000, 5012))
    for action, sun in _random_actions(7, 400, len(tags)):
        assert_same(pf.transform_action(action, tags, selected_units_num=sun),
                    jf.transform_action(action, tags, selected_units_num=sun))


def _captured_game(core_cls, seed):
    """Observations of a seeded fake game at loops across its thresholds
    (upgrades at 100, an effect from 50, the result at the end), both
    sides' views, as protos; with the replay action stream."""
    from test_replay_decoder import make_replay

    from distar_tpu_torch.envs.sc2.fake_sc2 import _replay_actions_until

    game = core_cls(end_at=400, n_units=8, seed=seed, map_size=(152, 160))
    observations = []
    for loop in (0, 30, 60, 120, 250, 400):
        game.advance(loop - game.game_loop)
        observations.append((game.build_observation(1, with_result=True),
                             game.build_observation(2, with_result=True)))
    actions, _ = _replay_actions_until(make_replay(n_actions=24, loops_between=10), 0, 10_000)
    return game.build_game_info(), observations, actions


def test_the_fake_games_are_the_same_bytes_in_both_packages():
    _, port_obs, port_actions = _captured_game(FakeGameCore, 3)
    _, jax_obs, _ = _captured_game(JaxFakeGameCore, 3)
    for (p1, p2), (j1, j2) in zip(port_obs, jax_obs):
        assert p1.SerializeToString() == j1.SerializeToString()
        assert p2.SerializeToString() == j2.SerializeToString()
    assert len(port_actions) == 24


@pytest.mark.parametrize("step", range(6))
def test_transform_obs_matches_jax_on_a_seeded_fake_game(step):
    game_info, observations, _ = _captured_game(FakeGameCore, 3)
    jf, pf = _both(game_info)
    own, opp = observations[step]
    for kw in ({}, {"opponent_obs": opp}):
        assert_same(pf.transform_obs(own, **kw), jf.transform_obs(own, **kw))
    assert_same(port_features.compute_battle_score(own), jax_features.compute_battle_score(own))
    for name in ("height_map", "creep", "visibility_map"):
        plane = getattr(own.observation.feature_layer_data.minimap_renders, name)
        assert_same(port_features.unpack_feature_layer(plane), jax_features.unpack_feature_layer(plane))


def test_reverse_raw_action_matches_jax_on_a_seeded_fake_game():
    """The replay stream the fake plays back (build at a point, train, attack
    a unit) against the fake game's tags, and the raw decode of each into a
    Z stream."""
    game_info, observations, actions = _captured_game(FakeGameCore, 3)
    jf, pf = _both(game_info)
    tags = jf.transform_obs(observations[3][0])["game_info"]["tags"]
    jax_infos, port_infos = [], []
    for a in actions:
        want = jf.reverse_raw_action(a.action_raw, tags)
        got = pf.reverse_raw_action(a.action_raw, tags)
        assert_same(got, want)
        jax_infos.append({"action_info": want["action"]})
        port_infos.append({"action_info": got["action"]})
    home, away = jf.born_locations(observations[0][0])
    assert_same(port_features.extract_z(port_infos, home, away), jax_features.extract_z(jax_infos, home, away))
