"""The port's copies of the JAX package's host-side contract: the action and
feature tables, the config cascade and the model configs must equal the
JAX package's, so a JAX config or observation loads into the port
unchanged."""
import numpy as np
import pytest

from distar_tpu.lib import actions as jax_actions
from distar_tpu.lib import features as jax_features
from distar_tpu.model import config as jax_config
from distar_tpu.utils import deep_merge_dicts as jax_merge
from distar_tpu_torch.lib import actions, features
from distar_tpu_torch.model import config
from distar_tpu_torch.utils import deep_merge_dicts

ACTION_TABLES = [
    "NUM_ACTIONS", "NUM_UNIT_TYPES", "NUM_BUFFS", "NUM_UPGRADES", "NUM_ADDON",
    "NUM_UNIT_MIX_ABILITIES", "QUEUE_ACTION_EMBEDDING_DIM", "NUM_BEGINNING_ORDER_ACTIONS",
    "NUM_CUMULATIVE_STAT_ACTIONS", "BEGINNING_ORDER_ACTIONS", "CUMULATIVE_STAT_ACTIONS",
    "SELECTED_UNITS_MASK",
]
FEATURE_TABLES = [
    "SPATIAL_SIZE", "MAX_DELAY", "BEGINNING_ORDER_LENGTH", "MAX_SELECTED_UNITS_NUM",
    "MAX_ENTITY_NUM", "EFFECT_LENGTH", "SPATIAL_INFO", "SCALAR_INFO", "ENTITY_INFO",
    "ACTION_HEADS", "LOGIT_SHAPES", "ACTION_SHAPES",
]


@pytest.mark.parametrize("name", ACTION_TABLES)
def test_action_tables_equal(name):
    np.testing.assert_array_equal(np.asarray(getattr(actions, name)),
                                  np.asarray(getattr(jax_actions, name)))


@pytest.mark.parametrize("name", FEATURE_TABLES)
def test_feature_tables_equal(name):
    assert getattr(features, name) == getattr(jax_features, name)


def test_fake_step_data_has_the_jax_schema():
    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                out.update(leaves(v, f"{prefix}/{k}"))
            return out
        return {prefix: (np.asarray(tree).shape, np.asarray(tree).dtype)}

    want = leaves(jax_features.fake_step_data(train=False))
    assert leaves(features.fake_step_data()) == want
    assert leaves(features.random_step_data(np.random.default_rng(0))) == want


@pytest.mark.parametrize("which", ["default_model_config", "student_model_config"])
def test_model_configs_equal(which):
    assert getattr(config, which)().to_dict() == getattr(jax_config, which)().to_dict()


def test_deep_merge_matches():
    base = {"a": {"b": 1, "c": [1, 2]}, "d": 3}
    over = {"a": {"b": 5, "e": {"f": 6}}, "d": {"x": 1}}
    assert deep_merge_dicts(base, over).to_dict() == jax_merge(base, over).to_dict()
    assert deep_merge_dicts(base, over).a.e.f == 6
