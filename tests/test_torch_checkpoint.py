"""The port's checkpoint format against the JAX package's, on the CPU.

A learner checkpoint the JAX package writes (real optax state) is served by
the port's gateway through the registry's default ``load_fn`` with the JAX
``BatchedInference``'s logits (tolerance of tests/test_torch_serve.py); a
checkpoint the port writes is read by the JAX package leaf for leaf and
byte for byte; corrupt copies raise in both; chunked, bf16, scalar and
sequence leaves cross both ways; and the port's MessagePack codec is held
against the ``msgpack`` package by a property test."""
import functools

import jax
import msgpack
import numpy as np
import optax
import pytest
import torch
from conftest import SMALL_MODEL
from flax import serialization
from hypothesis import given, settings
from hypothesis import strategies as st

from distar_tpu.actor.inference import BatchedInference as JaxBatchedInference
from distar_tpu.model import Model as JModel
from distar_tpu.model.config import default_model_config as jax_default_config
from distar_tpu.utils import checkpoint as jckpt
from distar_tpu.utils import deep_merge_dicts as jax_merge
from distar_tpu_torch.actor import BatchedInference
from distar_tpu_torch.lib import features as F
from distar_tpu_torch.model import Model, default_model_config, init_params
from distar_tpu_torch.model.convert import params_from_flax, params_to_flax
from distar_tpu_torch.serve import BatchedInferenceEngine, InferenceGateway, ModelRegistry
from distar_tpu_torch.utils import checkpoint as ckpt
from distar_tpu_torch.utils import deep_merge_dicts
from distar_tpu_torch.utils import msgpack as M
from distar_tpu_torch.utils import storage
from test_torch_serve import KERNEL_OVERLAY, TOL, jax_noise

torch.set_num_threads(1)

SLOTS = 3


def small_model(seed=0):
    model = Model(deep_merge_dicts(deep_merge_dicts(default_model_config(), SMALL_MODEL), KERNEL_OVERLAY))
    init_params(model, seed)
    return model


def leaves(tree, prefix=()):
    """{path: leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(leaves(v, prefix + (k,)))
        return out
    return {prefix: tree}


@pytest.fixture(scope="module")
def jax_learner_checkpoint(tmp_path_factory):
    """The JAX package's learner checkpoint of a SMALL_MODEL: its params
    and a real optax Adam state, written by its ``save_checkpoint``."""
    jm = JModel(jax_merge(jax_default_config(), SMALL_MODEL))
    rng = np.random.default_rng(3)
    obs = [F.random_step_data(rng) for _ in range(SLOTS)]
    first = F.batch_tree(obs)
    H = SMALL_MODEL["encoder"]["core_lstm"]["hidden_size"]
    h0 = ((np.zeros((SLOTS, H), np.float32),) * 2,)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), first["spatial_info"], first["entity_info"],
                              first["scalar_info"], first["entity_num"], h0, jax.random.PRNGKey(1))
    opt_state = optax.adam(1e-3).init(params)
    path = str(tmp_path_factory.mktemp("ckpt") / "learner.ckpt")
    jckpt.save_checkpoint(path, {"params": params, "opt_state": opt_state}, metadata={"iter": 7})
    return dict(path=path, jm=jm, params=params, obs=obs)


def test_jax_checkpoint_serves_through_the_port_gateway(jax_learner_checkpoint):
    """Registry default load_fn -> state_dict -> gateway flush: the JAX
    BatchedInference's logits, actions and log-probs under the same noise."""
    c = jax_learner_checkpoint
    seed = 5
    want = JaxBatchedInference(c["jm"], c["params"], SLOTS, seed=seed).sample(c["obs"])
    infer = BatchedInference(small_model(seed=9), SLOTS, device="cpu")  # weights from the checkpoint
    key = jax.random.split(jax.random.PRNGKey(seed))[1]  # the JAX object's first key
    infer.sample = functools.partial(infer.sample, noise=jax_noise(key, infer.model.cfg, SLOTS))
    registry = ModelRegistry()
    gw = InferenceGateway(BatchedInferenceEngine(infer), registry=registry, max_delay_s=0.05).start()
    try:
        info = gw.load_version("v1", source=c["path"], activate=True)
        assert info["load_s"] > 0
        got = gw.act_many([{"session_id": f"s{i}", "obs": o} for i, o in enumerate(c["obs"])])
    finally:
        gw.drain_and_stop()
    for g, w in zip(got, want):
        assert g["model_version"] == "v1"
        for k in F.ACTION_HEADS:
            np.testing.assert_array_equal(g["action_info"][k], np.asarray(w["action_info"][k]))
            np.testing.assert_allclose(g["logit"][k], np.asarray(w["logit"][k]), **TOL)
            np.testing.assert_allclose(g["action_logp"][k], np.asarray(w["action_logp"][k]), **TOL)


def test_load_params_strips_the_optimizer_state(jax_learner_checkpoint):
    c = jax_learner_checkpoint
    got = ckpt.load_params(c["path"])
    want = jax.tree.map(np.asarray, c["params"])
    assert set(leaves(got)) == set(leaves(want))
    for path, leaf in leaves(want).items():
        np.testing.assert_array_equal(leaves(got)[path], leaf)
    meta = ckpt.load_checkpoint(c["path"])["metadata"]
    assert meta == jckpt.load_checkpoint(c["path"])["metadata"] == {"iter": 7}


def port_learner_state(model):
    params = params_to_flax(model)
    zeros = jax.tree.map(lambda x: np.zeros_like(x) + 0.5, params)
    return {"params": params, "opt_state": ((), (np.int32(3), zeros, zeros), ())}


def test_port_checkpoint_is_read_by_the_jax_package(tmp_path):
    model = small_model()
    state = port_learner_state(model)
    meta = {"iter": 12, "player": "MP0", "lr": 1e-5, "tags": ["a", "b"]}
    path = str(tmp_path / "port.ckpt")
    ckpt.save_checkpoint(path, state, metadata=meta)
    assert jckpt.verify_checkpoint(path) and ckpt.verify_checkpoint(path)
    loaded = jckpt.load_checkpoint(path)
    assert loaded["metadata"] == jckpt._to_serialisable(meta)
    want = leaves(jckpt._to_serialisable(state))
    got = leaves(loaded["state"])
    assert set(got) == set(want)
    for path_, leaf in want.items():
        assert np.asarray(got[path_]).dtype == np.asarray(leaf).dtype
        np.testing.assert_array_equal(got[path_], leaf)
    # and the JAX load_params of it is the model, back through the bridge
    back = params_from_flax(jckpt.load_params(path), model)
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v)


def test_both_packages_write_the_same_bytes(tmp_path):
    """One tree, one metadata: the port's blob is the JAX package's."""
    state = port_learner_state(small_model())
    meta = {"iter": 1}
    a, b = str(tmp_path / "port.ckpt"), str(tmp_path / "jax.ckpt")
    ckpt.save_checkpoint(a, state, metadata=meta)
    jckpt.save_checkpoint(b, state, metadata=meta)
    assert open(a, "rb").read() == open(b, "rb").read()


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("fault", ["flipped_byte", "truncated"])
def test_corrupt_checkpoints_raise_in_both_packages(tmp_path, writer, fault):
    path = str(tmp_path / "c.ckpt")
    state = {"params": {"w": np.arange(4096, dtype=np.float32)}}
    (ckpt.save_checkpoint if writer == "port" else jckpt.save_checkpoint)(path, state)
    blob = bytearray(open(path, "rb").read())
    if fault == "flipped_byte":
        blob[len(blob) // 2] ^= 0x01
    else:
        del blob[-100:]
    open(path, "wb").write(bytes(blob))
    assert not ckpt.verify_checkpoint(path) and not jckpt.verify_checkpoint(path)
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.load_checkpoint(path)
    with pytest.raises(jckpt.CheckpointCorruptError):
        jckpt.load_checkpoint(path)


def undecodable(tmp_path):
    path = str(tmp_path / "junk.ckpt")
    storage.write_bytes(path, b"\xc1 not msgpack")
    return path


def test_undecodable_bytes_without_a_manifest_raise_corrupt(tmp_path):
    path = undecodable(tmp_path)
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.load_checkpoint(path)
    with pytest.raises(jckpt.CheckpointCorruptError):
        jckpt.load_checkpoint(path)


def odd_leaves():
    """Leaves past plain arrays: a chunked one, a scalar, nested sequences."""
    return {"big": np.arange(100, dtype=np.float32).reshape(4, 25),
            "scalar": np.float32(2.5), "count": np.int64(-3),
            "seq": ((np.ones(2, np.int32), [np.zeros(3, np.float64), 7]), "name")}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_chunked_scalar_and_sequence_leaves_cross_both_ways(tmp_path, monkeypatch, writer):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(M, "MAX_CHUNK_SIZE", 64)
    path = str(tmp_path / "odd.ckpt")
    (ckpt.save_checkpoint if writer == "port" else jckpt.save_checkpoint)(path, odd_leaves())
    blob = open(path, "rb").read()
    assert b"__msgpack_chunked_array__" in blob
    for loader in (ckpt.load_checkpoint, jckpt.load_checkpoint):
        state = loader(path)["state"]
        np.testing.assert_array_equal(state["big"], odd_leaves()["big"])
        assert state["scalar"] == np.float32(2.5) and state["scalar"].dtype == np.float32
        assert state["count"] == -3 and state["count"].dtype == np.int64
        seq = ckpt._from_seq(state["seq"])
        inner = ckpt._from_seq(seq[0])
        np.testing.assert_array_equal(inner[0], np.ones(2, np.int32))
        assert ckpt._from_seq(inner[1])[1] == 7 and seq[1] == "name"


def test_numpy_scalars_and_complex_leaves_match_flax():
    """flax's ext types 3 (numpy scalar) and 2 (complex) both ways, and the
    same bytes."""
    tree = {"b": {"i": np.int32(-7), "f": np.float64(0.25), "t": np.bool_(True)}, "c": complex(1, -2),
            "a": np.arange(6, dtype=np.uint8).reshape(2, 3)}
    blob = serialization.msgpack_serialize(tree)
    assert M.serialize(tree) == blob
    got = M.restore(blob)
    for k, v in tree["b"].items():
        assert type(got["b"][k]) is type(v) and got["b"][k] == v
    assert got["c"] == complex(1, -2)
    back = serialization.msgpack_restore(M.serialize(tree))
    assert back["b"]["i"].dtype == np.int32 and back["c"] == complex(1, -2)
    np.testing.assert_array_equal(back["a"], tree["a"])


def test_bf16_leaves_cross_both_ways(tmp_path):
    t = torch.randn(3, 5).bfloat16()
    a, b = str(tmp_path / "port.ckpt"), str(tmp_path / "jax.ckpt")
    ckpt.save_checkpoint(a, {"w": t})
    got = jckpt.load_checkpoint(a)["state"]["w"]
    assert got.dtype.name == "bfloat16"
    np.testing.assert_array_equal(got.view(np.uint16), t.view(torch.int16).numpy().view(np.uint16))
    jckpt.save_checkpoint(b, {"w": got})
    back = ckpt.load_checkpoint(b)["state"]["w"]
    assert back.dtype == torch.bfloat16 and torch.equal(back.view(torch.int16), t.view(torch.int16))


def test_storage_schemes_and_sharded_directories(tmp_path):
    ckpt.save_checkpoint("mem://ckpt/a", {"w": np.arange(3)})
    np.testing.assert_array_equal(ckpt.load_checkpoint("mem://ckpt/a")["state"]["w"], np.arange(3))
    assert storage.exists("mem://ckpt/a.manifest")
    with pytest.raises(RuntimeError, match="google-cloud-storage"):
        storage.read_bytes("gs://bucket/x")
    with pytest.raises(ValueError, match="no storage backend"):
        storage.read_bytes("s3://bucket/x")
    # a directory with a manifest routes to the sharded reader: a manifest
    # naming no skeleton is a corrupt generation, typed
    (tmp_path / "sharded").mkdir()
    (tmp_path / "sharded" / "sharding.json").write_text("{}")
    with pytest.raises(ckpt.CheckpointCorruptError, match="skeleton"):
        ckpt.load_checkpoint(str(tmp_path / "sharded"))
    assert not ckpt.verify_checkpoint(str(tmp_path / "sharded"))


msgpack_values = st.recursive(
    st.none() | st.booleans() | st.integers(-(2 ** 63), 2 ** 64 - 1)
    | st.floats(allow_nan=False) | st.text() | st.binary(),
    lambda inner: st.lists(inner, max_size=20) | st.dictionaries(st.text(max_size=8), inner, max_size=20),
    max_leaves=40)


@settings(max_examples=150, deadline=None)
@given(msgpack_values)
def test_msgpack_codec_matches_the_msgpack_package(value):
    """The port's writer gives the msgpack package's bytes; each reads the
    other's."""
    want = msgpack.packb(value, use_bin_type=True)
    assert M.packb(value) == want
    assert M.unpackb(want) == value
    assert msgpack.unpackb(M.packb(value), raw=False, strict_map_key=False) == value


@settings(max_examples=50, deadline=None)
@given(st.lists(st.floats(width=32, allow_nan=False), max_size=8), st.integers(1, 70000))
def test_msgpack_reads_float32_and_long_headers(floats, n):
    packer = msgpack.Packer(use_bin_type=True, use_single_float=True)
    assert M.unpackb(packer.pack(floats)) == floats
    blob = msgpack.packb({"s": "x" * n, "b": b"y" * n, "a": [0] * (n % 300)}, use_bin_type=True)
    assert M.unpackb(blob) == {"s": "x" * n, "b": b"y" * n, "a": [0] * (n % 300)}
