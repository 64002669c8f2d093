"""The port's serving path on the CPU at SMALL_MODEL: ``BatchedInference``
against the JAX package's over a 3-step session under the same Gumbel
noise (so the hidden-state carry and the inactive-lane merge are checked),
the teacher piggyback (``teacher_step`` over the same session, and through
the gateway's ``want_teacher``), then the gateway's sticky sessions, reset,
drain and the device rule.

Tolerance atol 2e-4 / rtol 1e-3 (tests/test_golden_parity.py:132)."""
import jax
import numpy as np
import pytest
import torch
from conftest import SMALL_MODEL

from distar_tpu.actor.inference import BatchedInference as JaxBatchedInference
from distar_tpu.model import Model as JModel
from distar_tpu.model.config import default_model_config as jax_default_config
from distar_tpu.utils import deep_merge_dicts as jax_merge
from distar_tpu_torch.actor import BatchedInference
from distar_tpu_torch.lib import features as F
from distar_tpu_torch.model import Model, default_model_config, init_params, noise_shapes
from distar_tpu_torch.model.convert import params_from_flax
from distar_tpu_torch.serve import BatchedInferenceEngine, DrainingError, InferenceGateway
from distar_tpu_torch.utils import deep_merge_dicts

torch.set_num_threads(1)

SLOTS = 3
TOL = dict(atol=2e-4, rtol=1e-3)
KERNEL_OVERLAY = {"encoder": {"entity": {"attention_impl": "pallas"}, "scatter": {"impl": "pallas"}}}
ACTIVE = [[True, True, True], [True, False, True], [True, True, True]]


def small_cfg(overlay=None):
    return deep_merge_dicts(deep_merge_dicts(default_model_config(), SMALL_MODEL), overlay or {})


def jax_noise(key, cfg, batch):
    """The Gumbel draws JAX's sample_action makes from ``key`` (see
    tests/test_torch_model.py)."""
    shapes = noise_shapes(cfg, batch)
    r = jax.random.split(key, 6)
    heads = ["action_type", "delay", "queued", None, "target_unit", "target_location"]
    out = {h: np.array(jax.random.gumbel(r[i], shapes[h])) for i, h in enumerate(heads) if h}
    step_keys = jax.random.split(r[3], shapes["selected_units"][1])
    out["selected_units"] = np.stack(
        [np.array(jax.random.gumbel(k, (batch, shapes["selected_units"][2]))) for k in step_keys], 1)
    return {k: torch.from_numpy(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def session():
    """Three steps through both BatchedInferences with the same weights,
    observations and noise; slot 1 sits out step 2."""
    jm = JModel(jax_merge(jax_default_config(), SMALL_MODEL))
    rng = np.random.default_rng(2)
    steps = [[F.random_step_data(rng) for _ in range(SLOTS)] for _ in range(3)]
    first = F.batch_tree(steps[0])
    H = SMALL_MODEL["encoder"]["core_lstm"]["hidden_size"]
    h0 = tuple((np.zeros((SLOTS, H), np.float32),) * 2 for _ in range(1))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), first["spatial_info"], first["entity_info"],
                              first["scalar_info"], first["entity_num"], h0, jax.random.PRNGKey(1))
    seed = 11
    jinf = JaxBatchedInference(jm, params, SLOTS, seed=seed)
    model = Model(small_cfg(KERNEL_OVERLAY))
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params), model))
    tinf = BatchedInference(model, SLOTS, device="cpu")
    rng_key = jax.random.PRNGKey(seed)
    record = []
    for prepared, active in zip(steps, ACTIVE):
        rng_key, key = jax.random.split(rng_key)  # the JAX object's own key schedule
        want = jinf.sample(prepared, active)
        got = tinf.sample(prepared, active, noise=jax_noise(key, model.cfg, SLOTS))
        record.append(dict(want=want, got=got, jh=jax.device_get(jinf.hidden),
                           th=[(h.numpy(), c.numpy()) for h, c in tinf.hidden]))
    return dict(record=record, tinf=tinf, state=model.state_dict(), jm=jm, params=params, steps=steps,
                first=first, h0=h0)


@pytest.fixture(scope="module")
def teacher_session(session):
    """Three teacher steps over the session's observations and sampled
    actions, in both packages, from a second set of JAX weights; slot 1
    sits out step 2."""
    jm, first, h0 = session["jm"], session["first"], session["h0"]
    teacher = jax.jit(jm.init)(jax.random.PRNGKey(7), first["spatial_info"], first["entity_info"],
                               first["scalar_info"], first["entity_num"], h0, jax.random.PRNGKey(8))
    jinf = JaxBatchedInference(jm, session["params"], SLOTS, teacher_params=teacher)
    model = Model(small_cfg(KERNEL_OVERLAY))
    model.load_state_dict(session["state"])
    tinf = BatchedInference(model, SLOTS, device="cpu",
                            teacher_params=params_from_flax(jax.tree.map(np.asarray, teacher), model))
    record = []
    for prepared, active, rec in zip(session["steps"], ACTIVE, session["record"]):
        outputs = [jax.tree.map(np.asarray, o) for o in rec["want"]]
        want = jinf.teacher_step(prepared, outputs, active)
        got = tinf.teacher_step(prepared, outputs, active)
        record.append(dict(want=want, got=got, jh=jax.device_get(jinf.teacher_hidden),
                           th=[(h.numpy(), c.numpy()) for h, c in tinf.teacher_hidden]))
    return dict(record=record, tinf=tinf, teacher=teacher)


@pytest.mark.parametrize("step", [0, 1, 2])
def test_teacher_step_matches_jax(teacher_session, step):
    rec = teacher_session["record"][step]
    for slot in range(SLOTS):
        if not ACTIVE[step][slot]:
            continue
        for k in F.ACTION_HEADS:
            np.testing.assert_allclose(rec["got"][slot][k], np.asarray(rec["want"][slot][k]), **TOL)
    for (th, tc), (jh, jc) in zip(rec["th"], rec["jh"]):
        np.testing.assert_allclose(th, np.asarray(jh), **TOL)
        np.testing.assert_allclose(tc, np.asarray(jc), **TOL)


def test_reset_slot_zeroes_the_teacher_carry_too(teacher_session):
    tinf = teacher_session["tinf"]
    assert all(h[0].any() for h, _ in tinf.teacher_hidden)
    tinf.reset_slot(0)
    assert not any(h[0].any() or c[0].any() for h, c in tinf.teacher_hidden)
    assert all(h[2].any() for h, _ in tinf.teacher_hidden)
    with pytest.raises(RuntimeError, match="no teacher params"):
        BatchedInference(Model(small_cfg()), SLOTS, device="cpu").teacher_step([], [], None)


def test_gateway_piggybacks_teacher_logits(session, teacher_session):
    """``want_teacher`` lanes get the teacher's logits from the same flush;
    the others get none and keep their teacher carry."""
    rng = np.random.default_rng(8)
    gw, infer = make_gateway(session["state"], seed=4)
    try:
        assert not gw.engine.has_teacher
        assert gw.set_teacher(params_from_flax(jax.tree.map(np.asarray, teacher_session["teacher"]),
                                               infer.model))
        assert gw.engine.has_teacher
        outs = gw.act_many([{"session_id": "a", "obs": F.random_step_data(rng), "want_teacher": True},
                            {"session_id": "b", "obs": F.random_step_data(rng)}])
        assert set(outs[0]["teacher_logit"]) == set(F.ACTION_HEADS) and "teacher_logit" not in outs[1]
        slot_b = gw.sessions.slot_of("b")
        assert not any(h[slot_b].any() for h, _ in infer.teacher_hidden)
        assert gw.teacher_flushes == 1 and gw.flushes == 1
    finally:
        gw.drain_and_stop()


@pytest.mark.parametrize("step", [0, 1, 2])
def test_three_step_session_matches_jax(session, step):
    rec = session["record"][step]
    for slot in range(SLOTS):
        if not ACTIVE[step][slot]:
            continue
        want, got = rec["want"][slot], rec["got"][slot]
        for k in F.ACTION_HEADS:
            np.testing.assert_array_equal(got["action_info"][k], np.asarray(want["action_info"][k]))
            np.testing.assert_allclose(got["logit"][k], np.asarray(want["logit"][k]), **TOL)
            np.testing.assert_allclose(got["action_logp"][k], np.asarray(want["action_logp"][k]), **TOL)
        np.testing.assert_array_equal(got["selected_units_num"], np.asarray(want["selected_units_num"]))
    for (th, tc), (jh, jc) in zip(rec["th"], rec["jh"]):
        np.testing.assert_allclose(th, np.asarray(jh), **TOL)
        np.testing.assert_allclose(tc, np.asarray(jc), **TOL)


def test_inactive_lane_keeps_its_hidden_state(session):
    before, after = session["record"][0]["th"], session["record"][1]["th"]
    for (h0, c0), (h1, c1) in zip(before, after):
        np.testing.assert_array_equal(h1[1], h0[1])  # slot 1 sat out step 2
        np.testing.assert_array_equal(c1[1], c0[1])
        assert not np.array_equal(h1[0], h0[0])


def test_outputs_are_host_numpy_with_contract_shapes(session):
    out = session["record"][2]["got"][0]
    for k, shape in F.ACTION_SHAPES.items():
        assert isinstance(out["action_info"][k], (np.ndarray, np.generic))
        assert np.shape(out["action_info"][k]) == shape
    for k, shape in F.LOGIT_SHAPES.items():
        assert out["logit"][k].shape == shape and out["logit"][k].dtype == np.float32


def test_reset_slot_zeroes_only_that_slot(session):
    tinf = session["tinf"]
    before = tinf.hidden_for_slot(2)
    tinf.reset_slot(0)
    for (h, c), (h2, c2) in zip(tinf.hidden_for_slot(0), tinf.hidden_for_slot(2)):
        assert not h.any() and not c.any()
    for (h, c), (hb, cb) in zip(tinf.hidden_for_slot(2), before):
        np.testing.assert_array_equal(h, hb)
        np.testing.assert_array_equal(c, cb)


def make_gateway(state, seed=0):
    model = Model(small_cfg(KERNEL_OVERLAY))
    model.load_state_dict(state)
    infer = BatchedInference(model, SLOTS, seed=seed, device="cpu")
    gw = InferenceGateway(BatchedInferenceEngine(infer), max_delay_s=0.01).start()
    gw.load_version("v1", params=state, activate=True)
    return gw, infer


def test_gateway_session_matches_direct_inference(session):
    """A session served through the gateway gets exactly what the engine
    computes for its slot: padding lanes are inactive and the noise comes
    from the same seeded generator."""
    rng = np.random.default_rng(5)
    obs = [F.random_step_data(rng) for _ in range(2)]
    gw, _ = make_gateway(session["state"], seed=3)
    try:
        served = [gw.act("alice", o) for o in obs]
        hidden = gw.session_hidden("alice")
    finally:
        gw.drain_and_stop()
    model = Model(small_cfg(KERNEL_OVERLAY))
    model.load_state_dict(session["state"])
    direct = BatchedInference(model, SLOTS, seed=3, device="cpu")
    template = {k: v for k, v in F.fake_step_data().items()}
    for o, s in zip(obs, served):
        want = direct.sample([o] + [template] * (SLOTS - 1), [True] + [False] * (SLOTS - 1))[0]
        assert s["model_version"] == "v1"
        for k in F.ACTION_HEADS:
            np.testing.assert_array_equal(s["action_info"][k], want["action_info"][k])
    for (h, c), (hw, cw) in zip(hidden, direct.hidden_for_slot(0)):
        np.testing.assert_array_equal(h, hw)
        np.testing.assert_array_equal(c, cw)


def test_sticky_sessions_keep_separate_state_and_reset(session):
    rng = np.random.default_rng(6)
    gw, infer = make_gateway(session["state"])
    try:
        a = [gw.act("a", F.random_step_data(rng)) for _ in range(2)]
        b = gw.act("b", F.random_step_data(rng))
        assert [o["session_step"] for o in a] == [1, 2] and b["session_step"] == 1
        assert gw.sessions.slot_of("a") != gw.sessions.slot_of("b")
        ha, hb = gw.session_hidden("a"), gw.session_hidden("b")
        assert not np.array_equal(ha[0][0], hb[0][0])
        assert gw.reset_session("a")
        assert not any(h.any() or c.any() for h, c in gw.session_hidden("a"))
        np.testing.assert_array_equal(gw.session_hidden("b")[0][0], hb[0][0])
        assert gw.act("a", F.random_step_data(rng))["session_step"] == 1
        outs = gw.act_many([{"session_id": s, "obs": F.random_step_data(rng)} for s in ("a", "b", "c")])
        assert [o["session_step"] for o in outs] == [2, 2, 1]
        assert gw.status()["sessions"]["active"] == 3
    finally:
        gw.drain_and_stop()
    assert isinstance(gw.act_many([{"session_id": "a", "obs": {}}])[0], DrainingError)


def test_the_cuda_device_rule_holds_float32_without_tf32(monkeypatch):
    """On CUDA the entry points' device rule turns TF32 off for matmuls and
    cuDNN convolutions, whoever calls it (``bin/serve.py``, a gateway built
    in process, a learner); the CPU leaves torch's switches as they are."""
    from distar_tpu_torch.actor.inference import resolve_device

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda")
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32


def test_entry_points_refuse_to_slide_onto_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    model = Model(small_cfg())
    init_params(model, 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BatchedInference(model, SLOTS)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceGateway(BatchedInferenceEngine(BatchedInference(model, SLOTS)))
    # the CPU only when asked for, and the gateway runs where its engine runs
    gw = InferenceGateway(BatchedInferenceEngine(BatchedInference(model, SLOTS, device="cpu")))
    assert gw.engine.device == torch.device("cpu")
