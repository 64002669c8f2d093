"""The port's training-dynamics observatory against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages: the
SMALL_MODEL's seeded port weights (through ``params_to_flax``), gradients
and updates drawn at the same shapes, a ``random_sl_batch``.

Tolerances, each with its reason:
* the tree's norms and ratios, rtol 1e-5: the same f32 sums of squares,
  grouped per module in another order (per-leaf norms, then a per-module
  sum); the non-finite censuses exactly (they count elements).
* the monitor's publication, equal Prometheus text: host arithmetic on the
  same floats.
* a bundle's arrays, bit for bit across packages (the same pickle).
"""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import SMALL_MODEL

from distar_tpu.obs import MetricsRegistry as JRegistry
from distar_tpu.obs import dynamics as jdyn
from distar_tpu.obs import render_prometheus as jax_prometheus
from distar_tpu_torch.actor.inference import to_device
from distar_tpu_torch.learner import SLLearner, random_sl_batch
from distar_tpu_torch.learner.base_learner import DEFAULT_LEARNER_CONFIG
from distar_tpu_torch.model import Model, default_model_config, init_params
from distar_tpu_torch.model.convert import params_to_flax
from distar_tpu_torch.obs import FleetHealth, MetricsRegistry, default_rulebook, render_prometheus
from distar_tpu_torch.obs.dynamics import (
    DYNAMICS_DEFAULTS,
    DynamicsMonitor,
    DynamicsSpec,
    DynamicsTree,
    config_digest,
    dynamics_tree,
    first_nonfinite,
    list_bundles,
    load_bundle,
    split_tree,
    tree_spec,
)
from distar_tpu_torch.tools import stepreplay
from distar_tpu_torch.utils import deep_merge_dicts

torch.set_num_threads(1)

B, T = 2, 2
LR = 1e-3


def _float_leaf(tree):
    """(the dict holding it, key) of the first float array in ``tree``."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            got = _float_leaf(v)
            if got is not None:
                return got
        elif np.asarray(v).dtype.kind == "f":
            return tree, k
    return None


def _inputs(rng, poison=None):
    model = Model(deep_merge_dicts(default_model_config(), SMALL_MODEL))
    init_params(model, 3)
    names = [n for n, _ in model.named_parameters()]
    params = list(model.parameters())
    grads = [torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)) for p in params]
    update = [torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)) for p in params]
    batch = random_sl_batch(B, T, rng)
    for k in ("new_episodes", "traj_lens"):
        batch.pop(k)
    if poison == "batch":
        holder, key = _float_leaf(batch["entity_info"])
        holder[key] = holder[key].copy()
        holder[key].reshape(-1)[3] = np.nan
    elif poison == "param":
        with torch.no_grad():
            params[7].view(-1)[0] = float("nan")
        grads = [g.fill_(float("nan")) for g in grads]  # the blast radius
    elif poison == "grad_inf":
        grads[-1].view(-1)[1] = float("inf")
    return model, names, params, grads, update, batch


@pytest.mark.parametrize("poison", [None, "batch", "param", "grad_inf"])
def test_dynamics_tree_matches_jax(poison):
    """Same parameters, gradients, update and batch: equal key sets, norms
    and ratios within rtol 1e-5, censuses and provenance exact."""
    rng = np.random.default_rng(31)
    model, names, params, grads, update, batch = _inputs(rng, poison)
    spec = dict(clip_type="norm", clip_threshold=1.0)
    got = {k: float(v) for k, v in dynamics_tree(
        model, params, grads, update=update, lr=LR, batch=to_device(batch, "cpu"),
        spec=DynamicsSpec(**spec)).items()}
    want = {k: float(v) for k, v in jdyn.dynamics_tree(
        jax.tree.map(jnp.asarray, params_to_flax(model)),
        jax.tree.map(jnp.asarray, params_to_flax(model, dict(zip(names, grads)))),
        updates=jax.tree.map(jnp.asarray, params_to_flax(model, {n: -LR * u for n, u in zip(names, update)})),
        batch=jax.tree.map(jnp.asarray, batch), spec=jdyn.DynamicsSpec(**spec)).items()}
    assert set(got) == set(want)
    assert {"encoder", "core_lstm", "policy"} <= set(split_tree(got)["param_norm"])
    for k, w in want.items():
        if k.startswith("dyn/nonfinite_"):
            assert got[k] == w, k
        elif math.isnan(w):
            assert math.isnan(got[k]), k
        else:
            np.testing.assert_allclose(got[k], w, rtol=1e-5, err_msg=k)
    assert first_nonfinite(got) == jdyn.first_nonfinite(want)
    origin = {None: None, "batch": "batch", "param": "params", "grad_inf": "grads"}[poison]
    assert (first_nonfinite(got) or {}).get("origin") == origin


@pytest.mark.parametrize("clip", [("value", 0.5), ("none", 1.0), ("max_norm", 1.0)])
def test_clip_activation_matches_jax(clip):
    rng = np.random.default_rng(32)
    model, names, params, grads, update, batch = _inputs(rng)
    spec = dict(clip_type=clip[0], clip_threshold=clip[1])
    got = dynamics_tree(model, params, grads, spec=DynamicsSpec(**spec))
    want = jdyn.dynamics_tree(jax.tree.map(jnp.asarray, params_to_flax(model)),
                              jax.tree.map(jnp.asarray, params_to_flax(model, dict(zip(names, grads)))),
                              spec=jdyn.DynamicsSpec(**spec))
    for k in ("dyn/clip_fraction", "dyn/clip_active"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)


def test_tree_is_split_around_the_update_and_adds_no_sync():
    """``before_update`` reads pre-step params and raw grads, the update
    ratio reads the update; every value is a 0-d float32 tensor (the step's
    one stacked copy ships them)."""
    rng = np.random.default_rng(33)
    model, names, params, grads, update, batch = _inputs(rng)
    tree = DynamicsTree(model, params, DynamicsSpec("norm", 1.0))
    pre = tree.before_update(params, grads, to_device(batch, "cpu"))
    post = tree.after_update(update, LR)
    assert not any(k.startswith("dyn/update_ratio/") for k in pre)
    assert set(post) == {f"dyn/update_ratio/{m}" for m in tree.modules} | {"dyn/update_ratio/total"}
    for v in {**pre, **post}.values():
        assert isinstance(v, torch.Tensor) and v.dim() == 0 and v.dtype == torch.float32


def test_tree_spec_static_gating():
    assert tree_spec({"enabled": False}, {"type": "norm"}) is None
    assert tree_spec({}, {"type": "norm", "threshold": 2.5}) == DynamicsSpec("norm", 2.5)
    assert tree_spec(None, None).clip_type == "none"
    for cfg in ({"enabled": False}, {}, {"every_n": 3}):
        for clip in ({"type": "norm", "threshold": 2.5}, {"type": "value", "threshold": 0.1}, None):
            got, want = tree_spec(cfg, clip), jdyn.tree_spec(cfg, clip)
            assert (got is None) == (want is None)
            if got is not None:
                assert (got.clip_type, got.clip_threshold) == (want.clip_type, want.clip_threshold)


# ----------------------------------------------------------------- monitor
class _FakeIter:
    def __init__(self):
        self.val = 0


class _FakeLearner:
    """The attribute surface DynamicsMonitor touches; its ``state`` is
    written into bundles."""

    def __init__(self, cfg=None):
        self.name = "sllearner"
        self.last_iter = _FakeIter()
        self.cfg = cfg or {"learner": {"batch_size": 2}}
        self.init_prng_seed = 7
        self.state = {"params": {"enc": np.ones((2,), np.float32)}}


def _healthy_log(gn=1.0):
    return {"total_loss": 0.5, "dyn/grad_norm/total": gn, "dyn/grad_norm/enc": gn,
            "dyn/nonfinite_grads/total": 0.0, "dyn/nonfinite_params/total": 0.0}


def _script():
    """A scripted sequence of host logs: healthy steps with RL and SL loss
    info, a NaN loss, an explosion, a collapsing entropy, a census hit."""
    logs = []
    for i in range(8):
        log = _healthy_log(gn=1.0 + 0.1 * i)
        log.update({"dyn/param_norm/enc": 5.0, "dyn/update_ratio/enc": 1e-3, "dyn/clip_fraction": 0.1,
                    "dyn/clip_active": 1.0, "dyn/nonfinite_batch/x": 0.0, "dyn/nonfinite_batch/total": 0.0,
                    "pg/winloss/action_type": 0.3 + i, "pg/build_order/action_type": 0.1,
                    "entropy/action_type": 0.5, "entropy/delay": 0.0, "entropy/total": 0.5,
                    "td/winloss": 0.2, "td/total": 0.2, "kl/extra_at": 0.01, "action_type_loss": 1.5,
                    "divergence": 0.4, "action_type_acc": 0.25})
        logs.append(log)
    logs[3]["total_loss"] = float("nan")
    logs[5]["dyn/grad_norm/total"] = 500.0
    logs[6]["entropy/action_type"] = 1e-4
    logs[7].update({"dyn/nonfinite_grads/total": 2.0, "dyn/nonfinite_grads/enc": 2.0})
    return logs


def test_monitor_publication_equals_jax():
    """The same scripted logs through both monitors: the same anomaly
    classes step by step and the same Prometheus text."""
    cfg = {"every_n": 2, "blackbox": False, "explosion_warmup": 3, "entropy_floor": 1e-3}
    jreg, preg = JRegistry(), MetricsRegistry()
    jmon = jdyn.DynamicsMonitor(cfg, registry=jreg)
    pmon = DynamicsMonitor(cfg, registry=preg)
    learner = _FakeLearner()
    for i, log in enumerate(_script()):
        learner.last_iter.val = i
        assert pmon.on_step(learner, dict(log)) == jmon.on_step(learner, dict(log)), i
        assert pmon.ema == jmon.ema
    text = render_prometheus(preg)
    assert "distar_train_loss_head" in text and "distar_train_entropy" in text
    assert text == jax_prometheus(jreg)


def test_monitor_freq_gates_export_not_detection():
    """every_n gates gauge EXPORT only; anomaly steps force-publish; the
    healthy path reads nothing of the learner's state."""
    class NoState(_FakeLearner):
        def __getattribute__(self, name):
            if name == "state":  # pragma: no cover - failure path
                raise AssertionError("on_step touched the learner state on the healthy path")
            return object.__getattribute__(self, name)

    reg = MetricsRegistry()
    mon = DynamicsMonitor({"every_n": 3, "blackbox": False}, registry=reg)
    learner = NoState()
    gauge = reg.gauge("distar_train_grad_norm", "per-module gradient global-norm", module="total")
    assert mon.on_step(learner, _healthy_log(gn=1.0)) == set()
    assert gauge.value == 1.0
    learner.last_iter.val = 1
    assert mon.on_step(learner, _healthy_log(gn=2.0)) == set()
    assert gauge.value == 1.0
    learner.last_iter.val = 2
    bad = _healthy_log(gn=3.0)
    bad["total_loss"] = float("nan")
    assert mon.on_step(learner, bad) == {"loss_nonfinite"}
    assert gauge.value == 3.0
    assert mon.steps_seen == 3 and mon.ema is not None


def test_monitor_disabled_is_inert():
    reg = MetricsRegistry()
    mon = DynamicsMonitor({"enabled": False}, registry=reg)
    log = _healthy_log()
    log["total_loss"] = float("nan")
    assert mon.on_step(_FakeLearner(), log) == set()
    assert mon.steps_seen == 0 and "distar_train_grad_norm" not in str(reg.snapshot())


def test_monitor_explosion_needs_warmup_and_ema():
    reg = MetricsRegistry()
    mon = DynamicsMonitor({"every_n": 1, "blackbox": False, "explosion_warmup": 5,
                           "explosion_factor": 10.0}, registry=reg)
    learner = _FakeLearner()
    for i in range(5):
        learner.last_iter.val = i
        assert mon.on_step(learner, _healthy_log(gn=1.0)) == set()
    learner.last_iter.val = 5
    assert mon.on_step(learner, _healthy_log(gn=50.0)) == {"grad_explosion"}
    snap = reg.snapshot()
    assert snap["distar_train_last_anomaly_step"] == 5.0
    assert snap["distar_train_anomalies_total{reason=grad_explosion}"] == 1.0


def test_monitor_debounce_capture_and_bundle_crosses_packages(tmp_path):
    """Debounce, re-arm and cap as the JAX monitor; the port's bundle loads
    with the JAX package's ``load_bundle`` to the same content."""
    reg = MetricsRegistry()
    mon = DynamicsMonitor({"every_n": 1, "blackbox_cap": 2, "clear_n": 2}, registry=reg,
                          blackbox_dir=str(tmp_path))
    learner = _FakeLearner(cfg={"learner": {"batch_size": 2, "dynamics": {"every_n": 1}}})
    learner.state = {"params": {"enc": np.ones((2,), np.float32)},
                     "opt_state": ((), ((np.zeros((), np.int32), {"enc": np.zeros(2, np.float32)}),))}
    batch = {"x": torch.tensor([1.0, float("nan")]), "_on_device": True}
    bad = _healthy_log()
    bad.update({"dyn/nonfinite_grads/total": 3.0, "dyn/nonfinite_grads/enc": 3.0,
                "dyn/nonfinite_batch/x": 1.0, "dyn/nonfinite_batch/total": 1.0})
    learner.last_iter.val = 4
    assert mon.on_step(learner, bad, batch) == {"grad_nonfinite"}
    learner.last_iter.val = 5
    mon.on_step(learner, bad, batch)  # still active: debounced
    assert [(b["step"], b["reason"]) for b in list_bundles(str(tmp_path))] == [(4, "grad_nonfinite")]
    for i in range(6, 8):
        learner.last_iter.val = i
        assert mon.on_step(learner, _healthy_log(), batch) == set()
    learner.last_iter.val = 8
    mon.on_step(learner, bad, batch)
    for i in range(9, 11):
        learner.last_iter.val = i
        mon.on_step(learner, _healthy_log(), batch)
    learner.last_iter.val = 11
    mon.on_step(learner, bad, batch)  # cap 2: the third writes nothing
    assert len(list_bundles(str(tmp_path))) == 2
    assert list_bundles(str(tmp_path)) == jdyn.list_bundles(str(tmp_path))
    assert reg.snapshot()["distar_train_blackbox_bundles_total"] == 2.0

    path = list_bundles(str(tmp_path))[0]["path"]
    bundle, jbundle = load_bundle(path), jdyn.load_bundle(path)
    assert bundle_keys(bundle) == bundle_keys(jbundle)
    assert jdyn.bundle_summary(jbundle) == jdyn.bundle_summary(bundle)
    assert jbundle["schema"] == "distar.blackbox.v1" and jbundle["step"] == 4
    assert jbundle["provenance"] == {"origin": "batch", "module": "x", "all": ["x"]}
    np.testing.assert_array_equal(jbundle["batch"]["x"], np.array([1.0, np.nan], np.float32))
    assert jbundle["batch"]["_on_device"] is True
    assert jbundle["config_digest"] == jdyn.config_digest(jbundle["config"]) == config_digest(bundle["config"])
    assert jbundle["diagnostics"]["dyn/nonfinite_grads/total"] == 3.0


def bundle_keys(bundle):
    return sorted(bundle)


def test_capture_failure_never_raises(tmp_path):
    blocked = tmp_path / "file"
    blocked.write_text("not a dir")
    mon = DynamicsMonitor({"every_n": 1}, registry=MetricsRegistry(), blackbox_dir=str(blocked))
    bad = _healthy_log()
    bad["total_loss"] = float("nan")
    assert mon.on_step(_FakeLearner(), bad, {"x": np.ones(2)}) == {"loss_nonfinite"}
    assert mon.bundles_written == 0 and mon.last_bundle_path is None


def test_rulebook_fires_once_with_bundle_exemplar(tmp_path):
    """anomaly -> capture (exemplar under the rule-watched family) ->
    sampler -> evaluator firing exactly once with blackbox:<bundle>."""
    reg = MetricsRegistry()
    mon = DynamicsMonitor({"every_n": 1}, registry=reg, blackbox_dir=str(tmp_path))
    fh = FleetHealth(rules=default_rulebook(roles=("learner",)), registry=reg)
    learner = _FakeLearner()
    bad = _healthy_log()
    bad.update({"dyn/nonfinite_grads/total": 2.0, "dyn/nonfinite_grads/enc": 2.0})
    mon.on_step(learner, bad, {"x": np.ones(2, np.float32)})
    fh.sampler.sample_once()
    fh.evaluator.evaluate_once()
    alerts = fh.evaluator.alerts()
    assert alerts["rules"]["learner_grad_nonfinite"]["state"] == "firing"
    firing = [e for e in alerts["history"] if e["rule"] == "learner_grad_nonfinite" and e["state"] == "firing"]
    assert firing[0].get("exemplar_trace_id") == f"blackbox:{list_bundles(str(tmp_path))[0]['id']}"
    for i in range(1, 5):
        learner.last_iter.val = i
        mon.on_step(learner, _healthy_log())
        fh.sampler.sample_once()
        fh.evaluator.evaluate_once()
    alerts = fh.evaluator.alerts()
    assert alerts["rules"]["learner_grad_nonfinite"]["fired_count"] == 1
    assert "learner_grad_nonfinite" not in alerts["firing"]


def test_defaults_are_the_jax_learners():
    assert DYNAMICS_DEFAULTS == jdyn.DYNAMICS_DEFAULTS
    assert dict(DEFAULT_LEARNER_CONFIG["learner"]["dynamics"]) == jdyn.DYNAMICS_DEFAULTS
    from distar_tpu.learner.base_learner import DEFAULT_LEARNER_CONFIG as JCFG

    for block in ("perf", "profile", "dynamics"):
        assert dict(DEFAULT_LEARNER_CONFIG["learner"][block]) == dict(JCFG["learner"][block]), block


# ------------------------------------------------------ a real SL learner
def test_sl_learner_dynamics_end_to_end(tmp_path, monkeypatch):
    """The clip's activation through the tree, one host copy a step, a
    poisoned parameter -> one bundle naming its module -> the port's
    stepreplay reproducing the step bit for bit from the bundle alone."""
    from distar_tpu_torch.learner import sl_learner
    from distar_tpu_torch.obs import get_registry
    from distar_tpu_torch.resilience.chaos import ChaosInjector

    monkeypatch.setenv("DISTAR_EXPERIMENTS_ROOT", str(tmp_path))
    learner = SLLearner({"common": {"save_path": str(tmp_path / "exp")},
                         "learner": {"batch_size": B, "unroll_len": T, "save_freq": 10 ** 6, "log_freq": 1,
                                     "grad_clip": {"type": "norm", "threshold": 0.05},
                                     "dynamics": {"every_n": 1, "blackbox_cap": 2}},
                         "model": SMALL_MODEL}, device="cpu")
    copies = []
    real = sl_learner.host_scalars
    monkeypatch.setattr(sl_learner, "host_scalars", lambda info: copies.append(1) or real(info))
    learner.run(2)
    assert len(copies) == 2  # the tree rides the step's one stacked copy
    log = learner.last_log
    gn = log["dyn/grad_norm/total"]
    assert gn > 0.05 and log["dyn/clip_active"] == 1.0
    assert log["dyn/clip_fraction"] == pytest.approx(1.0 - 0.05 / gn, rel=1e-5)
    np.testing.assert_allclose(gn, log["grad_norm"], rtol=1e-5)
    assert get_registry().snapshot()["distar_train_grad_clip_active"] == 1.0

    inj = ChaosInjector()
    inj.poison_module(learner, "core_lstm", n=1)
    learner.run(3)
    inj.restore()
    bundles = list_bundles(str(tmp_path / "exp" / "blackbox"))
    assert len(bundles) == 1
    bundle = load_bundle(bundles[0]["path"])
    assert bundle["provenance"]["origin"] == "params" and bundle["provenance"]["module"] == "core_lstm"
    assert jdyn.load_bundle(bundles[0]["path"])["provenance"] == bundle["provenance"]
    verdict = stepreplay.replay(bundle, params_from="bundle", runs=2, device="cpu")
    assert verdict["deterministic"] is True and verdict["nonfinite_reproduced"] is True
    assert verdict["provenance_confirmed"] is True
    assert verdict["ok"] is True and verdict["config_digest_drift"] is False


def test_stepreplay_cli_exit_code_and_json(tmp_path, monkeypatch, capsys):
    """``python -m distar_tpu_torch.tools.stepreplay --json`` prints the
    verdict's JAX keys and exits 0 on a faithful bundle."""
    from distar_tpu_torch.resilience.chaos import ChaosInjector

    monkeypatch.setenv("DISTAR_EXPERIMENTS_ROOT", str(tmp_path))
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)  # main sets it
    learner = SLLearner({"common": {"save_path": str(tmp_path / "exp")},
                         "learner": {"batch_size": B, "unroll_len": T, "save_freq": 10 ** 6, "log_freq": 10,
                                     "dynamics": {"every_n": 1}}, "model": SMALL_MODEL}, device="cpu")
    inj = ChaosInjector()
    inj.poison_module(learner, "policy", n=1)
    learner.run(1)
    inj.restore()
    path = list_bundles(str(tmp_path / "exp" / "blackbox"))[0]["path"]
    capsys.readouterr()
    assert stepreplay.main(["--bundle", path, "--device", "cpu", "--json",
                            "--workdir", str(tmp_path / "replay")]) == 0
    import json

    verdict = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"nonfinite_reproduced", "provenance_confirmed", "deterministic", "ok"} <= set(verdict)
    assert verdict["ok"] is True and verdict["device"] == "cpu"
    assert os.environ.get("CUBLAS_WORKSPACE_CONFIG") == ":4096:8"
