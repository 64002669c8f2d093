"""The port's SL learner runtime against the JAX package's, on the CPU.

One JAX ``SLLearner`` at SMALL_MODEL (2 x 3, the SL defaults: adamw, a
global-norm clip) is built for the module: it trains 2 steps and saves;
the port's ``SLLearner(device="cpu")`` restores that checkpoint bit for bit
and takes the next step beside the JAX learner's on the same batch; the
port's checkpoint of that step is restored by the JAX learner (its leaf
check passes) bit for bit and both take one more step. The next batch
restarts every trajectory, since a checkpoint holds no LSTM carry.
Tolerances are tests/test_torch_train.py's for a full step: loss, info
and grad_norm rtol 1e-4 (atol 1e-6), and the gradient, read back from the
new Adam moments, within 1e-4 of its global norm; each package's new
parameters are the adamw update of its own moments (``assert_steps_agree``).
``evaluate`` is held at the step's tolerance on the same parameters.
The JAX and port dataloaders give identical batches from one dataset, and
the two packages write identical dataset files. Either package's
``ReplayActor`` feeds the other's ``RemoteSLDataloader`` bit-equal, and
``bin/sl_train.py --remote`` trains on such a feed.
"""
import glob
import json
import os
import signal
import threading
import time

import jax
import numpy as np
import pytest
import torch
from conftest import SMALL_MODEL

from distar_tpu.learner import SLLearner as JSLLearner
from distar_tpu.learner import sl_dataloader as jsl
from distar_tpu_torch.bin import sl_train
from distar_tpu_torch.comm.serializer import loads
from distar_tpu_torch.learner import SLLearner, random_sl_batch
from distar_tpu_torch.learner import sl_dataloader as psl
from distar_tpu_torch.obs import MetricsRegistry, set_registry
from distar_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

B, T = 2, 3
LR = 1e-3  # SL_LEARNER_DEFAULTS' learning rate, both packages
STEP_TOL = dict(rtol=1e-4, atol=1e-6)


def _cfg(root, **learner):
    return {"common": {"save_path": str(root)},
            "learner": {"batch_size": B, "unroll_len": T, "save_freq": 10 ** 9, "log_freq": 10 ** 9,
                        **learner},
            "model": SMALL_MODEL}


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_leaves(v, prefix + (str(k),)))
    return out


def assert_states_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg="/".join(k))


B1, B2, EPS, WD = 0.9, 0.999, 1e-8, 1e-5  # SL_LEARNER_DEFAULTS' adamw, both packages
# optax corrects Adam's bias in f32: 1 - 0.999^n rounds about 2e-5 off at n = 3
BIAS_TOL = 2e-5


def _adam(state):
    """(params, mu, nu, count) of an SL learner state in the JAX layout."""
    count, mu, nu = state["opt_state"][1][0]
    return _leaves(state["params"]), _leaves(mu), _leaves(nu), int(np.asarray(count))


def assert_steps_agree(got_log, want_log, got_state, want_state, before):
    """The step's scalars within STEP_TOL; the clipped gradients the two
    steps folded into ``mu`` within 1e-4 of the JAX one's global norm
    (tests/test_torch_train.py's gradient tolerance); and each package's
    new parameters the adamw update of its own new moments."""
    assert set(got_log) == set(want_log)
    for k, w in want_log.items():
        np.testing.assert_allclose(got_log[k], w, **STEP_TOL, err_msg=k)
    p0, mu0, _, n0 = _adam(before)
    grads = []
    for state in (got_state, want_state):
        p, mu, nu, n = _adam(state)
        assert n == n0 + 1
        grads.append({k: (mu[k].astype(np.float64) - B1 * mu0[k]) / (1 - B1) for k in mu})
        for k in p:
            u = (mu[k] / (1 - B1 ** n)) / (np.sqrt(nu[k].astype(np.float64) / (1 - B2 ** n)) + EPS)
            want = p0[k] - LR * (u + WD * p0[k])
            np.testing.assert_allclose(p[k], want, rtol=1e-5, atol=BIAS_TOL * LR, err_msg="/".join(k))
    got, want = grads
    norm = sum(float((w ** 2).sum()) for w in want.values()) ** 0.5
    err = sum(float(((got[k] - w) ** 2).sum()) for k, w in want.items()) ** 0.5
    assert 0 < norm <= 1.0 + 1e-5 and err <= 1e-4 * norm  # the clip's threshold is 1.0


def _jax_state(learner):
    return jax.tree.map(np.asarray, learner.state)


@pytest.fixture(scope="module")
def cross(tmp_path_factory):
    """JAX -> port -> JAX, one step beside the other at each crossing."""
    root = tmp_path_factory.mktemp("sl_cross")
    rng = np.random.default_rng(21)
    batches = [random_sl_batch(B, T, rng) for _ in range(4)]
    for b in batches[2:]:
        b["new_episodes"][:] = True
    jl = JSLLearner(_cfg(root / "jax"))
    for b in batches[:2]:
        jl._train(b)
    jl.last_iter.update(2)
    jpath = str(root / "jax_iteration_2.ckpt")
    jl.save(jpath, sync=True)
    pl = SLLearner(_cfg(root / "port"), device="cpu")
    pl.restore(jpath)
    out = {"jax_saved": _jax_state(jl), "port_restored": pl.state, "port_iter": pl.last_iter.val}
    out["jax_log3"], out["port_log3"] = jl._train(batches[2]), pl._train(batches[2])
    out["jax_state3"], out["port_state3"] = _jax_state(jl), pl.state
    ppath = str(root / "port_iteration_3.ckpt")
    pl.last_iter.update(3)
    pl.save(ppath, sync=True)
    jl.restore(ppath)
    out["jax_restored"] = _jax_state(jl)
    # held-out metrics on the same parameters
    ds = psl.make_fake_dataset(str(root / "eval"), n_trajectories=2, steps_per_traj=5, seed=4)
    out["jax_eval"] = jl.evaluate(jsl.SLDataloader(jsl.ReplayDataset(ds.root), B, T, seed=2), max_batches=2)
    out["port_eval"] = pl.evaluate(psl.SLDataloader(ds, B, T, seed=2), max_batches=2)
    out["jax_log4"], out["port_log4"] = jl._train(batches[3]), pl._train(batches[3])
    out["jax_state4"], out["port_state4"] = _jax_state(jl), pl.state
    # a NaN in a float observation field: the JAX learner's monitor writes
    # its black-box bundle (the step is the one compiled above)
    poisoned = {k: v for k, v in batches[0].items()}
    poisoned["entity_info"] = dict(poisoned["entity_info"])
    key = next(k for k in sorted(poisoned["entity_info"])
               if np.asarray(poisoned["entity_info"][k]).dtype.kind == "f")
    poisoned["entity_info"][key] = np.array(poisoned["entity_info"][key], copy=True)
    poisoned["entity_info"][key].reshape(-1)[0] = np.nan
    jl._dynamics.before_step(jl)
    jl._dynamics.on_step(jl, jl._train(poisoned), poisoned)
    out["jax_bundle"] = jl._dynamics.last_bundle_path
    return out


def test_the_port_replays_a_jax_written_bundle(cross, tmp_path, monkeypatch):
    """The JAX SL learner's black-box bundle (its config, optax state, carry
    and batch) loads with the port's ``load_bundle`` and the port's
    stepreplay reproduces the non-finite step on the CPU, the provenance
    (the poisoned batch field) confirmed, two replays bit-equal."""
    from distar_tpu_torch.obs.dynamics import load_bundle
    from distar_tpu_torch.tools import stepreplay

    monkeypatch.setenv("DISTAR_EXPERIMENTS_ROOT", str(tmp_path))
    bundle = load_bundle(cross["jax_bundle"])
    assert bundle["learner"] == "sllearner" and bundle["provenance"]["origin"] == "batch"
    verdict = stepreplay.replay(bundle, params_from="bundle", runs=2, device="cpu")
    assert verdict["nonfinite_reproduced"] is True and verdict["provenance_confirmed"] is True
    assert verdict["deterministic"] is True and verdict["ok"] is True


def test_port_restores_a_jax_sl_checkpoint_bit_for_bit(cross):
    assert_states_equal(cross["port_restored"], cross["jax_saved"])
    assert cross["port_iter"] == 2
    count = cross["port_restored"]["opt_state"][1][0][0]
    assert count.dtype == np.int32 and int(count) == 2


def test_next_step_after_a_jax_checkpoint_matches_jax(cross):
    assert_steps_agree(cross["port_log3"], cross["jax_log3"], cross["port_state3"], cross["jax_state3"],
                       cross["jax_saved"])


def test_jax_restores_a_port_sl_checkpoint_bit_for_bit(cross):
    assert_states_equal(cross["jax_restored"], cross["port_state3"])


def test_next_step_after_a_port_checkpoint_matches_jax(cross):
    assert_steps_agree(cross["port_log4"], cross["jax_log4"], cross["port_state4"], cross["jax_state4"],
                       cross["port_state3"])


def test_evaluate_matches_jax(cross):
    got, want = cross["port_eval"], cross["jax_eval"]
    assert set(got) == set(want) and "total_loss" in got
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, **STEP_TOL, err_msg=k)


def test_evaluate_changes_no_state(tmp_path):
    lrn = SLLearner(_cfg(tmp_path), device="cpu")
    ds = psl.make_fake_dataset(str(tmp_path / "d"), n_trajectories=1, steps_per_traj=4)
    before, hidden = lrn.state, lrn.hidden
    metrics = lrn.evaluate(psl.SLDataloader(ds, B, T), max_batches=2)
    assert all(np.isfinite(v) for v in metrics.values())
    assert_states_equal(lrn.state, before)
    assert lrn.hidden is hidden and lrn.optimizer.count == 0
    assert all(p.grad is None for p in lrn.model.parameters())


def test_a_mismatched_checkpoint_is_refused_naming_leaves(cross, tmp_path):
    bigger = SLLearner({**_cfg(tmp_path), "model": {**SMALL_MODEL, "encoder": {
        **SMALL_MODEL["encoder"], "core_lstm": {"hidden_size": 48, "num_layers": 1}}}}, device="cpu")
    path = str(tmp_path / "small.ckpt")
    ckpt.save_checkpoint(path, cross["port_state3"], metadata={"last_iter": 3})
    before = bigger.state
    with pytest.raises(ckpt.CheckpointMismatchError, match=r"mismatched leaves, e\.g\. params/params/.*"
                                                            r": ckpt \(32, 16\) != state \(48, 16\)"):
        bigger.restore(path)
    assert_states_equal(bigger.state, before)


# ---------------------------------------------------------------- datasets
def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + (k,)) if isinstance(v, dict) else {prefix + (k,): v})
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_dataloaders_give_identical_batches(tmp_path, writer):
    """Trajectories of 5 and 7 steps in windows of 3: refills, padded tails
    and new_episodes, for 6 batches, from a dataset either package wrote."""
    root = str(tmp_path / "d")
    make = jsl.make_fake_dataset if writer == "jax" else psl.make_fake_dataset
    make(root, n_trajectories=3, steps_per_traj=5, seed=8)
    (jsl if writer == "jax" else psl).make_fake_dataset(root + "_long", n_trajectories=1,
                                                        steps_per_traj=7, seed=9)
    os.replace(os.path.join(root + "_long", "fake_0000.traj.zpkl"),
               os.path.join(root, "long_0000.traj.zpkl"))
    want_loader = jsl.SLDataloader(jsl.ReplayDataset(root), B, T, seed=3)
    got_loader = psl.SLDataloader(psl.ReplayDataset(root), B, T, seed=3)
    padded = 0
    for _ in range(6):
        want, got = _flat(next(want_loader)), _flat(next(got_loader))
        assert set(got) == set(want)
        for k, w in want.items():
            assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
            np.testing.assert_array_equal(got[k], w, err_msg="/".join(k))
        padded += int((got[("action_mask", "action_type")] == 0).sum())
    assert padded > 0


def test_both_packages_write_the_same_dataset_bytes(tmp_path):
    jsl.make_fake_dataset(str(tmp_path / "jax"), n_trajectories=2, steps_per_traj=4, seed=5)
    psl.make_fake_dataset(str(tmp_path / "port"), n_trajectories=2, steps_per_traj=4, seed=5)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 2
    for n in names:
        assert (tmp_path / "jax" / n).read_bytes() == (tmp_path / "port" / n).read_bytes(), n


def test_replay_dataset_refuses_an_empty_directory(tmp_path):
    with pytest.raises(FileNotFoundError):
        psl.ReplayDataset(str(tmp_path))


# ------------------------------------------------------- loss-spike guard
def test_sl_loss_spike_guard_snapshots(tmp_path):
    """As tests/test_learner.py's: a term past 10x its EMA after the warm-up
    dumps the step's inputs and a checkpoint; a near-zero EMA does not
    trigger; a non-finite value dumps once a divergence, even unseeded, and
    never enters the EMA; the cap bounds the dumps."""
    learner = SLLearner(_cfg(tmp_path, debug_loss_spike=True, debug_spike_warmup=0), device="cpu")
    learner.run(1)  # primes the EMA from real values

    def spike_files():
        return glob.glob(os.path.join(str(tmp_path), "debug", "*.spike"))

    pre_step = {"batch": {"x": torch.zeros(2)}, "hidden_state": learner.hidden,
                "new_episodes": np.zeros(B, bool), "traj_lens": None}
    base = dict(learner._debug_ema)
    key = next(k for k in base if "loss" in k and base[k] > 0.01)
    log = dict(base)
    log[key] = base[key] * 20 + 1.0
    learner.last_iter.update(5)
    learner._loss_spike_guard(log, pre_step)
    dumps = spike_files()
    assert len(dumps) == 1
    snap = loads(open(dumps[0], "rb").read())
    assert snap["key"] == key and "note" in snap
    np.testing.assert_array_equal(snap["batch"]["x"], np.zeros(2, np.float32))
    assert len(snap["hidden_state"]) == 1 and snap["new_episodes"].shape == (B,)
    assert ckpt.verify_checkpoint(learner.checkpoint_path())
    assert learner._debug_ema[key] == pytest.approx(base[key] * 0.95 + log[key] * 0.05)
    learner._debug_ema[key] = 1e-6
    learner._loss_spike_guard({key: 0.5}, pre_step)
    assert len(spike_files()) == 1
    learner._debug_ema[key] = 2.0
    learner._loss_spike_guard({key: float("nan")}, pre_step)
    learner._loss_spike_guard({key: float("nan")}, pre_step)  # the same divergence
    assert len(spike_files()) == 2 and learner._debug_ema[key] == 2.0
    learner._loss_spike_guard({"fresh_loss": float("inf")}, pre_step)
    assert len(spike_files()) == 3
    learner._debug_dumps = learner._DEBUG_DUMP_CAP
    learner._loss_spike_guard({key: 1e9}, pre_step)
    assert len(spike_files()) == 3


def test_a_non_finite_first_step_dumps_through_train(tmp_path):
    learner = SLLearner(_cfg(tmp_path, debug_loss_spike=True), device="cpu")
    batch = random_sl_batch(B, T, np.random.default_rng(3))
    with torch.no_grad():
        next(learner.model.parameters()).fill_(float("nan"))
    log = learner._train(batch)
    assert not np.isfinite(log["total_loss"])
    assert len(glob.glob(os.path.join(str(tmp_path), "debug", "*.spike"))) == 1


# ------------------------------------------------------------------ the bin
@pytest.fixture
def datasets(tmp_path):
    psl.make_fake_dataset(str(tmp_path / "train"), n_trajectories=3, steps_per_traj=7, seed=1)
    psl.make_fake_dataset(str(tmp_path / "held_out"), n_trajectories=2, steps_per_traj=7, seed=2)
    return str(tmp_path / "train"), str(tmp_path / "held_out")


def _argv(save, data, iters, *extra):
    return ["--device", "cpu", "--iters", str(iters), "--batch-size", "2", "--traj-len", "3",
            "--data", data, "--save-path", save, *extra]


def test_bin_trains_on_data_prints_eval_and_resumes(tmp_path, capsys, datasets):
    """EVAL lines at their cadence, the pointer's generations verified; a
    second start resumes at the newest, a third past a torn one."""
    data, held_out = datasets
    save = str(tmp_path / "run")
    sl_train.main(_argv(save, data, 4, "--eval-data", held_out, "--eval-freq", "2", "--eval-batches", "1",
                        "--config", json.dumps({"learner": {"log_freq": 1, "save_freq": 2}})))
    out = capsys.readouterr().out
    assert "sl_train resume: cold iter 0 skipped 0" in out and "sl_train done: 4 iters" in out
    assert 'launches={"masked_attention": 0' in out  # the plain versions on the CPU
    evals = [json.loads(ln[5:]) for ln in out.splitlines() if ln.startswith("EVAL ")]
    assert [e["iter"] for e in evals] == [2, 4] and all(np.isfinite(e["total_loss"]) for e in evals)
    logs = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    assert [lg["iter"] for lg in logs] == [1, 2, 3, 4]
    pointer = json.load(open(os.path.join(save, "checkpoints", "latest.json")))
    assert [g["step"] for g in pointer["generations"]] == [4, 2]
    assert all(ckpt.verify_checkpoint(g["path"]) for g in pointer["generations"])
    sl_train.main(_argv(save, data, 6, "--config", json.dumps({"learner": {"log_freq": 1}})))
    out = capsys.readouterr().out
    assert f"sl_train resume: {os.path.join(save, 'checkpoints', 'iteration_4.ckpt')} iter 4 skipped 0" in out
    logs = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    assert [lg["iter"] for lg in logs] == [5, 6] and "sl_train done: 6 iters" in out
    newest = os.path.join(save, "checkpoints", "iteration_6.ckpt")
    with open(newest, "r+b") as f:  # a torn newest generation
        f.truncate(1000)
    sl_train.main(_argv(save, data, 5, "--config", json.dumps({"learner": {"log_freq": 1}})))
    out = capsys.readouterr().out
    assert f"sl_train resume: {os.path.join(save, 'checkpoints', 'iteration_4.ckpt')} iter 4 skipped 1" in out
    assert "sl_train done: 5 iters" in out


class FlakyLoader:
    """An SL dataloader whose ``fail_at``-th batch raises once."""

    def __init__(self, inner, fail_at):
        self.inner, self.fail_at, self.n = inner, fail_at, 0

    def __iter__(self):
        return self

    def __next__(self):
        self.n += 1
        if self.n == self.fail_at:
            raise RuntimeError("replay shard unavailable")
        return next(self.inner)


def test_bin_survives_a_dataloader_crash_and_resumes(tmp_path, capsys, datasets):
    registry = MetricsRegistry()
    prev = set_registry(registry)
    try:
        data, _ = datasets
        args = sl_train.parser().parse_args(_argv(str(tmp_path / "run"), data, 5, "--restart-max", "2"))
        loader = FlakyLoader(psl.SLDataloader(psl.ReplayDataset(data), 2, 3), fail_at=4)
        lrn = sl_train.learner(args, loader)
    finally:
        set_registry(prev)
    out = capsys.readouterr().out
    assert "learner restart after RuntimeError('replay shard unavailable')" in out
    assert lrn.last_iter.val == 5 and "sl_train done: 5 iters" in out
    snap = registry.snapshot()
    assert snap["distar_resilience_restarts_total{task=learner}"] == 1
    assert snap["distar_resilience_resumes_total"] == 1  # from the crash save
    assert os.path.exists(str(tmp_path / "run" / "checkpoints" / "iteration_5.ckpt"))


def test_bin_coordinator_role_serves_until_sigterm(capsys):
    before = signal.getsignal(signal.SIGTERM)

    def stop_once_serving():  # SIGTERM only once the role's handler is in
        while signal.getsignal(signal.SIGTERM) is before:
            time.sleep(0.01)
        os.kill(os.getpid(), signal.SIGTERM)

    stopper = threading.Thread(target=stop_once_serving, daemon=True)
    stopper.start()
    sl_train.main(["--type", "coordinator", "--coordinator-addr", "127.0.0.1:0"])
    stopper.join(timeout=10)
    assert not stopper.is_alive()
    assert "coordinator serving on 127.0.0.1:" in capsys.readouterr().out
    assert signal.getsignal(signal.SIGTERM) is before


class StubDecoder:
    """The replay decoder's surface: ``run(path, player_idx)`` gives a
    trajectory of SL steps (``fake_step_data`` with its action fields, from
    a seeded generator) whatever the path."""

    def __init__(self, seed=0, steps=8):
        self.rng, self.steps, self.calls = np.random.default_rng(seed), steps, []

    def run(self, path, player_idx):
        from distar_tpu.lib import features as JF

        self.calls.append((path, player_idx))
        return [JF.fake_step_data(train=True, rng=self.rng) for _ in range(self.steps)]


class ListLoader(psl.SLDataloader):
    """``SLDataloader``'s batching over trajectories from a list."""

    def __init__(self, trajs, batch_size, unroll_len):
        self.batch_size, self.unroll_len, self._trajs = batch_size, unroll_len, list(trajs)
        self._slots = [[] for _ in range(batch_size)]
        self._fresh = [True] * batch_size

    def _refill(self, slot):
        self._slots[slot], self._fresh[slot] = list(self._trajs.pop(0)), True


@pytest.mark.parametrize("actor_pkg,loader_pkg", [("port", "jax"), ("jax", "port")])
def test_replay_actor_feeds_the_other_packages_remote_loader(actor_pkg, loader_pkg):
    """A ``ReplayActor`` with a stub decoder pushes both players of two
    replays on one coordinator; the other package's ``RemoteSLDataloader``
    pulls them into batches bit-equal to ``SLDataloader``'s batching of
    the decoder's trajectories in push order."""
    import importlib

    from distar_tpu_torch.comm import CoordinatorServer

    actor_mod = importlib.import_module(("distar_tpu_torch" if actor_pkg == "port" else "distar_tpu")
                                        + ".learner.replay_actor")
    loader_mod = importlib.import_module(("distar_tpu_torch" if loader_pkg == "port" else "distar_tpu")
                                         + ".learner.replay_actor")
    adapter_cls = {p: importlib.import_module(("distar_tpu_torch" if p == "port" else "distar_tpu")
                                              + ".comm").Adapter for p in ("port", "jax")}
    assert actor_mod.expand_replay_list(["a", "b", "c"], epochs=2, ntasks=2, proc_id=1) == \
        __import__("distar_tpu.learner.replay_actor", fromlist=["x"]).expand_replay_list(
            ["a", "b", "c"], epochs=2, ntasks=2, proc_id=1)
    co = CoordinatorServer()
    co.start()
    try:
        addr = (co.host, co.port)
        decoder = StubDecoder(seed=3)
        made = []
        real_run = decoder.run
        decoder.run = lambda path, idx: made.append(real_run(path, idx)) or made[-1]
        actor = actor_mod.ReplayActor(["a.SC2Replay", "b.SC2Replay"],
                                      adapter_factory=lambda: adapter_cls[actor_pkg](coordinator_addr=addr),
                                      decoder_factory=lambda: decoder, num_workers=1, ntasks=1, proc_id=0)
        actor.run()
        assert actor.pushed == 4 and actor.failed == actor.empty == 0
        assert sorted(decoder.calls) == [("a.SC2Replay", 0), ("a.SC2Replay", 1), ("b.SC2Replay", 0),
                                         ("b.SC2Replay", 1)]
        loader = loader_mod.RemoteSLDataloader(adapter_cls[loader_pkg](coordinator_addr=addr), batch_size=2,
                                               unroll_len=4, pull_timeout=30.0)
        want = ListLoader(made, batch_size=2, unroll_len=4)
        for _ in range(4):  # both windows of the four trajectories
            assert_tree_equal_np(next(loader), next(want))
    finally:
        co.stop()


def assert_tree_equal_np(got, want):
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w)
    for k in w:
        assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=k)


def test_bin_trains_on_a_remote_feed(tmp_path, capsys, monkeypatch):
    """``sl_train --remote``: the learner pulls, over the coordinator at
    ``--coordinator-addr``, the trajectories a ``ReplayActor`` pushes, and
    trains 2 steps."""
    from distar_tpu_torch.comm import Adapter, CoordinatorServer
    from distar_tpu_torch.learner.replay_actor import ReplayActor, RemoteSLDataloader

    monkeypatch.setenv("DISTAR_EXPERIMENTS_ROOT", str(tmp_path))
    co = CoordinatorServer()
    co.start()
    try:
        addr = (co.host, co.port)
        ReplayActor(["a.SC2Replay", "b.SC2Replay"], adapter_factory=lambda: Adapter(coordinator_addr=addr),
                    decoder_factory=lambda: StubDecoder(seed=4), ntasks=1, proc_id=0).run()
        lrn = sl_train.main(["--remote", "--coordinator-addr", f"{co.host}:{co.port}", "--device", "cpu",
                             "--iters", "2", "--batch-size", "2", "--traj-len", "4", "--no-supervise"])
        out = capsys.readouterr().out
        assert "sl_train done: 2 iters" in out, out[-2000:]
        assert isinstance(lrn._dataloader.source if hasattr(lrn._dataloader, "source") else lrn._dataloader,
                          RemoteSLDataloader)
        assert np.isfinite(lrn.last_log["total_loss"])
        # the learner's prefetcher reads past the 2 steps and waits inside a
        # pull on this coordinator; a thread left polling it after it stops
        # retries into the metrics of whatever test runs next in this
        # process. Close the prefetcher, feed its pending pull and see it end.
        prefetcher = lrn._dataloader
        prefetcher.close()
        ReplayActor(["c.SC2Replay", "d.SC2Replay"], adapter_factory=lambda: Adapter(coordinator_addr=addr),
                    decoder_factory=lambda: StubDecoder(seed=5), ntasks=1, proc_id=0).run()
        prefetcher._thread.join(timeout=60)
        assert not prefetcher._thread.is_alive()
    finally:
        co.stop()


@pytest.mark.parametrize("argv,item", [
    (["--mesh", "dp=2", "--no-health"], "does not factor")])
def test_bin_parts_not_ported_name_their_item(argv, item):
    """``--mesh`` (item 7, ported) refuses dp=2 on a world of one process,
    typed."""
    from distar_tpu_torch.parallel import MeshConfigError
    from distar_tpu_torch.parallel.dist import dist_close

    try:
        with pytest.raises(MeshConfigError if "--mesh" in argv else NotImplementedError, match=item):
            sl_train.main(argv + ["--device", "cpu"])
    finally:
        dist_close()


def test_bin_dynamics_every_sets_the_export_stride(tmp_path):
    """``--dynamics-every 1``: the learner's tree on, exported every step."""
    lrn = sl_train.main(["--type", "learner", "--iters", "1", "--smoke-model", "--device", "cpu",
                         "--batch-size", "2", "--traj-len", "2", "--no-health", "--save-path", str(tmp_path),
                         "--dynamics-every", "1"])
    assert lrn._dynamics.every_n == 1 and lrn.cfg.learner.dynamics.enabled
    assert lrn.last_log["dyn/nonfinite_grads/total"] == 0.0
    assert lrn.metrics.snapshot()["distar_train_grad_norm{module=total}"] == pytest.approx(
        lrn.last_log["dyn/grad_norm/total"])
