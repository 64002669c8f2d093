"""The port's ``parallel/`` in one process, against the JAX package's on the
CPU (this process has 8 host devices, tests/conftest.py): ``MeshSpec``,
the batch checks, ``shrink_dp`` and ``assemble_global``'s error give JAX's
results and messages; the placement rule on the port's flax tree gives
JAX's ``param_sharding`` spec string leaf by leaf; sharded checkpoint
directories cross both ways bit for bit (JAX-written from the port's
seeded learner state on two meshes, port-written from one process) with
equal manifests; corrupt shards fail typed and the manager falls back as
JAX's; a restore onto another mesh counts a reshard; a bf16 leaf
round-trips; ``ShardFeeder`` behaves as JAX's; the ring at sp=1 equals
JAX's ring and the plain attention with its gradients; the executor's
report keys are JAX's; ``dist_init``'s methods; the launchers' mesh flags.
Process groups formed here are a world of one on a free port, destroyed
after each test. Tolerances are stated where used.
"""
import ast
import json
import os
import types

import numpy as np
import pytest
import torch

from conftest import SMALL_MODEL
from distar_tpu_torch.parallel import ckpt as tck
from distar_tpu_torch.parallel import mesh as tmesh
from distar_tpu_torch.parallel.dist import dist_close, dist_init

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)  # tiny CPU ops: OpenMP workers only wait on each other
B, T = 2, 1


@pytest.fixture(autouse=True)
def registries():
    """Fresh metric registries of both packages for each test: the
    counters these tests read (shard corruption, reshards, checkpoint
    fallbacks) must not leak into later tests of the process, which read
    the global registry."""
    from distar_tpu import obs as jobs
    from distar_tpu_torch import obs

    prev, jprev = obs.set_registry(obs.MetricsRegistry()), jobs.set_registry(jobs.MetricsRegistry())
    yield
    obs.set_registry(prev)
    jobs.set_registry(jprev)


@pytest.fixture
def group():
    """A gloo world of one, destroyed after the test."""
    dist_init(method="single_node", device="cpu")
    yield
    tmesh.set_context_mesh(None)
    dist_close()


def _grid(**sizes):
    """A mesh's shape without a process group (the pure functions read only
    ``shape`` and ``coords``)."""
    shape = {a: int(sizes.get(a, 1)) for a in tmesh.AXES}
    return types.SimpleNamespace(shape=shape, coords=dict.fromkeys(tmesh.AXES, 0))


def _jax_mesh(**sizes):
    import jax

    from distar_tpu.parallel.mesh import MeshSpec, make_mesh

    n = int(np.prod(list(sizes.values())))
    return make_mesh(MeshSpec(**sizes), jax.devices()[:n])


# ------------------------------------------------------------------- mesh
SPECS = ["dp=4,fsdp=2", "dp=2,fsdp=2,tp=2", "fsdp=2,tp=4", "dp=8", "", "tp=2", "sp=4,dp=2", "dp=3",
         "fsdp=3", "dp=0", "tp=-1", "xp=2", "dp=two", "dp=2,dp=4"]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_meshspec_parse_and_sizes_equal_jax(spec, n):
    from distar_tpu.parallel.mesh import MeshConfigError, MeshSpec

    def outcome(mod_spec, err):
        try:
            s = mod_spec.parse(spec)
        except err as e:
            return ("parse", str(e))
        try:
            return ("sizes", tuple(s.sizes(n)), (s.dp, s.fsdp, s.tp, s.sp))
        except err as e:
            return ("sizes error", str(e))

    assert outcome(tmesh.MeshSpec, tmesh.MeshConfigError) == outcome(MeshSpec, MeshConfigError)


@pytest.mark.parametrize("sizes,batch", [({"dp": 4, "fsdp": 2}, 8), ({"dp": 4, "fsdp": 2}, 6),
                                         ({"dp": 8}, 4), ({"dp": 2, "tp": 4}, 3), ({"dp": 1}, 5)])
def test_batch_checks_and_shrink_dp_equal_jax(sizes, batch):
    from distar_tpu.parallel.mesh import MeshConfigError, batch_sharding, check_batch_divisible, shrink_dp

    jm = _jax_mesh(**sizes)

    def err(fn, *a, **kw):
        try:
            fn(*a, **kw)
            return None
        except (MeshConfigError, tmesh.MeshConfigError) as e:
            return str(e)

    grid = _grid(**sizes)
    assert err(tmesh.check_batch_divisible, grid, batch) == err(check_batch_divisible, jm, batch)
    assert err(tmesh.batch_sharding, grid, batch_size=batch) == err(batch_sharding, jm, batch_size=batch)
    want = dict(shrink_dp(jm, batch).shape)
    assert dict(zip(tmesh.AXES, tmesh.shrunk_spec(grid.shape, batch).sizes(
        int(np.prod(list(want.values())))))) == want
    assert str(tmesh.batch_sharding(grid)) == str(batch_sharding(jm).spec)
    assert str(tmesh.time_batch_sharding(grid)) == str(__import__(
        "distar_tpu.parallel.mesh", fromlist=["x"]).time_batch_sharding(jm).spec)


@pytest.mark.parametrize("shape,spec", [((5, 3), ("dp",)), ((3, 6), (None, ("dp", "fsdp"))),
                                        ((6, 5), (("dp", "fsdp"),)), ((5,), ("sp",))])
def test_assemble_global_error_equals_jax(shape, spec):
    from jax.sharding import NamedSharding, PartitionSpec as P

    from distar_tpu.parallel.feeder import assemble_global
    from distar_tpu.parallel.mesh import MeshConfigError
    from distar_tpu_torch.parallel.feeder import assemble_global as t_assemble

    jm = _jax_mesh(dp=2, fsdp=2, sp=2)
    x = np.zeros(shape, np.float32)
    with pytest.raises(MeshConfigError) as want:
        assemble_global(x, NamedSharding(jm, P(*spec)))
    with pytest.raises(tmesh.MeshConfigError) as got:
        t_assemble(x, tmesh.NamedSharding(_grid(dp=2, fsdp=2, sp=2), spec))
    assert str(got.value) == str(want.value)


def test_assemble_global_takes_this_ranks_block():
    """Row-major over the named axes, as JAX splits: (dp=1, fsdp=1) of a
    2 x 2 extent is block 3."""
    from distar_tpu_torch.parallel.feeder import assemble_global

    grid = _grid(dp=2, fsdp=2)
    grid.coords.update(dp=1, fsdp=1)
    x = np.arange(16).reshape(8, 2)
    got = assemble_global(x, tmesh.NamedSharding(grid, (("dp", "fsdp"),)))
    np.testing.assert_array_equal(got, x[6:8])
    assert assemble_global(x, tmesh.NamedSharding(grid, (("dp", "fsdp"),)), local=True) is x


def _learner(mesh=None, **lc):
    from distar_tpu_torch.learner import RLLearner

    return RLLearner({"learner": {"batch_size": B, "unroll_len": T, "prefetch_depth": 0, **lc},
                      "model": SMALL_MODEL}, device="cpu", mesh=mesh)


@pytest.fixture(scope="module")
def stepped():
    """A seeded SMALL_MODEL learner after one step (mu and nu not zero):
    its state in flax layouts."""
    lrn = _learner()
    lrn._train(next(lrn._dataloader))
    return lrn.state


@pytest.mark.parametrize("sizes", [{"dp": 8}, {"dp": 4, "fsdp": 2}, {"dp": 2, "fsdp": 2, "tp": 2},
                                   {"fsdp": 2, "tp": 4}])
def test_placement_rule_gives_jax_specs_leaf_by_leaf(stepped, sizes):
    import jax

    from distar_tpu.parallel.mesh import param_sharding

    want = [str(s.spec) for s in jax.tree.leaves(param_sharding(_jax_mesh(**sizes), stepped))]
    got = [str(s) for s in jax.tree.leaves(tmesh.param_sharding(_grid(**sizes), stepped),
                                           is_leaf=lambda x: isinstance(x, tmesh.NamedSharding))]
    assert len(got) == len(want) > 100 and got == want
    if sizes.get("tp", 1) > 1:
        assert any("'tp'" in s for s in got)


# ------------------------------------------------------------ checkpoints
def _leaves(state):
    import jax

    return [np.asarray(x) for x in jax.tree.leaves(state)]


def _bit_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(x.shape == y.shape and x.dtype == y.dtype
                                      and np.array_equal(x.reshape(-1).view(np.uint8), y.reshape(-1).view(np.uint8))
                                      for x, y in zip(la, lb))


def _jax_save(path, state, mesh, step=0):
    import jax

    from distar_tpu.parallel import ckpt as jck
    from distar_tpu.parallel.mesh import param_sharding

    placed = jax.tree.map(jax.device_put, state, param_sharding(mesh, state))
    jck.save_sharded(path, placed, {"last_iter": step})


@pytest.mark.parametrize("sizes", [{"dp": 4, "fsdp": 2}, {"dp": 2, "fsdp": 2, "tp": 2}])
def test_jax_written_directory_restores_into_the_port_bit_equal(stepped, tmp_path, sizes):
    """Built from the port's seeded state (no JAX learner compiled); the
    restore onto the port's one-device layout counts a reshard."""
    from distar_tpu_torch.obs import get_registry

    path = str(tmp_path / "iteration_3.ckpt")
    _jax_save(path, stepped, _jax_mesh(**sizes), step=3)
    lrn = _learner()
    before = get_registry().snapshot().get("distar_ckpt_reshards_total", 0)
    lrn.restore(path)
    assert lrn.last_iter.val == 3
    assert _bit_equal(lrn.state, stepped)
    assert get_registry().snapshot()["distar_ckpt_reshards_total"] == before + 1


def test_port_written_directory_passes_jax_and_manifests_are_equal(stepped, tmp_path):
    """An unmeshed port learner writes what a one-device JAX learner does:
    JAX's ``verify_sharded`` passes, its ``restore_sharded`` gives the
    port's arrays, and the manifests are equal but for ``ts``."""
    from distar_tpu.parallel import ckpt as jck

    lrn = _learner(sharded_ckpt=True)
    lrn._train(next(lrn._dataloader))
    port = str(tmp_path / "port")
    lrn.save(port, sync=True)
    jck.verify_sharded(port)
    assert _bit_equal(jck.restore_sharded(port)["state"], lrn.state)
    jax_dir = str(tmp_path / "jax")
    _jax_save(jax_dir, lrn.state, _jax_mesh(dp=1))
    manifests = [json.load(open(os.path.join(d, "sharding.json"))) for d in (port, jax_dir)]
    for m in manifests:
        m.pop("ts")
    assert manifests[0] == manifests[1]
    assert sorted(os.listdir(port)) == sorted(os.listdir(jax_dir))


def _corrupt(path, how):
    shard = max((f for f in os.listdir(path) if f.endswith(".shard")),
                key=lambda f: os.path.getsize(os.path.join(path, f)))
    fpath = os.path.join(path, shard)
    if how == "missing":
        os.remove(fpath)
        return
    data = bytearray(open(fpath, "rb").read())
    if how == "flipped":
        data[len(data) // 2] ^= 0x01
    else:
        data = data[: len(data) - 7]
    open(fpath, "wb").write(bytes(data))


@pytest.mark.parametrize("how", ["flipped", "truncated", "missing"])
def test_corrupt_shards_fail_typed_count_as_jax_and_the_manager_falls_back(stepped, tmp_path, how):
    from distar_tpu import obs as jobs
    from distar_tpu.parallel import ckpt as jck
    from distar_tpu.utils.checkpoint import CheckpointCorruptError as JaxCorrupt
    from distar_tpu_torch.obs import get_registry
    from distar_tpu_torch.utils.checkpoint import (CheckpointCorruptError, CheckpointManager,
                                                   load_checkpoint, verify_checkpoint)

    ckdir = tmp_path / "checkpoints"
    old, new = str(ckdir / "iteration_1.ckpt"), str(ckdir / "iteration_2.ckpt")
    tck.save_sharded(old, stepped, {"last_iter": 1}, mesh=tmesh.ONE_DEVICE)
    tck.save_sharded(new, stepped, {"last_iter": 2}, mesh=tmesh.ONE_DEVICE)
    manager = CheckpointManager(str(ckdir))
    manager.record(old, 1)
    manager.record(new, 2)
    _corrupt(new, how)
    key = "distar_ckpt_shard_corrupt_total"
    counts = [get_registry().snapshot().get(key, 0), jobs.get_registry().snapshot().get(key, 0)]
    with pytest.raises(CheckpointCorruptError):
        tck.verify_sharded(new)
    with pytest.raises(JaxCorrupt):
        jck.verify_sharded(new)
    assert (get_registry().snapshot().get(key, 0) - counts[0]
            == jobs.get_registry().snapshot().get(key, 0) - counts[1] == (0 if how == "missing" else 1))
    with pytest.raises(CheckpointCorruptError):
        load_checkpoint(new)
    assert not verify_checkpoint(new) and verify_checkpoint(old)
    assert manager.resolve_latest()["path"] == old
    lrn = _learner()
    lrn._ckpt_manager = manager
    assert lrn.resume_latest() == old and lrn.last_iter.val == 1


def test_bf16_leaf_round_trips(tmp_path):
    """Read back as a torch bf16 tensor (numpy has no bf16 without
    ``ml_dtypes``), bit for bit, and by JAX as its bf16."""
    from distar_tpu.parallel import ckpt as jck

    w = torch.randn(6, 4, generator=torch.Generator().manual_seed(0)).bfloat16()
    path = str(tmp_path / "bf16")
    tck.save_sharded(path, {"w": w, "x": np.arange(5, dtype=np.float32)})
    back = tck.restore_sharded(path)["state"]
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"].view(torch.int16), w.view(torch.int16))
    np.testing.assert_array_equal(back["x"], np.arange(5, dtype=np.float32))
    theirs = jck.restore_sharded(path)["state"]["w"]
    assert str(theirs.dtype) == "bfloat16"
    np.testing.assert_array_equal(theirs.view(np.int16), w.view(torch.int16).numpy())


def test_checkpoint_routes_directories_and_keeps_the_layout(stepped, tmp_path):
    from distar_tpu_torch.utils.checkpoint import load_checkpoint, verify_checkpoint

    path = str(tmp_path / "d")
    _jax_save(path, stepped, _jax_mesh(dp=4, fsdp=2))
    assert tck.is_sharded_checkpoint(path) and verify_checkpoint(path)
    out = load_checkpoint(path)
    assert out["sharding_layout"]["mesh_shape"] == {"dp": 4, "fsdp": 2, "tp": 1, "sp": 1}
    assert tck.saved_mesh_shape(path) == {"dp": 4, "fsdp": 2, "tp": 1, "sp": 1}
    assert _bit_equal(out["state"]["params"], stepped["params"])


# ----------------------------------------------------------------- feeder
def _run_feeder(cls, items, depth=2, fail_at=None):
    def source():
        for i in items:
            if i == fail_at:
                raise RuntimeError(f"source failed at {i}")
            yield {"x": np.full(2, i)}

    placed = []

    def place(b):
        placed.append(int(b["x"][0]))
        return {"x": b["x"] * 10}

    feeder = cls(source(), place, depth=depth)
    got, err = [], None
    try:
        for b in feeder:
            got.append(int(b["x"][0]))
    except RuntimeError as e:
        err = str(e)
    stats = feeder.stats()
    feeder.close()
    return got, err, sorted(stats), stats["batches"], feeder._thread.is_alive()


@pytest.mark.parametrize("fail_at", [None, 3, 0])
def test_shard_feeder_behaves_as_jax(fail_at):
    from distar_tpu.parallel.feeder import ShardFeeder as JaxFeeder
    from distar_tpu_torch.parallel import ShardFeeder

    assert _run_feeder(ShardFeeder, range(6), fail_at=fail_at) == _run_feeder(JaxFeeder, range(6), fail_at=fail_at)
    for cls in (ShardFeeder, JaxFeeder):
        with pytest.raises(ValueError, match="depth"):
            cls(iter([]), lambda b: b, depth=0)


def test_shard_feeder_banks_at_most_depth_and_close_joins():
    """A consumer that takes nothing leaves the producer with ``depth``
    placed batches queued and one in its hands; ``close`` reaps it."""
    import time

    from distar_tpu_torch.obs import get_registry
    from distar_tpu_torch.parallel import ShardFeeder

    placed = []
    feeder = ShardFeeder(iter(range(100)), lambda b: placed.append(b) or b, depth=3, token="depth_test")
    time.sleep(0.5)
    assert len(placed) == 4 and feeder.occupancy() == 1.0
    assert next(feeder) == 0 and feeder.stats()["batches"] == 1
    assert get_registry().snapshot()['distar_feeder_batches_total{token=depth_test}'] == 1
    feeder.close()
    assert not feeder._thread.is_alive()


# ------------------------------------------------------------------- ring
def test_ring_at_sp1_equals_jax_ring_and_plain_with_gradients(rng):
    """rtol and atol 2e-4, as JAX's own ring test; JAX's ring runs over sp=2
    of its host devices."""
    import jax.numpy as jnp

    from distar_tpu.ops.pallas_kernels import masked_attention_reference
    from distar_tpu.parallel.ring_attention import ring_self_attention as jax_ring
    from distar_tpu_torch.ops.kernels import masked_attention_plain
    from distar_tpu_torch.parallel import ring_self_attention

    Bq, H, N, D = 2, 2, 32, 8
    q, k, v = (rng.standard_normal((Bq, H, N, D)).astype(np.float32) for _ in range(3))
    mask = rng.random((Bq, N)) > 0.3
    mask[:, 0] = True
    with _jax_mesh(dp=1, sp=2) as jm:
        want = np.asarray(jax_ring(*map(jnp.asarray, (q, k, v, mask)), jm))
    np.testing.assert_allclose(want, np.asarray(masked_attention_reference(*map(jnp.asarray, (q, k, v, mask)))),
                               rtol=2e-4, atol=2e-4)
    ts = [torch.tensor(t, requires_grad=True) for t in (q, k, v)]
    got = ring_self_attention(*ts, torch.tensor(mask), None)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-4, atol=2e-4)
    dout = torch.tensor(rng.standard_normal((Bq, H, N, D)).astype(np.float32))
    (got * dout).sum().backward()
    ref = [torch.tensor(t, requires_grad=True) for t in (q, k, v)]
    (masked_attention_plain(*ref, torch.tensor(mask), upcast=False) * dout).sum().backward()
    for a, b in zip(ts, ref):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=2e-4, atol=2e-4)


def test_attention_module_ring_equals_xla(rng):
    from distar_tpu_torch.ops.transformer import Attention

    x = torch.tensor(rng.standard_normal((2, 16, 24)).astype(np.float32))
    mask = torch.tensor(rng.random((2, 16)) > 0.3)
    ring, xla = Attention(24, 8, 2, 24, impl="ring"), Attention(24, 8, 2, 24, impl="xla")
    xla.load_state_dict(ring.state_dict())
    np.testing.assert_allclose(ring(x, mask).detach().numpy(), xla(x, mask).detach().numpy(),
                               rtol=2e-4, atol=2e-4)


# --------------------------------------------------------- executor, dist
def _jax_report_keys():
    """Every key JAX's ``run_sharded_training`` can put in its report, read
    from its source: the dict literal, ``report.update(...)`` and
    ``report[...] =``."""
    tree = ast.parse(open(os.path.join(REPO, "distar_tpu", "parallel", "executor.py")).read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "run_sharded_training")
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.AnnAssign) and getattr(node.target, "id", "") == "report":
            keys |= {k.value for k in node.value.keys}
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "update":
            keys |= {kw.arg for kw in node.keywords}
        if isinstance(node, ast.Subscript) and getattr(node.value, "id", "") == "report" and isinstance(
                node.ctx, ast.Store):
            keys.add(node.slice.value)
    return keys


def test_run_sharded_training_report_keys_equal_jax(group, tmp_path):
    from distar_tpu_torch.parallel.executor import run_sharded_training

    report = run_sharded_training("dp=1", iters=1, batch_size=B, unroll_len=T, model_cfg=SMALL_MODEL,
                                  save_dir=str(tmp_path), save_freq=1, assert_tp=False, device="cpu")
    want = _jax_report_keys()
    assert set(report) == want - {"tp_leaves"}
    assert report["iters"] == 1 and report["mesh"] == {"dp": 1, "fsdp": 1, "tp": 1, "sp": 1}
    assert set(report["feeder"]) == {"batches", "wait_s_mean", "place_s_mean", "wait_s_total"}
    assert tck.is_sharded_checkpoint(os.path.join(report["checkpoint_dir"], "iteration_1.ckpt"))


def test_dist_init_methods(monkeypatch):
    import torch.distributed as dist

    from distar_tpu_torch.parallel.dist import free_port

    for var in ("RANK", "WORLD_SIZE", "SLURM_PROCID", "SLURM_NTASKS"):
        monkeypatch.delenv(var, raising=False)
    try:
        assert dist_init(method="auto", device="cpu") == {"rank": 0, "world_size": 1, "backend": "gloo"}
        assert dist_init(method="explicit") == {"rank": 0, "world_size": 1, "backend": "gloo"}  # formed already
    finally:
        dist_close()
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    try:
        assert dist_init(device="cpu")["world_size"] == 1 and dist.get_backend() == "gloo"
    finally:
        dist_close()
    with pytest.raises(ValueError, match="explicit"):
        dist_init(method="explicit", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dist_init(method="single_node")
    assert not dist.is_initialized()


def test_launchers_mesh_flags_as_jax(group):
    """``_mesh_from_args`` and ``_learner_cfg`` as tests/test_parallel_exec.py
    holds the JAX launcher's (on a world of one: dp=1 fits, dp=4,fsdp=2
    does not)."""
    import argparse

    from distar_tpu_torch.bin.rl_train import _learner_cfg, _mesh_from_args

    args = argparse.Namespace(mesh="dp=1", sharded_ckpt=None, experiment_name="t", save_path="",
                              batch_size=8, traj_len=2, iters=4, config="", dynamics_every=None,
                              dist_method="single_node", device="cpu")
    assert _mesh_from_args(args).shape == {"dp": 1, "fsdp": 1, "tp": 1, "sp": 1}
    assert _learner_cfg(args, {})["learner"]["sharded_ckpt"] is True
    args.sharded_ckpt = False
    assert _learner_cfg(args, {})["learner"]["sharded_ckpt"] is False
    args.mesh, args.sharded_ckpt = "", None
    assert _mesh_from_args(args) is None
    assert _learner_cfg(args, {})["learner"]["sharded_ckpt"] is False
    args.mesh = "dp=4,fsdp=2"
    with pytest.raises(tmesh.MeshConfigError, match="does not factor"):
        _mesh_from_args(args)


def test_meshed_learner_on_a_world_of_one_equals_the_unmeshed(group):
    """At dp=1 every collective is skipped: the same step, bit for bit on
    the CPU; rank and the collective estimate come from the live mesh."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = tmesh.make_mesh(tmesh.MeshSpec(dp=1))
    assert mesh.device_mesh.mesh_dim_names == tmesh.AXES
    assert tmesh.time_batch_sharding(mesh).placements() == (Shard(1), Replicate(), Replicate(), Replicate())
    a, b = _learner(), _learner(mesh=mesh)
    assert b.rank == 0 and b.mesh is mesh and tmesh.get_context_mesh() is mesh
    batch = next(a._dataloader)
    assert a._train(batch) == b._train(batch)
    assert _bit_equal(a.state, b.state)
    assert not any(v for k, v in b.metrics.snapshot().items()
                   if k.startswith("distar_perf_analysis_failures_total"))
