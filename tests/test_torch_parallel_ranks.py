"""The port's learners and ring attention over spawned gloo ranks on the CPU.

Two global batches, two steps: the RL learner under dp=2, tp=2, sp=2 with
``attention_impl='ring'``, fsdp=2 (and its sharded checkpoints), dp=4,
(dp=2, fsdp=2) and (fsdp=2, tp=2), and the SL learner under dp=2, each held
against the port's single-process steps on the whole batches (themselves
held against JAX in tests/test_torch_rl.py and tests/test_torch_train.py):
the loss, every info scalar (the dynamics tree's norms among them) of both
steps, the parameters after them, and the Adam moments gathered whole
(the second step's update reads the moments' sizes, which the first one's
does not). Under tp=2 with a per-rank loader only the first rank reads,
and the other trains on the batch it sends. The fsdp=2 directory of the
first step, restored onto (fsdp=2, tp=2) (a resharding restore) and
stepped once more, equals the single-process second step. A per-rank
masked mean planted in place of the global one fails the SL comparison.
Ring attention over 2 and 4 ranks against JAX's
``ring_self_attention`` and the plain attention, with gradients against
autograd through the plain version. The fsdp=2 directory passes JAX's
``verify_sharded``, restores bit-equal in JAX's ``restore_sharded``, and
its manifest equals the one JAX writes for the same state and mesh.
Under fsdp=2, tp=2, (dp=2, fsdp=2) and (fsdp=2, tp=2) each rank holds
between steps only its blocks of the parameters, gradients, mu and nu,
shaped as the JAX learner's addressable shards on the same mesh; at tp=2
each tp-split Linear and Conv2d does half its flops and the attention runs
half the heads.

Each world is one spawn (``parallel.dist.spawn_ranks``: a free port, each
rank joined with its own timeout, every rank killed when one fails) that
runs its cases in turn and leaves its results in a temporary directory;
the tests read them. This module's top level imports no JAX: the ranks
import it.
"""
import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # tiny CPU ops: OpenMP workers only wait on each other

B, T = 4, 1
# the meshed step against the single-process one: every info scalar within
# SCALAR_RTOL of max(1, |single-process|), and the parameters' step within
# UPDATE_RTOL of the single-process step's norm (Adam's first step is
# g / (|g| + eps), so f32 rounding of a gradient element near eps moves its
# parameter by up to the learning rate: the SL step, eps 1e-8, lies 3.3e-5
# off, the RL steps 2.3e-5 to 3.1e-5)
SCALAR_RTOL = 1e-5
UPDATE_RTOL = 2e-4
# the SL learner's second step (Adam eps 1e-8, b1 0.9): a gradient element
# at f32 rounding noise (|mu| near 1e-9, where the masked first rows leave
# a head's weight with no signal) flips sign between the reduction orders,
# and Adam moves its parameter by a whole learning rate either way; the
# dp=2 step lies 4.5e-3 off. A wrong moment, bias correction or carry-over
# moves every parameter: O(1) off
SL_SECOND_UPDATE_RTOL = 1e-2
# the Adam moments gathered whole against the single-process ones, over
# every leaf: mu (b1 = 0: the second step's gradient) and nu
MOMENT_RTOL = 1e-4
RING_TOL = dict(rtol=2e-4, atol=2e-4)  # JAX's own ring test's
WORLD2 = ("rl_dp2", "rl_tp2", "rl_tp2_local", "rl_sp2_ring", "rl_fsdp2", "sl_dp2", "sl_dp2_per_rank_mean")
WORLD4 = ("rl_dp4", "rl_dp2_fsdp2", "rl_fsdp2_tp2", "rl_restore_fsdp2_tp2")
# the meshes that split parameters: each rank's holdings read between its steps
CENSUS = ("rl_fsdp2", "rl_tp2", "rl_dp2_fsdp2", "rl_fsdp2_tp2")
# the meshes whose learners count their step's flops (the perf monitor's
# ``flops_per_step``), held against the live step's count
FLOP_CASES = ("rl_dp2", "rl_tp2", "rl_fsdp2")
FLOP_RTOL = 1e-6
MESHES = {"rl_dp2": {"dp": 2}, "rl_tp2": {"dp": 1, "tp": 2}, "rl_tp2_local": {"dp": 1, "tp": 2},
          "rl_sp2_ring": {"dp": 1, "sp": 2}, "rl_fsdp2": {"dp": 1, "fsdp": 2}, "sl_dp2": {"dp": 2},
          "sl_dp2_per_rank_mean": {"dp": 2}, "rl_dp4": {"dp": 4}, "rl_dp2_fsdp2": {"dp": 2, "fsdp": 2},
          "rl_fsdp2_tp2": {"dp": 1, "fsdp": 2, "tp": 2}, "rl_restore_fsdp2_tp2": {"dp": 1, "fsdp": 2, "tp": 2}}


def _model(case, small):
    if "ring" not in case:
        return small
    model = json.loads(json.dumps(small))
    model["encoder"]["entity"]["attention_impl"] = "ring"
    return model


def _learner(case, small, mesh=None, **lc):
    from distar_tpu_torch.learner import RLLearner, SLLearner

    cls = SLLearner if case.startswith("sl") else RLLearner
    return cls({"learner": {"batch_size": B, "unroll_len": T if cls is RLLearner else 2, "prefetch_depth": 0,
                            "log_freq": 10 ** 9, **lc}, "model": _model(case, small)}, device="cpu", mesh=mesh)


def _batches(lrn):
    """The first two batches of the learner's own seeded fake loader: the
    same global batches on every rank. An SL batch has every head masked
    off on its first row, so the ranks' rows hold different mask counts
    (as a real batch's heads do by action type)."""
    out = []
    for _ in range(2):
        batch = next(lrn._dataloader)
        if "action_mask" in batch:
            masks = {k: np.array(v, copy=True) for k, v in batch["action_mask"].items()}
            for v in masks.values():
                v[0] = 0
            batch = {**batch, "action_mask": masks}
        out.append(batch)
    return out


class _NotRead:
    """The loader of a replica that must not read its own."""

    def __iter__(self):
        return self

    def __next__(self):
        raise AssertionError("a tp replica read its own loader")


def _step(lrn, batch):
    """One step, counted as ``run`` counts it (the log's staleness reads
    the count)."""
    log = lrn._train(batch)
    lrn.last_iter.add(1)
    return log


def _params(lrn):
    """The parameters whole (gathered from the blocks where the placement
    splits a leaf: every rank calls)."""
    from distar_tpu_torch.parallel.spmd import param_shards

    shards = param_shards(lrn.model)
    return {n: p.detach().clone() for n, p in zip(shards.names, shards.whole(shards.params))}


def _steps(lrn, batches, logs=None, params=None, between=None):
    """Step ``lrn`` on each of ``batches``; the logs and the parameters
    after each step, appended to ``logs`` and ``params``. ``between`` is
    called after the first step, before anything gathers the parameters."""
    logs, params = ([] if logs is None else logs), ([] if params is None else params)
    for i, batch in enumerate(batches):
        logs.append(_step(lrn, batch))
        if i == 0 and between is not None:
            between()
        params.append(_params(lrn))
    return logs, params


def _count_grads(lrn):
    """The elements of the gradients each optimizer step receives, listed."""
    seen, real = [], lrn.optimizer.step

    def step(grads):
        seen.append(sum(g.numel() for g in grads))
        return real(grads)

    lrn.optimizer.step = step
    return seen


def _live_shapes():
    """How many live tensors have each shape."""
    import gc
    from collections import Counter

    gc.collect()
    return Counter(tuple(o.shape) for o in gc.get_objects() if isinstance(o, torch.Tensor))


def _census(lrn, grads_seen, before):
    """What this rank holds between steps: the elements of its parameters,
    of the last step's gradients, of mu and nu, each leaf's block shape in
    flax layout, and the split leaves some live tensor still holds whole:
    a tensor of the leaf's whole shape beyond the blocks of that shape and
    those alive before the learner was built (``before``, of the cases
    this rank ran earlier)."""
    from collections import Counter

    from distar_tpu_torch.model.convert import flax_layout
    from distar_tpu_torch.parallel.spmd import param_shards

    model, opt = lrn.model, lrn.optimizer
    blocks = {}
    for name, p in model.named_parameters():
        path, perm = flax_layout(model, name)
        blocks["/".join(path)] = [int(p.shape[d]) for d in (perm or range(p.dim()))]
    live = _live_shapes() - before
    own = Counter(tuple(t.shape) for t in opt.params + opt.mu + opt.nu)
    shards = param_shards(model)
    whole = [n for n, shape, p in zip(shards.names, shards.shapes, shards.params)
             if shape != tuple(p.shape) and live[shape] > own[shape]]
    return {"params": sum(p.numel() for p in opt.params), "grads": grads_seen[-1],
            "mu": sum(t.numel() for t in opt.mu), "nu": sum(t.numel() for t in opt.nu),
            "blocks": blocks, "whole_alive": whole}


def _flops(lrn, batch):
    """The RL loss's forward on ``batch`` under ``FlopCounterMode``: the
    flops of each module (by the counter's names), the modules whose
    weight tp splits, and the head count of every attention call."""
    from torch.utils.flop_counter import FlopCounterMode

    from distar_tpu_torch.learner.rl_learner import rl_loss
    from distar_tpu_torch.ops import kernels
    from distar_tpu_torch.parallel.spmd import TPConv2d, TPLinear

    heads, real = [], kernels.masked_attention_plain

    def plain(q, *args, **kwargs):
        heads.append(int(q.shape[1]))
        return real(q, *args, **kwargs)

    class Loss(torch.nn.Module):
        """The loss as a module: the counter names every module under it by
        its path from here."""

        def __init__(self):
            super().__init__()
            self.model = lrn.model

        def forward(self, data):
            return rl_loss(self.model, lrn.loss_cfg, data, lrn.local_batch_size, lrn.cfg.learner.unroll_len,
                           mesh=lrn.mesh)

    data = lrn.shard_batch(lrn._cap({k: v for k, v in batch.items() if k != "model_last_iter"}))
    kernels.masked_attention_plain = plain
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            Loss()(data)
    finally:
        kernels.masked_attention_plain = real
    return {"flops": {k: int(sum(v.values())) for k, v in counter.get_flop_counts().items()},
            "split": [f"Loss.model.{n}" for n, m in lrn.model.named_modules() if isinstance(m, (TPLinear, TPConv2d))],
            "heads": heads}


def _count_first_batch(lrn):
    """Turn on ``lrn``'s flop count (``learner.perf.aot``, off in the test
    harness) and keep the batch its first step hands the count."""
    seen, real = [], lrn._perf_note_step

    def note(batch):
        if not seen:
            seen.append(dict(batch))
        real(batch)

    lrn._perf_aot, lrn._perf_note_step = True, note
    return seen


def _flop_counts(lrn, batch):
    """This rank's step three ways: the perf monitor's ``flops_per_step``
    (the learner's meta copy of its model, placed on its mesh), the same
    step's loss forward and backward on the live model and ``batch``
    under ``count_flops``, and a meta copy left unplaced (the whole model
    on this rank's rows: the count before the copy was placed)."""
    from distar_tpu_torch.learner.rl_learner import rl_loss
    from distar_tpu_torch.obs.perf import count_flops, to_meta

    lrn._perf.analysis.join()
    cfg = lrn.cfg.learner

    def live():
        loss = rl_loss(lrn.model, lrn.loss_cfg, batch, lrn.local_batch_size, cfg.unroll_len, mesh=lrn.mesh)[0]
        torch.autograd.grad(loss, lrn.optimizer.params, allow_unused=True)

    def unplaced():
        with torch.device("meta"):
            model = type(lrn.model)(lrn.model_cfg)
            loss = lrn._flop_loss(model, to_meta(batch))
            torch.autograd.grad(loss, [p for p in model.parameters() if p.requires_grad], allow_unused=True)

    return {"learner": lrn._perf.flops_per_step, "live": count_flops(live), "unplaced": count_flops(unplaced)}


def _outcome(lrn, logs, params):
    return {"logs": logs, "params": params, "state": lrn.state}


def _plant_per_rank_mean(mesh):
    """The SL loss as a naive data-parallel learner computes it: each rank's
    masked means over its own rows, averaged over the ranks (the loss its
    gradient comes from, and every scalar it reports)."""
    import torch.distributed as dist

    from distar_tpu_torch.learner import sl_learner

    real = sl_learner.sl_loss

    def per_rank(model, cfg, batch, hidden, batch_size, mesh=None):
        total, info, state = real(model, cfg, batch, hidden, batch_size)
        n = mesh.size("batch")
        keys = sorted(info)
        vals = torch.stack([torch.as_tensor(info[k]).detach().float() for k in keys])
        dist.all_reduce(vals, group=mesh.group("batch"))
        return total / n, dict(zip(keys, (vals / n).unbind())), state

    sl_learner.sl_loss = per_rank
    return lambda: setattr(sl_learner, "sl_loss", real)


def _world(rank, cases, small, out, rings):
    from distar_tpu_torch.parallel import MeshSpec, make_mesh, set_context_mesh

    for case in cases:
        mesh = make_mesh(MeshSpec(**MESHES[case]))
        before = _live_shapes() if case in CENSUS else None
        undo = _plant_per_rank_mean(mesh) if case.endswith("per_rank_mean") else None
        lrn = _learner(case, small, mesh=mesh, sharded_ckpt=case == "rl_fsdp2")
        batches = _batches(lrn)
        between = None
        counted = _count_first_batch(lrn) if case in FLOP_CASES else None
        if case in CENSUS:
            seen = _count_grads(lrn)

            def between():
                if counted is not None:  # the count's meta copy gone before the census
                    lrn._perf.analysis.join()
                torch.save(_census(lrn, seen, before), os.path.join(out, f"census_{case}_{rank}.pt"))
        if case == "rl_tp2":
            torch.save(_flops(lrn, batches[0]), os.path.join(out, f"flops_{case}_{rank}.pt"))
        if case == "rl_tp2_local":
            # a per-rank loader (local=True): rank 0 pulls, rank 1 must not
            lrn.set_dataloader(iter(batches) if rank == 0 else _NotRead(), local=True)
            logs, params = _steps(lrn, [lrn._next_batch(), lrn._next_batch()])
        elif case == "rl_restore_fsdp2_tp2":
            lrn.restore(os.path.join(out, "fsdp2_step1.ckpt"))
            assert lrn.metrics.snapshot().get("distar_ckpt_reshards_total", 0) >= 1
            logs, params = _steps(lrn, batches[1:], [None], [None])
        else:
            logs, params = [], []
            for i, batch in enumerate(batches):
                _steps(lrn, [batch], logs, params, between if i == 0 else None)
                if case == "rl_fsdp2":
                    lrn.save(os.path.join(out, ("fsdp2_step1.ckpt", "fsdp2.ckpt")[i]), sync=True)
        outcome = _outcome(lrn, logs, params)  # the state gathers the split moments: every rank calls it
        if counted is not None:  # the live count runs the step's collectives: every rank calls it
            torch.save(_flop_counts(lrn, counted[0]), os.path.join(out, f"count_{case}_{rank}.pt"))
        if undo is not None:
            undo()
        if rank == 0:
            torch.save(outcome, os.path.join(out, f"{case}.pt"))
        set_context_mesh(None)
    if rings:
        from distar_tpu_torch.parallel.ring_attention import ring_self_attention

        data = np.load(os.path.join(out, "ring_inputs.npz"))
        n = torch.distributed.get_world_size()
        mesh = make_mesh(MeshSpec(dp=1, sp=n))
        leaves = [torch.tensor(data[k], requires_grad=True) for k in ("q", "k", "v")]
        got = ring_self_attention(*leaves, torch.tensor(data["mask"]), mesh)
        (got * torch.tensor(data["dout"])).sum().backward()
        if rank == 0:
            np.savez(os.path.join(out, f"ring{n}.npz"), out=got.detach().numpy(),
                     **{f"d{k}": t.grad.numpy() for k, t in zip("qkv", leaves)})


@pytest.fixture(scope="module")
def small():
    from conftest import SMALL_MODEL

    return SMALL_MODEL


@pytest.fixture(scope="module")
def ring_inputs():
    rng = np.random.default_rng(4)
    Bq, H, N, D = 2, 2, 32, 8
    q, k, v, dout = (rng.standard_normal((Bq, H, N, D)).astype(np.float32) for _ in range(4))
    mask = rng.random((Bq, N)) > 0.3
    mask[:, 0] = True
    return {"q": q, "k": k, "v": v, "mask": mask, "dout": dout}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, small, ring_inputs):
    """Both worlds' results: {case: outcome}, {n: ring outputs}, the dir."""
    from distar_tpu_torch.parallel.dist import spawn_ranks

    out = str(tmp_path_factory.mktemp("ranks"))
    np.savez(os.path.join(out, "ring_inputs.npz"), **ring_inputs)
    for world, cases in ((2, WORLD2), (4, WORLD4)):
        codes = spawn_ranks(_world, world, cases, small, out, True, timeout_s=300)
        assert codes == [0] * world, f"world {world}: exit codes {codes}"
    results = {case: torch.load(os.path.join(out, f"{case}.pt"), weights_only=False)
               for case in WORLD2 + WORLD4}
    rings = {n: dict(np.load(os.path.join(out, f"ring{n}.npz"))) for n in (2, 4)}
    return results, rings, out


@pytest.fixture(scope="module")
def single(small):
    """The single-process step on the whole batch, per learner and model,
    with the seeded parameters it started from."""
    out = {}
    for case in ("rl", "rl_ring", "sl"):
        lrn = _learner(case, small)
        before = _params(lrn)
        out[case] = {**_outcome(lrn, *_steps(lrn, _batches(lrn))), "before": before}
    return out


def _reference(case, single):
    return single["sl" if case.startswith("sl") else "rl_ring" if "ring" in case else "rl"]


def _worst(got, want):
    """(worst scalar share of its tolerance, each step's parameters off the
    single-process ones relative to that step's movement, the gathered
    moments off relative to their norm)."""
    scalars, updates = 0.0, []
    prev = want["before"]
    for mine, theirs, p_mine, p_theirs in zip(got["logs"], want["logs"], got["params"], want["params"]):
        if mine is not None:  # the restored case takes only the second step
            assert set(mine) == set(theirs)
            scalars = max(scalars, max(abs(mine[k] - v) / (SCALAR_RTOL * max(1.0, abs(v)))
                                       for k, v in theirs.items()))
            num = sum(float(((p_mine[n] - p) ** 2).sum()) for n, p in p_theirs.items())
            den = sum(float(((p - prev[n]) ** 2).sum()) for n, p in p_theirs.items())
            updates.append((num / den) ** 0.5)
        else:
            updates.append(0.0)
        prev = p_theirs
    (count, mu, nu), (want_count, want_mu, want_nu) = (s["opt_state"][1][0] for s in (got["state"], want["state"]))
    assert int(count) == int(want_count) == 2
    moments = max(_rel(_array_leaves(a), _array_leaves(b)) for a, b in ((mu, want_mu), (nu, want_nu)))
    return scalars, updates, moments


def _rel(got, want):
    assert len(got) == len(want) > 100
    num = sum(float(((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2).sum())
              for a, b in zip(got, want))
    return (num / sum(float((np.asarray(b, np.float64) ** 2).sum()) for b in want)) ** 0.5


@pytest.mark.parametrize("case", [c for c in WORLD2 + WORLD4 if not c.endswith("per_rank_mean")])
def test_meshed_step_equals_the_single_process_step(runs, single, case):
    results, _, _ = runs
    got = results[case]
    scalars, (first, second), moments = _worst(got, _reference(case, single))
    assert scalars <= 1.0, f"{case}: an info scalar off by {scalars:.3g} of its tolerance"
    assert first <= UPDATE_RTOL, f"{case}: the first step's parameters off by {first:.3g} of its norm"
    bound = SL_SECOND_UPDATE_RTOL if case.startswith("sl") else UPDATE_RTOL
    assert second <= bound, f"{case}: the second step's parameters off by {second:.3g} of its norm"
    assert moments <= MOMENT_RTOL, f"{case}: the gathered moments off by {moments:.3g} of their norm"
    assert any(k.startswith("dyn/grad_norm/") for k in got["logs"][-1])


def test_a_per_rank_mean_fails_the_sl_comparison(runs, single):
    """The masks' counts differ between the ranks' rows, so the mean of
    per-rank masked means is not the global masked mean: the loss the
    planted learner reports is off. (Its parameters are not: Adam's first
    step reads only each gradient element's sign.)"""
    results, _, _ = runs
    got, want = results["sl_dp2_per_rank_mean"]["logs"][0], single["sl"]["logs"][0]
    off = abs(got["total_loss"] - want["total_loss"]) / (SCALAR_RTOL * max(1.0, abs(want["total_loss"])))
    assert off > 10.0, f"the planted per-rank mean's loss is within {off:.3g} of the tolerance"


def test_split_state_gathers_whole(runs, single):
    """fsdp=2, (dp=2, fsdp=2) and (fsdp=2, tp=2) keep only their blocks of
    the parameters, mu and nu; the state they report
    (``learner_state_to_flax``) is the single-process learner's, leaf for
    leaf in its layout: the parameters within MOMENT_RTOL of their norm
    too (two steps move them by about 1e-3 of it, and the meshed steps lie
    within UPDATE_RTOL of that)."""
    results, _, _ = runs
    want = single["rl"]["state"]
    for case in ("rl_fsdp2", "rl_dp2_fsdp2", "rl_fsdp2_tp2"):
        got = results[case]["state"]
        pairs = list(zip(got["opt_state"][1][0][1:], want["opt_state"][1][0][1:]))
        for a, b in pairs + [(got["params"], want["params"])]:
            mine, theirs = _array_leaves(a), _array_leaves(b)
            assert [np.shape(x) for x in mine] == [np.shape(x) for x in theirs]
            assert _rel(mine, theirs) <= MOMENT_RTOL, case


def _world_size(case):
    return int(np.prod(list(MESHES[case].values())))


def _jax_blocks(case, single, rank):
    """The shape of each leaf's block on ``rank``'s device, by flax path,
    of the single-process learner's parameters placed by JAX's
    ``param_sharding`` on a JAX mesh of the case's shape (host devices)."""
    import jax

    from distar_tpu.parallel.mesh import MeshSpec, make_mesh, param_sharding

    mesh = make_mesh(MeshSpec(**MESHES[case]), jax.devices()[:_world_size(case)])
    params = single["rl"]["state"]["params"]["params"]
    placed = jax.tree.map(jax.device_put, params, param_sharding(mesh, params))
    device = mesh.devices.reshape(-1)[rank]
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(placed)[0]:
        shard = next(s for s in leaf.addressable_shards if s.device == device)
        out["/".join(k.key for k in path)] = list(shard.data.shape)
    return out


def _load_census(out, case):
    return [torch.load(os.path.join(out, f"census_{case}_{r}.pt"), weights_only=False)
            for r in range(_world_size(case))]


@pytest.mark.parametrize("case", CENSUS)
def test_each_rank_holds_only_its_blocks_between_steps(runs, single, case):
    """Between steps each rank's parameters, the gradients of its step, mu
    and nu hold as many elements as its blocks under JAX's placement (less
    than the whole model), and no live tensor holds a split leaf whole."""
    _, _, out = runs
    whole = sum(np.size(x) for x in _array_leaves(single["rl"]["state"]["params"]))
    for rank, census in enumerate(_load_census(out, case)):
        want = sum(int(np.prod(s)) for s in _jax_blocks(case, single, rank).values())
        assert want < whole
        for family in ("params", "grads", "mu", "nu"):
            assert census[family] == want, f"{case} rank {rank}: {family} {census[family]}, blocks {want}"
        assert census["whole_alive"] == [], f"{case} rank {rank}: whole {census['whole_alive'][:5]}"


@pytest.mark.parametrize("case", CENSUS)
def test_block_shapes_equal_the_jax_learners_addressable_shards(runs, single, case):
    _, _, out = runs
    for rank, census in enumerate(_load_census(out, case)):
        assert census["blocks"] == _jax_blocks(case, single, rank), f"{case} rank {rank}"


def test_tp_halves_each_split_modules_flops_and_the_attention_heads(runs, small):
    """At tp=2 every Linear and Conv2d whose weight tp splits does half the
    flops of the same module at tp=1 on the same rows (the RL loss's
    forward, ``FlopCounterMode`` per module), and every attention call
    sees H/2 heads."""
    _, _, out = runs
    lrn = _learner("rl", small)
    plain = _flops(lrn, _batches(lrn)[0])
    heads = {m.head_num for m in lrn.model.modules() if type(m).__name__ == "Attention"}
    assert len(plain["heads"]) > 0 and not plain["split"]
    for rank in range(2):
        got = torch.load(os.path.join(out, f"flops_rl_tp2_{rank}.pt"), weights_only=False)
        assert len(got["split"]) > 50
        for name in got["split"]:
            assert plain["flops"][name] > 0 and 2 * got["flops"][name] == plain["flops"][name], name
        assert got["heads"] == [h // 2 for h in plain["heads"]] and set(plain["heads"]) == heads


def test_tp_ranks_count_their_own_steps_flops(runs):
    """At tp=2 each rank's ``flops_per_step`` (the perf monitor's count,
    so its implied TFLOP/s and MFU) is what the rank's live step runs,
    forward and backward, and lies below the whole model's count on the
    same rows (the single-process step's: tp ranks take every row)."""
    _, _, out = runs
    for rank in range(2):
        got = torch.load(os.path.join(out, f"count_rl_tp2_{rank}.pt"), weights_only=False)
        assert got["live"] > 0 and abs(got["learner"] - got["live"]) <= FLOP_RTOL * got["live"], (rank, got)
        assert got["learner"] < got["unplaced"], (rank, got)


@pytest.mark.parametrize("case", ["rl_dp2", "rl_fsdp2"])
def test_dp_and_fsdp_ranks_count_as_before(runs, case):
    """Under dp=2 and fsdp=2 the placed meta copy counts what the whole
    model does on the rank's rows: the count is unchanged."""
    _, _, out = runs
    for rank in range(2):
        got = torch.load(os.path.join(out, f"count_{case}_{rank}.pt"), weights_only=False)
        assert got["learner"] > 0 and got["learner"] == got["unplaced"], (case, rank, got)


def test_one_process_counts_as_before(small):
    """On one process the learner's count is the unplaced copy's, and the
    live step's."""
    lrn = _learner("rl", small)
    counted = _count_first_batch(lrn)
    _step(lrn, _batches(lrn)[0])
    got = _flop_counts(lrn, counted[0])
    assert got["learner"] > 0 and got["learner"] == got["unplaced"], got
    assert abs(got["learner"] - got["live"]) <= FLOP_RTOL * got["live"], got


def _array_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _array_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _array_leaves(v)]
    return [tree]


@pytest.mark.parametrize("n", [2, 4])
def test_ring_over_ranks_equals_jax_and_plain_with_gradients(runs, ring_inputs, n):
    import jax
    import jax.numpy as jnp

    from distar_tpu.parallel.mesh import MeshSpec, make_mesh
    from distar_tpu.parallel.ring_attention import ring_self_attention
    from distar_tpu_torch.ops.kernels import masked_attention_plain

    _, rings, _ = runs
    got = rings[n]
    mesh = make_mesh(MeshSpec(dp=1, sp=n), jax.devices()[:n])
    args = [jnp.asarray(ring_inputs[k]) for k in ("q", "k", "v", "mask")]
    with mesh:
        want = np.asarray(ring_self_attention(*args, mesh))
    np.testing.assert_allclose(got["out"], want, **RING_TOL)
    leaves = [torch.tensor(ring_inputs[k], requires_grad=True) for k in ("q", "k", "v")]
    plain = masked_attention_plain(*leaves, torch.tensor(ring_inputs["mask"]), upcast=False)
    np.testing.assert_allclose(got["out"], plain.detach().numpy(), **RING_TOL)
    (plain * torch.tensor(ring_inputs["dout"])).sum().backward()
    for name, t in zip("qkv", leaves):
        np.testing.assert_allclose(got[f"d{name}"], t.grad.numpy(), **RING_TOL)


def test_two_rank_directory_passes_jax_with_an_equal_manifest(runs):
    """Written by 2 ranks at fsdp=2 (each its blocks, rank 0 the manifest
    after the barrier): JAX verifies it, restores the state the ranks
    report bit for bit, and writes the same manifest for that state on a
    (dp=1, fsdp=2) mesh of its host devices."""
    import jax

    from distar_tpu.parallel import ckpt as jck
    from distar_tpu.parallel.mesh import MeshSpec, make_mesh, param_sharding

    results, _, out = runs
    path = os.path.join(out, "fsdp2.ckpt")
    jck.verify_sharded(path)
    state = results["rl_fsdp2"]["state"]
    back = jck.restore_sharded(path)["state"]
    mine, theirs = _array_leaves(state), [np.asarray(x) for x in jax.tree.leaves(back)]
    assert len(mine) == len(theirs) and all(
        np.array_equal(np.asarray(a).reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8))
        for a, b in zip(mine, theirs))
    mesh = make_mesh(MeshSpec(dp=1, fsdp=2), jax.devices()[:2])
    jax_dir = os.path.join(out, "fsdp2_jax.ckpt")
    jck.save_sharded(jax_dir, jax.tree.map(jax.device_put, state, param_sharding(mesh, state)),
                     {"last_iter": 2})
    manifests = [json.load(open(os.path.join(d, "sharding.json"))) for d in (path, jax_dir)]
    for m in manifests:
        m.pop("ts")
    assert manifests[0] == manifests[1]
    assert any("'fsdp'" in leaf["spec"] for leaf in manifests[0]["leaves"].values())
