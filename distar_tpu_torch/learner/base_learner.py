"""The learner skeleton: config cascade, optimizer, checkpoints, hooks and
the crash-safe run loop.

Counterpart of ``distar_tpu.learner.base_learner`` on one device.
Subclasses build their model and optimizer in ``_setup_state`` and take one
optimisation step per ``_train(batch)``, returning the step's scalars.
Around that: the experiment directory (``experiments_root()`` /
``common.experiment_name``, or ``common.save_path``) with its text log,
scalar sink and meters; ``last_iter``; checkpoints in the JAX package's
layout (``model.convert.learner_state_to_flax``), written on a background
thread by default and published in the ``latest`` pointer only once
durable; ``restore``, which refuses a checkpoint that does not fit and
names the leaves, and ``resume_latest``, which falls back past a corrupt
generation; the admin API; the hooks; the prefetcher; and the
``distar_learner_*`` series. Around every step, as in the JAX run loop:
the training-dynamics monitor (``obs.DynamicsMonitor``: the tree's gauges,
anomaly detection, black-box bundles), the perf monitor
(``obs.PerfMonitor``: the ``distar_perf_*`` gauges, the flop count once per
learner), the step phases, and an on-demand profile
(``request_profile``, the admin ``profile`` route) started and stopped at
iteration boundaries.

On a mesh (``mesh=``, ``parallel.make_mesh``) the learner is one rank of
the ``torch.distributed`` group: ``rank`` is the process rank, the batch
is cut to this rank's rows, gradients are summed over the batch extent,
and where the mesh splits parameters the model is placed by
``parallel.spmd.shard_model`` (each rank holds and computes on its blocks
of the parameters, gradients and moments); the step equals the
single-process step on the whole batch. With
``learner.sharded_ckpt`` checkpoints are ``parallel.ckpt`` directories:
the snapshot is taken in the foreground (each rank its own shards), the
blobs are written on the async writer, rank 0 writes the manifest after a
barrier and alone records the ``latest`` pointer; a restore onto another
mesh shape counts ``distar_ckpt_reshards_total``. The prefetch wrapper is
``parallel.ShardFeeder``.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Iterable, Optional

import torch

from ..actor.inference import resolve_device
from ..model.convert import learner_state_to_flax, load_learner_state
from ..obs import (
    DYNAMICS_DEFAULTS,
    DynamicsMonitor,
    PerfMonitor,
    get_registry,
    record_step_phases,
    tree_spec,
)
from ..obs.perf import to_meta
from ..parallel import GradClipConfig, build_optimizer
from ..parallel.mesh import ONE_DEVICE
from ..parallel.spmd import param_shards, shard_model
from ..utils import Config, EasyTimer, build_logger, deep_merge_dicts
from ..utils.checkpoint import (
    AsyncCheckpointer,
    CheckpointCorruptError,
    CheckpointManager,
    CheckpointMismatchError,
    CountVar,
    SignalGuard,
    auto_checkpoint,
    load_checkpoint,
)
from ..utils.timing import sw as global_stopwatch
from .hooks import HookRegistry, default_hooks
from .prefetch import DevicePrefetcher

def experiments_root() -> str:
    """The experiment directories' root: ``DISTAR_EXPERIMENTS_ROOT``, else
    ``./experiments`` (the test harness points the variable at a temporary
    directory, so no run resumes from another's checkpoints)."""
    return os.environ.get("DISTAR_EXPERIMENTS_ROOT") or os.path.join(os.getcwd(), "experiments")


DEFAULT_LEARNER_CONFIG = Config(
    {
        "common": {"experiment_name": "default_experiment", "save_path": ""},
        "learner": {
            "learning_rate": 1e-5,
            "save_freq": 1000,
            "log_freq": 100,
            "load_path": "",
            "max_iterations": 10 ** 9,
            "grad_clip": {"type": "none", "threshold": 1.0},
            # one CRC'd blob per parameter shard + layout manifest
            # (parallel/ckpt.py), restorable onto any mesh; --mesh turns it on
            "sharded_ckpt": False,
            # the profiler hook: every profile.freq iterations capture
            # profile.duration iterations of torch.profiler trace (0 = off)
            "profile": {"freq": 0, "duration": 2, "logdir": ""},
            # live perf gauges (obs/perf.py): frames/s + step time always;
            # perf.aot counts the step's flops (the MFU numerator) once, on
            # a background thread ("auto" = on unless DISTAR_PERF_AOT=0);
            # aot_compile also publishes the allocator's footprint
            "perf": {"aot": "auto", "aot_compile": False, "mem_sample_every": 16},
            # training-dynamics observatory (obs/dynamics.py): the tree is
            # computed every step; every_n gates gauge EXPORT; anomalies
            # write debounced black-box bundles that
            # python -m distar_tpu_torch.tools.stepreplay re-executes
            "dynamics": dict(DYNAMICS_DEFAULTS),
        },
    }
)


def host_scalars(info: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Every 0-d tensor of ``info`` on the host, in one device -> host copy."""
    device = next(iter(info.values())).device
    values = torch.stack([v.to(device, torch.float32) for v in info.values()]).cpu().tolist()
    return dict(zip(info, values))


def _leaf_shapes(tree, prefix="") -> Dict[str, tuple]:
    """``{path: shape}`` of every leaf of a tree of dicts and tuples."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tuple(getattr(tree, "shape", ()) or ())}
    out = {}
    for k, v in items:
        out.update(_leaf_shapes(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


class BaseLearner:
    """Subclasses build ``self.model`` and ``self.optimizer`` (a
    ``parallel.Optimizer`` over the model's parameters) in ``_setup_state``
    and take one step per ``_train(batch)``. ``_CAP_FN`` is the batch
    layout's entity cap (``learner/data.py``); ``CKPT_ROLE`` keeps a role's
    checkpoint generations apart from the default tier's."""

    _CAP_FN = None
    CKPT_ROLE = ""
    # the parameters' init seed, recorded in black-box bundles
    init_prng_seed = 0

    def __init__(self, cfg: Optional[dict] = None, device=None, mesh=None):
        self.cfg = deep_merge_dicts(DEFAULT_LEARNER_CONFIG, cfg or {})
        lc = self.cfg.learner
        self.device = resolve_device(device)
        self.mesh = self._fit_mesh(mesh)
        self.rank = self.mesh.rank if self.mesh is not None else 0
        root = self.cfg.common.save_path or os.path.join(experiments_root(),
                                                         self.cfg.common.experiment_name)
        self.save_dir = root
        self.logger, self.scalar_sink, self.variable_record = build_logger(
            os.path.join(root, "logs"), f"{self.name}_rank{self.rank}")
        self.timer = EasyTimer()
        self.last_iter = CountVar(0)
        self.last_log: Dict[str, float] = {}
        self.log_buffer: Dict[str, Any] = {}
        self.metrics = get_registry()
        self._checkpointer = AsyncCheckpointer()
        self._ckpt_manager = CheckpointManager(os.path.join(root, "checkpoints"),
                                               role=lc.get("ckpt_role", "") or self.CKPT_ROLE)
        prof = lc.get("profile", {}) or {}
        self.hooks: HookRegistry = default_hooks(
            save_freq=lc.save_freq, log_freq=lc.log_freq,
            profile_freq=int(prof.get("freq", 0)),
            profile_duration=int(prof.get("duration", 2)),
            profile_logdir=prof.get("logdir", "") or os.path.join(root, "profiles"))
        pcfg = lc.get("perf", {}) or {}
        aot = pcfg.get("aot", "auto")
        if aot == "auto":
            aot = os.environ.get("DISTAR_PERF_AOT", "1").lower() not in ("0", "false")
        self._perf_aot = bool(aot)
        self._perf = PerfMonitor(token=self.name, registry=self.metrics,
                                 aot_compile=bool(pcfg.get("aot_compile", False)),
                                 mem_sample_every=int(pcfg.get("mem_sample_every", 16)),
                                 device=self.device)
        self._dynamics = DynamicsMonitor(dict(lc.get("dynamics", {}) or {}), name=self.name,
                                         registry=self.metrics,
                                         blackbox_dir=os.path.join(root, "blackbox"))
        self._profile_lock = threading.Lock()
        self._profile_req: Optional[Dict[str, Any]] = None
        self._step_guard = SignalGuard()
        self._pending_save = False
        self._stop_requested = False
        self._dataloader = None
        self._local_rows = False
        self._feed = None  # spmd.ReplicaFeed of a per-rank loader under tp x sp
        self._setup_dataloader()
        self._setup_state()
        # the analytic per-step collective estimate of the placement (none on one process)
        self._perf.publish_collectives(param_shards(self.model).collective_bytes())

    @property
    def name(self) -> str:
        return type(self).__name__.lower()

    def _fit_mesh(self, mesh):
        """``mesh`` shrunk (``shrink_dp``) until its batch extent divides
        ``learner.batch_size``, declared as the context mesh (ring
        attention reads its sp group); None stays None."""
        from ..parallel.mesh import MeshConfigError, batch_sharding, set_context_mesh, shrink_dp

        if mesh is None:
            return None
        B = int(self.cfg.learner.get("batch_size") or 1)
        fitted = shrink_dp(mesh, B)
        if fitted is not mesh:
            print(f"batch {B} not divisible by mesh dp={mesh.shape['dp']}; shrunk to "
                  f"dp={fitted.shape['dp']} (other axes preserved)", flush=True)
        if fitted.coords is None:
            raise MeshConfigError(f"rank {fitted.rank} is outside the mesh {fitted.shape} that "
                                  f"batch {B} fits")
        batch_sharding(fitted, batch_size=B)
        set_context_mesh(fitted)
        return fitted

    @property
    def local_batch_size(self) -> int:
        """The rows of each batch this rank trains on."""
        from ..parallel.mesh import dp_extent

        B = int(self.cfg.learner.batch_size)
        return B if self.mesh is None else B // dp_extent(self.mesh)

    def _build_optimizer(self, params: Iterable[torch.Tensor]):
        """learning_rate, betas, eps, weight_decay and the ``grad_clip``
        block of the learner config, through ``parallel.build_optimizer``.
        The model is placed on the mesh first (``spmd.shard_model``), so on
        a mesh that splits parameters the optimizer holds blocks, and its
        clip reads the whole leaves' norms from them."""
        lc = self.cfg.learner
        shards = shard_model(self.model, self.mesh)
        return build_optimizer(
            list(params),
            norms=shards.leaf_norms,
            learning_rate=lc.learning_rate,
            betas=tuple(lc.get("betas", (0.0, 0.99))),
            eps=lc.get("eps", 1e-5),
            weight_decay=float(lc.get("weight_decay", 0.0) or 0.0),
            clip=GradClipConfig(**lc.grad_clip),
        )

    def _dynamics_spec(self):
        """The spec the train step computes the dynamics tree with; None
        (``learner.dynamics.enabled`` false) builds the step without it."""
        lc = self.cfg.learner
        return tree_spec(lc.get("dynamics"), lc.get("grad_clip"))

    # ------------------------------------------------------------------ perf
    def _flop_loss(self, model, batch):  # pragma: no cover - abstract
        """The step's loss on ``model`` and ``batch`` (both on the meta
        device), for the flop count."""
        raise NotImplementedError

    def _flop_counter(self, meta_batch):
        """A function that runs the step's forward and backward on a meta
        copy of the model (same config, same kernel strings), placed on the
        learner's mesh as the live model is (``shard_model``: under tp its
        split products and attention heads are this rank's; collectives
        move nothing on meta), and ``meta_batch``: what
        ``obs.perf.count_flops`` counts, this rank's own step."""
        def run():
            with torch.device("meta"):
                model = type(self.model)(self.model_cfg)
                shard_model(model, self.mesh)
                params = [p for p in model.parameters() if p.requires_grad]
                loss = self._flop_loss(model, meta_batch)
                torch.autograd.grad(loss, params, allow_unused=True)
        return run

    def _perf_note_step(self, batch) -> None:
        """``_train`` calls this with the step's batch every iteration; the
        first call starts the flop count on a background thread (shapes
        only: the batch is read as meta tensors here)."""
        if self._perf_aot and not self._perf.counting:
            self._perf.note_step(self._flop_counter(to_meta(batch)))

    def _cap(self, batch):
        """``_CAP_FN`` to ``learner.max_entities`` slots where that is set."""
        n = self.cfg.learner.get("max_entities")
        return self._CAP_FN(batch, int(n)) if n else batch

    # ----------------------------------------------------------- checkpoints
    @property
    def state(self) -> dict:
        """``{"params", "opt_state"}`` in the JAX learner's layout, as numpy
        copies (the checkpoint's content)."""
        return learner_state_to_flax(self.model, self.optimizer)

    @property
    def checkpoint_manager(self) -> CheckpointManager:
        return self._ckpt_manager

    def checkpoint_path(self) -> str:
        return os.path.join(self.save_dir, "checkpoints", f"iteration_{self.last_iter.val}.ckpt")

    def _sharded_state(self) -> dict:
        """``state`` for a sharded checkpoint, taken without a collective:
        the parameters, mu and nu as this rank's blocks
        (``parallel.ckpt.LocalShard`` in flax layout; whole where the
        placement splits nothing)."""
        from ..model.convert import flax_layout
        from ..parallel.ckpt import LocalShard

        opt, shards = self.optimizer, param_shards(self.model)
        names = {id(p): n for n, p in self.model.named_parameters()}
        trees = []
        for blocks in (opt.params, opt.mu, opt.nu):
            tree: dict = {}
            for p, block in zip(opt.params, blocks):
                name = names[id(p)]
                path, perm = flax_layout(self.model, name)
                whole = shards.shapes[shards.index[name]]
                data = block.detach() if perm is None else block.detach().permute(perm)
                shape = whole if perm is None else tuple(whole[d] for d in perm)
                node = tree.setdefault("params", {})
                for k in path[:-1]:
                    node = node.setdefault(k, {})
                node[path[-1]] = LocalShard(data.float().cpu().numpy(), shape)
            trees.append(tree)
        return learner_state_to_flax(self.model, opt, trees=tuple(trees))

    def _ckpt_barrier(self) -> None:
        group = getattr(self.mesh, "ckpt_group", None)
        if group is not None:
            import torch.distributed as dist

            dist.barrier(group=group)

    def save(self, path: str, sync: bool = False) -> None:
        """Checkpoint the learner state with ``{"last_iter"}``. By default
        (``learner.async_save``) the host copy is taken here and the write
        runs on a background thread; ``sync`` writes before returning. The
        ``latest`` pointer names ``path`` only once its bytes are durable,
        and only rank 0 records it. With ``learner.sharded_ckpt`` the
        checkpoint is a ``parallel.ckpt`` directory (every rank its shards);
        a whole checkpoint on a mesh is written by rank 0 alone."""
        from ..parallel import ckpt as sharded

        step = self.last_iter.val
        lead = self.rank == 0

        def publish(p):
            if lead:
                self._ckpt_manager.record(p, step=step)

        if self.cfg.learner.get("sharded_ckpt", False):
            def snapshot(learner):
                return sharded.snapshot_sharded(learner._sharded_state(), learner.mesh or ONE_DEVICE)

            def write(p, snap, meta):
                sharded.write_sharded(p, snap, meta, barrier=self._ckpt_barrier)
                publish(p)
                self._ckpt_barrier()  # no rank returns before the generation is published
            on_complete = None
        else:
            def snapshot(learner):
                return learner.state
            write = None if lead else (lambda p, snap, meta: None)
            on_complete = publish
        self._checkpointer.save(path, self, metadata={"last_iter": step}, snapshot_fn=snapshot,
                                write_fn=write, on_complete=on_complete)
        if sync or not self.cfg.learner.get("async_save", True):
            self._checkpointer.wait()

    def restore(self, path: str) -> None:
        """Load a checkpoint of either package into the model and optimizer,
        and ``last_iter`` from its metadata. A leaf the checkpoint lacks
        keeps its value; one whose shape differs raises
        ``CheckpointMismatchError`` before anything changes."""
        self._checkpointer.wait()  # the path may still be being written
        target = self.state
        out = load_checkpoint(path, target=target)
        self._validate_restored(path, out["state"], target)
        saved = (out.get("sharding_layout") or {}).get("mesh_shape")
        live = dict((self.mesh or ONE_DEVICE).shape)
        if saved and dict(saved) != live:
            # the resharding restore: host-global arrays placed on another layout
            self.metrics.counter("distar_ckpt_reshards_total",
                                 "sharded checkpoints restored onto a different mesh shape").inc()
            self.logger.info(f"resharding restore: checkpoint mesh {saved} -> live mesh {live}")
        load_learner_state(out["state"], self.model, self.optimizer)
        self.last_iter.update(out["metadata"].get("last_iter", 0))

    def _validate_restored(self, path: str, state, target=None) -> None:
        """Refuse a checkpoint whose leaves do not fit this learner's state
        (another model config, or a stale experiment directory), naming
        them, so ``resume_latest`` falls back instead of training on
        foreign weights."""
        cur = _leaf_shapes(self.state if target is None else target)
        mismatched = [f"{k}: ckpt {shape} != state {cur[k]}"
                      for k, shape in _leaf_shapes(state).items() if k in cur and cur[k] != shape]
        if mismatched:
            raise CheckpointMismatchError(
                f"{path} does not fit this learner ({len(mismatched)} mismatched leaves, e.g. "
                f"{'; '.join(mismatched[:3])}); refusing to resume from it")

    def resume_latest(self) -> Optional[str]:
        """Restore the newest generation behind the ``latest`` pointer that
        loads and fits, skipping (and counting) the ones that do not; the
        path restored, or None for a cold start."""
        self._checkpointer.wait()
        for gen in self._ckpt_manager.generations():
            try:
                self.restore(gen["path"])
            except (CheckpointCorruptError, FileNotFoundError, OSError, ValueError):
                CheckpointManager._note_fallback(gen["path"])
                continue
            self.metrics.counter("distar_resilience_resumes_total",
                                 "learner restarts resumed from the latest pointer").inc()
            from ..obs import get_flight_recorder

            get_flight_recorder().record("learner_resume", path=gen["path"], step=gen.get("step", 0))
            self.logger.info(f"resumed from {gen['path']} (iter {self.last_iter.val})")
            return gen["path"]
        return None

    def _apply_pending_save(self) -> None:
        """The admin save: synchronous, so durable before it is reported.
        The run loop applies it at every iteration boundary; the RL and
        distillation learners apply it inside their step, as the JAX ones
        do."""
        if self._pending_save:
            self._pending_save = False
            path = self.checkpoint_path()
            self.save(path, sync=True)
            self.logger.info(f"admin checkpoint saved: {path}")

    # ------------------------------------------------------------- abstract
    def _setup_state(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def _setup_dataloader(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def _train(self, data) -> Dict[str, Any]:  # pragma: no cover - abstract
        raise NotImplementedError

    # -------------------------------------------------------------- prefetch
    def _place_batch(self, batch):  # overridden by learners that prefetch
        return batch

    def set_dataloader(self, it, local: bool = False) -> None:
        """Train on ``it`` from the next step (a prefetcher of the old
        loader is closed). ``local``: on a mesh, its batches are this
        rank's rows already (each rank pulls its own, the multi-host path
        of ``parallel.assemble_global``), not global batches to cut."""
        from ..parallel.spmd import replica_feed

        if isinstance(self._dataloader, DevicePrefetcher):
            self._dataloader.close()
        self._local_rows = local
        # ranks that differ only in tp or sp train on one batch: of a
        # per-rank loader only the block's first rank reads
        self._feed = replica_feed(self.mesh, self.device) if local else None
        self._dataloader = iter(it) if self._feed is None or self._feed.lead else None

    def _next_batch(self):
        """The next batch of the dataloader (on a tp x sp replica of a
        per-rank loader, the one its block's first rank read)."""
        if self._feed is None:
            return next(self._dataloader)
        return self._feed.next(self._dataloader)

    def _maybe_enable_prefetch(self) -> None:
        """Wrap the dataloader in a ``parallel.ShardFeeder`` placing batches
        with ``_place_batch`` ``learner.prefetch_depth`` (default 2; 0 turns
        it off) ahead. A feeder spent by an error is replaced by a new one
        on the same source, so a resumed run reads on."""
        from ..parallel.feeder import ShardFeeder

        depth = int(self.cfg.learner.get("prefetch_depth", 2))
        current = self._dataloader
        if current is None:  # a replica that reads no loader of its own
            return
        if isinstance(current, DevicePrefetcher):
            if not current.failed:
                return
            current.close()
            self._dataloader = current.source
        if depth <= 0 or type(self)._place_batch is BaseLearner._place_batch:
            return
        self._dataloader = ShardFeeder(self._dataloader, self._place_batch, depth=depth,
                                       token=self.name, device=self.device)

    # ----------------------------------------------------------------- admin
    def start_admin(self, port: int = 0):
        """Serve the admin API (status, save_ckpt, profile, and
        update_config / reset_value where the learner has them); requests
        apply at the iteration boundary."""
        from .admin import LearnerAdminServer

        self._admin = LearnerAdminServer(self, port=port)
        self._admin.start()
        self.logger.info(f"admin API on {self._admin.host}:{self._admin.port}")
        return self._admin

    def request_save(self) -> None:
        self._pending_save = True

    def request_stop(self) -> None:
        """Leave the run loop at the next iteration boundary; the after_run
        hooks (the final checkpoint) still run."""
        self._stop_requested = True

    # --------------------------------------------------------------- profile
    def request_profile(self, steps: int = 2, timeout_s: float = 600.0) -> dict:
        """On-demand bounded capture (admin ``POST /profile?steps=N``): arm
        a profiler session that the RUN LOOP starts and stops at iteration
        boundaries, then block this (admin-thread) caller until the trace
        is analysed. Returns the ranked bucket report; raises on timeout or
        profiler failure."""
        req = {"steps": max(1, int(steps)), "event": threading.Event(), "session": None,
               "stop_at": None, "report": None, "error": None}
        with self._profile_lock:
            pending = self._profile_req
            if pending is not None and not pending["event"].is_set():
                raise RuntimeError("a profile capture is already in flight")
            self._profile_req = req
        if not req["event"].wait(timeout_s):
            with self._profile_lock:
                if self._profile_req is req:
                    self._profile_req = None  # abandoned: unblock later arms
            raise TimeoutError(f"profile did not complete within {timeout_s}s "
                               f"(is the learner's run loop advancing?)")
        if req["error"]:
            raise RuntimeError(req["error"])
        return req["report"]

    def _profile_tick(self) -> None:
        """Run-loop leg of on-demand profiling: start the armed session at
        this boundary, stop and analyse it once the requested steps
        elapsed."""
        req = self._profile_req
        if req is None or req["event"].is_set():
            return
        if req["session"] is None:
            from ..obs import ProfilerSession

            logdir = os.path.join(self.save_dir, "profiles", f"ondemand_{self.last_iter.val}")
            session = ProfilerSession(logdir, registry=self.metrics)
            if not session.start():
                req["error"] = f"profiler start failed (logdir {logdir!r})"
                self._finish_profile(req)
                return
            req["session"] = session
            req["stop_at"] = self.last_iter.val + req["steps"]
            return
        if self.last_iter.val < req["stop_at"]:
            return
        session = req["session"]
        if not session.stop():
            req["error"] = "profiler stop failed"
            self._finish_profile(req)
            return
        try:
            from ..obs import analyze_trace, render_markdown

            report = analyze_trace(session.last_profile_path or session.logdir, steps=req["steps"])
            report["markdown"] = render_markdown(report)
            report["captured_steps"] = req["steps"]
            report["last_iter"] = self.last_iter.val
            report["perf"] = self._perf.snapshot()
            busy = getattr(session._profiler, "device_busy_us", None)
            if busy is not None:
                report["profiler_device_busy_us"] = busy
            req["report"] = report
        except Exception as e:
            req["error"] = f"trace analysis failed: {e!r}"
        self._finish_profile(req)

    def _finish_profile(self, req) -> None:
        with self._profile_lock:
            if self._profile_req is req:
                self._profile_req = None
        req["event"].set()

    # ------------------------------------------------------------------- run
    def run(self, max_iterations: Optional[int] = None) -> None:
        """Train until ``last_iter`` reaches ``max_iterations`` (or a stop
        request), under ``auto_checkpoint``: an exception, SIGTERM or
        SIGINT saves a checkpoint synchronously first (a signal during a
        step waits for the step's end). Every ``learner.log_freq`` steps a
        JSON line of the step's scalars (no per-parameter norms) goes to
        standard output."""
        max_iterations = max_iterations or self.cfg.learner.max_iterations
        log_freq = max(int(self.cfg.learner.log_freq), 1)
        self._maybe_enable_prefetch()
        iters_total = self.metrics.counter("distar_learner_iterations_total",
                                           "optimisation steps completed")
        step_time = self.metrics.histogram("distar_learner_step_seconds", "device train-step wall time")
        data_wait = self.metrics.histogram("distar_learner_data_wait_seconds",
                                           "dataloader wait per iteration")
        # a gauge, not a histogram: a health rule reads the raw last value
        loss_gauge = self.metrics.gauge("distar_learner_loss",
                                        "last total_loss (NaN/Inf watchdog input)")
        lc = self.cfg.learner
        frames_per_iter = float((lc.get("batch_size") or 0) * (lc.get("unroll_len") or 0))
        self._stop_requested = False

        @auto_checkpoint(lambda: self.save(self.checkpoint_path(), sync=True), guard=self._step_guard)
        def _run():
            self.hooks.call("before_run", self)
            while self.last_iter.val < max_iterations and not self._stop_requested:
                with self.timer:
                    data = self._next_batch()
                t_data = self.timer.value
                self.log_buffer["data_time"] = t_data
                self.hooks.call("before_iter", self)
                # aux refs (the SL carry before its reset) for a bundle
                self._dynamics.before_step(self)
                with self._step_guard:  # the step and its log line, whole
                    with self.timer:
                        log_vars = self._train(data)
                    t_train = self.timer.value
                    self.last_log = log_vars
                    self.log_buffer["train_time"] = t_train
                    self.log_buffer.update(log_vars)
                    if "total_loss" in log_vars:
                        loss_gauge.set(float(log_vars["total_loss"]))
                    # detection + gauge export from the fetched host log;
                    # the batch is read only if a bundle is written
                    self._dynamics.on_step(self, log_vars, data)
                    self.last_iter.add(1)
                    if self.last_iter.val % log_freq == 0 and self.rank == 0:
                        scalars = {k: v for k, v in log_vars.items() if "/" not in k}
                        print(json.dumps({"learner": self.name, "iter": self.last_iter.val,
                                          "train_time": t_train, **scalars}), flush=True)
                # host-callback phase: the hook pass after the step
                with self.timer:
                    self.hooks.call("after_iter", self)
                    self._apply_pending_save()
                iters_total.inc()
                step_time.observe(t_train)
                data_wait.observe(t_data)
                record_step_phases({"data_wait": t_data, "device_step": t_train,
                                    "host_callback": self.timer.value}, registry=self.metrics)
                self._perf.on_step(t_train, frames_per_iter)
                self._profile_tick()
            self.hooks.call("after_run", self)

        try:
            _run()
        finally:
            # a profile armed while this was the run loop must not strand
            # its admin-thread waiter once no more iterations will happen
            req = self._profile_req
            if req is not None and not req["event"].is_set():
                if req.get("session") is not None:
                    req["session"].stop()
                req["error"] = "learner run ended before the capture completed"
                self._finish_profile(req)
        global_stopwatch.report(registry=self.metrics)
        self._checkpointer.wait()  # drain the async writer before returning
