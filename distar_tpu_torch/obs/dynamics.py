"""Training-dynamics observatory: in-step diagnostics, anomaly black boxes.

Counterpart of ``distar_tpu.obs.dynamics``, in three moves:

* ``DynamicsTree`` (``dynamics_tree``) — scalar reductions inside the
  learner's train step: per-module gradient/param global norms,
  update-to-weight ratios, grad-clip activation, and non-finite censuses
  over grads, pre-step params and the batch. They are 0-d tensors on the
  device that ride the step's info dict, so the learner's ONE stacked
  device -> host copy (``host_scalars``) ships them: no ``.item()``, no
  host branch. Modules are the flax top-level module names
  (``model.convert.flax_names``), so keys and gauge labels are the JAX
  package's. The reductions are grouped, not per leaf: one concatenated
  buffer per family, read per module segment (norms accumulated in
  float64, censuses in int64).

* ``DynamicsMonitor`` — the host side, as the JAX package's: publishes the
  tree plus the routed loss info as bounded-cardinality ``distar_train_*``
  gauges, keeps a grad-norm EMA for explosion detection, and on anomaly
  (non-finite loss/grads, explosion vs EMA, entropy collapse) writes a
  debounced, capped **black-box bundle** in the JAX package's format
  (``BUNDLE_SCHEMA``, keys, file names; the state in the JAX checkpoint
  layout, ``model.convert.learner_state_to_flax``; the comm serializer's
  bytes), which ``python -m distar_tpu_torch.tools.stepreplay`` re-executes.

* ``first_nonfinite`` — provenance: the census is read batch > params >
  grads; the first family with a hit names the origin, not the blast
  radius.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Set, Tuple

from .flightrecorder import _versions, get_flight_recorder
from .registry import MetricsRegistry, get_registry
from .tracestore import note_exemplar

BUNDLE_SCHEMA = "distar.blackbox.v1"

DYNAMICS_DEFAULTS = {
    "enabled": True,
    # host-side gauge-export period (steps); the tree is computed every
    # step so detection has no blind window, and anomaly steps
    # force-publish regardless of the gate
    "every_n": 10,
    "ema_momentum": 0.99,
    # grad-norm explosion: ||g|| > factor * EMA(||g||), after warmup steps
    "explosion_factor": 10.0,
    "explosion_warmup": 20,
    # per-head |entropy| < floor => collapse (0 disables; RL-specific signal)
    "entropy_floor": 0.0,
    "blackbox": True,          # write forensic bundles on anomaly
    "blackbox_cap": 4,         # max bundles per process (disk guard)
    "blackbox_dir": "",        # default: <save_dir>/blackbox
    "blackbox_state": True,    # include post-step train state in the bundle
    "clear_n": 3,              # clean steps before an anomaly class re-arms
}

# bundle filenames are self-describing so listings never need to deserialize
_BUNDLE_RE = re.compile(r"^blackbox_(\d+)_step(\d+)_([a-z0-9_]+)\.bb$")

ANOMALY_CLASSES = (
    "loss_nonfinite",
    "grad_nonfinite",
    "grad_explosion",
    "entropy_collapse",
)


# --------------------------------------------------------------------- spec
@dataclass(frozen=True)
class DynamicsSpec:
    """What the step needs to know about the configured grad clip to report
    its activation."""

    clip_type: str = "none"
    clip_threshold: float = 1.0


def tree_spec(dynamics_cfg: Optional[dict], grad_clip_cfg: Optional[dict]
              ) -> Optional[DynamicsSpec]:
    """The spec the learner threads into its train step, or None when
    dynamics is disabled (the step then computes no tree: the 'off' arm of
    the overhead A/B)."""
    dcfg = dict(dynamics_cfg or {})
    if not dcfg.get("enabled", True):
        return None
    gc = dict(grad_clip_cfg or {})
    return DynamicsSpec(
        clip_type=str(gc.get("type", "none") or "none"),
        clip_threshold=float(gc.get("threshold", 1.0)),
    )


# ---------------------------------------------------------- in-step tree
def _tensor_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _tensor_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in _tensor_leaves(v)]
    return [tree] if hasattr(tree, "is_floating_point") else []


def _f32(t):
    import torch

    t = t.detach()
    return t if t.dtype == torch.float32 else t.float()


def _split_counts(flat, sizes: List[int]):
    """Per-segment non-finite element counts of a flat buffer, as one f32
    vector (int64 sums: exact)."""
    import torch

    bad = torch.isfinite(flat).logical_not_()
    return torch.stack([seg.sum() for seg in bad.split(sizes)]).float()


class DynamicsTree:
    """The tree's static layout for one model and one parameter list (the
    optimizer's order): each leaf's flax top-level module and the leaves in
    module order. Each family (params, grads, the update) is concatenated
    into one flat buffer in that order, then read per module segment: a
    norm accumulated in float64, a non-finite count in int64. Build once per
    learner; call ``before_update`` ahead of the optimizer (it reads
    pre-step params and raw grads) and ``after_update`` with the
    optimizer's update.

    The parameters, and so the grads and the update, are this rank's
    blocks as the model's placement gives them
    (``parallel.spmd.param_shards``): a rank reads only the leaves it
    counts (each block once over the mesh's shard group), and where the
    placement splits a leaf the sums of squares and counts are summed over
    that group, one all-reduce before the update and one after."""

    def __init__(self, model, params, spec: Optional[DynamicsSpec] = None):
        import torch

        from ..model.convert import flax_names
        from ..parallel.spmd import param_shards

        names = flax_names(model)
        by_id = {id(p): n for n, p in model.named_parameters()}
        shards = param_shards(model)
        leaves = [shards.index[by_id[id(p)]] for p in params]
        mods = [names[shards.names[i]].split("/")[1] for i in leaves]
        self.modules = sorted(set(mods))
        index = {m: i for i, m in enumerate(self.modules)}
        leaf_module = [index[m] for m in mods]
        self.order = sorted((k for k, i in enumerate(leaves) if shards.counted[i]), key=lambda k: leaf_module[k])
        self.sizes = [0] * len(self.modules)
        for k in self.order:
            self.sizes[leaf_module[k]] += params[k].numel()
        self.group = shards.mesh.group("shard")
        self.numel = sum(torch.Size(shards.shapes[i]).numel() for i in leaves)
        self.spec = spec
        self._float32 = all(p.dtype == torch.float32 for p in params)

    def _summed(self, *parts):
        """``parts`` (1-d tensors) summed over the shard group, in one
        all-reduce; as they are without one."""
        if self.group is None:
            return parts
        import torch
        import torch.distributed as dist

        flat = torch.cat([p.double() for p in parts])
        dist.all_reduce(flat, group=self.group)
        return tuple(seg.to(p.dtype) for seg, p in zip(flat.split([p.numel() for p in parts]), parts))

    def _flat(self, tensors):
        """The leaves in module order, flattened and concatenated in one
        native call (as DDP's buckets are): a Python call per leaf would be
        most of the tree's host time on a launch-bound step."""
        from torch._utils import _flatten_dense_tensors

        flat = _flatten_dense_tensors([tensors[i] for i in self.order])
        return flat if self._float32 else flat.float()

    def _module_sq(self, flat):
        """Per-module sums of squares, float64."""
        import torch

        return torch.stack([torch.linalg.vector_norm(seg, dtype=torch.float64)
                            for seg in flat.split(self.sizes)]).square()

    def before_update(self, params, grads, batch=None) -> Dict[str, Any]:
        """The tree's pre-update part: every key but the update ratios."""
        import torch

        with torch.no_grad():
            return self._before_update(params, grads, batch)

    def _before_update(self, params, grads, batch) -> Dict[str, Any]:
        from ..parallel.grad_clip import clip_activation, clipped_count

        out: Dict[str, Any] = {}
        pflat, gflat = self._flat(params), self._flat(grads)
        value_clip = self.spec is not None and self.spec.clip_type == "value"
        clipped = clipped_count([gflat], self.spec.clip_threshold) if value_clip else gflat.new_zeros(0)
        p2, g2, pbad, gbad, clipped = self._summed(
            self._module_sq(pflat), self._module_sq(gflat), _split_counts(pflat, self.sizes),
            _split_counts(gflat, self.sizes), clipped)
        pn, gn = p2.sqrt().float(), g2.sqrt().float()
        for i, mod in enumerate(self.modules):
            out[f"dyn/param_norm/{mod}"] = pn[i]
            out[f"dyn/grad_norm/{mod}"] = gn[i]
            out[f"dyn/nonfinite_grads/{mod}"] = gbad[i]
            out[f"dyn/nonfinite_params/{mod}"] = pbad[i]
        grad_norm_total = g2.sum().sqrt().float()
        out["dyn/param_norm/total"] = p2.sum().sqrt().float()
        out["dyn/grad_norm/total"] = grad_norm_total
        out["dyn/nonfinite_grads/total"] = gbad.sum()
        out["dyn/nonfinite_params/total"] = pbad.sum()
        if isinstance(batch, dict):
            out.update(batch_census(batch, pn.new_zeros(())))
        if self.spec is not None:
            frac, active = clip_activation(grad_norm_total, self.spec.clip_type, self.spec.clip_threshold,
                                           clipped, self.numel)
            out["dyn/clip_fraction"] = frac
            out["dyn/clip_active"] = active
        self._p2 = p2
        return out

    def after_update(self, update, lr: float) -> Dict[str, Any]:
        """The update-to-weight ratios of ``-lr * update`` (the parameters'
        step), against the pre-step norms ``before_update`` read."""
        import torch

        with torch.no_grad():
            return self._after_update(update, lr)

    def _after_update(self, update, lr: float) -> Dict[str, Any]:
        p2, self._p2 = self._p2, None
        u2 = self._summed(self._module_sq(self._flat(update)))[0] * (float(lr) ** 2)
        ratio = (u2.sqrt() / (p2.sqrt() + 1e-12)).float()
        out = {f"dyn/update_ratio/{mod}": ratio[i] for i, mod in enumerate(self.modules)}
        out["dyn/update_ratio/total"] = (u2.sum().sqrt() / (p2.sum().sqrt() + 1e-12)).float()
        return out


def batch_census(batch: dict, zero) -> Dict[str, Any]:
    """``dyn/nonfinite_batch/<top-level key>`` over each key's float leaves
    (a key with none emits no row) and ``/total``."""
    import torch

    keys, sizes, leaves = [], [], []
    for key in sorted(batch):
        floats = [t for t in _tensor_leaves(batch[key]) if t.is_floating_point()]
        if not floats:
            continue  # int-only obs can't be non-finite; don't emit a row
        keys.append(key)
        sizes.append(sum(t.numel() for t in floats))
        leaves += floats
    out: Dict[str, Any] = {}
    if not keys:
        out["dyn/nonfinite_batch/total"] = zero
        return out
    counts = _split_counts(torch.cat([_f32(t).reshape(-1) for t in leaves]), sizes)
    for i, key in enumerate(keys):
        out[f"dyn/nonfinite_batch/{key}"] = counts[i]
    out["dyn/nonfinite_batch/total"] = counts.sum()
    return out


def dynamics_tree(model, params, grads, update=None, lr: float = 1.0, batch=None,
                  spec: Optional[DynamicsSpec] = None) -> Dict[str, Any]:
    """The whole tree in one call, as the JAX package's ``dynamics_tree``:
    ``params`` pre-step, ``grads`` raw, ``update`` the optimizer's update
    (the parameters move by ``-lr * update``). Emits flat
    ``dyn/<family>/<module>`` 0-d float32 tensors:

    * ``dyn/grad_norm|param_norm|update_ratio/<module>`` + ``/total``
    * ``dyn/nonfinite_grads|nonfinite_params/<module>`` + ``/total``
    * ``dyn/nonfinite_batch/<top-level key>`` + ``/total`` (float leaves)
    * ``dyn/clip_fraction`` / ``dyn/clip_active`` (per ``spec``)

    A learner builds one ``DynamicsTree`` instead (the layout is static)."""
    tree = DynamicsTree(model, params, spec)
    out = tree.before_update(params, grads, batch)
    if update is not None:
        out.update(tree.after_update(update, lr))
    return out


# ---------------------------------------------------------- host-side views
def _f(val, default: float = 0.0) -> float:
    try:
        return float(val)
    except (TypeError, ValueError):
        return default


def _finite(val) -> bool:
    import math

    try:
        return math.isfinite(float(val))
    except (TypeError, ValueError):
        return False


def split_tree(log: Dict[str, Any]) -> Dict[str, Dict[str, float]]:
    """Group a host log dict's ``dyn/<family>/<module>`` scalars by family."""
    out: Dict[str, Dict[str, float]] = {}
    for key, val in log.items():
        if not key.startswith("dyn/"):
            continue
        parts = key.split("/", 2)
        if len(parts) == 3:
            out.setdefault(parts[1], {})[parts[2]] = _f(val)
        else:
            out.setdefault(parts[1], {})[""] = _f(val)
    return out


def first_nonfinite(log: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Localize an anomaly's origin from the censuses. Read order matters:
    one NaN in the batch makes EVERY module's grads non-finite via backprop,
    and a poisoned param does the same one hop later — so the narrowest
    family with a hit (batch, then pre-step params, then grads) names the
    origin rather than the blast radius."""
    for origin, prefix in (
        ("batch", "dyn/nonfinite_batch/"),
        ("params", "dyn/nonfinite_params/"),
        ("grads", "dyn/nonfinite_grads/"),
    ):
        hits = sorted(
            key[len(prefix):]
            for key, val in log.items()
            if key.startswith(prefix) and key[len(prefix):] != "total"
            and _f(val) > 0
        )
        if hits:
            return {"origin": origin, "module": hits[0], "all": hits}
    return None


def config_digest(cfg: Any) -> str:
    """Stable sha256 of a config mapping (canonical JSON, default=str)."""
    blob = json.dumps(cfg, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()


def _plain(obj):
    """JSON round-trip: Config/EasyDict trees become plain builtins."""
    return json.loads(json.dumps(obj, default=str))


def _host_tree(tree):
    """A tree of tensors (dicts, tuples, lists) as host numpy; other leaves
    stay (bfloat16 comes back as float32: numpy has no bfloat16)."""
    import torch

    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_host_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    return tree


# ------------------------------------------------------------------ bundles
def load_bundle(path: str) -> Dict[str, Any]:
    from ..comm import serializer

    with open(path, "rb") as f:
        bundle = serializer.loads(f.read())
    if bundle.get("schema") != BUNDLE_SCHEMA:
        raise ValueError(
            f"{path}: schema {bundle.get('schema')!r} != {BUNDLE_SCHEMA!r}"
        )
    return bundle


def bundle_summary(bundle: Dict[str, Any]) -> Dict[str, Any]:
    prov = bundle.get("provenance") or {}
    return {
        "schema": bundle.get("schema"),
        "step": bundle.get("step"),
        "reasons": bundle.get("reasons"),
        "learner": bundle.get("learner"),
        "origin": prov.get("origin"),
        "module": prov.get("module"),
        "config_digest": bundle.get("config_digest"),
        "ckpt": (bundle.get("checkpoint") or {}).get("path"),
        "ts": bundle.get("ts"),
    }


def list_bundles(dirpath: str) -> List[Dict[str, Any]]:
    """Cheap listing from filenames alone (no deserialization)."""
    out = []
    try:
        names = sorted(os.listdir(dirpath))
    except OSError:
        return out
    for name in names:
        m = _BUNDLE_RE.match(name)
        if m:
            out.append({
                "id": name,
                "path": os.path.join(dirpath, name),
                "seq": int(m.group(1)),
                "step": int(m.group(2)),
                "reason": m.group(3),
            })
    return sorted(out, key=lambda b: b["seq"])


# ------------------------------------------------------------------ monitor
class DynamicsMonitor:
    """Host-side consumer of the tree: gauge export, anomaly detection with
    EMA + debounce, and black-box capture.

    The learner run loop calls ``before_step`` (cheap: keeps tensor REFS of
    the aux state — the copy happens only if a bundle is written) and
    ``on_step`` with the already-fetched host log dict; this class adds no
    device sync on the healthy path.
    """

    def __init__(self, cfg: Optional[dict] = None, name: str = "learner",
                 registry: Optional[MetricsRegistry] = None,
                 blackbox_dir: str = ""):
        merged = dict(DYNAMICS_DEFAULTS)
        merged.update(dict(cfg or {}))
        self.cfg = merged
        self.enabled = bool(merged.get("enabled", True))
        self.every_n = max(1, int(merged.get("every_n", 10)))
        self.name = name
        self._reg = registry or get_registry()
        self.blackbox_dir = merged.get("blackbox_dir") or blackbox_dir
        self.ema: Optional[float] = None
        self.steps_seen = 0
        self.bundles_written = 0
        self.last_bundle_path: Optional[str] = None
        self.last_anomaly_step: Optional[int] = None
        self.last_capture_s: Optional[float] = None
        self._active: Set[str] = set()   # debounce: currently-firing classes
        self._clean = 0                  # consecutive anomaly-free steps
        self._aux: Optional[dict] = None

    # ------------------------------------------------------------- run hooks
    def before_step(self, learner) -> None:
        if not self.enabled:
            return
        aux_fn = getattr(learner, "_dynamics_aux", None)
        self._aux = aux_fn() if aux_fn is not None else None

    def on_step(self, learner, log: Dict[str, Any],
                batch: Any = None) -> Set[str]:
        """Detect → (maybe) capture → (maybe) publish → EMA. ``log`` is the
        host-side float dict the learner already fetched; ``batch`` is the
        step's input, captured only if a bundle is written. Returns the
        anomaly classes seen this step."""
        if not self.enabled:
            return set()
        step = int(learner.last_iter.val)
        anomalies, grad_norm = self.detect(log)
        sampled = self.steps_seen % self.every_n == 0
        self.steps_seen += 1
        fresh = anomalies - self._active
        self._active |= anomalies
        if (fresh and self.cfg.get("blackbox", True)
                and self.bundles_written < int(self.cfg.get("blackbox_cap", 4))):
            # the bundle, and its exemplar, BEFORE the anomaly's gauges: a
            # rule pass between a slow capture and the note would fire with
            # no exemplar (the JAX monitor publishes first)
            self.capture(learner, log, batch, step, sorted(anomalies))
        if sampled or anomalies:
            # anomaly steps force-publish: a NaN that only ever existed
            # between sample points would otherwise never reach the rules
            self.publish(log)
        if _finite(grad_norm):
            mom = float(self.cfg.get("ema_momentum", 0.99))
            self.ema = grad_norm if self.ema is None else (
                mom * self.ema + (1.0 - mom) * grad_norm
            )
            self._reg.gauge(
                "distar_train_grad_norm_ema",
                "EMA of the global gradient norm (explosion-rule baseline)",
            ).set(self.ema)
        if anomalies:
            self._clean = 0
            for reason in sorted(anomalies):
                self._reg.counter(
                    "distar_train_anomalies_total",
                    "training anomalies detected, by class",
                    reason=reason,
                ).inc()
            self.last_anomaly_step = step
            self._reg.gauge(
                "distar_train_last_anomaly_step",
                "step index of the most recent training anomaly",
            ).set(float(step))
        else:
            self._clean += 1
            if self._clean >= int(self.cfg.get("clear_n", 3)):
                self._active.clear()
        return anomalies

    # ------------------------------------------------------------- detection
    def detect(self, log: Dict[str, Any]) -> Tuple[Set[str], Optional[float]]:
        """Pure classification of one step's log dict; returns (classes,
        global grad norm). Uses only host floats — no device access."""
        anomalies: Set[str] = set()
        loss = log.get("total_loss")
        if loss is not None and not _finite(loss):
            anomalies.add("loss_nonfinite")
        grad_norm = log.get("dyn/grad_norm/total", log.get("grad_norm"))
        if grad_norm is not None and not _finite(grad_norm):
            anomalies.add("grad_nonfinite")
        for census in ("dyn/nonfinite_grads/total", "dyn/nonfinite_params/total",
                       "dyn/nonfinite_batch/total"):
            if _f(log.get(census)) > 0:
                anomalies.add("grad_nonfinite")
        if grad_norm is not None and _finite(grad_norm):
            warmup = int(self.cfg.get("explosion_warmup", 20))
            factor = float(self.cfg.get("explosion_factor", 10.0))
            if (self.ema is not None and self.steps_seen >= warmup
                    and self.ema > 0
                    and float(grad_norm) > factor * self.ema):
                anomalies.add("grad_explosion")
        floor = float(self.cfg.get("entropy_floor", 0.0))
        if floor > 0:
            for key, val in log.items():
                if not key.startswith("entropy/") or key == "entropy/total":
                    continue
                val = _f(val)
                # masked-out heads report exactly 0.0 — absence of the head,
                # not collapse of its distribution
                if val != 0.0 and abs(val) < floor:
                    anomalies.add("entropy_collapse")
                    break
        gn = float(grad_norm) if grad_norm is not None else None
        return anomalies, gn

    # ----------------------------------------------------------- publication
    def publish(self, log: Dict[str, Any]) -> None:
        """Flush the dyn/ tree + routed loss info into bounded gauges."""
        g = self._reg.gauge
        for key, raw in log.items():
            if not key.startswith("dyn/"):
                continue
            val = _f(raw, default=float("nan"))
            parts = key.split("/", 2)
            family = parts[1]
            module = parts[2] if len(parts) == 3 else ""
            if family == "grad_norm":
                g("distar_train_grad_norm",
                  "per-module gradient global-norm (module=total is global)",
                  module=module).set(val)
            elif family == "param_norm":
                g("distar_train_param_norm",
                  "per-module parameter global-norm",
                  module=module).set(val)
            elif family == "update_ratio":
                g("distar_train_update_ratio",
                  "per-module update-to-weight norm ratio",
                  module=module).set(val)
            elif family == "nonfinite_grads":
                g("distar_train_nonfinite_grads",
                  "non-finite gradient elements per module",
                  module=module).set(val)
            elif family == "nonfinite_params":
                g("distar_train_nonfinite_params",
                  "non-finite parameter elements per module (pre-step)",
                  module=module).set(val)
            elif family == "nonfinite_batch":
                g("distar_train_nonfinite_batch",
                  "non-finite elements per top-level batch leaf",
                  leaf=module).set(val)
            elif family == "clip_fraction":
                g("distar_train_grad_clip_fraction",
                  "fraction of gradient signal removed by the clip").set(val)
            elif family == "clip_active":
                g("distar_train_grad_clip_active",
                  "1 when the grad clip engaged this step").set(val)
        if self.ema is not None:
            gn = log.get("dyn/grad_norm/total", log.get("grad_norm"))
            if gn is not None and _finite(gn) and self.ema > 0:
                g("distar_train_grad_norm_explosion",
                  "grad norm over its EMA (explosion-rule input)",
                  ).set(float(gn) / self.ema)
        self.route_losses(log)

    def route_losses(self, log: Dict[str, Any]) -> None:
        """The rl/sl/distill info dicts become ``distar_train_*`` loss
        gauges; the vocabularies live next to the loss code
        (``losses/__init__``); anything off-vocabulary stays in the log
        buffer."""
        from ..losses import HEADS, LOSS_TERMS, REWARD_FIELDS, SL_METRIC_KEYS

        g = self._reg.gauge
        heads, fields = set(HEADS), set(REWARD_FIELDS)
        terms = set(LOSS_TERMS)
        sl_heads = ("action_type", "delay", "queued", "selected_units",
                    "target_unit", "target_location")
        pg_by_head: Dict[str, float] = {}
        for key, raw in log.items():
            if key.startswith("dyn/"):
                continue
            val = _f(raw, default=float("nan"))
            if key == "total_loss":
                g("distar_train_loss_term",
                  "loss terms (term=total is the optimized sum)",
                  term="total").set(val)
                continue
            if key == "divergence":
                g("distar_train_loss_term",
                  "loss terms (term=total is the optimized sum)",
                  term="divergence").set(val)
                continue
            if key in SL_METRIC_KEYS:
                g("distar_train_sl_metric",
                  "supervised accuracy/distance metrics by metric name",
                  metric=key).set(val)
                continue
            for head in sl_heads:
                if key == f"{head}_loss" or (
                        head == "selected_units" and key == "selected_units_loss"):
                    g("distar_train_loss_head",
                      "per-head loss contribution by term",
                      term="sl", head=head).set(val)
                    break
            parts = key.split("/")
            if len(parts) == 2:
                term, leaf = parts
                if term in terms and leaf == "total":
                    g("distar_train_loss_term",
                      "loss terms (term=total is the optimized sum)",
                      term=term).set(val)
                elif term in ("td", "reward", "value") and leaf in fields:
                    g("distar_train_loss_field",
                      "per-reward-field loss/values by term",
                      term=term, field=leaf).set(val)
                elif leaf in heads and term in terms:
                    g("distar_train_loss_head",
                      "per-head loss contribution by term",
                      term=term, head=leaf).set(val)
                    if term == "entropy" and val != 0.0:
                        # masked-out heads report exactly 0.0 — publishing
                        # it would trip the collapse rule on head absence
                        g("distar_train_entropy",
                          "per-head policy entropy (collapse-rule input)",
                          head=leaf).set(val)
                elif key == "kl/extra_at":
                    g("distar_train_loss_head",
                      "per-head loss contribution by term",
                      term="kl", head="extra_at").set(val)
            elif len(parts) == 3 and parts[0] == "pg":
                # pg/{field}/{head}: per-head pg is the field-sum
                if parts[1] in fields and parts[2] in heads:
                    pg_by_head[parts[2]] = pg_by_head.get(parts[2], 0.0) + val
        for head, val in sorted(pg_by_head.items()):
            g("distar_train_loss_head",
              "per-head loss contribution by term",
              term="pg", head=head).set(val)

    # --------------------------------------------------------------- capture
    def capture(self, learner, log: Dict[str, Any], batch: Any,
                step: int, reasons: List[str]) -> Optional[str]:
        """Write the forensic black-box bundle. The ONLY place the monitor
        touches the device — and only inside an anomaly, where a copy to
        the host is the least of the step's problems."""
        from ..comm import serializer

        t0 = time.perf_counter()
        dirpath = self.blackbox_dir or os.path.join(os.getcwd(), "blackbox")
        try:
            os.makedirs(dirpath, exist_ok=True)
            host_batch = _host_tree(batch) if batch is not None else None
            aux = _host_tree(self._aux) if self._aux is not None else None
            state = None
            if self.cfg.get("blackbox_state", True):
                state = learner.state
            cfg_plain = _plain(learner.cfg)
            provenance = first_nonfinite(log)
            ckpt = None
            try:
                ckpt = learner.checkpoint_manager.resolve_latest()
            except Exception:
                pass
            bundle = {
                "schema": BUNDLE_SCHEMA,
                "ts": time.time(),
                "step": step,
                "reasons": list(reasons),
                "learner": learner.name,
                "prng_seed": int(getattr(learner, "init_prng_seed", 0)),
                "batch": host_batch,
                "aux": aux,
                # the step updates the parameters in place, so the pre-step
                # state is gone: this state is one optimizer step PAST the
                # anomaly (replay restores it; param-origin anomalies replay
                # from the batch + the already-poisoned params)
                "state": state,
                "state_note": "one optimizer step PAST the anomaly (donated buffers)",
                "diagnostics": {k: _f(v, default=float("nan"))
                                for k, v in log.items()},
                "provenance": provenance,
                "checkpoint": ckpt,
                "config": cfg_plain,
                "config_digest": config_digest(cfg_plain),
                "versions": _versions(),
            }
            fname = (f"blackbox_{self.bundles_written:03d}_step{step}_"
                     f"{reasons[0]}.bb")
            path = os.path.join(dirpath, fname)
            with open(path, "wb") as f:
                f.write(serializer.dumps(bundle, compress=True))
        except Exception as e:  # forensics must never kill the run it studies
            try:
                learner.logger.error(f"black-box capture failed: {e!r}")
            except Exception:
                pass
            return None
        self.last_capture_s = time.perf_counter() - t0
        self.bundles_written += 1
        self.last_bundle_path = path
        trace_id = f"blackbox:{fname}"
        gn = log.get("dyn/grad_norm/total", log.get("grad_norm"))
        # the firing alerts' exemplar slot points at the bundle, so the
        # on-call path is alert -> bundle id -> stepreplay; keys are the
        # metric FAMILIES the default rulebook watches
        note_exemplar("distar_train_grad_norm", trace_id, _f(gn))
        note_exemplar("distar_train_nonfinite_grads", trace_id,
                      _f(log.get("dyn/nonfinite_grads/total")))
        note_exemplar("distar_train_grad_norm_explosion", trace_id, _f(gn))
        note_exemplar("distar_train_entropy", trace_id,
                      _f(log.get("entropy/total")))
        note_exemplar("distar_learner_loss", trace_id, _f(log.get("total_loss")))
        self._reg.counter(
            "distar_train_blackbox_bundles_total",
            "forensic black-box bundles written",
        ).inc()
        rec = get_flight_recorder()
        rec.record(
            "dynamics_anomaly", step=step, reasons=list(reasons),
            bundle=fname, learner=learner.name,
            provenance=bundle.get("provenance"),
        )
        try:
            rec.dump(
                artifact_dir=dirpath, reason=f"dynamics:{reasons[0]}",
                config=bundle["config"], registry=self._reg,
                extra={"blackbox": bundle_summary(bundle)},
            )
        except Exception:
            pass
        try:
            learner.logger.warning(
                f"training anomaly {reasons} at step {step}: "
                f"black box -> {path}"
            )
        except Exception:
            pass
        return path
