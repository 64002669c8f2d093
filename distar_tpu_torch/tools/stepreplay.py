"""stepreplay: deterministically re-execute a black-box anomaly bundle.

Counterpart of the JAX package's ``tools/stepreplay.py``. The
training-dynamics observatory (``obs/dynamics.py``) answers "what
happened" with a forensic bundle: the offending batch, pre-step aux (the
SL carry, the RL value-pretrain gate), init seed, step index, checkpoint
pointer, config digest and the diagnostics tree that localized the first
non-finite module. This tool rebuilds the learner from the bundle's own
config, restores the bundle's state (the JAX checkpoint layout, so a
bundle of either package replays here), and re-executes that one train
step at least twice:

  python -m distar_tpu_torch.tools.stepreplay --bundle exp/blackbox/blackbox_000_step7_grad_nonfinite.bb
  python -m distar_tpu_torch.tools.stepreplay --bundle ... --device cpu --json
  python -m distar_tpu_torch.tools.stepreplay --bundle ... --params init   # replay from a
        # fresh init from the recorded seed (the port's init) instead of the
        # captured state: batch-borne vs state-borne anomalies

``--device`` (default: CUDA) takes the place of the JAX tool's
``--platform``. The replays run under
``torch.use_deterministic_algorithms(True, warn_only=True)`` with cuBLAS's
deterministic workspace; an op that has no deterministic implementation is
named in ``nondeterministic_ops``.

Verdict (exit 0 only when the bundle is a faithful reproduction):

  * ``nonfinite_reproduced`` — the replayed step is non-finite again
    (loss, grad norm, or any census total), required whenever the bundle's
    reasons include a non-finite class;
  * ``provenance_confirmed`` — the census family/module the ORIGINAL run
    blamed is non-finite in the replay too;
  * ``deterministic`` — the replays are BIT-equal: every logged scalar and
    every post-step state leaf, NaN payloads included.

The bundled state is one optimizer step PAST the anomaly (the step updates
in place): batch-origin anomalies reproduce regardless, param-origin ones
because the post-step params are already poisoned by the NaN update.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import warnings


def _parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--bundle", required=True, help="path to a .bb bundle")
    p.add_argument("--device", default=None,
                   help="torch device for the replay (default: CUDA, raising where there is none)")
    p.add_argument("--params", choices=("bundle", "init"), default="bundle",
                   help="'bundle': restore the captured (post-anomaly) state; 'init': fresh init "
                        "from the recorded seed — isolates batch-borne anomalies")
    p.add_argument("--runs", type=int, default=2, help="replays to compare for bit-equality (>= 2)")
    p.add_argument("--workdir", default="", help="scratch experiment dir (default: a tempdir)")
    p.add_argument("--json", action="store_true", help="print the verdict as one JSON object")
    return p.parse_args(argv)


def _bits(x) -> bytes:
    """Bit-exact fingerprint of a host scalar/array (NaN payloads count)."""
    import numpy as np

    return np.asarray(x).tobytes()


def _tree_bits(tree, prefix="") -> "list[tuple[str, bytes]]":
    if isinstance(tree, dict):
        return [b for k in sorted(tree) for b in _tree_bits(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (tuple, list)):
        return [b for i, v in enumerate(tree) for b in _tree_bits(v, f"{prefix}/{i}")]
    return [(prefix, _bits(tree))] if hasattr(tree, "shape") else []


def _nonfinite(log: dict) -> bool:
    for key in ("total_loss", "grad_norm", "dyn/grad_norm/total"):
        v = log.get(key)
        if v is not None and not math.isfinite(float(v)):
            return True
    for key in ("dyn/nonfinite_grads/total", "dyn/nonfinite_params/total",
                "dyn/nonfinite_batch/total"):
        if float(log.get(key, 0.0) or 0.0) > 0:
            return True
    return False


def replay(bundle: dict, params_from: str = "bundle", runs: int = 2, device=None) -> dict:
    """Rebuild the learner from the bundle's config on ``device``,
    re-execute the captured step ``runs`` times from identical restored
    state under deterministic algorithms, and return the verdict dict."""
    import numpy as np
    import torch

    from ..learner import DistillLearner, RLLearner, SLLearner
    from ..model.convert import load_learner_state
    from ..obs.dynamics import config_digest, first_nonfinite

    classes = {"sllearner": SLLearner, "rllearner": RLLearner, "distilllearner": DistillLearner}
    cls = classes.get(bundle.get("learner", ""))
    if cls is None:
        raise SystemExit(f"unknown learner role {bundle.get('learner')!r} (know {sorted(classes)})")

    cfg = bundle["config"]
    digest_drift = config_digest(cfg) != bundle.get("config_digest")
    # every filesystem side effect into the scratch dir, and the replay kept
    # out of the anomaly business (no nested bundles)
    cfg.setdefault("common", {})["save_path"] = os.environ.get(
        "DISTAR_EXPERIMENTS_ROOT") or tempfile.mkdtemp(prefix="stepreplay_")
    cfg.setdefault("learner", {}).setdefault("dynamics", {})["blackbox"] = False

    learner = cls(cfg, device=device)
    if int(bundle.get("prng_seed", 0)) != learner.init_prng_seed:
        learner.init_prng_seed = int(bundle["prng_seed"])
        learner._setup_state()
    source = bundle.get("state") if params_from == "bundle" else learner.state
    if source is None:
        raise SystemExit("bundle carries no state (blackbox_state was off); rerun with --params init")
    aux = bundle.get("aux") or {}

    def arm():
        """Reset the learner to the bundle's captured pre-step conditions."""
        load_learner_state(source, learner.model, learner.optimizer)
        if "hidden_state" in aux and hasattr(learner, "hidden"):
            learner.hidden = tuple(
                (torch.as_tensor(np.asarray(h), device=learner.device),
                 torch.as_tensor(np.asarray(c), device=learner.device))
                for h, c in aux["hidden_state"])
        if "only_update_value" in aux and hasattr(learner, "_remaining_value_pretrain"):
            learner._remaining_value_pretrain = 1 if aux["only_update_value"] else 0

    batch = dict(bundle["batch"])
    batch.pop("_on_device", None)  # host copies are placed again on this host

    logs, states, offenders = [], [], set()
    deterministic_before = torch.are_deterministic_algorithms_enabled()
    warn_only_before = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(max(2, runs)):
                arm()
                logs.append(learner._train(dict(batch)))
                states.append(_tree_bits(learner.state))
        for w in caught:
            text = str(w.message)
            if "deterministic" in text:
                offenders.add(text.split(". ")[0][:200])
    finally:
        torch.use_deterministic_algorithms(deterministic_before, warn_only=warn_only_before)

    deterministic = all(
        set(log) == set(logs[0]) and all(_bits(log[k]) == _bits(logs[0][k]) for k in logs[0])
        for log in logs[1:]
    ) and all(s == states[0] for s in states[1:])

    reproduced = _nonfinite(logs[0])
    prov = bundle.get("provenance") or None
    prov_confirmed = None
    if prov:
        replay_prov = first_nonfinite(logs[0])
        key = f"dyn/nonfinite_{prov['origin']}/{prov['module']}"
        prov_confirmed = bool(
            float(logs[0].get(key, 0.0) or 0.0) > 0
            # post-step params are one NaN update past a batch/param poison,
            # so the replay may localize UPSTREAM of the original blame —
            # accept a same-or-narrower origin naming the same module
            or (replay_prov is not None and replay_prov["module"] == prov["module"])
        )

    expect_nonfinite = any(r in ("loss_nonfinite", "grad_nonfinite")
                           for r in bundle.get("reasons", ()))
    ok = deterministic and (reproduced or not expect_nonfinite) and prov_confirmed is not False
    return {
        "bundle_step": bundle.get("step"),
        "reasons": bundle.get("reasons"),
        "learner": bundle.get("learner"),
        "params_from": params_from,
        "runs": max(2, runs),
        "device": str(learner.device),
        "config_digest_drift": digest_drift,
        "nonfinite_reproduced": reproduced,
        "nonfinite_expected": expect_nonfinite,
        "provenance_recorded": prov,
        "provenance_confirmed": prov_confirmed,
        "deterministic": deterministic,
        "nondeterministic_ops": sorted(offenders),
        "total_loss": float(logs[0].get("total_loss", float("nan"))),
        "ok": ok,
    }


def main(argv=None) -> int:
    args = _parse_args(argv)
    # cuBLAS's deterministic workspace must be set before its first use
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    # a flop count would only add noise to forensics
    os.environ.setdefault("DISTAR_PERF_AOT", "0")
    os.environ["DISTAR_EXPERIMENTS_ROOT"] = args.workdir or tempfile.mkdtemp(prefix="stepreplay_")

    from ..obs.dynamics import bundle_summary, load_bundle

    bundle = load_bundle(args.bundle)
    if not args.json:
        print(f"bundle: {json.dumps(bundle_summary(bundle), default=str)}")
    verdict = replay(bundle, params_from=args.params, runs=args.runs, device=args.device)
    if args.json:
        print(json.dumps(verdict, default=str))
    else:
        for k, v in verdict.items():
            print(f"  {k}: {v}")
        print("verdict: anomaly reproduced deterministically from the bundle alone"
              if verdict["ok"] else "verdict: REPLAY FAILED")
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
