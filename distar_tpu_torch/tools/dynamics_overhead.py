"""dynamics_overhead: paired A/B cost of the training-dynamics diagnostics.

Counterpart of the JAX package's ``tools/dynamics_overhead.py``, with its
artifact's keys, on the port's ``SLLearner``. Two real learners are built
once in the same process (full model, batch 2, unroll 8 by default):

  * **on**: what production ships, the per-module diagnostics tree
    (grad/param norms, update ratios, non-finite censuses, clip fraction)
    computed inside the train step and riding the step's one host copy;
    gauge export every ``--every-n`` steps;
  * **off**: ``dynamics.enabled: false``, the step without the tree.

Arms interleave (ABAB...) and the verdict is the MEDIAN of PAIRED
per-visit ratios: each visit's on/off ran back to back, so the ratio
cancels the host's slow load drift. How many timed ON steps crossed an
export point rides in-band, with the gauge-publish cost measured apart and
amortized into the headline as ``publish_s / (every_n * step_s_off)``.
Each visit ends in the step's host copy, so it is synchronous with the
device. Exit 0 when the headline is within ``--envelope-pct`` (5%).

    python -m distar_tpu_torch.tools.dynamics_overhead --artifact dyn.json
    python -m distar_tpu_torch.tools.dynamics_overhead --iterations 2 --small --device cpu  # smoke

``--device`` is CUDA by default and raises without CUDA unless ``cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import time
from typing import List

SMALL_MODEL = {
    "encoder": {
        "entity": {"layer_num": 1, "hidden_dim": 32, "output_dim": 16,
                   "head_dim": 8},
        "spatial": {"down_channels": [4, 4, 8], "project_dim": 4,
                    "resblock_num": 1, "fc_dim": 16},
        "scatter": {"output_dim": 4},
        "core_lstm": {"hidden_size": 32, "num_layers": 1},
    },
    "policy": {
        "action_type_head": {"res_dim": 16, "res_num": 1, "gate_dim": 32},
        "delay_head": {"decode_dim": 16},
        "queued_head": {"decode_dim": 16},
        "selected_units_head": {"func_dim": 16},
        "target_unit_head": {"func_dim": 16},
        "location_head": {"res_dim": 8, "res_num": 1,
                          "upsample_dims": [4, 4, 1], "map_skip_dim": 8},
    },
    "value": {"res_dim": 8, "res_num": 1},
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--unroll", type=int, default=8)
    p.add_argument("--every-n", type=int, default=10,
                   help="ON arm's dynamics export frequency (the production "
                        "default; the tree itself runs every step inside the step)")
    p.add_argument("--iterations", type=int, default=3,
                   help="interleaved paired visits (median ratio wins)")
    p.add_argument("--steps-per-visit", type=int, default=1)
    p.add_argument("--envelope-pct", type=float, default=5.0,
                   help="acceptance: headline overhead within this percent")
    p.add_argument("--small", action="store_true",
                   help="tiny model smoke mode (NOT the flagship claim)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; raises without CUDA unless 'cpu')")
    p.add_argument("--artifact", default="",
                   help="write JSON lines here (last line = summary)")
    args = p.parse_args(argv)

    os.environ.setdefault("DISTAR_PERF_AOT", "0")
    os.environ.setdefault("DISTAR_EXPERIMENTS_ROOT",
                          tempfile.mkdtemp(prefix="dyn_overhead_"))

    from ..actor.inference import resolve_device
    from ..fleet import pinning
    from ..learner import SLLearner

    device = resolve_device(args.device)

    def build(tag: str, dynamics_cfg: dict) -> "SLLearner":
        cfg = {
            "common": {"experiment_name": f"dyn_overhead_{tag}"},
            "learner": {
                "batch_size": args.batch, "unroll_len": args.unroll,
                "save_freq": 10 ** 9, "log_freq": 10 ** 9,
                "dynamics": dynamics_cfg,
            },
        }
        if args.small:
            cfg["model"] = SMALL_MODEL
        return SLLearner(cfg, device=device)

    t0 = time.perf_counter()
    on = build("on", {"enabled": True, "every_n": args.every_n,
                      "blackbox": False})
    off = build("off", {"enabled": False})
    for learner in (on, off):
        # every run() exit writes a checkpoint (SaveCkptHook after_run):
        # serialization inside the timed visit on the full model; this
        # harness times train steps, not checkpointing
        learner.hooks._hooks["after_run"] = [
            h for h in learner.hooks._hooks["after_run"]
            if h.name != "save_ckpt"]
    lines: List[dict] = []
    last_log = {}

    def visit(learner, steps: int) -> float:
        """Time ``steps`` full iterations (data + step + the log copy that
        the diagnostics tree rides); _train copies the info tree to the
        host, so the visit is synchronous with the device by construction."""
        target = int(learner.last_iter.val) + steps
        t = time.perf_counter()
        learner.run(max_iterations=target)
        return (time.perf_counter() - t) / steps

    # warmup arm by arm: first executes (kernel builds, allocator growth)
    # never enter the timing
    for learner in (on, off):
        visit(learner, 1)
        visit(learner, 1)
    last_log.update(on.log_buffer)
    setup_s = time.perf_counter() - t0

    arms = {"on": [], "off": []}
    for i in range(max(1, args.iterations)):
        for name, learner in (("on", on), ("off", off)):
            step_s = visit(learner, args.steps_per_visit)
            row = {"metric": "dynamics overhead arm",
                   "case": f"dynamics_{name}", "iteration": i,
                   "step_s": round(step_s, 4)}
            arms[name].append(step_s)
            lines.append(row)
            print(json.dumps(row), flush=True)  # lint: allow-print

    # export steps the timed ON window actually crossed (steps_seen gates
    # publish; warmup consumed step 0, which always publishes)
    timed_on = args.iterations * args.steps_per_visit
    export_steps_timed = sum(
        1 for s in range(1, 1 + timed_on) if s % args.every_n == 0)
    # the gauge-publish leg, measured directly on a real host log dict
    # (pure host work: the device copy already happened inside _train)
    t = time.perf_counter()
    on._dynamics.publish({k: v for k, v in last_log.items()
                          if isinstance(v, (int, float))})
    publish_s = time.perf_counter() - t

    ratios = [a / b for a, b in zip(arms["on"], arms["off"]) if b > 0]
    ratio = statistics.median(ratios) if ratios else 1.0
    step_s_off = statistics.median(arms["off"])
    amortized_publish_pct = (
        publish_s / (args.every_n * step_s_off) * 100.0 if step_s_off else 0.0)
    overhead_pct = (ratio - 1.0) * 100.0 + amortized_publish_pct
    within = overhead_pct <= args.envelope_pct

    summary = {
        "metric": "training-dynamics diagnostics overhead "
                  "(in-step tree + export, SL "
                  + ("tiny-model SMOKE" if args.small else "flagship")
                  + f" {device.type} config, paired A/B)",
        "value": round(overhead_pct, 3),
        "unit": "% step-time",
        "overhead_pct": round(overhead_pct, 3),
        "tree_overhead_pct": round((ratio - 1.0) * 100.0, 3),
        "publish_s": round(publish_s, 5),
        "publish_amortized_pct": round(amortized_publish_pct, 4),
        "export_steps_timed": export_steps_timed,
        "paired_ratios": [round(r, 4) for r in ratios],
        "step_s_on": round(statistics.median(arms["on"]), 4),
        "step_s_off": round(step_s_off, 4),
        "every_n": args.every_n,
        "batch": args.batch, "unroll": args.unroll,
        "small_model": bool(args.small),
        "iterations": args.iterations,
        "steps_per_visit": args.steps_per_visit,
        "setup_s": round(setup_s, 1),
        "envelope_pct": args.envelope_pct,
        "within_envelope": within,
        "ab_label": "dynamics",
        "device": device.type,
        "cpu_derived": device.type == "cpu",
        "host_cores": pinning.host_cores(),
        # not a scaling claim — one process, both arms interleaved in the
        # SAME interpreter sharing identical host state (that sharing IS
        # the isolation here; there is nothing to pin apart)
        "scaling_valid": False,
        "pinning": {"pinned": False,
                    "reason": "single-process interleaved A/B: both arms "
                              "share one interpreter and host state"},
        "ts": time.time(),
    }
    lines.append(summary)
    print(json.dumps(summary), flush=True)  # lint: allow-print
    if args.artifact:
        with open(args.artifact, "w") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0 if within else 1


if __name__ == "__main__":
    raise SystemExit(main())
