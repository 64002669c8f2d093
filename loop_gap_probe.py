"""The RL strings' gradient gap on actor-made batches, on the card
(ROADMAP Queue 3 item 1).

    python3 loop_gap_probe.py [N]

Builds ``chip_smoke.py``'s rl_loop (``bin/rl_train.py --type all`` at the
flagship: kernel overlay, f32, the league and sizes of that phase), runs the
actor's job loop and draws up to N (default 12) of the learner's batches of
actor-made trajectories, without training. On each it reads the kernel
strings' whole gradients against 'xla' unpinned (``hold_strings``, the
loop check's reading); the first batch that reads above 1e-3 is saved under
``chiprun_out/`` and held by ``chip_smoke.hold_loop_batch`` with the
tolerance lowered to 1e-3 for this script, so the pinned probe (``rl_gap``:
every ReLU, max-pool and UPGO decision pinned to an f64 run's, and the
smooth copy) runs on it and must put the strings within GAP_TOL. Prints one
JSON line per batch and the probe's readings; exits 1 if the probe fails,
2 without CUDA, 3 when no batch read above 1e-3.
"""
from __future__ import annotations

import json
import os
import sys
import time

PROBE_ABOVE = 1e-3  # the readings are either about 5e-6 or above this


def main(argv=None) -> int:
    import torch

    if not torch.cuda.is_available():
        print("loop_gap_probe: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as C

    from distar_tpu_torch.bin import rl_train
    from distar_tpu_torch.learner import rl_loss
    from distar_tpu_torch.learner.data import as_float32
    from distar_tpu_torch.ops import build

    n = int((argv if argv is not None else sys.argv[1:] or ["12"])[0])
    device = torch.device("cuda")
    print(C.smi_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    tmp = os.path.join(C.REPO, "chiprun_out", "loop_gap_probe")
    os.makedirs(tmp, exist_ok=True)
    os.environ["DISTAR_EXPERIMENTS_ROOT"] = os.path.join(tmp, "experiments")
    args = rl_train.parser().parse_args([
        "--type", "all", "--full-model", "--iters", "1", "--batch-size", str(C.RL_B), "--traj-len", str(C.RL_T),
        "--env-num", str(C.LOOP_ENV_NUM), "--episode-game-loops", str(C.LOOP_EPISODE_LOOPS),
        "--save-path", os.path.join(tmp, "rl_loop"), "--device", device.type,
        "--config", json.dumps({"model": C.overlay("pallas", "pallas"), "league": C.LOOP_LEAGUE})])
    rl_train._resolve_args(args)
    loop = rl_train.build_all(args)
    rl_fn = lambda lrn, tb: rl_loss(lrn.model, lrn.loss_cfg, tb, C.RL_B, C.RL_T)  # noqa: E731
    learners = {impl: C.rl_learner(device, impl) for impl in C.STRINGS}
    readings, probe = [], None
    loop.supervisor.start()
    try:
        for i in range(n):
            t0 = time.perf_counter()
            batch = next(loop.learner._dataloader)
            held = as_float32({k: v for k, v in batch.items() if k not in ("trace_span_ids", "trace_age_s")})
            dist = C.hold_strings(f"loop gap probe: batch {i}", learners, held, rl_fn, hold_gradient=False)["strings"]
            readings.append(dist)
            print(json.dumps({"batch": i, "unpinned": dist, "s": time.perf_counter() - t0}), flush=True)
            if max(dist.values()) > PROBE_ABOVE:
                del learners
                saved, C.GRAD_TOL = C.GRAD_TOL, PROBE_ABOVE
                try:
                    probe = C.hold_loop_batch(device, held, rl_fn, dist, what=f"loop gap probe batch {i}")
                finally:
                    C.GRAD_TOL = saved
                break
    except C.SmokeFailure as e:
        print(f"loop_gap_probe: FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        loop.supervisor.stop(timeout=120)
        rl_train.close_all(loop)
    print(json.dumps({"readings": readings, "probe": probe}))
    return 0 if probe is not None else 3


if __name__ == "__main__":
    sys.exit(main())
