"""Supervised-learning launcher.

    python -m distar_tpu_torch.bin.sl_train --type learner --iters 2 --smoke-model --device cpu

Counterpart of ``distar_tpu.bin.sl_train``. The learner role trains on the
fake dataloader (schema-complete random batches), on CUDA unless
``--device`` says otherwise. The replay actor and coordinator roles, replay
data (``--data``), remote data (``--remote``) and the held-out evaluation
(``--eval-data``) need the SL learner runtime, which is not ported yet
(ROADMAP Queue 1 item 4).

``--config`` takes what the JAX launcher's does, a YAML file, and also a JSON
file or an inline JSON object. Its ``model`` block replaces the smoke model
over ``default_model_config()``, as in the JAX launcher; its ``learner``
block cascades over the learner defaults, and its ``batch_size`` and
``unroll_len`` stand where ``--batch-size`` and ``--traj-len`` are not given:

    python -m distar_tpu_torch.bin.sl_train --full-model --config \
        '{"model": {"encoder": {"scatter": {"impl": "pallas"}}}, "learner": {"log_freq": 1}}'
"""
from __future__ import annotations

import argparse
from typing import Iterable, Optional, Sequence

from ..learner import SLLearner
from ..utils import read_config

NOT_PORTED = "not ported yet: the SL learner runtime (ROADMAP Queue 1 item 4)"

# the JAX launchers' smoke model (distar_tpu/bin/rl_train.py SMOKE_MODEL)
SMOKE_MODEL = {
    "encoder": {
        "entity": {"layer_num": 1, "hidden_dim": 32, "output_dim": 16, "head_dim": 8},
        "spatial": {"down_channels": [4, 4, 8], "project_dim": 4, "resblock_num": 1, "fc_dim": 16},
        "scatter": {"output_dim": 4},
        "core_lstm": {"hidden_size": 32, "num_layers": 1},
    },
    "policy": {
        "action_type_head": {"res_dim": 16, "res_num": 1, "gate_dim": 32},
        "delay_head": {"decode_dim": 16},
        "queued_head": {"decode_dim": 16},
        "selected_units_head": {"func_dim": 16},
        "target_unit_head": {"func_dim": 16},
        "location_head": {"res_dim": 8, "res_num": 1, "upsample_dims": [4, 4, 1], "map_skip_dim": 8},
    },
    "value": {"res_dim": 8, "res_num": 1},
}


def learner(args, dataloader: Optional[Iterable] = None) -> SLLearner:
    """Build the SL learner the flags and ``--config`` describe, train
    ``args.iters`` steps (on ``dataloader`` when given, else the fake
    dataloader) and return it."""
    user_cfg = read_config(args.config) if args.config else {}
    learner_cfg = user_cfg.get("learner", {})
    lrn = SLLearner(
        {
            "learner": {
                "log_freq": max(args.iters // 4, 1),
                **learner_cfg,
                "batch_size": args.batch_size or int(learner_cfg.get("batch_size", 2)),
                "unroll_len": args.traj_len or int(learner_cfg.get("unroll_len", 8)),
            },
            "model": user_cfg.get("model", SMOKE_MODEL if args.smoke_model else {}),
        },
        device=args.device,
    )
    if dataloader is not None:
        lrn.set_dataloader(dataloader)
    lrn.run(args.iters)
    log = lrn.last_log
    print(f"sl_train done: {lrn.last_iter} iters, loss={log.get('total_loss', float('nan')):.4f}, "
          f"action_type_acc={log.get('action_type_acc', float('nan')):.4f}", flush=True)
    return lrn


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--type", default="learner", choices=("learner", "replay_actor", "coordinator"))
    p.add_argument("--config", default="",
                   help="YAML or JSON file, or inline JSON: 'model' and 'learner' overrides")
    p.add_argument("--iters", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=None, help="default: the config's, else 2")
    p.add_argument("--traj-len", type=int, default=None, help="default: the config's, else 8")
    p.add_argument("--smoke-model", action="store_true", default=True)
    p.add_argument("--full-model", dest="smoke_model", action="store_false",
                   help="default_model_config() at full width and depth")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; raises without CUDA unless 'cpu')")
    p.add_argument("--data", default="", help=NOT_PORTED)
    p.add_argument("--remote", action="store_true", help=NOT_PORTED)
    p.add_argument("--eval-data", default="", help=NOT_PORTED)
    return p


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parser().parse_args(argv)
    if args.type != "learner":
        raise NotImplementedError(f"--type {args.type}: {NOT_PORTED}")
    for flag, given in (("--data", args.data), ("--remote", args.remote),
                        ("--eval-data", args.eval_data)):
        if given:
            raise NotImplementedError(f"{flag}: {NOT_PORTED}")
    learner(args)


if __name__ == "__main__":
    main()
