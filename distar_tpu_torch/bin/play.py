"""Play/eval launcher: agent-vs-agent matches and a winrate report.

    python -m distar_tpu_torch.bin.play --game_type mock --device cpu --game-count 2

Counterpart of ``distar_tpu.bin.play``, on CUDA unless ``--device`` says
otherwise. Its game-free ``mock`` mode runs an ``Actor`` on ``MockEnv``s
with an explicit ``eval_test`` job between ``model1`` and ``model2``:
``--model1``/``--model2`` are checkpoints the port (or the JAX package)
wrote, loaded with ``utils.checkpoint.load_params`` and taken to the
policy-only model through ``model.convert.policy_params_from_flax``; a side
without one plays on the actor's seeded weights. The last line is the JAX
launcher's ``report``: ``games=N side0_winrate=.. side1_winrate=.. ties=..``.

Not ported yet, each raising ``NotImplementedError`` naming ROADMAP Queue 1
item 10 (``envs/sc2/``): the SC2 game types (``agent_vs_agent``,
``agent_vs_bot``, ``human_vs_agent``), the LAN showmatch (``--lan``,
``--lan-host``) and reference ``.pth`` checkpoints (``ref_convert``).
"""
from __future__ import annotations

import argparse
import os
from collections import Counter
from typing import Optional, Sequence

import torch

from ..actor import Actor
from ..envs import MockEnv
from ..model import Model, default_model_config
from ..model.convert import policy_params_from_flax
from ..utils import deep_merge_dicts

GAME_TYPES = ("agent_vs_agent", "agent_vs_bot", "human_vs_agent", "mock")
_SC2 = "the SC2 env, its maps and LAN games are not ported yet (ROADMAP Queue 1 item 10, envs/sc2/)"
_PTH = "reference .pth checkpoints need model/ref_convert.py, not ported yet (ROADMAP Queue 1 item 10)"


def load_params(path: str, model_cfg) -> dict:
    """A checkpoint's params as a ``state_dict`` of the policy-only model of
    ``model_cfg`` (a learner checkpoint's value towers dropped)."""
    if path.endswith((".pth", ".pt")):
        raise NotImplementedError(f"{path}: {_PTH}")
    from ..utils.checkpoint import load_params as load_native_params

    cfg = deep_merge_dicts(model_cfg, {})
    cfg.use_value_network = False
    with torch.device("meta"):
        shape_model = Model(cfg)
    return policy_params_from_flax(load_native_params(path), shape_model)


def side_name(path: str, default: str) -> str:
    if not path:
        return default
    return os.path.basename(path).rsplit(".", 1)[0] or default


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model1", default="", help="checkpoint for side 0")
    p.add_argument("--model2", default="", help="checkpoint for side 1")
    p.add_argument("--game_type", default="human_vs_agent", choices=GAME_TYPES,
                   help="mock (the only game type ported)")
    p.add_argument("--game-count", type=int, default=1)
    p.add_argument("--episode-game-loops", type=int, default=300, help="mock mode only")
    p.add_argument("--env-num", type=int, default=1)
    p.add_argument("--smoke-model", action="store_true", default=None,
                   help="the launchers' smoke model (default for checkpoint-less mock games)")
    p.add_argument("--full-model", dest="smoke_model", action="store_false",
                   help="default_model_config() at full width and depth")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; raises without CUDA unless 'cpu')")
    p.add_argument("--lan-host", action="store_true", help=_SC2)
    p.add_argument("--lan", default="", help=_SC2)
    return p


def main(argv: Optional[Sequence[str]] = None) -> list:
    args, unknown = parser().parse_known_args(argv)
    if args.lan_host or args.lan:
        raise NotImplementedError(f"{'--lan-host' if args.lan_host else '--lan'}: {_SC2}")
    if args.game_type != "mock":
        raise NotImplementedError(f"--game_type {args.game_type}: {_SC2}")
    if unknown:  # the SC2 game types' flags (--map, --race1, --z-path, ...)
        raise NotImplementedError(f"{' '.join(unknown)}: {_SC2}")
    from .sl_train import SMOKE_MODEL

    if args.smoke_model is None:
        # checkpoints carry the full-scale dims; a checkpoint-less mock game
        # runs the smoke model
        args.smoke_model = not args.model1
    model_cfg = SMOKE_MODEL if args.smoke_model else {}
    cfg = deep_merge_dicts(default_model_config(), model_cfg)
    player_params = {}
    if args.model1:
        player_params["model1"] = load_params(args.model1, cfg)
    if args.model2:
        player_params["model2"] = load_params(args.model2, cfg)
    actor = Actor(
        cfg={"actor": {"env_num": args.env_num, "traj_len": 10 ** 9}},
        model_cfg=model_cfg,
        env_fn=lambda: MockEnv(episode_game_loops=args.episode_game_loops),
        player_params=player_params,
        device=args.device,
    )
    job = {
        "player_ids": ["model1", "model2"],
        "send_data_players": [],
        "update_players": [],
        "teacher_player_ids": ["none", "none"],
        "branch": "eval_test",
        "env_info": {"map_name": "mock"},
    }
    results = actor.run_job(episodes=args.game_count, job=job)
    report(results)
    return results


def report(results) -> None:
    outcomes = Counter(
        "side0" if r["0"]["winloss"] > 0 else
        ("side1" if r["0"]["winloss"] < 0 else "tie")
        for r in results
    )
    n = max(len(results), 1)
    print(
        f"games={len(results)} side0_winrate={outcomes['side0'] / n:.2f} "
        f"side1_winrate={outcomes['side1'] / n:.2f} ties={outcomes['tie']}",
        flush=True,
    )


if __name__ == "__main__":
    main()
