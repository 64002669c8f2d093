"""Play/eval launcher: agent-vs-agent, agent-vs-bot and human-vs-agent
games on an SC2 install, the LAN showmatch, and a game-free mock mode.

    python -m distar_tpu_torch.bin.play --game_type mock --device cpu --game-count 2
    python -m distar_tpu_torch.bin.play --game_type agent_vs_bot --model1 ckpt --model2 bot7

Counterpart of ``distar_tpu.bin.play``, on CUDA unless ``--device`` says
otherwise. The SC2 game types find the install through
``envs.sc2.run_configs`` (``SC2PATH``), install the bundled
Ladder2019Season2 maps into it (or ``--maps-dir``'s), pin the matchup by
``--game_type`` and run the games through ``envs.sc2.launcher.make_sc2_env``
(``--map``, ``--race1``, ``--race2``, ``--z-path``, ``--save-replay-episodes``,
``--replay-dir``; ``--no-realtime`` steps agent games in lockstep, a human's
game runs on SC2's clock). ``--lan-host`` hosts a LAN game for a human and
prints the handshake endpoint; ``--lan host:port`` joins such a game as the
agent (``envs.sc2.lan``). The game-free ``mock`` mode runs the same
``Actor`` on ``MockEnv``s.

``--model1``/``--model2`` are checkpoints the port (or the JAX package)
wrote, loaded with ``utils.checkpoint.load_params``, or reference torch
``.pth``/``.pt`` state dicts, converted by ``model.ref_convert.convert_model``;
either is taken to the policy-only model through
``model.convert.policy_params_from_flax``. A side without one plays on the
actor's seeded weights. The last line is the JAX launcher's ``report``:
``games=N side0_winrate=.. side1_winrate=.. ties=..``.
"""
from __future__ import annotations

import argparse
import logging
import os
import re
import socket
from collections import Counter
from typing import Optional, Sequence

import torch

from ..actor import Actor
from ..envs import MockEnv
from ..model import Model, default_model_config
from ..model.convert import policy_params_from_flax
from ..utils import deep_merge_dicts

GAME_TYPES = ("agent_vs_agent", "agent_vs_bot", "human_vs_agent", "mock")


def find_sc2() -> str:
    """The SC2 install's directory, from the platform run config (the one
    source of truth for discovery, ``envs/sc2/run_configs.py``)."""
    from ..envs.sc2 import run_configs

    data_dir = run_configs.get().data_dir
    if not os.path.isdir(data_dir):
        raise SystemExit(
            f"StarCraft II install not found at '{data_dir}': set the SC2PATH "
            "environment variable (or use --game_type mock for a game-free "
            "smoke run)."
        )
    return data_dir


def load_params(path: str, model_cfg) -> dict:
    """A checkpoint's params as a ``state_dict`` of the policy-only model of
    ``model_cfg`` (a learner checkpoint's value towers dropped); reference
    torch ``.pth`` checkpoints convert on the fly
    (``model.ref_convert.convert_model``)."""
    if path.endswith((".pth", ".pt")):
        from ..model.ref_convert import convert_model

        sd = torch.load(path, map_location="cpu")
        sd = sd.get("model", sd)
        params = convert_model({k: v.numpy() if torch.is_tensor(v) else v for k, v in sd.items()},
                               model_cfg)
    else:
        from ..utils.checkpoint import load_params as load_native_params

        params = load_native_params(path)
    cfg = deep_merge_dicts(model_cfg, {})
    cfg.use_value_network = False
    with torch.device("meta"):
        shape_model = Model(cfg)
    return policy_params_from_flax(params, shape_model)


def side_name(path: str, default: str) -> str:
    if not path:
        return default
    return os.path.basename(path).rsplit(".", 1)[0] or default


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model1", default="", help="checkpoint for side 0")
    p.add_argument("--model2", default="", help="checkpoint for side 1 (or botN)")
    p.add_argument("--game_type", default="human_vs_agent", choices=GAME_TYPES)
    p.add_argument("--map", dest="map_name", default="KairosJunction")
    p.add_argument("--race1", default="zerg")
    p.add_argument("--race2", default="zerg")
    p.add_argument("--game-count", type=int, default=1)
    p.add_argument("--maps-dir", default="", help="bundled .SC2Map dir to auto-install")
    p.add_argument("--z-path", default="", help="Z strategy library for both sides")
    p.add_argument("--save-replay-episodes", type=int, default=0)
    p.add_argument("--replay-dir", default="replays")
    p.add_argument("--no-realtime", action="store_true",
                   help="lockstep stepping instead of wall-clock (agent games only)")
    p.add_argument("--episode-game-loops", type=int, default=300, help="mock mode only")
    p.add_argument("--env-num", type=int, default=1)
    p.add_argument("--smoke-model", action="store_true", default=None,
                   help="the launchers' smoke model (default for checkpoint-less mock games)")
    p.add_argument("--full-model", dest="smoke_model", action="store_false",
                   help="default_model_config() at full width and depth")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; raises without CUDA unless 'cpu')")
    p.add_argument("--lan-host", action="store_true",
                   help="HUMAN side of a remote showmatch: host a LAN game full-screen and print the "
                        "handshake port for the agent machine")
    p.add_argument("--lan", default="",
                   help="AGENT side of a remote showmatch: host:port of the human machine's handshake")
    return p


def _eval_job(player_ids, opponent_id: str, map_name: str, z_path: str) -> dict:
    return {
        "player_ids": list(player_ids),
        "send_data_players": [],
        "update_players": [],
        "teacher_player_ids": ["none"] * len(player_ids),
        "branch": "eval_test",
        "env_info": {"map_name": map_name},
        "z_path": [z_path] * 2 if z_path else [],
        "opponent_id": opponent_id,
    }


def main(argv: Optional[Sequence[str]] = None) -> Optional[list]:
    args = parser().parse_args(argv)
    if args.lan_host:
        run_lan_host(args)
        return None
    from .sl_train import SMOKE_MODEL

    if args.smoke_model is None:
        # checkpoints carry the full-scale dims; a checkpoint-less mock game
        # runs the smoke model
        args.smoke_model = args.game_type == "mock" and not args.model1
    model_cfg = SMOKE_MODEL if args.smoke_model else {}
    full_model_cfg = deep_merge_dicts(default_model_config(), model_cfg)

    if args.game_type == "mock":
        player_params = {}
        if args.model1:
            player_params["model1"] = load_params(args.model1, full_model_cfg)
        if args.model2:
            player_params["model2"] = load_params(args.model2, full_model_cfg)
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

    sc2_dir = find_sc2()
    # install the bundled Ladder2019Season2 maps (or --maps-dir's) so an
    # offline host plays without fetching any; a read-only install is fine:
    # run_configs.map_data falls back to the bundle at load time
    from ..envs.sc2 import maps as map_registry

    try:
        map_registry.install_maps(args.maps_dir or None, sc2_dir)
    except OSError as e:
        logging.warning(f"map auto-install into {sc2_dir} failed ({e!r}); relying on the bundled-map fallback")

    name1 = side_name(args.model1, "model1")
    player_params = {}
    if args.model1:
        player_params[name1] = load_params(args.model1, full_model_cfg)

    if args.lan:
        # agent side of a remote showmatch: join the human's hosted game
        from ..envs.sc2.lan import LanSC2Env

        host, sep, port = args.lan.rpartition(":")
        if not sep or not port.isdigit():
            raise SystemExit(f"--lan expects host:port (the endpoint --lan-host printed), got {args.lan!r}")
        host = host or "127.0.0.1"
        job = _eval_job([name1], "remote_human", args.map_name, "")
        job["z_path"] = [args.z_path] if args.z_path else []
        actor = Actor(
            cfg={"actor": {"env_num": 1, "traj_len": 10 ** 9}},
            model_cfg=model_cfg,
            env_fn=lambda: LanSC2Env(host, int(port), agent_race=args.race1),
            player_params=player_params,
            device=args.device,
        )
        results = actor.run_job(episodes=1, job=job)
        report(results)
        return results

    # matchup -> the env's player ids and the model-driven sides
    realtime = not args.no_realtime
    if args.game_type == "agent_vs_agent":
        name2 = side_name(args.model2, "model2")
        if name2 == name1:
            name2 = name1 + "(1)"
        env_player_ids = [name1, name2]
        agent_ids = [name1, name2]
        if args.model2:
            player_params[name2] = load_params(args.model2, full_model_cfg)
    elif args.game_type == "agent_vs_bot":
        if args.model2 and not re.fullmatch(r"bot\d+", args.model2):
            raise SystemExit(
                f"agent_vs_bot expects --model2 botN (built-in bot level), got {args.model2!r}; "
                "use --game_type agent_vs_agent for a checkpoint opponent")
        env_player_ids = [name1, args.model2 or "bot10"]
        agent_ids = [name1]
    else:  # human_vs_agent
        env_player_ids = [name1, "human"]
        agent_ids = [name1]
        realtime = True  # the human plays in wall-clock time

    env_cfg = {
        "env": {
            "map_name": args.map_name,
            "player_ids": env_player_ids,
            "races": [args.race1, args.race2],
            "realtime": realtime,
            "save_replay_episodes": args.save_replay_episodes,
            "replay_dir": args.replay_dir,
        }
    }
    from ..envs.sc2.launcher import make_sc2_env

    actor = Actor(
        cfg={"actor": {"env_num": args.env_num, "traj_len": 10 ** 9}},
        model_cfg=model_cfg,
        env_fn=lambda: make_sc2_env(env_cfg),
        player_params=player_params,
        device=args.device,
    )
    results = actor.run_job(episodes=args.game_count,
                            job=_eval_job(agent_ids, env_player_ids[-1], args.map_name, args.z_path))
    report(results)
    return results


def outward_ip() -> str:
    """This host's address for a remote machine to dial: the first
    non-loopback IPv4 address its name resolves to, else 127.0.0.1. (The
    JAX launcher reads the address a UDP socket connected towards a private
    address would use; the port opens no socket for it.)"""
    try:
        infos = socket.getaddrinfo(socket.gethostname(), None, socket.AF_INET)
    except OSError:
        return "127.0.0.1"
    for info in infos:
        ip = info[4][0]
        if not ip.startswith("127."):
            return ip
    return "127.0.0.1"


def run_lan_host(args) -> None:
    """Human side of a remote showmatch: host the LAN game, print the
    handshake endpoint, then keep the game's client alive until it stops
    answering pings."""
    import time

    find_sc2()
    from ..envs.sc2 import maps as map_registry
    from ..envs.sc2.lan import host_lan_game

    try:
        map_registry.install_maps(args.maps_dir or None)
    except OSError:
        pass
    controller, handshake_port, proc, join_thread = host_lan_game(args.map_name, race=args.race1, realtime=True)
    ip = outward_ip()
    print(
        f"LAN game hosted. On the agent machine run:\n"
        f"  python -m distar_tpu_torch.bin.play --lan {ip}:{handshake_port} "
        f"--model1 <ckpt> --race1 {args.race2}\n"
        f"(substitute this machine's reachable IP if {ip} is wrong)\n"
        f"Waiting for the agent to join...",
        flush=True,
    )
    join_thread.join()
    print("Agent joined — play! (this process exits when the game ends)", flush=True)
    try:
        while True:
            time.sleep(5)
            controller.ping()
    except Exception:
        pass
    finally:
        if proc is not None:
            proc.close()


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
