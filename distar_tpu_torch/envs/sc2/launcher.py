"""Game launch orchestration: N SC2 processes, multiplayer create/join with
port plumbing, lifecycle (restart / periodic relaunch), -> a real SC2Env.

Counterpart of ``distar_tpu.envs.sc2.launcher``.

Role parity with the reference SC2Env's launch half (reference: distar/envs/
env.py:96-330): launch one process per agent with retries x10 (:181-209),
reserve 2 ports per agent and wire server/client PortSets into the join
requests (:211-274), save the map onto every controller for multiplayer
(:235-241), built-in-bot player setups, game relaunch every N episodes
against engine leaks (:309-311), restart-vs-recreate on reset (:290-311).

The step/observe orchestration half already lives in envs.sc2_env.SC2Env —
this module provisions the controllers/features it drives. A
``controller_factory`` hook swaps real processes for connections to
fake_sc2.FakeSC2Server in tests (same RemoteController code path).
"""
from __future__ import annotations

import logging
import random
import re
import threading
import time
from typing import Callable, List, Optional, Sequence

from . import portpicker_compat as portpicker
from ..features import ProtoFeatures
from ..sc2_env import SC2Env
from . import maps as map_registry
from . import run_configs
from .proto import sc_pb

RACES = {"terran": 1, "zerg": 2, "protoss": 3, "random": 4}
MAX_RETRY_TIMES = 10


def crop_and_deduplicate_names(names: Sequence[str], limit: int = 32) -> List[str]:
    """SC2 truncates long player names; keep them unique after cropping."""
    out, seen = [], {}
    for name in names:
        cropped = name[:limit]
        n = seen.get(cropped, 0)
        seen[cropped] = n + 1
        out.append(cropped if n == 0 else f"{cropped[: limit - 3]}({n})")
    return out


class Player:
    def __init__(self, race: str, name: str = "agent"):
        self.race = RACES[race.lower()]
        self.name = name


class Bot(Player):
    def __init__(self, race: str, difficulty: int, ai_build: int = 1):
        super().__init__(race, name=f"bot{difficulty}")
        self.difficulty = difficulty
        self.ai_build = ai_build


class Human(Player):
    """A human participant: gets their own (full-screen) SC2 client to play
    in; the env never observes or acts their controller (reference
    env.py:191-197, :315-316)."""

    def __init__(self, race: str, name: str = "human"):
        super().__init__(race, name=name)


class SC2GameLauncher:
    """Owns processes + controllers + per-agent features for one game."""

    def __init__(
        self,
        map_name: str = "KairosJunction",
        players: Optional[Sequence[Player]] = None,
        realtime: bool = False,
        version: Optional[str] = None,
        run_config=None,
        relaunch_every_episodes: int = 10,
        random_seed: Optional[int] = None,
        controller_factory: Optional[Callable[[int], object]] = None,
        game_steps_per_episode: int = 100_000,
    ):
        self._map_names = [m for m in ([map_name] if isinstance(map_name, str) else list(map_name))]
        self.players = list(players or [Player("zerg"), Player("zerg")])
        self.num_agents = sum(1 for p in self.players if not isinstance(p, Bot))
        self._realtime = realtime
        self._random_seed = random_seed
        self._relaunch_every = relaunch_every_episodes
        self._controller_factory = controller_factory
        self._run_config = run_config
        if run_config is None and controller_factory is None:
            self._run_config = run_configs.get(version=version)
        self.game_steps_per_episode = game_steps_per_episode

        self._procs: List = []
        self.controllers: List = []
        self.features: List[ProtoFeatures] = []
        self._ports: List[int] = []
        self._episodes_since_launch = 0
        self._launched = False
        self.map_name = None

    # -------------------------------------------------------------- launch
    def _launch_game(self) -> None:
        """Launch processes (or factory controllers) with retries x10
        (reference env.py:179-209)."""
        for attempt in range(MAX_RETRY_TIMES):
            try:
                if self.num_agents > 1:
                    self._ports = [
                        portpicker.pick_unused_port() for _ in range(self.num_agents * 2)
                    ]
                else:
                    self._ports = []
                if self._controller_factory is not None:
                    self._procs = []
                    self.controllers = [
                        self._controller_factory(i) for i in range(self.num_agents)
                    ]
                else:
                    agent_players = [
                        p for p in self.players if not isinstance(p, Bot)
                    ]
                    # the human's client launches full screen (reference
                    # env.py:191-197)
                    self._procs = [
                        self._run_config.start(
                            want_rgb=False, full_screen=isinstance(p, Human)
                        )
                        for p in agent_players
                    ]
                    self.controllers = [p.controller for p in self._procs]
                return
            except Exception as e:
                logging.error("start SC2 failed (%r), retry %d", e, attempt)
                self.close()
                if attempt == MAX_RETRY_TIMES - 1:
                    raise

    def _create_join(self) -> None:
        """Create the game on the host and join from every agent
        (reference env.py:211-274)."""
        map_inst = map_registry.get(random.choice(self._map_names))
        self.map_name = map_inst.name
        map_size = map_registry.get_map_size(map_inst.name)

        create = sc_pb.RequestCreateGame(
            disable_fog=False, realtime=self._realtime
        )
        if self._run_config is not None and map_inst.path:
            map_data = map_inst.data(self._run_config)
            create.local_map.map_path = map_inst.path
            if self.num_agents == 1:
                create.local_map.map_data = map_data
            else:
                # every client must see the map file (SC2 tmpdir quirk,
                # reference :235-241)
                for c in self.controllers:
                    c.save_map(map_inst.path, map_data)
        else:
            create.local_map.map_path = map_inst.path or map_inst.name
        if self._random_seed is not None:
            create.random_seed = self._random_seed
        for p in self.players:
            if isinstance(p, Bot):
                create.player_setup.add(
                    type=sc_pb.Computer, race=p.race, difficulty=p.difficulty,
                    ai_build=p.ai_build,
                )
            else:
                create.player_setup.add(type=sc_pb.Participant)
        host = self.controllers[1] if self.num_agents > 1 else self.controllers[0]
        host.create_game(create)

        # interface options: raw + score + map-sized minimap feature layers
        # (reference _setup_interface :150-177)
        agent_players = [p for p in self.players if not isinstance(p, Bot)]
        has_human = any(isinstance(p, Human) for p in agent_players)
        names = crop_and_deduplicate_names([p.name for p in agent_players])
        join_reqs = []
        for p, name in zip(agent_players, names):
            interface = sc_pb.InterfaceOptions(
                raw=True,
                score=True,
                show_cloaked=False,
                show_burrowed_shadows=False,
                show_placeholders=False,
                # a human drives the UI, so raw commands must respect their
                # selection (reference _setup_interface env.py:153-156)
                raw_affects_selection=has_human,
                raw_crop_to_playable_area=True,
            )
            interface.feature_layer.width = 24
            interface.feature_layer.resolution.x = 1
            interface.feature_layer.resolution.y = 1
            interface.feature_layer.minimap_resolution.x = map_size[0]
            interface.feature_layer.minimap_resolution.y = map_size[1]
            interface.feature_layer.crop_to_playable_area = True
            join = sc_pb.RequestJoinGame(options=interface)
            join.race = p.race
            join.player_name = name
            if self._ports:
                join.shared_port = 0  # unused
                join.server_ports.game_port = self._ports[0]
                join.server_ports.base_port = self._ports[1]
                for i in range(self.num_agents - 1):
                    join.client_ports.add(
                        game_port=self._ports[i * 2 + 2],
                        base_port=self._ports[i * 2 + 3],
                    )
            join_reqs.append(join)

        # join blocks until all clients joined -> run in parallel
        # (reference :268-271 via run_parallel)
        errors: List = [None] * len(join_reqs)

        def _join(i):
            try:
                self.controllers[i].join_game(join_reqs[i])
            except Exception as e:  # surfaced after the barrier
                errors[i] = e

        threads = [
            threading.Thread(target=_join, args=(i,)) for i in range(len(join_reqs))
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for e in errors:
            if e is not None:
                raise e

        game_infos = [c.game_info() for c in self.controllers]
        self.features = [ProtoFeatures(gi) for gi in game_infos]
        self._launched = True

    @property
    def human_indices(self) -> List[int]:
        agent_players = [p for p in self.players if not isinstance(p, Bot)]
        return [i for i, p in enumerate(agent_players) if isinstance(p, Human)]

    def save_replay(self, replay_dir: str, prefix: Optional[str] = None) -> Optional[str]:
        """Pull the replay from the first controller and write it via the run
        config (reference env.py:485-496)."""
        if not self.controllers or self._run_config is None:
            return None
        data = self.controllers[0].save_replay()
        if not data:
            return None
        return self._run_config.save_replay(data, replay_dir, prefix)

    # ------------------------------------------------------------ lifecycle
    def ensure_game(self) -> None:
        """Called at every episode start: launch on first use, full relaunch
        every N episodes (memory leaks, reference :309-311), restart-or-
        recreate otherwise (:290-311)."""
        if not self._launched:
            self._launch_game()
            self._create_join()
            self._episodes_since_launch = 0
            return
        self._episodes_since_launch += 1
        if (
            self._relaunch_every
            and self._episodes_since_launch >= self._relaunch_every
            and self._controller_factory is None
        ):
            logging.info("relaunching SC2 after %d episodes", self._episodes_since_launch)
            self.close()
            self._launch_game()
            self._create_join()
            self._episodes_since_launch = 0
            return
        single = self.num_agents == 1 and len(self._map_names) == 1
        if single:
            try:
                self.controllers[0].restart()
                return
            except Exception as e:
                logging.warning("restart failed (%r); recreating the game", e)
        self._create_join()

    def close(self) -> None:
        for c in self.controllers:
            try:
                c.quit()
            except Exception:
                pass
        self.controllers = []
        for p in self._procs:
            try:
                p.close()
            except Exception:
                pass
        self._procs = []
        for port in self._ports:
            try:
                portpicker.return_port(port)
            except Exception:
                pass
        self._ports = []
        self._launched = False


class RealSC2Env(SC2Env):
    """SC2Env over a launcher's real controllers (the complete L2+L1 stack:
    orchestration from envs.sc2_env + the client layer underneath)."""

    def __init__(
        self,
        launcher: SC2GameLauncher,
        save_replay_episodes: int = 0,
        replay_dir: str = ".",
        **env_kwargs,
    ):
        self._launcher = launcher
        launcher.ensure_game()
        replay_saver = None
        if save_replay_episodes > 0:
            replay_saver = lambda prefix: launcher.save_replay(replay_dir, prefix)
        super().__init__(
            controllers=launcher.controllers,
            features=launcher.features,
            episode_length=launcher.game_steps_per_episode,
            realtime=env_kwargs.pop("realtime", launcher._realtime),
            human_indices=launcher.human_indices,
            save_replay_episodes=save_replay_episodes,
            replay_saver=replay_saver,
            **env_kwargs,
        )
        self._first_reset_done = False

    def reset(self):
        if self._first_reset_done:
            self._launcher.ensure_game()
            self._controllers = list(self._launcher.controllers)
            self._features = list(self._launcher.features)
        self._first_reset_done = True
        return super().reset()

    def close(self) -> None:
        self._launcher.close()


def make_sc2_env(cfg: Optional[dict] = None, controller_factory=None) -> RealSC2Env:
    """Config-driven construction (the actor's env_fn for real games).

    cfg.env keys (reference rl_user_config.yaml env block): map_name,
    player_ids (['agent','bot7']), races, realtime, game_steps_per_episode,
    random_delay_weights, update_both_obs, version, random_seed."""
    from ...utils import Config, deep_merge_dicts

    defaults = {
        "env": {
            "map_name": "KairosJunction",
            "player_ids": ["agent", "agent"],
            "races": ["zerg", "zerg"],
            "realtime": False,
            "game_steps_per_episode": 100_000,
            "random_delay_weights": [],
            "update_both_obs": True,
            "version": None,
            "random_seed": None,
            "relaunch_every_episodes": 10,
            "save_replay_episodes": 0,
            "replay_dir": ".",
        }
    }
    whole = deep_merge_dicts(Config(defaults), cfg or {})
    ec = whole.env
    players = []
    for pid, race in zip(ec.player_ids, ec.races):
        # exact forms only — agent ids derive from checkpoint basenames,
        # which may legitimately contain 'bot'/'human' as substrings
        bot_m = re.fullmatch(r"bot(\d+)", str(pid))
        if bot_m:
            players.append(Bot(race, int(bot_m.group(1))))
        elif str(pid) == "human":
            players.append(Human(race))
        else:
            players.append(Player(race, name=str(pid)))
    launcher = SC2GameLauncher(
        map_name=ec.map_name,
        players=players,
        realtime=ec.realtime,
        version=ec.get("version"),
        random_seed=ec.get("random_seed"),
        relaunch_every_episodes=ec.get("relaunch_every_episodes", 10),
        controller_factory=controller_factory,
        game_steps_per_episode=ec.game_steps_per_episode,
    )
    return RealSC2Env(
        launcher,
        random_delay_weights=list(ec.get("random_delay_weights") or []),
        both_obs=bool(ec.get("update_both_obs", True)),
        save_replay_episodes=int(ec.get("save_replay_episodes", 0) or 0),
        replay_dir=str(ec.get("replay_dir", ".")),
    )
