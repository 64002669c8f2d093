"""Arena evaluator: turns checkpoint history into reported matches.

Counterpart of ``distar_tpu.arena.evaluator``. The evaluator is the worker
half of the arena: it discovers the model roster from
:class:`~distar_tpu_torch.utils.checkpoint.CheckpointManager` role keys
(player ids are ``role:step``, e.g. ``main:300``), asks the store —
in-process or over the coordinator's ``arena_next`` route — for one
deterministic assignment, replays that assignment as a batched jaxenv
``head_to_head`` on its device, and reports the whole batch under
idempotent match keys. Reports are all-or-nothing: a kill mid-batch loses
the batch, the restarted evaluator re-receives the identical assignment,
and the keys make the replay exact — zero lost, zero double-counted.

The assignment's scenarios are a pure function of its seed
(``assignment_scenarios``: a ``torch.Generator`` seeded with it), and so are
the model players' Gumbel draws (``head_to_head``'s generator), so a
restarted evaluator replays the same episodes. They are not the JAX
package's episodes for that seed (ROADMAP Queue 3 item 16): the two
packages' ledgers agree in form, not match by match. Tests hand in JAX-made
scenarios by replacing ``assignment_scenarios``.

Scripted anchors (``attack_nearest``, ``idle``) need no checkpoint and
ground the rating scale even with a single model lineage.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Sequence

from ..envs.jaxenv import EnvConfig, ScenarioConfig, ScenarioGenerator
from ..envs.jaxenv.scenario import make_generator
from ..envs.jaxenv.winrate import attack_nearest_policy, head_to_head, idle_policy, model_policy
from ..model import default_model_config
from ..model.convert import frozen_model
from ..obs import get_registry
from ..utils import deep_merge_dicts
from ..utils.checkpoint import CheckpointManager
from .store import ANCHORS, ArenaStore, match_key


def anchor_policy(name: str):
    if name == "attack_nearest":
        return attack_nearest_policy()
    if name == "idle":
        return idle_policy()
    raise KeyError(f"unknown arena anchor: {name}")


def assignment_scenarios(seed: int, episodes: int, scenario_cfg: ScenarioConfig, device):
    """The scenario batch of one assignment: ``episodes`` scenarios drawn on
    ``device`` from a generator seeded with the assignment's ``seed``."""
    return ScenarioGenerator(scenario_cfg).batch(int(episodes), make_generator(seed, device))


def _skill_block(ratings: dict) -> Optional[dict]:
    """The in-band skill ledger ``perf_gate skill`` gates across rounds:
    the newest generation's ELO relative to the mean of the scripted
    anchors (the fixed points of the rating scale)."""
    players = (ratings or {}).get("players") or {}
    gens = {p: i for p, i in players.items() if not i.get("anchor")}
    anchors = {p: i for p, i in players.items() if i.get("anchor")}
    if not gens or not anchors:
        return None

    def step(pid: str) -> int:
        try:
            return int(pid.rsplit(":", 1)[1])
        except (ValueError, IndexError):
            return -1

    newest = max(gens, key=lambda p: (step(p), p))
    anchor_mean = sum(i["elo"] for i in anchors.values()) / len(anchors)
    return {
        "player": newest,
        "anchor_relative": gens[newest]["elo"] - anchor_mean,
        "matches": gens[newest].get("games"),
        "anchor": "mean(" + ",".join(sorted(anchors)) + ")",
    }


class ArenaEvaluator:
    """One evaluation worker over a checkpoint directory + scripted anchors.

    ``store`` (in-process) or ``coordinator_addr`` (remote) selects the
    reporting plane; exactly one must be given. ``roles`` are the
    CheckpointManager role keys whose generations enter the roster
    ("" is the default/teacher lineage, shown as ``main``). The model
    players run on ``device`` (CUDA unless the caller asks for another).
    """

    def __init__(self, ckpt_dir: str, model_cfg: dict,
                 store: Optional[ArenaStore] = None,
                 coordinator_addr: Optional[tuple] = None,
                 roles: Sequence[str] = ("",),
                 anchors: Sequence[str] = ANCHORS,
                 episodes: int = 8,
                 env_cfg: Optional[EnvConfig] = None,
                 scenario_cfg: Optional[ScenarioConfig] = None,
                 device=None):
        from ..actor.inference import resolve_device

        if (store is None) == (coordinator_addr is None):
            raise ValueError("need exactly one of store / coordinator_addr")
        self.ckpt_dir = ckpt_dir
        self.model_cfg = model_cfg
        self.store = store
        self.coordinator_addr = coordinator_addr
        self.roles = tuple(roles)
        self.anchors = tuple(anchors)
        self.episodes = int(episodes)
        self.env_cfg = env_cfg if env_cfg is not None else EnvConfig()
        self.scenario_cfg = (scenario_cfg if scenario_cfg is not None
                             else ScenarioConfig(
                                 units_per_squad=self.env_cfg.units_per_squad,
                                 max_units=self.env_cfg.units_per_squad))
        self.device = resolve_device(device)
        self._policies: Dict[str, object] = {}
        self._paths: Dict[str, str] = {}
        self.batches_done = 0
        self.matches_reported = 0
        self._ledger: List[dict] = []
        self._wall_start = time.monotonic()

    # ---------------------------------------------------------------- roster
    def refresh_roster(self) -> List[str]:
        """Player ids newest-first across role keys (newest overall first)."""
        entries = []
        for role in self.roles:
            mgr = CheckpointManager(self.ckpt_dir, role=role)
            label = role or "main"
            for gen in mgr.generations():
                pid = f"{label}:{int(gen.get('step', 0))}"
                entries.append((int(gen.get("step", 0)), pid, gen["path"]))
        entries.sort(key=lambda e: (-e[0], e[1]))
        players = []
        for _, pid, path in entries:
            if pid not in players:
                players.append(pid)
                self._paths[pid] = path
        return players

    def _policy(self, pid: str):
        pol = self._policies.get(pid)
        if pol is not None:
            return pol
        if pid in self.anchors:
            pol = anchor_policy(pid)
        else:
            cfg = deep_merge_dicts(default_model_config(), self.model_cfg or {})
            pol = model_policy(frozen_model(cfg, self._paths[pid], self.device))
        self._policies[pid] = pol
        return pol

    # -------------------------------------------------------------- wire plane
    def _rpc(self, route: str, body: dict):
        from ..comm.coordinator import coordinator_request

        host, port = self.coordinator_addr
        resp = coordinator_request(host, port, route, body)
        if resp.get("code") != 0:
            raise RuntimeError(f"{route} failed: {resp.get('info')}")
        return resp.get("info")

    def _ask(self, players: List[str]) -> Optional[dict]:
        if self.store is not None:
            return self.store.next_match(players, episodes=self.episodes)
        return self._rpc("arena_next",
                         {"players": players, "episodes": self.episodes})

    def _report(self, records: List[dict]) -> dict:
        if self.store is not None:
            return self.store.report_batch(records)
        return self._rpc("arena_report", {"matches": records})

    # ---------------------------------------------------------------- one step
    def evaluate_once(self) -> Optional[dict]:
        """Roster refresh -> ask -> head_to_head -> whole-batch report.

        Returns the summary dict (assignment + head_to_head stats + report
        accounting) or None when no assignment is available.
        """
        players = self.refresh_roster()
        assignment = self._ask(players)
        if not assignment:
            return None
        home, away = assignment["home"], assignment["away"]
        rnd, seed = int(assignment["round"]), int(assignment["seed"])
        episodes = int(assignment.get("episodes", self.episodes))
        scenarios = assignment_scenarios(seed, episodes, self.scenario_cfg, self.device)
        res = head_to_head(self._policy(home), self._policy(away), seed=seed,
                           scenarios=scenarios, env_cfg=self.env_cfg,
                           scenario_cfg=self.scenario_cfg, device=self.device)
        per_match_s = res["duration_s"] / max(episodes, 1)
        records = [
            {"key": match_key(home, away, rnd, i),
             "home": home, "away": away, "round": rnd,
             "winner": m["winner"], "game_steps": m["game_steps"],
             "duration_s": per_match_s}
            for i, m in enumerate(res["matches"])
        ]
        ack = self._report(records)
        self.batches_done += 1
        self.matches_reported += int(ack.get("applied", 0))
        self._ledger.append({"home": home, "away": away, "round": rnd,
                             "seed": seed, "episodes": episodes,
                             "win_rate": res["win_rate"],
                             "duration_s": res["duration_s"],
                             "applied": int(ack.get("applied", 0)),
                             "duplicates": int(ack.get("duplicates", 0))})
        reg = get_registry()
        reg.counter("distar_arena_eval_batches_total",
                    "head-to-head scenario batches the evaluator completed"
                    ).inc()
        reg.gauge("distar_arena_eval_matches_per_s",
                  "arena matches evaluated per second (batch episodes / "
                  "batch wall, compile included)"
                  ).set(episodes / max(res["duration_s"], 1e-9))
        return {"assignment": assignment, "result": res, "ack": ack}

    # ----------------------------------------------------------------- artifact
    def artifact(self, ratings: Optional[dict] = None) -> dict:
        """The ``ARENA_r*.json`` payload: throughput + rating ledger, honesty
        flags in-band (the device the batches ran on, the host's cores)."""
        wall = max(time.monotonic() - self._wall_start, 1e-9)
        total_eps = sum(e["episodes"] for e in self._ledger)
        try:
            cores = len(os.sched_getaffinity(0))
        except AttributeError:
            cores = os.cpu_count() or 1
        doc = {
            "bench": "arena",
            "metric": "arena match throughput (batched jaxenv head-to-head, "
                      "model build included)",
            "value": total_eps / wall,
            "unit": "matches/s",
            "matches_total": self.matches_reported,
            "batches": self.batches_done,
            "wall_s": wall,
            "matches_per_s": total_eps / wall,
            "device": self.device.type,
            "host_cores": cores,
            "scaling_valid": False,
            "ledger": self._ledger,
        }
        if ratings is not None:
            doc["ratings"] = ratings
            block = _skill_block(ratings)
            if block is not None:
                doc["arena"] = block
        return doc

    def write_artifact(self, path: str, ratings: Optional[dict] = None,
                       extra: Optional[dict] = None) -> str:
        doc = self.artifact(ratings=ratings)
        if extra:
            doc.update(extra)
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        return path
