"""Fleet supervision: spawn, watch, respawn and gracefully retire members.

Counterpart of ``distar_tpu.fleet.supervisor``. The process-level
complement of ``resilience.Supervisor`` (which watches threads inside one
process): a ``SubprocessFleet`` owns N real OS processes of one role —
serve gateways (``serve.fleet.gateway_proc``), replay shards
(``replay.server``) or league actor slots — and a ``FleetSupervisor``
bundles the fleets behind the scale_up/scale_down surface the
``Autoscaler`` drives. ``gateway_cmd`` and ``replay_cmd`` start the port's
modules, which run no model and start in under a second; a member command
that runs a model (say ``rl_train --type actor``) takes the port's device
rule: CUDA, unless its argv (``extra``) carries ``--device cpu``.

Contracts:

* **spawn** — members are real subprocesses printing the standard parseable
  ready line (``SERVE-GATEWAY host tcp http`` / ``REPLAY-SHARD host port
  ...`` / ``LEAGUE-ACTOR host port player=...``); with a coordinator
  configured they self-register, so discovery (and thereby every
  live-membership client) sees the join without help.
* **respawn** — an unexpected member death (exit without a drain) is
  respawned under a ``RestartPolicy`` budget (max respawns per sliding
  window); exhausting the budget retires the slot and counts a giveup
  instead of flapping forever.
* **retire** — scale-down is GRACEFUL: ``POST /drain`` on the member's
  admin surface (deregister-then-shed, sessions/items migrate via the
  client-side handoff paths), then wait for the process to exit itself;
  only a drain-timeout escalates to SIGTERM. A member killed mid-drain is
  NOT respawned — it was leaving — but its spill identity (the member
  index) stays, so a replay shard restarted on it recovers its tail.
"""
from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
import urllib.request
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..obs import get_registry
from ..resilience.supervisor import RestartPolicy

#: fleet kinds this module knows how to parse/drain
KINDS = ("gateway", "replay", "actor")


@dataclass
class FleetMember:
    fleet: str
    proc: subprocess.Popen
    addr: str                       # data-plane identity "host:port"
    http_addr: Optional[str] = None  # drain/status surface "host:port"
    started_ts: float = field(default_factory=time.monotonic)
    draining: bool = False
    meta: dict = field(default_factory=dict)

    @property
    def alive(self) -> bool:
        return self.proc.poll() is None


def _post(addr: str, path: str, timeout: float = 5.0) -> Optional[dict]:
    try:
        req = urllib.request.Request(
            f"http://{addr}{path}", data=b"{}",
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read())
    except Exception:  # noqa: BLE001 - drain is best-effort; timeout escalates
        return None


class SubprocessFleet:
    """One elastic fleet of subprocess members.

    ``build_cmd(index)`` returns the argv for a new member (index is a
    monotonic spawn counter — spill directories and shard ids key off it);
    ``kind`` picks the ready-line/drain conventions. Members print their
    ready line on stdout; stdin is held open (closing it reaps the member,
    the established fleet-process idiom)."""

    DRAIN_PATH = {"gateway": "/serve/drain", "replay": "/drain",
                  "actor": "/actor/drain"}
    READY_TOKEN = {"gateway": "SERVE-GATEWAY", "replay": "REPLAY-SHARD",
                   "actor": "LEAGUE-ACTOR"}

    def __init__(self, name: str, kind: str,
                 build_cmd: Callable[[int], List[str]],
                 restart_policy: Optional[RestartPolicy] = None,
                 drain_timeout_s: float = 30.0,
                 min_members: int = 0):
        assert kind in KINDS, kind
        self.name = name
        self.kind = kind
        self.build_cmd = build_cmd
        self.policy = restart_policy or RestartPolicy(max_restarts=3,
                                                      window_s=120.0)
        self.drain_timeout_s = float(drain_timeout_s)
        self.min_members = int(min_members)
        self._members: List[FleetMember] = []
        self._spawned = 0
        self._respawn_times: deque = deque()
        self.gave_up = False
        self._lock = threading.RLock()
        reg = get_registry()
        self._c_spawns = reg.counter(
            "distar_fleet_supervisor_spawns_total",
            "fleet member processes spawned", fleet=name)
        self._c_respawns = reg.counter(
            "distar_fleet_supervisor_respawns_total",
            "fleet members respawned after an unexpected death", fleet=name)
        self._c_drains = reg.counter(
            "distar_fleet_supervisor_drains_total",
            "graceful member retirements initiated", fleet=name)
        self._g_members = reg.gauge(
            "distar_fleet_supervisor_members",
            "live members per supervised fleet", fleet=name)

    # ------------------------------------------------------------------ spawn
    def spawn(self) -> FleetMember:
        """Start one member and wait for its ready line. Raises on a member
        that dies before serving — the caller (autoscaler) counts that as a
        failed decision, not a silent no-op."""
        with self._lock:
            index = self._spawned
            self._spawned += 1
        cmd = self.build_cmd(index)
        proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.DEVNULL, text=True)
        line = proc.stdout.readline().split()
        token = self.READY_TOKEN[self.kind]
        if len(line) < 3 or line[0] != token:
            try:
                proc.kill()
            except OSError:
                pass
            raise RuntimeError(
                f"{self.name} member failed to start (wanted {token!r} "
                f"ready line, got {line!r})")
        host, port = line[1], line[2]
        named = dict(t.split("=", 1) for t in line[3:] if "=" in t)
        if self.kind == "gateway":
            http = f"{host}:{line[3]}" if len(line) > 3 and "=" not in line[3] \
                else None
        else:
            http = f"{host}:{named['admin']}" if named.get("admin") else None
        named["index"] = str(index)
        member = FleetMember(self.name, proc, f"{host}:{port}",
                             http_addr=http, meta=named)
        with self._lock:
            self._members.append(member)
            self._g_members.set(len(self._members))
        self._c_spawns.inc()
        return member

    # ----------------------------------------------------------------- retire
    def drain(self, member: FleetMember,
              block: bool = False) -> threading.Thread:
        """Begin graceful retirement of one member: POST its drain route
        (deregister-then-shed server-side), then wait for the process to
        exit on its own — escalating to SIGTERM only after the drain
        timeout. Runs on a background thread (drains take as long as the
        slowest migrating session); ``block=True`` joins it."""
        member.draining = True
        self._c_drains.inc()

        def run():
            if member.http_addr:
                _post(member.http_addr, self.DRAIN_PATH[self.kind])
            deadline = time.monotonic() + self.drain_timeout_s
            while member.alive and time.monotonic() < deadline:
                time.sleep(0.1)
            if member.alive:
                try:
                    member.proc.terminate()
                    member.proc.wait(timeout=5.0)
                except Exception:  # noqa: BLE001 - last resort below
                    try:
                        member.proc.kill()
                    except OSError:
                        pass
            try:
                member.proc.stdin.close()
            except Exception:  # noqa: BLE001 - already gone
                pass
            with self._lock:
                if member in self._members:
                    self._members.remove(member)
                self._g_members.set(len(self._members))

        t = threading.Thread(target=run, name=f"{self.name}-drain", daemon=True)
        t.start()
        if block:
            t.join(self.drain_timeout_s + 10.0)
        return t

    # ------------------------------------------------------------------ watch
    def check_once(self) -> None:
        """One watchdog pass: respawn unexpectedly dead members under the
        restart budget (a member killed mid-drain was leaving — no
        respawn)."""
        with self._lock:
            dead = [m for m in self._members
                    if not m.alive and not m.draining]
            for m in dead:
                self._members.remove(m)
            self._g_members.set(len(self._members))
        for m in dead:
            if not self._budget_ok():
                self.gave_up = True
                get_registry().counter(
                    "distar_resilience_task_giveups_total",
                    "supervised tasks abandoned (restart budget exhausted)",
                    # analysis: allow(metric-label-cardinality) — fleet names come from the operator's static FleetSupervisor config (serve/replay), never from request data
                    task=f"fleet:{self.name}",
                ).inc()
                continue
            try:
                self.spawn()
                self._c_respawns.inc()
            except RuntimeError:
                continue  # next pass retries within the same budget

    def _budget_ok(self) -> bool:
        now = time.monotonic()
        while self._respawn_times and \
                now - self._respawn_times[0] > self.policy.window_s:
            self._respawn_times.popleft()
        if len(self._respawn_times) >= self.policy.max_restarts:
            return False
        self._respawn_times.append(now)
        return True

    # ---------------------------------------------------------------- surface
    def members(self) -> List[FleetMember]:
        with self._lock:
            return list(self._members)

    def active_members(self) -> List[FleetMember]:
        return [m for m in self.members() if not m.draining and m.alive]

    def addrs(self) -> List[str]:
        return [m.addr for m in self.active_members()]

    def draining_addrs(self) -> List[str]:
        return [m.addr for m in self.members() if m.draining]

    def pids(self) -> List[int]:
        return [m.proc.pid for m in self.members() if m.alive]

    def stop(self) -> None:
        """Reap everything (shutdown path, not graceful drain)."""
        for m in self.members():
            m.draining = True
            try:
                m.proc.stdin.close()
            except Exception:  # noqa: BLE001 - already gone
                pass
        for m in self.members():
            try:
                m.proc.wait(timeout=10.0)
            except Exception:  # noqa: BLE001 - escalate
                try:
                    m.proc.kill()
                except OSError:
                    pass
        with self._lock:
            self._members.clear()
            self._g_members.set(0)


class FleetSupervisor:
    """The pluggable backend the ``Autoscaler`` drives: named fleets with a
    uniform scale/retire surface and one watchdog thread respawning crashed
    members under their budgets."""

    def __init__(self, watch_interval_s: float = 0.5):
        self._fleets: Dict[str, SubprocessFleet] = {}
        self.watch_interval_s = watch_interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def add_fleet(self, fleet: SubprocessFleet) -> "FleetSupervisor":
        self._fleets[fleet.name] = fleet
        return self

    def fleet(self, name: str) -> SubprocessFleet:
        return self._fleets[name]

    def fleets(self) -> List[str]:
        return sorted(self._fleets)

    # ---------------------------------------------------------------- scaling
    def actual(self, name: str) -> int:
        return len(self._fleets[name].active_members())

    def scale_up(self, name: str, n: int = 1) -> List[str]:
        fleet = self._fleets[name]
        return [fleet.spawn().addr for _ in range(max(0, int(n)))]

    def scale_down(self, name: str, n: int = 1) -> List[str]:
        """Gracefully retire ``n`` members, newest first (LIFO keeps the
        stable core's ring segments untouched), never below the fleet's
        ``min_members``. Returns the addresses now draining."""
        fleet = self._fleets[name]
        active = sorted(fleet.active_members(), key=lambda m: -m.started_ts)
        allowed = max(0, len(active) - fleet.min_members)
        victims = active[:min(max(0, int(n)), allowed)]
        for m in victims:
            fleet.drain(m)
        return [m.addr for m in victims]

    # ------------------------------------------------------------------ watch
    def start(self) -> "FleetSupervisor":
        if self._thread is not None:
            return self

        def run():
            while not self._stop.wait(self.watch_interval_s):
                for fleet in list(self._fleets.values()):
                    try:
                        fleet.check_once()
                    except Exception:  # noqa: BLE001 - watchdog never dies
                        continue

        self._thread = threading.Thread(target=run, name="fleet-watch",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, reap: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if reap:
            for fleet in self._fleets.values():
                fleet.stop()

    # ---------------------------------------------------------------- surface
    def status(self) -> dict:
        out = {}
        for name, fleet in self._fleets.items():
            out[name] = {
                "members": [
                    {"addr": m.addr, "http": m.http_addr, "pid": m.proc.pid,
                     "alive": m.alive, "draining": m.draining}
                    for m in fleet.members()
                ],
                "active": len(fleet.active_members()),
                "draining": fleet.draining_addrs(),
                "gave_up": fleet.gave_up,
            }
        return out


def gateway_cmd(slots: int = 32, coordinator: str = "",
                extra: Optional[List[str]] = None) -> Callable[[int], List[str]]:
    """Standard ``gateway_proc`` member command builder."""
    def build(index: int) -> List[str]:
        cmd = [sys.executable, "-m", "distar_tpu_torch.serve.fleet.gateway_proc",
               "--port", "0", "--http-port", "0", "--slots", str(slots)]
        if coordinator:
            cmd += ["--coordinator", coordinator]
        return cmd + list(extra or [])
    return build


def replay_cmd(spill_root: str = "", coordinator: str = "",
               sampler: str = "fifo",
               extra: Optional[List[str]] = None) -> Callable[[int], List[str]]:
    """Standard ``replay.server`` member command builder (admin surface on,
    spill per member index so a restarted member recovers ITS tail)."""
    import os

    def build(index: int) -> List[str]:
        cmd = [sys.executable, "-m", "distar_tpu_torch.replay.server",
               "--port", "0", "--admin-port", "0",
               "--shard-id", f"s{index}", "--sampler", sampler,
               "--min-size", "1"]
        if spill_root:
            cmd += ["--spill-dir", os.path.join(spill_root, f"s{index}")]
        if coordinator:
            cmd += ["--coordinator", coordinator]
        return cmd + list(extra or [])
    return build
