"""Remote league proxy: the League surface over HTTP.

Counterpart of ``distar_tpu.league.remote``: ``RemoteLeague`` for the league
server, ``RemoteLeagueService`` for the coordinator-hosted league runtime.

Learners and actors on other hosts construct a RemoteLeague with the league
server's address and use it exactly like an in-process League (the subset of
methods the worker roles call). Retries ride the shared resilience fabric
(``resilience.retry_call`` with a per-proxy circuit breaker) instead of the
hand-rolled loop each transport used to carry — one observable policy for
every cross-process link (role of the reference's requests retry adapters,
reference: distar/ctools/worker/actor/actor_comm.py:59-60, adapter.py:56-63).
"""
from __future__ import annotations

from typing import Optional

from ..resilience import CircuitBreaker, CommError, FatalError, RetryPolicy, retry_call
from .api import league_request


class RemoteLeague:
    def __init__(self, host: str, port: int, retries: int = 5, backoff_s: float = 0.5,
                 timeout: float = 30.0, policy: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None):
        self.host, self.port = host, port
        self._timeout = timeout
        self._policy = policy or RetryPolicy(
            max_attempts=retries, backoff_base_s=backoff_s, backoff_max_s=10.0
        )
        # breaker shared across routes: the peer is one process — if jobs
        # are unreachable, results are too
        self._breaker = breaker or CircuitBreaker(op="league")

    def _call_once(self, route: str, body: dict):
        out = league_request(self.host, self.port, route, body, timeout=self._timeout)
        if out.get("code") == 0:
            return out["info"]
        # the server answered: this is an application error, not peer death
        raise FatalError(f"league {route} error: {out}")

    def _call(self, route: str, body: dict):
        try:
            return retry_call(
                self._call_once, route, body,
                op=f"league:{route}", policy=self._policy, breaker=self._breaker,
            )
        except CommError as e:
            raise CommError(
                f"league {route} unreachable after {self._policy.max_attempts} tries",
                op=e.op, cause=e,
            ) from e

    # --- the League surface used by workers ---
    def register_learner(self, player_id: str, ip: str = "", port: int = 0, rank: int = 0,
                         world_size: int = 1) -> dict:
        return self._call(
            "register_learner",
            {"player_id": player_id, "ip": ip, "port": port, "rank": rank,
             "world_size": world_size},
        )

    def learner_send_train_info(self, player_id: str, train_steps: int,
                                checkpoint_path: Optional[str] = None) -> dict:
        return self._call(
            "learner_send_train_info",
            {"player_id": player_id, "train_steps": train_steps,
             **({"checkpoint_path": checkpoint_path} if checkpoint_path else {})},
        )

    def actor_ask_for_job(self, request: Optional[dict] = None) -> dict:
        return self._call("actor_ask_for_job", request or {"job_type": "train"})

    def actor_send_result(self, result: dict) -> bool:
        return bool(self._call("actor_send_result", result))


class RemoteLeagueService:
    """Proxy for the coordinator-hosted league runtime (league/runtime/).

    The runtime routes live on the COORDINATOR, not the standalone league
    server — this proxy therefore speaks ``comm.coordinator_request`` (the
    resilience retry policy) rather than ``league_request``. The
    method surface mirrors :class:`~.runtime.service.LeagueService` one to
    one; bodies carry the idempotency handles (``learner_id``, ``seq``,
    match ``key``) that make retries safe on the journaled side.

    ``addr`` is a single ``host:port`` or an HA comma list
    (``"h1:p1,h2:p2"``: requests follow leadership across failovers).
    """

    def __init__(self, addr: str, timeout: float = 30.0, policy=None):
        self.addr = addr
        self._timeout = timeout
        self._policy = policy

    def _call(self, route: str, body: dict):
        from ..comm.coordinator import coordinator_request

        out = coordinator_request(self.addr, None, route, body,
                                  timeout=self._timeout, policy=self._policy)
        if out.get("code") != 0:
            raise FatalError(f"league runtime {route} error: {out}")
        return out.get("info")

    # --- the LeagueService surface, one proxy per journaled route ---
    def register_learner(self, player_id: str, learner_id: str = "",
                         ip: str = "", port: int = 0, rank: int = 0,
                         world_size: int = 1) -> dict:
        return self._call("league_register", {
            "player_id": player_id,
            "learner_id": learner_id or player_id,
            "ip": ip, "port": port, "rank": rank, "world_size": world_size,
        })

    def ask_job(self, player_id: str, learner_id: str = "",
                actor: str = "") -> Optional[dict]:
        return self._call("league_ask", {
            "player_id": player_id,
            "learner_id": learner_id or player_id,
            "actor": actor,
        })

    def report(self, job_id: str, matches: list, learner_id: str = "") -> dict:
        return self._call("league_report", {
            "job_id": job_id, "learner_id": learner_id, "matches": matches,
        })

    def train_info(self, player_id: str, seq: int, train_steps: int = 0,
                   checkpoint_path: str = "", generation_path: str = "",
                   learner_id: str = "") -> dict:
        return self._call("league_train_info", {
            "player_id": player_id,
            "learner_id": learner_id or player_id,
            "seq": int(seq),
            "train_steps": int(train_steps),
            **({"checkpoint_path": checkpoint_path} if checkpoint_path else {}),
            **({"generation_path": generation_path} if generation_path else {}),
        })

    def status(self) -> dict:
        return self._call("league_status", {})
