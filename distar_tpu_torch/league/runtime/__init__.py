"""League runtime: the subsystem that RUNS a multi-learner league.

Counterpart of ``distar_tpu.league.runtime``.

``service``   — coordinator-hosted matchmaking control plane (roster, PFSP
                jobs from the arena ledger, snapshot minting from
                checkpoint generations, assignment map), replay-safe by
                construction.
``reassign``  — payoff-driven elastic actor rebalancing over a fleet
                supervisor.
``runner``    — the ``rl_train --type league-run`` launcher: one
                coordinator (league + arena) plus N learner subprocesses,
                and the league learner's loop.
"""
from .reassign import PayoffReassigner
from .service import (
    BRANCHES,
    LeagueService,
    get_league_service,
    set_league_service,
)

__all__ = [
    "BRANCHES",
    "LeagueService",
    "PayoffReassigner",
    "get_league_service",
    "set_league_service",
]
