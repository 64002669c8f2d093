"""Payoff-driven elastic actor reassignment between league learners.

DD-PPO's lesson (PAPERS.md) applied to the league: actor capacity is one
elastic pool, not N static allotments. The matchmaking value of an episode
is highest where the payoff matrix is most uncertain — a pair at winrate
0.5 teaches PFSP the most, a solved pair (0 or 1) teaches nothing — so the
reassigner periodically re-divides the actor budget in proportion to each
learner's summed outcome variance ``w(1-w)`` over its arena pairs, then
drives the fleet machinery (``FleetSupervisor.scale_up`` /
``scale_down`` — graceful LIFO drain, ``min_members`` floor) to match.

Counterpart of ``distar_tpu.league.runtime.reassign``. It takes any
supervisor with ``actual``/``scale_up``/``scale_down``: league-run's
actor-slot fleets under ``fleet.FleetSupervisor``
(``runner.build_actor_fleets``), or a stub in tests.

Everything is read from public surfaces: the payoff cells come from
``ArenaStore.payoff_snapshot()`` (or an injected probe for tests), the
moves go through the supervisor, and the move count is reported to the
hosted :class:`~.service.LeagueService` so ``opsctl league`` and the
``distar_league_reassignments_total`` counter see every rebalance.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

#: outcome variance of an unplayed pair (w = 0.5): the exploration prior
UNPLAYED_VARIANCE = 0.25


def _largest_remainder(weights: Dict[str, float], total: int,
                       floor: int) -> Dict[str, int]:
    """Split ``total`` seats proportionally to ``weights`` with a per-key
    ``floor``, exact by largest-remainder rounding (deterministic ties by
    key). Floors are granted first; the remainder follows the weights."""
    keys = sorted(weights)
    n = len(keys)
    if n == 0:
        return {}
    floor = max(0, int(floor))
    spare = max(0, int(total) - floor * n)
    wsum = sum(max(0.0, weights[k]) for k in keys)
    if wsum <= 0:
        shares = {k: spare / n for k in keys}
    else:
        shares = {k: spare * max(0.0, weights[k]) / wsum for k in keys}
    out = {k: floor + int(shares[k]) for k in keys}
    leftover = floor * n + spare - sum(out.values())
    by_frac = sorted(keys, key=lambda k: (-(shares[k] - int(shares[k])), k))
    for k in by_frac[:leftover]:
        out[k] += 1
    return out


class PayoffReassigner:
    """Rebalance actor fleets across learners from the live payoff matrix.

    ``fleet_players`` maps fleet name (as registered on the supervisor) to
    the league player id that learner trains. ``payoff_fn`` defaults to the
    process-global arena store's ``payoff_snapshot``; tests inject a
    fixture. ``step()`` computes quotas, applies the delta (downscales
    first so the budget is never exceeded mid-move) and returns the per-
    fleet deltas actually applied.
    """

    def __init__(self, supervisor, fleet_players: Dict[str, str],
                 total_actors: int, min_actors: int = 1,
                 payoff_fn: Optional[Callable[[], dict]] = None,
                 service=None):
        self.supervisor = supervisor
        self.fleet_players = dict(fleet_players)
        self.total_actors = int(total_actors)
        self.min_actors = int(min_actors)
        self._payoff_fn = payoff_fn
        self._service = service

    def _payoff_cells(self) -> List[dict]:
        if self._payoff_fn is not None:
            snap = self._payoff_fn()
        else:
            from ...arena import get_arena_store

            store = get_arena_store()
            if store is None:
                return []
            snap = store.payoff_snapshot()
        return list(snap.get("cells") or [])

    def learning_weights(self) -> Dict[str, float]:
        """Per-fleet summed outcome variance of its player's arena pairs.
        A learner with no recorded pairs gets the unplayed prior, so fresh
        exploiters are seeded with capacity instead of starved."""
        cells = self._payoff_cells()
        weights: Dict[str, float] = {}
        for fleet, player in self.fleet_players.items():
            var, pairs = 0.0, 0
            for cell in cells:
                if player not in (cell.get("a"), cell.get("b")):
                    continue
                wr = float(cell.get("win_rate", 0.5))
                var += wr * (1.0 - wr)
                pairs += 1
            weights[fleet] = var if pairs else UNPLAYED_VARIANCE
        return weights

    def desired(self) -> Dict[str, int]:
        return _largest_remainder(
            self.learning_weights(), self.total_actors, self.min_actors)

    def step(self) -> Dict[str, int]:
        """One rebalance pass. Returns {fleet: applied_delta}; reports the
        moved-actor count to the league service (if attached)."""
        want = self.desired()
        have = {name: self.supervisor.actual(name) for name in want}
        deltas = {name: want[name] - have[name] for name in want}
        # drain first: freed slots fund the grows, keeping the pool bounded
        for name in sorted(want):
            if deltas[name] < 0:
                self.supervisor.scale_down(name, -deltas[name])
        for name in sorted(want):
            if deltas[name] > 0:
                self.supervisor.scale_up(name, deltas[name])
        moved = sum(d for d in deltas.values() if d > 0)
        if moved and self._service is not None:
            self._service.note_reassignment(moved)
        return deltas
