"""Arena store: the durable skill ledger behind the evaluation arena.

Wires the dormant seed ladder modules (``league/payoff.py``, ``league/
elo.py``, ``league/trueskill.py``) into the live system: every reported
match updates a per-pair payoff matrix (counts + Wilson confidence
intervals), the incremental ELO ladder, the TrueSkill ladder, and a
per-player :class:`~distar_tpu_torch.league.payoff.Payoff` record — then ships
the ratings as ``distar_arena_*`` gauges into the TSDB.

Exactly-once accounting is by construction, not coordination: every match
carries an **idempotent key** ``{home}|{away}|r{round}e{episode}`` derived
from the (deterministically scheduled) pair, the per-pair round counter,
and the episode index within the PRNG-keyed scenario batch. An evaluator
that dies mid-batch reports nothing (reports are whole-batch), re-asks,
and receives the *same* assignment — the round counter only advances when
results for it are applied — so a replayed batch either fills the hole
exactly or dedups exactly.

Scheduling is uncertainty-directed: the widest-Wilson-interval pair plays
next (unplayed pairs have width 1.0 and drain first), with an anchor
round-robin floor so the newest generation keeps meeting the scripted
anchors that ground the rating scale. Durability follows the league
autosave idiom: atomic journal (tmp+fsync+rename) + a daemon autosave
thread; a coordinator restart reloads ratings, payoff, round counters AND
the seen-key set, so idempotency survives the restart too.

Counterpart of ``distar_tpu.arena.store``, host code with no RNG of its
own: the same reports give the same ratings, schedule and dedup counts.
``load`` also reads a ledger the JAX package wrote (``utils.pickles``).
"""
from __future__ import annotations

import math
import pickle
import threading
import zlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..league.algorithms import pfsp
from ..league.elo import DRAW, LOSS, WIN, ELORating
from ..league.payoff import Payoff
from ..league.trueskill import TrueSkill
from ..obs import get_registry

#: scripted policies that ground the rating scale even with one lineage
ANCHORS = ("attack_nearest", "idle")

Z95 = 1.96  # two-sided 95% normal quantile for the Wilson interval


def wilson_interval(wins: float, draws: float, losses: float,
                    z: float = Z95) -> Tuple[float, float]:
    """Wilson score interval on the draw-counts-half success rate.

    Returns ``(low, high)``; the uninformative ``(0, 1)`` with no games.
    """
    n = wins + draws + losses
    if n <= 0:
        return 0.0, 1.0
    p = (wins + 0.5 * draws) / n
    denom = 1.0 + z * z / n
    center = (p + z * z / (2 * n)) / denom
    half = z * math.sqrt(p * (1.0 - p) / n + z * z / (4 * n * n)) / denom
    return max(0.0, center - half), min(1.0, center + half)


def match_key(home: str, away: str, round_idx: int, episode: int) -> str:
    """The idempotent identity of one match (pair + scenario round + seed
    index). Reporting the same key twice is a dedup, never a double-count."""
    return f"{home}|{away}|r{int(round_idx)}e{int(episode)}"


def match_seed(a: str, b: str, round_idx: int) -> int:
    """Deterministic PRNG seed for one (unordered pair, round) scenario set —
    a pure function of the assignment so a restarted evaluator replays the
    exact same episodes."""
    lo, hi = sorted((a, b))
    return zlib.crc32(f"{lo}|{hi}|r{int(round_idx)}".encode())


def _pair_key(a: str, b: str) -> Tuple[str, str]:
    return tuple(sorted((a, b)))  # type: ignore[return-value]


class ArenaStore:
    """Coordinator-hosted payoff matrix + rating ladders + match scheduler."""

    def __init__(self, path: Optional[str] = None,
                 anchors: Sequence[str] = ANCHORS,
                 anchor_period: int = 4,
                 seen_cap: int = 100_000,
                 payoff_min_games: int = 1,
                 payoff_window: int = 256):
        self._lock = threading.Lock()
        self.path = path
        self.anchors = tuple(anchors)
        self.anchor_period = max(1, int(anchor_period))
        self._seen_cap = int(seen_cap)
        self._payoff_min_games = payoff_min_games
        self._payoff_window = payoff_window
        # ordered-pair (home, away) -> {wins, draws, losses, games}, home view
        self._pairs: Dict[Tuple[str, str], Dict[str, int]] = {}
        # unordered-pair -> next scenario round to schedule (advances only
        # when results for the current round are applied)
        self._next_round: Dict[Tuple[str, str], int] = {}
        self._seen: "OrderedDict[str, None]" = OrderedDict()
        self.elo = ELORating()
        self.trueskill = TrueSkill()
        self.payoffs: Dict[str, Payoff] = {}
        self.matches_total = 0
        self.duplicates_total = 0
        self._autosave_stop: Optional[threading.Event] = None
        self._autosave_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- scheduling
    def next_match(self, players: Sequence[str],
                   episodes: int = 8) -> Optional[dict]:
        """Deterministic uncertainty-directed assignment.

        ``players`` is the model roster newest-first (anchors are implicit).
        Pure function of *reported* state: re-asking without reporting
        returns the same assignment, which is what makes the idempotent
        keys exact under evaluator kill/restart.
        """
        with self._lock:
            roster = list(dict.fromkeys(list(players) + list(self.anchors)))
            if len(roster) < 2:
                return None
            completed = sum(self._next_round.values())
            pair: Optional[Tuple[str, str]] = None
            if players and self.anchors and completed % self.anchor_period == 0:
                # anchor floor: newest generation meets the rotating anchor
                anchor = self.anchors[(completed // self.anchor_period)
                                      % len(self.anchors)]
                if players[0] != anchor:
                    pair = _pair_key(players[0], anchor)
            if pair is None:
                # widest Wilson interval first; ties break lexicographically
                best = None
                for i, a in enumerate(roster):
                    for b in roster[i + 1:]:
                        w, d, l = self._merged_counts(a, b)
                        lo, hi = wilson_interval(w, d, l)
                        cand = (-(hi - lo), _pair_key(a, b))
                        if best is None or cand < best:
                            best = cand
                assert best is not None
                pair = best[1]
            rnd = self._next_round.get(pair, 0)
            # alternate the home seat round-over-round to cancel asymmetry
            home, away = pair if rnd % 2 == 0 else (pair[1], pair[0])
            return {"home": home, "away": away, "round": rnd,
                    "seed": match_seed(home, away, rnd),
                    "episodes": int(episodes)}

    def _merged_counts(self, a: str, b: str) -> Tuple[int, int, int]:
        """(wins, draws, losses) from a's perspective over both seatings."""
        ab = self._pairs.get((a, b), {})
        ba = self._pairs.get((b, a), {})
        wins = ab.get("wins", 0) + ba.get("losses", 0)
        draws = ab.get("draws", 0) + ba.get("draws", 0)
        losses = ab.get("losses", 0) + ba.get("wins", 0)
        return wins, draws, losses

    # -------------------------------------------------------------- reporting
    def report_batch(self, records: Sequence[dict]) -> dict:
        """Apply match records exactly once; duplicates dedup by key.

        Each record: ``{key, home, away, round, winner, game_steps,
        duration_s}`` with ``winner`` in {"home", "away", "draw"}.
        Returns ``{"applied": n, "duplicates": m}``.
        """
        applied = duplicates = 0
        with self._lock:
            for rec in records:
                key = str(rec["key"])
                if key in self._seen:
                    duplicates += 1
                    continue
                self._seen[key] = None
                while len(self._seen) > self._seen_cap:
                    self._seen.popitem(last=False)
                self._apply(rec)
                applied += 1
            self.matches_total += applied
            self.duplicates_total += duplicates
        self._publish_metrics()
        return {"applied": applied, "duplicates": duplicates}

    def _apply(self, rec: dict) -> None:
        home, away = str(rec["home"]), str(rec["away"])
        winner = str(rec.get("winner", "draw"))
        st = self._pairs.setdefault(
            (home, away), {"wins": 0, "draws": 0, "losses": 0, "games": 0})
        stat_home = {"game_steps": float(rec.get("game_steps", 0.0)),
                     "game_duration": float(rec.get("duration_s", 0.0))}
        stat_away = dict(stat_home)
        if winner == "home":
            st["wins"] += 1
            self.elo.update(home, away, WIN)
            self.trueskill.update(home, away)
            stat_home["winrate"], stat_away["winrate"] = 1.0, 0.0
        elif winner == "away":
            st["losses"] += 1
            self.elo.update(home, away, LOSS)
            self.trueskill.update(away, home)
            stat_home["winrate"], stat_away["winrate"] = 0.0, 1.0
        else:
            st["draws"] += 1
            self.elo.update(home, away, DRAW)
            self.trueskill.update(home, away, draw=True)
            stat_home["winrate"] = stat_away["winrate"] = 0.5
        st["games"] += 1
        self._payoff(home).update(away, stat_home)
        self._payoff(away).update(home, stat_away)
        pair = _pair_key(home, away)
        rnd = int(rec.get("round", 0))
        self._next_round[pair] = max(self._next_round.get(pair, 0), rnd + 1)

    def _payoff(self, pid: str) -> Payoff:
        p = self.payoffs.get(pid)
        if p is None:
            p = self.payoffs[pid] = Payoff(
                warm_up_size=self._payoff_window,
                min_win_rate_games=self._payoff_min_games)
        return p

    # -------------------------------------------------------------- snapshots
    def players(self) -> List[str]:
        with self._lock:
            return sorted({p for pair in self._pairs for p in pair}
                          | set(self.anchors))

    def ratings_snapshot(self) -> dict:
        """``GET /arena/ratings`` payload: ladders + match accounting."""
        with self._lock:
            elo_r = self.elo.ratings(start_from_zero=False)
            roster = sorted({p for pair in self._pairs for p in pair}
                            | set(self.anchors))
            players = {}
            for p in roster:
                mu, sigma = self.trueskill._get(p)
                games = sum(self._pairs.get((p, o), {}).get("games", 0)
                            + self._pairs.get((o, p), {}).get("games", 0)
                            for o in roster if o != p)
                players[p] = {
                    "elo": elo_r.get(p, self.elo.init_elo),
                    "trueskill_mu": mu, "trueskill_sigma": sigma,
                    "trueskill_exposed": mu - 3.0 * sigma,
                    "games": games,
                    "anchor": p in self.anchors,
                }
            return {"players": players,
                    "anchors": list(self.anchors),
                    "matches_total": self.matches_total,
                    "duplicates_total": self.duplicates_total}

    def payoff_snapshot(self) -> dict:
        """``GET /arena/payoff`` payload: matrix + Wilson CIs + PFSP preview."""
        with self._lock:
            roster = sorted({p for pair in self._pairs for p in pair}
                            | set(self.anchors))
            cells = []
            for i, a in enumerate(roster):
                for b in roster[i + 1:]:
                    w, d, l = self._merged_counts(a, b)
                    n = w + d + l
                    lo, hi = wilson_interval(w, d, l)
                    cells.append({
                        "a": a, "b": b, "wins": w, "draws": d, "losses": l,
                        "games": n,
                        "win_rate": (w + 0.5 * d) / n if n else 0.5,
                        "wilson_low": lo, "wilson_high": hi,
                    })
            preview = self._pfsp_preview_locked(roster)
            return {"players": roster, "cells": cells,
                    "pfsp_preview": preview,
                    "pfsp_weighting": "variance"}

    def pfsp_preview(self, roster: Sequence[str]) -> Dict[str, Dict[str, float]]:
        """Public PFSP-weight rows over an explicit roster — the league
        matchmaker's read path (it must weight exactly what the payoff
        snapshot previews, so both call one implementation)."""
        with self._lock:
            return self._pfsp_preview_locked(list(roster))

    def _pfsp_preview_locked(self, roster: List[str]) -> Dict[str, Dict[str, float]]:
        """Read-only PFSP opponent weights per player: the paper's variance
        weighting ``w(1-w)`` over observed winrates (0.5 for unplayed pairs),
        normalized — what the league PR will matchmake from."""
        preview: Dict[str, Dict[str, float]] = {}
        for p in roster:
            opponents = [o for o in roster if o != p]
            if not opponents:
                continue
            wrs = []
            for o in opponents:
                w, d, l = self._merged_counts(p, o)
                n = w + d + l
                wrs.append((w + 0.5 * d) / n if n else 0.5)
            weights = pfsp(np.asarray(wrs), weighting="variance")
            preview[p] = {o: float(wt) for o, wt in zip(opponents, weights)}
        return preview

    # ---------------------------------------------------------------- metrics
    def _publish_metrics(self) -> None:
        with self._lock:
            elo_r = self.elo.ratings(start_from_zero=False)
            ts = {p: self.trueskill.exposed(p) for p in self.trueskill.ratings}
            matches, dups = self.matches_total, self.duplicates_total
            pairs = len({_pair_key(*k) for k in self._pairs})
            newest = self._newest_player_locked()
        reg = get_registry()
        for player, rating in elo_r.items():
            reg.gauge("distar_arena_rating_elo",
                      "ELO rating per arena player (ladder offsets + init)",
                      player=player).set(rating)
        for player, exposed in ts.items():
            reg.gauge("distar_arena_rating_trueskill",
                      "conservative TrueSkill rating (mu - 3*sigma) per arena player",
                      player=player).set(exposed)
        reg.gauge("distar_arena_matches_applied",
                  "matches applied to the payoff matrix (post-dedup)").set(matches)
        reg.gauge("distar_arena_duplicates",
                  "match reports dropped as idempotent-key duplicates").set(dups)
        reg.gauge("distar_arena_pairs",
                  "distinct player pairs with at least one match").set(pairs)
        if newest is not None and newest in elo_r:
            rating = elo_r[newest]
            reg.gauge("distar_arena_main_rating",
                      "ELO of the newest non-anchor generation").set(rating)
            reg.gauge(
                "distar_arena_main_rating_inverted",
                "negated main-lineage ELO — trending_up here means the newest "
                "generation is LOSING rating (the regression rule's input)",
            ).set(-rating)

    def _newest_player_locked(self) -> Optional[str]:
        """Newest non-anchor player by the ``role:step`` id convention
        (max step wins); None when only anchors are known."""
        best: Tuple[int, str] = (-1, "")
        for pair in self._pairs:
            for p in pair:
                if p in self.anchors:
                    continue
                step = -1
                if ":" in p:
                    try:
                        step = int(p.rsplit(":", 1)[1])
                    except ValueError:
                        step = -1
                if (step, p) > best:
                    best = (max(step, 0), p)
        return best[1] or None

    # -------------------------------------------------------------- durability
    def _state_locked(self) -> dict:
        return {
            "pairs": dict(self._pairs),
            "next_round": dict(self._next_round),
            "seen": list(self._seen.keys()),
            "elo": self.elo,
            "trueskill": self.trueskill,
            "payoffs": self.payoffs,
            "matches_total": self.matches_total,
            "duplicates_total": self.duplicates_total,
        }

    def state_blob(self) -> dict:
        """Detached full-ledger state — the HA snapshot payload (journal
        snapshots and the warm-standby follower feed both carry it). The
        pickle round-trip detaches the live ladder objects so later matches
        can't mutate a snapshot already handed out."""
        with self._lock:
            return pickle.loads(pickle.dumps(self._state_locked()))

    def load_state(self, data: dict) -> None:
        """Adopt a ``state_blob()``/journal payload wholesale — ratings,
        payoff matrix, round counters AND the seen-key set, so idempotent
        dedup keeps holding across restarts and failovers."""
        with self._lock:
            self._pairs = dict(data["pairs"])
            self._next_round = dict(data["next_round"])
            self._seen = OrderedDict((k, None) for k in data["seen"])
            self.elo = data["elo"]
            self.trueskill = data["trueskill"]
            self.payoffs = data["payoffs"]
            self.matches_total = int(data["matches_total"])
            self.duplicates_total = int(data["duplicates_total"])
        self._publish_metrics()

    def save(self, path: Optional[str] = None) -> str:
        """Atomic journal (tmp+fsync+rename via the storage layer): a
        coordinator killed mid-save leaves the previous journal intact."""
        from ..utils import storage

        path = path or self.path
        assert path, "ArenaStore.save needs a path"
        with self._lock:
            blob = pickle.dumps(self._state_locked())
        storage.write_bytes(path, blob)
        return path

    def load(self, path: Optional[str] = None) -> None:
        """Adopt the journal at ``path``, the port's or the JAX package's."""
        from ..utils import pickles, storage

        path = path or self.path
        assert path, "ArenaStore.load needs a path"
        self.load_state(pickles.loads(storage.read_bytes(path)))

    def maybe_load(self) -> bool:
        """Load the journal at ``self.path`` if present; False otherwise."""
        from ..utils import storage

        if self.path and storage.exists(self.path):
            self.load(self.path)
            return True
        return False

    def start_autosave(self, path: Optional[str] = None,
                       interval_s: float = 30.0) -> str:
        """Periodic journaling on a daemon thread (the league-autosave
        idiom): journaling failures must never kill match accounting."""
        path = path or self.path
        assert path, "ArenaStore.start_autosave needs a path"
        assert interval_s > 0
        self.path = path
        self.stop_autosave()
        self._autosave_stop = threading.Event()
        stop = self._autosave_stop

        def run():
            saves = get_registry().counter(
                "distar_arena_autosaves_total", "arena journals written")
            while not stop.wait(interval_s):
                try:
                    self.save(path)
                    saves.inc()
                except Exception:
                    pass  # next tick retries; the previous journal is intact

        self._autosave_thread = threading.Thread(
            target=run, daemon=True, name="arena-autosave")
        self._autosave_thread.start()
        return path

    def stop_autosave(self) -> None:
        stop, thread = self._autosave_stop, self._autosave_thread
        if stop is not None:
            stop.set()
        if thread is not None:
            thread.join(timeout=10.0)
            self._autosave_thread = None


# --------------------------------------------------------------- process-global
_STORE: Optional[ArenaStore] = None
_STORE_LOCK = threading.Lock()


def set_arena_store(store: Optional[ArenaStore]) -> None:
    global _STORE
    with _STORE_LOCK:
        _STORE = store


def get_arena_store() -> Optional[ArenaStore]:
    with _STORE_LOCK:
        return _STORE
