"""Player multiplexing: several models behind ONE gateway address.

Counterpart of ``distar_tpu.serve.mux``. ``GatewayMux`` is one TCP + one
HTTP address fronting a ``{player: InferenceGateway}`` table, with
requests routed by the optional wire ``player`` field both frontends
carry. Each player keeps its OWN engine, session table, micro-batcher and
versioned registry — sessions are keyed by ``(player, session)`` by
construction, and a hot swap of one player cannot disturb another's
flushes. Requests without a ``player`` field resolve to the
``default_player`` (the first configured); a request naming an unserved
player answers the typed ``unknown_player`` wire error.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from .errors import UnknownPlayerError
from .gateway import InferenceGateway

#: Model-tiering player ids (docs/serving.md, model tiering): the wire
#: ``player`` field IS the QoS class — teacher-tier traffic (eval, ladder,
#: showmatches: quality-critical, low volume) names the full-size policy,
#: student-tier traffic (bulk rollouts: volume-critical) names the
#: distilled student. One mux, one address, zero new wire surface.
TEACHER_TIER = "teacher"
STUDENT_TIER = "student"

_TIER_BY_TRAFFIC = {
    "eval": TEACHER_TIER,
    "ladder": TEACHER_TIER,
    "showmatch": TEACHER_TIER,
    "rollout": STUDENT_TIER,
    "bulk": STUDENT_TIER,
}


def tier_player(traffic: str, default: str = STUDENT_TIER) -> str:
    """The serving-tier player id for a traffic class: quality-critical
    classes (eval/ladder/showmatch) ride the teacher, everything bulk
    rides the student. Unknown classes get ``default`` — bulk-by-default
    keeps the expensive tier reserved for traffic that NAMED it."""
    return _TIER_BY_TRAFFIC.get(str(traffic).lower(), default)


class GatewayMux:
    """The gateway surface over a per-player gateway table.

    Frontends call ``resolve(player)`` first (both do, whenever the target
    has a ``resolve`` attribute) and dispatch the op against the result:
    the player's ``InferenceGateway``, or this mux itself for ``player is
    None`` — the mux delegates session/admin ops to the default player's
    gateway and aggregates ``status`` across all of them."""

    def __init__(self, gateways: Dict[str, InferenceGateway],
                 default_player: Optional[str] = None):
        if not gateways:
            raise ValueError("GatewayMux needs at least one player gateway")
        self.gateways = dict(gateways)
        self.default_player = default_player or next(iter(self.gateways))
        if self.default_player not in self.gateways:
            raise ValueError(
                f"default player {self.default_player!r} not in "
                f"{sorted(self.gateways)}")

    # ---------------------------------------------------------------- routing
    def resolve(self, player: Optional[str]):
        """The dispatch target for a request: the named player's gateway, or
        the mux itself (default-player delegation + aggregate status) when
        the request carries no player field."""
        if player is None:
            return self
        gw = self.gateways.get(player)
        if gw is None:
            raise UnknownPlayerError(
                f"player {player!r} not served here (players: "
                f"{sorted(self.gateways)})")
        return gw

    def players(self) -> List[str]:
        return sorted(self.gateways)

    @property
    def _default(self) -> InferenceGateway:
        return self.gateways[self.default_player]

    # -------------------------------------------- default-player delegation
    def act(self, session_id, obs, timeout_s=None, want_teacher=False,
            trace=None):
        return self._default.act(session_id, obs, timeout_s,
                                 want_teacher=want_teacher, trace=trace)

    def act_many(self, requests, timeout_s=None):
        return self._default.act_many(requests, timeout_s=timeout_s)

    def reserve_sessions(self, session_ids):
        return self._default.reserve_sessions(session_ids)

    def session_hidden(self, session_id):
        return self._default.session_hidden(session_id)

    def set_teacher(self, params):
        return self._default.set_teacher(params)

    def reset_session(self, session_id):
        return self._default.reset_session(session_id)

    def end_session(self, session_id):
        return self._default.end_session(session_id)

    def load_version(self, version, source=None, params=None, activate=False):
        return self._default.load_version(version, source=source, params=params,
                                          activate=activate)

    def activate_version(self, version):
        return self._default.activate_version(version)

    # ---------------------------------------------------------------- status
    def status(self) -> dict:
        """Aggregate view: per-player gateway status plus the fields a
        single gateway reports — sessions/requests SUMMED over players,
        generation/version from the default player (the one legacy callers
        are talking to)."""
        per_player = {p: gw.status() for p, gw in self.gateways.items()}
        default = per_player[self.default_player]
        sessions = {k: sum(st["sessions"].get(k, 0) for st in per_player.values())
                    for k in ("active", "free_slots", "num_slots", "inflight")}
        requests = {}
        for st in per_player.values():
            for k, v in (st.get("requests") or {}).items():
                requests[k] = requests.get(k, 0.0) + v
        total = sum(requests.values())
        return {
            **default,
            "sessions": sessions,
            "requests": requests,
            "shed_rate": round(requests.get("shed", 0.0) / total, 6) if total else 0.0,
            "queue_depth": sum(st.get("queue_depth", 0) for st in per_player.values()),
            "players": per_player,
            "default_player": self.default_player,
        }

    # -------------------------------------------------------------- lifecycle
    def start(self) -> "GatewayMux":
        for gw in self.gateways.values():
            gw.start()
        return self

    def begin_drain(self) -> dict:
        """Graceful retirement of the whole address: every player gateway
        sheds new requests and finishes those in flight. Idempotent."""
        for gw in self.gateways.values():
            gw.begin_drain()
        return {"draining": True, "resident": self.resident_sessions()}

    def resident_sessions(self) -> int:
        return sum(gw.resident_sessions() for gw in self.gateways.values())

    @property
    def draining(self) -> bool:
        return any(gw._draining for gw in self.gateways.values())

    def drain_and_stop(self, timeout: Optional[float] = 30.0) -> None:
        self.begin_drain()
        for gw in self.gateways.values():
            gw.drain_and_stop(timeout)
