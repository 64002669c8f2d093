"""The league: players, matchmaking, payoff, ELO and TrueSkill, its HTTP API
and the remote proxy.

Counterpart of ``distar_tpu.league``; ``league/runtime/`` is the
coordinator-hosted league runtime (matchmaking service, reassigner and the
league-run launcher). Host code apart from the runner's learner loop, which
drives the fused rollout on the device.
"""
from .algorithms import pfsp
from .api import LeagueAPIServer, league_request
from .elo import ELORating
from .league import LEAGUE_DEFAULTS, League
from .payoff import Payoff
from .player import (
    ActivePlayer,
    AdaptiveEvolutionaryExploiterPlayer,
    ExpertExploiterPlayer,
    ExpertPlayer,
    ExploiterPlayer,
    HistoricalPlayer,
    MainExploiterPlayer,
    MainPlayer,
    Player,
    active_player_type,
)
from .remote import RemoteLeague
from .stats import EmaMeter, WindowedMeter
from .trueskill import TrueSkill

__all__ = [
    "pfsp",
    "LeagueAPIServer",
    "league_request",
    "ELORating",
    "LEAGUE_DEFAULTS",
    "League",
    "Payoff",
    "ActivePlayer",
    "AdaptiveEvolutionaryExploiterPlayer",
    "ExpertExploiterPlayer",
    "ExpertPlayer",
    "ExploiterPlayer",
    "HistoricalPlayer",
    "MainExploiterPlayer",
    "MainPlayer",
    "Player",
    "RemoteLeague",
    "TrueSkill",
    "active_player_type",
    "EmaMeter",
    "WindowedMeter",
]
