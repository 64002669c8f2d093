"""Multi-gateway serving fleet: discovery, session-affinity routing, rollout.

Counterpart of ``distar_tpu.serve.fleet``: many ``bin/serve.py`` gateways
register with the coordinator under the ``serve_gateway`` token (lease,
heartbeat, ``peers`` discovery); a routing tier pins sticky-carry sessions
to gateways over a consistent-hash ring, as an in-client library
(``FleetClient``) or a standalone proxy (``python -m
distar_tpu_torch.serve.fleet.router``); and ``FleetRollout`` drives
all-or-nothing fleet-wide hot swaps with per-gateway ack and rollback, and
canary-percent rollouts.

Failure model in one line: a dead gateway's sessions re-route to survivors
within one retry budget and re-materialize from a zero carry, counted in
``distar_fleet_session_migrations_total``.
"""
from .discovery import GATEWAY_TOKEN, GatewayMap, register_gateway
from .rollout import CANARY_TOKEN, FleetRollout, fetch_canary, publish_canary
from .router import FleetClient, FleetRouter, RouterGatewayAdapter

__all__ = [
    "CANARY_TOKEN",
    "FleetClient",
    "FleetRollout",
    "FleetRouter",
    "GATEWAY_TOKEN",
    "GatewayMap",
    "RouterGatewayAdapter",
    "fetch_canary",
    "publish_canary",
    "register_gateway",
]
