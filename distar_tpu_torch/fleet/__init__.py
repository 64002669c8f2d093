"""Elastic fleet control plane.

Counterpart of ``distar_tpu.fleet``. The coordinator-side loop that lets the serving/replay fleets reshape
themselves under load instead of being hand-sized at launch:

* ``pinning``    — the core-pinning harness that makes multi-process perf
  numbers honest (``scaling_valid: true`` requires its provenance block);
* ``supervisor`` — ``FleetSupervisor``/``SubprocessFleet``: spawn, watch,
  respawn-under-budget and gracefully drain real member processes;
* ``autoscaler`` — ``Autoscaler`` + declarative ``ScalePolicy`` rules over
  the obs TSDB, with hysteresis and cooldown, driving the supervisor.

``league.runtime.runner.build_actor_fleets`` builds league-run's
actor-slot fleets on the supervisor.
"""
from .autoscaler import (
    SIG_GW_ACTIVE,
    SIG_GW_QUEUE,
    SIG_GW_SHED,
    SIG_GW_SLOTS,
    SIG_RP_BLOCK_INSERT,
    SIG_RP_CAPACITY,
    SIG_RP_ITEMS,
    Autoscaler,
    MemberProbe,
    ScalePolicy,
    default_policies,
    get_autoscaler,
    set_autoscaler,
)
from .pinning import PinPlan, can_pin, host_cores, pin_fleet, pin_pid, plan, scaling_valid
from .supervisor import (
    FleetMember,
    FleetSupervisor,
    SubprocessFleet,
    gateway_cmd,
    replay_cmd,
)

__all__ = [
    "SIG_GW_ACTIVE",
    "SIG_GW_QUEUE",
    "SIG_GW_SHED",
    "SIG_GW_SLOTS",
    "SIG_RP_BLOCK_INSERT",
    "SIG_RP_CAPACITY",
    "SIG_RP_ITEMS",
    "Autoscaler",
    "MemberProbe",
    "ScalePolicy",
    "default_policies",
    "get_autoscaler",
    "set_autoscaler",
    "PinPlan",
    "can_pin",
    "host_cores",
    "pin_fleet",
    "pin_pid",
    "plan",
    "scaling_valid",
    "FleetMember",
    "FleetSupervisor",
    "SubprocessFleet",
    "gateway_cmd",
    "replay_cmd",
]
