"""Core-pinning harness: make multi-process measurements physically honest.

Counterpart of ``distar_tpu.fleet.pinning``. When the host has the cores,
each fleet process the harness starts is pinned to its own disjoint core
set (``os.sched_setaffinity``, taskset's syscall) and the driving client
to a reserved core, and a **provenance block** records it beside the
numbers. When the host does not have enough cores, or the platform cannot
set an affinity, ``plan`` REFUSES in band: the block says ``pinned:
false`` with the reason, and ``scaling_valid`` stays false. The harness
pins only processes it was handed (its own children, or itself to its
current mask), never another process of the machine.

The contract, as the JAX package's ``tools/perf_gate.py`` scaling gate
reads it:

    an artifact may claim ``scaling_valid: true`` ONLY with a ``pinning``
    block whose ``pinned`` is true and whose ``host_cores`` is >= 2.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

#: the provenance block's tool tag (the JAX package's perf_gate matches on it)
TOOL = "tools/pin.py"


def host_cores() -> int:
    """Cores THIS process may schedule onto (the affinity mask, not the
    machine total — a cgroup/taskset-restricted run must not claim cores it
    cannot use)."""
    if hasattr(os, "sched_getaffinity"):
        return len(os.sched_getaffinity(0))
    return os.cpu_count() or 1


def can_pin() -> bool:
    return hasattr(os, "sched_setaffinity")


@dataclass
class PinPlan:
    """A per-process core assignment, or an explicit refusal.

    ``assignments[i]`` is the core list for fleet process ``i``;
    ``client_cores`` is the reserved set for the driving client (load
    generator / learner fan-in). ``pinned`` is False when the host cannot
    honestly separate the processes — callers MUST then keep
    ``scaling_valid: false``."""

    pinned: bool
    host_cores: int
    assignments: List[List[int]] = field(default_factory=list)
    client_cores: List[int] = field(default_factory=list)
    refused_reason: str = ""

    def provenance(self, applied: Optional[Dict[str, List[int]]] = None) -> dict:
        """The artifact block a scaling gate verifies. ``applied``
        maps role/pid labels to the core lists actually installed."""
        out = {
            "tool": TOOL,
            "pinned": self.pinned,
            "host_cores": self.host_cores,
        }
        if self.pinned:
            out["assignments"] = applied if applied is not None else {
                f"proc{i}": cores for i, cores in enumerate(self.assignments)
            }
            out["client_cores"] = list(self.client_cores)
        else:
            out["refused_reason"] = self.refused_reason or "insufficient cores"
        return out


def plan(n_procs: int, reserve_client: int = 1,
         cores: Optional[List[int]] = None) -> PinPlan:
    """Plan a one-core-per-process assignment for ``n_procs`` fleet
    processes plus ``reserve_client`` cores for the driving side.

    REFUSES (``pinned=False``) rather than over-subscribing: a host with
    fewer than ``n_procs + reserve_client`` schedulable cores cannot give
    each process its own silicon, so any scaling measured there is
    context-switch arithmetic, not a separation claim. Also refuses on
    platforms without ``sched_setaffinity`` (macOS) — claiming pinning
    without the syscall would be exactly the dishonesty this gate exists to
    stop."""
    n_procs = int(n_procs)
    reserve_client = max(0, int(reserve_client))
    if n_procs < 1:
        raise ValueError("plan needs n_procs >= 1")
    if cores is None:
        cores = sorted(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") \
            else list(range(os.cpu_count() or 1))
    total = len(cores)
    if not can_pin():
        return PinPlan(pinned=False, host_cores=total,
                       refused_reason="platform has no sched_setaffinity")
    need = n_procs + reserve_client
    if total < need or total < 2:
        return PinPlan(
            pinned=False, host_cores=total,
            refused_reason=(
                f"{total} schedulable core(s) < {n_procs} fleet process(es)"
                f" + {reserve_client} client core(s): pinning would still "
                "time-share"))
    # one core per fleet process, the remainder to the client side — the
    # client is usually the fan-out bottleneck and may be multi-threaded
    assignments = [[cores[i]] for i in range(n_procs)]
    client = cores[n_procs:] if reserve_client else cores[n_procs:] or cores
    return PinPlan(pinned=True, host_cores=total, assignments=assignments,
                   client_cores=list(client) or [cores[-1]])


def pin_pid(pid: int, cores: List[int]) -> bool:
    """Install an affinity mask on a live process (0 = self). Returns False
    instead of raising when the platform or permissions refuse — callers
    must then downgrade their claim, not crash the bench."""
    if not can_pin() or not cores:
        return False
    try:
        os.sched_setaffinity(int(pid), set(int(c) for c in cores))
        return True
    except (OSError, ValueError):
        return False


def apply(plan_: PinPlan, pids: List[int],
          client_pid: int = 0) -> Optional[dict]:
    """Apply a plan to live fleet processes (+ the calling client). Returns
    the provenance block on full success, ``None`` when any pin failed —
    the all-or-nothing contract: a half-pinned fleet is still time-shared
    somewhere, so no provenance may be claimed."""
    if not plan_.pinned:
        return None
    if len(pids) > len(plan_.assignments):
        return None
    applied: Dict[str, List[int]] = {}
    for pid, cores in zip(pids, plan_.assignments):
        if not pin_pid(pid, cores):
            return None
        applied[f"pid{pid}"] = list(cores)
    if plan_.client_cores:
        if not pin_pid(client_pid, plan_.client_cores):
            return None
        applied["client"] = list(plan_.client_cores)
    return plan_.provenance(applied)


def pin_fleet(pids: List[int], reserve_client: int = 1) -> dict:
    """The one-call harness benches and drills use: plan for ``len(pids)``
    processes, apply when the host allows, and ALWAYS return a provenance
    block — ``pinned: true`` with the installed assignments, or ``pinned:
    false`` with the refusal reason, in-band either way."""
    p = plan(len(pids), reserve_client=reserve_client)
    if not p.pinned:
        return p.provenance()
    prov = apply(p, pids)
    if prov is None:
        refused = PinPlan(pinned=False, host_cores=p.host_cores,
                          refused_reason="sched_setaffinity failed on a "
                                         "fleet member (permissions?)")
        return refused.provenance()
    return prov


def scaling_valid(provenance: dict, min_cores: int = 2) -> bool:
    """The ONLY way an artifact should compute its ``scaling_valid`` flag:
    true iff pinning was actually installed on a host with enough cores."""
    return bool(provenance.get("pinned")) and \
        int(provenance.get("host_cores", 0)) >= int(min_cores)
