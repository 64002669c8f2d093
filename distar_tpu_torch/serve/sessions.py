"""Sticky sessions: server-side recurrent state in a bounded slot map.

Counterpart of ``distar_tpu.serve.sessions``. Each client
session pins one engine slot so its LSTM carry lives on the server between
requests. Slots are a hard capacity — the batch dimension of the forward —
so allocation is admission control: a new session gets a free slot, else the
least-recently-used idle-expired session is evicted, else the request is
shed with ``CapacityError``. Sessions with requests in flight are never
evicted.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from ..obs import get_registry
from .errors import CapacityError


class _Session:
    __slots__ = ("session_id", "slot", "last_seen", "inflight", "created", "steps")

    def __init__(self, session_id: str, slot: int, now: float):
        self.session_id = session_id
        self.slot = slot
        self.last_seen = now
        self.inflight = 0
        self.created = now
        self.steps = 0  # forwards served this episode (zeroed on reset)


class SessionTable:
    def __init__(
        self,
        num_slots: int,
        idle_ttl_s: float = 300.0,
        on_alloc: Optional[Callable[[int], None]] = None,
    ):
        """``on_alloc(slot)`` runs under the table lock whenever a slot is
        (re)assigned — the gateway zeroes the engine's hidden state there so
        a recycled slot never leaks the previous session's carry."""
        assert num_slots > 0
        self.num_slots = num_slots
        self.idle_ttl_s = idle_ttl_s
        self._on_alloc = on_alloc
        self._sessions: Dict[str, _Session] = {}
        self._free = list(range(num_slots - 1, -1, -1))  # pop() -> slot 0 first
        self._lock = threading.Lock()
        reg = get_registry()
        self._g_active = reg.gauge(
            "distar_serve_sessions_active", "sessions currently holding a slot"
        )
        self._c_evict = reg.counter(
            "distar_serve_session_evictions_total", "idle sessions evicted for capacity"
        )

    # ------------------------------------------------------------- lifecycle
    def acquire(self, session_id: str) -> int:
        """Return the session's slot, allocating (and possibly evicting an
        idle-expired session) on first contact; bumps last_seen and the
        in-flight count. Pair every acquire with ``release``."""
        now = time.time()
        with self._lock:
            s = self._sessions.get(session_id)
            if s is None:
                slot = self._alloc_locked(now)
                s = _Session(session_id, slot, now)
                self._sessions[session_id] = s
                self._g_active.set(len(self._sessions))
                if self._on_alloc is not None:
                    self._on_alloc(slot)
            s.last_seen = now
            s.inflight += 1
            return s.slot

    def reserve(self, session_ids: List[str]) -> Dict[str, int]:
        """All-or-nothing bulk allocation (the rollout plane's exact-
        capacity admission: actors pre-allocate every env slot's session at
        job start so nothing sheds mid-episode). Either every id gets a
        slot — already-known ids keep theirs — or the table is untouched
        and a typed ``CapacityError`` reports the shortfall up front.
        Eviction of idle-expired sessions is allowed, exactly as in the
        single-session path; in-flight sessions are never victims."""
        now = time.time()
        with self._lock:
            need = [sid for sid in dict.fromkeys(session_ids)
                    if sid not in self._sessions]
            evictable = sum(
                1 for s in self._sessions.values()
                if s.inflight == 0 and now - s.last_seen >= self.idle_ttl_s
            )
            if len(need) > len(self._free) + evictable:
                raise CapacityError(
                    f"reserve of {len(need)} new sessions exceeds capacity: "
                    f"{len(self._free)} free + {evictable} evictable of "
                    f"{self.num_slots} slots"
                )
            out: Dict[str, int] = {}
            for sid in need:
                slot = self._alloc_locked(now)  # cannot fail: counted above
                self._sessions[sid] = _Session(sid, slot, now)
                if self._on_alloc is not None:
                    self._on_alloc(slot)
            self._g_active.set(len(self._sessions))
            for sid in dict.fromkeys(session_ids):
                s = self._sessions[sid]
                s.last_seen = now
                out[sid] = s.slot
            return out

    def note_step(self, session_id: str) -> int:
        """One forward served for this session; returns the episode-local
        step count (clients detect a server-side carry reset — restart,
        eviction — when this counter runs backwards)."""
        with self._lock:
            s = self._sessions.get(session_id)
            if s is None:
                return 0
            s.steps += 1
            return s.steps

    def reset_steps(self, session_id: str) -> None:
        """Episode boundary: the step counter restarts with the carry."""
        with self._lock:
            s = self._sessions.get(session_id)
            if s is not None:
                s.steps = 0

    def release(self, session_id: str) -> None:
        """A request for this session finished (delivered, shed or timed
        out) — the session becomes evictable again once idle-expired."""
        with self._lock:
            s = self._sessions.get(session_id)
            if s is not None:
                s.inflight = max(0, s.inflight - 1)
                s.last_seen = time.time()

    def _alloc_locked(self, now: float) -> int:
        if self._free:
            return self._free.pop()
        # LRU idle-expired victim with nothing in flight
        victim = None
        for s in self._sessions.values():
            if s.inflight > 0 or now - s.last_seen < self.idle_ttl_s:
                continue
            if victim is None or s.last_seen < victim.last_seen:
                victim = s
        if victim is None:
            raise CapacityError(
                f"all {self.num_slots} session slots busy and none idle past "
                f"{self.idle_ttl_s}s"
            )
        del self._sessions[victim.session_id]
        self._c_evict.inc()
        self._g_active.set(len(self._sessions))
        return victim.slot

    def slot_of(self, session_id: str) -> Optional[int]:
        with self._lock:
            s = self._sessions.get(session_id)
            return None if s is None else s.slot

    def end(self, session_id: str) -> bool:
        """Explicitly release the session's slot (client said goodbye)."""
        with self._lock:
            s = self._sessions.pop(session_id, None)
            if s is None:
                return False
            self._free.append(s.slot)
            self._g_active.set(len(self._sessions))
            return True

    def stats(self) -> dict:
        with self._lock:
            return {
                "active": len(self._sessions),
                "free_slots": len(self._free),
                "num_slots": self.num_slots,
                "inflight": sum(s.inflight for s in self._sessions.values()),
            }
