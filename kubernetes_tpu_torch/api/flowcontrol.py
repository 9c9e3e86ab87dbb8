"""API Priority & Fairness, reduced to its load-bearing core.

Reference: staging/src/k8s.io/apiserver/pkg/util/flowcontrol
(apf_controller.go, apf_filter.go; wired into the handler chain at
server/config.go:990-996).  The reference implementation is a
config-driven controller reconciling FlowSchema/PriorityLevel objects
into fair-queuing dispatchers (1,128 LoC of shuffle-sharding).  What
that machinery BUYS an apiserver is: (1) requests are classified into
priority levels, (2) each level has its own concurrency seats and a
bounded FIFO queue, (3) when a level's queue is full new arrivals are
shed with 429 + Retry-After, so (4) a flood in one level cannot starve
another level's traffic.  This module provides exactly those four
properties with static levels — the config-object dance is not what
protects the store.

  exempt         healthz/readyz + system:masters      (never queued)
  system         system:* users/groups (schedulers, controllers, nodes)
  workload-high  authenticated non-system users
  catch-all      anonymous + everything else

Watches hold a seat for their (long) lifetime in the reference too;
here they are classified but acquire with a short timeout so a full
level sheds them quickly instead of hanging the handler thread.

Dispatch discipline (one gate-wide lock, not per-level ones):

  * FIFO within a level — a fresh arrival never takes a seat while the
    same level has queued waiters (no barging);
  * priority across levels — every freed seat re-runs a dispatch scan
    in level-declaration order (system first), so a higher-priority
    waiter claims capacity before any lower level's arrival;
  * borrow DOWNWARD only — a higher-priority level out of its own
    seats may execute on a lower level's idle effective capacity, but
    never the reverse: a catch-all flood can never consume system
    seats (the isolation property the flood tests pin).

On top of the static knobs sits :class:`AdaptiveAPF`: the scheduler's
OverloadController level and the store's watch/dispatch depth feed a
pressure ladder that shrinks every non-system level's effective seats
and queue limits under overload (halving per pressure step) and
restores the configured values with hysteresis — the serving-plane
mirror of the solve side's shed ladder.  Load-shed responses carry a
Retry-After that widens with pressure (``retry_after_s``).

A copy of the reference package's api/flowcontrol.py, whole; its
seats are tracked by this package's analysis/ledger.py and its
admission fires this package's `apf.admit` fault point.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from . import auth as authmod
from ..analysis import ledger as _ledger
from ..testing import faults


class _Ticket:
    """One queued request: granted under the gate lock by the dispatch
    scan, then observed by its waiting thread."""

    __slots__ = ("granted", "donor")

    def __init__(self):
        self.granted = False
        self.donor: Optional["PriorityLevel"] = None


class Seat:
    """A held admission: release() returns the capacity to whichever
    level lent it (the request's own level, or a lower-priority donor
    on the borrow-downward path)."""

    __slots__ = ("_gate", "level", "donor", "_released")

    def __init__(self, gate: "APFGate", level: "PriorityLevel",
                 donor: "PriorityLevel"):
        self._gate = gate
        self.level = level
        self.donor = donor
        self._released = False
        _ledger.acquire("seat", id(self))

    # compat: callers that logged the old PriorityLevel return value's
    # name keep working
    @property
    def name(self) -> str:
        return self.level.name

    def release(self) -> None:
        self._gate._release(self)


class PriorityLevel:
    """One level's seats + bounded FIFO waiting room (apf_filter.go's
    queueSet reduced to one queue per level).  All mutable state is
    guarded by the owning gate's ``_cond`` — the level itself holds no
    lock (single-lock dispatch is what makes cross-level fairness
    decidable atomically)."""

    def __init__(self, name: str, seats: int, queue_limit: int):
        self.name = name
        self.seats = seats                    # configured
        self.queue_limit = queue_limit        # configured
        self.seats_effective = seats          # adaptive (<= seats)
        self.queue_limit_effective = queue_limit
        self.rank = 0                         # 0 = highest priority
        self.in_flight = 0       # requests of THIS level executing
        self.seats_used = 0      # capacity charged here (own + lent)
        self.rejected_total = 0
        self.dispatched_total = 0
        self._waiters: deque = deque()

    @property
    def queued(self) -> int:
        return len(self._waiters)


@dataclass
class FlowSchema:
    """Classification rule: first match wins (FlowSchema precedence)."""

    name: str
    level: str
    users: Tuple[str, ...] = ()     # exact names; () = any
    groups: Tuple[str, ...] = ()    # any-of; () = any
    verbs: Tuple[str, ...] = ()     # () = any

    def matches(self, subject: authmod.Subject, verb: str) -> bool:
        if self.users and subject.name not in self.users:
            return False
        if self.groups and not set(self.groups) & set(subject.groups):
            return False
        if self.verbs and verb not in self.verbs:
            return False
        return True


DEFAULT_LEVELS = {
    # seats sized like the reference defaults' spirit: system traffic
    # gets guaranteed headroom, the catch-all gets a small slice.
    # Declaration order IS priority order (system highest).
    "system": (16, 128),
    "workload-high": (16, 128),
    "catch-all": (4, 16),
}

DEFAULT_SCHEMAS = [
    FlowSchema("system-leader-election", "system", groups=("system:masters",)),
    FlowSchema("system-components", "system",
               groups=("system:schedulers", "system:controllers",
                       "system:nodes")),
    FlowSchema("workload-high", "workload-high",
               groups=("system:authenticated",)),
    FlowSchema("catch-all", "catch-all"),
]

_LEVEL_KEYS = {"seats", "queueLimit"}


def levels_from_config(doc: dict) -> Dict[str, Tuple[int, int]]:
    """Per-level seat/queue knobs from a config mapping — the
    fleet-scale serving path's tuning surface (the seats were
    compile-time constants before; thousands of informers through one
    apiserver need per-deployment sizing).

    Shape: ``{level: {"seats": int, "queueLimit": int}}``.  Levels merge
    ONTO :data:`DEFAULT_LEVELS`, so a document tuning one level keeps
    the defaults for the rest; new level names are allowed (schemas must
    route to them explicitly).  Validated: unknown per-level keys are
    rejected, ``seats`` must be >= 1 (a 0-seat level deadlocks every
    request routed to it), ``queueLimit`` >= 0, and the ``catch-all``
    level cannot be removed (classification falls back to it)."""
    levels: Dict[str, Tuple[int, int]] = dict(DEFAULT_LEVELS)
    for name, spec in (doc or {}).items():
        if not isinstance(spec, dict):
            raise ValueError(
                f"apfLevels[{name!r}] must be a mapping with "
                f"{sorted(_LEVEL_KEYS)}"
            )
        unknown = set(spec) - _LEVEL_KEYS
        if unknown:
            raise ValueError(
                f"apfLevels[{name!r}]: unknown keys {sorted(unknown)} "
                f"(known: {sorted(_LEVEL_KEYS)})"
            )
        cur = levels.get(name, (0, 0))
        seats = int(spec.get("seats", cur[0]))
        qlen = int(spec.get("queueLimit", cur[1]))
        if seats < 1:
            raise ValueError(
                f"apfLevels[{name!r}]: seats must be >= 1 (a 0-seat "
                "level rejects every request routed to it)"
            )
        if qlen < 0:
            raise ValueError(f"apfLevels[{name!r}]: queueLimit must be >= 0")
        levels[name] = (seats, qlen)
    if "catch-all" not in levels:
        raise ValueError("apfLevels must keep the catch-all level")
    return levels


class APFGate:
    """The filter the server calls around every request
    (apf_filter.go Handle): classify -> acquire -> handle -> release.

    One lock for the whole gate: every grant decision (fresh arrival,
    freed seat, pressure change) runs the same priority-ordered FIFO
    dispatch scan, so fairness holds atomically across levels."""

    GUARDED_FIELDS = {
        "pressure": "_cond",
    }

    def __init__(
        self,
        levels: Optional[Dict[str, Tuple[int, int]]] = None,
        schemas: Optional[List[FlowSchema]] = None,
        queue_wait_s: float = 5.0,
    ):
        self._cond = threading.Condition()
        self.levels = {
            name: PriorityLevel(name, seats, qlen)
            for name, (seats, qlen) in (levels or DEFAULT_LEVELS).items()
        }
        for rank, lv in enumerate(self.levels.values()):
            lv.rank = rank
        self._by_rank = sorted(self.levels.values(), key=lambda l: l.rank)
        self.schemas = list(schemas or DEFAULT_SCHEMAS)
        self.queue_wait_s = queue_wait_s
        self.pressure = 0

    @classmethod
    def from_config(cls, source) -> "APFGate":
        """Build a gate from a config document: a dict, a YAML string,
        or a YAML file path.  Top-level keys: ``apfLevels`` (per-level
        seat/queue knobs, see :func:`levels_from_config`) and
        ``queueWaitSeconds``; unknown keys are rejected (the strict
        decoding posture the scheduler config takes)."""
        import os

        if isinstance(source, dict):
            doc = source
        else:
            import yaml

            text = source
            if isinstance(source, str) and os.path.exists(source):
                with open(source) as f:
                    text = f.read()
            doc = yaml.safe_load(text) or {}
        unknown = set(doc) - {"apfLevels", "queueWaitSeconds"}
        if unknown:
            raise ValueError(
                f"unknown APF configuration fields: {sorted(unknown)}"
            )
        return cls(
            levels=levels_from_config(doc.get("apfLevels")),
            queue_wait_s=float(doc.get("queueWaitSeconds", 5.0)),
        )

    def classify(self, subject: authmod.Subject, verb: str) -> PriorityLevel:
        for schema in self.schemas:
            if schema.matches(subject, verb) and schema.level in self.levels:
                return self.levels[schema.level]
        return self.levels["catch-all"]

    # -- dispatch core (all *_locked: caller holds self._cond) -----------

    def _find_capacity_locked(
        self, level: PriorityLevel
    ) -> Optional[PriorityLevel]:
        """The level that will lend a seat to `level`, or None.  Own
        effective capacity first; then borrow DOWNWARD from a
        lower-priority level with idle effective seats and no waiters
        of its own.  Never upward — lower levels cannot touch
        higher-priority capacity."""
        if level.seats_used < level.seats_effective:
            return level
        for donor in self._by_rank[level.rank + 1:]:
            if (
                donor.seats_used < donor.seats_effective
                and not donor._waiters
            ):
                return donor
        return None

    def _grant_locked(
        self, level: PriorityLevel, donor: PriorityLevel
    ) -> None:
        donor.seats_used += 1
        level.in_flight += 1
        level.dispatched_total += 1

    def _dispatch_locked(self) -> bool:
        """Serve queued waiters while capacity exists: levels in
        priority order, FIFO within each.  Returns True if anything was
        granted (caller must notify_all)."""
        granted = False
        for level in self._by_rank:
            while level._waiters:
                donor = self._find_capacity_locked(level)
                if donor is None:
                    break
                ticket = level._waiters.popleft()
                ticket.granted = True
                ticket.donor = donor
                self._grant_locked(level, donor)
                granted = True
        return granted

    # -- the request path -------------------------------------------------

    def acquire(
        self, subject: authmod.Subject, verb: str
    ) -> Optional[Seat]:
        """Seat for this request, or None → reply 429."""
        level = self.classify(subject, verb)
        faults.fire("apf.admit", level=level.name, verb=verb)
        with self._cond:
            # fresh arrivals never barge past their level's FIFO
            if not level._waiters:
                donor = self._find_capacity_locked(level)
                if donor is not None:
                    self._grant_locked(level, donor)
                    return Seat(self, level, donor)
            if len(level._waiters) >= level.queue_limit_effective:
                level.rejected_total += 1
                return None
            ticket = _Ticket()
            level._waiters.append(ticket)
            deadline = time.monotonic() + self.queue_wait_s
            while not ticket.granted:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            if ticket.granted:
                return Seat(self, level, ticket.donor)
            # timed out: a grant can no longer race in — we hold the lock
            try:
                level._waiters.remove(ticket)
            except ValueError:
                pass
            level.rejected_total += 1
            return None

    def _release(self, seat: Seat) -> None:
        with self._cond:
            if seat._released:
                return
            seat._released = True
            _ledger.discharge("seat", id(seat))
            seat.level.in_flight -= 1
            seat.donor.seats_used -= 1
            if self._dispatch_locked():
                self._cond.notify_all()

    # -- adaptive pressure -------------------------------------------------

    def set_pressure(self, pressure: int) -> None:
        """Apply an overload pressure step: every non-system level's
        effective seats and queue limit halve per step (floor 1 seat /
        0 queue); the system level keeps its full configured seats so
        control traffic (scheduler, kubelets, leader leases) always has
        headroom.  Recovery (pressure falling) restores the configured
        values and re-runs dispatch — capacity that reappears goes to
        the queue heads immediately."""
        pressure = max(0, int(pressure))
        with self._cond:
            if pressure == self.pressure:
                return
            self.pressure = pressure
            for lv in self._by_rank:
                if lv.name == "system" or pressure == 0:
                    lv.seats_effective = lv.seats
                    lv.queue_limit_effective = lv.queue_limit
                else:
                    lv.seats_effective = max(1, lv.seats >> pressure)
                    lv.queue_limit_effective = lv.queue_limit >> pressure
            if self._dispatch_locked():
                self._cond.notify_all()

    def retry_after_s(self) -> float:
        """The Retry-After a 429 should carry: widens with pressure so
        shed clients back off harder the deeper the overload."""
        with self._cond:
            return float(1 << self.pressure)

    def seats_current(self) -> int:
        """Effective seats across all levels (apf_seats_current)."""
        with self._cond:
            return sum(lv.seats_effective for lv in self._by_rank)

    def rejected_total(self) -> int:
        with self._cond:
            return sum(lv.rejected_total for lv in self._by_rank)

    def metrics(self) -> str:
        """Prometheus text exposition of per-level state (the reference's
        apiserver_flowcontrol_* series reduced)."""
        lines = [
            "# TYPE apiserver_flowcontrol_current_inqueue_requests gauge",
        ]
        for lv in self.levels.values():
            lines.append(
                "apiserver_flowcontrol_current_inqueue_requests"
                f'{{priority_level="{lv.name}"}} {lv.queued}'
            )
        lines.append(
            "# TYPE apiserver_flowcontrol_current_executing_requests gauge"
        )
        for lv in self.levels.values():
            lines.append(
                "apiserver_flowcontrol_current_executing_requests"
                f'{{priority_level="{lv.name}"}} {lv.in_flight}'
            )
        lines.append(
            "# TYPE apiserver_flowcontrol_current_limit_seats gauge"
        )
        for lv in self.levels.values():
            lines.append(
                "apiserver_flowcontrol_current_limit_seats"
                f'{{priority_level="{lv.name}"}} {lv.seats_effective}'
            )
        lines.append("# TYPE apiserver_flowcontrol_rejected_requests_total counter")
        for lv in self.levels.values():
            lines.append(
                "apiserver_flowcontrol_rejected_requests_total"
                f'{{priority_level="{lv.name}"}} {lv.rejected_total}'
            )
        lines.append("# TYPE apiserver_flowcontrol_dispatched_requests_total counter")
        for lv in self.levels.values():
            lines.append(
                "apiserver_flowcontrol_dispatched_requests_total"
                f'{{priority_level="{lv.name}"}} {lv.dispatched_total}'
            )
        return "\n".join(lines) + "\n"


class AdaptiveAPF:
    """The serving-plane shed ladder: overload observations in,
    pressure steps out (mirroring OverloadController's rise-fast /
    recover-slow shape).

    ``note()`` takes the scheduler's overload level (0/1/2) and the
    store's watch/dispatch backlog depths; the raw pressure is the max
    of the overload level and the depth ladder (>= threshold → 1,
    >= 4x threshold → 2).  Rising pressure applies IMMEDIATELY (shed
    now, ask questions later); falling pressure needs ``recover_after``
    consecutive lower observations and then steps down ONE level at a
    time — the hysteresis that keeps a flapping signal from thrashing
    the seat limits."""

    def __init__(
        self,
        gate: APFGate,
        depth_threshold: int = 256,
        recover_after: int = 3,
    ):
        self.gate = gate
        self.depth_threshold = depth_threshold
        self.recover_after = recover_after
        self._level = 0
        self._below = 0
        self._lock = threading.Lock()

    @property
    def level(self) -> int:
        return self._level

    def note(
        self,
        overload_level: int = 0,
        watch_depth: int = 0,
        dispatch_depth: int = 0,
    ) -> int:
        depth = max(int(watch_depth), int(dispatch_depth))
        from_depth = 0
        if depth >= self.depth_threshold:
            from_depth = 1
        if depth >= 4 * self.depth_threshold:
            from_depth = 2
        raw = max(int(overload_level), from_depth)
        with self._lock:
            if raw > self._level:
                self._level = raw
                self._below = 0
            elif raw < self._level:
                self._below += 1
                if self._below >= self.recover_after:
                    self._level -= 1
                    self._below = 0
            else:
                self._below = 0
            level = self._level
        self.gate.set_pressure(level)
        return level
