"""The 3-tier scheduling queue, adapted to batch draining: a copy of the
reference package's scheduler/queue.py, whole.

Reference: pkg/scheduler/internal/queue/scheduling_queue.go:90-206.
Tiers and transitions are preserved:

  activeQ        heap in queuesort order (priority desc, then arrival —
                 plugins/queuesort/priority_sort.go:52)
  backoffQ       heap by backoff expiry; exponential per-pod backoff
                 (DefaultPodInitialBackoff 1s .. DefaultPodMaxBackoff 10s,
                 apis/config/types.go:72-77)
  unschedulable  map of pods a cycle failed; they leave on cluster events
                 (move_all_to_active_or_backoff — the pre-QueueingHints
                 moveAllToActiveOrBackoffQueue behaviour) or after the
                 flush interval (flushUnschedulablePodsLeftover,
                 scheduling_queue.go DefaultPodMaxInUnschedulablePodsDuration)

The one batch-shaped change: the hot consumer is `pop_batch`, which drains
up to max_n pods in queuesort order for one batched device solve, instead
of the reference's one-pod Pop (schedule_one.go:66).  Gated pods
(non-empty spec.scheduling_gates) are held outside all three tiers until
their gates clear — the SchedulingGates PreEnqueue plugin
(plugins/schedulinggates/scheduling_gates.go:62).
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..analysis import ledger as _ledger
from ..api import types as api
from ..ops import assign as assign_ops

# Event → wake-set (QueueingHints-lite, internal/queue/events.go:25-89
# reduced to the solver's failure stages).  None = wake every reason.
# The payoff: pod churn (AssignedPodDelete at heartbeat rates) never
# wakes pods that failed on node affinity/taints — freeing resources
# cannot fix a static mismatch.
EVENT_WAKES = {
    "NodeAdd": None,
    "NodeUpdate": None,  # labels/taints/capacity can change any stage
    "NodeDelete": None,  # evicted pods re-enter; survivors re-place
    "AssignedPodDelete": {
        assign_ops.REASON_RESOURCES,
        assign_ops.REASON_PORTS,
        assign_ops.REASON_SPREAD,
        assign_ops.REASON_INTERPOD,
        assign_ops.REASON_GANG,
        # freed devices can open a contiguous carve-out
        assign_ops.REASON_SLICE,
    },
    # adding a pod can satisfy AFFINITY-direction inter-pod terms AND
    # raise a spread constraint's global minimum (a new match in the
    # min-count domain lifts every other domain's cap)
    "AssignedPodAdd": {assign_ops.REASON_INTERPOD, assign_ops.REASON_SPREAD},
    "AssignedPodUpdate": {assign_ops.REASON_INTERPOD, assign_ops.REASON_SPREAD},
}


def pod_key(pod: api.Pod) -> str:
    return f"{pod.meta.namespace}/{pod.meta.name}"


def gang_key(pod: api.Pod) -> Optional[str]:
    """The queue's gang identity: "namespace/group", or None for
    ungrouped pods.  Same-named groups in different namespaces are
    distinct gangs (the PodGroup is a namespaced object in the
    reference; CoschedulingPermit quorums are per namespace too)."""
    group = pod.spec.scheduling_group
    return f"{pod.meta.namespace}/{group}" if group else None


class AdaptiveBatchWindow:
    """Load-adaptive accumulation window for ``pop_batch``.

    Two observed signals drive it:

      * arrival rate ``r`` (pods/s) — EWMA over fixed sampling buckets,
        fed by ``SchedulingQueue.add`` on every new pending pod;
      * per-pod pipeline cost ``c`` (s/pod) — EWMAs of solve and commit
        cost per pod, fed by the scheduler's completed cycles/waves.

    Policy: the window plus the processing time of the batch it collects
    must fit the latency SLO — ``w + (r*w)*c <= slo`` gives
    ``w* = slo / (1 + r*c)``.  Sparse arrivals (fewer than ~2 expected
    during ``w*``) make waiting pointless, so the window floors to
    ``min_window``; sustained churn widens it (bigger batches amortize
    encode/solve/commit) up to ``max_window``.  Overload level >= 2 from
    the scheduler's OverloadController pins it at ``max_window``: the
    cheapest load to shed is per-cycle fixed overhead — fewer, fuller
    cycles.  With no signal yet the configured base window applies.
    """

    GUARDED_FIELDS = {
        "_rate": "_lock",
        "_solve_pp": "_lock",
        "_commit_pp": "_lock",
        "_bucket": "_lock",
        "_bucket_start": "_lock",
        "_overload": "_lock",
    }

    _SAMPLE_S = 0.25   # arrival-rate sampling bucket
    _ALPHA = 0.3       # EWMA weight for new samples

    def __init__(
        self,
        base_window: float = 0.05,
        min_window: float = 0.005,
        max_window: float = 0.25,
        slo_seconds: float = 0.5,
        clock=time.monotonic,
    ):
        self._clock = clock
        self.base = base_window
        self.min = min(min_window, max_window)
        self.max = max_window
        self.slo = slo_seconds
        self._lock = threading.Lock()
        self._rate = 0.0        # pods/s EWMA
        self._solve_pp = 0.0    # solve seconds per pod EWMA
        self._commit_pp = 0.0   # commit seconds per pod EWMA
        self._bucket = 0
        self._bucket_start = self._clock()
        self._overload = 0

    def _fold_locked(self) -> None:
        now = self._clock()
        periods = int((now - self._bucket_start) / self._SAMPLE_S)
        if periods <= 0:
            return
        sample = self._bucket / (periods * self._SAMPLE_S)
        for _ in range(min(periods, 50)):  # idle gaps decay toward 0
            self._rate += self._ALPHA * (sample - self._rate)
        self._bucket = 0
        self._bucket_start += periods * self._SAMPLE_S

    def note_arrival(self, n: int = 1) -> None:
        with self._lock:
            self._fold_locked()
            self._bucket += n

    def note_solve(self, pods: int, seconds: float) -> None:
        if pods <= 0:
            return
        with self._lock:
            self._solve_pp += self._ALPHA * (
                max(seconds, 0.0) / pods - self._solve_pp
            )

    def note_commit(self, pods: int, seconds: float) -> None:
        if pods <= 0:
            return
        with self._lock:
            self._commit_pp += self._ALPHA * (
                max(seconds, 0.0) / pods - self._commit_pp
            )

    def set_overload(self, level: int) -> None:
        with self._lock:
            self._overload = level

    def window(self) -> float:
        with self._lock:
            self._fold_locked()
            if self._overload >= 2:
                return self.max
            r = self._rate
            c = self._solve_pp + self._commit_pp
            if r <= 0.0 and c <= 0.0:
                # no signal yet: the configured base window applies
                return min(max(self.base, self.min), self.max)
            w_star = self.slo / (1.0 + r * c)
            if r * w_star < 2.0:
                # sparse arrivals: waiting would not grow the batch
                return self.min
            return min(max(w_star, self.min), self.max)


@dataclass
class QueuedPodInfo:
    """scheduling_queue.go QueuedPodInfo."""

    pod: api.Pod
    timestamp: float = 0.0            # arrival (queuesort tiebreak)
    attempts: int = 0
    initial_attempt_timestamp: float = 0.0
    unschedulable_since: float = 0.0
    gated: bool = False
    # assign.REASON_* from the failing solve; -1 = unknown (always woken)
    unschedulable_reason: int = -1
    # event clock at pop time (in-flight event tracking,
    # scheduling_queue.go inFlightPods/inFlightEvents): events arriving
    # while this pod is mid-cycle are replayed when it comes back
    popped_event_seq: int = 0


class SchedulingQueue:
    # guarded-by declarations: all three tiers plus the gang
    # and in-flight-event bookkeeping mutate under the queue condition
    # (producer handlers, pop_batch, and the wake paths race otherwise)
    GUARDED_FIELDS = {
        "_active": "_cond",
        "_class_rr": "_cond",
        "_rr_offset": "_cond",
        "_backoff": "_cond",
        "_unschedulable": "_cond",
        "_gated": "_cond",
        "_infos": "_cond",
        "_tier": "_cond",
        "_group_keys": "_cond",
        "_group_size": "_cond",
        "_gang_staged": "_cond",
        "_event_seq": "_cond",
        "_events_log": "_cond",
        "_closed": "_cond",
    }
    # helpers only reached from under `with self._cond:` (the *_locked
    # suffix convention covers the rest)
    LOCKED_METHODS = frozenset(
        {"_push_active", "_push_backoff", "_drop_group_member"}
    )

    def __init__(
        self,
        backoff_base: float = 1.0,
        backoff_max: float = 10.0,
        unschedulable_flush_after: float = 300.0,
        clock=time.monotonic,
        batch_window: float = 0.0,
        window_ctl: Optional[AdaptiveBatchWindow] = None,
    ):
        self._clock = clock
        self._base = backoff_base
        self._max_backoff = backoff_max
        self._flush_after = unschedulable_flush_after
        # bounded accumulation window (seconds): once pop_batch has at
        # least one pod but fewer than max_n, it keeps collecting new
        # arrivals for up to this long before returning, so churn-paced
        # arrivals form real batches instead of near-empty solves.  0
        # preserves the pop-immediately behaviour.  Bounded by the
        # attempt-latency budget: every pod in the batch pays the window
        # as queueing latency.
        self._batch_window = batch_window
        # optional AdaptiveBatchWindow: when present, pop_batch derives
        # its default window from observed arrival rate + cycle cost
        # instead of the fixed value, and add() feeds the rate estimate.
        # Read-only reference (the controller has its own lock).
        self._window_ctl = window_ctl
        self._cond = threading.Condition()
        self._seq = itertools.count()
        # The active tier is split into one queuesort heap PER PROFILE
        # CLASS (pod.spec.scheduler_name): pop_batch serves the classes
        # deficit-round-robin so one hot profile's arrival stream can
        # never starve another profile's lane, and a profile lane can
        # pop only its own class (`profiles=`).  A single-class queue
        # (the default profile) degenerates to exactly the old global
        # heap — pop order is bit-identical.
        self._active: Dict[str, List[tuple]] = {}  # class -> (-prio, ts, seq, key)
        self._class_rr: List[str] = []           # class round-robin order
        self._rr_offset = 0                      # rotation cursor
        self._backoff: List[tuple] = []          # (ready, seq, key)
        self._unschedulable: Dict[str, QueuedPodInfo] = {}
        self._gated: Dict[str, QueuedPodInfo] = {}
        self._infos: Dict[str, QueuedPodInfo] = {}   # all known pending pods
        self._tier: Dict[str, str] = {}          # key -> active|backoff|unsched|gated|gangstage|inflight
        # Gang bookkeeping (the coscheduling PodGroup PreEnqueue pattern):
        # _group_keys tracks every pending member per gang (for atomic
        # draining in pop_batch); _group_size is the gang's declared
        # member count (max over members — one member declaring it is
        # enough); _gang_staged holds members of gangs that have not yet
        # reached that size.  Gangs are keyed "namespace/group"
        # (_gang_of): same-named groups in different namespaces are
        # DISTINCT gangs — pooling them inflated whole-gang counts and,
        # worse, let one namespace's inflight member park another
        # namespace's half-gang in pop_batch's gang pull forever (the
        # per-namespace quorum the CoschedulingPermit r4 fix already
        # established; the store's per-shard fan-out surfaced the queue
        # half of the same bug by skewing cross-namespace pop timing).
        self._group_keys: Dict[str, set] = {}
        self._group_size: Dict[str, int] = {}
        self._gang_staged: Dict[str, QueuedPodInfo] = {}
        # In-flight event log (scheduling_queue.go inFlightEvents): each
        # cluster event gets a sequence number; a pod parked after its
        # cycle replays events that arrived since it was popped — without
        # this, an event landing DURING the cycle that just failed the
        # pod is lost and the pod parks forever (e.g. the PV that makes
        # it schedulable appearing while the solve runs).
        self._event_seq = 0
        self._events_log: deque = deque(maxlen=512)  # (seq, wake-set|None)
        self._closed = False

    # -- helpers -----------------------------------------------------------

    @staticmethod
    def _class_of(pod: api.Pod) -> str:
        return pod.spec.scheduler_name or ""

    def _push_active(self, info: QueuedPodInfo) -> None:
        key = pod_key(info.pod)
        cls = self._class_of(info.pod)
        heap = self._active.get(cls)
        if heap is None:
            heap = self._active[cls] = []
            self._class_rr.append(cls)
        heapq.heappush(
            heap,
            (-info.pod.spec.priority, info.timestamp, next(self._seq), key),
        )
        self._tier[key] = "active"
        self._cond.notify_all()

    def _backoff_duration(self, info: QueuedPodInfo) -> float:
        # calculateBackoffDuration: base * 2^(attempts-1), capped
        d = self._base * (2 ** max(info.attempts - 1, 0))
        return min(d, self._max_backoff)

    def _push_backoff(self, info: QueuedPodInfo) -> None:
        key = pod_key(info.pod)
        ready = self._clock() + self._backoff_duration(info)
        heapq.heappush(self._backoff, (ready, next(self._seq), key))
        self._tier[key] = "backoff"
        self._cond.notify_all()

    def _flush_due_locked(self) -> None:
        now = self._clock()
        while self._backoff and self._backoff[0][0] <= now:
            _, _, key = heapq.heappop(self._backoff)
            info = self._infos.get(key)
            if info is not None and self._tier.get(key) == "backoff":
                self._push_active(info)
        # unschedulable flush interval
        stale = [
            k for k, inf in self._unschedulable.items()
            if now - inf.unschedulable_since >= self._flush_after
        ]
        for k in stale:
            info = self._unschedulable.pop(k)
            self._push_backoff(info)

    # -- producer side (event handlers) -----------------------------------

    def add(self, pod: api.Pod) -> None:
        """A new pending pod (eventhandlers addPodToSchedulingQueue)."""
        with self._cond:
            if self._closed:
                return
            key = pod_key(pod)
            now = self._clock()
            info = self._infos.get(key)
            if info is None:
                info = QueuedPodInfo(
                    pod=pod, timestamp=now, initial_attempt_timestamp=now
                )
                self._infos[key] = info
                if self._window_ctl is not None:
                    # new pending pod: one arrival sample for the
                    # adaptive window's rate estimate
                    self._window_ctl.note_arrival()
            info.pod = pod
            if pod.spec.scheduling_gates:
                info.gated = True
                if self._tier.get(key) == "inflight":
                    # re-gated mid-cycle: parking IS the pod's
                    # disposition — the in-flight cycle's later
                    # requeue/park callbacks see the gate and no-op
                    _ledger.discharge("pod", key)
                self._gated[key] = info
                self._tier[key] = "gated"
                return
            info.gated = False
            if self._tier.get(key) in ("active", "backoff", "inflight"):
                return
            self._unschedulable.pop(key, None)
            self._gated.pop(key, None)
            self._admit_locked(info)

    def _admit_locked(self, info: QueuedPodInfo) -> None:
        """Admit an ungated pending pod: register gang membership, stage
        it if its gang is not whole yet (a partial gang must never reach
        a solve), otherwise push to active — releasing any members that
        were staged waiting for it.  Callers hold self._cond."""
        key = pod_key(info.pod)
        group = gang_key(info.pod)
        if group:
            self._group_keys.setdefault(group, set()).add(key)
            declared = info.pod.spec.scheduling_group_size
            if declared:
                self._group_size[group] = max(
                    declared, self._group_size.get(group, 0)
                )
            size = self._group_size.get(group, 0)
            if size and len(self._group_keys[group]) < size:
                self._gang_staged[key] = info
                self._tier[key] = "gangstage"
                return
            self._release_gang_locked(group)
        self._push_active(info)

    def _release_gang_locked(self, group: str) -> None:
        """Release every still-staged member of a gang that is now whole
        (no-op while it is short).  Runs from _admit_locked AND from
        update() — a pod can complete its gang by JOINING via update
        (or a same-group update can newly declare the size); without the
        update-side call the staged members stayed in 'gangstage'
        forever.  Callers hold self._cond."""
        size = self._group_size.get(group, 0)
        keys = self._group_keys.get(group, set())
        if size and len(keys) < size:
            return
        for k in [
            k for k in keys
            if self._tier.get(k) == "gangstage" and k in self._gang_staged
        ]:
            self._push_active(self._gang_staged.pop(k))

    def update(self, pod: api.Pod) -> None:
        """Spec/labels changed: gated pods re-check gates; unschedulable
        pods get another chance (updatePodInSchedulingQueue)."""
        with self._cond:
            key = pod_key(pod)
            info = self._infos.get(key)
            if info is None:
                self.add(pod)
                return
            old_group = gang_key(info.pod)
            new_group = gang_key(pod)
            info.pod = pod
            tier = self._tier.get(key)
            if old_group != new_group:
                # Group membership changed: retract the stale registration
                # (otherwise the old group's whole-gang count stays
                # inflated forever), register under the new group even for
                # pods already queued (pop_batch's gang pull reads
                # _group_keys — an unregistered grouped pod would strand),
                # and re-admit a staged pod under its new spec.
                if old_group and old_group in self._group_keys:
                    self._group_keys[old_group].discard(key)
                    if not self._group_keys[old_group]:
                        self._group_keys.pop(old_group)
                        self._group_size.pop(old_group, None)
                if tier == "gangstage":
                    self._gang_staged.pop(key, None)
                    self._admit_locked(info)
                    return
                if new_group:
                    self._group_keys.setdefault(new_group, set()).add(key)
                    declared = pod.spec.scheduling_group_size
                    if declared:
                        self._group_size[new_group] = max(
                            declared, self._group_size.get(new_group, 0)
                        )
                    # joining may have completed the gang — wake its
                    # staged members (they won't get another event)
                    self._release_gang_locked(new_group)
            elif new_group:
                # same group: a size declaration arriving via update must
                # take effect (first add may have omitted it).  A
                # newly-satisfied size releases the staged members; a
                # newly-SHORT gang re-stages queued members (mirroring
                # delete()) so a partial gang never reaches a solve.
                declared = pod.spec.scheduling_group_size
                if declared:
                    self._group_size[new_group] = max(
                        declared, self._group_size.get(new_group, 0)
                    )
                size = self._group_size.get(new_group, 0)
                if size and len(self._group_keys.get(new_group, ())) < size:
                    for k in list(self._group_keys.get(new_group, ())):
                        if self._tier.get(k) in ("active", "backoff"):
                            inf = self._infos[k]
                            self._gang_staged[k] = inf
                            self._tier[k] = "gangstage"
                else:
                    self._release_gang_locked(new_group)
            if tier == "gated" and not pod.spec.scheduling_gates:
                self._gated.pop(key, None)
                info.gated = False
                self._admit_locked(info)
            elif tier == "unsched":
                self._unschedulable.pop(key, None)
                self._admit_locked(info)

    def delete(self, pod: api.Pod) -> None:
        with self._cond:
            key = pod_key(pod)
            self._infos.pop(key, None)
            self._unschedulable.pop(key, None)
            self._gated.pop(key, None)
            self._gang_staged.pop(key, None)
            if self._tier.pop(key, None) == "inflight":
                _ledger.discharge("pod", key)
            self._drop_group_member(pod, key)
            # lazy heap deletion: stale keys skipped on pop
            group = gang_key(pod)
            if group and group in self._group_keys:
                size = self._group_size.get(group, 0)
                if size and len(self._group_keys[group]) < size:
                    # the gang dropped below its declared size: re-stage
                    # queued members so a partial gang never reaches a
                    # solve (inflight members are left alone — their
                    # batch is already committed)
                    for k in list(self._group_keys[group]):
                        if self._tier.get(k) in ("active", "backoff"):
                            inf = self._infos[k]
                            self._gang_staged[k] = inf
                            self._tier[k] = "gangstage"
            # a departing member can also unblock a skipped gang waiting
            # in pop_batch
            self._cond.notify_all()

    def _drop_group_member(self, pod: api.Pod, key: str) -> None:
        group = gang_key(pod)
        if group and group in self._group_keys:
            self._group_keys[group].discard(key)
            if not self._group_keys[group]:
                del self._group_keys[group]
                self._group_size.pop(group, None)

    # -- consumer side -----------------------------------------------------

    def pop_batch(
        self,
        max_n: int,
        timeout: Optional[float] = None,
        window: Optional[float] = None,
        profiles: Optional[set] = None,
    ) -> List[QueuedPodInfo]:
        """Drain up to max_n pods in queuesort order; blocks until at
        least one is available (or timeout).  Popped pods are 'inflight'
        until done()/requeue.

        Gang-atomic: popping any member of a scheduling group pulls every
        other pending member of that group into the same batch (batch may
        exceed max_n; members in backoff/unschedulable are pulled early —
        gang atomicity dominates their parking), so the joint solve always
        sees whole gangs and its all-or-nothing post-pass can hold.  A
        gang with a member the pop cannot pull (staged below its declared
        size, or inflight in another batch) is skipped whole and returned
        to active.

        `window` (default: the adaptive controller's current window when
        one is wired, else the queue's fixed batch_window) is the bounded
        accumulation window: with at least one pod in hand but fewer than
        max_n, the pop keeps collecting arrivals for up to `window`
        seconds before returning.  Never exceeds `timeout` — a timeout=0
        (non-blocking) pop stays non-blocking.

        `profiles` restricts the pop to those profile classes
        (pod.spec.scheduler_name) — a profile LANE pops only its own
        disjoint pod class.  None pops every class, serving classes
        deficit-round-robin: each rotation takes one pod (or one whole
        gang) per class, so a 10:1 arrival skew between two profiles
        still drains both — one hot class cannot starve another lane's
        pods out of the batch (queuesort order is preserved WITHIN each
        class; a single-class queue pops in exactly the old global
        order)."""
        deadline = None if timeout is None else self._clock() + timeout
        if window is None:
            if self._window_ctl is not None:
                window = self._window_ctl.window()
            else:
                window = self._batch_window
        if timeout is not None:
            window = min(window, timeout)
        pullable = ("active", "backoff", "unsched")
        with self._cond:
            batch: List[QueuedPodInfo] = []

            def take(key: str) -> Optional[QueuedPodInfo]:
                info = self._infos.get(key)
                if info is None or self._tier.get(key) not in pullable:
                    return None  # stale entry
                self._unschedulable.pop(key, None)
                # backoff/active heap entries are lazily skipped via
                # the tier check on their eventual pop
                self._tier[key] = "inflight"
                _ledger.acquire("pod", key)
                info.attempts += 1
                info.popped_event_seq = self._event_seq
                batch.append(info)
                return info

            def take_one(cls: str, skipped: Dict[str, QueuedPodInfo]) -> bool:
                """Take one pod (or one whole gang) from a class heap.
                Returns False when the class has nothing pullable."""
                heap = self._active.get(cls)
                while heap:
                    _, _, _, key = heapq.heappop(heap)
                    info = self._infos.get(key)
                    if (
                        info is None
                        or self._tier.get(key) != "active"
                        or key in skipped
                    ):
                        continue
                    group = gang_key(info.pod)
                    if not group:
                        take(key)
                        return True
                    # the popped key rides along even if registration was
                    # somehow missed — a popped-but-untaken pod would
                    # otherwise strand in tier 'active' with no heap entry
                    members = sorted(self._group_keys.get(group, ()) | {key})
                    if any(
                        self._tier.get(k) not in pullable for k in members
                    ):
                        skipped[key] = info
                        continue
                    for k in members:
                        take(k)
                    return True
                return False

            def collect() -> None:
                skipped: Dict[str, QueuedPodInfo] = {}
                classes = [
                    c for c in self._class_rr
                    if profiles is None or c in profiles
                ]
                n_cls = len(classes)
                if n_cls:
                    # deficit round-robin across profile classes: one
                    # pod (or gang) per class per rotation, starting at
                    # the rotating cursor so successive pops don't
                    # favor the same class's head-of-line
                    start = self._rr_offset % n_cls
                    exhausted: set = set()
                    while len(batch) < max_n and len(exhausted) < n_cls:
                        for j in range(n_cls):
                            cls = classes[(start + j) % n_cls]
                            if cls in exhausted:
                                continue
                            if not take_one(cls, skipped):
                                exhausted.add(cls)
                            if len(batch) >= max_n:
                                break
                    self._rr_offset += 1
                for info in skipped.values():
                    self._push_active(info)

            while True:
                self._flush_due_locked()
                collect()
                if batch:
                    break
                if self._closed:
                    return []
                wait = None
                if self._backoff:
                    wait = max(self._backoff[0][0] - self._clock(), 0.01)
                if deadline is not None:
                    remaining = deadline - self._clock()
                    if remaining <= 0:
                        return []
                    wait = min(wait, remaining) if wait else remaining
                self._cond.wait(wait)
            # bounded accumulation window: wait for more arrivals so
            # churn-paced creates form a real batch (the event-driven
            # batching the reference gets from its queue running ahead
            # of per-pod cycles, scheduling_queue.go:117)
            if window and window > 0 and len(batch) < max_n:
                wend = self._clock() + window
                if deadline is not None:
                    wend = min(wend, deadline)
                while len(batch) < max_n and not self._closed:
                    remaining = wend - self._clock()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
                    self._flush_due_locked()
                    collect()
            return batch

    def done(self, pod: api.Pod) -> None:
        """Pod scheduled (assumed+bound): drop from the pending set."""
        with self._cond:
            key = pod_key(pod)
            self._infos.pop(key, None)
            if self._tier.pop(key, None) == "inflight":
                _ledger.discharge("pod", key)
            self._drop_group_member(pod, key)
            # a departing member can unblock a skipped gang in pop_batch
            self._cond.notify_all()

    def add_unschedulable(
        self, info: QueuedPodInfo, reason: int = -1
    ) -> None:
        """A cycle failed to place the pod: park it until an event or the
        flush interval (AddUnschedulableIfNotPresent).  `reason` is the
        solver's failure stage — events wake only plausibly-affected
        pods (move_for_event)."""
        with self._cond:
            key = pod_key(info.pod)
            if key not in self._infos:
                return  # deleted meanwhile
            if self._tier.get(key) == "gated":
                # re-gated mid-cycle (an update added scheduling gates
                # while the pod was inflight): the gate parked it —
                # overriding to "unsched" would let move_for_event
                # requeue a gated pod into a solve
                return
            if self._tier.get(key) == "inflight":
                _ledger.discharge("pod", key)
            info.unschedulable_since = self._clock()
            info.unschedulable_reason = reason
            if self._missed_event_locked(info, reason):
                # an event that can fix this failure arrived while the
                # pod was mid-cycle — retry instead of parking
                self._push_backoff(info)
                return
            self._unschedulable[key] = info
            self._tier[key] = "unsched"

    def _missed_event_locked(self, info: QueuedPodInfo, reason: int) -> bool:
        """True when an event logged after this pod was popped would have
        woken it (the inFlightEvents replay)."""
        if reason == assign_ops.REASON_UNENCODABLE:
            return False
        since = info.popped_event_seq
        if self._events_log and self._events_log[0][0] > since + 1:
            # events between pop and the log's horizon were evicted —
            # be conservative (only happens past 512 events per cycle)
            return True
        for seq, wakes in self._events_log:
            if seq <= since:
                continue
            if wakes is None or reason < 0 or reason in wakes:
                return True
        return False

    def requeue_backoff(self, info: QueuedPodInfo) -> None:
        """Transient failure (e.g. bind error): retry after backoff."""
        with self._cond:
            key = pod_key(info.pod)
            if key not in self._infos:
                return
            if self._tier.get(key) == "gated":
                # re-gated mid-cycle: the gate parked it — pushing to
                # backoff would clobber the gate and pop a gated pod
                # into the next solve
                return
            if self._tier.get(key) == "inflight":
                _ledger.discharge("pod", key)
            self._push_backoff(info)

    def move_all_to_active_or_backoff(self, event: str = "") -> None:
        """A cluster event may have made unschedulable pods schedulable:
        move them to backoff (still inside their backoff window) or
        active (MoveAllToActiveOrBackoffQueue, scheduling_queue.go:117)."""
        self.move_for_event(None)

    def move_for_event(self, event: Optional[str]) -> int:
        """Event-scoped requeue: wake only pods whose recorded failure
        reason the event can plausibly fix (EVENT_WAKES; unknown events
        or reasons wake everything).  Returns the number woken — the
        churn benchmark asserts this stays bounded."""
        wakes = EVENT_WAKES.get(event) if event is not None else None
        moved = 0
        with self._cond:
            self._event_seq += 1
            self._events_log.append((self._event_seq, wakes))
            now = self._clock()
            for key, info in list(self._unschedulable.items()):
                reason = info.unschedulable_reason
                if reason == assign_ops.REASON_UNENCODABLE:
                    # no cluster event can fix a spec the encoder rejects;
                    # only update() (spec change) or the flush interval
                    # revives it — even all-reason events skip it
                    continue
                if wakes is not None and reason >= 0 and reason not in wakes:
                    continue
                self._unschedulable.pop(key)
                moved += 1
                if now < info.unschedulable_since + self._backoff_duration(info):
                    self._push_backoff(info)
                else:
                    self._push_active(info)
        return moved

    # -- introspection -----------------------------------------------------

    def stats(self) -> Dict[str, int]:
        with self._cond:
            active = sum(1 for t in self._tier.values() if t == "active")
            backoff = sum(1 for t in self._tier.values() if t == "backoff")
            return {
                "active": active,
                "backoff": backoff,
                "unschedulable": len(self._unschedulable),
                "gated": len(self._gated),
                "gang_staged": len(self._gang_staged),
                "inflight": sum(
                    1 for t in self._tier.values() if t == "inflight"
                ),
            }

    def pending_count(self) -> int:
        with self._cond:
            return len(self._infos)

    def contains(self, key: str) -> bool:
        """True when the pod is known to the queue in ANY tier (incl.
        gated/staged/inflight) — the leadership-reconciliation sweep
        uses this to find pods a crashed predecessor stranded."""
        with self._cond:
            return key in self._infos

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
