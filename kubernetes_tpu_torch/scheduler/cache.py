"""Scheduler cache: assume/confirm/expire over the incremental tensor
state.

Reference: pkg/scheduler/internal/cache/cache.go:57-260.  The reference
cache keeps per-node NodeInfo structs plus an assumed-pods set with TTL;
ours keeps the same bookkeeping over ops.schema.ClusterState, whose rows
ARE the snapshot (no separate UpdateSnapshot walk — updating a row is
updating the snapshot, the end state the generation protocol exists to
approximate).

A copy of kubernetes_tpu/scheduler/cache.py, its obligation-ledger hooks
(analysis/ledger.py: acquire on assume, discharge on confirm or forget)
included.

Lifecycle (cache.go's state machine):

  assume(pod, node)    solver picked a node; resources land immediately
                       so the next batch sees them (AssumePod)
  finish_binding(pod)  bind API call returned; TTL countdown starts
                       (FinishBinding)
  confirm via add_pod  informer delivered the bound pod: assumed ->
                       confirmed (AddPod on an assumed pod)
  forget(pod)          bind failed; undo the assume (ForgetPod)
  cleanup_expired()    assumed-with-finished-binding pods whose TTL
                       passed are dropped — the informer never confirmed
                       them (cleanupAssumedPods, run periodically)
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from ..analysis import ledger as _ledger
from ..api import types as api
from ..ops import schema
from .queue import pod_key


@dataclass
class _Assumed:
    pod: api.Pod
    node: str
    binding_finished: bool = False
    deadline: Optional[float] = None


class SchedulerCache:
    # every access to these fields holds self._lock
    GUARDED_FIELDS = {
        "state": "_lock",
        "_assumed": "_lock",
        "_nominated": "_lock",
        "_waiting_on_node": "_lock",
    }
    # reviewed to run with the lock already held (callers acquire it)
    LOCKED_METHODS = frozenset({"_account"})

    def __init__(
        self,
        state: schema.ClusterState,
        ttl: float = 30.0,
        clock=time.monotonic,
    ):
        self.state = state
        self.ttl = ttl
        self._clock = clock
        self._lock = threading.RLock()
        self._assumed: Dict[str, _Assumed] = {}
        # Nominated pods (preemption winners waiting to land): their
        # requests overlay the nominated node's usage in OTHER pods'
        # snapshots, so nobody steals the space their victims freed — the
        # PodNominator / RunFilterPluginsWithNominatedPods analogue
        # (framework/interface.go:778, runtime/framework.go:962).
        self._nominated: Dict[str, tuple] = {}  # key -> (pod, node_name)
        # Pods delivered before their node (informers are per-kind threads
        # with no cross-kind ordering).  The reference cache tolerates this
        # by creating a stub NodeInfo (cache.go AddPod on unknown node);
        # we buffer and apply when the node arrives.
        self._waiting_on_node: Dict[str, Dict[str, api.Pod]] = {}

    @property
    def lock(self) -> threading.RLock:
        """The cache mutex.  The solve path holds it while encoding a
        snapshot from live state (the UpdateSnapshot-under-mutex property,
        cache.go:185) so informer threads can't mutate mid-encode."""
        return self._lock

    # -- nodes (informer-fed) ---------------------------------------------

    def add_node(self, node: api.Node) -> None:
        with self._lock:
            self.state.add_node(node)
            for pod in self._waiting_on_node.pop(node.meta.name, {}).values():
                if not self.state.has_pod(pod):
                    self.state.add_pod(pod)

    def update_node(self, node: api.Node) -> None:
        with self._lock:
            self.state.update_node(node)

    def remove_node(self, name: str) -> None:
        with self._lock:
            # drop assumed entries for pods that lived on the node
            for key, a in list(self._assumed.items()):
                if a.node == name:
                    self._assumed.pop(key)
                    _ledger.discharge("assume", key)
            self._waiting_on_node.pop(name, None)
            self.state.remove_node(name)

    # -- assume protocol ---------------------------------------------------

    def assume(self, pod: api.Pod, node: str) -> None:
        key = pod_key(pod)
        with self._lock:
            if key in self._assumed:
                raise ValueError(f"pod {key} already assumed")
            self.state.add_pod(pod, node)
            self._assumed[key] = _Assumed(pod=pod, node=node)
            _ledger.acquire("assume", key)
            # the pod landed — its nomination's reservation is spent
            self._nominated.pop(key, None)

    # -- nominations (PodNominator) ----------------------------------------

    def nominate(self, pod: api.Pod, node_name: str) -> None:
        with self._lock:
            self._nominated[pod_key(pod)] = (pod, node_name)

    def remove_nomination(self, pod: api.Pod) -> None:
        with self._lock:
            self._nominated.pop(pod_key(pod), None)

    def nominations_excluding(self, keys) -> List[tuple]:
        """(node_name, pod) reservations for nominated pods NOT in `keys`
        (a batch must not see its own members' reservations — a nominee
        schedules INTO its reserved space)."""
        with self._lock:
            return [
                (node, pod)
                for k, (pod, node) in self._nominated.items()
                if k not in keys
            ]

    def finish_binding(self, pod: api.Pod) -> None:
        with self._lock:
            a = self._assumed.get(pod_key(pod))
            if a is not None and not a.binding_finished:
                a.binding_finished = True
                a.deadline = self._clock() + self.ttl

    def finish_binding_all(self, pods: List[api.Pod]) -> None:
        """finish_binding for a whole bind wave under one lock
        acquisition + one clock read (the binding stage commits waves of
        hundreds of pods; per-pod lock churn is measurable there)."""
        with self._lock:
            deadline = self._clock() + self.ttl
            for pod in pods:
                a = self._assumed.get(pod_key(pod))
                if a is not None and not a.binding_finished:
                    a.binding_finished = True
                    a.deadline = deadline

    def forget(self, pod: api.Pod) -> bool:
        """Undo an assume (ForgetPod).  Returns True when an assumed
        entry was actually released — callers use this to fire the
        capacity-freed queue wake only when capacity really came back."""
        key = pod_key(pod)
        with self._lock:
            a = self._assumed.pop(key, None)
            if a is not None:
                _ledger.discharge("assume", key)
                self.state.remove_pod(a.pod)
                return True
            return False

    def is_assumed(self, pod: api.Pod) -> bool:
        with self._lock:
            return pod_key(pod) in self._assumed

    def assumed_nodes(self) -> Dict[str, str]:
        """Snapshot of the assume set: pod key -> assumed node (the
        leadership-reconciliation sweep walks this against the store)."""
        with self._lock:
            return {k: a.node for k, a in self._assumed.items()}

    def forget_key(self, key: str, node: Optional[str] = None) -> bool:
        """forget() by key — with `node`, only when the entry still
        points at that node (a confirm that raced the reconcile sweep
        must win).  Returns True when an entry was released."""
        with self._lock:
            a = self._assumed.get(key)
            if a is None or (node is not None and a.node != node):
                return False
            self._assumed.pop(key)
            _ledger.discharge("assume", key)
            self.state.remove_pod(a.pod)
            return True

    # -- bound pods (informer-fed) ----------------------------------------

    def _account(self, pod: api.Pod) -> None:
        """Add the pod to state, buffering when its node is unknown."""
        try:
            self.state.add_pod(pod)
        except KeyError:
            self._waiting_on_node.setdefault(pod.spec.node_name, {})[
                pod_key(pod)
            ] = pod

    def add_pod(self, pod: api.Pod) -> None:
        """Informer ADDED/MODIFIED with an assigned node.  Confirms an
        assumed pod (dropping its TTL) or accounts a newly seen one."""
        key = pod_key(pod)
        with self._lock:
            a = self._assumed.pop(key, None)
            if a is not None:
                _ledger.discharge("assume", key)
                if a.node == pod.spec.node_name:
                    return  # confirmed; resources already accounted
                # scheduled elsewhere than assumed: re-account
                self.state.remove_pod(a.pod)
            if not self.state.has_pod(pod):
                self._account(pod)

    def update_pod(self, old: api.Pod, new: api.Pod) -> None:
        """Bound-pod spec change (in-place resize, label edits): swap the
        accounted object so requested rows and constraint tables track the
        new spec (cache.go UpdatePod)."""
        key = pod_key(new)
        if old.spec == new.spec and old.meta.labels == new.meta.labels:
            # status-only update (phase/conditions churn): nothing the
            # accounting or constraint tables read changed — skip the
            # O(pods-on-node) re-account entirely
            return
        with self._lock:
            if self._assumed.get(key) is not None:
                # still assumed: add_pod's confirm path owns the transition
                self.add_pod(new)
                return
            for waiting in self._waiting_on_node.values():
                waiting.pop(key, None)
            if self.state.has_pod(old):
                self.state.remove_pod(old)
            if new.spec.node_name:
                self._account(new)

    def remove_pod(self, pod: api.Pod) -> None:
        key = pod_key(pod)
        with self._lock:
            if self._assumed.pop(key, None) is not None:
                _ledger.discharge("assume", key)
            for waiting in self._waiting_on_node.values():
                waiting.pop(key, None)
            if self.state.has_pod(pod):
                self.state.remove_pod(pod)

    # -- expiry ------------------------------------------------------------

    def cleanup_expired(self) -> List[api.Pod]:
        """Drop assumed pods whose binding finished but the informer never
        confirmed within TTL.  Returns the expired pods (callers requeue
        them)."""
        now = self._clock()
        expired: List[api.Pod] = []
        with self._lock:
            for key, a in list(self._assumed.items()):
                if a.binding_finished and a.deadline is not None and now > a.deadline:
                    self._assumed.pop(key)
                    _ledger.discharge("assume", key)
                    self.state.remove_pod(a.pod)
                    expired.append(a.pod)
        return expired

    def assumed_count(self) -> int:
        with self._lock:
            return len(self._assumed)
