"""The waiting-pods map — Permit's asynchronous half: a copy of the
reference package's scheduler/waitingpods.py, whole.

Reference: pkg/scheduler/framework/runtime/waiting_pods_map.go + the
Permit extension point (framework/interface.go:330-666): a Permit
plugin may return Wait with a timeout; the pod parks in the waiting map
while its binding goroutine blocks in WaitOnPermit
(schedule_one.go:278).  Any plugin may later Allow or Reject it; the
timeout rejects.  This is the extension point real coscheduling
plugins are built on (scheduler/coscheduling.py).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from ..api import types as api
from .queue import pod_key


class WaitingPod:
    """One pod parked at Permit (waitingPod, waiting_pods_map.go:52).

    Decisions LATCH: the first of allow/reject/timeout wins and later
    calls report whether they prevailed — the reference's
    compare-and-swap on the waiting pod's status.  try_claim/allow/
    release_claim give group releasers (coscheduling) a two-phase
    commit: claim every member atomically, then finalize — so a member
    timing out mid-release can never yield a partially-allowed gang."""

    def __init__(self, pod: api.Pod, node: str, timeout: float):
        self.pod = pod
        self.node = node
        self.deadline = time.monotonic() + timeout
        self._done = threading.Event()
        self._mu = threading.Lock()
        self._claimed = False           # guarded_by: _mu
        self._verdict: Optional[str] = None  # "allow" | reason  # guarded_by: _mu

    def try_claim(self) -> bool:
        """Atomically reserve the decision (phase 1 of a group release);
        False when already decided or claimed."""
        with self._mu:
            if self._verdict is not None or self._claimed:
                return False
            self._claimed = True
            return True

    def release_claim(self) -> None:
        """Abort phase 1 — the pod returns to plain waiting."""
        with self._mu:
            self._claimed = False

    def allow(self) -> bool:
        """Finalize allow; True iff the pod ends allowed."""
        with self._mu:
            if self._verdict is None:
                self._verdict = "allow"
                self._claimed = False
                self._done.set()
            return self._verdict == "allow"

    def reject(self, reason: str = "rejected") -> bool:
        """Latch a rejection; False when already decided or a group
        release holds the claim (the claimer's decision wins)."""
        with self._mu:
            if self._claimed:
                return False
            if self._verdict is None:
                self._verdict = reason
                self._done.set()
            return self._verdict == reason

    def _locked_verdict(self) -> Optional[str]:
        """The latched decision, read under the mutex: wait()'s readers
        run on the binding thread while allow/reject latch from plugin
        threads, so the read holds the lock."""
        with self._mu:
            return self._verdict

    def wait(self) -> str:
        """Block until Allow/Reject/timeout (WaitOnPermit); returns
        "allow" or the rejection reason ("timeout" when the permit
        window lapsed).  A timeout racing an in-flight group claim
        defers to the claimer's decision."""
        while True:
            remaining = self.deadline - time.monotonic()
            if self._done.wait(timeout=max(remaining, 0)):
                return self._locked_verdict() or "rejected"
            if self.reject("timeout"):
                return "timeout"
            # claimed: the group release is deciding — wait it out
            if self._done.wait(timeout=0.05):
                return self._locked_verdict() or "rejected"


class WaitingPodsMap:
    GUARDED_FIELDS = {"_pods": "_lock"}

    def __init__(self):
        self._lock = threading.Lock()
        self._pods: Dict[str, WaitingPod] = {}

    def add(self, wp: WaitingPod) -> None:
        with self._lock:
            self._pods[pod_key(wp.pod)] = wp

    def remove(self, pod: api.Pod) -> None:
        with self._lock:
            self._pods.pop(pod_key(pod), None)

    def get(self, pod: api.Pod) -> Optional[WaitingPod]:
        with self._lock:
            return self._pods.get(pod_key(pod))

    def iterate(self) -> List[WaitingPod]:
        """Snapshot of the currently-waiting pods (IterateOverWaitingPods
        — what coscheduling plugins walk to release a whole group)."""
        with self._lock:
            return list(self._pods.values())

    def allow(self, pod: api.Pod) -> bool:
        wp = self.get(pod)
        if wp is None:
            return False
        wp.allow()
        return True

    def reject(self, pod: api.Pod, reason: str = "rejected") -> bool:
        wp = self.get(pod)
        if wp is None:
            return False
        wp.reject(reason)
        return True
