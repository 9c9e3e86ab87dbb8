"""Lease-based leader election: a copy of
kubernetes_tpu/client/leaderelection.py over this package's Store and
Lease.  It runs on host objects only; `Scheduler(store,
leader_elector=...)` dispatches while `is_leader()` and fences its bind
waves with `fence_token()`.

Reference: client-go tools/leaderelection/leaderelection.go:181-245 —
tryAcquireOrRenew under optimistic concurrency against a Lease object;
the holder renews every RetryPeriod, standbys watch the renew time and
take over when LeaseDuration elapses without one.  Fail-over therefore
bounds at lease_duration + one retry period, and split-brain is
excluded by the store's Conflict-on-stale-rv semantics (the etcd
transaction's analogue).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

from ..api import store as st
from ..api import types as api
from ..testing import faults


class LeaderElector:
    def __init__(
        self,
        store: st.Store,
        lease_name: str,
        identity: str,
        namespace: str = "kube-system",
        lease_duration: float = 15.0,
        renew_period: float = 2.0,
        clock=time.monotonic,
        on_started_leading: Optional[Callable[[], None]] = None,
        on_stopped_leading: Optional[Callable[[], None]] = None,
    ):
        self.store = store
        self.lease_name = lease_name
        self.identity = identity
        self.namespace = namespace
        self.lease_duration = lease_duration
        self.renew_period = renew_period
        self._clock = clock
        self.on_started_leading = on_started_leading
        self.on_stopped_leading = on_stopped_leading
        self._leading = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # renew attempts that raised (store fault, injected failure) and
        # were treated as a failed renew rather than killing the loop
        self.renew_errors = 0
        # lease_transitions observed when THIS identity last acquired:
        # the write-fencing generation (Store.update_wave fence=...).
        # Written only by the elector thread; read cross-thread as one
        # atomic int (a stale read just means a fenced commit, which is
        # the safe direction).  -1 = never acquired.
        self._generation = -1

    # -- the tryAcquireOrRenew step ----------------------------------------

    def try_acquire_or_renew(self) -> bool:
        faults.fire("leader.renew", identity=self.identity)
        now = self._clock()
        try:
            lease = self.store.get("Lease", self.lease_name, self.namespace)
        except st.NotFound:
            lease = api.Lease(
                meta=api.ObjectMeta(
                    name=self.lease_name, namespace=self.namespace
                ),
                spec=api.LeaseSpec(
                    holder_identity=self.identity,
                    lease_duration_seconds=int(self.lease_duration),
                    acquire_time=now,
                    renew_time=now,
                ),
            )
            try:
                self.store.create(lease)
                self._generation = 0  # first acquisition of a new lease
                return True
            except st.AlreadyExists:
                return False  # raced; retry next period
        spec = lease.spec
        if (
            spec.holder_identity != self.identity
            and now < spec.renew_time + self.lease_duration
        ):
            return False  # someone else holds a live lease
        took_over = spec.holder_identity != self.identity
        spec.holder_identity = self.identity
        spec.renew_time = now
        if took_over:
            spec.acquire_time = now
            spec.lease_transitions += 1
        try:
            self.store.update(lease)
            self._generation = spec.lease_transitions
            return True
        except (st.Conflict, st.NotFound):
            return False  # raced with another candidate; retry

    def fence_token(self) -> Optional[st.FenceToken]:
        """The write-fencing proof for Store.update_wave: this
        identity's lease coordinates at its LAST acquisition.  Returned
        even after leadership is lost — a deposed leader's late wave
        must carry its stale token so the store can reject it (no token
        would mean no fencing at all).  None only before the first
        acquisition."""
        if self._generation < 0:
            return None
        return st.FenceToken(
            name=self.lease_name,
            namespace=self.namespace,
            identity=self.identity,
            generation=self._generation,
        )

    # -- run loop ----------------------------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                got = self.try_acquire_or_renew()
            except Exception:  # noqa: BLE001 — renew containment
                # an exception mid-renew (store fault, injected failure)
                # is a FAILED renew, not a dead elector: the holder must
                # step down exactly once (below) and keep retrying — a
                # dead loop with _leading still set would be split-brain
                got = False
                self.renew_errors += 1
                logging.getLogger(__name__).exception(
                    "leader renew failed for %s; treating as lost lease",
                    self.identity,
                )
            if got and not self._leading.is_set():
                self._leading.set()
                if self.on_started_leading:
                    self.on_started_leading()
            elif not got and self._leading.is_set():
                # failed to renew: step down (the reference cancels the
                # leading context)
                self._leading.clear()
                if self.on_stopped_leading:
                    self.on_stopped_leading()
            self._stop.wait(self.renew_period)
        if self._leading.is_set():
            self._leading.clear()
            if self.on_stopped_leading:
                self.on_stopped_leading()

    def start(self) -> "LeaderElector":
        self._thread = threading.Thread(
            target=self._run, name=f"leaderelection-{self.identity}", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, release: bool = True) -> None:
        """Stop; with release (the reference's ReleaseOnCancel), zero the
        renew time so standbys take over immediately."""
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        if release:
            try:
                lease = self.store.get("Lease", self.lease_name, self.namespace)
                if lease.spec.holder_identity == self.identity:
                    lease.spec.renew_time = 0.0
                    self.store.update(lease, force=True)
            except st.NotFound:
                pass

    def is_leader(self) -> bool:
        return self._leading.is_set()

    def wait_for_leadership(self, timeout: float = 30.0) -> bool:
        return self._leading.wait(timeout)
