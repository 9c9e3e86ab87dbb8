"""The controller worker pattern: shared informers feed a rate-limited
workqueue; N worker threads pop keys and reconcile desired vs actual
through the store.

Reference: every controller in pkg/controller follows this shape —
registered at cmd/kube-controller-manager/app/controllermanager.go:515,
run as Run(workers) with queue.Get → syncHandler(key) → lister-read →
clientset writes → watch events re-enqueue (level-triggered).

A copy of the reference package's controllers/base.py, whole.
"""

from __future__ import annotations

import logging
import threading
from typing import List, Optional, Tuple

from ..api import store as st
from ..api import types as api
from ..client.informers import InformerFactory
from ..client.workqueue import WorkQueue

logger = logging.getLogger(__name__)


def obj_key(obj) -> str:
    return f"{obj.meta.namespace}/{obj.meta.name}"


def split_key(key: str) -> Tuple[str, str]:
    namespace, _, name = key.partition("/")
    return namespace, name


def controller_owner(obj) -> Optional[api.OwnerReference]:
    """The managing controller's OwnerReference, if any
    (metav1.GetControllerOf)."""
    for ref in obj.meta.owner_references:
        if ref.controller:
            return ref
    return None


class Expectations:
    """ControllerExpectations (pkg/controller/controller_utils.go): after
    a sync issues creates/deletes, the controller must not act on that
    key again until the informer has OBSERVED them — the informer cache
    lags the store, and recounting it early double-provisions (fresh
    names defeat AlreadyExists)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._adds: dict = {}
        self._dels: dict = {}

    def expect_creations(self, key: str, n: int) -> None:
        with self._lock:
            self._adds[key] = self._adds.get(key, 0) + n

    def expect_deletions(self, key: str, n: int) -> None:
        with self._lock:
            self._dels[key] = self._dels.get(key, 0) + n

    def creation_observed(self, key: str) -> None:
        with self._lock:
            if self._adds.get(key, 0) > 0:
                self._adds[key] -= 1

    def deletion_observed(self, key: str) -> None:
        with self._lock:
            if self._dels.get(key, 0) > 0:
                self._dels[key] -= 1

    def satisfied(self, key: str) -> bool:
        with self._lock:
            return self._adds.get(key, 0) <= 0 and self._dels.get(key, 0) <= 0

    def forget(self, key: str) -> None:
        with self._lock:
            self._adds.pop(key, None)
            self._dels.pop(key, None)


class Controller:
    """Base: owns a workqueue + workers; subclasses set KIND, wire
    informer handlers in `register()`, and implement `sync(key)`.

    sync() must be level-based and idempotent: it reads the CURRENT
    state and converges one step; errors requeue the key with
    rate-limited backoff (workqueue.add_rate_limited)."""

    KIND = ""

    def __init__(
        self,
        store: st.Store,
        informers: InformerFactory,
        workers: int = 2,
    ):
        self.store = store
        self.informers = informers
        self.queue = WorkQueue()
        self.expectations = Expectations()
        self.workers = workers
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()

    # -- wiring ------------------------------------------------------------

    def register(self) -> None:
        """Subclasses add informer handlers here (called by start)."""
        raise NotImplementedError

    def enqueue(self, obj) -> None:
        self.queue.add(obj_key(obj))

    def enqueue_owner(self, pod: api.Pod, kind: Optional[str] = None) -> None:
        """Route a dependent-object event to its controller's key
        (resolveControllerRef in every reference controller)."""
        ref = controller_owner(pod)
        if ref is not None and ref.kind == (kind or self.KIND):
            self.queue.add(f"{pod.meta.namespace}/{ref.name}")

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self.register()
        for i in range(self.workers):
            t = threading.Thread(
                target=self._worker,
                name=f"{self.KIND.lower()}-worker-{i}",
                daemon=True,
            )
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        self.queue.shutdown()
        for t in self._threads:
            t.join(timeout=5)

    def _worker(self) -> None:
        while not self._stop.is_set():
            key = self.queue.get(timeout=0.2)
            if key is None:
                continue
            try:
                self.sync(key)
            except st.Conflict:
                # optimistic-concurrency race: retry against fresh state
                self.queue.done(key)
                self.queue.add_rate_limited(key)
                continue
            except Exception:
                logger.exception("%s: sync(%s) failed", self.KIND, key)
                self.queue.done(key)
                self.queue.add_rate_limited(key)
                continue
            self.queue.done(key)
            self.queue.forget(key)

    # -- reconcile ---------------------------------------------------------

    def sync(self, key: str) -> None:
        raise NotImplementedError

    # -- shared helpers ----------------------------------------------------

    def pods_owned_by(
        self, namespace: str, owner_kind: str, owner_name: str
    ) -> List[api.Pod]:
        pods = self.informers.informer("Pod").list()
        out = []
        for p in pods:
            if p.meta.namespace != namespace:
                continue
            ref = controller_owner(p)
            if ref is not None and ref.kind == owner_kind and ref.name == owner_name:
                out.append(p)
        return out
