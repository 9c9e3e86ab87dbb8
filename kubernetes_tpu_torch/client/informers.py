"""Informer machinery: reflector + shared informer + listers (a copy of
kubernetes_tpu/client/informers.py).

The client-go cache stack (tools/cache) reduced to its load-bearing
parts:

  Reflector      list+watch against the Store, relisting on Expired /
                 stream termination (reflector.go:340 ListAndWatch, the
                 410-Gone relist path) with jittered exponential backoff
                 on consecutive expiries, through a shared RelistGate
                 bounding concurrent relists (storm containment)
  SharedInformer local thread-safe object cache + handler fan-out
                 (shared_informer.go:459 Run; handlers get add/update/
                 delete callbacks after an initial synthetic-ADDED sync,
                 DeltaFIFO's replace semantics)
  Lister         snapshot reads of the informer cache (listers)

Transport is the in-process api.store.Store — the deployment analogue of
client-go speaking to the apiserver's watch cache.  Delivery runs on one
informer thread per kind (client-go's single event goroutine per
informer); handlers must not block it.
"""

from __future__ import annotations

import logging
import random
import threading
from typing import Any, Callable, Dict, List, Optional

from ..api import store as st

logger = logging.getLogger(__name__)

Handler = Callable[[str, Any, Optional[Any]], None]
# Handler(event_type, obj, old_obj): old_obj set for MODIFIED only.


class RelistGate:
    """Shared relist limiter: when N informers expire together (a relist
    storm — the store expired their watches in one overload episode), a
    bounded semaphore caps how many hit `Store.list` concurrently; the
    rest queue on the gate instead of synchronously hammering the one
    snapshot path every consumer is already waiting on.  Combined with
    each reflector's jittered backoff, simultaneous expiries de-correlate
    instead of re-synchronizing on the next relist."""

    def __init__(self, max_concurrent: int = 2):
        self.max_concurrent = max_concurrent
        self._sem = threading.BoundedSemaphore(max_concurrent)

    def __enter__(self) -> "RelistGate":
        self._sem.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self._sem.release()


class SharedInformer:
    """One kind's local cache, kept in sync by a reflector thread."""

    # jittered exponential backoff on Expired (the 410/overflow path):
    # base doubles per consecutive expiry up to the cap; the actual wait
    # is uniform in [cap/2, cap] so simultaneous expiries spread
    _RELIST_BACKOFF_BASE = 0.05
    _RELIST_BACKOFF_MAX = 2.0

    def __init__(
        self,
        store: st.Store,
        kind: str,
        relist_gate: Optional[RelistGate] = None,
    ):
        self._store = store
        self.kind = kind
        self._lock = threading.RLock()
        self._cache: Dict[str, Any] = {}
        self._handlers: List[Handler] = []
        self._synced = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._watch: Optional[st.Watch] = None
        self._gate = relist_gate or RelistGate()
        self._expired_streak = 0  # consecutive Expired relists
        self._rng = random.Random()
        self.relists = 0          # observability (tests assert recovery)
        # rv of the most recent relist cut.  With the sharded store a
        # list() is a point-in-time-consistent cut across every shard
        # (taken under the publish lock: sub-waves are all-or-nothing in
        # it, and every item's rv is <= this value) — tests assert the
        # cut contract through this bookmark.
        self.last_relist_rv = 0

    # -- wiring ------------------------------------------------------------

    def add_handler(self, handler: Handler, replay: bool = True) -> None:
        """Register a handler; when replay (the shared-informer contract),
        it first receives synthetic ADDED events for the current cache."""
        with self._lock:
            if replay:
                for obj in self._cache.values():
                    try:
                        handler(st.ADDED, obj, None)
                    except Exception:
                        logger.exception(
                            "informer %s: handler %r failed on replay",
                            self.kind, handler,
                        )
            self._handlers.append(handler)

    def start(self) -> None:
        if self._thread:
            return
        self._thread = threading.Thread(
            target=self._run, name=f"informer-{self.kind}", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        w = self._watch
        if w:
            w.stop()
        if self._thread:
            self._thread.join(timeout=5)

    def wait_for_sync(self, timeout: Optional[float] = 10) -> bool:
        """WaitForCacheSync: true once the initial list landed."""
        return self._synced.wait(timeout)

    # -- reads (listers) ---------------------------------------------------

    def get(self, name: str, namespace: str = "default") -> Optional[Any]:
        with self._lock:
            return self._cache.get(self._key(namespace, name))

    def list(self) -> List[Any]:
        with self._lock:
            return list(self._cache.values())

    @staticmethod
    def _key(namespace: str, name: str) -> str:
        return f"{namespace}/{name}" if namespace else name

    def _obj_key(self, obj: Any) -> str:
        return self._key(obj.meta.namespace, obj.meta.name)

    # -- reflector loop ----------------------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                rv = self._relist()
                self._synced.set()
                self._expired_streak = 0  # a stream established == healthy
                self._stream(rv)
            except st.Expired:
                # the 410 path: watch(from_rv) too old, replay overflow,
                # or the store expired the stream (coalescing overflow).
                # Jittered exponential backoff so N informers expiring
                # together don't relist in lockstep (relist storm).
                self._stop.wait(self._expired_delay())
                continue
            except Exception:
                if self._stop.is_set():
                    return
                self._stop.wait(0.05)  # backoff then relist

    def _expired_delay(self) -> float:
        self._expired_streak = min(self._expired_streak + 1, 8)
        cap = min(
            self._RELIST_BACKOFF_BASE * (2 ** (self._expired_streak - 1)),
            self._RELIST_BACKOFF_MAX,
        )
        return self._rng.uniform(cap / 2, cap)

    def _relist(self) -> int:
        with self._gate:  # bounded concurrent relists (storm containment)
            items, rv = self._store.list(self.kind)
        self.relists += 1
        self.last_relist_rv = rv
        with self._lock:
            fresh = {self._obj_key(o): o for o in items}
            stale = set(self._cache) - set(fresh)
            for key in stale:
                old = self._cache.pop(key)
                self._emit(st.DELETED, old, None)
            for key, obj in fresh.items():
                old = self._cache.get(key)
                if old is not None and self._recreated(old, obj):
                    self._cache.pop(key)
                    self._emit(st.DELETED, old, None)
                    old = None
                self._cache[key] = obj
                if old is None:
                    self._emit(st.ADDED, obj, None)
                elif old.meta.resource_version != obj.meta.resource_version:
                    self._emit(st.MODIFIED, obj, old)
        return rv

    @staticmethod
    def _recreated(old, new) -> bool:
        """True when `new` is a DIFFERENT object under the same key — a
        delete + recreate the watch path compacted into one event (or a
        relist jumped over).  The split is re-synthesized as
        DELETED(old) + ADDED(new) so uid-sensitive consumers (the PV
        controller's claimRef.UID check, the scheduler cache's
        accounting) see the true transition."""
        old_uid = getattr(old.meta, "uid", "")
        new_uid = getattr(new.meta, "uid", "")
        return bool(old_uid) and bool(new_uid) and old_uid != new_uid

    def _stream(self, rv: int) -> None:
        self._watch = self._store.watch(self.kind, from_rv=rv)
        try:
            for ev in self._watch:
                if self._stop.is_set():
                    return
                with self._lock:
                    key = self._obj_key(ev.obj)
                    if ev.type == st.DELETED:
                        old = self._cache.pop(key, None)
                        self._emit(st.DELETED, ev.obj, old)
                    else:
                        old = self._cache.get(key)
                        if old is not None and self._recreated(old, ev.obj):
                            # delete + recreate compacted by the watch
                            # buffer: synthesize the split
                            self._cache.pop(key)
                            self._emit(st.DELETED, old, None)
                            old = None
                        self._cache[key] = ev.obj
                        self._emit(
                            st.ADDED if old is None else st.MODIFIED, ev.obj, old
                        )
        finally:
            self._watch = None
        # stream ended (consumer stop / store closed it): loop relists.
        # An EXPIRED stream raises st.Expired out of the iteration above
        # instead — _run's 410 handler adds the jittered backoff.

    def _emit(self, typ: str, obj: Any, old: Optional[Any]) -> None:
        # Handler faults must not kill the stream or starve later handlers
        # (client-go's processorListener delivery is panic-isolated per
        # listener); the local cache was already updated, so a dead stream
        # would never re-deliver this event after relist.
        for h in self._handlers:
            try:
                h(typ, obj, old)
            except Exception:
                logger.exception(
                    "informer %s: handler %r failed on %s", self.kind, h, typ
                )


class InformerFactory:
    """SharedInformerFactory: one informer per kind, shared by consumers."""

    def __init__(self, store: st.Store):
        self.store = store
        self._informers: Dict[str, SharedInformer] = {}
        self._lock = threading.Lock()
        # one gate for every informer this factory hands out: the
        # relist-storm bound is per CONSUMER PROCESS, not per kind
        self.relist_gate = RelistGate()

    def informer(self, kind: str) -> SharedInformer:
        with self._lock:
            inf = self._informers.get(kind)
            if inf is None:
                inf = SharedInformer(
                    self.store, kind, relist_gate=self.relist_gate
                )
                self._informers[kind] = inf
            return inf

    def start(self) -> None:
        with self._lock:
            for inf in self._informers.values():
                inf.start()

    def stop(self) -> None:
        with self._lock:
            for inf in self._informers.values():
                inf.stop()

    def wait_for_sync(self, timeout: Optional[float] = 10) -> bool:
        """WaitForCacheSync over STARTED informers — a registered but
        never-started informer cannot sync (tests start subsets; the
        reference's WaitForCacheSync likewise takes the informers the
        caller chose to run)."""
        with self._lock:
            infs = [i for i in self._informers.values() if i._thread]
        return all(inf.wait_for_sync(timeout) for inf in infs)
