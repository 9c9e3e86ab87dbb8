"""In-memory versioned object store with watch streams: the single-shard
part of the reference package's `Store` (kubernetes_tpu/api/store.py)
that the scheduler loop, its informers and its binders read and write.

Semantics kept from the reference:
  * every successful write bumps one global resourceVersion (etcd
    revision semantics: one counter across kinds);
  * optimistic concurrency: update with a stale resource_version fails
    with Conflict (GuaranteedUpdate's retry trigger);
  * create, get, update and delete deep-copy across the boundary, so a
    caller's object is never the stored one; `list` returns
    (items, rv), a point-in-time cut, so a watch can resume from that rv
    (reflector's ListAndWatch contract);
  * objects carrying finalizers get the two-phase delete
    (deletionTimestamp set, removal when the last finalizer goes);
  * watch(kind, from_rv) replays buffered events after from_rv, then
    streams; a from_rv older than the event ring raises Expired — the
    client relists (the 410 Gone path);
  * update_wave commits a wave of read-modify-write updates as ONE
    transaction (one lock acquisition, one fan-out hand-off), each object
    its own resourceVersion and its own event, failures split per object;
    a FenceToken makes the wave leadership-conditional (Fenced).

Threading: writes hold the store lock and append the committed events to
the dispatch backlog; one fan-out thread (started lazily, weakly
referenced so an abandoned store's thread exits) delivers them to
per-watcher bounded COALESCING buffers off the store lock, so a slow
consumer never stalls writers.  A watcher that falls behind has its
MODIFIED runs compacted latest-wins and its ADDED+DELETED pairs
annihilated; only when more distinct objects are pending than its
capacity is it marked Expired — bookmark rv + forced relist — never
silently terminated.  With one shard and one fan-out thread every
stream is totally ordered by resourceVersion.

Lock order: ``Store._lock`` -> ``Store._dispatch_cv`` / ``Watch._mu``.

Left out of the reference's store (this package has no use for them
yet): sharding (``shard_count`` is 1 and ``shard_index`` always 0, so
the scheduler's binder keeps the single-transaction commit), the
journal, its framing, snapshots and checkpoints, resharding and
recovery, admission, ``kinds`` and ``state_fingerprint``.
"""

from __future__ import annotations

import copy
import logging
import threading
import time
import weakref
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import (
    Any, Callable, Dict, Iterator, List, NamedTuple, Optional, Tuple,
)

from ..analysis import ledger as _ledger
from ..testing import faults
from . import types as api

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"


class NotFound(KeyError):
    pass


class AlreadyExists(ValueError):
    pass


class Conflict(ValueError):
    """Stale resourceVersion on update/delete."""


class Expired(ValueError):
    """Watch start revision fell out of the event buffer (410 Gone)."""


class Fenced(ValueError):
    """A fenced write's leadership lease is stale: the caller was
    deposed between staging the wave and committing it.  The etcd
    analogue is a txn whose lease-ownership compare fails — the late
    wave of a dead leader must never double-bind."""


class FenceToken(NamedTuple):
    """Leadership proof threaded into ``Store.update_wave``: the wave
    commits only while `identity` still holds the named Lease at the
    same acquisition `generation` (lease_transitions when the caller
    acquired).  The check runs under the store lock, atomically with the
    wave's commit."""

    name: str
    namespace: str
    identity: str
    generation: Optional[int] = None


@dataclass
class Event:
    type: str          # ADDED | MODIFIED | DELETED
    kind: str
    obj: Any           # committed object (immutable after publish)
    rv: int


def _key(namespace: str, name: str) -> str:
    return f"{namespace}/{name}" if namespace else name


# Watch._offer verdicts (read by the fan-out thread)
OFFER_OK = "ok"
OFFER_STOPPED = "stopped"
OFFER_EXPIRED = "expired"


class Watch:
    """One watch stream backed by a bounded per-watcher COALESCING
    buffer: iterate to receive events; stop() to cancel.

    Backpressure semantics (the survivable-overload contract):

      * events for DISTINCT objects queue in rv order;
      * a MODIFIED landing on a pending entry replaces it latest-wins
        (an un-consumed ADDED stays ADDED with the newest object — the
        consumer never saw the original);
      * a DELETED landing on a pending ADDED annihilates both (the
        consumer never learns the object existed);
      * a DELETED landing on a pending MODIFIED collapses to DELETED;
      * an ADDED landing on a pending DELETED (delete + recreate while
        the consumer lagged) collapses to MODIFIED with the new object —
        cache-diffing consumers (SharedInformer) synthesize the right
        local transition either way;
      * compaction always keeps the LATEST rv and re-sorts the entry to
        the back, so delivery stays strictly rv-monotonic.

    The dedup horizon (``_last_rv``) is the highest rv delivered into (or
    compacted through) this buffer: offers at or below it were already
    replayed at registration.

    Only when the number of distinct pending objects would exceed the
    capacity is the stream EXPIRED: pending events are dropped, the
    bookmark rv recorded, and iteration raises `Expired` so the consumer
    relists (the 410 path).  `stopped` is also set so poll-style
    consumers fall into their relist branch.  Consumer-initiated stop()
    ends iteration with StopIteration instead.
    """

    GUARDED_FIELDS = {
        "_pending": "_mu",
        "_last_rv": "_mu",
        "stopped": "_mu",
        "expired": "_mu",
        "expired_rv": "_mu",
        "coalesced": "_mu",
    }

    def __init__(self, store: "Store", capacity: int):
        self._store = store
        self._capacity = capacity
        self._mu = threading.Condition()
        # object key -> coalesced Event, insertion/compaction order ==
        # ascending rv (every insert/replace carries the current max rv
        # and moves to the back)
        self._pending: "OrderedDict[str, Event]" = OrderedDict()
        self._last_rv = 0
        self.stopped = False
        self.expired = False
        self.expired_rv = 0     # bookmark: last consistent rv at expiry
        self.coalesced = 0      # events compacted away in this buffer

    def stop(self) -> None:
        self._store._drop_watch(self)
        with self._mu:
            self.stopped = True
            self._mu.notify_all()

    def _pin_locked(self, rv: int) -> None:
        # registration pin (caller holds _mu): backlog stragglers at or
        # below the registration's commit were covered by the ring replay
        # (or predate a from-now watch)
        if rv > self._last_rv:
            self._last_rv = rv

    def _offer(self, ev: Event) -> str:
        # hot path (per event per watcher): the disarmed check is one
        # module-attribute load, not a function call
        if faults._registry is not None and faults.fire("watch.offer") == faults.DROP:
            # injected overload: as if coalescing itself overflowed —
            # the watcher expires and its consumer relists
            with self._mu:
                self._expire_locked()
            return OFFER_EXPIRED
        with self._mu:
            if self.expired:
                return OFFER_EXPIRED
            if self.stopped:
                return OFFER_STOPPED
            return self._offer_locked(ev)

    def _offer_locked(self, ev: Event) -> str:
        # caller holds _mu: one event through the coalescing rules
        if ev.rv <= self._last_rv:
            # already replayed at registration: exactly-once dedup
            return OFFER_OK
        key = _key(ev.obj.meta.namespace, ev.obj.meta.name)
        cur = self._pending.get(key)
        if cur is None:
            if len(self._pending) >= self._capacity:
                self._expire_locked()
                return OFFER_EXPIRED
            self._pending[key] = ev
        elif cur.type == ADDED and ev.type == DELETED:
            # annihilation: the consumer never saw the object
            del self._pending[key]
            self.coalesced += 2
        else:
            typ = ev.type
            if cur.type == ADDED and ev.type == MODIFIED:
                typ = ADDED          # still unseen: stays a create
            elif cur.type == DELETED and ev.type == ADDED:
                typ = MODIFIED       # delete+recreate: latest-wins
            self._pending[key] = Event(typ, ev.kind, ev.obj, ev.rv)
            self._pending.move_to_end(key)
            self.coalesced += 1
        self._last_rv = ev.rv
        self._mu.notify_all()
        return OFFER_OK

    def _offer_batch(self, events: List[Event]) -> str:
        """Deliver a committed chunk under ONE ``_mu`` acquisition — the
        fan-out thread's half of the watch path.  Per-event semantics
        (fault point, dedup, coalescing rules, capacity expiry) are
        those of ``_offer``; only the locking is chunked."""
        armed = faults._registry is not None
        with self._mu:
            for ev in events:
                if armed and faults.fire("watch.offer") == faults.DROP:
                    # injected overload: as if coalescing overflowed
                    self._expire_locked()
                    return OFFER_EXPIRED
                if self.expired:
                    return OFFER_EXPIRED
                if self.stopped:
                    return OFFER_STOPPED
                if self._offer_locked(ev) is OFFER_EXPIRED:
                    return OFFER_EXPIRED
            self._mu.notify_all()
            return OFFER_OK

    def _expire_locked(self) -> None:
        if self.expired:
            return
        self.expired = True
        self.stopped = True  # poll-style consumers relist off .stopped
        self.expired_rv = self._last_rv
        # pending events are dropped: the forced relist recovers them
        # (and everything after) from one consistent snapshot
        self._pending.clear()
        self._mu.notify_all()

    def __iter__(self) -> Iterator[Event]:
        return self

    def __next__(self) -> Event:
        if faults._registry is not None:
            faults.fire("watch.consume")  # injected slow consumer
        with self._mu:
            while True:
                if self._pending:
                    _, ev = self._pending.popitem(last=False)
                    return ev
                if self.expired:
                    raise Expired(
                        f"watch expired at rv {self.expired_rv}; relist"
                    )
                if self.stopped:
                    raise StopIteration
                # bounded wait: a missed notify can never park the
                # consumer forever
                self._mu.wait(0.5)

    def get(self, timeout: Optional[float] = None) -> Optional[Event]:
        """One event, or None on timeout / stream end (expiry included —
        check `.expired` / `.stopped` to distinguish and relist)."""
        if faults._registry is not None:
            faults.fire("watch.consume")  # injected slow consumer
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._mu:
            while True:
                if self._pending:
                    _, ev = self._pending.popitem(last=False)
                    return ev
                if self.stopped or self.expired:
                    return None
                if deadline is None:
                    self._mu.wait(0.5)
                    continue
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._mu.wait(remaining)


class Store:
    """The single-process control-plane store (one shard) — see the
    module docstring for the concurrency contract."""

    # graftlint guarded-by declarations: the objects, the rv counter, the
    # event ring, the watcher registry and its counters share the store
    # lock; the fan-out backlog has its own condition (publishers append
    # under _lock -> _dispatch_cv, the dispatcher pops under _dispatch_cv
    # alone — one lock-order direction, never a cycle)
    GUARDED_FIELDS = {
        "_objects": "_lock",
        "_versions": "_lock",
        "_rv": "_lock",
        "_buffer": "_lock",
        "_watchers": "_lock",
        "watchers_terminated": "_lock",
        "terminated_by_kind": "_lock",
        "watch_expired_total": "_lock",
        "_watch_coalesced_closed": "_lock",
        "fenced_writes_total": "_lock",
        "fanout_chunks": "_lock",
        "fanout_chunk_events": "_lock",
        "_dispatch_backlog": "_dispatch_cv",
        "_dispatch_inflight": "_dispatch_cv",
        "_dispatch_thread": "_dispatch_cv",
    }
    # caller-holds-the-store-lock (or, for _ensure_dispatcher_cv_held,
    # the dispatch condition) helpers
    LOCKED_METHODS = frozenset({
        "_ensure_dispatcher_cv_held",
        "_dispatch",
        "_dispatch_wave",
        "_queue_fanout_locked",
        "_check_fence_locked",
        "_publish_one_locked",
    })

    def __init__(
        self,
        buffer_size: int = 4096,
        # per-watcher queue matches the event buffer: a watcher that
        # can't hold buffer_size events couldn't relist-recover either,
        # and a 4k bind wave must not kill the scheduler's own informer
        watch_capacity: int = 4096,
    ):
        self._lock = threading.RLock()
        self._objects: Dict[str, Dict[str, Any]] = {}   # kind -> key -> obj
        self._versions: Dict[str, Dict[str, int]] = {}  # kind -> key -> rv
        self._rv = 0
        self._buffer: List[Event] = []      # ring of recent events
        self._buffer_size = buffer_size
        self._watch_capacity = watch_capacity
        self._watchers: Dict[str, List[Watch]] = {}     # kind -> watches
        # destructive slow-watcher kills — the backpressured fan-out
        # never performs them, so this stays 0
        self.watchers_terminated = 0
        self.terminated_by_kind: Dict[str, int] = {}    # bounded: one key/kind
        # overload-protection observability (mirrored into the scheduler
        # Registry as scheduler_watch_* each cycle):
        #   expired — watchers converted to bookmark+relist after their
        #       coalescing buffer overflowed (or a replay overflowed);
        #   coalesced (closed) — compacted-event counts folded in from
        #       watchers that have since expired or stopped (live
        #       watchers keep their own counters; watch_stats() sums).
        self.watch_expired_total = 0
        self._watch_coalesced_closed = 0
        # update_wave calls rejected because the caller's FenceToken no
        # longer matched the Lease (a deposed leader's late wave)
        self.fenced_writes_total = 0
        # batched fan-out accounting: chunks handed to watchers and the
        # events they carried (mean = fan-out chunk size — mirrored into
        # the Registry's scheduler_fanout_chunk_size)
        self.fanout_chunks = 0
        self.fanout_chunk_events = 0
        # fan-out backlog: publishers append committed event batches
        # under the store lock; the dispatch thread (started lazily with
        # the first delivery) delivers them to the coalescing buffers OFF
        # the store lock
        self._dispatch_cv = threading.Condition()
        self._dispatch_backlog: deque = deque()
        self._dispatch_inflight = False
        self._dispatch_thread: Optional[threading.Thread] = None

    # -- the one shard -----------------------------------------------------

    @property
    def shard_count(self) -> int:
        return 1

    def shard_index(self, kind: str, namespace: str = "default") -> int:
        """The shard owning (kind, namespace): always 0 here."""
        return 0

    # -- helpers -----------------------------------------------------------

    @staticmethod
    def _kind_of(obj: Any) -> str:
        kind = getattr(obj, "KIND", None)
        if not kind:
            raise TypeError(f"object {obj!r} has no KIND")
        return kind

    @staticmethod
    def _namespace(kind: str, namespace: str) -> str:
        # resource scope normalization: cluster-scoped objects live at
        # namespace "" regardless of what the caller set
        return "" if kind in api.CLUSTER_SCOPED_KINDS else namespace

    def _dispatch(self, ev: Event) -> None:
        # caller holds the store lock: ring append + backlog hand-off —
        # the fan-out itself runs on the dispatch thread off every lock
        self._buffer.append(ev)
        if len(self._buffer) > self._buffer_size:
            del self._buffer[: self._buffer_size // 4]
        self._queue_fanout_locked(ev.kind, [ev])

    def _dispatch_wave(self, kind: str, events: List[Event]) -> None:
        # caller holds the store lock; one ring extend + ONE backlog
        # hand-off for the whole wave (delivered as a batch)
        self._buffer.extend(events)
        excess = len(self._buffer) - self._buffer_size
        if excess > 0:
            del self._buffer[: excess + self._buffer_size // 4]
        self._queue_fanout_locked(kind, events)

    def _queue_fanout_locked(self, kind: str, events: List[Event]) -> None:
        # caller holds the store lock.  No watchers for the kind means no
        # delivery obligation: a watcher registered later replays from
        # the ring (watch(from_rv)) or starts from-now pinned to the
        # current rv, so skipping the backlog is exact.
        if not self._watchers.get(kind):
            return
        with self._dispatch_cv:
            self._ensure_dispatcher_cv_held()
            self._dispatch_backlog.append((kind, events))
            self._dispatch_cv.notify_all()

    def _ensure_dispatcher_cv_held(self) -> None:
        # caller holds the dispatch condition.  Lazy + self-healing: the
        # thread starts with the first delivery and is restarted here if
        # an injected crash killed it (every hand-off passes this check).
        t = self._dispatch_thread
        if t is not None and t.is_alive():
            return
        t = threading.Thread(
            target=_watch_dispatch_loop,
            args=(weakref.ref(self),),
            name="watch-dispatch",
            daemon=True,
        )
        self._dispatch_thread = t
        t.start()

    def _fan_out(self, kind: str, events: List[Event]) -> None:
        """Deliver one committed batch to every watcher of `kind` — the
        dispatch thread's half of the watch path, OFF the store lock; the
        chunk reaches each watcher through ONE ``Watch._mu``
        acquisition."""
        with self._lock:
            watchers = list(self._watchers.get(kind, ()))
            if watchers:
                self.fanout_chunks += 1
                self.fanout_chunk_events += len(events)
        expired: List[Watch] = []
        for w in watchers:
            try:
                if w._offer_batch(events) is OFFER_EXPIRED:
                    expired.append(w)
            except Exception:  # noqa: BLE001 — per-watcher containment
                # a poisoned offer (fault-schedule exception) costs only
                # THIS watcher, loudly: expire the stream so its consumer
                # relists, instead of starving the remaining watchers of
                # the rest of the batch with no 410 signal
                logging.getLogger(__name__).exception(
                    "watch offer failed; expiring the watcher"
                )
                with w._mu:
                    w._expire_locked()
                expired.append(w)
        for w in expired:
            self._retire_expired_watch(w, kind)

    def _retire_expired_watch(self, w: Watch, kind: str) -> None:
        with self._lock:
            ws = self._watchers.get(kind)
            if ws is not None and w in ws:
                ws.remove(w)
            self.watch_expired_total += 1
            with w._mu:  # _lock -> Watch._mu (same order as replay)
                self._watch_coalesced_closed += w.coalesced
                w.coalesced = 0

    def _publish_one_locked(
        self,
        op: str,
        kind: str,
        key: str,
        obj: Any,
        set_rv: bool = True,
        event_copy: bool = False,
    ) -> int:
        """The publish step (caller holds the store lock): allocate the
        rv, install/remove the object, append the event to the ring and
        the backlog.  The dispatched Event aliases the committed object
        by default: committed objects are never mutated in place (an
        update replaces the map entry).  `set_rv=False` leaves the
        object's meta untouched (delete() of a STORED object);
        `event_copy=True` deep-copies the event payload (paths that hand
        the same object back to the caller)."""
        self._rv += 1
        rv = self._rv
        if set_rv:
            obj.meta.resource_version = rv
        objs = self._objects.setdefault(kind, {})
        vers = self._versions.setdefault(kind, {})
        if op == DELETED:
            objs.pop(key, None)
            vers.pop(key, None)
        else:
            objs[key] = obj
            vers[key] = rv
        ev_obj = copy.deepcopy(obj) if event_copy else obj
        self._dispatch(Event(op, kind, ev_obj, rv))
        return rv

    # -- CRUD --------------------------------------------------------------

    def create(self, obj: Any) -> Any:
        kind = self._kind_of(obj)
        namespace = self._namespace(kind, obj.meta.namespace)
        key = _key(namespace, obj.meta.name)
        with self._lock:
            objs = self._objects.setdefault(kind, {})
            if key in objs:
                raise AlreadyExists(f"{kind} {key} exists")
            obj = copy.deepcopy(obj)
            obj.meta.namespace = namespace
            if not obj.meta.creation_timestamp:
                obj.meta.creation_timestamp = time.time()
            self._publish_one_locked(ADDED, kind, key, obj)
            return copy.deepcopy(obj)

    def get(self, kind: str, name: str, namespace: str = "default") -> Any:
        key = _key(self._namespace(kind, namespace), name)
        with self._lock:
            try:
                return copy.deepcopy(self._objects[kind][key])
            except KeyError:
                raise NotFound(f"{kind} {key}") from None

    def update(
        self, obj: Any, *, force: bool = False, copy_result: bool = True
    ) -> Any:
        """Optimistic-concurrency update: obj.meta.resource_version must
        match the stored version unless force (the GuaranteedUpdate retry
        loop's compare step).  copy_result=False skips the defensive
        deep copy of the return value for hot-path callers that discard
        it (the scheduler's binds, the event recorder) — the returned
        object is then the COMMITTED one and must not be mutated."""
        kind = self._kind_of(obj)
        namespace = self._namespace(kind, obj.meta.namespace)
        key = _key(namespace, obj.meta.name)
        with self._lock:
            objs = self._objects.get(kind, {})
            if key not in objs:
                raise NotFound(f"{kind} {key}")
            current_rv = self._versions[kind][key]
            if not force and obj.meta.resource_version != current_rv:
                raise Conflict(
                    f"{kind} {key}: rv {obj.meta.resource_version} != "
                    f"{current_rv}"
                )
            obj = copy.deepcopy(obj)
            obj.meta.namespace = namespace
            if (
                obj.meta.deletion_timestamp is not None
                and not obj.meta.finalizers
            ):
                # last finalizer dropped on a deleting object: the
                # update completes the two-phase delete (store.go:1176)
                self._publish_one_locked(
                    DELETED, kind, key, obj,
                    event_copy=True,  # obj is handed back below
                )
                return obj
            self._publish_one_locked(MODIFIED, kind, key, obj)
            return copy.deepcopy(obj) if copy_result else obj

    def update_wave(
        self,
        kind: str,
        updates: List[Tuple[str, str, Callable[[Any], None]]],
        *,
        fence: Optional[FenceToken] = None,
        shard_hint: Optional[int] = None,
    ) -> Tuple[List[str], Dict[str, Exception]]:
        """Commit a wave of read-modify-write updates as ONE transaction.

        `updates` is a list of (name, namespace, mutate) where mutate(obj)
        edits a private copy of the stored object in place.  The wave
        runs under one store-lock acquisition with ONE watch fan-out
        hand-off — the scheduler's bind wave pays per-pod costs only for
        the copy and the mutation.

        Failure splits per object, never per wave: a missing object or a
        mutate() exception lands in the returned error map under its
        "namespace/name" key and the rest of the wave commits.  Returns
        (applied_keys, errors).

        Each committed object still gets its own resourceVersion and its
        own watch Event, so watch/informer semantics are those of
        per-object update(); only the write-path overhead is shared.

        `fence` (a FenceToken) makes the wave LEADERSHIP-CONDITIONAL:
        under the store lock, the named Lease must still be held by the
        token's identity at the token's acquisition generation, or the
        wave is rejected whole with `Fenced` (counted in
        `fenced_writes_total`) — a deposed leader's late bind wave can
        never double-bind behind its successor's back.

        `shard_hint` is accepted for the reference's signature; with one
        shard every wave is one transaction."""
        faults.fire("store.update_wave", kind=kind, updates=len(updates))
        applied: List[str] = []
        errors: Dict[str, Exception] = {}
        with self._lock:
            if fence is not None:
                # an already-stale wave commits NOTHING
                self._check_fence_locked(fence)
            objs = self._objects.get(kind, {})
            prepared: List[Tuple[str, Any]] = []   # (key, mutated copy)
            for name, namespace, mutate in updates:
                key = _key(self._namespace(kind, namespace), name)
                cur = objs.get(key)
                if cur is None:
                    errors[key] = NotFound(f"{kind} {key}")
                    continue
                obj = copy.deepcopy(cur)
                try:
                    mutate(obj)
                except Exception as e:  # noqa: BLE001 — per-object split
                    errors[key] = e
                    continue
                prepared.append((key, obj))
            if not prepared:
                return applied, errors
            events: List[Event] = []
            vers = self._versions.setdefault(kind, {})
            for key, obj in prepared:
                self._rv += 1
                rv = self._rv
                obj.meta.resource_version = rv
                if (
                    obj.meta.deletion_timestamp is not None
                    and not obj.meta.finalizers
                ):
                    # mirror update(): dropping the last finalizer on a
                    # deleting object completes the two-phase delete
                    objs.pop(key, None)
                    vers.pop(key, None)
                    events.append(Event(DELETED, kind, obj, rv))
                else:
                    objs[key] = obj
                    vers[key] = rv
                    events.append(Event(MODIFIED, kind, obj, rv))
                applied.append(key)
            self._dispatch_wave(kind, events)
        return applied, errors

    def _check_fence_locked(self, fence: FenceToken) -> None:
        # caller holds the store lock — the Lease cannot change while the
        # wave publishes, so the compare-and-commit is atomic
        lease = self._objects.get("Lease", {}).get(
            _key(fence.namespace, fence.name)
        )
        spec = getattr(lease, "spec", None)
        if (
            spec is None
            or spec.holder_identity != fence.identity
            or (
                fence.generation is not None
                and spec.lease_transitions != fence.generation
            )
        ):
            self.fenced_writes_total += 1
            holder = getattr(spec, "holder_identity", None)
            raise Fenced(
                f"wave fenced: lease {fence.namespace}/"
                f"{fence.name} held by {holder!r}, caller "
                f"{fence.identity!r} gen {fence.generation}"
            )

    def delete(self, kind: str, name: str, namespace: str = "default") -> Any:
        """Remove an object.  Objects carrying finalizers get the
        reference's two-phase deletion (registry/generic/registry/
        store.go:1116): deletionTimestamp is set and a MODIFIED event
        fires; the real removal happens when the last finalizer is
        dropped via update()."""
        key = _key(self._namespace(kind, namespace), name)
        with self._lock:
            objs = self._objects.get(kind, {})
            if key not in objs:
                raise NotFound(f"{kind} {key}")
            obj = objs[key]
            if obj.meta.finalizers and obj.meta.deletion_timestamp is not None:
                # already terminating: delete-on-deleting is a no-op
                return copy.deepcopy(obj)
            if obj.meta.finalizers and obj.meta.deletion_timestamp is None:
                obj = copy.deepcopy(obj)
                obj.meta.deletion_timestamp = time.time()
                self._publish_one_locked(MODIFIED, kind, key, obj)
                return copy.deepcopy(obj)
            # the STORED object: its meta stays at its committed rv
            # (set_rv=False) and the event payload is a copy — the raw
            # object is returned to the caller below
            self._publish_one_locked(
                DELETED, kind, key, obj, set_rv=False, event_copy=True,
            )
            return obj

    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        selector: Optional[Callable[[Any], bool]] = None,
    ) -> Tuple[List[Any], int]:
        """(items, resource_version) — the ListAndWatch hand-off point:
        deep copies of every object of `kind` (in `namespace`, passing
        `selector`), in creation order.  The object references and the rv
        are captured under the store lock (a wave is all-or-nothing in
        the cut); the copies happen outside it — committed objects are
        immutable, an update replaces the map entry."""
        if faults._registry is not None:
            # relist-storm chaos: injected list latency models a control
            # plane whose snapshot path is the contended resource
            faults.fire("store.list", kind=kind)
        with self._lock:
            refs = list(self._objects.get(kind, {}).values())
            rv = self._rv
        items = [
            copy.deepcopy(o)
            for o in refs
            if (namespace is None or o.meta.namespace == namespace)
            and (selector is None or selector(o))
        ]
        return items, rv

    # -- watch -------------------------------------------------------------

    def watch(self, kind: str, from_rv: Optional[int] = None) -> Watch:
        """Stream events for `kind` after `from_rv` (exclusive).  None
        means 'from now'.  Raises Expired when from_rv predates the event
        ring — relist and retry (reflector.go 410 handling)."""
        with self._lock:
            w = Watch(self, self._watch_capacity)
            if from_rv is not None:
                oldest_known = self._buffer[0].rv if self._buffer else self._rv + 1
                if from_rv + 1 < oldest_known and from_rv < self._rv:
                    raise Expired(
                        f"rv {from_rv} too old (buffer starts at {oldest_known})"
                    )
                for ev in self._buffer:
                    if ev.kind == kind and ev.rv > from_rv:
                        if w._offer(ev) is not OFFER_OK:
                            # the replay itself overflowed the coalescing
                            # buffer (or was fault-dropped): this stream
                            # would be lossy FROM BIRTH — refuse it; the
                            # client relists (410 path)
                            self.watch_expired_total += 1
                            raise Expired(
                                f"rv {from_rv} replay overflowed the "
                                "watch buffer; relist"
                            )
            with w._mu:
                # pin the dedup horizon to the commit the registration is
                # consistent with: backlog stragglers at or below it were
                # covered by the replay (or predate a from-now watch)
                w._pin_locked(self._rv)
            self._watchers.setdefault(kind, []).append(w)
            return w

    def _drop_watch(self, w: Watch) -> None:
        with self._lock:
            for ws in self._watchers.values():
                if w in ws:
                    ws.remove(w)
                    break
            with w._mu:
                self._watch_coalesced_closed += w.coalesced
                w.coalesced = 0

    def dispatch_depth(self) -> int:
        """Committed-but-undelivered watch events queued at the fan-out
        thread — the store-side overload signal (a deep backlog means
        watchers cannot keep up with the commit rate)."""
        with self._dispatch_cv:
            return sum(len(evs) for _, evs in self._dispatch_backlog)

    def watch_stats(self) -> Dict[str, int]:
        """Fan-out observability snapshot: deepest per-watcher pending
        backlog, fan-out dispatch backlog, total compacted events,
        expiries, and (legacy) destructive terminations — mirrored into
        the scheduler Registry as scheduler_watch_* gauges every
        cycle."""
        dispatch_depth = self.dispatch_depth()
        with self._lock:
            depth = 0
            coalesced = self._watch_coalesced_closed
            for ws in self._watchers.values():
                for w in ws:
                    with w._mu:
                        depth = max(depth, len(w._pending))
                        coalesced += w.coalesced
            return {
                "watch_queue_depth": depth,
                "watch_dispatch_depth": dispatch_depth,
                "watch_coalesced_total": coalesced,
                "watch_expired_total": self.watch_expired_total,
                "watchers_terminated": self.watchers_terminated,
            }

    # -- lifecycle ---------------------------------------------------------

    def close(self, timeout: float = 5.0) -> None:
        """Graceful shutdown: drain the watch-dispatch backlog (pending
        committed batches reach their watchers) before returning.  The
        fan-out thread holds the store only weakly and exits once the
        store is dropped.  Reads keep working (tests inspect closed
        stores)."""
        deadline = time.monotonic() + timeout
        with self._dispatch_cv:
            while (
                (self._dispatch_backlog or self._dispatch_inflight)
                and time.monotonic() < deadline
            ):
                self._dispatch_cv.wait(0.05)

    # -- convenience -------------------------------------------------------

    @property
    def resource_version(self) -> int:
        with self._lock:
            return self._rv


def _watch_dispatch_loop(store_ref: "weakref.ref[Store]") -> None:
    """The fan-out worker: drains the dispatch backlog and delivers each
    committed batch to its watchers off the store lock.

    Holds the store only through a weakref between iterations, so an
    abandoned store's dispatcher exits instead of leaking a polling
    thread per Store.  Fault-schedule exceptions escaping a delivery are
    contained (and the hand-off path restarts the thread if something
    interpreter-grade kills it)."""
    while True:
        store = store_ref()
        if store is None:
            return
        batch = None
        # deadline-bounded predicate loop: doze until a batch arrives,
        # re-checking the backlog under the SAME acquisition after every
        # wakeup, but fall out after ~0.2 s so the strong store ref drops
        # and an abandoned store can be collected
        doze = time.monotonic() + 0.2
        with store._dispatch_cv:
            while not store._dispatch_backlog:
                remaining = doze - time.monotonic()
                if remaining <= 0:
                    break
                store._dispatch_cv.wait(remaining)
            if store._dispatch_backlog:
                batch = store._dispatch_backlog.popleft()
                # close() waits for backlog-empty AND not-inflight, so a
                # batch mid-fan-out still blocks a graceful shutdown
                store._dispatch_inflight = True  # graftlint: disable=obligations -- armed only when a batch popped; the fan-out finally below clears it under the same cv
                _ledger.push("dispatch_inflight", id(store))
        if batch is not None:
            try:
                store._fan_out(*batch)
            except Exception:  # noqa: BLE001 — delivery containment
                logging.getLogger(__name__).exception(
                    "watch fan-out batch failed; continuing"
                )
            finally:
                with store._dispatch_cv:
                    store._dispatch_inflight = False
                    _ledger.pop("dispatch_inflight", id(store))
                    store._dispatch_cv.notify_all()
        # drop the strong references before sleeping so GC can collect
        # an otherwise-abandoned store
        store = None
        batch = None
