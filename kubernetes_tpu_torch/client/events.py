"""EventRecorder: the record/events broadcaster reduced to store writes
with client-go-style aggregation (a copy of kubernetes_tpu/client/events.py).

Reference: client-go tools/record (EventBroadcaster/EventRecorder) and
the scheduler's call sites (fwk.EventRecorder().Eventf,
schedule_one.go:1003,1094).  Repeats of the same (object, reason,
message) bump `count` on one Event object instead of flooding the store
— the events correlator's aggregation behaviour.

Two modes:
  sync (default)  — eventf writes through immediately (tests, CLI).
  async           — eventf enqueues and a broadcaster thread drains on
                    a short interval, coalescing repeats in-queue
                    before they ever hit the store.  This is the
                    reference's actual shape (the broadcaster's
                    buffered channel; record.go NewBroadcaster): a bind
                    wave of 4k pods must not pay 4k synchronous store
                    writes on the scheduling thread.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..api import store as st
from ..api import types as api

_QUEUE_CAP = 8192  # broadcaster channel capacity; overflow drops (record.go)


class EventRecorder:
    def __init__(
        self,
        store: st.Store,
        component: str = "default-scheduler",
        ttl: float = 3600.0,
        clock=time.time,
        async_mode: bool = False,
        flush_interval: float = 0.05,
    ):
        self.store = store
        self.component = component
        # the reference apiserver bounds Events with a TTL (default 1h,
        # --event-ttl); without expiry a long-running scheduler grows the
        # store (and journal compactions) without bound
        self.ttl = ttl
        self._clock = clock
        self._writes = 0
        self._async = async_mode
        self._flush_interval = flush_interval
        self._queue: List[Tuple[Any, str, str, str, float]] = []
        self._qlock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if async_mode:
            self._thread = threading.Thread(
                target=self._broadcaster, name="event-broadcaster", daemon=True
            )
            self._thread.start()

    def eventf(
        self, obj: Any, event_type: str, reason: str, message: str
    ) -> None:
        """Record one event for obj; never raises into the caller (events
        are best-effort observability, not control flow)."""
        if self._async:
            with self._qlock:
                if len(self._queue) < _QUEUE_CAP:
                    self._queue.append(
                        (obj, event_type, reason, message, self._clock())
                    )
            return
        try:
            self._record(obj, event_type, reason, message, self._clock())
        except Exception:
            pass

    # -- async broadcaster --------------------------------------------------

    def _broadcaster(self) -> None:
        while not self._stop.wait(self._flush_interval):
            self.flush()
        self.flush()

    def flush(self) -> None:
        """Drain the queue, coalescing repeats of (object, reason,
        message) into one store write with the summed count."""
        with self._qlock:
            batch, self._queue = self._queue, []
        if not batch:
            return
        merged: Dict[Tuple[str, str, str, str], list] = {}
        for obj, event_type, reason, message, ts in batch:
            # event_type is part of the identity (matching _record's
            # same-type check): a Normal and a Warning repeat of the same
            # reason/message must not merge into one record whose type is
            # whichever arrived first
            key = (
                obj.meta.namespace,
                f"{obj.meta.name}.{reason.lower()}",
                event_type,
                message,
            )
            slot = merged.get(key)
            if slot is None:
                merged[key] = [obj, event_type, reason, message, ts, 1]
            else:
                slot[4] = ts
                slot[5] += 1
        for obj, event_type, reason, message, ts, n in merged.values():
            try:
                self._record(obj, event_type, reason, message, ts, count=n)
            except Exception:
                pass

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
        self.flush()

    # -- write-through ------------------------------------------------------

    def _record(
        self,
        obj: Any,
        event_type: str,
        reason: str,
        message: str,
        now: float,
        count: int = 1,
    ) -> None:
        meta = obj.meta
        name = f"{meta.name}.{reason.lower()}"
        self._writes += 1
        if self._writes % 256 == 0:
            self._expire(now)
        try:
            ev = self.store.get("Event", name, meta.namespace)
            if ev.message == message and ev.type == event_type:
                ev.count += count
                ev.last_timestamp = now
                self.store.update(ev, force=True, copy_result=False)
                return
            self.store.delete("Event", name, meta.namespace)
        except KeyError:
            pass
        self.store.create(
            api.Event(
                meta=api.ObjectMeta(name=name, namespace=meta.namespace),
                involved_object=api.ObjectReference(
                    kind=getattr(obj, "KIND", ""),
                    name=meta.name,
                    namespace=meta.namespace,
                    uid=meta.uid,
                ),
                reason=reason,
                message=message,
                type=event_type,
                first_timestamp=now,
                last_timestamp=now,
                source_component=self.component,
                count=count,
            )
        )

    def _expire(self, now: float) -> None:
        """Drop events past the TTL (the --event-ttl sweep)."""
        events, _ = self.store.list("Event")
        for ev in events:
            if now - ev.last_timestamp > self.ttl:
                try:
                    self.store.delete("Event", ev.meta.name, ev.meta.namespace)
                except KeyError:
                    pass
