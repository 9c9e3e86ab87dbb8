"""Rate-limited work queues — client-go util/workqueue reduced to the
semantics every controller depends on:

  * dedup: an item added while queued is processed once (queue.go's
    dirty/processing sets);
  * re-add during processing: processed again after done() (no lost
    updates);
  * per-item exponential backoff via add_rate_limited / forget
    (rate_limiting_queue.go + default_rate_limiters.go's
    ItemExponentialFailureRateLimiter);
  * add_after: delayed enqueue (delaying_queue.go).

A copy of the reference package's client/workqueue.py, whole.
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import Any, Dict, List, Optional, Set, Tuple


class WorkQueue:
    def __init__(
        self,
        base_delay: float = 0.005,
        max_delay: float = 1000.0,
        clock=time.monotonic,
    ):
        self._clock = clock
        self._base = base_delay
        self._max = max_delay
        self._cond = threading.Condition()
        self._queue: List[Any] = []
        self._dirty: Set[Any] = set()
        self._processing: Set[Any] = set()
        self._failures: Dict[Any, int] = {}
        self._delayed: List[Tuple[float, int, Any]] = []  # (when, seq, item)
        self._seq = 0
        self._shutdown = False

    # -- core (queue.go) ---------------------------------------------------

    def add(self, item: Any) -> None:
        with self._cond:
            if self._shutdown or item in self._dirty:
                return
            self._dirty.add(item)
            if item in self._processing:
                return
            self._queue.append(item)
            self._cond.notify()

    def get(self, timeout: Optional[float] = None) -> Optional[Any]:
        """Blocks for the next item (None on timeout/shutdown).  The item
        is 'processing' until done(item)."""
        deadline = None if timeout is None else self._clock() + timeout
        with self._cond:
            while True:
                self._pump_delayed_locked()
                if self._queue:
                    item = self._queue.pop(0)
                    self._processing.add(item)
                    self._dirty.discard(item)
                    return item
                if self._shutdown:
                    return None
                wait = self._next_wait_locked(deadline)
                if wait is not None and wait <= 0:
                    return None
                self._cond.wait(wait)

    def done(self, item: Any) -> None:
        with self._cond:
            self._processing.discard(item)
            if item in self._dirty:
                self._queue.append(item)
                self._cond.notify()

    def shutdown(self) -> None:
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()

    def __len__(self) -> int:
        with self._cond:
            return len(self._queue)

    # -- delays / rate limiting -------------------------------------------

    def add_after(self, item: Any, delay: float) -> None:
        if delay <= 0:
            self.add(item)
            return
        with self._cond:
            if self._shutdown:
                return
            self._seq += 1
            heapq.heappush(self._delayed, (self._clock() + delay, self._seq, item))
            self._cond.notify()

    def add_rate_limited(self, item: Any) -> None:
        """Enqueue after the item's exponential backoff (failures so far)."""
        with self._cond:
            n = self._failures.get(item, 0)
            self._failures[item] = n + 1
        self.add_after(item, min(self._base * (2 ** n), self._max))

    def forget(self, item: Any) -> None:
        """Reset the item's backoff (call on successful sync)."""
        with self._cond:
            self._failures.pop(item, None)

    def num_requeues(self, item: Any) -> int:
        with self._cond:
            return self._failures.get(item, 0)

    # -- internals ---------------------------------------------------------

    def _pump_delayed_locked(self) -> None:
        now = self._clock()
        while self._delayed and self._delayed[0][0] <= now:
            _, _, item = heapq.heappop(self._delayed)
            if item in self._dirty or self._shutdown:
                continue
            self._dirty.add(item)
            if item not in self._processing:
                self._queue.append(item)

    def _next_wait_locked(self, deadline: Optional[float]) -> Optional[float]:
        """Seconds to sleep, None for forever, <=0 for 'give up now'."""
        candidates = []
        if self._delayed:
            candidates.append(self._delayed[0][0])
        if deadline is not None:
            candidates.append(deadline)
        if not candidates:
            return None
        wait = min(candidates) - self._clock()
        if deadline is not None and min(candidates) == deadline:
            return wait if wait > 0 else 0
        return max(wait, 0.001)
