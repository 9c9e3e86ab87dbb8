"""Runtime exactly-once obligation ledger: a copy of the reference
package's analysis/ledger.py, whole.

It observes the acquisitions that actually happen and answers one
question: did each individual object reach exactly one disposition by
quiesce time?

Tracked obligation kinds (hooks live next to the production guards, so
a legitimately-idempotent second call never reaches the ledger).  The
kinds this package acquires today:

  pod                a pod popped into the queue's "inflight" tier
                     (scheduler/queue.py take()) must leave it exactly
                     once — done / delete / requeue_backoff /
                     add_unschedulable / re-gate.
  assume             a cache.assume() insert must be confirmed
                     (add_pod/finish_binding) or forgotten
                     (forget/forget_key/remove_*/cleanup_expired)
                     exactly once (scheduler/cache.py).
  slot               a DispatchArbiter admission (counter, owner-scoped
                     per arbiter; models/batch_scheduler.py).  release()
                     reports to the ledger BEFORE the below-zero swallow
                     guard, so a masked double-release surfaces here even
                     though the production counter is protected.
  fault              testing/faults.py arm() → disarm() in tests.

The reference's other kinds (seat, stream_inflight, dispatch_inflight)
belong to its API server and its scheduler loop; they stay in the kind
lists so the two ledgers read alike.

Keyed kinds record per-object acquire/discharge transitions with a
short acquiring call chain; discharging an already-discharged key
raises :class:`ObligationViolation` IMMEDIATELY (a double-disposition
is corruption in progress, not an end-state anomaly).  Counter kinds
keep an owner-scoped LIFO of acquire chains; popping an empty stack
for a known owner is likewise a double-discharge.  Keys and owners the
ledger never saw acquired are ignored silently — arming mid-flight
must not misattribute pre-arming acquisitions.

At quiesce, :meth:`ObligationLedger.assert_clean` reports every leaked
obligation with the call chain that acquired it.

Usage (scoped)::

    from kubernetes_tpu_torch.analysis import ledger

    with ledger.tracked() as led:
        ...                      # queue, cache and arbiter hooks record
    led.assert_clean()

This module is import-light (stdlib only): hooks cost one module-global
None check when disarmed.
"""

from __future__ import annotations

import contextlib
import sys
import threading
from typing import Dict, List, Optional, Tuple

#: kinds tracked per-object (acquire/discharge keyed by object identity)
KEYED_KINDS = ("pod", "assume", "seat", "fault")

#: kinds tracked as owner-scoped counters (LIFO stack of acquire chains)
COUNTER_KINDS = ("slot", "stream_inflight", "dispatch_inflight")


class ObligationViolation(AssertionError):
    """An obligation was discharged twice, or leaked past quiesce."""


def _chain(skip: int = 2, limit: int = 7) -> str:
    """A short acquiring call chain: the last few frames below the
    ledger method (skip drops _chain + the method itself), rendered
    one-per-segment ("file:line fn").  A raw ``sys._getframe`` walk,
    not traceback.extract_stack — the extract path reads source lines
    through linecache per frame, and this runs on every pod pop/assume
    of an armed run (the hooks must not perturb the overlap timing the
    chaos suites assert on)."""
    try:
        f = sys._getframe(skip)
    except ValueError:  # shallower stack than skip
        return "<top>"
    parts: List[str] = []
    while f is not None and len(parts) < limit:
        code = f.f_code
        parts.append(
            f"{code.co_filename.rsplit('/', 1)[-1]}:{f.f_lineno} "
            f"{code.co_name}"
        )
        f = f.f_back
    return " <- ".join(parts)


class ObligationLedger:
    def __init__(self):
        self._mu = threading.Lock()
        self.acquired = 0
        # keyed kinds: (kind, key) -> acquiring chain while HELD,
        # then moved to _done with the discharging chain
        self._held: Dict[Tuple[str, object], str] = {}
        self._done: Dict[Tuple[str, object], str] = {}
        # counter kinds: (kind, owner) -> LIFO of acquiring chains;
        # owners stay in the dict after draining so an extra pop is
        # distinguishable from a never-seen owner
        self._stacks: Dict[Tuple[str, object], List[str]] = {}
        self.double: List[str] = []

    # -- keyed kinds ---------------------------------------------------------

    def acquire(self, kind: str, key: object) -> None:
        with self._mu:
            self.acquired += 1
            k = (kind, key)
            # a re-acquire retires the previous cycle of this key (a
            # requeued pod popped again, a re-assume after forget)
            self._done.pop(k, None)
            self._held[k] = _chain()

    def discharge(self, kind: str, key: object) -> None:
        with self._mu:
            k = (kind, key)
            chain = self._held.pop(k, None)
            if chain is not None:
                self._done[k] = _chain()
                return
            prev = self._done.get(k)
            if prev is None:
                return  # never saw the acquire (armed mid-flight)
            msg = (
                f"double-discharge of {kind} {key!r}: already discharged"
                f" at [{prev}], discharged again at [{_chain()}]"
            )
            self.double.append(msg)
        raise ObligationViolation(msg)

    # -- counter kinds -------------------------------------------------------

    def push(self, kind: str, owner: object) -> None:
        with self._mu:
            self.acquired += 1
            self._stacks.setdefault((kind, owner), []).append(_chain())

    def pop(self, kind: str, owner: object) -> None:
        with self._mu:
            stack = self._stacks.get((kind, owner))
            if stack is None:
                return  # never saw an acquire for this owner
            if stack:
                stack.pop()
                return
            msg = (
                f"double-discharge of {kind} counter (owner {owner:#x}): "
                f"released below zero at [{_chain()}]"
            )
            self.double.append(msg)
        raise ObligationViolation(msg)

    def reset_cycles(self) -> None:
        """Forget completed acquire/discharge cycles.  Keyed kinds use
        identity-stable keys (pod keys, object ids) that RECUR across
        tests in a session-armed run — a retired ``default/p3`` from
        one test must not make the next test's discharge-without-
        acquire of its own ``default/p3`` (an informer delete of a
        never-assumed pod) read as a double-discharge.  The per-test
        conftest fixture calls this at every test boundary; held
        obligations and recorded violations survive — only the
        double-discharge lookback window resets."""
        with self._mu:
            self._done.clear()

    def abandon(self) -> None:
        """Process-death semantics: drop every held obligation and
        counter stack without counting a discharge.  Scheduler.kill()
        (the chaos harness's SIGKILL analogue) calls this — a real
        crash takes the in-memory ledger with it, and the abandoned
        pods/assumes are recovered by TTL expiry and successor
        reconciliation, not by structural discharge.  Keys stay out of
        ``_done`` so a successor's re-acquire/discharge of the same
        pod key is a fresh cycle, and a stray late discharge from a
        half-dead thread reads as never-seen (silent) — which is why
        the counter OWNERS are forgotten outright (an empty-but-known
        stack means double-discharge) and the ``_done`` lookback is
        dropped (kill() shuts the commit pool down without waiting, so
        an in-flight hand-off may discharge after the abandon).  The
        cost: a concurrent live instance's held obligations are
        dropped too — acceptable in crash tests, which re-verify
        drainage on the survivor afterwards."""
        with self._mu:
            self._held.clear()
            self._done.clear()
            self._stacks.clear()

    # -- results -------------------------------------------------------------

    def outstanding(self, kinds: Optional[Tuple[str, ...]] = None) -> List[str]:
        """Leaked obligations (acquired, never discharged), each with
        its acquiring call chain."""
        with self._mu:
            out = [
                f"leaked {kind} {key!r}: acquired at [{chain}], never"
                " discharged"
                for (kind, key), chain in sorted(
                    self._held.items(), key=lambda kv: repr(kv[0])
                )
                if kinds is None or kind in kinds
            ]
            for (kind, owner), stack in sorted(
                self._stacks.items(), key=lambda kv: repr(kv[0])
            ):
                if kinds is not None and kind not in kinds:
                    continue
                for chain in stack:
                    out.append(
                        f"leaked {kind} counter (owner {owner:#x}):"
                        f" acquired at [{chain}], never released"
                    )
            return out

    @property
    def tracked_total(self) -> int:
        with self._mu:
            return self.acquired

    @property
    def leaks_total(self) -> int:
        return len(self.outstanding())

    @property
    def double_discharge_total(self) -> int:
        with self._mu:
            return len(self.double)

    def assert_quiesced(self, kinds: Tuple[str, ...], context: str = "") -> None:
        """Quiesce-time check for the given kinds only: the chaos
        suites call this where they already assert assumed_count()==0 /
        all-bound, so a failure names the leaking acquisition site."""
        leaks = self.outstanding(kinds)
        if leaks:
            where = f" [{context}]" if context else ""
            raise ObligationViolation(
                f"{len(leaks)} obligation(s) leaked at quiesce{where}:\n"
                + "\n".join(leaks[:20])
            )

    def assert_clean(self) -> None:
        problems = list(self.double) + self.outstanding()
        if problems:
            raise ObligationViolation("\n".join(problems[:20]))


_active: Optional[ObligationLedger] = None


@contextlib.contextmanager
def tracked(led: Optional[ObligationLedger] = None):
    """Arm obligation tracking for the dynamic extent of the context.
    Nested arming shares the outer ledger (session fixture + per-test
    use must not shadow each other — analysis/epochs.py, same)."""
    global _active
    if _active is not None:
        yield _active
        return
    led = led or ObligationLedger()
    _active = led
    try:
        yield led
    finally:
        _active = None


def active() -> Optional[ObligationLedger]:
    return _active


# -- module-level hooks (no-ops unless armed) --------------------------------

def acquire(kind: str, key: object) -> None:
    a = _active
    if a is not None:
        a.acquire(kind, key)


def discharge(kind: str, key: object) -> None:
    a = _active
    if a is not None:
        a.discharge(kind, key)


def push(kind: str, owner: object) -> None:
    a = _active
    if a is not None:
        a.push(kind, owner)


def pop(kind: str, owner: object) -> None:
    a = _active
    if a is not None:
        a.pop(kind, owner)


def abandon() -> None:
    a = _active
    if a is not None:
        a.abandon()


def tracked_total() -> int:
    a = _active
    return a.tracked_total if a is not None else 0


def leaks_total() -> int:
    a = _active
    return a.leaks_total if a is not None else 0


def double_discharge_total() -> int:
    a = _active
    return a.double_discharge_total if a is not None else 0
