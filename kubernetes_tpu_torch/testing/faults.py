"""Deterministic, seeded fault injection: a copy of
kubernetes_tpu/testing/faults.py without its store-journal crash
harness (its obligation-ledger hook included: arm acquires, disarm
discharges).

Named fault points are threaded through the hot path, and each point
consults the armed registry through one module-level indirection.
Disarmed — the production state — the check is a single global load and
an early return.  The points wired in this package (KNOWN_POINTS):
`batch.solve` and `solve.carveout` (models/batch_scheduler.py
solve_encoded_async), `solve.partials` (models/partials.py sync),
`mirror.grow` (models/mirror.py _resize_resident), `batch.preemption`
(scheduler/preemption.py), the store's `store.update_wave`, `store.list`,
`watch.offer` and `watch.consume` (api/store.py), and the loop's
`binder.commit_wave`, `binder.stream_subwave` and `solve.speculate`
(scheduler/scheduler.py), the elector's `leader.renew`
(client/leaderelection.py), and the API front's `server.request`,
`server.watch.write` (api/server.py) and `apf.admit`
(api/flowcontrol.py).  The reference's journal and checkpoint points
have no counterpart here yet.

Schedules are bounded and seeded: a `FaultRegistry(seed=N)` draws every
probabilistic decision from its own `random.Random(N)`, so a failing
seed replays byte-identically.  Schedule kinds:

  fail(point, n)        raise (fail-once / fail-N); custom exception type
  crash(point, n)       raise FaultCrash — a BaseException that escapes
                        `except Exception` containment
  delay(point, s, n)    sleep `s` seconds (latency injection)
  torn_write(point)     the caller writes a PREFIX of its payload and
                        then fails
  drop(point, n)        the caller discards its payload
  corrupt(point, n)     the caller poisons its result

Sites that need caller-interpreted behaviour (torn/drop/corrupt) read
fire()'s return value; exception-kind schedules raise from inside
fire() so most sites need no control flow at all.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from random import Random
from typing import Dict, List, Optional

from ..analysis import ledger as _ledger


# Every fault point the hot path exposes.  fail()/crash()/... validate
# against this set so a typo'd point name fails the test loudly instead
# of silently never firing.
KNOWN_POINTS = frozenset({
    # -- the store and its watch streams (api/store.py) ----------------
    # the wave transaction (Store.update_wave, fired before the commit):
    # fail-grade schedules fail the whole wave (the binder retries once,
    # then splits it per pod)
    "store.update_wave",
    # the list/relist path (Store.list): delay-grade models a contended
    # snapshot path under a relist storm
    "store.list",
    # one event offered to one watcher's coalescing buffer: DROP expires
    # the watcher as if coalescing overflowed (its informer relists)
    "watch.offer",
    # the consumer side of a watch stream (Watch.get / iteration):
    # delay-grade models a slow consumer
    "watch.consume",
    # -- the scheduler loop (scheduler/scheduler.py) --------------------
    # one bind wave's commit on the binding stage: fail-grade schedules
    # fail the wave (retried once, then split per pod); crash-grade
    # schedules kill the binder (its watchdog restarts it)
    "binder.commit_wave",
    # a batch dispatched SPECULATIVELY — encode/solve over an earlier
    # wave's assumed placements while that wave is still committing;
    # fail-grade schedules kill the dispatch (the cycle containment
    # requeues exactly the speculative batch)
    "solve.speculate",
    # a streamed per-store-shard sub-wave handed to the commit pool (a
    # store of one shard never streams; kept for the reference's set)
    "binder.stream_subwave",
    # -- the solve --------------------------------------------------------
    # the device solve's dispatch (TorchBatchScheduler.solve_encoded_async):
    # fail-grade schedules kill the dispatch (retried once, then the
    # circuit breaker trips to the host fallback); CORRUPT fills the score
    # tensor with NaN so the decode's health check trips
    "batch.solve",
    # the batched PostFilter dry-run (one [P, N, K] dispatch per pass);
    # corrupt-grade schedules poison the decoded result so the health
    # check trips and the pass falls back to the per-pod parity path
    "batch.preemption",
    # a gang carve-out batch dispatched to the device (slice family
    # armed, gangs present) — fail-grade schedules kill the solve and
    # ride the batch.solve retry/breaker containment
    "solve.carveout",
    # the incremental-solve partials sync (models/partials.py): CORRUPT
    # poisons the resident affinity rows with +inf so the solve's scores
    # go NaN and the decode health check trips (the retry recomputes in
    # full); fail-grade schedules make the batch solve cold instead
    "solve.partials",
    # the in-place resident resize at a pad-bucket crossing
    # (models/mirror.py _resize_resident): fail-grade schedules decline
    # the resize (a full upload follows); CORRUPT fills the grown
    # allocatable with +inf so the fit scores go NaN and the decode
    # health check trips (the retry's invalidation re-uploads in full)
    "mirror.grow",
    # -- leader election (client/leaderelection.py) ---------------------
    # one tryAcquireOrRenew attempt: fail-grade schedules make the renew
    # raise, which the elector counts as a FAILED renew (renew_errors) —
    # the holder steps down exactly once and re-acquires on a later
    # healthy period
    "leader.renew",
    # -- the API front (api/server.py, api/flowcontrol.py) ---------------
    # every authorized HTTP request, fired before dispatch: fail-grade
    # schedules surface as 4xx/5xx to the client (retry containment),
    # delay-grade as server-side latency
    "server.request",
    # one watch frame written to an HTTP watch stream: delay-grade is a
    # stalled TCP consumer (full socket buffer), fail-grade a mid-frame
    # client disconnect, torn-grade a partial frame write then error —
    # the per-watcher write deadline must expire the watch, never pin
    # the handler thread
    "server.watch.write",
    # APF admission (flowcontrol.APFGate.acquire): delay-grade stalls
    # admission (queue-wait coverage), fail-grade rejects the request
    # at the gate (surfaced as a 4xx by the handler's containment)
    "apf.admit",
})

# caller-interpreted actions returned by fire()
DROP = "drop"
CORRUPT = "corrupt"


class FaultInjected(RuntimeError):
    """The default injected failure."""


class FaultCrash(BaseException):
    """Escapes `except Exception` containment: the injected analogue of
    a worker thread dying outright (stack overflow, interpreter-level
    fault) — what binder supervision exists to recover from."""


@dataclass
class TornWrite:
    """Returned by fire(): write only `frac` of the payload, then fail."""

    frac: float = 0.5


@dataclass
class _Schedule:
    mode: str                 # fail | crash | delay | torn | drop | corrupt
    remaining: int            # fires left; -1 = unbounded
    exc: type = FaultInjected
    seconds: float = 0.0
    probability: float = 1.0
    frac: float = 0.5


class FaultRegistry:
    """One chaos run's fault plan: schedules per point, consumed in
    registration order, every probabilistic draw from the run's seed."""

    GUARDED_FIELDS = {
        "_schedules": "_lock",
        "_rng": "_lock",
        "fired": "_lock",
        "log": "_lock",
        "last_ctx": "_lock",
    }
    # schedule registration precedes arm(): the builder-style fail()/
    # crash()/... calls run single-threaded before any hot-path thread
    # can reach fire()
    LOCKED_METHODS = frozenset({"_add"})

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._rng = Random(seed)
        self._lock = threading.Lock()
        self._schedules: Dict[str, List[_Schedule]] = {}
        # observability for the suite's coverage assertions
        self.fired: Dict[str, int] = {}
        self.log: List[tuple] = []  # (point, mode)
        # fire-site context of the LAST schedule that fired per point
        # (e.g. {"shard": 2} from the store's per-shard points) — the
        # crash-one-shard chaos family reads which shard it killed
        self.last_ctx: Dict[str, dict] = {}

    # -- schedule registration -------------------------------------------

    def _add(self, point: str, sched: _Schedule) -> "FaultRegistry":
        if point not in KNOWN_POINTS:
            raise ValueError(
                f"unknown fault point {point!r}; known: {sorted(KNOWN_POINTS)}"
            )
        self._schedules.setdefault(point, []).append(sched)
        return self

    def fail(
        self,
        point: str,
        n: int = 1,
        exc: type = FaultInjected,
        probability: float = 1.0,
    ) -> "FaultRegistry":
        return self._add(
            point, _Schedule("fail", n, exc=exc, probability=probability)
        )

    def crash(
        self, point: str, n: int = 1, probability: float = 1.0
    ) -> "FaultRegistry":
        return self._add(
            point, _Schedule("crash", n, probability=probability)
        )

    def delay(
        self, point: str, seconds: float, n: int = 1, probability: float = 1.0
    ) -> "FaultRegistry":
        return self._add(
            point,
            _Schedule("delay", n, seconds=seconds, probability=probability),
        )

    def torn_write(
        self, point: str, frac: float = 0.5, n: int = 1
    ) -> "FaultRegistry":
        return self._add(point, _Schedule("torn", n, frac=frac))

    def drop(
        self, point: str, n: int = 1, probability: float = 1.0
    ) -> "FaultRegistry":
        return self._add(point, _Schedule("drop", n, probability=probability))

    def corrupt(
        self, point: str, n: int = 1, probability: float = 1.0
    ) -> "FaultRegistry":
        return self._add(
            point, _Schedule("corrupt", n, probability=probability)
        )

    def pending(self) -> Dict[str, int]:
        """Point → fires still scheduled (0 once a bounded plan drained;
        the chaos suite's bounded-quiesce precondition)."""
        with self._lock:
            return {
                point: sum(
                    s.remaining for s in scheds if s.remaining > 0
                )
                for point, scheds in self._schedules.items()
            }

    # -- the hot-path side ------------------------------------------------

    def fire(self, point: str, **ctx):
        delay_s = 0.0
        action = None
        exc: Optional[BaseException] = None
        with self._lock:
            for sched in self._schedules.get(point, ()):
                if sched.remaining == 0:
                    continue
                if (
                    sched.probability < 1.0
                    and self._rng.random() >= sched.probability
                ):
                    continue
                if sched.remaining > 0:
                    sched.remaining -= 1
                self.fired[point] = self.fired.get(point, 0) + 1
                self.log.append((point, sched.mode))
                self.last_ctx[point] = dict(ctx)
                if sched.mode == "delay":
                    delay_s = sched.seconds
                    continue  # latency composes with a later failure
                if sched.mode == "fail":
                    exc = sched.exc(f"injected fault at {point}")
                elif sched.mode == "crash":
                    exc = FaultCrash(f"injected crash at {point}")
                elif sched.mode == "torn":
                    action = TornWrite(sched.frac)
                elif sched.mode == "drop":
                    action = DROP
                elif sched.mode == "corrupt":
                    action = CORRUPT
                break  # at most one non-delay schedule fires per call
        if delay_s > 0.0:
            time.sleep(delay_s)
        if exc is not None:
            raise exc
        return action


# -- module-level arming ----------------------------------------------------

_registry: Optional[FaultRegistry] = None


def arm(registry: FaultRegistry) -> FaultRegistry:
    global _registry
    if _registry is not None:
        # re-arm over a live registry: the previous arming's obligation
        # is retired by being overwritten, not leaked
        _ledger.discharge("fault", 0)
    _registry = registry
    _ledger.acquire("fault", 0)
    return registry


def disarm() -> None:
    global _registry
    if _registry is not None:
        _ledger.discharge("fault", 0)
    _registry = None


@contextlib.contextmanager
def armed(registry: FaultRegistry):
    arm(registry)
    try:
        yield registry
    finally:
        disarm()


def fire(point: str, **ctx):
    """The hot-path entry: a single global load when disarmed."""
    reg = _registry
    if reg is None:
        return None
    return reg.fire(point, **ctx)
