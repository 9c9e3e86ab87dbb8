"""Scheduler metrics: the part of kubernetes_tpu/scheduler/metrics.py the
ported modules record into — the Histogram, Counter and Gauge classes and
a Registry carrying the six preemption metrics and the circuit breaker's
two gauges (metric names as the reference's,
pkg/scheduler/metrics/metrics.go).  The scheduler loop, which sets the
gauges from TorchBatchScheduler.breaker each cycle, and the rest of the
Registry come later.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, Tuple

# the reference's scheduling-latency bucket layout (metrics.go:92:
# ExponentialBuckets(0.001, 2, 15))
_DEF_BUCKETS = tuple(0.001 * 2 ** i for i in range(15))


class Histogram:
    def __init__(self, name: str, buckets: Tuple[float, ...] = _DEF_BUCKETS):
        self.name = name
        self.buckets = sorted(buckets)
        self.counts = [0] * (len(self.buckets) + 1)
        self.total = 0.0
        self.n = 0
        self.max = 0.0  # true upper bound for the +Inf bucket
        self._lock = threading.Lock()

    def observe(self, value: float, count: int = 1) -> None:
        """Record `value`, `count` times.  count>1 is the batched-solve
        fan-out: one device dispatch schedules P pods, so the per-pod
        algorithm cost (solve/P) is observed once per pod without P
        bisect calls."""
        with self._lock:
            self.counts[bisect.bisect_left(self.buckets, value)] += count
            self.total += value * count
            self.n += count
            if value > self.max:
                self.max = value

    def percentile(self, q: float) -> float:
        """Linear-interpolated quantile from bucket counts (what the
        perf-harness metricsCollector computes from histograms)."""
        with self._lock:
            if self.n == 0:
                return 0.0
            target = q * self.n
            seen = 0
            lo = 0.0
            for i, c in enumerate(self.counts):
                # the +Inf bucket's bound is the true max observed value
                # (Prometheus would report the last finite bound; fabricating
                # lo*2 would misreport p99s the perf harness quotes)
                hi = (
                    self.buckets[i]
                    if i < len(self.buckets)
                    else max(self.max, lo)
                )
                if seen + c >= target and c > 0:
                    frac = (target - seen) / c
                    return lo + (hi - lo) * frac
                seen += c
                lo = hi
            return lo

    @property
    def average(self) -> float:
        with self._lock:
            return self.total / self.n if self.n else 0.0


class Counter:
    def __init__(self, name: str):
        self.name = name
        self._v: Dict[Tuple[str, ...], float] = {}
        self._lock = threading.Lock()

    def inc(self, *labels: str, by: float = 1.0) -> None:
        with self._lock:
            self._v[labels] = self._v.get(labels, 0.0) + by

    def get(self, *labels: str) -> float:
        with self._lock:
            return self._v.get(labels, 0.0)

    @property
    def total(self) -> float:
        with self._lock:
            return sum(self._v.values())


class Gauge:
    def __init__(self, name: str):
        self.name = name
        self._v: Dict[Tuple[str, ...], float] = {}
        self._lock = threading.Lock()

    def set(self, value: float, *labels: str) -> None:
        with self._lock:
            self._v[labels] = value

    def get(self, *labels: str) -> float:
        with self._lock:
            return self._v.get(labels, 0.0)

    @property
    def total(self) -> float:
        """Sum over every label tuple (the bare value when unlabeled)."""
        with self._lock:
            return sum(self._v.values())


class Registry:
    """The ported metrics of one scheduler, by reference name."""

    def __init__(self):
        self.preemption_victims = Histogram("scheduler_preemption_victims")
        self.preemption_attempts = Counter("scheduler_preemption_attempts_total")
        # wall seconds of one PostFilter pass's shared encode + batched
        # [P, N, K] dry-run + static-feasibility dispatch (one observation
        # per pass)
        self.preemption_solve_duration = Histogram(
            "scheduler_preemption_solve_duration_seconds"
        )
        # failed pods sharing one batched preemption solve
        self.preemption_batch_size = Histogram(
            "scheduler_preemption_batch_size_pods",
            buckets=tuple(float(2 ** i) for i in range(13)),
        )
        # (preemptor, node) pairs recomputed from live state because an
        # earlier preemptor of the same pass evicted there (the coupling
        # discipline that keeps batched == sequential)
        self.preemption_conflict_serializations = Counter(
            "scheduler_preemption_conflict_serializations_total"
        )
        # feasible candidates whose minimal eviction set would violate a
        # PodDisruptionBudget (ranked last — minNumPDBViolatingScoreFunc)
        self.preemption_pdb_blocked_total = Counter(
            "scheduler_preemption_pdb_blocked_total"
        )
        # -- degraded mode --------------------------------------------------
        # circuit-breaker state: 0 closed, 1 half-open, 2 open
        self.solve_breaker_state = Gauge("scheduler_solve_breaker_state")
        # running total of batches solved on the host fallback path
        # (mirrored from the breaker each cycle — monotonic)
        self.solve_fallback_total = Gauge("scheduler_solve_fallback_total")
