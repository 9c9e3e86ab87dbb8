"""Poor-man's op tracing: timed steps logged when a threshold is blown (a
copy of kubernetes_tpu/utils/trace.py).

Reference: utiltrace.New("Scheduling", ...) with LogIfLong(100ms) steps
inside schedulePod (schedule_one.go:391-431) — the lightweight always-on
layer under the OTel integration.  A Trace collects named steps; if the
total exceeds the threshold at the end of the `with` block, every step
is logged with its share, so slow cycles self-describe in logs without a
profiler attached.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger("kubernetes_tpu_torch.trace")

# Over-threshold traces, recorded alongside the log line so harnesses
# (bench.py BENCH_STRICT) can FAIL on slow cycles instead of merely
# warning into a log nobody greps.  Bounded; drain_overruns() empties it.
_OVERRUNS: List[Dict] = []
_OVERRUNS_LOCK = threading.Lock()
_OVERRUNS_CAP = 256


def drain_overruns() -> List[Dict]:
    """Return and clear the recorded over-threshold traces.  Each entry:
    {name, total_s, threshold_s, fields, steps: [(what, seconds)]}."""
    with _OVERRUNS_LOCK:
        out = list(_OVERRUNS)
        _OVERRUNS.clear()
    return out


class Trace:
    def __init__(self, name: str, threshold: float = 0.1, clock=time.monotonic,
                 **fields):
        self.name = name
        self.threshold = threshold
        self._clock = clock
        self.fields = fields
        self._t0 = clock()
        self._last = self._t0
        self._logged = False
        self._log_lock = threading.Lock()
        self.steps: List[Tuple[str, float]] = []

    def step(self, what: str) -> None:
        now = self._clock()
        self.steps.append((what, now - self._last))
        self._last = now

    @property
    def total(self) -> float:
        return self._clock() - self._t0

    def __enter__(self) -> "Trace":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.log_if_long()

    def log_if_long(self, threshold: Optional[float] = None) -> None:
        limit = self.threshold if threshold is None else threshold
        total = self.total
        # Exactly once per trace, even when a caller's explicit exit-path
        # call races or stacks with the with-block exit (the r05 bench
        # tail showed every over-threshold schedule_batch trace twice —
        # the explicit call at the end of the group loop plus __exit__,
        # each formatting its own slightly-later total).  The flag is
        # checked-and-set under a lock so a trace finalized from another
        # thread (deferred-cycle finalize) can't double-emit either.
        if total < limit:
            return
        with self._log_lock:
            if self._logged:
                return
            self._logged = True
        tags = ",".join(f"{k}={v}" for k, v in self.fields.items())
        parts = "; ".join(f"{w}: {dt * 1e3:.1f}ms" for w, dt in self.steps)
        logger.warning(
            "trace %s (%s) took %.1fms (threshold %.0fms): %s",
            self.name, tags, total * 1e3, limit * 1e3, parts,
        )
        with _OVERRUNS_LOCK:
            if len(_OVERRUNS) < _OVERRUNS_CAP:
                _OVERRUNS.append(
                    {
                        "name": self.name,
                        "total_s": round(total, 4),
                        "threshold_s": limit,
                        "fields": dict(self.fields),
                        "steps": [
                            (w, round(dt, 4)) for w, dt in self.steps
                        ],
                    }
                )
