"""Runtime epoch auditor for the device residents.

Every resident buffer (models/mirror.py DeviceClusterMirror, models/
partials.py PartialsCache) is stamped with an :class:`EpochStamp` at each
state transition (sync / rollback / invalidate):

    (struct_generation, vocab watermark, dirty watermark, buffer lineage)

``struct_gen`` is ClusterState.struct_generation (resource-axis
identity), ``vocab_key`` the per-referenced-key expansion watermark
(None for residents that do not expand against vocabularies),
``synced_gen`` the ClusterState.generation the buffer content matches
(the dirty watermark), and ``buffer_id`` a process-unique lineage token
minted at every full upload/recompute — a delta chain keeps its base's
lineage, a rollback restores the bookmarked one, an invalidate clears
the stamp whole.

Armed, the auditor validates at consume time — inside
``TorchBatchScheduler.encode_pending`` (against the state's CURRENT
generations, under the cache lock) and ``_dispatch`` (cross-resident:
the partials epoch must agree with the mirror epoch the solve reads) —
and records the divergent ``(resident, field, epoch)`` triple.  Disarmed
cost is one module-global None check per hook.

Usage::

    from kubernetes_tpu_torch.analysis import epochs

    with epochs.tracked() as auditor:
        ...                      # scheduler runs, hooks audit
    auditor.assert_clean()

This module imports neither torch nor numpy: stamps are plain
ints/tuples and the hooks never touch device tensor contents.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
from typing import List, NamedTuple, Optional


class CoherenceViolation(AssertionError):
    """A resident buffer reached a solve with a divergent epoch."""


class EpochStamp(NamedTuple):
    """Epoch tuple stamped onto a resident buffer at each transition."""

    resident: str                  # "mirror" / "partials" / ...
    struct_gen: int                # ClusterState.struct_generation
    vocab_key: Optional[tuple]     # expansion watermark (None: no vocab)
    synced_gen: int                # ClusterState.generation (dirty mark)
    buffer_id: int                 # lineage: minted per full upload


# process-unique buffer lineage tokens; 0 is reserved for "no buffer"
_buffer_ids = itertools.count(1)


def fresh_buffer_id() -> int:
    """Mint a lineage token for a freshly (re)built resident buffer."""
    return next(_buffer_ids)


class EpochAuditor:
    def __init__(self):
        self._mu = threading.Lock()
        self.audits = 0
        self.violations: List[str] = []
        # accounting, not violations: rollbacks refused because the
        # resident was invalidated after the bookmark (the guard that
        # keeps a rollback from resurrecting a buffer an invalidate
        # deliberately dropped — models/mirror.py rollback())
        self.rollbacks_blocked = 0

    # -- recording ---------------------------------------------------------

    def _violate(self, resident: str, field: str, epoch, expected) -> None:
        self.violations.append(
            f"({resident}, {field}, {epoch!r}): diverges from the "
            f"scheduler cache's current {field}={expected!r} at consume "
            "time — a discipline wire (rollback/invalidate/sync) was "
            "missed"
        )

    def audit_consume(
        self,
        stamp: Optional[EpochStamp],
        resident: str,
        struct_gen: int,
        generation: int,
        vocab_key: Optional[tuple] = None,
        check_vocab: bool = False,
    ) -> None:
        """One consume-time audit of a resident's stamp against the
        owning cache's CURRENT generations (caller holds the cache
        lock — the generations are read there)."""
        with self._mu:
            self.audits += 1
            if stamp is None:
                self.violations.append(
                    f"({resident}, stamp, None): resident buffer consumed "
                    "with no epoch stamp — it was never synced, or an "
                    "invalidate cleared it and a stale reference leaked"
                )
                return
            if stamp.struct_gen != struct_gen:
                self._violate(resident, "struct_gen", stamp, struct_gen)
            if stamp.synced_gen != generation:
                self._violate(resident, "synced_gen", stamp, generation)
            if check_vocab and stamp.vocab_key != vocab_key:
                self._violate(resident, "vocab_key", stamp, vocab_key)

    def audit_pair(
        self, mirror_stamp: EpochStamp, partials_stamp: EpochStamp
    ) -> None:
        """Cross-resident audit at dispatch time: the partials rows a
        solve consumes must have been evaluated in the same epoch as
        the mirror tensors it consumes (the two residents roll
        together)."""
        with self._mu:
            self.audits += 1
            if partials_stamp.struct_gen != mirror_stamp.struct_gen:
                self._violate(
                    "partials", "struct_gen", partials_stamp,
                    mirror_stamp.struct_gen,
                )
            if partials_stamp.synced_gen != mirror_stamp.synced_gen:
                self._violate(
                    "partials", "synced_gen", partials_stamp,
                    mirror_stamp.synced_gen,
                )

    def note_rollback_blocked(self, resident: str) -> None:
        with self._mu:
            self.rollbacks_blocked += 1

    # -- results -----------------------------------------------------------

    @property
    def audits_total(self) -> int:
        with self._mu:
            return self.audits

    @property
    def violations_total(self) -> int:
        with self._mu:
            return len(self.violations)

    def assert_clean(self) -> None:
        if self.violations:
            raise CoherenceViolation("\n".join(self.violations[:20]))


_active: Optional[EpochAuditor] = None


@contextlib.contextmanager
def tracked(auditor: Optional[EpochAuditor] = None):
    """Arm epoch auditing for the dynamic extent of the context.
    Nested arming shares the outer auditor (an enclosing fixture and a
    test's own use must not shadow each other)."""
    global _active
    if _active is not None:
        yield _active
        return
    auditor = auditor or EpochAuditor()
    _active = auditor
    try:
        yield auditor
    finally:
        _active = None


def active() -> Optional[EpochAuditor]:
    return _active


# -- module-level hooks (no-ops unless armed) --------------------------------

def audit_mirror(mirror, state) -> None:
    """Consume-time audit of a DeviceClusterMirror: called from
    encode_pending right after mirror.sync(), under the cache lock."""
    a = _active
    if a is not None:
        a.audit_consume(
            mirror.epoch(), "mirror",
            state.struct_generation, state.generation,
        )


def audit_partials(partials, state) -> None:
    """Consume-time audit of a PartialsCache: called from
    encode_pending right after partials.sync(), under the cache lock.
    Skips cleanly when the cache declined the batch (no stamp and no
    store is a cold solve, not a violation)."""
    a = _active
    if a is None:
        return
    if partials.epoch() is None and partials._store is None:
        return  # declined / cold: the solve takes the in-program path
    a.audit_consume(
        partials.epoch(), "partials",
        state.struct_generation, state.generation,
        vocab_key=partials._vocab_watermark(), check_vocab=True,
    )


def audit_dispatch(meta) -> None:
    """Dispatch-time cross-resident audit: the epoch pair encode_pending
    stamped onto the SnapshotMeta must agree with itself — the partials
    statics a solve reads were evaluated against the exact mirror epoch
    it consumes."""
    a = _active
    if a is None:
        return
    stamp = getattr(meta, "coherence_stamp", None)
    if stamp is None:
        return  # cold encode, or stamped before arming
    mirror_stamp, partials_stamp = stamp
    if mirror_stamp is not None and partials_stamp is not None:
        a.audit_pair(mirror_stamp, partials_stamp)


def note_rollback_blocked(resident: str) -> None:
    a = _active
    if a is not None:
        a.note_rollback_blocked(resident)


def audits_total() -> int:
    a = _active
    return a.audits_total if a is not None else 0


def violations_total() -> int:
    a = _active
    return a.violations_total if a is not None else 0
