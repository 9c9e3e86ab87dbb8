"""PartialsCache — device-resident Filter/Score partials, warm-started from
the mirror (the incremental O(changes) solve).

The sibling of DeviceClusterMirror: where the mirror makes the host->device
transfer O(changed rows), this cache makes the per-batch Filter/Score
re-evaluation O(changes).  It keeps the per-class static triple
(ops/partials.py PartialsStore) resident on the device, keyed by CONTENT
signatures of the encoder's pod classes, with the batch-local selector and
preferred table indices replaced by the builder's persistent signature
registry ids (SnapshotMeta.sel_stable / pref_stable) so a key survives
across batches.

Per sync (under the cache lock, right after mirror.sync()):

  1. classes first seen this batch get a slot and their spec rows (one
     `mirror_rows` launch, which writes fresh spec leaves);
  2. one `partials_eval` launch writes a fresh store: the new classes'
     full [N] rows, every cached class re-evaluated at ONLY the node rows
     dirtied since the cache's last sync (ClusterState.dirty_rows, which
     includes the rows the previous batch's assumes touched) and at the
     columns a pad-bucket grow added, every other entry copied;
  3. the solve consumes the batch-ordered gather — the `statics=` operand
     of the greedy scan and the wavefront.

Resync discipline (the reference's, whole):

  * full recompute when the struct generation moved or the delta would
    touch more than half the rows;
  * full FLUSH (keys dropped) when an expansion-relevant vocabulary grew
    (the per-referenced-key watermark): a grown vocab changes what a
    cached selector row should contain without changing its key;
  * reallocation (more classes than slots) reseeds from this batch; more
    classes than MAX_SLOTS declines (None: the solve runs cold);
  * a PERIODIC full recompute every `resync_interval` delta syncs, plus
    verify(), the oracle-parity gate the tests drive;
  * a pad-bucket crossing resizes the store's columns in the same store
    update and keeps every class warm;
  * speculation_point()/rollback() bookmark the resident tensors (updates
    are out of place, so holding the references is the double buffer),
    and invalidate() drops everything.

The `solve.partials` fault point (testing/faults.py) fires at the top of
every sync: a raised fault reaches the scheduler, which invalidates the
cache and solves that batch cold; CORRUPT poisons the resident affinity
rows after the epoch stamp (`_poison_aff`).  The reference's `mesh`
branches are not ported yet.  All state is mutated under the
scheduler-cache lock.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np
import torch

from ..analysis import epochs
from ..ops import device as device_ops
from ..ops import partials as pops
from ..ops import schema
from ..testing import faults
from ..utils import vocab as vb

_DOMAIN_LABELS = schema.DOMAIN_LABELS


def _poison_aff(store: pops.PartialsStore) -> pops.PartialsStore:
    """CORRUPT-grade fault: the resident raw-affinity rows as +inf (a fill,
    plain torch on the store's device).  The per-pod normalisation divides
    by the feasible-set max — floor(100 * inf / inf) is NaN — so every
    feasible node's score goes NaN and the decode health check trips
    (models.batch_scheduler.SolveUnhealthy).  A NaN poison would be
    squashed: normalize reads a NaN max as not > 0 and zeroes the row."""
    return store._replace(aff=torch.full_like(store.aff, float("inf")))


class PartialsCache:
    """One consumer's resident Filter/Score partials for a ClusterState
    (each TorchBatchScheduler owns one, next to its DeviceClusterMirror)."""

    # deltas touching more rows than this fraction take a full recompute
    FULL_SYNC_FRACTION = 0.5
    # forced full recompute every this many delta syncs
    DEFAULT_RESYNC_INTERVAL = 1024
    MIN_SLOTS = 32
    MAX_SLOTS = 1024

    def __init__(self, state: schema.ClusterState, device="cuda",
                 resync_interval: int = DEFAULT_RESYNC_INTERVAL):
        self.state = state
        self.device = torch.device(device)
        self.resync_interval = max(int(resync_interval), 1)
        self._store: Optional[pops.PartialsStore] = None
        self._specs: Optional[pops.ClassSpecs] = None
        self._slots: Dict[tuple, int] = {}
        self._cap = 0
        self._n = 0
        self._synced_gen = 0
        self._struct_gen = 0
        self._vocab_key: Optional[tuple] = None
        self._since_full = 0
        self._epoch: Optional[epochs.EpochStamp] = None
        self._inval_gen = 0
        self.hit_rows_total = 0         # [class, row] entries served warm
        self.recomputed_rows_total = 0  # node rows re-evaluated
        self.full_recomputes = 0        # full store recomputes (any cause)
        self.rollbacks = 0              # speculation rollbacks
        self.delta_syncs = 0
        self.grows = 0                  # in-place node-axis grows/shrinks
        # syncs that raised and left their batch to cold statics (the
        # owner's catch counts them; not in stats(), whose keys are the
        # reference's)
        self.sync_failures = 0
        # False reseeds the whole store on any node-axis change (the
        # oracle the elastic-axis tests hold the in-place resize against)
        self.incremental_grow = True
        # kernel launches of the most recent sync ({name: count}: the
        # store's partials_eval, the spec rows' mirror_rows) and its
        # host->device bytes
        self.last_launches: Dict[str, int] = {}
        self.last_sync_bytes = 0
        self._spec_stage = device_ops.PinnedStage()
        self._idx_stage = device_ops.PinnedStage()

    # -- bookkeeping -------------------------------------------------------

    def stats(self) -> dict:
        return {
            "hit_rows_total": self.hit_rows_total,
            "recomputed_rows_total": self.recomputed_rows_total,
            "full_recomputes": self.full_recomputes,
            "rollbacks": self.rollbacks,
            "delta_syncs": self.delta_syncs,
            "slots": len(self._slots),
            "grows": self.grows,
        }

    def epoch(self) -> Optional[epochs.EpochStamp]:
        """The resident store's epoch stamp (None when invalidated,
        declined, or never synced)."""
        return self._epoch

    def speculation_point(self) -> tuple:
        """Bookmark the resident store for a speculative encode (caller
        holds the cache lock, as for the mirror's)."""
        return (
            self._store, self._specs, dict(self._slots), self._cap, self._n,
            self._synced_gen, self._struct_gen, self._vocab_key,
            self._since_full, self._epoch, self._inval_gen,
        )

    def rollback(self, point: tuple) -> None:
        """Restore a speculation_point() bookmark; the next sync
        re-evaluates every row dirtied since it.  Refused (stays
        invalidated) when invalidate() ran after the bookmark."""
        (store, specs, slots, cap, n, synced_gen, struct_gen, vocab_key,
         since_full, epoch_stamp, inval_gen) = point
        if inval_gen != self._inval_gen:
            epochs.note_rollback_blocked("partials")
            return
        self._store = store
        self._specs = specs
        self._slots = dict(slots)
        self._cap = cap
        self._n = n
        self._synced_gen = synced_gen
        self._struct_gen = struct_gen
        self._vocab_key = vocab_key
        self._since_full = since_full
        self._epoch = epoch_stamp
        self.rollbacks += 1

    def invalidate(self) -> None:
        """Drop the resident store AND the signature map: the next sync
        recomputes in full from its batch."""
        self._store = None
        self._specs = None
        self._slots = {}
        self._cap = 0
        self._n = 0
        self._synced_gen = 0
        self._struct_gen = 0
        self._vocab_key = None
        self._since_full = 0
        self._epoch = None
        self._inval_gen += 1

    def _vocab_watermark(self) -> tuple:
        """The builder's per-referenced-key expansion watermark: only
        vocabularies some encoded requirement expanded against count, so
        the hostname every new node interns does not flush warm rows."""
        return self.state.builder.expansion_watermark()

    # -- signature keying --------------------------------------------------

    @staticmethod
    def class_key(pods: schema.PodBatch, rep: int, meta: schema.SnapshotMeta) -> tuple:
        """Content signature of one class representative's STATIC spec —
        the inputs of the triple (name, selector, tolerations, ports,
        preferred terms), table indices replaced by the stable registry
        ids.  Requests are excluded: classes differing only in resources
        share one row."""
        si = int(pods.sel_idx[rep])
        mt = pods.pref_idx.shape[1]
        prefs = tuple(
            (
                meta.pref_stable[int(pods.pref_idx[rep, j])]
                if int(pods.pref_idx[rep, j]) >= 0 else -1,
                float(pods.pref_weight[rep, j]),
            )
            for j in range(mt)
        )
        return (
            bool(pods.valid[rep]),
            int(pods.name_id[rep]),
            meta.sel_stable[si] if si >= 0 else -1,
            np.ascontiguousarray(pods.tol_bits[:, rep, :]).tobytes(),
            np.ascontiguousarray(pods.tol_all[:, rep]).tobytes(),
            np.ascontiguousarray(pods.port_bits[rep]).tobytes(),
            prefs,
        )

    def _spec_row(self, snap: schema.Snapshot, rep: int) -> tuple:
        """One ClassSpecs row (host numpy) for a representative pod,
        byte-copied from the batch tables."""
        pods, sel, pref = snap.pods, snap.selectors, snap.preferred
        lim = self.state.builder.limits
        t_cap, e_cap, k_cap, mt = (
            lim.max_terms, lim.max_exprs, lim.max_ids_per_expr, lim.max_preferred,
        )
        si = int(pods.sel_idx[rep])
        if si >= 0:
            sel_ids = np.array(sel.expr_ids[si])
            sel_op = np.array(sel.expr_op[si])
            sel_slot = np.array(sel.expr_slot[si])
            sel_tv = np.array(sel.term_valid[si])
        else:
            sel_ids = np.full((t_cap, e_cap, k_cap), -1, dtype=np.int32)
            sel_op = np.zeros((t_cap, e_cap), dtype=np.int32)
            sel_slot = np.full((t_cap, e_cap), _DOMAIN_LABELS, dtype=np.int32)
            sel_tv = np.zeros(t_cap, dtype=bool)
        pref_ids = np.full((mt, e_cap, k_cap), -1, dtype=np.int32)
        pref_op = np.zeros((mt, e_cap), dtype=np.int32)
        pref_slot = np.full((mt, e_cap), _DOMAIN_LABELS, dtype=np.int32)
        pref_valid = np.zeros(mt, dtype=bool)
        pref_weight = np.zeros(mt, dtype=np.float32)
        for j in range(mt):
            pi = int(pods.pref_idx[rep, j])
            if pi < 0:
                continue
            pref_ids[j] = pref.expr_ids[pi]
            pref_op[j] = pref.expr_op[pi]
            pref_slot[j] = pref.expr_slot[pi]
            pref_valid[j] = True
            pref_weight[j] = pods.pref_weight[rep, j]
        return (
            bool(pods.valid[rep]), int(pods.name_id[rep]), si >= 0,
            sel_ids, sel_op, sel_slot, sel_tv,
            np.array(pods.tol_bits[:, rep, :]),
            np.array(pods.tol_all[:, rep]),
            np.array(pods.port_bits[rep]),
            pref_ids, pref_op, pref_slot, pref_valid, pref_weight,
        )

    @staticmethod
    def _stack_spec_rows(rows: List[tuple]) -> Dict[str, np.ndarray]:
        """Host spec rows stacked field by field (slots on each field's
        slot axis: dim 1 for the effect-major tol leaves)."""
        cols = list(zip(*rows))
        return {
            "valid": np.array(cols[0], dtype=bool),
            "name_id": np.array(cols[1], dtype=np.int32),
            "has_sel": np.array(cols[2], dtype=bool),
            "sel_ids": np.stack(cols[3]),
            "sel_op": np.stack(cols[4]),
            "sel_slot": np.stack(cols[5]),
            "sel_tv": np.stack(cols[6]),
            "tol_bits": np.stack(cols[7], axis=1),
            "tol_all": np.stack(cols[8], axis=1),
            "port_bits": np.stack(cols[9]),
            "pref_ids": np.stack(cols[10]),
            "pref_op": np.stack(cols[11]),
            "pref_slot": np.stack(cols[12]),
            "pref_valid": np.stack(cols[13]),
            "pref_weight": np.stack(cols[14]),
        }

    def _empty_specs(self, cap: int) -> Dict[str, np.ndarray]:
        lim = self.state.builder.limits
        t_cap, e_cap, k_cap, mt = (
            lim.max_terms, lim.max_exprs, lim.max_ids_per_expr, lim.max_preferred,
        )
        return {
            "valid": np.zeros(cap, dtype=bool),
            "name_id": np.full(cap, -1, dtype=np.int32),
            "has_sel": np.zeros(cap, dtype=bool),
            "sel_ids": np.full((cap, t_cap, e_cap, k_cap), -1, dtype=np.int32),
            "sel_op": np.zeros((cap, t_cap, e_cap), dtype=np.int32),
            "sel_slot": np.full((cap, t_cap, e_cap), _DOMAIN_LABELS, dtype=np.int32),
            "sel_tv": np.zeros((cap, t_cap), dtype=bool),
            "tol_bits": np.zeros((3, cap, lim.taint_words), dtype=np.uint32),
            "tol_all": np.zeros((3, cap), dtype=bool),
            "port_bits": np.zeros((cap, lim.port_words), dtype=np.uint32),
            "pref_ids": np.full((cap, mt, e_cap, k_cap), -1, dtype=np.int32),
            "pref_op": np.zeros((cap, mt, e_cap), dtype=np.int32),
            "pref_slot": np.full((cap, mt, e_cap), _DOMAIN_LABELS, dtype=np.int32),
            "pref_valid": np.zeros((cap, mt), dtype=bool),
            "pref_weight": np.zeros((cap, mt), dtype=np.float32),
        }

    # -- the sync protocol -------------------------------------------------

    def sync(self, cluster: schema.ClusterTensors, snap: schema.Snapshot,
             meta: schema.SnapshotMeta,
             cluster_epoch: Optional[epochs.EpochStamp] = None
             ) -> Optional[pops.ClassStatics]:
        """Warm statics for this batch, or None when the cache declines
        (more live classes than MAX_SLOTS).  `cluster` is the mirror's
        resident tensors for the state's CURRENT generation — the tensors
        the solve consumes; `snap` is still host numpy; `cluster_epoch`
        is the mirror's stamp, whose lineage the store's stamp inherits."""
        state = self.state
        class_rep = np.asarray(snap.pods.class_rep)
        c_dim = class_rep.shape[0]
        n_real = int((class_rep >= 0).sum())
        self.last_launches = {}
        self.last_sync_bytes = 0
        act = faults.fire("solve.partials", classes=n_real)
        keys = [self.class_key(snap.pods, int(class_rep[c]), meta) for c in range(n_real)]
        n = int(cluster.allocatable.shape[0])
        vkey = self._vocab_watermark()

        stale = (
            self._store is None
            or self._struct_gen < state.struct_generation
            or self._vocab_key != vkey
            or (self._n != n and not self.incremental_grow)
        )
        # distinct first-seen keys (classes differing only in requests
        # share one slot)
        misses = list(dict.fromkeys(k for k in keys if k not in self._slots))
        needed = len(self._slots) + len(misses)
        if needed > self._cap:
            if needed > self.MAX_SLOTS:
                return None  # more live classes than the cache may hold
            stale = True  # reallocation: reseed from this batch
        if not stale and self._since_full >= self.resync_interval:
            stale = True  # periodic full recompute

        dirty = None
        if not stale:
            static_idx, usage_idx = state.dirty_rows(self._synced_gen, n)
            dirty = np.union1d(static_idx, usage_idx).astype(np.int32)
            if dirty.shape[0] > self.FULL_SYNC_FRACTION * n:
                stale = True
        if stale:
            slot_arr = self._full_reset(cluster, snap, keys, n, vkey, c_dim)
        else:
            slot_arr = self._delta(cluster, snap, keys, misses, dirty, n, c_dim)
        self._epoch = epochs.EpochStamp(
            "partials", self._struct_gen, self._vocab_key, self._synced_gen,
            cluster_epoch.buffer_id if cluster_epoch is not None else 0,
        )
        if act == faults.CORRUPT:
            # poison the RESIDENT partials (a CORRUPT fault poisons
            # content, not epochs): the warm solve's scores go NaN, the
            # decode health check trips, and the retry path invalidates
            # this cache and recomputes in full
            self._store = _poison_aff(self._store)
        return pops.gather_statics(self._store, slot_arr)

    def _slot_order(self, keys: List[tuple], c_dim: int) -> np.ndarray:
        """Each batch class's slot ([C]; padded classes alias class 0's)."""
        return np.array([self._slots[keys[c if c < len(keys) else 0]]
                         for c in range(c_dim)], dtype=np.int32)

    def _launched(self, name: str) -> None:
        self.last_launches[name] = self.last_launches.get(name, 0) + 1

    def _upload(self, *arrs: np.ndarray) -> List[torch.Tensor]:
        outs = device_ops.pack_leaves(arrs, self._idx_stage, self.device)
        self.last_sync_bytes += self._idx_stage.bytes_sent
        return outs

    def _delta(self, cluster, snap, keys, misses, dirty, n, c_dim) -> torch.Tensor:
        """The warm path: the reference's resize, insert and refresh, with
        its counts, as one store update — one `partials_eval` launch over
        the union of the grown columns, the dirty columns and the missed
        slots, against the current cluster and the final specs (each of
        the reference's steps evaluates the same cluster, and a missed
        slot's row is overwritten whole)."""
        state = self.state
        class_rep = np.asarray(snap.pods.class_rep)
        miss_set = set(misses)
        hits = sum(1 for k in keys if k not in miss_set)
        miss_rows, miss_idx = [], []
        if misses:
            reps_by_key = {}
            for c, k in enumerate(keys):
                reps_by_key.setdefault(k, int(class_rep[c]))
            for k in misses:
                slot = len(self._slots)
                self._slots[k] = slot
                miss_rows.append(self._spec_row(snap, reps_by_key[k]))
                miss_idx.append(slot)
        old_n = self._n
        grow_idx = np.arange(old_n, n, dtype=np.int32)
        miss_arr = np.asarray(miss_idx, dtype=np.int32)
        cols = np.union1d(dirty, grow_idx).astype(np.int32)
        miss_d, cols_d, slots_d = self._upload(miss_arr, cols, self._slot_order(keys, c_dim))
        if misses:
            rows = self._stack_spec_rows(miss_rows)
            self._specs = pops.set_spec_rows(self._specs, rows, miss_arr, self._spec_stage)
            self.last_sync_bytes += self._spec_stage.bytes_sent
            self._launched("mirror_rows")
        if old_n != n or misses or cols.shape[0]:
            self._store = pops.update_store(self._store, self._specs, cluster,
                                            miss_d if misses else None,
                                            cols_d if cols.shape[0] else None)
            self._launched("partials_eval")
        if old_n != n:
            # elastic node axis: the columns resized in the same update;
            # the grown ones evaluated against the grown cluster
            if n > old_n:
                self.recomputed_rows_total += int(grow_idx.shape[0])
            self.grows += 1
            self._n = n
        if misses:
            self.recomputed_rows_total += len(miss_idx) * n
        if dirty.shape[0]:
            self.recomputed_rows_total += int(dirty.shape[0])
        self.hit_rows_total += max(hits, 0) * (n - int(dirty.shape[0]))
        self.delta_syncs += 1
        self._since_full += 1
        self._synced_gen = state.generation
        return slots_d

    def _full_reset(self, cluster, snap, keys, n, vkey, c_dim) -> torch.Tensor:
        """Reseed from this batch's classes and recompute the whole store
        in one launch (first sync, struct/vocab invalidation, over-fraction
        delta, periodic resync, reallocation)."""
        state = self.state
        class_rep = np.asarray(snap.pods.class_rep)
        self._slots = {}
        rows: List[tuple] = []
        for c, k in enumerate(keys):
            if k in self._slots:
                continue
            self._slots[k] = len(rows)
            rows.append(self._spec_row(snap, int(class_rep[c])))
        cap = min(max(vb.pad_dim(max(len(rows), 1), self.MIN_SLOTS), self._cap),
                  self.MAX_SLOTS)
        specs = self._empty_specs(cap)
        if rows:
            for f, v in self._stack_spec_rows(rows).items():
                if f in pops.SPEC_AX1:
                    specs[f][:, : v.shape[1]] = v
                else:
                    specs[f][: v.shape[0]] = v
        leaves = device_ops.pack_leaves(
            [specs[f] for f in pops.ClassSpecs._fields], self._spec_stage, self.device)
        self.last_sync_bytes += self._spec_stage.bytes_sent
        self._specs = pops.ClassSpecs(*leaves)
        self._store = pops.eval_store(cluster, self._specs)
        self._launched("partials_eval")
        self._cap = cap
        self._n = n
        self._synced_gen = state.generation
        self._struct_gen = state.struct_generation
        self._vocab_key = vkey
        self._since_full = 0
        self.full_recomputes += 1
        self.recomputed_rows_total += len(rows) * n
        return self._upload(self._slot_order(keys, c_dim))[0]

    # -- the oracle-parity gate --------------------------------------------

    def verify(self, cluster, snap: Optional[schema.Snapshot] = None) -> bool:
        """Recompute every slot's row from scratch and compare with the
        resident store (the parity gate; not on the hot path).  A mismatch
        invalidates the cache and returns False."""
        if self._store is None or self._specs is None:
            return True
        want = pops.eval_store(cluster, self._specs)
        for f, w, g in zip(pops.PartialsStore._fields, want, self._store):
            ok = torch.equal(w, g) and (f == "sfeas" or not torch.isnan(g).any())
            if not ok:
                logging.getLogger(__name__).warning(
                    "partials parity gate tripped on %s: forcing full recompute", f)
                self.invalidate()
                return False
        return True
