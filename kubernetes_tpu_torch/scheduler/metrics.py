"""Scheduler metrics — the reference's Prometheus surface reduced to an
in-process registry (pkg/scheduler/metrics/metrics.go:89-150,
component-base/metrics wrappers): a copy of
kubernetes_tpu/scheduler/metrics.py, the whole Registry.  Metric *names*
are kept identical so the scheduler_perf collectors scrape the same
series the reference's do.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Tuple

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


class HistogramVec:
    """A labeled histogram family (component-base metrics HistogramVec):
    one child Histogram per label tuple, created lazily.  snapshot()
    flattens children under `name{label}` so /metrics and collectors see
    plain histograms."""

    def __init__(self, name: str, buckets: Tuple[float, ...] = _DEF_BUCKETS):
        self.name = name
        self.buckets = buckets
        self._children: Dict[Tuple[str, ...], Histogram] = {}
        self._lock = threading.Lock()

    def labels(self, *labels: str) -> Histogram:
        with self._lock:
            h = self._children.get(labels)
            if h is None:
                child_name = (
                    f'{self.name}{{extension_point="{"/".join(labels)}"}}'
                    if labels
                    else self.name
                )
                h = self._children[labels] = Histogram(
                    child_name, self.buckets
                )
            return h

    def children(self) -> Dict[Tuple[str, ...], Histogram]:
        with self._lock:
            return dict(self._children)


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
        """Sum over every label tuple — equal to the bare value for
        unlabeled gauges; the cross-tier total for labeled ones (what
        the perf collectors report for pending_pods)."""
        with self._lock:
            return sum(self._v.values())


class Registry:
    """One scheduler's metric set, by reference name."""

    def __init__(self):
        # metrics.go:89 scheduling_attempt_duration_seconds
        self.scheduling_attempt_duration = Histogram(
            "scheduler_scheduling_attempt_duration_seconds"
        )
        # metrics.go SchedulingAlgorithmLatency — PER POD: one device
        # dispatch solves a whole batch, so each pod is observed at
        # solve_duration / batch_size (the comparable per-attempt cost;
        # the whole-batch number lives in batch_solve_duration below)
        self.scheduling_algorithm_duration = Histogram(
            "scheduler_scheduling_algorithm_duration_seconds"
        )
        # OUR batch-level metric (no reference analogue): one observation
        # per device solve, including any first-batch kernel build
        self.batch_solve_duration = Histogram(
            "scheduler_batch_solve_duration_seconds"
        )
        # OUR pipeline metrics (no reference analogue — the reference's
        # binding cycle is per-pod goroutines, ours is batched waves):
        # one full cycle of the solve stage, pop -> solve -> assume ->
        # wave dispatch (commit happens off-thread and is NOT included)
        self.schedule_batch_duration = Histogram(
            "scheduler_schedule_batch_duration_seconds"
        )
        # one observation per bind wave the binding stage commits
        self.commit_wave_duration = Histogram(
            "scheduler_commit_wave_duration_seconds"
        )
        # pods per committed wave (coalescing effectiveness under churn)
        self.commit_wave_size = Histogram(
            "scheduler_commit_wave_size_pods",
            buckets=tuple(float(2 ** i) for i in range(13)),
        )
        # seconds of each wave's commit that ran WHILE a device solve was
        # in flight — the pipeline's realized solve/commit overlap; a
        # healthy pipeline keeps this close to commit_wave_duration
        self.pipeline_overlap = Histogram(
            "scheduler_pipeline_overlap_seconds"
        )
        # one observation per per-store-shard sub-wave the binder
        # commits (the sharded store's per-shard commit durations)
        self.commit_subwave_duration = Histogram(
            "scheduler_commit_subwave_duration_seconds"
        )
        # seconds of sub-wave commit work that ran CONCURRENTLY with
        # another sub-wave of the same wave (sum of sub-wave durations
        # minus the wave's commit wall time) — the realized cross-shard
        # commit overlap; 0 means sub-waves serialized
        self.commit_subwave_overlap = Histogram(
            "scheduler_commit_subwave_overlap_seconds"
        )
        # OUR solve-side pipeline metrics (no reference analogue):
        # waves per wavefront-routed greedy solve (ops.assign wavefront:
        # the scan's P sequential steps collapse to ~P/W)
        self.solve_wave_count = Histogram(
            "scheduler_solve_wave_count",
            buckets=tuple(float(2 ** i) for i in range(13)),
        )
        # fallbacks per wavefront solve: serialized (coupled) waves plus
        # per-pod exact re-evaluations (fit flips) — a high count means
        # the partitioner is mis-planning for this workload
        self.solve_wave_fallbacks = Histogram(
            "scheduler_solve_wave_fallbacks",
            buckets=tuple(float(2 ** i) for i in range(13)),
        )
        # wall seconds of solver executable compiles: synchronous
        # first-shape compiles observed on the dispatch path plus
        # background prewarm-pool compiles (SolverPrewarmPool)
        self.solve_compile_duration = Histogram(
            "scheduler_solve_compile_duration_seconds"
        )
        # seconds of device solve + readback hidden behind host work
        # (the pop window) per group — the realized solve-side overlap;
        # a healthy pipeline keeps this close to the device solve time
        self.decode_overlap = Histogram(
            "scheduler_decode_overlap_seconds"
        )
        # pod_scheduling_sli_duration_seconds (end-to-end incl. requeues)
        self.pod_scheduling_sli_duration = Histogram(
            "scheduler_pod_scheduling_sli_duration_seconds"
        )
        # labeled per extension point (PreEnqueue/Permit/PreBind/...),
        # observed by the Framework runners (framework.py)
        self.framework_extension_point_duration = HistogramVec(
            "scheduler_framework_extension_point_duration_seconds"
        )
        # -- degraded-mode / robustness surface (docs/robustness.md) ------
        # circuit-breaker state: 0 closed, 1 half-open, 2 open
        self.solve_breaker_state = Gauge("scheduler_solve_breaker_state")
        # running total of batches solved on the host fallback path
        # (mirrored from the breaker each cycle — monotonic)
        self.solve_fallback_total = Gauge("scheduler_solve_fallback_total")
        # binding-worker restarts by the watchdog (binder supervision)
        self.binder_restarts = Counter("scheduler_binder_restarts_total")
        # waves that failed twice and were split into per-pod commits
        self.binder_poison_waves = Counter(
            "scheduler_binder_poison_waves_total"
        )
        # corrupt journal records replay survived (mirrored from the
        # store: skipped mid-file lines + truncated torn tails)
        self.journal_recovered_records = Gauge(
            "scheduler_journal_recovered_records"
        )
        # -- crash-restart recovery surface (docs/robustness.md) ----------
        # wall time the store's last recovery took (snapshot load +
        # journal suffix replay), mirrored from the store
        self.store_recovery_duration_ms = Gauge(
            "scheduler_store_recovery_duration_ms"
        )
        # objects the last recovery loaded from the checkpoint snapshot
        self.store_snapshot_records = Gauge(
            "scheduler_store_snapshot_records"
        )
        # journal records the last recovery replayed past the snapshot
        self.store_journal_suffix_records = Gauge(
            "scheduler_store_journal_suffix_records"
        )
        # checkpoints the store has taken (growth/interval/manual)
        self.store_checkpoints_total = Gauge(
            "scheduler_store_checkpoints_total"
        )
        # (kind, namespace)-hash shards the store splits its
        # locks/journals/watch fan-out across (1 = unsharded legacy)
        self.store_shard_count = Gauge("scheduler_store_shard_count")
        # bind waves the store rejected because the committing leader's
        # fence token was stale (a deposed leader's late wave)
        self.fenced_writes_total = Gauge("scheduler_fenced_writes_total")
        # leadership/restart reconciliations the scheduler ran (start,
        # takeover, reacquisition)
        self.leader_reconcile_total = Counter(
            "scheduler_leader_reconcile_total"
        )
        # kernel libraries built or loaded after the first batch
        # (analysis/retrace.py), mirrored each cycle; steady-state
        # increments mean a kernel build landed mid-run
        self.solve_retrace_total = Gauge("scheduler_solve_retrace_total")
        # -- sharded-solve surface (docs/scheduler_loop.md mesh mode) ------
        # mesh size the solver shards the node axis over (0 single-chip)
        self.solve_shard_count = Gauge("scheduler_solve_shard_count")
        # full mirror re-uploads (struct-generation changes, shape
        # changes, over-fraction deltas) — mirrored from
        # DeviceClusterMirror; steady state should not move
        self.mirror_resync_total = Gauge("scheduler_mirror_resync_total")
        # real dirty rows scattered by mirror delta syncs (running
        # total) — per-batch host→device transfer is O(this delta), not
        # O(N); bench c7 gates on it
        self.mirror_delta_rows = Gauge("scheduler_mirror_delta_rows")
        # batches a configured mesh could not solve sharded (padded node
        # bucket smaller than the mesh) and routed single-chip instead
        self.sharded_solve_fallbacks = Gauge(
            "scheduler_sharded_solve_fallbacks"
        )
        # -- elastic node axis (docs/scheduler_loop.md) --------------------
        # pad-bucket crossings the mirror absorbed with an in-place
        # resident resize (device-side pad/slice) instead of a full
        # re-upload — autoscaler growth should move THIS, not resyncs
        self.mirror_grow_total = Gauge("scheduler_mirror_grow_total")
        # node-axis rows added by in-place grows (running total): the
        # bucket-crossing transfer is O(this delta + dirty rows), not
        # O(N) — bench c12 gates on it
        self.mirror_grow_rows = Gauge("scheduler_mirror_grow_rows")
        # the pad bucket ClusterState currently exposes (post-hysteresis:
        # rises eagerly, falls only after bucketShrinkDwell generations)
        self.node_axis_bucket = Gauge("scheduler_node_axis_bucket")
        # deferred-compaction invocations that did work (trim or move)
        self.compactions_total = Gauge("scheduler_compactions_total")
        # rows relocated by deferred compaction (running total; bounded
        # per invocation by compactionBatchRows — a drain is O(live))
        self.compaction_moved_rows = Gauge(
            "scheduler_compaction_moved_rows"
        )
        # -- incremental-solve surface (docs/scheduler_loop.md) ------------
        # [class, node-row] partials entries served from the resident
        # cache instead of re-evaluated (running total, mirrored from
        # the PartialsCache each cycle)
        self.partials_hit_rows = Gauge("scheduler_partials_hit_rows")
        # node rows re-evaluated by the warm path: dirty-row refreshes
        # plus full rows for first-seen classes — per-batch recompute is
        # O(this delta), not O(C x N)
        self.partials_recomputed_rows = Gauge(
            "scheduler_partials_recomputed_rows"
        )
        # full partials-store recomputes (first sync, struct/vocab
        # invalidation, periodic resync, parity-gate trips); steady
        # state should not move outside the periodic interval
        self.partials_full_recomputes = Gauge(
            "scheduler_partials_full_recomputes_total"
        )
        # speculation rollbacks of the resident partials (invalidated
        # speculative batches — rolled back alongside the mirror)
        self.partials_rollbacks = Gauge(
            "scheduler_partials_rollbacks_total"
        )
        # graftcoh runtime epoch auditor (analysis/epochs.py), mirrored
        # each cycle when GRAFTLINT_COHERENCE=1 arms it (0 disarmed):
        # consume-time resident-epoch audits performed and violations
        # recorded — chaos and BENCH_STRICT runs gate violations == 0
        # with audits > 0
        self.coherence_audits = Gauge("scheduler_coherence_audits_total")
        self.coherence_violations = Gauge(
            "scheduler_coherence_violations_total"
        )
        # graftobl runtime exactly-once ledger (analysis/ledger.py),
        # mirrored each cycle when GRAFTLINT_OBLIGATIONS=1 arms it (all
        # 0 disarmed): obligations tracked, leaked past discharge, and
        # double-discharged — chaos and BENCH_STRICT runs gate leaks ==
        # double-discharges == 0
        self.obligations_tracked = Gauge(
            "scheduler_obligations_tracked_total"
        )
        self.obligation_leaks = Gauge("scheduler_obligation_leaks_total")
        self.obligation_double_discharge = Gauge(
            "scheduler_obligation_double_discharge_total"
        )
        # -- overload-protection surface (docs/robustness.md) -------------
        # deepest per-watcher coalescing backlog at the last cycle mirror
        self.watch_queue_depth = Gauge("scheduler_watch_queue_depth")
        # events compacted away by per-watcher coalescing (latest-wins
        # MODIFIED runs + ADDED/DELETED annihilation), store mirror
        self.watch_coalesced_total = Gauge("scheduler_watch_coalesced_total")
        # watchers expired (bookmark rv + forced relist) after their
        # coalescing buffer overflowed — the survivable-overload path
        self.watch_expired_total = Gauge("scheduler_watch_expired_total")
        # legacy destructive slow-watcher kills, labeled per kind; the
        # backpressured fan-out never performs them (benches assert 0)
        self.watch_terminated_total = Gauge("scheduler_watch_terminated_total")
        # the adaptive accumulation window currently in force
        self.batch_window_ms = Gauge("scheduler_batch_window_ms")
        # overload controller level: 0 healthy / 1 shed background /
        # 2 severe (window pinned wide)
        self.overload_level = Gauge("scheduler_overload_level")
        # background work units (preemption dry-runs) the overload
        # controller deferred instead of letting cycles pile up
        self.overload_shed_total = Counter("scheduler_overload_shed_total")
        # schedule_attempts_total{result="scheduled|unschedulable|error"}
        self.schedule_attempts = Counter("scheduler_schedule_attempts_total")
        # pending_pods{queue="active|backoff|unschedulable|gated"}
        self.pending_pods = Gauge("scheduler_pending_pods")
        self.preemption_victims = Histogram("scheduler_preemption_victims")
        self.preemption_attempts = Counter("scheduler_preemption_attempts_total")
        # -- batched-preemption surface (docs/scheduler_loop.md) -----------
        # wall seconds of one PostFilter pass's shared encode + batched
        # [P, N, K] device dry-run + static-feasibility dispatch (one
        # observation per pass; the per-pod walk this replaced paid this
        # cost per failed pod)
        self.preemption_solve_duration = Histogram(
            "scheduler_preemption_solve_duration_seconds"
        )
        # failed pods sharing one batched preemption solve
        self.preemption_batch_size = Histogram(
            "scheduler_preemption_batch_size_pods",
            buckets=tuple(float(2 ** i) for i in range(13)),
        )
        # wavefront-style conflict serializations: (preemptor, node)
        # pairs recomputed from live state because an earlier preemptor
        # of the same pass evicted there (the coupling discipline that
        # keeps batched == sequential)
        self.preemption_conflict_serializations = Counter(
            "scheduler_preemption_conflict_serializations_total"
        )
        # feasible candidates whose minimal eviction set would violate a
        # PodDisruptionBudget (ranked last — minNumPDBViolatingScoreFunc)
        self.preemption_pdb_blocked_total = Counter(
            "scheduler_preemption_pdb_blocked_total"
        )
        # -- pipelined multi-lane surface (docs/scheduler_loop.md) ---------
        # concurrent profile lanes in force (1 = the serial loop)
        self.lane_count = Gauge("scheduler_lane_count")
        # batches dispatched SPECULATIVELY — encode/solve run while an
        # earlier wave was still committing, over its assumed placements
        self.speculative_solves_total = Counter(
            "scheduler_speculative_solves_total"
        )
        # speculative batches invalidated (a wave they solved over
        # failed/was fenced after their dispatch) and requeued whole
        self.misspeculation_total = Counter("scheduler_misspeculation_total")
        # per streamed sub-wave: milliseconds between its hand-off to
        # the commit pool and the completion of the whole group's
        # staging — the commit lead streaming bought that sub-wave
        self.subwave_stream_lead_ms = Histogram(
            "scheduler_subwave_stream_lead_ms",
            buckets=tuple(0.1 * 2 ** i for i in range(15)),
        )
        # -- TPU slice-topology surface (docs/scheduler_loop.md) -----------
        # cluster-wide fragmentation after the most recent slice-family
        # solve: 1 - (per-slice largest placeable free cube volumes /
        # free devices); 0 = every free device in a maximal cube
        self.fragmentation_score = Gauge("scheduler_fragmentation_score")
        # gangs that anchored a slice carve-out (running total across
        # solves; CoschedulingPermit-released gangs count through the
        # two outcome counters below instead)
        self.slice_carveouts = Counter("scheduler_slice_carveouts_total")
        # shaped gangs fully placed but NOT inside their carve-out
        # (prefer-mode scattered fallbacks; require mode keeps this 0)
        self.slice_carveout_fallbacks = Counter(
            "scheduler_slice_carveout_fallbacks_total"
        )
        # shaped gangs fully placed inside their carved sub-cuboid
        self.gang_contiguous_placements = Counter(
            "scheduler_gang_contiguous_placements_total"
        )
        # -- columnar host plane (docs/scheduler_loop.md host plane) -------
        # pod rows encoded per second by the most recent snapshot build
        # (the columnar spec-row fast path; the host encode's share of
        # the sustained-rate budget)
        self.encode_rows_per_s = Gauge("scheduler_encode_rows_per_s")
        # running bytes of framed journal writes (one serialization +
        # one crc + one write/fsync per commit sub-wave), store mirror
        self.journal_frame_bytes = Gauge("scheduler_journal_frame_bytes")
        # mean events per watch fan-out chunk (batched per-watcher
        # hand-off under one publish-lock hold), store mirror
        self.fanout_chunk_size = Gauge("scheduler_fanout_chunk_size")
        # the c6s ramp hunt's capacity knee: highest arrival rate whose
        # backlog stayed bounded (0 until a ramp-mode bench run sets it)
        self.c6s_arrival_knee = Gauge(
            "scheduler_c6s_arrival_knee_pods_per_s"
        )
        # -- serving plane (docs/robustness.md serving-plane section) ------
        # effective APF seats across all priority levels (shrinks under
        # adaptive pressure, recovers with hysteresis) — mirrored from
        # the replica set's shared gate each cycle
        self.apf_seats_current = Gauge("scheduler_apf_seats_current")
        # requests shed by APF across all levels (429 + Retry-After)
        self.apf_rejected_total = Gauge("scheduler_apf_rejected_total")
        # watch streams expired by the per-watcher HTTP write deadline
        # (stalled TCP consumers), cumulative across killed replicas
        self.server_watch_write_stalls_total = Gauge(
            "scheduler_server_watch_write_stalls_total"
        )
        # replica instances killed out of the serving set (clients fail
        # over to the survivors and re-watch from their last rv)
        self.replica_failovers_total = Gauge(
            "scheduler_replica_failovers_total"
        )
        # -- graftsched surface (docs/static_analysis.md) ------------------
        # deterministic interleaving schedules explored and yield points
        # scheduled across them (analysis/interleave.py TOTALS, mirrored
        # via interleave.mirror_metrics — make race / --interleave runs)
        self.interleave_schedules_total = Gauge(
            "scheduler_interleave_schedules_total"
        )
        self.interleave_yield_points = Gauge(
            "scheduler_interleave_yield_points"
        )
        # findings of the static atomicity pass at the last mirrored
        # lint run (tree-clean CI keeps this 0; mirror_metrics sets it)
        self.atomicity_findings = Gauge("scheduler_atomicity_findings")

    def snapshot(self) -> Dict[str, object]:
        """Name → metric, for collectors.  HistogramVec children appear
        under their labeled names (`name{extension_point="..."}`)."""
        out: Dict[str, object] = {}
        for m in vars(self).values():
            if isinstance(m, (Histogram, Counter, Gauge)):
                out[m.name] = m
            elif isinstance(m, HistogramVec):
                for child in m.children().values():
                    out[child.name] = child
        return out
