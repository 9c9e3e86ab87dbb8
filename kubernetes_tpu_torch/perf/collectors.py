"""Throughput and metrics collectors emitting DataItems: a copy of
kubernetes_tpu/perf/collectors.py over this package's scheduler metrics
Registry.

Reference: test/integration/scheduler_perf/util.go:364-475
(throughputCollector sampling scheduled-pod deltas on a fixed interval;
collect() summarizing Average/Perc50/90/95/99) and
scheduler_perf.go:100-112 (metricsCollector scraping histograms).
DataItem JSON shape matches the reference's {data, unit, labels} so
perf-dash-style tooling can ingest either.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional

from ..api import store as st
from ..scheduler.metrics import Counter, Gauge, Histogram, Registry


class DataItem(dict):
    """{"data": {...}, "unit": str, "labels": {...}} — util.go DataItem."""

    def __init__(self, data: Dict[str, float], unit: str, labels: Dict[str, str]):
        super().__init__(data=data, unit=unit, labels=labels)


def _percentiles(sorted_vals: List[float]) -> Dict[str, float]:
    n = len(sorted_vals)
    if n == 0:
        return {}
    pick = lambda q: sorted_vals[max(0, int(math.ceil(n * q / 100)) - 1)]
    return {
        "Average": sum(sorted_vals) / n,
        "Perc50": pick(50),
        "Perc90": pick(90),
        "Perc95": pick(95),
        "Perc99": pick(99),
    }


class ThroughputCollector:
    """Samples scheduled-pod count deltas every `interval` seconds in a
    thread (util.go:364 run()); zero-delta intervals are coalesced into
    the next non-zero sample, skipped-interval style."""

    def __init__(
        self,
        store: st.Store,
        namespaces: Optional[List[str]] = None,
        interval: float = 0.1,
        labels: Optional[Dict[str, str]] = None,
        pod_names: Optional[set] = None,
        lister=None,
    ):
        self.store = store
        self.namespaces = namespaces
        self.interval = interval
        self.labels = dict(labels or {})
        # When set, only these pods count — preemption workloads DELETE
        # bound victims, so counting every scheduled pod in the namespace
        # would produce negative deltas.
        self.pod_names = pod_names
        # cheap pod source (e.g. an informer cache's list): store.list
        # deep-copies every object per call, and a 100ms sampling loop
        # over thousands of pods GIL-starves the scheduler it measures
        self.lister = lister or (lambda: store.list("Pod")[0])
        self.samples: List[float] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _scheduled_count(self) -> int:
        pods = self.lister()
        return sum(
            1
            for p in pods
            if p.spec.node_name
            and (self.namespaces is None or p.meta.namespace in self.namespaces)
            and (self.pod_names is None or p.meta.name in self.pod_names)
        )

    def _run(self) -> None:
        last = self._scheduled_count()
        last_t = time.monotonic()
        self._baseline = last
        skipped = 0
        while not self._stop.wait(self.interval):
            now = time.monotonic()
            cur = self._scheduled_count()
            delta = cur - last
            if delta == 0:
                if cur == last and last == self._baseline:
                    # still idle before the run's first placement: slide
                    # the window start so the FIRST non-zero delta is
                    # measured over one interval, not the whole idle
                    # lead-in.  The old first-observation reset discarded
                    # that delta entirely — a burst that completed inside
                    # one interval produced NO samples and the summary
                    # reported Average=0.0 (PreemptionBasic/500Nodes).
                    last_t = now
                else:
                    skipped += 1  # mid-run stall: coalesce into the next
                continue
            throughput = delta / max(now - last_t, 1e-9)
            for _ in range(skipped + 1):
                self.samples.append(throughput)
            last, last_t, skipped = cur, now, 0
        # final sub-window sample: a burst that finished after the last
        # tick (or entirely between start and stop) would otherwise be
        # dropped on the floor
        now = time.monotonic()
        cur = self._scheduled_count()
        if cur - last > 0:
            self.samples.append((cur - last) / max(now - last_t, 1e-9))

    def start(self) -> "ThroughputCollector":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)

    def collect(self) -> List[DataItem]:
        vals = sorted(self.samples)
        if not vals:
            return []
        labels = dict(self.labels)
        labels["Metric"] = "SchedulingThroughput"
        return [DataItem(_percentiles(vals), "pods/s", labels)]


def histogram_baseline(registry: Registry) -> Dict[str, tuple]:
    """Snapshot histogram counters so a later MetricsCollector can report
    the measured WINDOW only — the reference's metricsCollector inits at
    the collectMetrics op's start and diffs at collect
    (scheduler_perf.go:100-112); without the diff the summary mixes the
    init-phase and warmup attempts into the measured percentiles."""
    out: Dict[str, tuple] = {}
    for name, m in registry.snapshot().items():
        if isinstance(m, Histogram):
            with m._lock:
                out[name] = (list(m.counts), m.total, m.n)
    return out


class MetricsCollector:
    """Extracts percentile summaries from the scheduler's histograms by
    reference metric name (scheduler_perf.go:100-112)."""

    # seconds-unit histograms, reported as ms percentiles.  The three
    # export surfaces below are reconciled against scheduler/metrics.py
    # Registry by the reference's registry pass (analysis/registry.py, run
    # over this package by tests/test_torch_imports.py): every name here
    # must exist there, and every Registry metric must appear in exactly
    # one of these tuples.
    DEFAULT_METRICS = (
        "scheduler_scheduling_attempt_duration_seconds",
        "scheduler_scheduling_algorithm_duration_seconds",
        "scheduler_batch_solve_duration_seconds",
        "scheduler_pod_scheduling_sli_duration_seconds",
        # solve-side pipeline: exposed compile time and the readback
        # hidden behind host work (scheduler/metrics.py)
        "scheduler_solve_compile_duration_seconds",
        "scheduler_decode_overlap_seconds",
        # solve/bind pipeline stages (docs/scheduler_loop.md) — were
        # registered but never exported (graftlint registry drift)
        "scheduler_schedule_batch_duration_seconds",
        "scheduler_commit_wave_duration_seconds",
        "scheduler_pipeline_overlap_seconds",
        # sharded-store commit fan-out: per-shard sub-wave durations and
        # the realized cross-shard commit overlap (docs/scheduler_loop.md)
        "scheduler_commit_subwave_duration_seconds",
        "scheduler_commit_subwave_overlap_seconds",
        # batched PostFilter: one shared encode + [P, N, K] dry-run per
        # preemption pass (docs/scheduler_loop.md preemption section)
        "scheduler_preemption_solve_duration_seconds",
    )

    # count-unit histograms: reported as raw percentiles (no ms scaling —
    # wave/batch sizes and victim counts, not durations)
    COUNT_METRICS = (
        "scheduler_commit_wave_size_pods",
        "scheduler_solve_wave_count",
        "scheduler_solve_wave_fallbacks",
        "scheduler_preemption_victims",
        # failed pods sharing one batched preemption dry-run
        "scheduler_preemption_batch_size_pods",
        # commit lead (ms) each streamed sub-wave gained over the
        # whole-wave hand-off (docs/scheduler_loop.md multi-lane cycle)
        "scheduler_subwave_stream_lead_ms",
    )

    # breaker / supervision / journal-recovery scalars (gauges and
    # counters, reported as one Total value — docs/robustness.md), plus
    # the attempt/pending totals that were registered but unexported
    SCALAR_METRICS = (
        "scheduler_solve_breaker_state",
        "scheduler_solve_fallback_total",
        # solver XLA traces seen by the retrace tracker (armed runs only)
        "scheduler_solve_retrace_total",
        # sharded multichip solve: mesh size, device-mirror transfer
        # accounting (resyncs / delta rows), and single-chip fallbacks
        # (docs/scheduler_loop.md mesh mode)
        "scheduler_solve_shard_count",
        "scheduler_mirror_resync_total",
        "scheduler_mirror_delta_rows",
        "scheduler_sharded_solve_fallbacks",
        # elastic node axis: in-place resident grows (vs full resyncs),
        # the rows they added, the hysteresis-governed pad bucket, and
        # deferred-compaction work (docs/scheduler_loop.md)
        "scheduler_mirror_grow_total",
        "scheduler_mirror_grow_rows",
        "scheduler_node_axis_bucket",
        "scheduler_compactions_total",
        "scheduler_compaction_moved_rows",
        # incremental O(changes) solving: resident-partials hit/recompute
        # accounting, full recomputes, and speculation rollbacks
        # (docs/scheduler_loop.md incremental-solve section)
        "scheduler_partials_hit_rows",
        "scheduler_partials_recomputed_rows",
        "scheduler_partials_full_recomputes_total",
        "scheduler_partials_rollbacks_total",
        # graftcoh runtime epoch auditor (GRAFTLINT_COHERENCE=1; 0 when
        # disarmed — docs/static_analysis.md coherence section)
        "scheduler_coherence_audits_total",
        "scheduler_coherence_violations_total",
        # graftobl runtime exactly-once ledger (GRAFTLINT_OBLIGATIONS=1;
        # all 0 when disarmed — docs/static_analysis.md obligations
        # section)
        "scheduler_obligations_tracked_total",
        "scheduler_obligation_leaks_total",
        "scheduler_obligation_double_discharge_total",
        "scheduler_binder_restarts_total",
        "scheduler_binder_poison_waves_total",
        "scheduler_journal_recovered_records",
        # crash-restart recovery: store snapshot/suffix recovery cost,
        # checkpoint count, stale-leader fenced waves, and leadership
        # reconciliations (docs/robustness.md recovery contract)
        "scheduler_store_recovery_duration_ms",
        "scheduler_store_snapshot_records",
        "scheduler_store_journal_suffix_records",
        "scheduler_store_checkpoints_total",
        "scheduler_store_shard_count",
        "scheduler_fenced_writes_total",
        "scheduler_leader_reconcile_total",
        # overload protection: watch fan-out backpressure + adaptive
        # batch window (docs/robustness.md)
        "scheduler_watch_queue_depth",
        "scheduler_watch_coalesced_total",
        "scheduler_watch_expired_total",
        "scheduler_watch_terminated_total",
        "scheduler_batch_window_ms",
        "scheduler_overload_level",
        "scheduler_overload_shed_total",
        "scheduler_schedule_attempts_total",
        "scheduler_pending_pods",
        "scheduler_preemption_attempts_total",
        # batched preemption: cross-preemptor conflict recomputes and
        # PDB-blocked candidate rankings (docs/scheduler_loop.md)
        "scheduler_preemption_conflict_serializations_total",
        "scheduler_preemption_pdb_blocked_total",
        # pipelined multi-lane cycle: concurrent profile lanes,
        # speculative dispatches and invalidated speculations
        # (docs/scheduler_loop.md)
        "scheduler_lane_count",
        "scheduler_speculative_solves_total",
        "scheduler_misspeculation_total",
        # columnar host plane: encode throughput, framed journal bytes,
        # fan-out chunking, and the c6s ramp knee
        # (docs/scheduler_loop.md host plane section)
        "scheduler_encode_rows_per_s",
        "scheduler_journal_frame_bytes",
        "scheduler_fanout_chunk_size",
        "scheduler_c6s_arrival_knee_pods_per_s",
        # serving plane: adaptive APF seat/shed accounting, write-
        # deadline stalls, and replica failovers
        # (docs/robustness.md serving-plane section)
        "scheduler_apf_seats_current",
        "scheduler_apf_rejected_total",
        "scheduler_server_watch_write_stalls_total",
        "scheduler_replica_failovers_total",
        # graftsched: interleaving schedules explored / yield points
        # scheduled (analysis/interleave.py) and static atomicity
        # findings at the last mirrored run (docs/static_analysis.md)
        "scheduler_interleave_schedules_total",
        "scheduler_interleave_yield_points",
        "scheduler_atomicity_findings",
        # TPU slice topology: post-solve fragmentation and gang
        # carve-out outcomes (docs/scheduler_loop.md)
        "scheduler_fragmentation_score",
        "scheduler_slice_carveouts_total",
        "scheduler_slice_carveout_fallbacks_total",
        "scheduler_gang_contiguous_placements_total",
    )

    def __init__(
        self,
        registry: Registry,
        labels: Optional[Dict[str, str]] = None,
        baseline: Optional[Dict[str, tuple]] = None,
    ):
        self.registry = registry
        self.labels = dict(labels or {})
        self.baseline = baseline or {}

    def _windowed(self, name: str, h: Histogram) -> Histogram:
        base = self.baseline.get(name)
        if base is None:
            return h
        counts0, total0, n0 = base
        with h._lock:
            d = Histogram(name, tuple(h.buckets))
            d.counts = [c - c0 for c, c0 in zip(h.counts, counts0)]
            d.total = h.total - total0
            d.n = h.n - n0
            d.max = h.max  # upper bound; per-window max isn't tracked
        return d

    def collect(self) -> List[DataItem]:
        out: List[DataItem] = []
        snap = self.registry.snapshot()
        for name in self.DEFAULT_METRICS:
            h = snap.get(name)
            if not isinstance(h, Histogram):
                continue
            h = self._windowed(name, h)
            if h.n == 0:
                continue
            labels = dict(self.labels)
            labels["Metric"] = name
            ms = 1000.0  # histograms record seconds; DataItems report ms
            out.append(
                DataItem(
                    {
                        "Average": h.average * ms,
                        "Perc50": h.percentile(0.50) * ms,
                        "Perc90": h.percentile(0.90) * ms,
                        "Perc95": h.percentile(0.95) * ms,
                        "Perc99": h.percentile(0.99) * ms,
                    },
                    "ms",
                    labels,
                )
            )
        for name in self.COUNT_METRICS:
            h = snap.get(name)
            if not isinstance(h, Histogram):
                continue
            h = self._windowed(name, h)
            if h.n == 0:
                continue
            labels = dict(self.labels)
            labels["Metric"] = name
            out.append(
                DataItem(
                    {
                        "Average": h.average,
                        "Perc50": h.percentile(0.50),
                        "Perc90": h.percentile(0.90),
                        "Perc95": h.percentile(0.95),
                        "Perc99": h.percentile(0.99),
                    },
                    "count",
                    labels,
                )
            )
        for name in self.SCALAR_METRICS:
            m = snap.get(name)
            if isinstance(m, Counter):
                value = m.total
            elif isinstance(m, Gauge):
                # labeled gauges (pending_pods per tier) report the
                # cross-label total; unlabeled ones their bare value
                value = m.total
            else:
                continue
            if value == 0.0:
                continue  # quiet metrics don't clutter the summary
            labels = dict(self.labels)
            labels["Metric"] = name
            out.append(DataItem({"Total": value}, "count", labels))
        return out
