"""The host scheduler: informer-fed cache + queue draining into batched
device solves, with a two-stage solve/bind pipeline — a copy of
kubernetes_tpu/scheduler/scheduler.py over TorchBatchScheduler on the
CUDA card.

Reference mapping (pkg/scheduler/scheduler.go, schedule_one.go):

  Scheduler.run            scheduler.go:438 Run (queue flush + hot loop)
  schedule_batch           the batched schedule_one.go:66 ScheduleOne:
                           NextPod -> schedulePod -> assume; one device
                           dispatch schedules the whole batch.  The bind
                           tail is handed to the binding stage as a WAVE
                           and commits off-thread.
  binding stage            schedule_one.go:118's `go bindingCycle` —
                           binds never run on the scheduling thread.
                           Ours is a dedicated worker committing whole
                           waves through one store transaction
                           (store.update_wave) instead of per-pod
                           goroutines doing per-pod POSTs; assume-cache
                           entries bridge the gap exactly as the
                           reference's assume/bind split does, so batch
                           N+1's snapshot is correct while batch N's
                           binds are still in flight.
  failure handling         handleSchedulingFailure :1017 ->
                           AddUnschedulableIfNotPresent; a bind error
                           splits that pod out of the wave, forgets the
                           assume and requeues with backoff
  event wiring             eventhandlers.go:287 addAllEventHandlers:
                           informers feed cache (assigned pods, nodes)
                           and queue (pending pods, requeue-on-event)

The scheduling algorithm itself — filters, scores, selectHost, the
assume bookkeeping between pods of one batch — runs on the card inside
TorchBatchScheduler (models/batch_scheduler.py), through the hand-written
kernels of csrc/.  `Scheduler(store)` builds its profiles on the card and
raises without one; `device="cpu"` runs the plain versions.

Only a scheduling lane (the `_run` thread, or a direct `schedule_batch`
caller) touches a CUDA tensor: `finalize_pending` finishes the readback
and hands back host lists before `_stage_group` builds a bind wave, so the
binder thread, the informers and the event broadcaster work on host
objects only.

Left out of the reference's loop: nothing of the cycle.  The leader
elector stays an optional duck-typed argument (client/leaderelection.py
is not ported yet), and `warmup` runs its buckets one after another
instead of on four threads (see there).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from ..analysis import epochs as _epochs
from ..analysis import ledger as _ledger
from ..analysis import retrace as _retrace
from ..api import store as st
from ..api import types as api
from ..client.events import EventRecorder
from ..client.informers import InformerFactory
from ..models.batch_scheduler import TorchBatchScheduler
from ..ops import assign as assign_ops
from ..testing import faults
from ..utils.trace import Trace
from .cache import SchedulerCache
from .config import SchedulerConfiguration
from .framework import Framework, FrameworkRegistry
from .metrics import Registry
from .preemption import PreemptionEvaluator
from .queue import AdaptiveBatchWindow, QueuedPodInfo, SchedulingQueue, pod_key
from .waitingpods import WaitingPod, WaitingPodsMap


class OverloadController:
    """Load-aware degradation ladder for the solve stage.

    Tracks an EWMA of the cycle's PLACEMENT work (pop → solve → stage →
    dispatch) against the latency SLO and exposes a shed level consumed
    each cycle.  The PostFilter preemption pass is EXCLUDED from the
    fed duration: shedding decisions must not be driven by the work
    they shed — counting the pass made one expensive preemption round
    trip the ladder to level 2, which deferred preemption, which left
    no cycles to decay the average: preemption froze exactly when the
    backlog needed it (the self-inhibition bench c9 exposed).

      0  healthy — full work;
      1  overloaded (ewma > slo) — background work sheds first: the
         PostFilter preemption BATCH is capped (the batched dry-run
         amortized the per-pod marginal cost, so an overloaded cycle
         keeps a small batch instead of deferring preemption outright —
         preemption load spikes exactly when the cluster is overloaded);
         pods past the cap count into scheduler_overload_shed_total,
         never the placement work itself;
      2  severe (ewma > 2*slo) — preemption dry-runs defer entirely and
         the adaptive batch window pins at its max: fewer, fuller
         cycles shed per-cycle fixed overhead without dropping pods.

    Levels fall only when the EWMA drops below 80% of the rising
    threshold (hysteresis), so one fast cycle doesn't flap the ladder.
    """

    GUARDED_FIELDS = {"_ewma": "_lock", "_level": "_lock"}

    _ALPHA = 0.3

    def __init__(self, slo_seconds: float = 0.5):
        self.slo = slo_seconds
        self._lock = threading.Lock()
        self._ewma = 0.0
        self._level = 0

    def note_cycle(self, duration_s: float) -> int:
        with self._lock:
            self._ewma += self._ALPHA * (max(duration_s, 0.0) - self._ewma)
            e, lvl = self._ewma, self._level
            if e > 2 * self.slo:
                lvl = 2
            else:
                if lvl == 2 and e < 0.8 * 2 * self.slo:
                    lvl = 1
                if e > self.slo:
                    lvl = max(lvl, 1)
                elif lvl == 1 and e < 0.8 * self.slo:
                    lvl = 0
            self._level = lvl
            return lvl

    def level(self) -> int:
        with self._lock:
            return self._level


def _combine_transforms(transforms):
    """Compose pod_transform hooks: selectors AND together, extra
    requests sum (VolumeBinding + DRA both fold into the encode)."""

    def combined(pod):
        selector, requests = None, {}
        for fn in transforms:
            sel, extra = fn(pod)
            selector = api.and_selectors(selector, sel)
            for k, v in (extra or {}).items():
                requests[k] = requests.get(k, 0) + v
        return selector, requests

    return combined


def _host_array(values) -> np.ndarray:
    """A result field as a host array: a torch tensor (on the card after
    a gang admission retry re-aligned last_result) is copied back here,
    on the scheduling lane, never on the binder."""
    if isinstance(values, torch.Tensor):
        return values.detach().cpu().numpy()
    return np.asarray(values)


class _Cycle:
    """One in-flight solve-stage cycle: popped-batch staging state plus
    (optionally) the last profile group still out on the device as a
    DeviceSolve future (scheduler._run's readback pipeline).

    `batch` is every popped info and `handled` the keys a terminal path
    has taken ownership of (staged into the wave, parked, requeued,
    handed to a Permit thread): a cycle that dies mid-flight is salvaged
    by requeueing batch − handled, so a fault can never strand pods in
    the 'inflight' tier (Scheduler._salvage_cycle)."""

    __slots__ = ("stats", "trace", "reservations", "failed", "wave",
                 "pending", "solved_any", "batch", "handled",
                 "spec_token", "mirror_points", "partials_points")

    def __init__(self, stats, trace, reservations, batch):
        self.stats = stats
        self.trace = trace
        self.reservations = reservations
        self.failed: List[QueuedPodInfo] = []
        self.wave: List[tuple] = []
        self.pending = None  # (fwk, sched_name, group, DeviceSolve, t_solve)
        self.solved_any = False
        self.batch: List[QueuedPodInfo] = batch
        self.handled: set = set()
        # speculative dispatch: the wave-failure generation this cycle's
        # solves were dispatched under (None = not speculative), plus
        # per-profile mirror AND partials-cache bookmarks for the
        # invalidation rollback (the two resident buffers roll together)
        self.spec_token = None
        self.mirror_points: Dict[str, tuple] = {}
        self.partials_points: Dict[str, tuple] = {}


_REASON_TEXT = {
    assign_ops.REASON_STATIC: "node affinity/taints/name mismatch",
    assign_ops.REASON_RESOURCES: "insufficient resources",
    assign_ops.REASON_PORTS: "host port conflict",
    assign_ops.REASON_SPREAD: "topology spread constraints violated",
    assign_ops.REASON_INTERPOD: "inter-pod (anti-)affinity rules",
    assign_ops.REASON_GANG: "gang not fully placeable",
    assign_ops.REASON_SLICE: "no free contiguous slice carve-out",
}


class Scheduler:
    # graftlint guarded-by declarations: the binding-stage backlog and
    # worker flags share the wave condition; the device-solve interval
    # log (pipeline-overlap attribution) shares the solve lock
    GUARDED_FIELDS = {
        "_waves": "_wave_cv",
        "_wave_active": "_wave_cv",
        "_binder_stop": "_wave_cv",
        "_stream_inflight": "_wave_cv",
        "_solve_windows": "_solve_lock",
        "_solve_open": "_solve_lock",
        "_wave_fail_gen": "_spec_lock",
        "_inflight_cycles": "_inflight_lock",
    }

    def __init__(
        self,
        store: st.Store,
        batch_size: Optional[int] = None,
        tpu: Optional[TorchBatchScheduler] = None,
        assume_ttl: Optional[float] = None,
        clock=time.monotonic,
        leader_elector=None,
        config: Optional[SchedulerConfiguration] = None,
        device=None,
    ):
        self.store = store
        self.config = (config or SchedulerConfiguration()).validate()
        self.batch_size = batch_size or self.config.batch_size
        # profiles: scheduler_name -> Framework, one shared cluster state
        # (profile/profile.go:46; explicit `tpu` keeps the single-profile
        # constructor shape tests/benches use)
        # device: None means the CUDA card (the registry's schedulers
        # raise without one); an injected `tpu` brings its own device
        if device is None and tpu is not None:
            device = tpu.device
        self.profiles = FrameworkRegistry(
            self.config, state=tpu.state if tpu else None, device=device
        )
        if tpu is not None:
            # the injected instance IS the default profile's solver —
            # sharing only its state would silently drop a custom
            # mode/score_config/limits on the scheduling path (the
            # registry-built instance would solve instead)
            self.profiles.default.tpu = tpu
        self.tpu = tpu or self.profiles.default.tpu
        self.cache = SchedulerCache(
            self.tpu.state,
            ttl=assume_ttl or self.config.assume_ttl_seconds,
            clock=clock,
        )
        # overload protection (docs/robustness.md): the adaptive window
        # sizes pop_batch's accumulation from observed arrival rate and
        # solve/commit cost; the overload controller sheds background
        # work (preemption dry-runs) and widens the window when cycles
        # overrun the latency SLO, instead of letting traces pile up
        self.window_ctl: Optional[AdaptiveBatchWindow] = None
        if self.config.adaptive_batch_window:
            self.window_ctl = AdaptiveBatchWindow(
                base_window=self.config.batch_window_seconds,
                min_window=self.config.batch_window_min_seconds,
                max_window=self.config.batch_window_max_seconds,
                slo_seconds=self.config.batch_latency_slo_seconds,
                clock=clock,
            )
        self.overload = OverloadController(
            slo_seconds=self.config.batch_latency_slo_seconds
        )
        self.queue = SchedulingQueue(
            backoff_base=self.config.pod_initial_backoff_seconds,
            backoff_max=self.config.pod_max_backoff_seconds,
            unschedulable_flush_after=self.config.unschedulable_flush_seconds,
            clock=clock,
            batch_window=self.config.batch_window_seconds,
            window_ctl=self.window_ctl,
        )
        self.metrics = Registry()
        # pods parked at Permit (waiting_pods_map.go); coscheduling-style
        # plugins Allow/Reject through this map
        self.waiting = WaitingPodsMap()
        # async: a bind wave must not pay per-pod synchronous Event
        # writes on the scheduling thread (the broadcaster channel)
        self.events = EventRecorder(
            store, component="default-scheduler", async_mode=True
        )
        self.preemption = PreemptionEvaluator(
            self.tpu, self.cache, store, self.metrics
        )
        self.preemption.events = self.events
        # PostFilter budget per cycle: preemption is the exceptional path;
        # cap the per-batch dry-run work so a mass of unschedulable pods
        # can't stall the hot loop.
        self.max_preemptions_per_cycle = self.config.max_preemptions_per_cycle
        # VolumeBinding: host-side claim/volume state; topology + attach
        # limits fold into the snapshot encode via the builder transform
        # (scheduler/volumebinding.py) — PreFilter/Filter cost nothing
        # extra on device.  Reserve rides filter_result, rollback rides
        # unreserve, API writes ride pre_bind.
        from .deviceclaims import DeviceClaimBinder
        from .volumebinding import VolumeBinder

        gate = self.profiles.gate
        self.preemption.pdb_aware = gate.enabled("PDBAwarePreemption")
        self.volumes = VolumeBinder(store)
        self.devices = DeviceClaimBinder(store)
        transforms = []
        if gate.enabled("VolumeBinding"):
            transforms.append(self.volumes.pod_requirements)
        if gate.enabled("DynamicResourceAllocation"):
            transforms.append(self.devices.pod_requirements)
            # topology-shaped claims hand their carve-out extent to the
            # encoder (the batched carve-out kernels steer the carrier
            # onto a free-box corner; scheduler/deviceclaims.py)
            self.tpu.builder.pod_shape_hook = self.devices.pod_shape
        if transforms:
            self.tpu.builder.pod_transform = _combine_transforms(transforms)
        # default plugins on every profile: preemption (PostFilter) +
        # volume binding + device claims (Reserve/Unreserve/PreBind)
        for fwk in self.profiles:
            fwk.metrics = self.metrics
            # background prewarm compiles report into the same histogram
            # as synchronous first-shape compiles
            pool = getattr(fwk.tpu, "prewarm_pool", None)
            if pool is not None:
                pool.compile_observer = (
                    self.metrics.solve_compile_duration.observe
                )
            fwk.post_filter.append(self._preempt_plugin)
            if gate.enabled("VolumeBinding"):
                fwk.filter_result.append(self._volume_reserve_plugin)
                fwk.unreserve.append(self.volumes.unreserve)
                fwk.pre_bind.append(self.volumes.prebind)
            if gate.enabled("DynamicResourceAllocation"):
                fwk.filter_result.append(self._device_reserve_plugin)
                fwk.unreserve.append(self.devices.unreserve)
                fwk.pre_bind.append(self.devices.prebind)
        self.informers = InformerFactory(store)
        # Optional client.leaderelection.LeaderElector: when set, the hot
        # loop only schedules while leading (app/server.go:170-180 —
        # replicated schedulers, single active) — standbys keep informers
        # warm so takeover is immediate.
        self.leader_elector = leader_elector
        # Leadership/restart reconciliation (docs/robustness.md): the
        # flag starts SET so the first leading pass of the hot loop
        # reconciles local pipeline state against the store — covering
        # process restart AND an elector that acquired before this
        # scheduler attached; every later acquisition re-sets it.  The
        # reconcile itself runs on the scheduling thread (never the
        # elector thread, whose renew cadence it must not delay).
        self._reconcile_needed = threading.Event()
        self._reconcile_needed.set()
        if leader_elector is not None:
            prev_cb = leader_elector.on_started_leading

            def _on_started_leading():
                self._reconcile_needed.set()
                if prev_cb:
                    prev_cb()

            leader_elector.on_started_leading = _on_started_leading
        self._clock = clock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # -- pipelined multi-lane scheduling ------------------------------
        # each lane runs its own pop→encode→solve pipeline over its
        # profiles' disjoint pod classes (docs/scheduler_loop.md); lane 0
        # is the LEAD lane (leadership reconcile, assume-TTL sweeps,
        # cross-cutting metric mirrors).  scheduler_lanes=0 auto-sizes to
        # one lane per profile; a single profile keeps the serial loop.
        names = list(self.profiles.frameworks)
        lanes_cfg = self.config.scheduler_lanes
        n_lanes = len(names) if lanes_cfg == 0 else min(lanes_cfg, len(names))
        n_lanes = max(n_lanes, 1)
        if n_lanes > 1:
            self._lane_profiles: List[Optional[set]] = [
                set(names[i::n_lanes]) for i in range(n_lanes)
            ]
        else:
            self._lane_profiles = [None]  # one lane pops every class
        self._lane_threads: List[threading.Thread] = []
        self.metrics.lane_count.set(float(n_lanes))
        # per-scheduling-thread in-flight cycle (lanes + direct
        # schedule_batch callers salvage their OWN cycle on faults)
        self._inflight_lock = threading.Lock()
        self._inflight_cycles: Dict[int, "_Cycle"] = {}
        # speculative solve overlap: batches dispatched while a wave is
        # still committing record the wave-failure generation; a commit
        # failure/fence bumps it and invalidates the speculation
        self._speculation_enabled = self.config.speculative_solve
        self._spec_lock = threading.Lock()
        self._wave_fail_gen = 0
        # PostFilter preemption shares one evaluator: concurrent lanes
        # serialize their passes (preemption is background work)
        self._postfilter_lock = threading.Lock()
        # -- binding stage (the async binding cycle) ----------------------
        # schedule_batch stages placements (assume + Permit) and hands the
        # bind tail to this worker as a wave; the next cycle's pop/solve
        # overlaps the commit.  Backlog is bounded so a commit stage that
        # falls behind backpressures the solve stage instead of growing
        # an unbounded requeue-latency tail.
        self._waves: deque = deque()  # (entries, attempts) pairs
        self._wave_cv = threading.Condition()
        self._wave_active = False
        self._binder_stop = False
        self._max_wave_backlog = 2
        # device-solve intervals, for the pipeline-overlap metric (the
        # binder reads them to attribute its commit time)
        self._solve_lock = threading.Lock()
        self._solve_windows: deque = deque(maxlen=64)  # (start, end)
        self._solve_open: Optional[float] = None
        # sharded-store commit fan-out: the binder partitions each wave
        # into per-store-shard sub-waves and commits up to this many
        # concurrently (shard A's journal fsync / watch fan-out overlaps
        # shard B's and the next solve).  A 1-shard store keeps the
        # serial single-transaction path and pays for no pool.
        subwave_width = min(
            self.config.commit_subwave_concurrency,
            getattr(store, "shard_count", 1),
        )
        self._commit_pool: Optional[ThreadPoolExecutor] = (
            ThreadPoolExecutor(
                max_workers=subwave_width,
                thread_name_prefix="commit-subwave",
            )
            if subwave_width > 1
            else None
        )
        self._subwave_width = subwave_width
        # streamed sub-wave commits: staging hands each store shard's
        # slice of a wave to the commit pool AS IT STAGES, instead of
        # dispatching the whole wave after the full readback; bounded by
        # 2x the pool width (backpressure on the solve stage)
        self._stream_enabled = (
            self.config.stream_subwaves and self._commit_pool is not None
        )
        self._stream_inflight = 0
        self._bind_thread = threading.Thread(
            target=self._bind_worker, name="bind-wave", daemon=True
        )
        self._bind_thread.start()
        self._wire_handlers()

    # -- event wiring (eventhandlers.go:287) ------------------------------

    def _wire_handlers(self) -> None:
        self.informers.informer("Node").add_handler(self._on_node)
        self.informers.informer("Pod").add_handler(self._on_pod)
        self.informers.informer("Node").add_handler(self.volumes.on_node)
        self.informers.informer("Pod").add_handler(self.volumes.on_pod)
        for kind, handler in (
            ("PersistentVolume", self.volumes.on_pv),
            ("PersistentVolumeClaim", self.volumes.on_pvc),
            ("StorageClass", self.volumes.on_class),
            ("ResourceClaim", self.devices.on_claim),
            ("DeviceClass", self.devices.on_class),
        ):
            inf = self.informers.informer(kind)
            inf.add_handler(handler)
            inf.add_handler(self._on_volume_event)

    def _on_volume_event(self, typ: str, obj, old) -> None:
        # a PV/PVC/StorageClass change can lift a volume-topology static
        # failure (the selector the transform folded in) or free attach
        # capacity — wake statically-parked and resource-parked pods
        self.queue.move_for_event("NodeUpdate")

    def _on_node(self, typ: str, node: api.Node, old) -> None:
        if typ == st.ADDED:
            self.cache.add_node(node)
            self.queue.move_for_event("NodeAdd")
        elif typ == st.MODIFIED:
            self.cache.update_node(node)
            self.queue.move_for_event("NodeUpdate")
        elif typ == st.DELETED:
            self.cache.remove_node(node.meta.name)

    def _on_pod(self, typ: str, pod: api.Pod, old) -> None:
        assigned = bool(pod.spec.node_name)
        if pod.spec.resource_claims and typ != st.DELETED:
            self.devices.track_pod(typ, pod)
        if typ == st.DELETED:
            if assigned:
                # the cache removal must see the claim state the pod was
                # ACCOUNTED under — deallocating first would make
                # remove_pod subtract device counts that were never
                # added (unaccounting symmetry)
                self.cache.remove_pod(pod)
                # a terminated pod frees resources: unschedulable pods
                # may fit now — but only resource/port/spread/interpod
                # failures can benefit (AssignedPodDelete wake set)
                self.queue.move_for_event("AssignedPodDelete")
            else:
                self.queue.delete(pod)
                self.cache.remove_nomination(pod)
            if pod.spec.resource_claims:
                self.devices.track_pod(typ, pod)
                pkey = pod_key(pod)
                for claim_name in pod.spec.resource_claims:
                    # last consumer gone -> deallocate; dead CARRIER with
                    # sharers -> hand accounting to a survivor — AFTER
                    # unaccounting (dynamicresources.go:275 semantics)
                    self.devices.on_consumer_delete(
                        f"{pod.meta.namespace}/{claim_name}",
                        pkey,
                        cache=self.cache,
                    )
            return
        if assigned:
            # bound (or our own bind echoing back): confirm in cache
            if old is not None and not old.spec.node_name:
                self.queue.done(pod)
            if (
                typ == st.MODIFIED
                and old is not None
                and old.spec.node_name == pod.spec.node_name
            ):
                # already-bound pod changed (in-place resize, label edit):
                # re-account so requested rows track the new spec
                self.cache.update_pod(old, pod)
                self.queue.move_for_event("AssignedPodUpdate")
            else:
                self.cache.add_pod(pod)
                # a newly bound pod can satisfy waiting affinity/spread
                # constraints (AssignedPodAdd cluster event)
                self.queue.move_for_event("AssignedPodAdd")
            return
        if self.profiles.for_pod(pod) is None:
            return  # another scheduler's pod (skipPodSchedule)
        fwk = self.profiles.for_pod(pod)
        reason = fwk.run_pre_enqueue(pod)
        if reason:
            # PreEnqueue rejection: stay out of the queue until the next
            # pod UPDATE re-runs the gate (schedulinggates semantics)
            self.queue.delete(pod)
            return
        if typ == st.ADDED:
            self.queue.add(pod)
        else:
            self.queue.update(pod)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """Start informers + the scheduling loop thread."""
        self.informers.informer("Node").start()
        self.informers.informer("Pod").start()
        self.informers.informer("PersistentVolume").start()
        self.informers.informer("PersistentVolumeClaim").start()
        self.informers.informer("StorageClass").start()
        self.informers.informer("ResourceClaim").start()
        self.informers.informer("DeviceClass").start()
        self.informers.wait_for_sync()
        self._thread = threading.Thread(
            target=self._run, args=(0,), name="scheduler", daemon=True
        )
        self._thread.start()
        # additional profile lanes (multi-profile configs): each pops
        # and solves its own pod classes concurrently
        self._lane_threads = [
            threading.Thread(
                target=self._run, args=(i,), name=f"scheduler-lane{i}",
                daemon=True,
            )
            for i in range(1, len(self._lane_profiles))
        ]
        for t in self._lane_threads:
            t.start()

    def stop(self) -> None:
        self._stop.set()
        self.queue.close()
        if self._thread:
            # a first cycle can sit in the kernels' nvcc build for a
            # minute; wait it out rather than tear the interpreter down
            # under a live CUDA launch
            self._thread.join(timeout=120)
        for t in self._lane_threads:
            t.join(timeout=120)
        # drain the binding stage: staged placements are assumed in the
        # cache, so dropping their waves would leak phantom usage until
        # the assume TTL fires
        self.flush_binds(timeout=30)
        with self._wave_cv:
            self._binder_stop = True
            self._wave_cv.notify_all()
        self._bind_thread.join(timeout=10)
        if self._commit_pool is not None:
            self._commit_pool.shutdown(wait=True)
        self.informers.stop()
        self.events.stop()

    def kill(self) -> None:
        """Ungraceful teardown — the chaos harness's process-death
        analogue.  Nothing drains: staged bind waves are dropped on the
        floor and assumed pods are abandoned, exactly what a SIGKILL'd
        scheduler leaves behind (the successor's reconciliation and the
        store's durable state are what recover them).  Never use outside
        crash-restart tests; stop() is the graceful path."""
        # a SIGKILL takes the in-memory obligation ledger with it: the
        # popped/assumed state this instance held is recovered by TTL
        # expiry and successor reconciliation, not discharged
        _ledger.abandon()
        self._stop.set()
        self.queue.close()
        with self._wave_cv:
            self._binder_stop = True
            self._waves.clear()
            self._wave_cv.notify_all()
        if self._thread:
            self._thread.join(timeout=10)
        for t in self._lane_threads:
            t.join(timeout=10)
        self._bind_thread.join(timeout=5)
        if self._commit_pool is not None:
            self._commit_pool.shutdown(wait=False)
        self.informers.stop()
        self.events.stop()

    # -- leadership / restart reconciliation -------------------------------

    def _reconcile_leadership(self) -> None:
        """Make local pipeline state agree with the STORE before the
        first post-acquisition dispatch (on_started_leading's analogue
        of the reference's WaitForCacheSync + queue flush).  A new
        leader — fresh process after a crash, or a warm standby taking
        over — must not trust caches built under someone else's
        leadership:

          * every assumed entry is checked against the store: a pod the
            predecessor (or this process, pre-crash) assumed but never
            durably committed is forgotten and re-queued; a pod the
            store says landed elsewhere is forgotten (the informer
            re-accounts it); a matching bind is kept for the informer to
            confirm;
          * unbound pods missing from the queue entirely (an informer
            gap across the handoff) are swept from the store into it —
            the no-pod-lost floor does not depend on event delivery
            across a leadership boundary;
          * the device mirror is invalidated (next solve performs a full
            RESHARDED re-upload — the delta protocol's resident copy
            belongs to the predecessor's generation history) and the
            solve breaker resets to closed (the cooldown belonged to the
            predecessor's device, not ours).

        Bound-exactly-once across the boundary needs no work here: the
        store is the source of truth, bound pods arrive through the
        informer as bound (never queued), and the wave mutator + write
        fencing reject any late commit that disagrees."""
        log = logging.getLogger(__name__)
        requeued = 0
        try:
            pods, _ = self.store.list("Pod")
        except Exception:  # noqa: BLE001 — retry next cycle
            log.exception("leadership reconcile: store list failed")
            self._reconcile_needed.set()
            return
        by_key = {pod_key(p): p for p in pods}
        for key, node in self.cache.assumed_nodes().items():
            cur = by_key.get(key)
            if cur is not None and cur.spec.node_name == node:
                continue  # durably bound where assumed; informer confirms
            self.cache.forget_key(key, node)
            if cur is not None and not cur.spec.node_name:
                # assumed but never committed: give it back to the queue
                self.queue.add(cur)
                requeued += 1
        # store sweep: unbound pods the queue does not know (popped by a
        # crashed predecessor, or an event lost across the handoff)
        for key, pod in by_key.items():
            if pod.spec.node_name or self.profiles.for_pod(pod) is None:
                continue
            if self.cache.is_assumed(pod):
                continue
            if not self.queue.contains(key):
                self.queue.add(pod)
                requeued += 1
        # device-side state: full mirror re-upload + breaker to closed
        for fwk in self.profiles:
            tpu = fwk.tpu
            mirror = getattr(tpu, "_mirror", None)
            partials = getattr(tpu, "_partials", None)
            if mirror is not None:
                with self.cache.lock:
                    mirror.invalidate()
                    if partials is not None:
                        # the resident partials belong to the same
                        # generation history as the mirror: a new leader
                        # recomputes them whole (warm failover must not
                        # inherit a predecessor's warm rows)
                        partials.invalidate()
            breaker = getattr(tpu, "breaker", None)
            if breaker is not None:
                breaker.reset()
        self.metrics.leader_reconcile_total.inc()
        if requeued:
            log.info(
                "leadership reconcile: re-queued %d uncommitted pod(s)",
                requeued,
            )

    # -- binding stage (the dedicated bind worker) -------------------------

    # a wave that failed this many whole-wave commits splits into per-pod
    # commits (the poison-wave escape hatch): one retry, then isolation
    _MAX_WAVE_ATTEMPTS = 1

    def _bind_worker(self) -> None:
        while True:
            with self._wave_cv:
                while not self._waves and not self._binder_stop:
                    self._wave_cv.wait(0.2)
                if not self._waves:
                    return  # stopping and drained
                entries, attempts = self._waves.popleft()
                self._wave_active = True
                self._wave_cv.notify_all()
            # entries not yet committed or failed: the crash handler
            # requeues exactly this remainder, so a crash-grade fault at
            # ANY point (first commit, retry bookkeeping, mid-split)
            # loses nothing to the assume-TTL
            remaining = list(entries)
            try:
                try:
                    self._commit_wave(entries)
                    remaining = []
                except Exception:  # noqa: BLE001 — wave containment
                    # a whole-wave fault must not kill the binding stage
                    # for the process's lifetime NOR park its pods on
                    # the assume-TTL: retry the wave once, then treat it
                    # as poison and split to per-pod commits with
                    # bounded per-pod failure handling
                    if attempts < self._MAX_WAVE_ATTEMPTS:
                        logging.getLogger(__name__).exception(
                            "bind wave failed (attempt %d); retrying",
                            attempts,
                        )
                        with self._wave_cv:
                            self._waves.appendleft((entries, attempts + 1))
                            self._wave_cv.notify_all()
                        remaining = []
                    else:
                        logging.getLogger(__name__).exception(
                            "bind wave failed twice; splitting poison "
                            "wave into per-pod commits"
                        )
                        self.metrics.binder_poison_waves.inc()
                        while remaining:
                            entry = remaining[0]
                            try:
                                self._commit_wave([entry])
                            except Exception:  # noqa: BLE001 — per-pod
                                logging.getLogger(__name__).exception(
                                    "per-pod commit failed for %s; "
                                    "requeueing", pod_key(entry[1].pod),
                                )
                                self._fail_bind(entry[0], entry[1])
                            remaining.pop(0)
            except BaseException:
                # injected crash / interpreter-level fault: the worker
                # is about to die — put the unprocessed remainder back
                # for the restarted worker (_ensure_binder)
                with self._wave_cv:
                    if remaining:
                        self._waves.appendleft((remaining, attempts + 1))
                    self._wave_active = False
                    self._wave_cv.notify_all()
                raise
            with self._wave_cv:
                self._wave_active = False
                self._wave_cv.notify_all()

    def _ensure_binder(self) -> None:
        """Binder watchdog: restart the binding worker if it died (a
        crash-grade fault escaped containment).  Called from the hot
        loop, the wave dispatch path and flush_binds, so direct
        schedule_batch() callers recover too."""
        # double-checked locking: the hot loop calls this every cycle and
        # the worker is almost always alive — the lock-free probe is the
        # fast path; the locked re-check below is authoritative
        if self._bind_thread.is_alive() or self._binder_stop:  # graftlint: disable=guarded-by
            return
        with self._wave_cv:
            if self._bind_thread.is_alive() or self._binder_stop:
                return
            # the dead worker can't clear its active flag; a stale True
            # would wedge flush_binds forever
            self._wave_active = False
            self.metrics.binder_restarts.inc()
            logging.getLogger(__name__).error(
                "binding worker died; restarting (binder supervision)"
            )
            self._bind_thread = threading.Thread(
                target=self._bind_worker, name="bind-wave", daemon=True
            )
            self._bind_thread.start()
            self._wave_cv.notify_all()

    def _dispatch_wave_async(self, wave: List[tuple]) -> None:
        """Hand a bind wave to the binding stage; blocks only when the
        bounded backlog is full (commit slower than solve — the
        backpressure that keeps requeue latency bounded)."""
        self._ensure_binder()
        with self._wave_cv:
            while len(self._waves) >= self._max_wave_backlog:
                self._wave_cv.wait(0.2)
                if not self._bind_thread.is_alive():
                    break  # watchdog's restart will drain the backlog
            self._waves.append((wave, 0))
            self._wave_cv.notify_all()
        self._ensure_binder()

    def flush_binds(self, timeout: float = 30.0) -> bool:
        """Block until every dispatched bind wave has committed (tests
        and shutdown; the hot path never waits).  True on drained."""
        deadline = time.monotonic() + timeout
        while True:
            self._ensure_binder()
            with self._wave_cv:
                # predicate loop under ONE acquisition (graftlint
                # atomicity cv-discipline); breaks out to re-run the
                # binder watchdog when the worker died mid-drain — a
                # dead worker can never notify this cv again
                while (
                    self._waves or self._wave_active or self._stream_inflight
                ):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                    self._wave_cv.wait(min(remaining, 0.2))
                    if not self._bind_thread.is_alive():
                        break
                else:
                    return True

    # -- per-thread in-flight cycle tracking ------------------------------

    def _inflight_set(self, cycle: Optional["_Cycle"]) -> None:
        ident = threading.get_ident()
        with self._inflight_lock:
            if cycle is None:
                self._inflight_cycles.pop(ident, None)
            else:
                self._inflight_cycles[ident] = cycle

    def _inflight_get(self) -> Optional["_Cycle"]:
        with self._inflight_lock:
            return self._inflight_cycles.get(threading.get_ident())

    # -- speculative solve overlap ----------------------------------------

    def _spec_token(self) -> int:
        """The wave-failure generation a speculative dispatch records;
        any commit failure / fence bumps it (see _note_commit_failure)."""
        with self._spec_lock:
            return self._wave_fail_gen

    def _spec_invalidated(self, token: int) -> bool:
        with self._spec_lock:
            return self._wave_fail_gen != token

    def _note_commit_failure(self) -> None:
        """A staged placement was released on the commit side (failed
        sub-wave, fenced wave, PreBind error): any batch dispatched
        speculatively over the released assumes must invalidate."""
        with self._spec_lock:
            self._wave_fail_gen += 1

    def _waves_in_flight(self) -> bool:
        with self._wave_cv:
            return bool(
                self._waves or self._wave_active or self._stream_inflight
            )

    # -- streamed sub-wave commits ----------------------------------------

    def _dispatch_subwave_async(self, entries: List[tuple], sid: int) -> None:
        """Hand one store shard's staged slice of a wave to the commit
        pool immediately (before the rest of the wave stages).  Bounded
        by 2x the pool width so a slow store backpressures the solve
        stage instead of growing an unbounded in-flight set."""
        faults.fire("binder.stream_subwave", pods=len(entries), shard=sid)
        cap = 2 * self._subwave_width
        with self._wave_cv:
            while self._stream_inflight >= cap and not self._binder_stop:
                self._wave_cv.wait(0.2)
            self._stream_inflight += 1
            _ledger.push("stream_inflight", id(self))
            self._wave_cv.notify_all()
        try:
            self._commit_pool.submit(self._commit_stream_subwave, entries)
        except BaseException:
            with self._wave_cv:
                self._stream_inflight -= 1
                _ledger.pop("stream_inflight", id(self))
                self._wave_cv.notify_all()
            raise

    def _commit_stream_subwave(self, entries: List[tuple]) -> None:
        """One streamed per-shard sub-wave on the commit pool.  The
        wave-retry/poison machinery stays with the whole-wave binder
        path; a streamed sub-wave commits once and a whole-sub-wave
        fault requeues its pods with backoff (bound-exactly-once per
        sub-wave holds: the mutator's already-bound guard plus fencing
        reject any duplicate commit)."""
        try:
            self._commit_wave(entries)
        except BaseException:  # noqa: BLE001 — crash-grade containment:
            # the pool thread must survive and the pods must not strand
            # on the assume TTL
            logging.getLogger(__name__).exception(
                "streamed sub-wave commit failed; requeueing %d pod(s)",
                len(entries),
            )
            for fwk, info, _, _ in entries:
                try:
                    self._fail_bind(fwk, info)
                except Exception:  # noqa: BLE001
                    logging.getLogger(__name__).exception(
                        "streamed sub-wave requeue failed for %s",
                        pod_key(info.pod),
                    )
        finally:
            with self._wave_cv:
                self._stream_inflight -= 1
                _ledger.pop("stream_inflight", id(self))
                self._wave_cv.notify_all()

    def _solve_window(self, start: float, end: float) -> None:
        with self._solve_lock:
            self._solve_windows.append((start, end))
            self._solve_open = None

    def _solve_overlap(self, t0: float, t1: float) -> float:
        """Seconds of [t0, t1] that intersected device-solve windows —
        the realized pipeline overlap for one wave commit."""
        with self._solve_lock:
            spans = list(self._solve_windows)
            if self._solve_open is not None:
                spans.append((self._solve_open, t1))
        total = 0.0
        for s, e in spans:
            total += max(0.0, min(e, t1) - max(s, t0))
        return min(total, max(t1 - t0, 0.0))

    def _commit_wave(self, wave: List[tuple]) -> None:
        """Commit one bind wave: PreBind per pod, then ONE store
        transaction for every surviving bind, then the per-pod success
        tail.  Failures split per pod back to individual requeue — a bad
        pod never takes its wave down."""
        faults.fire("binder.commit_wave", pods=len(wave))
        t0 = self._clock()
        binds: List[tuple] = []
        for fwk, info, node_name, t_attempt in wave:
            try:
                fwk.run_pre_bind(info.pod, node_name)
            except Exception:  # noqa: BLE001 — per-pod containment
                self._fail_bind(fwk, info)
                continue
            binds.append((fwk, info, node_name, t_attempt))
        if binds:
            def bind_mutator(node_name: str):
                def mutate(pod: api.Pod) -> None:
                    if pod.spec.node_name and pod.spec.node_name != node_name:
                        # bound-exactly-once guard: a retried wave must
                        # never move an already-bound pod (same-node
                        # recommit is an idempotent no-op-shaped write)
                        raise st.Conflict(
                            f"pod already bound to {pod.spec.node_name}"
                        )
                    pod.spec.node_name = node_name
                    pod.status.phase = "Running"
                return mutate

            # stale-leader write fencing: every sub-wave commits only
            # while our lease acquisition is still current (a deposed
            # leader's late sub-wave is rejected inside its transaction
            # — the Fenced path below requeues; the pods belong to the
            # successor now)
            fence = None
            if self.leader_elector is not None:
                token = getattr(self.leader_elector, "fence_token", None)
                if token is not None:
                    fence = token()
            failed = self._commit_subwaves(binds, bind_mutator, fence)
            done: List[api.Pod] = []
            for fwk, info, node_name, t_attempt in binds:
                if pod_key(info.pod) in failed:
                    self._fail_bind(fwk, info)
                    continue
                done.append(info.pod)
                self._finish_bound(
                    fwk, info, node_name, t_attempt, finish_binding=False
                )
            # TTL countdown for the whole wave under one lock/clock read
            self.cache.finish_binding_all(done)
        dt = self._clock() - t0
        self.metrics.commit_wave_duration.observe(dt)
        self.metrics.commit_wave_size.observe(float(len(wave)))
        if self.window_ctl is not None:
            self.window_ctl.note_commit(len(wave), dt)
        self.metrics.pipeline_overlap.observe(
            self._solve_overlap(t0, self._clock())
        )

    def _commit_subwaves(self, binds, bind_mutator, fence) -> set:
        """Commit one bind wave as per-store-shard SUB-waves — each an
        atomic ``update_wave`` transaction on its shard, committed
        CONCURRENTLY (up to commit_subwave_concurrency) so shard A's
        journal append / watch fan-out overlaps shard B's and the next
        solve.  A 1-shard store (or a wave whose pods all live on one
        shard) keeps the single-transaction path.  Returns the set of
        pod keys that must requeue (per-object errors, a fenced
        sub-wave, or a whole-sub-wave failure)."""
        shard_of = getattr(self.store, "shard_index", None)
        groups: "Dict[int, List[tuple]]" = {}
        for entry in binds:
            sid = (
                shard_of("Pod", entry[1].pod.meta.namespace)
                if shard_of is not None else 0
            )
            groups.setdefault(sid, []).append(entry)

        def commit_group(sid, group):
            updates = [
                (info.pod.meta.name, info.pod.meta.namespace,
                 bind_mutator(node_name))
                for _, info, node_name, _ in group
            ]
            t_g = self._clock()
            try:
                # the binder already partitioned by shard_index: the
                # shard hint lets the store skip re-hashing every pod
                # (the streamed hand-off fast path)
                kwargs = {"fence": fence}
                if shard_of is not None:
                    kwargs["shard_hint"] = sid
                _, errs = self.store.update_wave("Pod", updates, **kwargs)
                bad = set(errs)
            except st.Fenced:
                logging.getLogger(__name__).warning(
                    "bind sub-wave fenced (leadership lost since "
                    "staging); requeueing %d pod(s) for the new leader",
                    len(group),
                )
                bad = {pod_key(info.pod) for _, info, _, _ in group}
            except Exception:  # noqa: BLE001 — sub-wave containment
                logging.getLogger(__name__).exception(
                    "sub-wave transaction failed; requeueing its pods"
                )
                bad = {pod_key(info.pod) for _, info, _, _ in group}
            return bad, self._clock() - t_g

        failed: set = set()
        durations: List[float] = []
        t_all = self._clock()
        if len(groups) > 1 and self._commit_pool is not None:
            futures = [
                self._commit_pool.submit(commit_group, sid, g)
                for sid, g in groups.items()
            ]
            for f in futures:
                bad, dt = f.result()
                failed |= bad
                durations.append(dt)
        else:
            for sid, g in groups.items():
                bad, dt = commit_group(sid, g)
                failed |= bad
                durations.append(dt)
        wall = self._clock() - t_all
        for dt in durations:
            self.metrics.commit_subwave_duration.observe(dt)
        # realized cross-shard commit concurrency: sub-wave work that
        # ran while another sub-wave of this wave was also committing
        self.metrics.commit_subwave_overlap.observe(
            max(sum(durations) - wall, 0.0)
        )
        return failed

    def _fail_bind(self, fwk: Framework, info: QueuedPodInfo) -> None:
        """The binding stage's per-pod failure tail: forget the assume,
        roll back reservations, requeue with backoff.  Also bumps the
        wave-failure generation: a batch dispatched speculatively over
        this (now released) assume invalidates at harvest."""
        self._note_commit_failure()
        released = self.cache.forget(info.pod)
        fwk.run_unreserve(info.pod)
        if released:
            # the assume had accounted real capacity; its release is an
            # AssignedPodDelete-shaped event — without it, pods parked on
            # REASON_RESOURCES would sleep until the flush interval even
            # though the space just came back
            self.queue.move_for_event("AssignedPodDelete")
        self.metrics.schedule_attempts.inc("error")
        self.queue.requeue_backoff(info)

    def _run(self, lane_idx: int = 0) -> None:
        # The solve-side pipeline: the LAST profile group of cycle N stays
        # a device future (DeviceSolve) while the next pop's accumulation
        # window runs — the device solves and the readback transfers while
        # the host collects arrivals, instead of the host idling inside
        # np.asarray.  The deferred group is decoded and staged BEFORE the
        # next batch encodes, so snapshots still see every assume.
        #
        # Each profile LANE runs this loop over its own disjoint pod
        # classes (multi-profile configs); lane 0 is the LEAD lane —
        # leadership reconciliation and the assume-TTL sweep run there
        # only, once per pass, never once per lane.
        lead = lane_idx == 0
        profiles = self._lane_profiles[lane_idx]
        cycle: Optional[_Cycle] = None
        while not self._stop.is_set():
            self._ensure_binder()
            if self.leader_elector and not self.leader_elector.is_leader():
                cycle = self._finish_contained(cycle)
                time.sleep(0.05)
                continue
            if self._reconcile_needed.is_set():
                if not lead:
                    # reconciliation is in flight on the lead lane: a
                    # follower lane must not dispatch over un-reconciled
                    # caches — wait for the lead to clear the flag
                    cycle = self._finish_contained(cycle)
                    time.sleep(0.01)
                    continue
                # first pass after start or (re)acquired leadership:
                # reconcile local state against the store BEFORE popping
                self._reconcile_needed.clear()
                try:
                    self._reconcile_leadership()
                except Exception:  # noqa: BLE001 — containment
                    logging.getLogger(__name__).exception(
                        "leadership reconcile failed; continuing"
                    )
            try:
                # with a solve in flight, the pop is the OVERLAP window —
                # bound it by the accumulation window so staging of the
                # deferred group never waits the full idle timeout
                timeout = 0.2 if cycle is None else min(
                    0.05, self.config.batch_window_seconds or 0.05
                )
                batch = self.queue.pop_batch(
                    self.batch_size, timeout=timeout, profiles=profiles
                )
            except Exception:  # noqa: BLE001
                batch = []
            if (
                batch
                and self.leader_elector
                and not self.leader_elector.is_leader()
            ):
                # leadership was lost INSIDE the pop window: a
                # stepped-down scheduler must not dispatch — hand the
                # batch back and wait for re-acquisition
                for info in batch:
                    self.queue.requeue_backoff(info)
                batch = []
            try:
                if cycle is not None:
                    self._finish_cycle(cycle)
                    cycle = None
                if batch:
                    cycle = self._dispatch_batch(batch)
            except Exception:  # noqa: BLE001 — per-cycle containment
                # the reference contains per-cycle errors (ScheduleOne
                # logs and returns; the wait.Until loop re-enters) — one
                # lost race must not kill the scheduling thread for the
                # process's lifetime.  Salvage first: popped pods the
                # dead cycle never dispositioned go back to the queue
                # instead of stranding in the 'inflight' tier.
                self._salvage_cycle(self._inflight_get())
                cycle = None
                logging.getLogger(__name__).exception(
                    "schedule_batch cycle failed; continuing"
                )
            if lead:
                for pod in self.cache.cleanup_expired():
                    # binding never confirmed: give the pod another chance
                    self.queue.add(pod)
        self._finish_contained(cycle)

    def _salvage_cycle(self, cycle: Optional["_Cycle"]) -> None:
        """A cycle died mid-flight: dispatch whatever bind-wave entries
        it had fully staged (assumed + Permit-allowed — safe to commit),
        then requeue every popped pod no terminal path owned, forgetting
        any assume the dead cycle left behind.  The chaos invariant this
        maintains: every popped pod ends bound or back in the queue,
        never wedged inflight."""
        self._inflight_set(None)
        if cycle is None:
            return
        if cycle.wave:
            staged, cycle.wave = cycle.wave, []
            for _, info, _, _ in staged:
                cycle.handled.add(pod_key(info.pod))
            try:
                self._dispatch_wave_async(staged)
            except Exception:  # noqa: BLE001
                logging.getLogger(__name__).exception(
                    "salvage: staged wave dispatch failed; requeueing"
                )
                for fwk, info, _, _ in staged:
                    self._fail_bind(fwk, info)
        for info in cycle.batch:
            key = pod_key(info.pod)
            if key in cycle.handled:
                continue
            cycle.handled.add(key)
            if self.cache.is_assumed(info.pod):
                # the dead cycle assumed it but lost it before staging
                self.cache.forget(info.pod)
            self.metrics.schedule_attempts.inc("error")
            self.queue.requeue_backoff(info)

    def _finish_contained(self, cycle: Optional["_Cycle"]) -> Optional["_Cycle"]:
        if cycle is not None:
            try:
                self._finish_cycle(cycle)
            except Exception:  # noqa: BLE001
                self._salvage_cycle(self._inflight_get())
                logging.getLogger(__name__).exception(
                    "deferred cycle finalize failed"
                )
        return None

    # -- the batched scheduling cycle -------------------------------------

    def schedule_batch(self, timeout: Optional[float] = None) -> Dict[str, int]:
        """One synchronous solve-stage cycle: drain -> device solve ->
        assume each placement -> hand the bind wave to the binding stage
        -> park failures.  Returns counters for tests/metrics.

        `scheduled` counts pods staged into the bind wave (assumed, past
        Permit): the wave commits asynchronously, and a bind error later
        splits that pod back to requeue (metrics record it as an error).
        Callers that need the binds durable call flush_binds().

        The hot loop (_run) uses the same _dispatch_batch/_finish_cycle
        halves but defers the finalize across the next pop window — this
        entry point finishes the cycle in place so direct callers (tests,
        single-step drivers) keep strict pop->solve->stage semantics."""
        batch = self.queue.pop_batch(self.batch_size, timeout=timeout)
        if not batch:
            return {"popped": 0, "scheduled": 0, "unschedulable": 0,
                    "bind_errors": 0}
        try:
            return self._finish_cycle(self._dispatch_batch(batch))
        except Exception:
            # direct callers see the error, but popped pods must not
            # strand inflight (the same salvage the hot loop runs)
            self._salvage_cycle(self._inflight_get())
            raise

    def _dispatch_batch(self, batch: List[QueuedPodInfo]) -> "_Cycle":
        """The dispatch half of one cycle: group the popped batch by
        profile, encode + dispatch each group's device solve.  Each group
        runs its FULL cycle (solve -> assume -> bind) before the next
        group solves — assume lands the placements in the shared state,
        so a later profile's snapshot sees them; only the LAST group's
        decode+staging is left pending for _finish_cycle (the readback
        the hot loop overlaps with the next pop window)."""
        stats = {"popped": len(batch), "scheduled": 0, "unschedulable": 0,
                 "bind_errors": 0}
        if not self._speculation_enabled:
            # speculative_solve=false: strict solve-vs-commit
            # serialization — a new batch dispatches only over durably
            # committed waves (the rollback knob; the default pipeline
            # overlaps and invalidates on failure instead)
            self.flush_binds(timeout=30.0)
        # Encode under the cache lock (informer threads mutate the same
        # ClusterState/vocabularies); solve outside it.  A pod whose spec
        # can't be encoded (cap overflow, unsupported field) must only
        # reject that pod, not kill the loop (the reference marks the one
        # pod unschedulable, handleSchedulingFailure).
        reservations = self.cache.nominations_excluding(
            {pod_key(info.pod) for info in batch}
        )
        # slow cycles self-describe on EVERY exit path (utiltrace
        # LogIfLong, schedule_one.go:391-431); threshold is generous
        # because a first cycle's kernel build legitimately runs tens of seconds.
        # _finish_cycle's log_if_long is the ONE emission point — the old
        # with-block exit double-logged every over-threshold trace.
        trace = Trace("schedule_batch", threshold=1.0, pods=len(batch))
        cycle = _Cycle(stats, trace, reservations, batch)
        self._inflight_set(cycle)
        if self._speculation_enabled and self._waves_in_flight():
            # SPECULATIVE dispatch: this batch's encode/solve runs over
            # placements an in-flight wave only ASSUMED.  Record the
            # wave-failure generation — a commit failure/fence before
            # this cycle harvests invalidates it (requeue, not stage).
            self.metrics.speculative_solves_total.inc()
            faults.fire("solve.speculate", pods=len(batch))
            cycle.spec_token = self._spec_token()
        # A pod can be popped twice into one accumulation window (delete
        # + recreate races a mid-cycle requeue): the duplicate would make
        # cache.assume raise "already assumed" downstream — requeue it
        # per-pod here instead of letting it near the solve.
        seen: set = set()
        deduped: List[QueuedPodInfo] = []
        for info in batch:
            key = pod_key(info.pod)
            if key in seen:
                cycle.handled.add(key)
                self.metrics.schedule_attempts.inc("error")
                self.queue.requeue_backoff(info)
                continue
            seen.add(key)
            deduped.append(info)
        batch = deduped
        by_fwk: Dict[str, List[QueuedPodInfo]] = {}
        for info in batch:
            by_fwk.setdefault(info.pod.spec.scheduler_name, []).append(info)
        groups = [
            (name, group, self.profiles.frameworks.get(name))
            for name, group in by_fwk.items()
        ]
        # another scheduler's pod slipped in.  Normally unreachable (the
        # informer and the reconcile sweep both filter on profile), but a
        # popped pod is an obligation: dropping the group silently would
        # strand its members on the inflight tier forever.  Retire each
        # with an explicit disposition instead.
        for name, group, fwk in groups:
            if fwk is not None:
                continue
            for info in group:
                key = pod_key(info.pod)
                cycle.handled.add(key)
                self.metrics.schedule_attempts.inc("error")
                self.queue.done(info.pod)
                self.events.eventf(
                    info.pod, "Warning", "FailedScheduling",
                    f"no framework profile for scheduler {name!r}",
                )
        groups = [g for g in groups if g[2] is not None]
        for idx, (sched_name, group, fwk) in enumerate(groups):
            solved = self._solve_group_async(cycle, fwk, sched_name, group)
            if solved is None:
                continue
            cycle.solved_any = True
            if idx == len(groups) - 1:
                cycle.pending = solved
            else:
                self._harvest_group(cycle, *solved)
        return cycle

    def _solve_group_async(self, cycle, fwk, sched_name, group):
        """Encode + dispatch one profile group; returns (fwk, name,
        group, DeviceSolve, t_solve) or None when nothing solvable."""
        t_solve = self._clock()
        with self._solve_lock:
            self._solve_open = t_solve
        if cycle.spec_token is not None:
            # speculative encode: bookmark the profile's device-mirror
            # resident buffer (the double-buffer base) so invalidation
            # can drop the speculative delta chain whole
            mirror = getattr(fwk.tpu, "_mirror", None)
            partials = getattr(fwk.tpu, "_partials", None)
            if mirror is not None and sched_name not in cycle.mirror_points:
                with self.cache.lock:
                    cycle.mirror_points[sched_name] = (
                        mirror, mirror.speculation_point()
                    )
                    if partials is not None:
                        # the resident partials double-buffer with the
                        # mirror: one bookmark pair, taken atomically
                        cycle.partials_points[sched_name] = (
                            partials, partials.speculation_point()
                        )
        pods = [info.pod for info in group]
        try:
            ds = fwk.tpu.schedule_pending_async(
                pods, lock=self.cache.lock, reservations=cycle.reservations
            )
        except (OverflowError, ValueError):
            group = self._reject_unencodable(group, fwk, cycle)
            if not group:
                with self._solve_lock:
                    self._solve_open = None
                return None
            try:
                ds = fwk.tpu.schedule_pending_async(
                    [info.pod for info in group], lock=self.cache.lock,
                    reservations=cycle.reservations,
                )
            except (OverflowError, ValueError):
                # cumulative/batch-level encode failure even though
                # each pod encodes alone: park the whole group rather
                # than killing the scheduler thread
                with self._solve_lock:
                    self._solve_open = None
                for info in group:
                    cycle.handled.add(pod_key(info.pod))
                    self.metrics.schedule_attempts.inc("error")
                    self.queue.add_unschedulable(
                        info, reason=assign_ops.REASON_UNENCODABLE
                    )
                return None
        cycle.trace.step(f"encode[{sched_name}]")
        return (fwk, sched_name, group, ds, t_solve)

    def _misspeculate_group(self, cycle, fwk, sched_name, group, ds) -> None:
        """A wave this group's solve speculated over failed or was
        fenced after the dispatch: the solve ran against assumed
        placements that no longer hold.  Discard the solve undecoded
        (releasing its dispatch slot), roll the profile's mirror back to
        its pre-speculation resident buffer, and requeue EXACTLY this
        batch with backoff — bounded, because attempts already counted
        at pop and backoff grows per retry."""
        if hasattr(ds, "release_slot"):
            ds.release_slot()
        point = cycle.mirror_points.get(sched_name)
        if point is not None:
            mirror, bookmark = point
            with self.cache.lock:
                mirror.rollback(bookmark)
                ppoint = cycle.partials_points.get(sched_name)
                if ppoint is not None:
                    # partials roll back WITH the mirror: warm rows must
                    # never outlive the resident tensors they were
                    # evaluated against (partials_rollbacks_total)
                    partials, pbookmark = ppoint
                    partials.rollback(pbookmark)
        self.metrics.misspeculation_total.inc()
        logging.getLogger(__name__).info(
            "mis-speculation: requeueing %d pod(s) of profile %s "
            "(a wave failed/fenced after the speculative dispatch)",
            len(group), sched_name,
        )
        for info in group:
            cycle.handled.add(pod_key(info.pod))
            self.queue.requeue_backoff(info)

    def _harvest_group(self, cycle, fwk, sched_name, group, ds, t_solve):
        """Decode one dispatched group (the coalesced readback) and stage
        its placements."""
        if cycle.spec_token is not None and self._spec_invalidated(
            cycle.spec_token
        ):
            self._misspeculate_group(cycle, fwk, sched_name, group, ds)
            return
        names = fwk.tpu.finalize_pending(
            [info.pod for info in group], ds, lock=self.cache.lock,
            reservations=cycle.reservations,
        )
        # the breaker's retry/fallback may have replaced the solve the
        # names came from — read telemetry off the effective one, never
        # the sick original (its decode raises)
        ds = getattr(fwk.tpu, "last_solve", None) or ds
        lt = fwk.tpu.last_timings or {}
        encode_s = float(lt.get("encode_s", 0.0))
        compile_s = float(lt.get("compile_s", 0.0))
        decode_wait = float(lt.get("decode_wait_s", 0.0))
        overlap_s = float(lt.get("decode_overlap_s", 0.0))
        now = self._clock()
        # overlap window = the DEVICE half only: the encode holds the
        # cache lock, which a concurrent wave commit also needs, so only
        # the device dispatch truly pipelines against commits
        self._solve_window(
            min(t_solve + encode_s + compile_s, now), now
        )
        # one device dispatch solved len(group) pods.  batch_solve
        # observes the EXPOSED solve cost — encode + compile + the decode
        # wait the host actually blocked on; readback hidden behind the
        # pop window shows up in decode_overlap instead.  The
        # reference-named per-pod algorithm metric gets the per-pod share
        # so harness percentiles stay comparable with the reference's
        # per-ScheduleOne numbers.
        dt_exposed = encode_s + compile_s + decode_wait
        if self.window_ctl is not None:
            # compile walls are one-off; the steady per-pod solve cost
            # the window should size against excludes them
            self.window_ctl.note_solve(
                len(group), encode_s + decode_wait
            )
        self.metrics.batch_solve_duration.observe(dt_exposed)
        self.metrics.scheduling_algorithm_duration.observe(
            dt_exposed / max(len(group), 1), count=len(group)
        )
        self.metrics.decode_overlap.observe(overlap_s)
        if compile_s > 0.01:
            # a real trace/compile, not dispatch-enqueue noise
            self.metrics.solve_compile_duration.observe(compile_s)
        if ds.wave_count is not None:
            self.metrics.solve_wave_count.observe(float(ds.wave_count))
            self.metrics.solve_wave_fallbacks.observe(
                float(ds.wave_fallbacks or 0)
            )
        if ds.frag_score is not None:
            # slice-family solve: mirror the carve-out telemetry (same
            # coalesced readback as the names — no extra round-trip)
            self.metrics.fragmentation_score.set(float(ds.frag_score))
            self.metrics.slice_carveouts.inc(by=float(ds.carveouts or 0))
            self.metrics.gang_contiguous_placements.inc(
                by=float(ds.contiguous_gangs or 0)
            )
            self.metrics.slice_carveout_fallbacks.inc(
                by=float(ds.carveout_fallbacks or 0)
            )
        # reasons come from the SAME readback as the names; after a gang
        # admission retry the solve result no longer aligns positionally
        # (unplaced pods there are unadmitted gang members — REASON_GANG
        # by construction) and last_result reflects that
        result = fwk.tpu.last_result
        if result is ds.result and ds.reasons() is not None:
            reasons = ds.reasons()
        elif result is not None and result.reasons is not None:
            reasons = [
                int(r) for r in _host_array(result.reasons)[: len(group)]
            ]
        else:
            reasons = [-1] * len(group)
        cycle.trace.step(f"decode[{sched_name}]")
        self._stage_group(fwk, group, names, reasons, cycle)
        cycle.trace.step(f"commit[{sched_name}]")

    def _finish_cycle(self, cycle: "_Cycle") -> Dict[str, int]:
        """The staging half: decode any deferred group, hand the bind
        wave to the binding stage, run PostFilter, emit trace/metrics."""
        if cycle.pending is not None:
            # time since dispatch = readback/solve hidden behind host work
            cycle.trace.step("overlap")
            pending, cycle.pending = cycle.pending, None
            self._harvest_group(cycle, *pending)
        stats, trace = cycle.stats, cycle.trace
        if cycle.wave:
            # binding stage takes over: the NEXT cycle's pop+solve runs
            # while this wave commits (assume entries already bridge it)
            self._dispatch_wave_async(cycle.wave)
            trace.step("dispatch")
        if cycle.solved_any:
            # PostFilter: preemption for unschedulable pods, highest
            # priority first (handleSchedulingFailure ->
            # Evaluator.Preempt, schedule_one.go:1017, preemption.go:150).
            # The whole batch shares ONE victim-tensor encode + device
            # dry-run (PreemptionEvaluator.shared_pass); victim deletes
            # emit AssignedPodDelete events that requeue the nominee.
            # Under overload the batch is CAPPED at level 1 (the batched
            # solve amortized the per-pod marginal cost — preemption
            # load spikes exactly when the cluster is overloaded, so
            # deferring it outright was backwards) and deferred only at
            # level 2; pods past the cap count into overload_shed_total
            # and stay parked for a later healthy cycle (or the flush
            # interval).
            cycle.failed.sort(key=lambda i: -i.pod.spec.priority)
            t_postfilter = self._clock()
            budget = self.max_preemptions_per_cycle
            level = self.overload.level()
            if level >= 2:
                budget = 0
            elif level == 1:
                budget = max(1, budget // 4)
            eligible = cycle.failed[: self.max_preemptions_per_cycle]
            batch_infos = eligible[:budget]
            try:
                if batch_infos:
                    # concurrent lanes serialize their PostFilter passes:
                    # the evaluator's shared pass caches per-pass state
                    # (victim tensors, priority floor) one pass at a time
                    with self._postfilter_lock, self.preemption.shared_pass(
                        [info.pod for info in batch_infos]
                    ):
                        for info in batch_infos:
                            fwk = self.profiles.for_pod(info.pod)
                            if fwk is not None and fwk.run_post_filter(
                                info.pod
                            ):
                                stats["preempted"] = (
                                    stats.get("preempted", 0) + 1
                                )
            except (faults.FaultCrash, Exception):  # noqa: BLE001
                # preemption is background work: a crash-grade fault in
                # the batched dry-run must not kill the scheduling
                # thread — the failed pods stay parked and retry on a
                # later cycle (the flush interval is the floor)
                logging.getLogger(__name__).exception(
                    "PostFilter preemption pass failed; continuing"
                )
            if len(eligible) > len(batch_infos):
                self.metrics.overload_shed_total.inc(
                    by=float(len(eligible) - len(batch_infos))
                )
            postfilter_s = self._clock() - t_postfilter
            trace.step("postfilter")
            qs = self.queue.stats()
            for tier, v in qs.items():
                self.metrics.pending_pods.set(v, tier)
        else:
            postfilter_s = 0.0
        trace.log_if_long()
        self.metrics.schedule_batch_duration.observe(trace.total)
        # overload ladder: feed the cycle's PLACEMENT duration — the
        # PostFilter pass is excluded (see OverloadController: shedding
        # must not be driven by the work it sheds) — publish the level,
        # and let the adaptive window react (level 2 pins it wide)
        level = self.overload.note_cycle(
            max(trace.total - postfilter_s, 0.0)
        )
        self.metrics.overload_level.set(float(level))
        if self.window_ctl is not None:
            self.window_ctl.set_overload(level)
            self.metrics.batch_window_ms.set(
                self.window_ctl.window() * 1000.0
            )
        # degraded-mode observability: mirror the breaker and journal
        # recovery state into the registry every cycle (cheap gauge sets)
        breaker = getattr(self.tpu, "breaker", None)
        if breaker is not None:
            self.metrics.solve_breaker_state.set(breaker.state_code())
            self.metrics.solve_fallback_total.set(
                float(breaker.fallback_count())
            )
        # kernel libraries loaded after the first cycle (the CUDA analogue
        # of a mid-run retrace; analysis/retrace.py) — the first finished
        # cycle opens the steady window
        _retrace.mark_steady()
        self.metrics.solve_retrace_total.set(float(_retrace.total()))
        # graftcoh resident-epoch audits, when the coherence auditor is
        # armed (bench / GRAFTLINT_COHERENCE=1 runs; 0 disarmed)
        self.metrics.coherence_audits.set(float(_epochs.audits_total()))
        self.metrics.coherence_violations.set(
            float(_epochs.violations_total())
        )
        # graftobl exactly-once ledger, when armed (bench /
        # GRAFTLINT_OBLIGATIONS=1 runs; all 0 disarmed)
        self.metrics.obligations_tracked.set(
            float(_ledger.tracked_total())
        )
        self.metrics.obligation_leaks.set(float(_ledger.leaks_total()))
        self.metrics.obligation_double_discharge.set(
            float(_ledger.double_discharge_total())
        )
        # sharded-solve surface: mesh size in use, device-mirror
        # host→device transfer accounting, and single-chip fallbacks
        self.metrics.solve_shard_count.set(
            float(getattr(self.tpu, "shard_count", 0))
        )
        self.metrics.sharded_solve_fallbacks.set(
            float(getattr(self.tpu, "sharded_fallbacks", 0))
        )
        mirror = getattr(self.tpu, "_mirror", None)
        if mirror is not None:
            self.metrics.mirror_resync_total.set(float(mirror.resync_total))
            self.metrics.mirror_delta_rows.set(
                float(mirror.delta_rows_total)
            )
            # elastic node axis: in-place resident resizes vs re-uploads
            self.metrics.mirror_grow_total.set(float(mirror.grow_syncs))
            self.metrics.mirror_grow_rows.set(
                float(mirror.grow_rows_total)
            )
        est = getattr(self.tpu, "state", None)
        if est is not None:
            self.metrics.node_axis_bucket.set(float(est.node_axis_bucket))
            self.metrics.compactions_total.set(float(est.compactions_total))
            self.metrics.compaction_moved_rows.set(
                float(est.compaction_moved_rows_total)
            )
        # incremental-solve surface: resident-partials hit/recompute
        # accounting across every profile's cache (summed — profiles
        # sync independently, the surface is one control plane)
        p_stats = [
            fwk.tpu._partials.stats()
            for fwk in self.profiles
            if getattr(fwk.tpu, "_partials", None) is not None
        ]
        if p_stats:
            self.metrics.partials_hit_rows.set(
                float(sum(s["hit_rows_total"] for s in p_stats))
            )
            self.metrics.partials_recomputed_rows.set(
                float(sum(s["recomputed_rows_total"] for s in p_stats))
            )
            self.metrics.partials_full_recomputes.set(
                float(sum(s["full_recomputes"] for s in p_stats))
            )
            self.metrics.partials_rollbacks.set(
                float(sum(s["rollbacks"] for s in p_stats))
            )
        # columnar host plane: encode throughput of the most recent
        # snapshot build (summed across profiles would double-count the
        # shared builder — the max is the live figure), framed journal
        # bytes and mean fan-out chunk size mirrored from the store
        enc = max(
            (
                getattr(fwk.tpu, "last_encode_rows_per_s", 0.0)
                for fwk in self.profiles
            ),
            default=0.0,
        )
        if enc:
            self.metrics.encode_rows_per_s.set(float(enc))
        frame_bytes = getattr(self.store, "journal_frame_bytes", None)
        if frame_bytes is not None:
            self.metrics.journal_frame_bytes.set(float(frame_bytes))
        chunks = getattr(self.store, "fanout_chunks", 0)
        if chunks:
            self.metrics.fanout_chunk_size.set(
                float(self.store.fanout_chunk_events) / float(chunks)
            )
        recovered = getattr(self.store, "journal_recovered_records", None)
        if recovered is not None:
            self.metrics.journal_recovered_records.set(float(recovered))
        # crash-restart recovery surface: the store's last recovery cost
        # split, checkpoint count, and fenced late-leader waves
        for attr, gauge in (
            ("recovery_duration_ms", self.metrics.store_recovery_duration_ms),
            ("snapshot_records", self.metrics.store_snapshot_records),
            (
                "journal_suffix_records",
                self.metrics.store_journal_suffix_records,
            ),
            ("checkpoints_total", self.metrics.store_checkpoints_total),
            ("shard_count", self.metrics.store_shard_count),
            ("fenced_writes_total", self.metrics.fenced_writes_total),
        ):
            v = getattr(self.store, attr, None)
            if v is not None:
                gauge.set(float(v))
        # watch fan-out health: mirror the store's backpressure counters
        # (depth / coalesced / expired) and any legacy terminations
        watch_stats = getattr(self.store, "watch_stats", None)
        if watch_stats is not None:
            ws = watch_stats()
            self.metrics.watch_queue_depth.set(
                float(ws["watch_queue_depth"])
            )
            self.metrics.watch_coalesced_total.set(
                float(ws["watch_coalesced_total"])
            )
            self.metrics.watch_expired_total.set(
                float(ws["watch_expired_total"])
            )
            for kind, n in dict(
                getattr(self.store, "terminated_by_kind", {})
            ).items():
                self.metrics.watch_terminated_total.set(float(n), kind)
        # serving plane: feed the adaptive APF ladder (overload level +
        # store depths) and mirror the fleet-wide serving gauges.  The
        # store carries a weakref to the replica set (set by
        # APIServerReplicaSet); exception-contained — serving-plane
        # trouble must never take the scheduling loop down with it.
        plane_ref = getattr(self.store, "serving_plane", None)
        plane = plane_ref() if plane_ref is not None else None
        if plane is not None:
            try:
                plane.note_scheduler(level, self.store)
                sp = plane.serving_stats()
                self.metrics.apf_seats_current.set(
                    float(sp["apf_seats_current"])
                )
                self.metrics.apf_rejected_total.set(
                    float(sp["apf_rejected_total"])
                )
                self.metrics.server_watch_write_stalls_total.set(
                    float(sp["server_watch_write_stalls_total"])
                )
                self.metrics.replica_failovers_total.set(
                    float(sp["replica_failovers_total"])
                )
            except Exception:  # noqa: BLE001 — mirror-only containment
                logging.getLogger(__name__).exception(
                    "serving-plane mirror failed"
                )
        self._inflight_set(None)
        return stats

    def _stage_group(
        self,
        fwk: Framework,
        group: List[QueuedPodInfo],
        names: List[Optional[str]],
        reasons: List[int],
        cycle: "_Cycle",
    ) -> None:
        """Assume one profile's placements and stage them into the bind
        wave (the per-pod tail of ScheduleOne, schedule_one.go:118-133
        batched; the bind itself runs on the binding stage).  Permit
        ordering is preserved: reject aborts here, wait parks the pod on
        its own WaitOnPermit thread exactly as before — only the
        allow-path bind moves into the wave.  Every branch marks the pod
        handled so a mid-cycle fault salvages only truly-orphaned pods.

        A duplicate assume ("already assumed" ValueError — the same pod
        reaching the solve twice despite the dispatch dedup) is contained
        to a per-pod requeue-with-backoff; it never kills the cycle.

        STREAMED sub-wave commits (stream_subwaves, multi-shard stores):
        instead of accumulating the whole group into ``cycle.wave`` and
        dispatching after the full readback+staging, the group is staged
        per STORE SHARD and each shard's slice is handed to the commit
        pool the moment it finishes staging — shard A's journal fsync /
        watch fan-out run while shard B's pods are still staging (and
        while the next solve runs).  Each pod lands in exactly ONE
        streamed sub-wave, and every sub-wave carries the same fence /
        bound-exactly-once semantics as a whole wave."""
        shard_of = getattr(self.store, "shard_index", None)
        if not (self._stream_enabled and shard_of is not None):
            for i, (info, node_name) in enumerate(zip(group, names)):
                entry = self._stage_one(
                    fwk, info, node_name, reasons[i], cycle
                )
                if entry is not None:
                    cycle.wave.append(entry)
            return
        # streamed: bucket the group's indices by owning store shard,
        # stage shard-by-shard, hand each staged slice off immediately
        buckets: Dict[int, List[int]] = {}
        for i, node_name in enumerate(names):
            sid = (
                shard_of("Pod", group[i].pod.meta.namespace)
                if node_name is not None else -1
            )
            buckets.setdefault(sid, []).append(i)
        handoffs: List[float] = []
        for sid, idxs in buckets.items():
            entries: List[tuple] = []
            for i in idxs:
                entry = self._stage_one(
                    fwk, group[i], names[i], reasons[i], cycle
                )
                if entry is not None:
                    entries.append(entry)
            if sid < 0 or not entries:
                continue
            try:
                self._dispatch_subwave_async(entries, sid)
                handoffs.append(self._clock())
            except Exception:  # noqa: BLE001 — hand-off containment:
                # staged (assumed) pods must not strand on the TTL
                logging.getLogger(__name__).exception(
                    "streamed sub-wave hand-off failed; requeueing"
                )
                for e in entries:
                    self._fail_bind(e[0], e[1])
        if handoffs:
            t_end = self._clock()
            for t in handoffs:
                # the commit lead streaming bought this sub-wave over
                # the whole-group hand-off point
                self.metrics.subwave_stream_lead_ms.observe(
                    (t_end - t) * 1000.0
                )

    def _stage_one(self, fwk, info, node_name, reason, cycle):
        """Stage ONE placement (the per-pod tail shared by the whole-wave
        and streamed paths): filter_result veto → assume → Permit.
        Returns a bind-wave entry for the allow path, None when a
        terminal path (park, requeue, WaitOnPermit thread) took the
        pod."""
        stats, failed = cycle.stats, cycle.failed
        t_attempt = self._clock()
        if node_name is not None:
            node_name = fwk.run_filter_result(info.pod, node_name)
            if node_name is None:
                # a later plugin rejected a placement an earlier one
                # may have reserved for (e.g. volume Reserve) — roll
                # the reservations back before parking
                fwk.run_unreserve(info.pod)
        if node_name is None:
            stats["unschedulable"] += 1
            self.metrics.schedule_attempts.inc("unschedulable")
            self.queue.add_unschedulable(info, reason=reason)
            self.events.eventf(
                info.pod, "Warning", "FailedScheduling",
                f"0 nodes available ({_REASON_TEXT.get(reason, 'unschedulable')})",
            )
            failed.append(info)
            cycle.handled.add(pod_key(info.pod))
            return None
        try:
            self.cache.assume(info.pod, node_name)
        except (KeyError, ValueError):
            fwk.run_unreserve(info.pod)
            stats["bind_errors"] += 1
            self.metrics.schedule_attempts.inc("error")
            self.queue.requeue_backoff(info)
            cycle.handled.add(pod_key(info.pod))
            return None
        # Permit (schedule_one.go:231): reject aborts; wait parks
        # the pod in the waiting map and the binding runs on its own
        # thread blocking in WaitOnPermit (:278) — the scheduling
        # loop moves on, like the reference's async bindingCycle
        verdict, timeout = fwk.run_permit(info.pod, node_name)
        if verdict == "reject":
            self.cache.forget(info.pod)
            fwk.run_unreserve(info.pod)
            stats["unschedulable"] += 1
            self.metrics.schedule_attempts.inc("unschedulable")
            self.events.eventf(
                info.pod, "Warning", "FailedScheduling",
                f"permit rejected on node {node_name}",
            )
            self.queue.requeue_backoff(info)
            cycle.handled.add(pod_key(info.pod))
            return None
        if verdict == "wait":
            wp = WaitingPod(info.pod, node_name, timeout)
            self.waiting.add(wp)
            t = threading.Thread(
                target=self._binding_cycle_async,
                args=(fwk, info, node_name, wp, t_attempt),
                name=f"bind-{info.pod.meta.name}",
                daemon=True,
            )
            t.start()
            stats["waiting"] = stats.get("waiting", 0) + 1
            cycle.handled.add(pod_key(info.pod))
            return None
        # staged: assumed + Permit-allowed; the binding stage owns
        # the rest (PreBind -> wave commit -> PostBind)
        stats["scheduled"] += 1
        cycle.handled.add(pod_key(info.pod))
        return (fwk, info, node_name, t_attempt)

    def _bind_tail(self, fwk, info, node_name, t_attempt) -> bool:
        """PreBind -> bind -> PostBind with failure containment: the
        per-pod tail used by WaitOnPermit binding threads, whose pods
        complete outside any wave (the global metrics Registry still
        records them)."""
        try:
            fwk.run_pre_bind(info.pod, node_name)
            self._bind(info.pod, node_name)
        except Exception:
            self._fail_bind(fwk, info)
            return False
        self._finish_bound(fwk, info, node_name, t_attempt)
        return True

    def _finish_bound(
        self, fwk, info, node_name, t_attempt, finish_binding: bool = True
    ) -> None:
        """The success tail of a committed bind: PostBind, Scheduled
        event, TTL countdown, queue drop, metrics."""
        fwk.run_post_bind(info.pod, node_name)
        self.events.eventf(
            info.pod, "Normal", "Scheduled",
            f"Successfully assigned {pod_key(info.pod)} to {node_name}",
        )
        if finish_binding:
            self.cache.finish_binding(info.pod)
        self.queue.done(info.pod)
        self.metrics.schedule_attempts.inc("scheduled")
        self.metrics.scheduling_attempt_duration.observe(
            self._clock() - t_attempt
        )
        self.metrics.pod_scheduling_sli_duration.observe(
            self._clock() - info.initial_attempt_timestamp
        )

    def _binding_cycle_async(
        self, fwk, info, node_name, wp, t_attempt
    ) -> None:
        """WaitOnPermit then the bind tail, on a binding thread
        (schedule_one.go:118's goroutine).  Rejection/timeout forgets the
        assume, rolls back reservations, and requeues with backoff."""
        try:
            verdict = wp.wait()
        finally:
            self.waiting.remove(info.pod)
        if verdict != "allow":
            self.cache.forget(info.pod)
            fwk.run_unreserve(info.pod)
            self.metrics.schedule_attempts.inc("unschedulable")
            self.events.eventf(
                info.pod, "Warning", "FailedScheduling",
                f"permit {verdict} on node {node_name}",
            )
            self.queue.requeue_backoff(info)
            return
        self._bind_tail(fwk, info, node_name, t_attempt)

    def _volume_reserve_plugin(
        self, pod: api.Pod, node_name: str
    ) -> Optional[str]:
        """Reserve (volume_binding.go:369): pick concrete volumes for the
        pod's unbound claims on the chosen node; rejecting the placement
        parks the pod for retry (the solve's selector already restricted
        candidates to topology-feasible nodes, so rejection here means a
        race on volume capacity)."""
        if not any(v.persistent_volume_claim for v in pod.spec.volumes):
            return node_name
        try:
            node = self.store.get("Node", node_name, namespace="")
        except KeyError:
            return None
        return node_name if self.volumes.reserve(pod, node) else None

    def _device_reserve_plugin(
        self, pod: api.Pod, node_name: str
    ) -> Optional[str]:
        """DRA Reserve: assume claim allocations on the chosen node."""
        if not pod.spec.resource_claims:
            return node_name
        try:
            node = self.store.get("Node", node_name, namespace="")
        except KeyError:
            return None
        return node_name if self.devices.reserve(pod, node) else None

    def _preempt_plugin(self, pod: api.Pod) -> Optional[str]:
        """The DefaultPreemption PostFilter plugin (registered on every
        profile; replaceable/augmentable via Framework.register)."""
        if not self.preemption.eligible(pod):
            return None
        result = self.preemption.preempt(pod)
        return result.nominated_node if result else None

    def _reject_unencodable(
        self,
        batch: List[QueuedPodInfo],
        fwk: Optional[Framework] = None,
        cycle: Optional["_Cycle"] = None,
    ) -> List[QueuedPodInfo]:
        """Batch encode failed: find the offending pods by encoding each
        alone against the SAME profile's builder (rare path; the per-pod
        encode is the authoritative validation) and park them
        unschedulable.  Returns the encodable remainder."""
        tpu = fwk.tpu if fwk is not None else self.tpu
        good: List[QueuedPodInfo] = []
        for info in batch:
            try:
                tpu.encode_pending([info.pod], lock=self.cache.lock)
                good.append(info)
            except (OverflowError, ValueError):
                if cycle is not None:
                    cycle.handled.add(pod_key(info.pod))
                self.metrics.schedule_attempts.inc("error")
                # only a pod UPDATE (spec change) can help — no cluster
                # event wakes this reason (queue.move_for_event)
                self.queue.add_unschedulable(
                    info, reason=assign_ops.REASON_UNENCODABLE
                )
        return good

    def _bind(self, pod: api.Pod, node_name: str) -> None:
        """The DefaultBinder POST pods/{name}/binding analogue: write
        nodeName through the API with optimistic concurrency."""
        current = self.store.get("Pod", pod.meta.name, pod.meta.namespace)
        current.spec.node_name = node_name
        current.status.phase = "Running"
        self.store.update(current, copy_result=False)

    # -- warmup ------------------------------------------------------------

    def warmup(self, pods: List[api.Pod], max_batch: Optional[int] = None) -> float:
        """Build and load the solver kernels a coming workload will hit.

        The reference warms its first-shape XLA compiles here (10-40 s
        each).  On the card the kernels are built once per source by nvcc
        (kernels/build.py) and loaded by their first launch; warmup runs
        the REAL scheduling path — encode + solve, placements discarded,
        nothing assumed or bound — over every power-of-two pod bucket up
        to the first full batch, using caller-supplied template pods so
        the routes and constraint families (spread/interpod/ports/...)
        match the workload's, and every kernel those batches launch is
        built, loaded and its first launch paid before the measured
        window.

        Two rounds per bucket: round A against the current (typically
        bound-pod-free) cluster, round B with one template pod assumed —
        the bound_* feature flags flip once the first batch binds, which
        selects other stages of the kernels; for constraint-free
        workloads round B is skipped.

        Returns seconds spent.  Never raises: a bucket that fails to
        encode (cap overflow) is skipped — the real cycle handles those
        pods through its own rejection path."""
        t0 = self._clock()
        if not pods or not self.tpu.state._rows:
            return 0.0
        fwk = self.profiles.for_pod(pods[0]) or self.profiles.default
        cap = min(len(pods), max_batch or self.batch_size)
        from ..utils import vocab as vb

        buckets, b = [], self.tpu.builder.limits.min_pods
        top = vb.pad_dim(cap, self.tpu.builder.limits.min_pods)
        while b <= top:
            buckets.append(b)
            b *= 2
        log = logging.getLogger(__name__)

        def warm_bucket(bucket: int) -> None:
            try:
                fwk.tpu.schedule_pending(
                    pods[:bucket], num_pods_hint=bucket, lock=self.cache.lock,
                )
            except Exception:
                log.exception("warmup bucket %d skipped", bucket)

        def warm_all() -> None:
            # buckets one after another, largest first: the reference runs
            # them on four threads so XLA compiles overlap, but here each
            # solve launches on the one card and syncs the profile's
            # resident mirror and partials — concurrent solves would share
            # those residents and the stream, and nvcc builds every kernel
            # at the first launch anyway
            for bucket in reversed(buckets):
                warm_bucket(bucket)

        # constraint-free pods can never flip the bound_* feature flags
        # (their count tables have no rows), so one round suffices
        needs_bound_round = any(
            p.spec.topology_spread_constraints
            or (p.spec.affinity and (p.spec.affinity.pod_affinity
                                     or p.spec.affinity.pod_anti_affinity))
            for p in pods
        )
        warm_all()
        if needs_bound_round:
            # round B: one template pod assumed on a live node flips
            # bound_spread/bound_terms/bound_pref
            import copy

            clone = copy.deepcopy(pods[0])
            clone.meta.name = "warmup-bound-pod"
            clone.meta.namespace = pods[0].meta.namespace or "default"
            node0 = next(iter(self.tpu.state._rows))
            try:
                self.cache.assume(clone, node0)  # graftlint: disable=obligations -- the warm_all finally forgets the clone; if THAT forget fails it is logged and cleanup_expired retires the synthetic assume by TTL
            except Exception:
                return self._clock() - t0  # no usable node; round A ran
            try:
                warm_all()
            finally:
                try:
                    self.cache.forget(clone)
                except Exception:
                    log.exception("warmup: forgetting the bound clone failed")
        return self._clock() - t0

    # -- test/bench convenience -------------------------------------------

    def wait_for_idle(self, timeout: float = 30.0) -> bool:
        """True once no pending pods remain in active/backoff/inflight
        (unschedulable pods may remain parked)."""
        deadline = self._clock() + timeout
        while self._clock() < deadline:
            s = self.queue.stats()
            if s["active"] == 0 and s["inflight"] == 0 and s["backoff"] == 0:
                return True
            time.sleep(0.02)
        return False
