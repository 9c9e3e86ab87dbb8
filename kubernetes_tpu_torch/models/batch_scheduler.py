"""TorchBatchScheduler: the batched scheduler on one CUDA card.

Owns the incremental cluster state (persistent vocabularies) and runs the
batch solve on the device the scheduler was built for.  The surface is the
one the host scheduler and the bench drive:

    sched = TorchBatchScheduler()                  # on "cuda"
    placements = sched.schedule(nodes, pending_pods, bound_pods)

    sched.add_node(n) / sched.remove_node(name)
    sched.assume(pod, node_name) / sched.forget(pod)
    placements = sched.schedule_pending(pending_pods)

Three solve routes, chosen at encode time on the PADDED pod axis exactly
as the reference package's TPUBatchScheduler chooses them (`_route`):
under mode="auto" (the default) batches of >= AUCTION_MIN_PODS padded pods
and every gang batch take the auction when its families allow it
(ops.auction.auction_features_ok); other batches of >= WAVEFRONT_MIN_PODS
take the wavefront; the rest take the greedy scan.  mode="greedy" and
mode="auction" pin the family.

By default (use_mirror=True, use_partials=True, as the reference's
DeviceClusterMirror and IncrementalSolve gates) the cluster half of every
batch stays resident on the device (models/mirror.py): a batch sends only
the node rows dirtied since the last sync, in one packed copy scattered by
one `mirror_rows` launch, plus its pod and constraint tables in one packed
copy (ops/device.py); the greedy scan and the wavefront take warm class
statics gathered from the resident partials (models/partials.py) instead
of launching `class_statics`, and the auction stays cold for statics, as
in the reference.  use_mirror=False is the cold path: the whole snapshot
is copied every batch and every solve recomputes its statics.

Every batch is read back once through pinned host buffers and a CUDA
event (DeviceSolve), whose decode checks the scores (SolveUnhealthy on a
NaN, or on a placed pod's non-finite score).  Degraded mode is the
reference's: a failed dispatch or readback retries once (a readback
retry invalidates both residents and re-encodes), a second failure trips
the SolveCircuitBreaker, and while it is open every batch solves on the
host (`_host_fallback`: testing/oracle.py's Oracle over the state's
retained objects, with the gang all-or-nothing post-pass) until the
cooldown's half-open probe succeeds on the card.  Every fallback is
logged and counted in `breaker.fallbacks`.  A failed partials sync
solves that batch cold (counted in the cache's `sync_failures`).  On the
card only SolveUnhealthy and an injected fault take these paths
(`solve_fault_recoverable`): a kernel that fails to build or launch, or a
CUDA error, re-raises.  The fault points `batch.solve`,
`solve.carveout` (here), `solve.partials` (models/partials.py) and
`mirror.grow` (models/mirror.py) drive these paths (testing/faults.py).

Profiles that share one card (scheduler/framework.py FrameworkRegistry)
share one DispatchArbiter: a dispatch takes a slot before its launch and
the decode gives it back once the readback's event completed, so at most
`depth` solves are in flight across the profiles.  One profile passes
arbiter=None and takes no slot.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..analysis import epochs
from ..analysis import ledger as _ledger
from ..api import types as api
from ..ops import assign as assign_ops
from ..ops import auction as auction_ops
from ..ops import device as device_ops
from ..ops import schema
from ..ops.scores import DEFAULT_SCORE_CONFIG, ScoreConfig
from ..testing import faults
from ..testing.oracle import Oracle
from .mirror import DeviceClusterMirror
from .partials import PartialsCache


_log = logging.getLogger(__name__)


class SolveUnhealthy(RuntimeError):
    """A device solve returned a corrupt result (a NaN score, or a placed
    pod's non-finite score): its placements cannot be trusted.  Treated
    like a dispatch error by the circuit breaker."""


def solve_fault_recoverable(exc: Exception, device: torch.device) -> bool:
    """Whether a device-path fault goes to the retry, the circuit breaker
    and the host fallback.  On the card only a corrupt result
    (SolveUnhealthy) and an injected fault (testing/faults.py) do: a
    kernel that fails to build or launch, or a CUDA error, re-raises, so a
    broken card is never hidden behind host solves.  On the CPU every
    exception does, as in the reference."""
    return (device.type != "cuda"
            or isinstance(exc, (SolveUnhealthy, faults.FaultInjected)))


class SolveCircuitBreaker:
    """Device-solve circuit breaker (the reference's, whole).

    closed     device solves flow normally.
    open       the device path failed twice in a row (one retry); every
               batch routes to the host fallback until the cooldown
               elapses.
    half-open  the cooldown elapsed: ONE batch probes the device; success
               closes the breaker, failure re-opens it with a fresh
               cooldown.

    No failure-rate window: a device solve is all-or-nothing per batch,
    so consecutive-failure semantics (fail, retry, trip) match the
    dispatch shape.  Every field is read and written under `_lock`."""

    CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"
    _STATE_CODE = {CLOSED: 0.0, HALF_OPEN: 1.0, OPEN: 2.0}

    def __init__(self, cooldown: float = 5.0, clock=time.monotonic):
        self.cooldown = cooldown
        self._clock = clock
        self._lock = threading.Lock()
        self.state = self.CLOSED
        self._open_until = 0.0
        self.trips = 0       # CLOSED/HALF_OPEN -> OPEN transitions
        self.fallbacks = 0   # batches solved on the host path
        self.probes = 0      # half-open device attempts

    def state_code(self) -> float:
        """0 closed, 1 half-open, 2 open (the solve_breaker_state gauge)."""
        with self._lock:
            return self._STATE_CODE[self.state]

    def record_fallback(self) -> None:
        """Count a batch solved on the host path (the owner's
        _host_fallback calls it)."""
        with self._lock:
            self.fallbacks += 1

    def fallback_count(self) -> int:
        with self._lock:
            return self.fallbacks

    def allow_device(self) -> bool:
        """True when this batch may use the device: closed, or open with
        the cooldown elapsed (the call turns the breaker half-open and the
        batch becomes the probe)."""
        with self._lock:
            if self.state == self.CLOSED:
                return True
            if self.state == self.OPEN and self._clock() >= self._open_until:
                self.state = self.HALF_OPEN
                self.probes += 1
                return True
            # open inside the cooldown, or half-open with the probe in
            # flight on another thread
            return False

    def record_success(self) -> None:
        with self._lock:
            if self.state != self.CLOSED:
                self.state = self.CLOSED

    def record_failure(self) -> None:
        with self._lock:
            self.trips += 1
            self.state = self.OPEN
            self._open_until = self._clock() + self.cooldown

    def reset(self) -> None:
        """Snap the breaker to closed with no cooldown pending (a new
        leader re-probes the device instead of inheriting a cooldown it
        never observed)."""
        with self._lock:
            self.state = self.CLOSED
            self._open_until = 0.0


class DispatchArbiter:
    """Device-admission control for concurrent profile lanes sharing one
    card (the reference's, whole).

    Each lane runs its own pop→encode→solve pipeline; encodes already
    serialize under the scheduler-cache lock, but device dispatch must be
    arbitrated: the arbiter bounds in-flight device solves to `depth`
    (default 2 — double-buffering: lane A's batch N+1 dispatches while
    batch N reads back, and a third program cannot pile onto the card's
    stream ahead of another lane's turn).  A slot is taken before the
    launch and given back by DeviceSolve's decode once the readback's
    event has completed (or by an explicit release_slot on an
    invalidation path that never decodes).

    The wait is deadline-bounded as a safety valve: a leaked slot (a
    caller that dispatched and never decoded) degrades fairness, never
    wedges a lane — forced admissions are counted in `forced`."""

    def __init__(self, depth: int = 2, timeout: float = 30.0,
                 clock=time.monotonic):
        self.depth = max(int(depth), 1)
        self.timeout = timeout
        self._clock = clock
        self._cv = threading.Condition()
        self._inflight = 0
        self.acquires = 0
        self.forced = 0

    def acquire(self) -> bool:
        """Take a dispatch slot; False means the deadline expired and
        admission was forced (the safety valve, not the normal path)."""
        with self._cv:
            self.acquires += 1
            deadline = self._clock() + self.timeout
            while self._inflight >= self.depth:
                remaining = deadline - self._clock()
                if remaining <= 0:
                    self.forced += 1
                    self._inflight += 1
                    _ledger.push("slot", id(self))
                    return False
                self._cv.wait(min(remaining, 0.2))
            self._inflight += 1
            _ledger.push("slot", id(self))
            return True

    def release(self) -> None:
        with self._cv:
            # the ledger pop sits BEFORE the below-zero guard on purpose:
            # the guard keeps the counter sane, but a release with no
            # matching acquire is the double-discharge the ledger surfaces
            _ledger.pop("slot", id(self))
            if self._inflight > 0:
                self._inflight -= 1
            self._cv.notify_all()

    def inflight(self) -> int:
        with self._cv:
            return self._inflight


class HostSolve:
    """A completed host-fallback solve with DeviceSolve's surface: the
    names are already there; there is no device future, no pinned buffer
    or event, and no reason tensor (reasons() is None).  The telemetry
    properties are None, as off their routes."""

    result = None
    wave_count = None
    wave_fallbacks = None
    frag_score = None
    carveouts = None
    contiguous_gangs = None
    carveout_fallbacks = None

    def __init__(self, names: List[Optional[str]]):
        self._names = names
        self.encode_s = 0.0
        self.dispatch_s = 0.0
        self.decode_wait_s = 0.0
        self.deferred_s = 0.0
        self.dispatched_at = time.perf_counter()

    def ready(self) -> bool:
        return True

    def names(self) -> List[Optional[str]]:
        return self._names

    def reasons(self) -> Optional[List[int]]:
        return None

    def release_slot(self) -> None:
        """No-op: the host fallback never held a dispatch slot."""


class DeviceSolve:
    """A dispatched solve held as device futures.

    The decode (device->host readback) is deferred until `names()` or
    `reasons()` is first called.  On the card the readback is already
    queued at dispatch: non-blocking copies into pinned host buffers and
    a CUDA event recorded after them, so `ready()` is the event's query
    and the decode only waits on the event."""

    _CARVE = ("frag_score", "carveouts", "contiguous_gangs", "carveout_fallbacks")

    def __init__(self, result: assign_ops.SolveResult, meta: schema.SnapshotMeta,
                 clock=time.perf_counter):
        self.result = result
        self.meta = meta
        self._clock = clock
        self._decoded = None
        dev = result.assignment.device
        fields = (result.assignment, result.scores, result.reasons)
        # wavefront telemetry rides the same readback (None off that route;
        # an AuctionResult has no such fields)
        wave = tuple(
            getattr(result, f, None) for f in ("wave_count", "wave_fallbacks")
        )
        self._has_wave = wave[0] is not None
        if self._has_wave:
            fields = fields + wave
        # slice carve-out telemetry rides it too (None off the family)
        carve = tuple(getattr(result, f, None) for f in self._CARVE)
        self._has_carve = carve[0] is not None
        if self._has_carve:
            fields = fields + carve
        if dev.type == "cuda":
            self._host = tuple(
                torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in fields
            )
            for h, t in zip(self._host, fields):
                h.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(dev))
        else:
            self._host = fields
            self._event = None
        # DispatchArbiter slot held for this in-flight solve (multi-lane
        # admission); released by the decode, or explicitly by an
        # invalidation path that never decodes
        self._slot: Optional[DispatchArbiter] = None
        self.dispatched_at = clock()
        # step wall split, filled by schedule_pending_async / _decode
        self.encode_s = 0.0        # snapshot encode + host->device transfer
        self.dispatch_s = 0.0      # kernel enqueue
        self.decode_wait_s = 0.0   # time blocked on the readback
        self.deferred_s = 0.0      # dispatch -> decode-start gap (overlap)

    def ready(self) -> bool:
        """Non-blocking: has the device finished the solve and its readback?"""
        return self._event is None or bool(self._event.query())

    def release_slot(self) -> None:
        """Give the dispatch-arbiter slot back (idempotent).  Runs from
        the decode's finally and from an invalidation path."""
        slot, self._slot = self._slot, None
        if slot is not None:
            slot.release()

    def _decode(self):
        if self._decoded is None:
            t0 = self._clock()
            self.deferred_s = t0 - self.dispatched_at
            try:
                if self._event is not None:
                    self._event.synchronize()
            finally:
                # the card finished (or failed) this program and its
                # readback: the next lane's dispatch may proceed either way
                self.release_slot()
            self.decode_wait_s = self._clock() - t0
            assignment, scores, reasons = (h.numpy() for h in self._host[:3])
            # health check: a NaN score, or a placed pod whose winning score
            # is non-finite, means none of this batch's placements can be
            # trusted
            s = scores[: self.meta.num_pods]
            placed = assignment[: self.meta.num_pods] >= 0
            if np.isnan(s).any() or not np.isfinite(s[placed]).all():
                raise SolveUnhealthy("non-finite score tensor in device solve")
            k = 5 if self._has_wave else 3
            wave = (
                tuple(int(h) for h in self._host[3:5]) if self._has_wave
                else (None, None)
            )
            carve = (None,) * 4
            if self._has_carve:
                h = self._host[k:k + 4]
                carve = (float(h[0]), int(h[1]), int(h[2]), int(h[3]))
            self._decoded = (assignment.copy(), reasons.copy()) + wave + carve
        return self._decoded

    def names(self) -> List[Optional[str]]:
        assignment = self._decode()[0][: self.meta.num_pods]
        return [self.meta.node_name(int(i)) for i in assignment]

    def reasons(self) -> Optional[List[int]]:
        return [int(r) for r in self._decode()[1][: self.meta.num_pods]]

    @property
    def wave_count(self) -> Optional[int]:
        """Executed waves (None off the wavefront route)."""
        return self._decode()[2]

    @property
    def wave_fallbacks(self) -> Optional[int]:
        """Serialized members + per-pod full re-evaluations (None off the
        wavefront route)."""
        return self._decode()[3]

    @property
    def frag_score(self) -> Optional[float]:
        """Post-solve cluster fragmentation (None off the slice family)."""
        return self._decode()[4]

    @property
    def carveouts(self) -> Optional[int]:
        return self._decode()[5]

    @property
    def contiguous_gangs(self) -> Optional[int]:
        return self._decode()[6]

    @property
    def carveout_fallbacks(self) -> Optional[int]:
        return self._decode()[7]


class TorchBatchScheduler:
    """Owns the incremental cluster state and solves batches on `device`.

    device: None means the CUDA card; without one the constructor raises
    rather than carry on on the CPU (pass device="cpu" for the plain
    versions).  mode: "auto" | "greedy" | "auction" (see the module
    docstring).  use_wavefront=False keeps greedy-family batches on the
    classic scan.  use_mirror / use_partials / partials_resync_interval:
    the resident cluster mirror and the warm partials (the module
    docstring); the partials need the mirror.  carveout_policy:
    "prefer" | "require" | "off" for the TPU slice carve-out family.
    arbiter: a DispatchArbiter shared by the profile lanes of one card
    (FrameworkRegistry builds one for two or more profiles)."""

    # Greedy-family batches at least this large (padded) solve through the
    # wavefront (ops.assign.wavefront_assign), as in the reference package.
    WAVEFRONT_MIN_PODS = 64
    # Batches at least this large (padded) route to the auction when its
    # constraint coverage allows, as in the reference package.
    AUCTION_MIN_PODS = 1024
    # members a wave may hold (the wavefront kernel's widest wave)
    WAVE_CAP = assign_ops.DEFAULT_WAVE_CAP

    def __init__(
        self,
        score_config: ScoreConfig = DEFAULT_SCORE_CONFIG,
        limits: Optional[schema.SnapshotLimits] = None,
        mode: str = "auto",
        state: Optional[schema.ClusterState] = None,
        device=None,
        use_wavefront: bool = True,
        use_mirror: bool = True,
        use_partials: bool = True,
        partials_resync_interval: int = PartialsCache.DEFAULT_RESYNC_INTERVAL,
        carveout_policy: str = "prefer",
        arbiter: Optional[DispatchArbiter] = None,
    ):
        if mode not in ("auto", "greedy", "auction"):
            raise ValueError(f"mode must be auto|greedy|auction, got {mode!r}")
        # TPU slice carve-outs (ops/slices.py): "prefer" biases shaped
        # gangs onto contiguous sub-cuboids, "require" filters on them (a
        # gang that cannot fit contiguously parks whole), "off" disarms
        # the family
        if carveout_policy not in ("prefer", "require", "off"):
            raise ValueError(
                f"carveout_policy must be prefer|require|off, got {carveout_policy!r}")
        self.carveout_policy = carveout_policy
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchBatchScheduler: no CUDA device is available; pass "
                "device='cpu' to run the plain-torch versions on the CPU"
            )
        if state is not None:
            self.builder = state.builder
            self.state = state
        else:
            self.builder = schema.SnapshotBuilder(limits)
            self.state = schema.ClusterState(self.builder)
        self.score_config = score_config
        self.mode = mode
        # shared across the profile lanes of one card (FrameworkRegistry);
        # None (one profile) takes no slot and pays nothing
        self.arbiter = arbiter
        # throughput of the most recent snapshot build (pods/s over the
        # build_from_state wall time), as the reference records it
        self.last_encode_rows_per_s = 0.0
        self.use_wavefront = use_wavefront
        self.use_mirror = use_mirror
        self._mirror = DeviceClusterMirror(self.state, self.device)
        self._partials: Optional[PartialsCache] = (
            PartialsCache(self.state, self.device, resync_interval=partials_resync_interval)
            if use_partials and use_mirror else None
        )
        self._fill_cache: dict = {}
        self._put_stage = device_ops.PinnedStage()
        # device-solve circuit breaker: dispatch and readback faults (and
        # non-finite scores) retry once, then trip every batch to the host
        # fallback for a cooldown
        self.breaker = SolveCircuitBreaker()
        self.last_result = None  # SolveResult or auction_ops.AuctionResult
        # the effective solve of the most recent finalize_pending (the
        # caller's DeviceSolve unless the retry or the fallback replaced
        # it): a DeviceSolve or a HostSolve
        self.last_solve = None
        self.last_timings: Dict[str, float] = {}

    # -- incremental cluster state ---------------------------------------

    def add_node(self, node: api.Node) -> None:
        self.state.add_node(node)

    def update_node(self, node: api.Node) -> None:
        self.state.update_node(node)

    def remove_node(self, name: str) -> None:
        self.state.remove_node(name)

    def assume(self, pod: api.Pod, node_name: str) -> None:
        """Account a placement immediately (cache.go AssumePod)."""
        self.state.add_pod(pod, node_name)

    def forget(self, pod: api.Pod) -> None:
        """Undo an assume / remove a bound pod (ForgetPod/RemovePod)."""
        self.state.remove_pod(pod)

    # -- scheduling -------------------------------------------------------

    def _route(
        self,
        snap: schema.Snapshot,
        features: assign_ops.FeatureFlags,
        topo_split: Tuple[int, int],
        n_groups: int,
    ) -> str:
        """The solve route, decided on the padded pod axis as the reference
        package's TPUBatchScheduler._route decides it.  Slice carve-out
        batches stay on the classic scan: auction_features_ok declines
        them and the wavefront is skipped for them."""
        p = snap.pods.req.shape[0]
        route = self.mode
        if route == "auto":
            route = "greedy"
            if auction_ops.auction_features_ok(features):
                ok = True
                if features.interpod:
                    # the reference's bound on the repair's [P, T] tables
                    t_dim = snap.terms.valid.shape[0]
                    if t_dim * max(p, topo_split[1]) > 2**25:
                        ok = False
                if ok and (n_groups > 0 or p >= self.AUCTION_MIN_PODS):
                    route = "auction"
        if route == "greedy" and (
            self.use_wavefront and p >= self.WAVEFRONT_MIN_PODS
            and not features.slices
        ):
            route = "wavefront"
        return route

    def _annotate(self, snap: schema.Snapshot, meta: schema.SnapshotMeta,
                  no_bound_pods: bool = False) -> None:
        """Routing statics, derived while the snapshot is host numpy: the
        features, the auction's tie_k, the route and, on the wavefront
        route, the wave plan."""
        meta.features = assign_ops.features_of(
            snap, no_bound_pods=no_bound_pods, slice_policy=self.carveout_policy)
        meta.topo_split = assign_ops.required_topo_z_split(snap)
        meta.n_groups = schema.num_groups(snap)
        meta.tie_k = auction_ops.default_tie_k(snap)
        meta.route = self._route(snap, meta.features, meta.topo_split, meta.n_groups)
        if meta.route == "wavefront":
            meta.wave_plan = assign_ops.plan_waves(
                snap, features=meta.features, wave_cap=self.WAVE_CAP
            )

    def encode_pending(
        self,
        pending: Sequence[api.Pod],
        num_pods_hint: int = 0,
        lock=None,
        reservations: Sequence[Tuple[str, api.Pod]] = (),
    ) -> Tuple[schema.Snapshot, schema.SnapshotMeta]:
        """Encode pending pods + live cluster state and put the snapshot on
        the device, in the reference's order: build, annotate and route
        while host-resident; then the mirror's sync; then, on the greedy
        and wavefront routes, the partials' sync into `meta.statics`; then
        the fill shortcut and the packed copy of the pod and constraint
        tables; then the reservations overlay.  `lock` (the scheduler
        cache's mutex) is held across the encode and the syncs:
        build_from_state returns views aliasing live arrays.
        reservations: (node_name, pod) pairs whose requests overlay the
        named node's usage in THIS snapshot only (out of place: the
        resident tensors are never written here)."""
        with lock if lock is not None else contextlib.nullcontext():
            t0 = time.perf_counter()
            snap, meta = self.builder.build_from_state(
                self.state, pending, num_pods_hint=num_pods_hint
            )
            split = {"build_s": time.perf_counter() - t0}
            if pending and split["build_s"] > 0.0:
                self.last_encode_rows_per_s = len(pending) / split["build_s"]
            rows, reqs, nzs = [], [], []
            for node_name, pod in reservations:
                row = self.state._rows.get(node_name)
                if row is None:
                    continue  # nominated node left the cluster
                req, nz, _ = self.builder.pod_usage(pod, self.state._r)
                rows.append(row)
                reqs.append(req)
                nzs.append(nz)
            no_bound = not self.state._pods
            t0 = time.perf_counter()
            self._annotate(snap, meta, no_bound_pods=no_bound)
            split["annotate_s"] = time.perf_counter() - t0
            meta.encode_split = split
            if self.use_mirror:
                snap = self._put_mirrored(snap, meta, no_bound)
            else:
                t0 = time.perf_counter()
                snap = device_ops.to_device(snap, self.device)
                split["put_s"] = time.perf_counter() - t0
                meta.transfer_bytes = {"put": sum(
                    t.numel() * t.element_size() for table in snap for t in table)}
        if rows:
            cl = snap.cluster
            cluster = cl._replace(
                requested=device_ops.add_rows_in_order(
                    cl.requested, rows, np.stack(reqs)),
                nonzero_requested=device_ops.add_rows_in_order(
                    cl.nonzero_requested, rows, np.stack(nzs)),
            )
            snap = snap._replace(cluster=cluster)
        return snap, meta

    def _put_mirrored(self, snap: schema.Snapshot, meta: schema.SnapshotMeta,
                      no_bound: bool) -> schema.Snapshot:
        """The transfer of a mirrored batch: the resident cluster (synced),
        the warm statics on the greedy-family routes, and one packed copy
        of the pod and constraint tables.  Caller holds the cache lock."""
        split = meta.encode_split
        t0 = time.perf_counter()
        dev_cluster = self._mirror.sync()
        epochs.audit_mirror(self._mirror, self.state)
        split["mirror_s"] = time.perf_counter() - t0
        launches = dict(self._mirror.last_launches)
        partials_bytes = 0
        t0 = time.perf_counter()
        if self._partials is not None and meta.route in ("greedy", "wavefront"):
            # the cache is an optimisation layer: a failure inside it (an
            # injected solve.partials fault; on the CPU any error)
            # invalidates it and this batch solves with cold statics
            try:
                meta.statics = self._partials.sync(
                    dev_cluster, snap, meta, cluster_epoch=self._mirror.epoch())
            except Exception as exc:  # noqa: BLE001 — cold solve instead
                if not solve_fault_recoverable(exc, self.device):
                    raise
                self._partials.invalidate()
                self._partials.sync_failures += 1
                _log.exception("partials sync failed; cold solve for this batch")
            for k, v in self._partials.last_launches.items():
                launches[k] = launches.get(k, 0) + v
            partials_bytes = self._partials.last_sync_bytes
            if meta.statics is not None:
                # a MAX_SLOTS decline leaves the store behind the state:
                # audit only what this solve consumes
                epochs.audit_partials(self._partials, self.state)
                meta.coherence_stamp = (self._mirror.epoch(), self._partials.epoch())
        split["partials_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        snap = snap._replace(cluster=dev_cluster)
        snap = device_ops.device_fill_shortcut(
            snap, self._fill_cache, self.device, no_bound_pods=no_bound,
            features=meta.features)
        snap = device_ops.packed_device_put(snap, self._put_stage, self.device)
        split["put_s"] = time.perf_counter() - t0
        meta.resident_launches = launches
        meta.transfer_bytes = {"mirror": self._mirror.last_sync_bytes,
                               "partials": partials_bytes,
                               "put": self._put_stage.bytes_sent}
        return snap

    def _invalidate_residents(self, lock=None) -> None:
        """Drop the mirror and the partials: after a failed dispatch or
        readback either may be the fault, and the next encode rebuilds
        both in full."""
        with lock if lock is not None else contextlib.nullcontext():
            if self._partials is not None:
                self._partials.invalidate()
            self._mirror.invalidate()

    def _dispatch(self, snap: schema.Snapshot, meta: schema.SnapshotMeta):
        if meta.features is None:
            self._annotate(snap, meta)
        epochs.audit_dispatch(meta)
        if meta.route == "auction":
            return auction_ops.auction_assign(
                snap, self.score_config, n_groups=meta.n_groups,
                features=meta.features, tie_k=meta.tie_k,
                topo_z=meta.topo_split,
            )
        if meta.route == "wavefront":
            return assign_ops.wavefront_assign(
                snap, meta.wave_plan.members, self.score_config,
                features=meta.features, n_groups=meta.n_groups,
                topo_z=meta.topo_split, statics=meta.statics,
            )
        return assign_ops.greedy_assign(
            snap, self.score_config, features=meta.features,
            n_groups=meta.n_groups, topo_z=meta.topo_split, statics=meta.statics,
        )

    def solve_encoded_async(
        self, snap: schema.Snapshot, meta: schema.SnapshotMeta
    ) -> DeviceSolve:
        """Dispatch a prebuilt snapshot; the result stays a device future
        (DeviceSolve) read back on first names()/reasons() access.  The
        fault points: `batch.solve` on every dispatch, `solve.carveout` on
        a slice batch with gangs; a raised fault kills the dispatch, and
        CORRUPT fills the score tensor with NaN (a fill on the result's
        device) so the decode's health check trips."""
        act = faults.fire("batch.solve", pods=meta.num_pods)
        if (meta.features is not None and meta.features.slices
                and (meta.n_groups or 0) > 0):
            faults.fire("solve.carveout", gangs=meta.n_groups)
        slot = self.arbiter
        if slot is not None:
            # multi-lane admission: at most `depth` device programs in
            # flight across every profile lane of this card, taken before
            # the launch and never between the launch and the readback
            slot.acquire()
        try:
            result = self._dispatch(snap, meta)
            if act == faults.CORRUPT and getattr(result, "scores", None) is not None:
                result = result._replace(
                    scores=torch.full_like(result.scores, float("nan")))
            ds = DeviceSolve(result, meta)
        except BaseException:
            if slot is not None:
                slot.release()
            raise
        self.last_result = result
        ds._slot = slot
        return ds

    def solve_encoded(
        self, snap: schema.Snapshot, meta: schema.SnapshotMeta
    ) -> List[Optional[str]]:
        """Dispatch a prebuilt snapshot and decode node names (blocking)."""
        return self.solve_encoded_async(snap, meta).names()

    def schedule_pending_async(
        self,
        pending: Sequence[api.Pod],
        num_pods_hint: int = 0,
        lock=None,
        reservations: Sequence[Tuple[str, api.Pod]] = (),
    ) -> Optional[DeviceSolve]:
        """Encode + dispatch one batch without blocking on the device.
        Returns None for an empty batch; finish with finalize_pending().
        With the breaker open the batch solves on the host (a HostSolve);
        a failed dispatch retries once, then trips the breaker, drops both
        residents and solves on the host."""
        if not pending:
            return None
        if not self.breaker.allow_device():
            return self._host_fallback(pending, lock=lock, reservations=reservations)
        t0 = time.perf_counter()
        snap, meta = self.encode_pending(
            pending, num_pods_hint=num_pods_hint, lock=lock,
            reservations=reservations,
        )
        t1 = time.perf_counter()
        try:
            ds = self.solve_encoded_async(snap, meta)
        except Exception as exc:  # noqa: BLE001 — device dispatch fault
            if not solve_fault_recoverable(exc, self.device):
                raise
            _log.exception("device solve dispatch failed; retrying once")
            try:
                ds = self.solve_encoded_async(snap, meta)
            except Exception as exc2:  # noqa: BLE001
                if not solve_fault_recoverable(exc2, self.device):
                    raise
                self.breaker.record_failure()
                # either resident may be the fault, and the host fallback
                # reads neither
                self._invalidate_residents(lock)
                _log.exception("device solve retry failed; breaker open, host fallback")
                return self._host_fallback(pending, lock=lock, reservations=reservations)
        ds.encode_s = t1 - t0
        ds.dispatch_s = ds.dispatched_at - t1
        return ds

    def finalize_pending(
        self,
        pending: Sequence[api.Pod],
        ds: Optional[DeviceSolve],
        lock=None,
        reservations: Sequence[Tuple[str, api.Pod]] = (),
    ) -> List[Optional[str]]:
        """Decode a dispatched batch, record the encode/solve/decode wall
        split, and run the gang admission retry if the batch needs it.

        A readback fault (SolveUnhealthy at the health check, an injected
        fault; on the CPU any error) retries once: both residents are
        dropped under the lock and the batch is encoded and solved again.
        A second failure trips the breaker and this batch solves on the
        host."""
        if ds is None:
            return []
        try:
            names = ds.names()
            if not isinstance(ds, HostSolve):
                self.breaker.record_success()
        except Exception as exc:  # noqa: BLE001 — device readback fault
            if not solve_fault_recoverable(exc, self.device):
                raise
            _log.exception("device solve readback failed; retrying once")
            try:
                # a poisoned resident (solve.partials, mirror.grow CORRUPT)
                # surfaces here: the retry's encode uploads and
                # recomputes in full
                self._invalidate_residents(lock)
                snap, meta = self.encode_pending(pending, lock=lock, reservations=reservations)
                ds = self.solve_encoded_async(snap, meta)
                names = ds.names()
                self.breaker.record_success()
            except Exception as exc2:  # noqa: BLE001
                if not solve_fault_recoverable(exc2, self.device):
                    raise
                self.breaker.record_failure()
                _log.exception("device solve retry failed; breaker open, host fallback")
                ds = self._host_fallback(pending, lock=lock, reservations=reservations)
                names = ds.names()
        # the EFFECTIVE solve of this batch: telemetry readers (wave
        # counts, reasons) must read this one, not the failed original
        self.last_solve = ds
        self.last_timings = {
            "encode_s": ds.encode_s,
            "compile_s": ds.dispatch_s,
            "solve_s": ds.deferred_s + ds.decode_wait_s,
            "decode_wait_s": ds.decode_wait_s,
            "decode_overlap_s": ds.deferred_s,
        }
        return self._gang_admission_retry(
            pending, names,
            lambda subset: self.schedule_pending_no_retry(
                subset, lock=lock, reservations=reservations,
                num_pods_hint=len(pending),
            ),
        )

    def schedule_pending(
        self,
        pending: Sequence[api.Pod],
        num_pods_hint: int = 0,
        lock=None,
        reservations: Sequence[Tuple[str, api.Pod]] = (),
    ) -> List[Optional[str]]:
        """One batched scheduling step against the incremental state.
        Returns one node name (or None) per pending pod.  Placements are
        NOT auto-assumed — the caller assumes/binds explicitly."""
        ds = self.schedule_pending_async(
            pending, num_pods_hint=num_pods_hint, lock=lock,
            reservations=reservations,
        )
        return self.finalize_pending(
            pending, ds, lock=lock, reservations=reservations
        )

    def schedule_pending_no_retry(
        self, pending, lock=None, reservations=(), num_pods_hint: int = 0
    ) -> List[Optional[str]]:
        if not self.breaker.allow_device():
            return self._host_fallback(
                pending, lock=lock, reservations=reservations).names()
        snap, meta = self.encode_pending(
            pending, lock=lock, reservations=reservations,
            num_pods_hint=num_pods_hint,
        )
        return self.solve_encoded(snap, meta)

    # -- degraded mode (the circuit breaker's fallback) --------------------

    def _host_fallback(
        self,
        pending: Sequence[api.Pod],
        lock=None,
        reservations: Sequence[Tuple[str, api.Pod]] = (),
    ) -> HostSolve:
        """Solve one batch on the host: testing/oracle.py's per-pod exact
        evaluation over the state's retained node and pod objects, with
        the solves' gang all-or-nothing post-pass mirrored on the host.
        On healthy state with the default weights the oracle places as
        the scan does, so an open breaker costs throughput, not placement
        quality.  Nominated reservations are accounted as bound pods on
        their nominated nodes.  Logged and counted in breaker.fallbacks."""
        t0 = time.perf_counter()
        with lock if lock is not None else contextlib.nullcontext():
            state = self.state
            nodes = [state._node_objs[name] for name in state._rows
                     if name in state._node_objs]
            oracle = Oracle(nodes, fit_strategy=self.score_config.fit_strategy,
                            slice_policy=self.carveout_policy)
            by_name = {s.node.meta.name: s for s in oracle.states}
            for key, pod in state._pods.items():
                ns = by_name.get(state._pod_node.get(key) or pod.spec.node_name)
                if ns is not None:
                    ns.add_pod(pod)
            for node_name, pod in reservations:
                ns = by_name.get(node_name)
                if ns is not None:
                    ns.add_pod(pod)
            names = oracle.schedule(list(pending))
        # gang all-or-nothing post-pass (ops.assign _gang_release's host
        # mirror): an incomplete gang releases every member
        groups: Dict[str, List[int]] = {}
        for i, p in enumerate(pending):
            g = p.spec.scheduling_group
            if g:
                groups.setdefault(g, []).append(i)
        for idx in groups.values():
            if any(names[i] is None for i in idx):
                for i in idx:
                    names[i] = None
        self.breaker.record_fallback()
        self.last_result = None  # no reason tensor aligns with these names
        hs = HostSolve(names)
        hs.encode_s = time.perf_counter() - t0
        _log.warning("host fallback solved %d pods in %.3f s (breaker %s)",
                     len(pending), hs.encode_s, self.breaker.state)
        return hs

    def _gang_admission_retry(
        self,
        pending: Sequence[api.Pod],
        names: List[Optional[str]],
        solve_subset,
    ) -> List[Optional[str]]:
        """Gang scarcity packing: when gangs are present and NONE placed
        completely, admit gangs by priority until capacity runs out — a
        binary search over the priority-ordered gang prefix (if the k
        highest-priority gangs don't fit, k+1 don't either), O(log G)
        extra solves, only on the everything-parked path."""
        groups: Dict[str, List[int]] = {}
        for i, p in enumerate(pending):
            g = p.spec.scheduling_group
            if g:
                groups.setdefault(g, []).append(i)
        if not groups:
            return names
        complete = [
            g for g, idx in groups.items()
            if all(names[i] is not None for i in idx)
        ]
        if complete:
            return names  # scarcity handled: some gang(s) landed
        full_result = self.last_result
        # admission order: priority desc, then smaller gangs first
        order = sorted(
            groups,
            key=lambda g: (
                -max(pending[i].spec.priority for i in groups[g]),
                len(groups[g]),
                g,
            ),
        )
        nongang = [
            i for i, p in enumerate(pending) if not p.spec.scheduling_group
        ]

        def attempt(k: int) -> Optional[List[Optional[str]]]:
            idx = list(nongang)
            for g in order[:k]:
                idx.extend(groups[g])
            idx.sort()
            sub = [pending[i] for i in idx]
            sub_names = solve_subset(sub)
            admitted = {i for g in order[:k] for i in groups[g]}
            pos = {orig: j for j, orig in enumerate(idx)}
            if any(sub_names[pos[i]] is None for i in admitted):
                return None  # an admitted gang still doesn't fit
            out: List[Optional[str]] = [None] * len(pending)
            for orig, j in pos.items():
                out[orig] = sub_names[j]
            return out

        lo, hi, best = 0, len(order), None
        while lo < hi:
            mid = (lo + hi + 1) // 2
            got = attempt(mid)
            if got is not None:
                best, lo = got, mid
            else:
                hi = mid - 1
        if best is None:
            self.last_result = full_result  # re-align reasons with names
            return names
        # last_result belongs to the final SUBSET solve; its reasons no
        # longer align with the merged name list
        self.last_result = None
        return best

    # -- stateless (one-shot) ---------------------------------------------

    def snapshot(
        self,
        nodes: Sequence[api.Node],
        pending: Sequence[api.Pod],
        bound: Sequence[api.Pod] = (),
        num_pods_hint: int = 0,
    ) -> Tuple[schema.Snapshot, schema.SnapshotMeta]:
        return self.builder.build(
            nodes, pending, bound_pods=bound, num_pods_hint=num_pods_hint
        )

    def schedule(
        self,
        nodes: Sequence[api.Node],
        pending: Sequence[api.Pod],
        bound: Sequence[api.Pod] = (),
    ) -> List[Optional[str]]:
        """One-shot: encode nodes + pending (+ bound) and solve."""
        if not pending:
            return []

        def solve(pods):
            # pad every gang-retry subset into the full batch's bucket
            snap, meta = self.snapshot(
                nodes, pods, bound, num_pods_hint=len(pending)
            )
            self._annotate(snap, meta)
            snap = device_ops.to_device(snap, self.device)
            return self.solve_encoded_async(snap, meta).names()

        return self._gang_admission_retry(pending, solve(pending), solve)
