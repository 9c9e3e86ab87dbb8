"""The scheduling framework seam: extension points + profiles — a copy of
the reference package's scheduler/framework.py over TorchBatchScheduler.

Reference: the 11-point plugin API (framework/interface.go:330-666) and
profile.Map (profile/profile.go:46).  The batched redesign keeps the
HOST-side extension points as ordered plugin lists — out-of-tree code
registers plain callables — while the device-side points (PreFilter/
Filter/Score/Normalize) are the fused kernels, configured per profile
through ScoreConfig rather than per-plugin chains (you cannot insert a
Python callback into the middle of one kernel launch; that coupling is
the design).

Extension points exposed here and where they run:

  pre_enqueue(pod) -> Optional[str]   gate a pod out of the queue with a
                                      reason (SchedulingGates built in)
  post_filter(pod) -> Optional[str]   after a failed cycle; returns a
                                      nominated node (preemption default)
  pre_bind(pod, node) -> None         before the API bind; raise to abort
                                      (volume-attach analogue)
  post_bind(pod, node) -> None        fire-and-forget after bind
  filter_result(pod, node) -> node    final veto/override hook on a
                                      placement before assume (the
                                      extender call-site analogue)

A Framework belongs to one profile; FrameworkRegistry maps
pod.spec.scheduler_name -> Framework (frameworkForPod, scheduler.go:358
— pods naming an unknown scheduler are not ours to schedule).

FrameworkRegistry builds its schedulers on the CUDA card unless the
caller passes device="cpu"; without a card it raises, as
TorchBatchScheduler does, and never carries on on the CPU.  A config
that names a mesh with the ShardedSolve gate on raises
NotImplementedError: the multi-device solves are not ported yet.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, List, Optional

from ..api import types as api
from ..models.batch_scheduler import DispatchArbiter, TorchBatchScheduler
from ..ops import schema
from .config import ProfileConfig, SchedulerConfiguration


class Framework:
    """One profile's runtime: its batch scheduler + host extension points.
    `tpu` keeps the reference's attribute name; it holds the profile's
    TorchBatchScheduler."""

    def __init__(self, profile: ProfileConfig, tpu: TorchBatchScheduler):
        self.profile = profile
        self.tpu = tpu
        self.pre_enqueue: List[Callable[[api.Pod], Optional[str]]] = []
        self.post_filter: List[Callable[[api.Pod], Optional[str]]] = []
        self.pre_bind: List[Callable[[api.Pod, str], None]] = []
        self.post_bind: List[Callable[[api.Pod, str], None]] = []
        self.filter_result: List[Callable[[api.Pod, str], Optional[str]]] = []
        # Reserve's rollback half (interface.go Reserve/Unreserve): runs
        # when a placement is abandoned after filter_result accepted it
        # (assume failure, PreBind error, bind conflict)
        self.unreserve: List[Callable[[api.Pod], None]] = []
        # Permit (interface.go:330-666): each plugin returns
        # ("allow" | "reject" | "wait", timeout_seconds); any reject
        # wins, any wait parks the pod in the waiting map and its
        # binding thread blocks in WaitOnPermit (schedule_one.go:278)
        self.permit: List[Callable[[api.Pod, str], tuple]] = []
        # set by the Scheduler: the metrics Registry whose
        # framework_extension_point_duration vec the runners observe
        # (frameworkImpl.metricsRecorder, runtime/framework.go)
        self.metrics = None

    def _observe(self, point: str, t0: float) -> None:
        if self.metrics is not None:
            self.metrics.framework_extension_point_duration.labels(
                point
            ).observe(time.monotonic() - t0)

    @property
    def scheduler_name(self) -> str:
        return self.profile.scheduler_name

    def register(self, point: str, fn: Callable) -> None:
        """Out-of-tree plugin registration (the merge at scheduler.go:
        278-281): `point` names one of the host extension lists."""
        getattr(self, point).append(fn)

    # -- runners -----------------------------------------------------------

    def run_pre_enqueue(self, pod: api.Pod) -> Optional[str]:
        t0 = time.monotonic()
        try:
            for fn in self.pre_enqueue:
                reason = fn(pod)
                if reason:
                    return reason
            return None
        finally:
            self._observe("PreEnqueue", t0)

    def run_post_filter(self, pod: api.Pod) -> Optional[str]:
        t0 = time.monotonic()
        try:
            for fn in self.post_filter:
                nominated = fn(pod)
                if nominated:
                    return nominated
            return None
        finally:
            self._observe("PostFilter", t0)

    def run_pre_bind(self, pod: api.Pod, node: str) -> None:
        t0 = time.monotonic()
        try:
            for fn in self.pre_bind:
                fn(pod, node)  # raising aborts the bind (reference semantics)
        finally:
            self._observe("PreBind", t0)

    def run_post_bind(self, pod: api.Pod, node: str) -> None:
        t0 = time.monotonic()
        for fn in self.post_bind:
            try:
                fn(pod, node)
            except Exception:
                pass  # PostBind is informational (interface.go:624)
        self._observe("PostBind", t0)

    def run_filter_result(self, pod: api.Pod, node: str) -> Optional[str]:
        t0 = time.monotonic()
        try:
            for fn in self.filter_result:
                node = fn(pod, node)
                if node is None:
                    return None
            return node
        finally:
            self._observe("Reserve", t0)

    def run_unreserve(self, pod: api.Pod) -> None:
        t0 = time.monotonic()
        for fn in self.unreserve:
            try:
                fn(pod)
            except Exception:
                pass  # rollback must not mask the original failure
        self._observe("Unreserve", t0)

    def run_permit(self, pod: api.Pod, node: str) -> tuple:
        """Combined Permit verdict: ("allow"|"reject"|"wait", timeout).
        Reject short-circuits; wait accumulates the LONGEST requested
        timeout (RunPermitPlugins, runtime/framework.go).  A plugin
        exception is a reject (the reference turns plugin errors into a
        non-success Status) — letting it propagate after cache.assume
        would leak the assumed capacity forever."""
        t0 = time.monotonic()
        try:
            verdict, timeout = "allow", 0.0
            for fn in self.permit:
                try:
                    v, t = fn(pod, node)
                except Exception:
                    logging.getLogger(__name__).exception(
                        "permit plugin %r failed for %s/%s; rejecting",
                        fn, pod.meta.namespace, pod.meta.name,
                    )
                    return "reject", 0.0
                if v == "reject":
                    return "reject", 0.0
                if v == "wait":
                    verdict = "wait"
                    timeout = max(timeout, float(t))
            return verdict, timeout
        finally:
            self._observe("Permit", t0)


class FrameworkRegistry:
    """profile.Map: scheduler_name -> Framework, all profiles sharing ONE
    cluster state (the reference shares one cache across profiles).

    device: None means the CUDA card (each TorchBatchScheduler raises
    without one); "cpu" runs the plain versions."""

    def __init__(
        self,
        config: SchedulerConfiguration,
        state: Optional[schema.ClusterState] = None,
        device=None,
    ):
        config.validate()
        self.config = config
        self.gate = config.gate()
        # AuctionSolver gate pins the router to the greedy scan — the
        # registry build-time consult, like the reference's gate-driven
        # plugin registry (plugins/registry.go:58-70)
        mode = "auto" if self.gate.enabled("AuctionSolver") else "greedy"
        use_mirror = self.gate.enabled("DeviceClusterMirror")
        # incremental O(changes) solving: per-profile PartialsCache
        # warm-starting the greedy/wavefront solves from the mirror's
        # resident tensors (models/partials.py; needs the mirror)
        use_partials = use_mirror and self.gate.enabled("IncrementalSolve")
        if config.mesh_devices and self.gate.enabled("ShardedSolve"):
            # the reference builds one mesh shared by every profile here
            # (parallel/sharded.py); this package has no multi-device
            # solves yet, and a mesh knob must not be ignored quietly
            raise NotImplementedError(
                f"meshDevices={config.mesh_devices} with the ShardedSolve "
                "gate on needs the multi-device solves, which this package "
                "does not have yet (the multi-device twins of "
                "parallel/sharded.py); set meshDevices to 0 or turn "
                "ShardedSolve off"
            )
        first: Optional[TorchBatchScheduler] = None
        self.frameworks: Dict[str, Framework] = {}
        # multi-profile configs run concurrent LANES sharing one card: one
        # dispatch arbiter admits their device programs (double-buffer
        # depth).  A single profile has no contention and pays nothing.
        self.arbiter = (
            DispatchArbiter() if len(config.profiles) > 1 else None
        )
        for profile in config.profiles:
            tpu = TorchBatchScheduler(
                score_config=profile.effective_score_config(),
                limits=config.effective_limits() if first is None else None,
                state=first.state if first is not None else state,
                mode=mode,
                device=device,
                use_mirror=use_mirror,
                arbiter=self.arbiter,
                carveout_policy=config.slice_carveout_policy,
                use_partials=use_partials,
                partials_resync_interval=config.partials_resync_interval,
            )
            if first is None:
                first = tpu
            self.frameworks[profile.scheduler_name] = Framework(profile, tpu)
        self.default = next(iter(self.frameworks.values()))
        # elastic node axis: the knobs live on the ONE ClusterState all
        # profiles share (tensors()'s bucket hysteresis and remove_node's
        # deferred compaction are state-side, not per-profile)
        self.state.configure_elastic_axis(
            headroom=config.node_axis_headroom,
            shrink_dwell=config.bucket_shrink_dwell,
            compaction_batch_rows=config.compaction_batch_rows,
        )

    @property
    def state(self) -> schema.ClusterState:
        return self.default.tpu.state

    def for_pod(self, pod: api.Pod) -> Optional[Framework]:
        """frameworkForPod: None means the pod names another scheduler
        and is not ours (scheduler.go:358-367 skipPodSchedule)."""
        return self.frameworks.get(pod.spec.scheduler_name)

    def __iter__(self):
        return iter(self.frameworks.values())
