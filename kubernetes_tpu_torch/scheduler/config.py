"""The versioned scheduler configuration API: a copy of the reference
package's scheduler/config.py, whole.  PyYAML is imported only when
load_config is handed YAML text or a file path; a dict needs no YAML.

Reference: KubeSchedulerConfiguration (apis/config/types.go:37-100) —
profiles with per-plugin weights/enablement, backoff bounds, parallelism
and percentageOfNodesToScore — with defaulting and validation
(apis/config/{v1,validation}).  Mapped onto the batched device design:

  * score-plugin weights/disables become the profile's ScoreConfig (a
    disabled score plugin is weight 0 — kernels read weights directly);
  * FILTER plugins cannot be individually disabled: the filter chain is
    one fused kernel, and validation rejects the attempt rather than
    silently ignoring it;
  * parallelism (goroutine fan-out, types.go:48) and
    percentageOfNodesToScore (adaptive sampling) have no meaning here —
    one dispatch filters and scores every node (SURVEY §2.7).  They are
    accepted for config-file parity and validated, nothing more.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Tuple

from ..ops.schema import SnapshotLimits
from ..ops.scores import DEFAULT_SCORE_CONFIG, ScoreConfig
from ..utils.featuregate import FeatureGate

# Score plugins that map onto ScoreConfig weights (names/names.go:20-43).
SCORE_PLUGIN_WEIGHTS = {
    "NodeResourcesFit": "fit_weight",
    "NodeResourcesBalancedAllocation": "balanced_weight",
    "NodeAffinity": "node_affinity_weight",
    "TaintToleration": "taint_weight",
    "PodTopologySpread": "spread_weight",
    "InterPodAffinity": "interpod_weight",
    "ImageLocality": "image_weight",
}


@dataclass
class ProfileConfig:
    """One scheduler profile (apis/config KubeSchedulerProfile)."""

    scheduler_name: str = "default-scheduler"
    score_config: ScoreConfig = field(default_factory=lambda: DEFAULT_SCORE_CONFIG)
    disabled_score_plugins: Tuple[str, ...] = ()

    def effective_score_config(self) -> ScoreConfig:
        cfg = self.score_config
        for name in self.disabled_score_plugins:
            cfg = replace(cfg, **{SCORE_PLUGIN_WEIGHTS[name]: 0.0})
        return cfg


@dataclass
class SchedulerConfiguration:
    profiles: List[ProfileConfig] = field(
        default_factory=lambda: [ProfileConfig()]
    )
    batch_size: int = 4096
    # bounded batch-accumulation window: how long pop_batch keeps
    # collecting arrivals once it has at least one pod but fewer than
    # batch_size, so churn-paced creates form real batches instead of
    # near-empty solves.  Every pod in the batch pays the window as
    # queueing latency, so it is capped at the attempt-latency budget
    # (validation rejects > 1s; default 50ms).  With the adaptive
    # controller enabled this is the no-signal starting window.
    batch_window_seconds: float = 0.05
    # adaptive window (docs/scheduler_loop.md): pop_batch's window tracks
    # observed arrival rate and solve/commit cost so sustained churn
    # forms big batches while sparse arrivals pop near-immediately;
    # bounds and the latency SLO the sizing targets (w + r*w*c <= slo).
    adaptive_batch_window: bool = True
    batch_window_min_seconds: float = 0.005
    batch_window_max_seconds: float = 0.25
    batch_latency_slo_seconds: float = 0.5
    pod_initial_backoff_seconds: float = 1.0
    pod_max_backoff_seconds: float = 10.0
    assume_ttl_seconds: float = 30.0
    unschedulable_flush_seconds: float = 300.0
    max_preemptions_per_cycle: int = 16
    # sharded multichip solve (docs/scheduler_loop.md mesh mode): shard
    # the node axis of every solve across this many devices.  0 (the
    # default) stays single-chip; mesh sizes must be powers of two so
    # padded node buckets split evenly.  Consulted at registry build
    # time together with the ShardedSolve feature gate.  This package has
    # no multi-device solves yet: FrameworkRegistry raises
    # NotImplementedError when both are set.
    mesh_devices: int = 0
    # sharded-store commit fan-out (docs/scheduler_loop.md): a bind wave
    # is partitioned into per-store-shard sub-waves and the binder
    # commits up to this many concurrently, so shard A's journal fsync /
    # watch fan-out overlaps shard B's (and the next solve).  1
    # serializes sub-waves; the effective width is min(this, store
    # shards).
    commit_subwave_concurrency: int = 4
    # Pipelined multi-lane scheduling (docs/scheduler_loop.md):
    # scheduler_lanes caps the number of concurrent profile lanes — each
    # lane runs its own pop→encode→solve pipeline over its profiles'
    # disjoint pod classes, sharing one device/mesh through the dispatch
    # arbiter.  0 = auto (one lane per configured profile); 1 pins the
    # serial single-thread loop regardless of profile count.
    scheduler_lanes: int = 0
    # Speculative solve overlap: batch N+1's encode/solve runs against
    # batch N's ASSUMED placements while N's wave is still committing
    # (the assume-cache bridge extended across the commit seam).  A
    # commit failure / fence after the speculative dispatch invalidates
    # the in-flight batch — it requeues with backoff and counts into
    # scheduler_misspeculation_total.  False serializes strictly: a new
    # batch dispatches only once every staged wave has committed.
    speculative_solve: bool = True
    # Streamed sub-wave commits: staged placements are handed to the
    # commit pool per STORE SHARD as each shard's slice of the wave is
    # decoded+staged, instead of after the whole wave stages — shard A's
    # commit overlaps shard B's staging and the next solve.  Requires a
    # multi-shard store (a 1-shard store keeps the whole-wave path).
    stream_subwaves: bool = True
    # TPU slice carve-outs (docs/scheduler_loop.md "TPU slice topology"):
    # how gang/claim carve-out requests (pod.spec.tpu_topology /
    # ResourceClaim.spec.topology) bind to slice sub-cuboids.
    #   prefer  — carve-out quality rides the score (contiguous
    #             placements rank strictly above fragmenting ones; a
    #             gang that can't fit contiguously scatters and counts a
    #             carveout fallback);
    #   require — the carve-out preference becomes a filter: a gang
    #             without a free contiguous sub-cuboid parks whole
    #             (all-or-nothing releases the anchor too);
    #   off     — the slice family is disarmed.
    slice_carveout_policy: str = "prefer"
    # largest per-axis torus extent a slice may declare
    # (SnapshotLimits.max_slice_dim — bounds the carve-out grid);
    # 0 keeps the SnapshotLimits default
    slice_max_dim: int = 0
    # Incremental O(changes) solving (docs/scheduler_loop.md
    # "Incremental solve: resident partials"): forced full recompute of
    # the device-resident Filter/Score partials every this many delta
    # syncs — the periodic half of the cache's resync/parity discipline
    # (struct/vocab invalidation and the decode-side parity gate are
    # unconditional).  Armed by the IncrementalSolve feature gate.
    partials_resync_interval: int = 1024
    # Elastic node axis (docs/scheduler_loop.md "Elastic node axis"):
    # nodeAxisHeadroom is the backing-array growth factor applied when
    # ClusterState reallocates under autoscaler growth (rounded up to
    # the next power-of-two bucket; >= 1.0 — larger values amortize
    # host-side reallocs across more node adds);
    node_axis_headroom: float = 2.0
    # bucketShrinkDwell is the number of consecutive snapshot
    # generations occupancy must sit below the lower pad bucket before
    # tensors() shrinks the exposed bucket — the hysteresis that keeps
    # scale-up/down oscillation around a boundary from flip-flopping
    # compile keys and resident device arrays;
    bucket_shrink_dwell: int = 8
    # compactionBatchRows caps the rows one deferred-compaction
    # invocation relocates during scale-down (amortized trigger: a
    # full drain does O(live) total work, never O(live^2)).
    compaction_batch_rows: int = 512
    # parity-only knobs (see module docstring)
    parallelism: int = 16
    percentage_of_nodes_to_score: int = 100
    limits: Optional[SnapshotLimits] = None
    # feature-gate overrides (utils.featuregate.DEFAULT_FEATURES),
    # consulted at registry/router build time — e.g. AuctionSolver=false
    # pins every profile's solver to the greedy scan
    feature_gates: Dict[str, bool] = field(default_factory=dict)

    def gate(self) -> FeatureGate:
        return FeatureGate(overrides=self.feature_gates)

    def effective_limits(self) -> Optional[SnapshotLimits]:
        """The SnapshotLimits every profile's builder uses: the explicit
        `limits` when given (None means builder defaults), with a
        non-zero sliceMaxDim knob folded in."""
        lim = self.limits
        if self.slice_max_dim > 0:
            lim = lim if lim is not None else SnapshotLimits()
            lim.max_slice_dim = self.slice_max_dim
        return lim

    def validate(self) -> "SchedulerConfiguration":
        """Raise ValueError on an invalid configuration (the
        apis/config/validation analogue); returns self for chaining."""
        if not self.profiles:
            raise ValueError("at least one profile is required")
        names = [p.scheduler_name for p in self.profiles]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate profile schedulerName in {names}")
        for p in self.profiles:
            for plugin in p.disabled_score_plugins:
                if plugin not in SCORE_PLUGIN_WEIGHTS:
                    raise ValueError(
                        f"unknown or non-disableable score plugin {plugin!r} "
                        f"(filter plugins are fused; known: "
                        f"{sorted(SCORE_PLUGIN_WEIGHTS)})"
                    )
            cfg = p.score_config
            for f_name in (
                "fit_weight", "balanced_weight", "node_affinity_weight",
                "taint_weight", "spread_weight", "interpod_weight",
                "image_weight",
            ):
                if getattr(cfg, f_name) < 0:
                    raise ValueError(f"{p.scheduler_name}: {f_name} < 0")
            shape = cfg.rtcr_shape
            if not shape or any(
                b[0] <= a[0] for a, b in zip(shape, shape[1:])
            ):
                raise ValueError(
                    f"{p.scheduler_name}: rtcr_shape utilization points "
                    "must be non-empty and strictly increasing "
                    "(apis/config/validation's shape check)"
                )
            if cfg.fit_strategy not in (
                "LeastAllocated", "MostAllocated", "RequestedToCapacityRatio"
            ):
                raise ValueError(
                    f"{p.scheduler_name}: unknown fit_strategy "
                    f"{cfg.fit_strategy!r}"
                )
        if self.batch_size <= 0:
            raise ValueError("batch_size must be positive")
        if not (0 <= self.batch_window_seconds <= 1.0):
            raise ValueError(
                "batch_window_seconds must be within [0, 1] — the window "
                "is pure queueing latency for every pod in the batch"
            )
        if not (
            0
            <= self.batch_window_min_seconds
            <= self.batch_window_max_seconds
            <= 1.0
        ):
            raise ValueError(
                "adaptive window bounds must satisfy "
                "0 <= min <= max <= 1s (queueing-latency budget)"
            )
        if self.batch_latency_slo_seconds <= 0:
            raise ValueError("batch_latency_slo_seconds must be positive")
        if self.pod_initial_backoff_seconds <= 0:
            raise ValueError("pod_initial_backoff_seconds must be positive")
        if self.pod_max_backoff_seconds < self.pod_initial_backoff_seconds:
            raise ValueError(
                "pod_max_backoff_seconds < pod_initial_backoff_seconds"
            )
        if not (0 <= self.percentage_of_nodes_to_score <= 100):
            raise ValueError("percentage_of_nodes_to_score must be 0..100")
        if self.max_preemptions_per_cycle < 0:
            raise ValueError("max_preemptions_per_cycle must be >= 0")
        if self.commit_subwave_concurrency < 1:
            raise ValueError("commit_subwave_concurrency must be >= 1")
        if self.scheduler_lanes < 0:
            raise ValueError(
                "scheduler_lanes must be >= 0 (0 = one lane per profile)"
            )
        if self.mesh_devices < 0:
            raise ValueError("mesh_devices must be >= 0")
        if self.mesh_devices and (
            self.mesh_devices & (self.mesh_devices - 1)
        ):
            raise ValueError(
                "mesh_devices must be a power of two: padded node "
                "buckets are powers of two, and the node axis must "
                "split evenly across the mesh (parallel/sharded.py)"
            )
        if self.slice_carveout_policy not in ("prefer", "require", "off"):
            raise ValueError(
                "slice_carveout_policy must be one of prefer|require|off"
            )
        if self.slice_max_dim < 0:
            raise ValueError(
                "slice_max_dim must be >= 0 (0 = SnapshotLimits default)"
            )
        if self.partials_resync_interval < 1:
            raise ValueError(
                "partials_resync_interval must be >= 1 (every delta sync "
                "may force a full recompute, never none)"
            )
        if self.node_axis_headroom < 1.0:
            raise ValueError(
                "node_axis_headroom must be >= 1.0 (the backing arrays "
                "must at least fit the rows that forced the realloc)"
            )
        if self.bucket_shrink_dwell < 1:
            raise ValueError(
                "bucket_shrink_dwell must be >= 1 (a 1-generation dwell "
                "is the minimum hysteresis; 0 would shrink mid-encode)"
            )
        if self.compaction_batch_rows < 1:
            raise ValueError(
                "compaction_batch_rows must be >= 1 (a 0 budget would "
                "never relocate a row and the watermark could only trim)"
            )
        self.gate()  # unknown/locked gate overrides raise here
        return self


# ---------------------------------------------------------------------------
# Versioned config-file loading: KubeSchedulerConfiguration-shaped YAML
# -> defaults -> validation -> SchedulerConfiguration (the
# apis/config/{v1,validation} pipeline; scheduler.go:268-276 wires it).
# ---------------------------------------------------------------------------

_API_VERSIONS = (
    "kubescheduler.config.k8s.io/v1",
    "kubescheduler.config.tpu/v1",
)
_TOP_KEYS = {
    "apiVersion", "kind", "parallelism", "percentageOfNodesToScore",
    "podInitialBackoffSeconds", "podMaxBackoffSeconds", "profiles",
    "featureGates", "batchSize", "batchWindowSeconds", "assumeTTLSeconds",
    "unschedulableFlushSeconds", "maxPreemptionsPerCycle",
    "adaptiveBatchWindow", "batchWindowMinSeconds", "batchWindowMaxSeconds",
    "batchLatencySLOSeconds", "meshDevices", "commitSubwaveConcurrency",
    "schedulerLanes", "speculativeSolve", "streamSubwaves",
    "sliceCarveoutPolicy", "sliceMaxDim", "partialsResyncInterval",
    "nodeAxisHeadroom", "bucketShrinkDwell", "compactionBatchRows",
}


def load_config(source: Any) -> SchedulerConfiguration:
    """Load a KubeSchedulerConfiguration-shaped document: a YAML file
    path, a YAML string, or an already-parsed dict.  Unknown top-level
    fields are rejected (the strict-decoding posture); the result is
    defaulted and validated."""
    import os

    if isinstance(source, dict):
        doc = source
    else:
        import yaml

        text = source
        if isinstance(source, str) and os.path.exists(source):
            with open(source) as f:
                text = f.read()
        doc = yaml.safe_load(text) or {}
    if doc.get("kind", "KubeSchedulerConfiguration") != "KubeSchedulerConfiguration":
        raise ValueError(f"unexpected kind {doc.get('kind')!r}")
    api_version = doc.get("apiVersion", _API_VERSIONS[0])
    if api_version not in _API_VERSIONS:
        raise ValueError(
            f"unsupported apiVersion {api_version!r}; known: {_API_VERSIONS}"
        )
    unknown = set(doc) - _TOP_KEYS
    if unknown:
        raise ValueError(f"unknown configuration fields: {sorted(unknown)}")

    cfg = SchedulerConfiguration()
    if "parallelism" in doc:
        cfg.parallelism = int(doc["parallelism"])
    if "percentageOfNodesToScore" in doc:
        cfg.percentage_of_nodes_to_score = int(doc["percentageOfNodesToScore"])
    if "podInitialBackoffSeconds" in doc:
        cfg.pod_initial_backoff_seconds = float(doc["podInitialBackoffSeconds"])
    if "podMaxBackoffSeconds" in doc:
        cfg.pod_max_backoff_seconds = float(doc["podMaxBackoffSeconds"])
    if "batchSize" in doc:
        cfg.batch_size = int(doc["batchSize"])
    if "batchWindowSeconds" in doc:
        cfg.batch_window_seconds = float(doc["batchWindowSeconds"])
    if "adaptiveBatchWindow" in doc:
        cfg.adaptive_batch_window = bool(doc["adaptiveBatchWindow"])
    if "batchWindowMinSeconds" in doc:
        cfg.batch_window_min_seconds = float(doc["batchWindowMinSeconds"])
    if "batchWindowMaxSeconds" in doc:
        cfg.batch_window_max_seconds = float(doc["batchWindowMaxSeconds"])
    if "batchLatencySLOSeconds" in doc:
        cfg.batch_latency_slo_seconds = float(doc["batchLatencySLOSeconds"])
    if "assumeTTLSeconds" in doc:
        cfg.assume_ttl_seconds = float(doc["assumeTTLSeconds"])
    if "unschedulableFlushSeconds" in doc:
        cfg.unschedulable_flush_seconds = float(doc["unschedulableFlushSeconds"])
    if "maxPreemptionsPerCycle" in doc:
        cfg.max_preemptions_per_cycle = int(doc["maxPreemptionsPerCycle"])
    if "meshDevices" in doc:
        cfg.mesh_devices = int(doc["meshDevices"])
    if "commitSubwaveConcurrency" in doc:
        cfg.commit_subwave_concurrency = int(doc["commitSubwaveConcurrency"])
    if "schedulerLanes" in doc:
        cfg.scheduler_lanes = int(doc["schedulerLanes"])
    if "speculativeSolve" in doc:
        cfg.speculative_solve = bool(doc["speculativeSolve"])
    if "streamSubwaves" in doc:
        cfg.stream_subwaves = bool(doc["streamSubwaves"])
    if "sliceCarveoutPolicy" in doc:
        cfg.slice_carveout_policy = str(doc["sliceCarveoutPolicy"])
    if "sliceMaxDim" in doc:
        cfg.slice_max_dim = int(doc["sliceMaxDim"])
    if "partialsResyncInterval" in doc:
        cfg.partials_resync_interval = int(doc["partialsResyncInterval"])
    if "nodeAxisHeadroom" in doc:
        cfg.node_axis_headroom = float(doc["nodeAxisHeadroom"])
    if "bucketShrinkDwell" in doc:
        cfg.bucket_shrink_dwell = int(doc["bucketShrinkDwell"])
    if "compactionBatchRows" in doc:
        cfg.compaction_batch_rows = int(doc["compactionBatchRows"])
    if "featureGates" in doc:
        cfg.feature_gates = {
            str(k): bool(v) for k, v in (doc["featureGates"] or {}).items()
        }
    if "profiles" in doc:
        cfg.profiles = [_load_profile(p) for p in doc["profiles"] or []]
    return cfg.validate()


def _load_profile(doc: Dict[str, Any]) -> ProfileConfig:
    unknown = set(doc) - {"schedulerName", "plugins", "pluginConfig"}
    if unknown:
        raise ValueError(f"unknown profile fields: {sorted(unknown)}")
    profile = ProfileConfig(
        scheduler_name=doc.get("schedulerName", "default-scheduler")
    )
    score_kwargs: Dict[str, Any] = {}
    plugins = doc.get("plugins") or {}
    score = plugins.get("score") or {}
    disabled = tuple(
        d["name"] for d in score.get("disabled") or [] if d.get("name") != "*"
    )
    profile.disabled_score_plugins = disabled
    for e in score.get("enabled") or []:
        name, weight = e.get("name"), e.get("weight")
        if name not in SCORE_PLUGIN_WEIGHTS:
            raise ValueError(
                f"unknown score plugin {name!r}; known: "
                f"{sorted(SCORE_PLUGIN_WEIGHTS)}"
            )
        if weight is not None:
            score_kwargs[SCORE_PLUGIN_WEIGHTS[name]] = float(weight)
    for pc in doc.get("pluginConfig") or []:
        if pc.get("name") == "NodeResourcesFit":
            strat = (pc.get("args") or {}).get("scoringStrategy") or {}
            if "type" in strat:
                score_kwargs["fit_strategy"] = strat["type"]
            shape = strat.get("requestedToCapacityRatio", {}).get("shape")
            if shape:
                score_kwargs["rtcr_shape"] = tuple(
                    (float(p["utilization"]), float(p["score"]))
                    for p in shape
                )
    if score_kwargs:
        profile.score_config = replace(DEFAULT_SCORE_CONFIG, **score_kwargs)
    return profile
