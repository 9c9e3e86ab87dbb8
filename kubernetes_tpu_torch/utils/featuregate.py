"""Feature gates — staged feature lifecycle with override validation: a
copy of the reference package's utils/featuregate.py, whole.

Reference: component-base/featuregate/feature_gate.go +
pkg/features/kube_features.go: a known-features map with per-feature
default + maturity stage, overridden by `--feature-gates=Foo=true` /
componentconfig maps, consulted at plugin-registry/router build time
(plugins/registry.go:58-70).  GA-locked features reject overrides the
way LockToDefault does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional

ALPHA = "ALPHA"
BETA = "BETA"
GA = "GA"


@dataclass(frozen=True)
class FeatureSpec:
    default: bool
    stage: str = BETA
    lock_to_default: bool = False


# The framework's gateable behaviors (the kube_features.go analogue).
DEFAULT_FEATURES: Dict[str, FeatureSpec] = {
    # route large/gang batches to the joint auction solve instead of the
    # greedy scan (models/batch_scheduler._route)
    "AuctionSolver": FeatureSpec(True, BETA),
    # device-resident cluster mirror with delta sync (models/mirror.py)
    "DeviceClusterMirror": FeatureSpec(True, BETA),
    # incremental O(changes) solving: device-resident Filter/Score
    # partials warm-starting every greedy/wavefront solve, scatter-
    # refreshed from the mirror's dirty rows (models/partials.py).
    # Requires DeviceClusterMirror — disabled along with it.
    "IncrementalSolve": FeatureSpec(True, BETA),
    # node-axis-sharded multichip solve when the config names a mesh
    # (SchedulerConfiguration.mesh_devices; parallel/sharded.py) — off
    # pins every profile to the single chip regardless of meshDevices
    "ShardedSolve": FeatureSpec(True, BETA),
    # PV/PVC topology + attach limits in scheduling
    # (scheduler/volumebinding.py)
    "VolumeBinding": FeatureSpec(True, BETA),
    # PodDisruptionBudget-aware victim ranking (scheduler/preemption.py)
    "PDBAwarePreemption": FeatureSpec(True, BETA),
    # ResourceClaim/DeviceClass scheduling (scheduler/deviceclaims.py)
    "DynamicResourceAllocation": FeatureSpec(True, BETA),
    # gang staging in the queue + all-or-nothing post-pass; GA and
    # locked — the north-star workload depends on it
    "GangScheduling": FeatureSpec(True, GA, lock_to_default=True),
}


class FeatureGate:
    def __init__(
        self,
        known: Optional[Mapping[str, FeatureSpec]] = None,
        overrides: Optional[Mapping[str, bool]] = None,
    ):
        self._known = dict(known if known is not None else DEFAULT_FEATURES)
        self._overrides: Dict[str, bool] = {}
        if overrides:
            self.set_from_map(overrides)

    def set_from_map(self, overrides: Mapping[str, bool]) -> "FeatureGate":
        """Apply overrides, validating names and GA locks (SetFromMap)."""
        for name, value in overrides.items():
            spec = self._known.get(name)
            if spec is None:
                raise ValueError(
                    f"unknown feature gate {name!r}; known: "
                    f"{sorted(self._known)}"
                )
            if spec.lock_to_default and value != spec.default:
                raise ValueError(
                    f"feature gate {name} is {spec.stage} and locked to "
                    f"{spec.default}"
                )
            self._overrides[name] = bool(value)
        return self

    @classmethod
    def from_flag(cls, flag: str) -> "FeatureGate":
        """Parse `Foo=true,Bar=false` (the --feature-gates flag shape)."""
        overrides = {}
        for part in flag.split(","):
            part = part.strip()
            if not part:
                continue
            name, _, raw = part.partition("=")
            if raw.lower() not in ("true", "false"):
                raise ValueError(
                    f"feature gate {part!r}: value must be true|false"
                )
            overrides[name.strip()] = raw.lower() == "true"
        return cls(overrides=overrides)

    def enabled(self, name: str) -> bool:
        if name in self._overrides:
            return self._overrides[name]
        spec = self._known.get(name)
        if spec is None:
            raise ValueError(f"unknown feature gate {name!r}")
        return spec.default

    def as_map(self) -> Dict[str, bool]:
        return {name: self.enabled(name) for name in self._known}
