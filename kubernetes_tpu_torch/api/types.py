"""Core API object model: the Pod/Node subset the scheduler port encodes,
the storage, device-claim and Event objects its loop's binders and
event recorder read and write, and the Lease its leader election holds.

A copy of the reference package's object model, cut to what the encoder,
the scheduler loop and the test builders read.  Field names are identical, so the encoder
also reads the reference package's objects by duck typing.

The Python-native equivalent of the reference's versioned API types
(reference: staging/src/k8s.io/api/core/v1/types.go and
pkg/apis/core/types.go).  Only the fields the control plane and scheduler
actually consume are modelled; everything is a plain dataclass so objects
are cheap to construct in tests and benchmarks (the reference's builder
wrappers, pkg/scheduler/testing/wrappers.go, have an equivalent in
testing.wrappers).

Conventions:
  * cpu is always integer milli-cores, memory/ephemeral-storage integer
    bytes, every other resource an integer count (the canonical units the
    reference's resource.Quantity MilliValue()/Value() calls produce).
  * labels/annotations are plain dicts.
"""

from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Resource names (reference: staging/src/k8s.io/api/core/v1/types.go ResourceName)
# ---------------------------------------------------------------------------

CPU = "cpu"                      # milli-cores
MEMORY = "memory"                # bytes
EPHEMERAL_STORAGE = "ephemeral-storage"  # bytes
PODS = "pods"                    # count

# Default requests applied for *scoring only* when a pod declares none
# (reference: pkg/scheduler/util/pod_resources.go:33-36).
DEFAULT_MILLI_CPU_REQUEST = 100
DEFAULT_MEMORY_REQUEST = 200 * 1024 * 1024

# Taint effects (reference: api/core/v1/types.go TaintEffect)
NO_SCHEDULE = "NoSchedule"
PREFER_NO_SCHEDULE = "PreferNoSchedule"
NO_EXECUTE = "NoExecute"
TAINT_EFFECTS = (NO_SCHEDULE, PREFER_NO_SCHEDULE, NO_EXECUTE)

# Well-known taint applied to cordoned nodes
# (reference: staging/src/k8s.io/api/core/v1/well_known_taints.go).
TAINT_NODE_UNSCHEDULABLE = "node.kubernetes.io/unschedulable"
TAINT_NODE_NOT_READY = "node.kubernetes.io/not-ready"
TAINT_NODE_UNREACHABLE = "node.kubernetes.io/unreachable"

# Well-known labels
LABEL_HOSTNAME = "kubernetes.io/hostname"
LABEL_ZONE = "topology.kubernetes.io/zone"
LABEL_REGION = "topology.kubernetes.io/region"

# TPU slice-topology node labels (the GKE tpu-topology label family,
# normalized): a node that is one device of a multi-host TPU slice
# carries its slice (pool) name, the slice's torus extent "XxYxZ", its
# own coordinates "x,y,z" within the slice, and (optionally) a core
# index on the host.  ops/schema.py encodes them into the cluster
# tensors (slice_id / torus_coords / slice_dims / slice_pos);
# ops/slices.py carves gangs out of them.
LABEL_TPU_SLICE = "tpu.kubernetes.io/slice"
LABEL_TPU_TOPOLOGY = "tpu.kubernetes.io/topology"
LABEL_TPU_COORDS = "tpu.kubernetes.io/coords"
LABEL_TPU_CORE = "tpu.kubernetes.io/core"


def parse_topology(text) -> Optional[Tuple[int, int, int]]:
    """Parse an "AxBxC" torus-extent string (1 or 2 axes are padded
    with trailing 1s: "8" -> (8,1,1), "4x2" -> (4,2,1)).  Returns None
    for anything unparseable or non-positive — callers treat that as
    'no declared topology', never an error (one malformed label must
    not sink an encode)."""
    if not text or not isinstance(text, str):
        return None
    parts = text.lower().split("x")
    if not 1 <= len(parts) <= 3:
        return None
    try:
        dims = [int(p) for p in parts]
    except ValueError:
        return None
    if any(d <= 0 for d in dims):
        return None
    return tuple(dims + [1] * (3 - len(dims)))


def parse_coords(text) -> Optional[Tuple[int, int, int]]:
    """Parse an "x,y,z" in-slice coordinate string (missing trailing
    axes read 0).  None for unparseable/negative values."""
    if not text or not isinstance(text, str):
        return None
    parts = text.split(",")
    if not 1 <= len(parts) <= 3:
        return None
    try:
        coords = [int(p) for p in parts]
    except ValueError:
        return None
    if any(c < 0 for c in coords):
        return None
    return tuple(coords + [0] * (3 - len(parts)))

_uid_counter = itertools.count(1)


def _new_uid() -> str:
    return f"uid-{next(_uid_counter)}"


# ---------------------------------------------------------------------------
# Metadata
# ---------------------------------------------------------------------------


@dataclass
class ObjectMeta:
    """reference: staging/src/k8s.io/apimachinery/pkg/apis/meta/v1/types.go ObjectMeta."""

    name: str = ""
    namespace: str = "default"
    uid: str = field(default_factory=_new_uid)
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    resource_version: int = 0
    generation: int = 0
    creation_timestamp: float = 0.0
    deletion_timestamp: Optional[float] = None
    owner_references: List["OwnerReference"] = field(default_factory=list)
    finalizers: List[str] = field(default_factory=list)


@dataclass
class OwnerReference:
    kind: str = ""
    name: str = ""
    uid: str = ""
    controller: bool = False


# ---------------------------------------------------------------------------
# Selectors / affinity (reference: api/core/v1/types.go NodeSelector et al.)
# ---------------------------------------------------------------------------

OP_IN = "In"
OP_NOT_IN = "NotIn"
OP_EXISTS = "Exists"
OP_DOES_NOT_EXIST = "DoesNotExist"
OP_GT = "Gt"
OP_LT = "Lt"
OP_EQUAL = "Equal"  # toleration operator


@dataclass
class Requirement:
    """One match expression: NodeSelectorRequirement / LabelSelectorRequirement."""

    key: str
    op: str = OP_IN
    values: List[str] = field(default_factory=list)

    def matches(self, labels: Dict[str, str]) -> bool:
        """Label-set semantics (reference: apimachinery/pkg/labels/selector.go
        Requirement.Matches — NotIn/DoesNotExist match when the key is absent)."""
        present = self.key in labels
        if self.op == OP_IN:
            return present and labels[self.key] in self.values
        if self.op == OP_NOT_IN:
            return (not present) or labels[self.key] not in self.values
        if self.op == OP_EXISTS:
            return present
        if self.op == OP_DOES_NOT_EXIST:
            return not present
        if self.op in (OP_GT, OP_LT):
            # Both the label value and the bound must parse as integers;
            # otherwise the requirement doesn't match (labels.Requirement
            # semantics: ParseInt failure => no match).
            if not present:
                return False
            lv = _parse_int(labels[self.key])
            bound = _parse_int(self.values[0]) if self.values else None
            if lv is None or bound is None:
                return False
            return lv > bound if self.op == OP_GT else lv < bound
        raise ValueError(f"unknown operator {self.op}")


def _parse_int(s: str) -> Optional[int]:
    try:
        return int(s)
    except ValueError:
        return None


@dataclass
class NodeSelectorTerm:
    """Expressions are ANDed (reference: v1.NodeSelectorTerm)."""

    match_expressions: List[Requirement] = field(default_factory=list)

    def matches(self, labels: Dict[str, str]) -> bool:
        return all(r.matches(labels) for r in self.match_expressions)


@dataclass
class NodeSelector:
    """Terms are ORed (reference: v1.NodeSelector)."""

    terms: List[NodeSelectorTerm] = field(default_factory=list)

    def matches(self, labels: Dict[str, str]) -> bool:
        return any(t.matches(labels) for t in self.terms)


@dataclass
class PreferredSchedulingTerm:
    weight: int = 1
    preference: NodeSelectorTerm = field(default_factory=NodeSelectorTerm)


@dataclass
class LabelSelector:
    """reference: metav1.LabelSelector — match_labels ANDed with expressions."""

    match_labels: Dict[str, str] = field(default_factory=dict)
    match_expressions: List[Requirement] = field(default_factory=list)

    def matches(self, labels: Dict[str, str]) -> bool:
        for k, v in self.match_labels.items():
            if labels.get(k) != v:
                return False
        return all(r.matches(labels) for r in self.match_expressions)

    def requirements(self) -> List[Requirement]:
        """Canonical AND-of-requirements form."""
        reqs = [Requirement(k, OP_IN, [v]) for k, v in sorted(self.match_labels.items())]
        reqs.extend(self.match_expressions)
        return reqs


def and_selectors(
    a: Optional["NodeSelector"], b: Optional["NodeSelector"]
) -> Optional["NodeSelector"]:
    """AND of two OR-of-AND NodeSelectors: the term cross product (the
    same distribution GetRequiredNodeAffinity applies to nodeSelector +
    affinity)."""
    if a is None:
        return b
    if b is None:
        return a
    return NodeSelector(
        terms=[
            NodeSelectorTerm(
                match_expressions=list(ta.match_expressions)
                + list(tb.match_expressions)
            )
            for ta in a.terms
            for tb in b.terms
        ]
    )


@dataclass
class PodAffinityTerm:
    """reference: v1.PodAffinityTerm."""

    label_selector: Optional[LabelSelector] = None
    topology_key: str = LABEL_HOSTNAME
    namespaces: List[str] = field(default_factory=list)  # empty => pod's own ns
    # namespace_selector needs Namespace objects (not modelled); encode
    # raises when set rather than silently ignoring it.
    namespace_selector: Optional[LabelSelector] = None
    # match_label_keys fold the *incoming pod's* label values into the
    # selector at schedule time (interpodaffinity PreFilter since 1.29);
    # the encoder implements this merge.
    match_label_keys: List[str] = field(default_factory=list)


@dataclass
class WeightedPodAffinityTerm:
    weight: int = 1
    term: PodAffinityTerm = field(default_factory=PodAffinityTerm)


@dataclass
class PodAffinity:
    required: List[PodAffinityTerm] = field(default_factory=list)
    preferred: List[WeightedPodAffinityTerm] = field(default_factory=list)


@dataclass
class PodAntiAffinity:
    required: List[PodAffinityTerm] = field(default_factory=list)
    preferred: List[WeightedPodAffinityTerm] = field(default_factory=list)


@dataclass
class NodeAffinity:
    required: Optional[NodeSelector] = None
    preferred: List[PreferredSchedulingTerm] = field(default_factory=list)


@dataclass
class Affinity:
    node_affinity: Optional[NodeAffinity] = None
    pod_affinity: Optional[PodAffinity] = None
    pod_anti_affinity: Optional[PodAntiAffinity] = None


@dataclass
class TopologySpreadConstraint:
    """reference: v1.TopologySpreadConstraint."""

    max_skew: int = 1
    topology_key: str = LABEL_ZONE
    when_unsatisfiable: str = "DoNotSchedule"  # or "ScheduleAnyway"
    label_selector: Optional[LabelSelector] = None
    # When fewer eligible domains than min_domains exist, global minimum
    # is treated as 0 (filtering.go minMatchNum); DoNotSchedule only.
    min_domains: Optional[int] = None
    # Pod label values at these keys merge into the selector at schedule
    # time (PreFilter); the encoder implements this merge.
    match_label_keys: List[str] = field(default_factory=list)
    # NodeInclusionPolicies: only the reference defaults are implemented
    # (Honor affinity, Ignore taints); encode raises on other values.
    node_affinity_policy: str = "Honor"   # Honor | Ignore
    node_taints_policy: str = "Ignore"    # Honor | Ignore


# ---------------------------------------------------------------------------
# Taints / tolerations
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Taint:
    key: str
    value: str = ""
    effect: str = NO_SCHEDULE


@dataclass
class Toleration:
    """reference: v1.Toleration.ToleratesTaint (api/core/v1/toleration.go)."""

    key: str = ""                 # empty key + Exists tolerates everything
    op: str = OP_EXISTS           # Exists | Equal
    value: str = ""
    effect: str = ""              # empty effect matches all effects
    toleration_seconds: Optional[int] = None

    def tolerates(self, taint: Taint) -> bool:
        if self.effect and self.effect != taint.effect:
            return False
        if self.key and self.key != taint.key:
            return False
        if not self.key:
            return self.op == OP_EXISTS
        if self.op == OP_EXISTS:
            return True
        return self.value == taint.value


def tolerations_tolerate_taint(tols: List[Toleration], taint: Taint) -> bool:
    return any(t.tolerates(taint) for t in tols)


# ---------------------------------------------------------------------------
# Pods
# ---------------------------------------------------------------------------


@dataclass
class ContainerPort:
    name: str = ""                # named port (Service targetPort refs)
    container_port: int = 0
    host_port: int = 0            # 0 => no host port claim
    protocol: str = "TCP"
    host_ip: str = ""             # "" or "0.0.0.0" => wildcard


@dataclass
class Probe:
    """core/v1 Probe timing envelope (types.go Probe).  The probe
    ACTION (exec/http/tcp) is carried out by the node agent's runtime;
    the hollow runtime resolves outcomes from agent annotations so
    tests and kubemark can script failures (agent.py)."""

    initial_delay_seconds: float = 0.0
    period_seconds: float = 1.0
    failure_threshold: int = 3
    success_threshold: int = 1
    timeout_seconds: float = 1.0


@dataclass
class Container:
    name: str = "c"
    image: str = ""
    requests: Dict[str, int] = field(default_factory=dict)
    limits: Dict[str, int] = field(default_factory=dict)
    ports: List[ContainerPort] = field(default_factory=list)
    readiness_probe: Optional[Probe] = None
    liveness_probe: Optional[Probe] = None
    startup_probe: Optional[Probe] = None


@dataclass
class Volume:
    """Pod volume: only the PVC source is modelled (the scheduling-
    relevant one; core/v1/types.go Volume has ~30 sources)."""

    name: str = ""
    persistent_volume_claim: Optional[str] = None  # claim name in pod ns


@dataclass
class PodSpec:
    node_name: str = ""           # set at bind time
    containers: List[Container] = field(default_factory=list)
    init_containers: List[Container] = field(default_factory=list)
    overhead: Dict[str, int] = field(default_factory=dict)
    affinity: Optional[Affinity] = None
    node_selector: Dict[str, str] = field(default_factory=dict)
    tolerations: List[Toleration] = field(default_factory=list)
    topology_spread_constraints: List[TopologySpreadConstraint] = field(default_factory=list)
    priority: int = 0
    preemption_policy: str = "PreemptLowerPriority"  # or "Never"
    scheduler_name: str = "default-scheduler"
    # Gang/coscheduling group: pods sharing a group name schedule
    # all-or-nothing in the joint batched solve (the out-of-tree
    # coscheduling PodGroup pattern; no in-tree reference counterpart).
    scheduling_group: Optional[str] = None
    # Declared gang size (the PodGroup minMember analogue).  When set,
    # the scheduling queue stages arriving members and releases the gang
    # to the active tier only once this many are present, so a gang is
    # never solved (and hence never partially bound) before it is whole.
    scheduling_group_size: Optional[int] = None
    scheduling_gates: List[str] = field(default_factory=list)
    # Requested TPU carve-out shape "AxBxC" (api.parse_topology): the
    # pod — or, for a gang, every member of its scheduling_group — asks
    # to be placed as a contiguous axis-aligned sub-cuboid of one TPU
    # slice (ops/slices.py).  Empty = no topology request.
    tpu_topology: str = ""
    restart_policy: str = "Always"
    termination_grace_period_seconds: int = 30
    service_account: str = ""  # defaulted to "default" at admission
    volumes: List[Volume] = field(default_factory=list)  # unused by the solves
    # ResourceClaim names (pod namespace) this pod consumes — the
    # pod.spec.resourceClaims reference (DRA)
    resource_claims: List[str] = field(default_factory=list)


@dataclass
class PodStatus:
    phase: str = "Pending"        # Pending | Running | Succeeded | Failed
    conditions: List[Dict[str, Any]] = field(default_factory=list)
    nominated_node_name: str = ""
    pod_ip: str = ""              # set by the node agent once running
    host_ip: str = ""
    # per-container restart counts, by container name (node agent v1);
    # the containerStatuses[].restartCount aggregate
    restart_counts: Dict[str, int] = field(default_factory=dict)


@dataclass
class Pod:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)

    KIND = "Pod"

    # -- derived ---------------------------------------------------------

    def resource_requests(self) -> Dict[str, int]:
        """Effective pod request: sum of containers, elementwise max with the
        largest init container, plus overhead
        (reference: pkg/api/v1/resource/helpers.go PodRequests)."""
        total: Dict[str, int] = {}
        for c in self.spec.containers:
            for k, v in c.requests.items():
                total[k] = total.get(k, 0) + v
        for ic in self.spec.init_containers:
            for k, v in ic.requests.items():
                if v > total.get(k, 0):
                    total[k] = v
        for k, v in self.spec.overhead.items():
            total[k] = total.get(k, 0) + v
        return total

    def nonzero_requests(self) -> Tuple[int, int]:
        """(milli_cpu, memory) with scoring defaults applied
        (reference: pkg/scheduler/util/pod_resources.go GetNonzeroRequests)."""
        req = self.resource_requests()
        return (
            req.get(CPU, DEFAULT_MILLI_CPU_REQUEST),
            req.get(MEMORY, DEFAULT_MEMORY_REQUEST),
        )

    def host_ports(self) -> List[Tuple[str, str, int]]:
        """(protocol, host_ip, port) triples claimed by this pod."""
        out = []
        for c in self.spec.containers:
            for p in c.ports:
                if p.host_port > 0:
                    out.append((p.protocol, p.host_ip or "0.0.0.0", p.host_port))
        return out

    def required_node_selector(self) -> Optional[NodeSelector]:
        """Merge .spec.node_selector and required node affinity into one
        NodeSelector in CNF-ish form.  node_selector entries are ANDed into
        every term (reference semantics: both must match —
        component-helpers/scheduling/corev1/nodeaffinity.GetRequiredNodeAffinity)."""
        ns_reqs = [Requirement(k, OP_IN, [v]) for k, v in sorted(self.spec.node_selector.items())]
        aff = self.spec.affinity.node_affinity if self.spec.affinity else None
        req_sel = aff.required if aff else None
        if req_sel is None or not req_sel.terms:
            if not ns_reqs:
                return None
            return NodeSelector(terms=[NodeSelectorTerm(match_expressions=ns_reqs)])
        terms = [
            NodeSelectorTerm(match_expressions=ns_reqs + list(t.match_expressions))
            for t in req_sel.terms
        ]
        return NodeSelector(terms=terms)

    def preferred_node_affinity(self) -> List[PreferredSchedulingTerm]:
        aff = self.spec.affinity.node_affinity if self.spec.affinity else None
        return list(aff.preferred) if aff else []


# ---------------------------------------------------------------------------
# Nodes
# ---------------------------------------------------------------------------


@dataclass
class NodeSpec:
    unschedulable: bool = False
    taints: List[Taint] = field(default_factory=list)
    provider_id: str = ""


@dataclass
class ContainerImage:
    names: List[str] = field(default_factory=list)
    size_bytes: int = 0


@dataclass
class NodeStatus:
    allocatable: Dict[str, int] = field(default_factory=dict)
    capacity: Dict[str, int] = field(default_factory=dict)
    images: List[ContainerImage] = field(default_factory=list)
    conditions: List[Dict[str, Any]] = field(default_factory=list)


@dataclass
class Node:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)

    KIND = "Node"

    def effective_taints(self) -> List[Taint]:
        """Spec taints plus the synthetic unschedulable taint for cordoned
        nodes (the reference's NodeUnschedulable plugin consults the spec
        flag but honours tolerations of node.kubernetes.io/unschedulable —
        pkg/scheduler/framework/plugins/nodeunschedulable/node_unschedulable.go:60-76;
        modelling it as a taint gives identical semantics in one code path)."""
        taints = list(self.spec.taints)
        if self.spec.unschedulable:
            t = Taint(TAINT_NODE_UNSCHEDULABLE, "", NO_SCHEDULE)
            if t not in taints:
                taints.append(t)
        return taints


# ---------------------------------------------------------------------------
# Policy APIs (reference: staging/src/k8s.io/api/policy/v1/types.go
# PodDisruptionBudget) — consumed by preemption's victim ranking.
# ---------------------------------------------------------------------------


@dataclass
class PodDisruptionBudgetSpec:
    selector: Optional[LabelSelector] = None
    min_available: Optional[int] = None     # at least this many healthy
    max_unavailable: Optional[int] = None   # at most this many disrupted


@dataclass
class PodDisruptionBudgetStatus:
    disruptions_allowed: int = 0
    current_healthy: int = 0
    desired_healthy: int = 0
    expected_pods: int = 0


@dataclass
class PodDisruptionBudget:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodDisruptionBudgetSpec = field(
        default_factory=PodDisruptionBudgetSpec
    )
    status: PodDisruptionBudgetStatus = field(
        default_factory=PodDisruptionBudgetStatus
    )

    KIND = "PodDisruptionBudget"

    def matches(self, pod: "Pod") -> bool:
        if pod.meta.namespace != self.meta.namespace:
            return False
        sel = self.spec.selector
        return sel is not None and sel.matches(pod.meta.labels)



# ---------------------------------------------------------------------------
# Storage APIs (reference: staging/src/k8s.io/api/core/v1/types.go
# PersistentVolume/PersistentVolumeClaim, storage/v1/types.go
# StorageClass) — the slice VolumeBinding schedules against.
# ---------------------------------------------------------------------------

STORAGE = "storage"                       # PVC resource request key
VOLUME_BINDING_IMMEDIATE = "Immediate"
VOLUME_BINDING_WAIT = "WaitForFirstConsumer"
PV_AVAILABLE = "Available"
PV_BOUND = "Bound"
PV_RELEASED = "Released"
PVC_PENDING = "Pending"
PVC_BOUND = "Bound"
# node-allocatable key prefix for attach limits (the reference models
# CSI attach limits as node-published countable resources —
# nodevolumelimits/csi.go GetVolumeLimitKey)
ATTACH_LIMIT_PREFIX = "attachable-volumes-"


def attach_limit_resource(driver: str) -> str:
    return ATTACH_LIMIT_PREFIX + driver


@dataclass
class PersistentVolumeSpec:
    capacity: Dict[str, int] = field(default_factory=dict)  # {storage: bytes}
    access_modes: List[str] = field(default_factory=list)
    storage_class_name: str = ""
    # topology constraint: node must satisfy this to mount the volume
    # (core/v1 VolumeNodeAffinity.required)
    node_affinity: Optional[NodeSelector] = None
    claim_ref: Optional[str] = None       # "namespace/name" of bound claim
    claim_uid: str = ""                   # that claim's uid: a deleted-and-
    # recreated same-name PVC must NOT silently inherit the volume
    # (pv_controller.go checks claimRef.UID for exactly this)
    driver: str = ""                      # CSI driver (attach-limit bucket)
    # Retain | Delete | Recycle (core/v1 PersistentVolumeReclaimPolicy;
    # acted on by the PV controller when the claim goes away)
    reclaim_policy: str = "Retain"


@dataclass
class PersistentVolumeStatus:
    phase: str = PV_AVAILABLE


@dataclass
class PersistentVolume:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PersistentVolumeSpec = field(default_factory=PersistentVolumeSpec)
    status: PersistentVolumeStatus = field(
        default_factory=PersistentVolumeStatus
    )

    KIND = "PersistentVolume"

    def storage(self) -> int:
        return int(self.spec.capacity.get(STORAGE, 0))


@dataclass
class PersistentVolumeClaimSpec:
    access_modes: List[str] = field(default_factory=list)
    storage_class_name: str = ""
    resources: Dict[str, int] = field(default_factory=dict)  # {storage: bytes}
    volume_name: str = ""                 # set when bound to a PV


@dataclass
class PersistentVolumeClaimStatus:
    phase: str = PVC_PENDING


@dataclass
class PersistentVolumeClaim:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PersistentVolumeClaimSpec = field(
        default_factory=PersistentVolumeClaimSpec
    )
    status: PersistentVolumeClaimStatus = field(
        default_factory=PersistentVolumeClaimStatus
    )

    KIND = "PersistentVolumeClaim"

    def requested_storage(self) -> int:
        return int(self.spec.resources.get(STORAGE, 0))


@dataclass
class StorageClass:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    provisioner: str = ""
    volume_binding_mode: str = VOLUME_BINDING_IMMEDIATE
    # restrict dynamic provisioning to these topologies (storage/v1
    # StorageClass.allowedTopologies, as OR-of-AND selector terms)
    allowed_topologies: Optional[NodeSelector] = None

    KIND = "StorageClass"


# ---------------------------------------------------------------------------
# Dynamic resource allocation (reference: resource.k8s.io ResourceClaim /
# DeviceClass, scheduled by plugins/dynamicresources/dynamicresources.go)
# — device claims as first-class objects with allocation lifecycle.
# ---------------------------------------------------------------------------


def device_resource(class_name: str) -> str:
    """The node-allocatable resource name carrying a device class's
    per-node capacity (the devicemanager-published countable-resource
    convention)."""
    return f"devices/{class_name}"


@dataclass
class DeviceClass:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    driver: str = ""

    KIND = "DeviceClass"


@dataclass
class ResourceClaimSpec:
    device_class_name: str = ""
    count: int = 1                 # devices requested from the class
    # Topology-shaped claim: request an "AxBxC" contiguous carve-out of
    # one TPU slice instead of `count` loose devices.  Allocation
    # records the carve-out (status.carveout) and every consumer is
    # pinned INSIDE it via slice/coord label selector terms — matched
    # in the batched filter, not host Python.
    topology: str = ""


@dataclass
class ResourceClaimStatus:
    phase: str = "Pending"         # Pending | Allocated
    allocated_node: str = ""       # set at allocation (Reserve/PreBind)
    # the consumer pod (ns/name) whose resource accounting carries the
    # claim's device count — keeps usage stable across the pod's
    # lifetime while sharers add only the co-location pin
    carrier: str = ""
    # topology-shaped allocation record: "slice=<name>;lo=x,y,z;shape=AxBxC"
    # (scheduler/deviceclaims.py format_carveout) — the carved sub-cuboid
    # consumers are pinned inside
    carveout: str = ""


@dataclass
class ResourceClaim:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ResourceClaimSpec = field(default_factory=ResourceClaimSpec)
    status: ResourceClaimStatus = field(default_factory=ResourceClaimStatus)

    KIND = "ResourceClaim"


@dataclass
class ObjectReference:
    """core/v1 ObjectReference — the involved object of an Event."""

    kind: str = ""
    name: str = ""
    namespace: str = "default"
    uid: str = ""


@dataclass
class Event:
    """core/v1 Event, the slice the scheduler's EventRecorder emits
    (schedule_one.go:1003 Eventf; aggregated by count like
    client-go's correlator)."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    involved_object: ObjectReference = field(default_factory=ObjectReference)
    reason: str = ""
    message: str = ""
    type: str = "Normal"          # Normal | Warning
    count: int = 1
    first_timestamp: float = 0.0
    last_timestamp: float = 0.0
    source_component: str = ""

    KIND = "Event"


@dataclass
class LeaseSpec:
    """coordination.k8s.io/v1 LeaseSpec — the leader-election record."""

    holder_identity: str = ""
    lease_duration_seconds: int = 15
    acquire_time: float = 0.0
    renew_time: float = 0.0
    lease_transitions: int = 0


@dataclass
class Lease:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: LeaseSpec = field(default_factory=LeaseSpec)

    KIND = "Lease"


# kinds that live outside namespaces (the store keys them at namespace ""),
# the reference's set restricted to the kinds this package defines
CLUSTER_SCOPED_KINDS = frozenset({
    "Node", "PersistentVolume", "StorageClass", "DeviceClass",
})
