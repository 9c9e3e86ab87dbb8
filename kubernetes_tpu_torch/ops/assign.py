"""Batched assignment solve: the greedy route.

The reference schedules one pod at a time: pop, filter, score, pick, then
`assume` the pod into the cache so the next pod sees its resources
(schedule_one.go:66-133, :940-957).  `greedy_assign` reproduces exactly
those semantics for a whole batch: pods are solved in priority-then-batch
index order (queuesort/priority_sort.go:52), each step evaluates the pod
against the carried usage, picks the first highest-scoring feasible node
and adds the pod's requests to that node before the next step.

Everything placement-independent — the NodeName/TaintToleration/
NodeAffinity filter slice, the bound-port check and the raw
affinity/taint score rows — is hoisted out of the loop per pod *class*
(`class_statics`, schema.PodBatch.class_id).

On the card the solve is three CUDA kernels: `match_terms` (selector and
preferred masks), `class_statics` and `greedy_scan` (the whole sequential
loop in one launch).  On the CPU the plain versions below run; they are
what the tests hold against the reference package.

This slice covers the static, resource and host-port families.  Batches
that use topology spread, inter-pod (anti-)affinity, ImageLocality or
slice carve-outs raise NotImplementedError naming the slice that brings
them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.vocab import pad_dim
from .filters import (
    fits_resources,
    pod_view,
    preferred_match,
    selector_match,
    static_feasible_for_pod,
)
from .schema import ClusterTensors, PodBatch, Snapshot
from .scores import (
    DEFAULT_SCORE_CONFIG,
    ScoreConfig,
    node_affinity_raw,
    score_from_raw,
    taint_toleration_raw,
)

NEG_INF = float("-inf")


class FeatureFlags(NamedTuple):
    """Static gates derived host-side from the encoded batch (the
    reference package's FeatureFlags, field for field)."""

    spread: bool = False       # any topology-spread constraints
    soft_spread: bool = False  # any ScheduleAnyway constraints (scoring)
    interpod: bool = False     # any inter-pod (anti-)affinity terms
    term_slots: Tuple[int, ...] = ()  # topology-key slots those terms use
    ports: bool = False        # any pending pod claims host ports
    interpod_aff: bool = False  # any AFFINITY-direction terms
    spread_slots: Tuple[int, ...] = ()  # topology-key slots spread rows use
    interpod_pref: bool = False  # any preferred (scoring) interpod terms
    images: bool = False         # any pending pod names a known image
    bound_spread: bool = False
    bound_terms: bool = False
    bound_pref: bool = False
    slices: bool = False
    slice_require: bool = False
    slice_z: int = 1
    slice_dim: int = 1


# constraint families this slice does not solve, and the slice that will
_DEFERRED_FAMILIES = (
    ("spread", "PodTopologySpread (constraint-families slice)"),
    ("interpod", "required InterPodAffinity (constraint-families slice)"),
    ("interpod_pref", "preferred InterPodAffinity (constraint-families slice)"),
    ("images", "ImageLocality (constraint-families slice)"),
    ("slices", "TPU slice carve-outs (slice carve-out slice)"),
)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def required_topo_z(snapshot: Snapshot) -> int:
    """Smallest valid topo-value capacity for this snapshot."""
    return pad_dim(int(_np(snapshot.cluster.topo_ids).max()) + 1, 1)


def required_topo_z_split(snapshot: Snapshot) -> Tuple[int, int]:
    """(z_spread, z_terms): value capacities sized to the topology slots
    each family actually uses."""
    topo = _np(snapshot.cluster.topo_ids)

    def z_for(slots) -> int:
        if len(slots) == 0:
            return 1
        return pad_dim(int(topo[:, sorted(slots)].max()) + 1, 1)

    spread_valid = _np(snapshot.spread.valid)
    spread_slots = set(_np(snapshot.spread.slot)[spread_valid].tolist())
    term_valid = _np(snapshot.terms.valid)
    term_slots = set(_np(snapshot.terms.slot)[term_valid].tolist())
    pref_valid = _np(snapshot.prefpod.valid)
    term_slots |= set(_np(snapshot.prefpod.slot)[pref_valid].tolist())
    return z_for(spread_slots), z_for(term_slots)


def features_of(
    snapshot: Snapshot, no_bound_pods: bool = False,
    slice_policy: str = "prefer",
) -> FeatureFlags:
    """Derive the static gates host-side (cheap numpy reductions on the
    encoded, pre-transfer snapshot)."""
    spread_valid = _np(snapshot.spread.valid)
    hard = _np(snapshot.spread.hard)
    term_valid = _np(snapshot.terms.valid)
    slots = _np(snapshot.terms.slot)
    if no_bound_pods:
        bound_spread = bound_terms = bound_pref = False
    else:
        bound_spread = bool(_np(snapshot.spread.node_matches).any())
        bound_terms = bool(
            _np(snapshot.terms.node_matches).any()
            or _np(snapshot.terms.node_owners).any()
        )
        bound_pref = bool(
            _np(snapshot.prefpod.node_counts).any()
            or _np(snapshot.prefpod.owner_weight).any()
        )
    shapes = _np(snapshot.pods.pod_shape)
    sids = _np(snapshot.cluster.slice_id)
    slices_on = (
        slice_policy != "off"
        and bool((shapes.prod(axis=1) > 0).any())
        and bool((sids >= 0).any())
    )
    if slices_on:
        slice_z = pad_dim(int(sids.max()) + 1, 1)
        slice_dim = pad_dim(
            max(int(_np(snapshot.cluster.slice_dims).max()), 1), 1
        )
    else:
        slice_z = slice_dim = 1
    return FeatureFlags(
        spread=bool(spread_valid.any()),
        soft_spread=bool((spread_valid & ~hard).any()),
        interpod=bool(term_valid.any()),
        term_slots=tuple(sorted(set(slots[term_valid].tolist()))),
        ports=bool(_np(snapshot.pods.port_bits).any()),
        interpod_aff=bool((_np(snapshot.terms.aff_idx) >= 0).any()),
        spread_slots=tuple(
            sorted(set(_np(snapshot.spread.slot)[spread_valid].tolist()))
        ),
        interpod_pref=bool(_np(snapshot.prefpod.valid).any()),
        images=bool(
            (_np(snapshot.images.pod_ids) >= 0).any()
            and _np(snapshot.cluster.image_bits).any()
        ),
        bound_spread=bound_spread,
        bound_terms=bound_terms,
        bound_pref=bound_pref,
        slices=slices_on,
        slice_require=slices_on and slice_policy == "require",
        slice_z=slice_z,
        slice_dim=slice_dim,
    )


def check_supported(features: FeatureFlags) -> None:
    """Raise NotImplementedError for a constraint family this slice does
    not solve — a batch is never solved with a family silently dropped."""
    for flag, what in _DEFERRED_FAMILIES:
        if getattr(features, flag):
            raise NotImplementedError(
                f"{what} is not ported yet: the torch greedy solve covers "
                "the static, resource and host-port families only"
            )


# Failure-reason codes: the FIRST filter stage that emptied the pod's
# candidate set (the reference package's REASON_* values).
REASON_NONE = -1      # placed
REASON_STATIC = 0     # NodeName/affinity/taints/validity (+ bound ports)
REASON_RESOURCES = 1  # NodeResourcesFit
REASON_PORTS = 2      # in-batch host-port conflicts
REASON_SPREAD = 3     # PodTopologySpread (hard)
REASON_INTERPOD = 4   # InterPodAffinity (required)
REASON_GANG = 5       # placed individually but released with its gang
REASON_UNENCODABLE = 6  # spec exceeds encoder caps / unsupported field
REASON_SLICE = 7      # slice carve-out (require mode)


class SolveResult(NamedTuple):
    assignment: torch.Tensor   # i32[P]: node index, or -1 unschedulable
    scores: torch.Tensor       # f32[P]: winning node's score (-inf if none)
    feasible_counts: torch.Tensor  # i32[P]: feasible nodes seen by each pod
    cluster: ClusterTensors    # post-solve cluster (assumed placements applied)
    reasons: torch.Tensor = None   # i32[P]: REASON_* for unplaced pods


def class_statics_plain(
    cluster: ClusterTensors,
    pods: PodBatch,
    sel_mask: torch.Tensor,
    pref_mask: torch.Tensor,
    reps: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of kernel `class_statics`: one row per class from its
    representative pod (reps, already clipped to the pod axis)."""
    sfeas, aff, taint = [], [], []
    for rep in reps.tolist():
        pod = pod_view(pods, rep)
        sfeas.append(
            static_feasible_for_pod(cluster, pod, sel_mask)
            & ~((cluster.port_bits & pod.port_bits[None, :]) != 0).any(dim=-1)
        )
        aff.append(node_affinity_raw(pod, pref_mask))
        taint.append(taint_toleration_raw(cluster, pod))
    return torch.stack(sfeas), torch.stack(aff), torch.stack(taint)


def class_statics(
    cluster: ClusterTensors,
    pods: PodBatch,
    sel_mask: torch.Tensor,
    pref_mask: torch.Tensor,
    reps: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-class hoisted tables: (static_feas bool[C, N], aff_raw f32[C, N],
    taint_raw f32[C, N]).  The static feasibility folds in the port check
    against *initial* (bound-pod) port claims; in-batch conflicts ride the
    solve's carry.  Wrapper of kernel `class_statics`: the kernel for
    tensors on the card, the plain version for tensors on the CPU."""
    p = pods.req.shape[0]
    if reps is None:
        reps = torch.clamp(pods.class_rep, 0, p - 1)
    if cluster.allocatable.device.type == "cpu":
        return class_statics_plain(cluster, pods, sel_mask, pref_mask, reps)
    from ..kernels import bindings

    return bindings.class_statics(cluster, pods, sel_mask, pref_mask, reps)


def solve_order(pods: PodBatch) -> torch.Tensor:
    """Priority-then-batch-index pop order (queuesort/priority_sort.go:52:
    higher priority first, earlier arrival breaking ties).  Stable argsort
    on negated priority ≡ lexicographic (-priority, index)."""
    return torch.argsort(-pods.priority, stable=True).to(torch.int32)


def _pick(masked_scores: torch.Tensor) -> torch.Tensor:
    """argmax with first-index ties (torch.argmax returns the first
    maximal index, like jnp.argmax)."""
    return torch.argmax(masked_scores)


def _eval_pod(
    cl: ClusterTensors,
    pods: PodBatch,
    i: int,
    cls: int,
    sfeas_c: torch.Tensor,
    aff_c: torch.Tensor,
    taint_c: torch.Tensor,
    new_ports: Optional[torch.Tensor],
    features: FeatureFlags,
    cfg: ScoreConfig,
):
    """The Filter+Score half of one scheduling step for pod i against the
    carried state: (feas[N], masked_scores[N], found, reason,
    feasible_count), for the static, resource and port families."""
    pod = pod_view(pods, i)
    s_static = sfeas_c[cls]
    s_any = bool(s_static.any())
    feas = s_static & fits_resources(cl, pod)
    a_res = bool(feas.any())
    if features.ports:
        feas = feas & ~((new_ports & pod.port_bits[None, :]) != 0).any(dim=-1)
    a_ports = bool(feas.any())
    found = a_ports
    if found:
        reason = REASON_NONE
    elif not s_any:
        reason = REASON_STATIC
    elif not a_res:
        reason = REASON_RESOURCES
    else:
        reason = REASON_PORTS
    scores = score_from_raw(cl, pod, feas, aff_c[cls], taint_c[cls], cfg)
    masked = torch.where(feas, scores, NEG_INF)
    cnt = int(feas.sum())
    return feas, masked, found, reason, cnt


def _gang_release(
    assignment, win_scores, reasons, requested, nonzero, pods, n_groups, n,
):
    """All-or-nothing gang post-pass: release every placement of a group
    with an unplaced member, subtracting the released requests from the
    carried usage.  The reference drops its out-of-bounds scatter rows;
    index_add_ would raise on them, so only dropped pods are scattered."""
    g = pods.group_id
    gc = torch.clamp(g, 0, n_groups - 1).long()
    unplaced = (assignment < 0) & pods.valid & (g >= 0)
    incomplete = torch.zeros(n_groups, dtype=torch.bool, device=g.device)
    incomplete.index_put_((gc[unplaced],), torch.ones_like(gc[unplaced], dtype=torch.bool))
    dropped = (g >= 0) & incomplete[gc] & (assignment >= 0)
    tgt = assignment[dropped].long()
    requested = requested.index_add(0, tgt, -pods.req[dropped])
    nonzero = nonzero.index_add(0, tgt, -pods.nonzero_req[dropped])
    assignment = torch.where(dropped, -1, assignment)
    win_scores = torch.where(dropped, NEG_INF, win_scores)
    reasons = torch.where(dropped, REASON_GANG, reasons)
    return assignment, win_scores, reasons, requested, nonzero


def greedy_assign_plain(
    cluster: ClusterTensors,
    pods: PodBatch,
    sfeas_c: torch.Tensor,
    aff_c: torch.Tensor,
    taint_c: torch.Tensor,
    order: torch.Tensor,
    features: FeatureFlags,
    n_groups: int,
    cfg: ScoreConfig,
):
    """Plain version of kernel `greedy_scan`: the sequential loop in
    torch ops.  Returns (assignment, scores, feasible_counts, reasons,
    requested, nonzero_requested, port_bits)."""
    n = cluster.allocatable.shape[0]
    p = pods.req.shape[0]
    c_dim = sfeas_c.shape[0]
    dev = cluster.allocatable.device
    requested = cluster.requested.clone()
    nonzero = cluster.nonzero_requested.clone()
    new_ports = torch.zeros_like(cluster.port_bits) if features.ports else None
    class_id = pods.class_id.tolist()
    assignment = torch.full((p,), -1, dtype=torch.int32, device=dev)
    win_scores = torch.full((p,), NEG_INF, dtype=torch.float32, device=dev)
    feas_counts = torch.zeros(p, dtype=torch.int32, device=dev)
    reasons = torch.full((p,), REASON_NONE, dtype=torch.int32, device=dev)
    for i in order.tolist():
        cl = cluster._replace(requested=requested, nonzero_requested=nonzero)
        cls = min(max(class_id[i], 0), c_dim - 1)
        feas, masked, found, reason, cnt = _eval_pod(
            cl, pods, i, cls, sfeas_c, aff_c, taint_c, new_ports, features, cfg,
        )
        feas_counts[i] = cnt
        reasons[i] = reason
        if found:
            choice = int(_pick(masked))
            assignment[i] = choice
            win_scores[i] = masked[choice]
            requested[choice] += pods.req[i]
            nonzero[choice] += pods.nonzero_req[i]
            if features.ports:
                new_ports[choice] |= pods.port_bits[i]
    if n_groups > 0:
        assignment, win_scores, reasons, requested, nonzero = _gang_release(
            assignment, win_scores, reasons, requested, nonzero,
            pods, n_groups, n,
        )
    port_bits = (
        cluster.port_bits | new_ports if features.ports else cluster.port_bits
    )
    return (assignment, win_scores, feas_counts, reasons, requested, nonzero,
            port_bits)


def greedy_scan(
    cluster: ClusterTensors,
    pods: PodBatch,
    sfeas_c: torch.Tensor,
    aff_c: torch.Tensor,
    taint_c: torch.Tensor,
    order: torch.Tensor,
    features: FeatureFlags,
    n_groups: int,
    cfg: ScoreConfig,
):
    """Wrapper of kernel `greedy_scan`: the kernel for tensors on the
    card, the plain version for tensors on the CPU.  The carry tensors
    are copied first, so the input snapshot is left as it was."""
    if cluster.allocatable.device.type == "cpu":
        return greedy_assign_plain(
            cluster, pods, sfeas_c, aff_c, taint_c, order, features,
            n_groups, cfg,
        )
    from ..kernels import bindings

    return bindings.greedy_scan(
        cluster, pods, sfeas_c, aff_c, taint_c, order, features, n_groups, cfg,
    )


def _solver_prep(snapshot: Snapshot):
    """Per-batch device prep, cold path: the selector and preferred masks
    (kernel match_terms) and the class-hoisted static tables (kernel
    class_statics).  Returns (cluster, pods, sfeas_c, aff_c, taint_c)."""
    cluster, pods, sel, pref = snapshot[:4]
    sel_mask = selector_match(cluster, sel)
    pref_mask = preferred_match(cluster, pref)
    sfeas_c, aff_c, taint_c = class_statics(cluster, pods, sel_mask, pref_mask)
    return cluster, pods, sfeas_c, aff_c, taint_c


def greedy_assign(
    snapshot: Snapshot,
    cfg: ScoreConfig = DEFAULT_SCORE_CONFIG,
    features: Optional[FeatureFlags] = None,
    n_groups: Optional[int] = None,
) -> SolveResult:
    """Sequential-greedy solve of the whole pending batch, on the device
    the snapshot's tensors lie on.

    Semantically equivalent to running the reference's scheduling cycle
    once per pod in priority order with cache assume between cycles.
    When n_groups > 0, groups with any unplaced member release every
    placement after the loop (all-or-nothing); later pods saw the released
    placements' usage (conservative, as in the reference package).

    features / n_groups are derived from the snapshot when not given
    (a host readback for tensors on the card; encode_pending derives them
    before the transfer)."""
    if features is None:
        features = features_of(snapshot)
    check_supported(features)
    if n_groups is None:
        n_groups = int(_np(snapshot.pods.group_id).max()) + 1
    cluster, pods, sfeas_c, aff_c, taint_c = _solver_prep(snapshot)
    order = solve_order(pods)
    (assignment, win_scores, feas_counts, reasons, requested, nonzero,
     port_bits) = greedy_scan(
        cluster, pods, sfeas_c, aff_c, taint_c, order, features, n_groups, cfg,
    )
    final = cluster._replace(
        requested=requested, nonzero_requested=nonzero, port_bits=port_bits,
    )
    return SolveResult(assignment, win_scores, feas_counts, final, reasons)
