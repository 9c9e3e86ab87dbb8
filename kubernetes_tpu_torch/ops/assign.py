"""Batched assignment solve: the greedy family (the scan and the wavefront).

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

On the card the solve is two CUDA kernels: `class_statics` (the cold
statics prep: the selector and preferred rows the classes name, the class
tables and the spread family's selector mask, in one launch) and
`greedy_scan` (the whole sequential loop in one launch) — or `wavefront`
in place of `greedy_scan` for the
wave-parallel solve of the same semantics (section below).  On the CPU the
plain versions below run; they are what the tests hold against the
reference package.

The solves cover the static, resource, host-port, PodTopologySpread
(hard and soft; ops/topology.py), required and preferred InterPodAffinity
(ops/interpod.py), ImageLocality and TPU slice carve-out (ops/slices.py)
families; the preferred terms and the images are hoisted per class as one
already-weighted extra score row (`class_extras`, kernel `class_extras` on
the card).  Slice batches take the scan only, as in the reference: every
shaped pod writes the free mask that the next one's corner test reads, so
the wavefront raises on them and the auction declines them.  After a slice
batch's scan, kernel `slice_stats` (plain: ops/slices.py) reports the
post-solve fragmentation and the gangs' carve-out outcomes.

`evaluate_single` is the single-pod Filter + Score with no placement that
the extender's verbs serve (kernel `evaluate_single` on the card).
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
from .interpod import (
    PrefPodState,
    TermState,
    _idx_to_bits,
    _pack_bits_t,
    interpod_filter,
    interpod_update,
    prep_pref_pod,
    prep_terms,
)
from .schema import ClusterTensors, PodBatch, PreferredTable, SelectorTable, Snapshot
from .slices import carveout_eval, corner_mask, free_devices, slice_stats
from .scores import (
    DEFAULT_SCORE_CONFIG,
    ScoreConfig,
    node_affinity_raw,
    resource_score_parts,
    score_from_raw,
    static_extra,
    taint_toleration_raw,
)
from .topology import (
    SpreadState,
    prep_spread,
    spread_filter,
    spread_score,
    spread_update,
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


def needs_topo(features: FeatureFlags) -> bool:
    """True when a family reads the topology-value capacity."""
    return features.spread or features.interpod or features.interpod_pref


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
    # wavefront telemetry (None on the classic scan): executed wave count
    # and fallback count (serialized members + per-pod full re-evaluations)
    wave_count: torch.Tensor = None      # i32[]
    wave_fallbacks: torch.Tensor = None  # i32[]
    # slice carve-out telemetry (None off the slice family): post-solve
    # cluster fragmentation and the gangs' carve-out outcomes
    frag_score: torch.Tensor = None          # f32[]
    carveouts: torch.Tensor = None           # i32[]
    contiguous_gangs: torch.Tensor = None    # i32[]
    carveout_fallbacks: torch.Tensor = None  # i32[]


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


def cold_statics(
    cluster: ClusterTensors,
    pods: PodBatch,
    sel: SelectorTable,
    pref: PreferredTable,
    reps: Optional[torch.Tensor] = None,
    want_sel_mask: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The cold statics prep: per-class hoisted tables (static_feas
    bool[C, N], aff_raw f32[C, N], taint_raw f32[C, N]) from the selector
    and preferred tables, and the selector mask bool[S, N] when
    want_sel_mask (else None).  The static feasibility folds in the port
    check against *initial* (bound-pod) port claims; in-batch conflicts
    ride the solve's carry.  reps: the classes' representatives (default:
    class_rep).  Wrapper of kernel `class_statics`: on the card one launch
    (the rows the classes name, the tables and the mask); on the CPU
    selector_match, preferred_match and class_statics_plain."""
    if reps is None:
        reps = pods.class_rep
    if cluster.allocatable.device.type != "cpu":
        from ..kernels import bindings

        return bindings.class_statics(cluster, pods, sel, pref, reps, want_sel_mask)
    sel_mask = selector_match(cluster, sel)
    statics = class_statics_plain(cluster, pods, sel_mask, preferred_match(cluster, pref),
                                  torch.clamp(reps, 0, pods.req.shape[0] - 1))
    return (*statics, sel_mask if want_sel_mask else None)


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
    sp: Optional[SpreadState],
    spread,
    features: FeatureFlags,
    cfg: ScoreConfig,
    tm: Optional[TermState] = None,
    terms=None,
    extra_c: Optional[torch.Tensor] = None,
    gang_sl: Optional[torch.Tensor] = None,
    gang_lo: Optional[torch.Tensor] = None,
):
    """The Filter+Score half of one scheduling step for pod i against the
    carried state (sp: the spread counts, when features.spread; tm: the
    inter-pod bits, when features.interpod; extra_c: the classes' extra
    score rows; gang_sl / gang_lo: the gangs' carve-out carry, when
    features.slices and gangs are present): (feas[N], masked_scores[N],
    found, reason, feasible_count), in the reference's stage order —
    static, resources, ports, spread, inter-pod, and the slice carve-out
    last (a filter under "require" only).  The carve-out bonus is added
    after the normalised score, outside its sum, for every pod of a slice
    batch (x + 0.0 turns -0.0 into +0.0, as in the reference)."""
    pod = pod_view(pods, i)
    s_static = sfeas_c[cls]
    s_any = bool(s_static.any())
    feas = s_static & fits_resources(cl, pod)
    a_res = bool(feas.any())
    if features.ports:
        feas = feas & ~((new_ports & pod.port_bits[None, :]) != 0).any(dim=-1)
    a_ports = bool(feas.any())
    if features.spread:
        feas = feas & spread_filter(sp, spread, i)
    a_spread = bool(feas.any())
    if features.interpod:
        feas = feas & interpod_filter(tm, terms, i)
    s_bonus = None
    a_interpod = True
    if features.slices:
        s_bonus, s_ok = carveout_eval(cl, pods, i, gang_sl, gang_lo, features)
        if features.slice_require:
            a_interpod = bool(feas.any())
            feas = feas & s_ok
    found = bool(feas.any())
    if found:
        reason = REASON_NONE
    elif not s_any:
        reason = REASON_STATIC
    elif not a_res:
        reason = REASON_RESOURCES
    elif not a_ports:
        reason = REASON_PORTS
    elif not a_spread:
        reason = REASON_SPREAD
    elif not a_interpod:
        reason = REASON_INTERPOD
    else:
        reason = REASON_SLICE if features.slice_require else REASON_INTERPOD
    sp_score = spread_score(sp, spread, i, feas) if features.soft_spread else None
    scores = score_from_raw(
        cl, pod, feas, aff_c[cls], taint_c[cls], cfg, spread_score=sp_score,
        extra=extra_c[cls] if extra_c is not None else None,
    )
    if s_bonus is not None:
        scores = scores + s_bonus
    masked = torch.where(feas, scores, NEG_INF)
    cnt = int(feas.sum())
    return feas, masked, found, reason, cnt


def add_rows(dst: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """dst with vals[i] added to row idx[i], each row's additions in
    increasing i: the order of the reference's scatter-add, which decides
    the rounding once a row's sum passes float32's exact range.  index_add
    on the CPU adds serially, in that order; on the card its atomics keep
    no order, so this plain version runs on the CPU only (the card's
    solves commit and release through their kernels)."""
    if dst.device.type != "cpu":
        raise ValueError("add_rows adds in pod index order on the CPU only; "
                         "on the card the solve kernels add")
    return dst.index_add(0, idx, vals)


def _gang_release(
    assignment, win_scores, reasons, requested, nonzero, pods, n_groups, n,
):
    """All-or-nothing gang post-pass: release every placement of a group
    with an unplaced member, subtracting the released requests from the
    carried usage, each node's in pod index order (add_rows).  The
    reference drops its out-of-bounds scatter rows; index_add_ would raise
    on them, so only dropped pods are scattered."""
    g = pods.group_id
    gc = torch.clamp(g, 0, n_groups - 1).long()
    unplaced = (assignment < 0) & pods.valid & (g >= 0)
    incomplete = torch.zeros(n_groups, dtype=torch.bool, device=g.device)
    incomplete.index_put_((gc[unplaced],), torch.ones_like(gc[unplaced], dtype=torch.bool))
    dropped = (g >= 0) & incomplete[gc] & (assignment >= 0)
    tgt = assignment[dropped].long()
    requested = add_rows(requested, tgt, -pods.req[dropped])
    nonzero = add_rows(nonzero, tgt, -pods.nonzero_req[dropped])
    assignment = torch.where(dropped, -1, assignment)
    win_scores = torch.where(dropped, NEG_INF, win_scores)
    reasons = torch.where(dropped, REASON_GANG, reasons)
    return assignment, win_scores, reasons, requested, nonzero


class SpreadArgs(NamedTuple):
    """What the spread family hands a solve: the constraint table and the
    per-batch prep state (prep_spread); the solve carries counts_node."""

    table: object        # schema.SpreadTable (tensors)
    state: SpreadState
    z: int               # value capacity of the spread slots (z_spread)


class TermArgs(NamedTuple):
    """What the inter-pod family hands a solve: the term table and the
    per-batch prep state (prep_terms); the solve carries the three
    bitsets."""

    table: object        # schema.TermTable (tensors)
    state: TermState
    z: int               # value capacity of the term slots (z_terms)


def _term_bits(tm: Optional[TermState]) -> tuple:
    """(present, blocked, global_any) of a term carry, or three Nones."""
    if tm is None:
        return None, None, None
    return tm.present_bits, tm.blocked_bits, tm.global_any


def term_bits_copy(tm_args: Optional[TermArgs], features: FeatureFlags):
    """Fresh contiguous copies of the prep's (present, blocked,
    global_any) bits, the carry a solve updates in place; None without
    the inter-pod family."""
    if not features.interpod:
        return None
    return tuple(t.clone().contiguous() for t in _term_bits(tm_args.state))


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
    sp_args: Optional[SpreadArgs] = None,
    tm_args: Optional[TermArgs] = None,
    extra_c: Optional[torch.Tensor] = None,
):
    """Plain version of kernel `greedy_scan`: the sequential loop in
    torch ops.  Returns (assignment, scores, feasible_counts, reasons,
    requested, nonzero_requested, port_bits, spread counts_node, the
    inter-pod present, blocked and global_any bits; None for a family the
    batch does not use; then, for a slice batch with gangs only, the
    gangs' carve-out carry gang_sl i32[G], gang_lo i32[G, 3], gang_corner
    bool[G]).  The gang release
    leaves the inter-pod bits as they are, as the reference does.

    The carve-out carry is written by a gang's first placed shaped member:
    its slice, its coordinates and whether it sat on a free-box corner of
    the pre-placement state (reference ops/assign.py:703-731)."""
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
    sp, spread = _spread_carry(sp_args, features)
    tm, terms = _term_carry(tm_args, features)
    gang = gang_carry(features, n_groups, dev)
    gang_sl, gang_lo, gang_corner = gang if gang is not None else (None,) * 3
    group_id = pods.group_id.tolist()
    for i in order.tolist():
        cl = cluster._replace(requested=requested, nonzero_requested=nonzero)
        cls = min(max(class_id[i], 0), c_dim - 1)
        feas, masked, found, reason, cnt = _eval_pod(
            cl, pods, i, cls, sfeas_c, aff_c, taint_c, new_ports, sp, spread,
            features, cfg, tm, terms, extra_c, gang_sl, gang_lo,
        )
        feas_counts[i] = cnt
        reasons[i] = reason
        if found:
            choice = int(_pick(masked))
            g = group_id[i]
            gc = min(max(g, 0), n_groups - 1)
            if (gang is not None and g >= 0 and int(pods.pod_shape[i].prod()) > 0
                    and int(gang_sl[gc]) < 0):
                # a new anchor, read against the pre-placement carry
                corner = corner_mask(cl, free_devices(cl), pods.pod_shape[i],
                                     features.slice_z, features.slice_dim)
                gang_sl[gc] = cluster.slice_id[choice]
                gang_lo[gc] = cluster.torus_coords[choice, :3]
                gang_corner[gc] = corner[choice]
            assignment[i] = choice
            win_scores[i] = masked[choice]
            requested[choice] += pods.req[i]
            nonzero[choice] += pods.nonzero_req[i]
            if features.ports:
                new_ports[choice] |= pods.port_bits[i]
            if features.spread:
                sp = spread_update(sp, spread, i, choice)
            if features.interpod:
                tm = interpod_update(tm, i, choice)
    if n_groups > 0:
        assignment, win_scores, reasons, requested, nonzero = _gang_release(
            assignment, win_scores, reasons, requested, nonzero,
            pods, n_groups, n,
        )
    port_bits = (
        cluster.port_bits | new_ports if features.ports else cluster.port_bits
    )
    return (assignment, win_scores, feas_counts, reasons, requested, nonzero,
            port_bits, sp.counts_node if features.spread else None, *_term_bits(tm),
            *(gang or ()))


def gang_carry(features: FeatureFlags, n_groups: int, dev) -> Optional[tuple]:
    """The scan's fresh carve-out carry (gang_sl i32[G] -1, gang_lo
    i32[G, 3] -1, gang_corner bool[G] False), or None unless the batch
    uses the slice family and has gangs."""
    if not (features.slices and n_groups > 0):
        return None
    i32 = torch.int32
    return (torch.full((n_groups,), -1, dtype=i32, device=dev),
            torch.full((n_groups, 3), -1, dtype=i32, device=dev),
            torch.zeros(n_groups, dtype=torch.bool, device=dev))


def _spread_carry(sp_args: Optional[SpreadArgs], features: FeatureFlags):
    """(state, table) a plain solve starts from: a copy of the prep
    state's counts, or (None, None) without the spread family."""
    if not features.spread:
        return None, None
    if sp_args is None:
        raise ValueError("features.spread is set but no spread prep was given")
    st = sp_args.state
    return st._replace(counts_node=st.counts_node.clone()), sp_args.table


def _term_carry(tm_args: Optional[TermArgs], features: FeatureFlags):
    """(state, table) a plain solve starts from: the prep state (its bits
    are replaced, never written), or (None, None) without the family."""
    if not features.interpod:
        return None, None
    if tm_args is None:
        raise ValueError("features.interpod is set but no inter-pod prep was given")
    return tm_args.state, tm_args.table


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
    sp_args: Optional[SpreadArgs] = None,
    tm_args: Optional[TermArgs] = None,
    extra_c: Optional[torch.Tensor] = None,
):
    """Wrapper of kernel `greedy_scan`: the kernel for tensors on the
    card, the plain version for tensors on the CPU.  The carry tensors
    are copied first, so the input snapshot is left as it was."""
    if cluster.allocatable.device.type == "cpu":
        return greedy_assign_plain(
            cluster, pods, sfeas_c, aff_c, taint_c, order, features,
            n_groups, cfg, sp_args, tm_args, extra_c,
        )
    from ..kernels import bindings

    return bindings.greedy_scan(
        cluster, pods, sfeas_c, aff_c, taint_c, order, features, n_groups, cfg,
        sp_args, tm_args, extra_c,
    )


def family_z(snapshot: Snapshot, features: FeatureFlags, topo_z) -> tuple:
    """(z_spread, z_terms): the given value capacities, or — when a family
    that reads them is on — required_topo_z_split's (a host readback for
    tensors on the card); (None, None) otherwise."""
    if topo_z is not None:
        return tuple(topo_z)
    if features.spread or features.interpod or features.interpod_pref:
        return required_topo_z_split(snapshot)
    return None, None


def spread_prep(snapshot: Snapshot, sel_mask: torch.Tensor,
                features: FeatureFlags,
                topo_z: Optional[int] = None) -> Optional[SpreadArgs]:
    """The spread family's per-batch prep (prep_spread: kernel family_prep
    on the card), or None without it.  topo_z: the value capacity of the
    spread slots (required_topo_z_split's first entry, derived here — a
    host readback for tensors on the card — when not given); any capacity
    above the largest value gives the same state."""
    if not features.spread:
        return None
    if topo_z is None:
        topo_z, _ = required_topo_z_split(snapshot)
    state = prep_spread(
        snapshot.cluster, sel_mask, snapshot.spread, topo_z,
        has_bound=features.bound_spread,
    )
    return SpreadArgs(snapshot.spread, state, topo_z)


def terms_prep(snapshot: Snapshot, features: FeatureFlags,
               z_terms: Optional[int] = None) -> Optional[TermArgs]:
    """The inter-pod family's per-batch prep (prep_terms: kernel
    family_prep on the card), or None without it.  z_terms: the value capacity
    of the term slots (required_topo_z_split's second entry, derived here
    when not given)."""
    if not features.interpod:
        return None
    if z_terms is None:
        _, z_terms = required_topo_z_split(snapshot)
    state = prep_terms(
        snapshot.cluster, snapshot.terms, z_terms, slots=features.term_slots,
        has_bound=features.bound_terms,
    )
    return TermArgs(snapshot.terms, state, z_terms)


def class_extras_plain(
    cluster: ClusterTensors, prefpod, images, features: FeatureFlags,
    cfg: ScoreConfig, reps: torch.Tensor, feas: torch.Tensor,
    pp: Optional[PrefPodState],
) -> torch.Tensor:
    """Plain version of kernel `class_extras`: f32[C, N], row c the
    already-weighted static extras (static_extra) of pod reps[c],
    normalised over the feasible row feas[c]."""
    return torch.stack([
        static_extra(cluster, prefpod, images, features, cfg, rep, feas[c], pp)
        for c, rep in enumerate(reps.tolist())
    ])


def class_extras(
    cluster: ClusterTensors, prefpod, images, features: FeatureFlags,
    cfg: ScoreConfig, reps: torch.Tensor, feas: torch.Tensor,
    pp: Optional[PrefPodState],
) -> torch.Tensor:
    """Wrapper of kernel `class_extras`: the kernel for tensors on the
    card, the plain version for tensors on the CPU."""
    if cluster.allocatable.device.type == "cpu":
        return class_extras_plain(cluster, prefpod, images, features, cfg, reps, feas, pp)
    from ..kernels import bindings

    return bindings.class_extras(cluster, prefpod, images, features, cfg, reps, feas, pp)


def extras_prep(snapshot: Snapshot, features: FeatureFlags, cfg: ScoreConfig,
                reps: torch.Tensor, feas: torch.Tensor,
                z_terms: Optional[int] = None) -> Optional[torch.Tensor]:
    """The hoisted static score extras (preferred inter-pod affinity and
    ImageLocality) of the (representative, feasible row) pairs, or None
    without either family.  The preferred terms count BOUND pods only, as
    scoring.go's PreScore over the cycle's snapshot does (in-batch
    placements do not attract later batchmates within a solve: the
    reference package's documented divergence); images never change
    mid-solve."""
    if not (features.interpod_pref or features.images):
        return None
    pp = None
    if features.interpod_pref:
        if z_terms is None:
            _, z_terms = required_topo_z_split(snapshot)
        pp = prep_pref_pod(snapshot.cluster, snapshot.prefpod, z_terms,
                           has_bound=features.bound_pref)
    return class_extras(snapshot.cluster, snapshot.prefpod, snapshot.images, features,
                        cfg, reps, feas, pp)


def _solver_prep(snapshot: Snapshot, features: FeatureFlags,
                 topo_z: Optional[Tuple[int, int]] = None,
                 cfg: ScoreConfig = DEFAULT_SCORE_CONFIG, statics=None):
    """Per-batch device prep: the class-hoisted static tables, the spread
    and inter-pod states and the classes' extra score rows (kernel
    class_extras).  Cold (statics None): cold_statics, one class_statics
    launch (with the selector mask when the spread family needs it for
    its owner eligibility).  Warm: `statics` is the (sfeas, aff, taint)
    triple gathered from the resident partials (ops.partials.ClassStatics),
    equal to what class_statics would give, and class_statics does not run
    — the spread family's selector mask comes from match_terms.
    topo_z: (z_spread, z_terms).  Returns (cluster, pods, sfeas_c, aff_c,
    taint_c, sp_args, tm_args, extra_c)."""
    cluster, pods, sel, pref = snapshot[:4]
    z_spread, z_terms = family_z(snapshot, features, topo_z)
    if statics is None:
        sfeas_c, aff_c, taint_c, sel_mask = cold_statics(cluster, pods, sel, pref,
                                                         want_sel_mask=features.spread)
    else:
        sfeas_c, aff_c, taint_c = statics
        sel_mask = selector_match(cluster, sel) if features.spread else None
    sp_args = spread_prep(snapshot, sel_mask, features, z_spread)
    tm_args = terms_prep(snapshot, features, z_terms)
    reps = torch.clamp(pods.class_rep, 0, pods.req.shape[0] - 1)
    extra_c = extras_prep(snapshot, features, cfg, reps, sfeas_c, z_terms)
    return cluster, pods, sfeas_c, aff_c, taint_c, sp_args, tm_args, extra_c


def greedy_assign(
    snapshot: Snapshot,
    cfg: ScoreConfig = DEFAULT_SCORE_CONFIG,
    features: Optional[FeatureFlags] = None,
    n_groups: Optional[int] = None,
    topo_z: Optional[Tuple[int, int]] = None,
    statics=None,
) -> SolveResult:
    """Sequential-greedy solve of the whole pending batch, on the device
    the snapshot's tensors lie on.

    Semantically equivalent to running the reference's scheduling cycle
    once per pod in priority order with cache assume between cycles.
    When n_groups > 0, groups with any unplaced member release every
    placement after the loop (all-or-nothing); later pods saw the released
    placements' usage (conservative, as in the reference package).

    features / n_groups / topo_z (the (z_spread, z_terms) value capacities
    of the spread and inter-pod slots) are derived from the snapshot when
    not given (a host readback for tensors on the card; encode_pending
    derives them before the transfer).  statics: the warm (sfeas, aff,
    taint) triple of the resident partials (see _solver_prep)."""
    if features is None:
        features = features_of(snapshot)
    if n_groups is None:
        n_groups = int(_np(snapshot.pods.group_id).max()) + 1
    cluster, pods, sfeas_c, aff_c, taint_c, sp_args, tm_args, extra_c = _solver_prep(
        snapshot, features, topo_z, cfg, statics)
    order = solve_order(pods)
    out = greedy_scan(
        cluster, pods, sfeas_c, aff_c, taint_c, order, features, n_groups, cfg,
        sp_args, tm_args, extra_c,
    )
    (assignment, win_scores, feas_counts, reasons, requested, nonzero,
     port_bits) = out[:7]
    final = cluster._replace(
        requested=requested, nonzero_requested=nonzero, port_bits=port_bits,
    )
    carve = (None,) * 4
    if features.slices:
        gang = out[11:14] if len(out) > 11 else None
        carve = slice_stats(final, pods, assignment, gang, features, n_groups)
    return SolveResult(assignment, win_scores, feas_counts, final, reasons,
                       frag_score=carve[0], carveouts=carve[1],
                       contiguous_gangs=carve[2], carveout_fallbacks=carve[3])


# -- wavefront greedy -------------------------------------------------------
#
# The scan pays one sequential step per pod.  The wavefront solve
# partitions the solve order into WAVES and pays one heavy step per wave:
# every member is evaluated against the wave-start carry, and the
# sequential decisions inside the wave run in an O(K) mini-scan that only
# corrects the wave-start scores at nodes picked earlier in the wave (the
# allocation scores are the only usage-dependent family, and they are
# per-node closed forms).  Placements equal the scan's exactly:
#
#   * a wave whose members claim a common host port is serialized through
#     the scan's own step (`wave_safe` re-checks on the device, so any
#     contiguous partition of the solve order is correct);
#   * inside a safe wave, a member's score vector differs from its
#     wave-start vector only at nodes picked earlier in the wave, so the
#     corrected picked-node scores are compared against the best unpicked
#     candidate of a top-(K+1) list ordered by (score desc, index asc);
#   * a member whose fit FLIPS at a picked node is re-evaluated in full
#     against the live carry (its feasible set, and the normalisation
#     over it, changed).
#
# `plan_waves` is host numpy, as in the reference package.

DEFAULT_WAVE_CAP = 32


class WavePlan(NamedTuple):
    """Host-side wave partition of one batch (plan_waves)."""

    members: np.ndarray  # i32[W_pad, K] pod indices in solve order, -1 pad
    n_waves: int         # real (non-empty) wave count


def _pack_idx_rows(idx: np.ndarray, dim: int) -> np.ndarray:
    """i32[P, M] index lists (-1 pad) -> packed u32[P, words] membership."""
    p = idx.shape[0]
    words = max(1, (dim + 31) // 32)
    out = np.zeros((p, words), dtype=np.uint32)
    rows, vals = np.nonzero(idx >= 0)
    ids = idx[rows, vals]
    np.bitwise_or.at(
        out, (rows, ids >> 5), np.uint32(1) << (ids & 31).astype(np.uint32)
    )
    return out


def plan_waves(
    snapshot: Snapshot,
    features: Optional[FeatureFlags] = None,
    wave_cap: int = DEFAULT_WAVE_CAP,
) -> WavePlan:
    """Partition the solve order into conflict-free waves (host numpy).

    A pod joins the open wave unless one of these would break:
      * size: the wave already holds `wave_cap` members;
      * ports: its host-port bits intersect a member's;
      * spread/terms: a wave member WRITES a constraint row this pod
        READS (a spread row it matches, or a term it matches or carries as
        anti-affinity, read by a later member's constraints or terms);
      * headroom: aggregate wave demand would exceed the roomiest
        node's free capacity (elementwise; the reference's default
        headroom_frac of 1.0) — a heuristic
        that keeps fit-flip fallbacks rare, not a correctness condition.

    The partition is a performance hint only: the solve re-checks
    coupling on the device and serializes unsafe waves."""
    if features is None:
        features = features_of(snapshot)
    pods = snapshot.pods
    priority = _np(pods.priority)
    p = priority.shape[0]
    order = np.argsort(-priority, kind="stable").astype(np.int32)

    use_ports = bool(features.ports)
    use_spread = bool(features.spread or features.soft_spread)
    use_terms = bool(features.interpod)
    port_bits = _np(pods.port_bits).view(np.uint32) if use_ports else None
    if use_spread:
        sp_idx = _np(snapshot.spread.pod_idx)
        reads_sp = _pack_idx_rows(sp_idx, _np(snapshot.spread.valid).shape[0])
        pm = _np(snapshot.spread.pod_matches)
        writes_sp = np.packbits(pm, axis=1, bitorder="little")
        w32 = reads_sp.shape[1] * 4
        if writes_sp.shape[1] < w32:
            writes_sp = np.pad(writes_sp, ((0, 0), (0, w32 - writes_sp.shape[1])))
        writes_sp = writes_sp[:, :w32].copy().view(np.uint32)
    if use_terms:
        t_dim = _np(snapshot.terms.valid).shape[0]
        mi = _np(snapshot.terms.matches_incoming).view(np.uint32)
        anti = _pack_idx_rows(_np(snapshot.terms.anti_idx), t_dim)
        aff = _pack_idx_rows(_np(snapshot.terms.aff_idx), t_dim)
        w = min(mi.shape[1], anti.shape[1])
        writes_tm = mi[:, :w] | anti[:, :w]
        reads_tm = writes_tm | aff[:, :w]

    req = _np(pods.req)
    alloc = _np(snapshot.cluster.allocatable)
    used = _np(snapshot.cluster.requested)
    valid = _np(snapshot.cluster.node_valid)
    free = np.where(valid[:, None], alloc - used, 0.0)
    slack = free.max(axis=0)

    waves = []
    cur = []
    port_acc = np.zeros_like(port_bits[0]) if use_ports else None
    sp_acc = np.zeros_like(writes_sp[0]) if use_spread else None
    tm_acc = np.zeros_like(writes_tm[0]) if use_terms else None
    # f32, the schema's request dtype (request quantities stay inside
    # f32's exact-integer envelope by construction)
    demand = np.zeros(req.shape[1], dtype=np.float32)

    for i in order.tolist():
        conflict = len(cur) >= wave_cap
        if not conflict and cur:
            if use_ports and (port_acc & port_bits[i]).any():
                conflict = True
            elif use_spread and (sp_acc & reads_sp[i]).any():
                conflict = True
            elif use_terms and (tm_acc & reads_tm[i]).any():
                conflict = True
            elif ((demand + req[i]) > slack).any():
                conflict = True
        if conflict:
            waves.append(cur)
            cur = []
            if use_ports:
                port_acc = np.zeros_like(port_bits[0])
            if use_spread:
                sp_acc = np.zeros_like(writes_sp[0])
            if use_terms:
                tm_acc = np.zeros_like(writes_tm[0])
            demand = np.zeros(req.shape[1], dtype=np.float32)
        cur.append(i)
        if use_ports:
            port_acc |= port_bits[i]
        if use_spread:
            sp_acc |= writes_sp[i]
        if use_terms:
            tm_acc |= writes_tm[i]
        demand += req[i]
    if cur:
        waves.append(cur)

    n_waves = len(waves)
    w_pad = pad_dim(max(n_waves, 1), 8)
    members = np.full((w_pad, wave_cap), -1, dtype=np.int32)
    for wi, wv in enumerate(waves):
        members[wi, : len(wv)] = wv
    return WavePlan(members=members, n_waves=n_waves)


def _top_stable(masked: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of each row in (value desc, index asc) order —
    lax.top_k's order.  torch.topk promises no order among equal values,
    so this is a stable descending sort."""
    vals, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


def _pick_full(cl, pods, i, cls, sfeas_c, aff_c, taint_c, ports, sp, spread,
               features, cfg, tm, terms, extra_c):
    """One exact scan step's decision for pod i against carry `cl`:
    (choice, win, count, reason, found)."""
    _, masked, found, reason, cnt = _eval_pod(
        cl, pods, i, cls, sfeas_c, aff_c, taint_c, ports, sp, spread, features, cfg,
        tm, terms, extra_c,
    )
    choice = int(_pick(masked))
    return choice, float(masked[choice]) if found else NEG_INF, cnt, reason, found


def wavefront_assign_plain(
    cluster: ClusterTensors,
    pods: PodBatch,
    sfeas_c: torch.Tensor,
    aff_c: torch.Tensor,
    taint_c: torch.Tensor,
    members: torch.Tensor,
    features: FeatureFlags,
    n_groups: int,
    cfg: ScoreConfig,
    sp_args: Optional[SpreadArgs] = None,
    tm_args: Optional[TermArgs] = None,
    extra_c: Optional[torch.Tensor] = None,
):
    """Plain version of kernel `wavefront`: the wave loop in torch ops.
    members: i32[W, K] pod indices in solve order (-1 pad).  Returns
    (assignment, scores, feasible_counts, reasons, requested,
    nonzero_requested, port_bits, wave_count, wave_fallbacks, spread
    counts_node, inter-pod present, blocked and global_any bits; None for
    a family the batch does not use)."""
    n = cluster.allocatable.shape[0]
    p = pods.req.shape[0]
    c_dim = sfeas_c.shape[0]
    dev = cluster.allocatable.device
    k_dim = members.shape[1]
    kk = min(k_dim + 1, n)
    requested = cluster.requested.clone()
    nonzero = cluster.nonzero_requested.clone()
    new_ports = torch.zeros_like(cluster.port_bits) if features.ports else None
    class_id = pods.class_id.tolist()
    assignment = torch.full((p,), -1, dtype=torch.int32, device=dev)
    win_scores = torch.full((p,), NEG_INF, dtype=torch.float32, device=dev)
    feas_counts = torch.zeros(p, dtype=torch.int32, device=dev)
    reasons = torch.full((p,), REASON_NONE, dtype=torch.int32, device=dev)
    n_waves = n_fb = 0
    sp, spread = _spread_carry(sp_args, features)
    tm, terms = _term_carry(tm_args, features)
    term_rows = wave_term_rows(terms) if features.interpod else None

    def record(i, choice, win, cnt, reason, found):
        assignment[i] = choice if found else -1
        win_scores[i] = win
        feas_counts[i] = cnt
        reasons[i] = reason

    for row in members.tolist():
        live = [(j, i) for j, i in enumerate(row) if i >= 0]
        if not live:
            continue  # an all-padding row is skipped, not counted
        n_waves += 1
        cl0 = cluster._replace(requested=requested, nonzero_requested=nonzero)
        if not _wave_safe(pods, [i for _, i in live], features, spread, term_rows):
            # coupled wave: the scan's own step, member by member
            for _, i in live:
                cl = cluster._replace(requested=requested, nonzero_requested=nonzero)
                cls = min(max(class_id[i], 0), c_dim - 1)
                choice, win, cnt, reason, found = _pick_full(
                    cl, pods, i, cls, sfeas_c, aff_c, taint_c, new_ports,
                    sp, spread, features, cfg, tm, terms, extra_c,
                )
                record(i, choice, win, cnt, reason, found)
                if found:
                    requested[choice] += pods.req[i]
                    nonzero[choice] += pods.nonzero_req[i]
                    if features.ports:
                        new_ports[choice] |= pods.port_bits[i]
                    if features.spread:
                        sp = spread_update(sp, spread, i, choice)
                    if features.interpod:
                        tm = interpod_update(tm, i, choice)
            n_fb += len(live)
            continue
        # heavy half: every member against the wave-start carry
        req0, nz0 = requested.clone(), nonzero.clone()
        evals = {}
        for j, i in live:
            cls = min(max(class_id[i], 0), c_dim - 1)
            _, masked, found, reason, cnt = _eval_pod(
                cl0, pods, i, cls, sfeas_c, aff_c, taint_c, new_ports,
                sp, spread, features, cfg, tm, terms, extra_c,
            )
            topv, topi = _top_stable(masked, kk)
            evals[j] = (masked, found, reason, cnt, topv, topi)
        # the O(K) mini-scan
        picked = []  # (node, ...) of earlier members in this wave
        for j, i in live:
            masked, found_k, reason_k, cnt_k, topv, topi = evals[j]
            pod = pod_view(pods, i)
            cls = min(max(class_id[i], 0), c_dim - 1)
            pxc = torch.tensor(picked, dtype=torch.long, device=dev)
            cap_rows = cluster.allocatable[pxc]
            req0_rows, reqc_rows = req0[pxc], requested[pxc]
            skip = pod.req[None, :] <= 0
            fits0 = (skip | (req0_rows + pod.req[None, :] <= cap_rows)).all(-1)
            fitsc = (skip | (reqc_rows + pod.req[None, :] <= cap_rows)).all(-1)
            flip = bool((sfeas_c[cls][pxc] & (fits0 != fitsc)).any())
            if flip:
                # the spread counts and term bits are the wave start's, which
                # no member of a safe wave reads after another writes them
                cl = cluster._replace(requested=requested, nonzero_requested=nonzero)
                choice, win, cnt, reason, found = _pick_full(
                    cl, pods, i, cls, sfeas_c, aff_c, taint_c, new_ports,
                    sp, spread, features, cfg, tm, terms, extra_c,
                )
                n_fb += 1
            else:
                choice, win, found = _cheap_pick(
                    cluster, pod, cfg, pxc, cap_rows, req0_rows, reqc_rows,
                    nz0[pxc], nonzero[pxc], masked, topv, topi, found_k, n,
                )
                cnt, reason = cnt_k, reason_k
            record(i, choice, win, cnt, reason, found)
            if found:
                requested[choice] += pods.req[i]
                nonzero[choice] += pods.nonzero_req[i]
                picked.append(choice)
        # deferred port, spread and term commits, in member order: no
        # member of a safe wave read these
        for j, i in live:
            a = int(assignment[i])
            if a < 0:
                continue
            if features.ports:
                new_ports[a] |= pods.port_bits[i]
            if features.spread:
                sp = spread_update(sp, spread, i, a)
            if features.interpod:
                tm = interpod_update(tm, i, a)
    if n_groups > 0:
        assignment, win_scores, reasons, requested, nonzero = _gang_release(
            assignment, win_scores, reasons, requested, nonzero,
            pods, n_groups, n,
        )
    port_bits = (
        cluster.port_bits | new_ports if features.ports else cluster.port_bits
    )
    i32 = torch.int32
    return (assignment, win_scores, feas_counts, reasons, requested, nonzero,
            port_bits, torch.tensor(n_waves, dtype=i32, device=dev),
            torch.tensor(n_fb, dtype=i32, device=dev),
            sp.counts_node if features.spread else None, *_term_bits(tm))


def wave_term_rows(terms) -> Tuple[torch.Tensor, torch.Tensor]:
    """(writes, reads) i32[P, TW]: the terms each pod writes when placed
    (those it matches, and those it carries as anti-affinity) and those
    its evaluation reads (the written ones and its affinity terms) — the
    reference's wave-safety rows, packed over the narrower of the two
    word widths and not masked by validity, as the reference's are."""
    t_dim = terms.valid.shape[0]
    anti_w = _pack_bits_t(_idx_to_bits(terms.anti_idx, t_dim))
    aff_w = _pack_bits_t(_idx_to_bits(terms.aff_idx, t_dim))
    tw = min(terms.matches_incoming.shape[1], anti_w.shape[1])
    writes = terms.matches_incoming[:, :tw] | anti_w[:, :tw]
    return writes.contiguous(), (writes | aff_w[:, :tw]).contiguous()


def _wave_safe(pods: PodBatch, live, features: FeatureFlags, spread=None,
               term_rows=None) -> bool:
    """No member writes dynamic state that a later member reads: a host
    port a later member claims, a spread row (the member matches its
    selector) a later member's constraints read, or a term (matched or
    carried as anti-affinity) a later member's terms read."""
    if len(live) < 2:
        return True
    idx = torch.tensor(live, dtype=torch.long, device=pods.port_bits.device)
    hit = torch.zeros((len(live), len(live)), dtype=torch.bool, device=idx.device)
    if features.ports:
        pb = pods.port_bits[idx]
        hit |= ((pb[:, None, :] & pb[None, :, :]) != 0).any(-1)
    if features.spread:
        wr = spread.pod_matches[idx]                          # [K, C] rows written
        rows = torch.arange(wr.shape[1], device=idx.device)
        rd = (rows[None, None, :] == spread.pod_idx[idx][:, :, None]).any(dim=1)  # read
        hit |= (wr[:, None, :] & rd[None, :, :]).any(-1)
    if features.interpod:
        wr, rd = (t[idx] for t in term_rows)
        hit |= ((wr[:, None, :] & rd[None, :, :]) != 0).any(-1)
    return not bool(torch.triu(hit, diagonal=1).any())


def _cheap_pick(cluster, pod, cfg, pxc, cap_rows, req0_rows, reqc_rows,
                nz0_rows, nzc_rows, masked, topv, topi, found_k, n):
    """The closed-form correction of the wave-start scores at the nodes
    picked earlier in the wave, against the best unpicked candidate of the
    top list: (choice, win, found), exactly the scan's pick."""
    fit0, bal0 = resource_score_parts(
        cluster._replace(allocatable=cap_rows, requested=req0_rows,
                         nonzero_requested=nz0_rows), pod, cfg)
    fitc, balc = resource_score_parts(
        cluster._replace(allocatable=cap_rows, requested=reqc_rows,
                         nonzero_requested=nzc_rows), pod, cfg)
    d_alloc = cfg.fit_weight * (fitc - fit0) + cfg.balanced_weight * (balc - bal0)
    base = masked[pxc]
    cand_ok = base > NEG_INF
    cand_val = base + d_alloc
    ispicked = (topi.long()[:, None] == pxc[None, :]).any(-1)
    un_ok = ~ispicked & (topv > NEG_INF)
    if bool(un_ok.any()):
        first = int(torch.nonzero(un_ok)[0, 0])
        bu_val, bu_idx = topv[first : first + 1], topi.long()[first : first + 1]
    else:
        bu_val = torch.full((1,), NEG_INF, device=masked.device)
        bu_idx = torch.full((1,), n, dtype=torch.long, device=masked.device)
    vals = torch.cat([torch.where(cand_ok, cand_val, NEG_INF), bu_val])
    idxs = torch.cat([pxc, bu_idx])
    best = float(vals.max())
    found = found_k and best > NEG_INF
    if not found:
        return -1, NEG_INF, False
    choice = int(idxs[(vals >= best) & (vals > NEG_INF)].min())
    return min(max(choice, 0), n - 1), best, True


def wavefront(
    cluster: ClusterTensors,
    pods: PodBatch,
    sfeas_c: torch.Tensor,
    aff_c: torch.Tensor,
    taint_c: torch.Tensor,
    members: torch.Tensor,
    features: FeatureFlags,
    n_groups: int,
    cfg: ScoreConfig,
    sp_args: Optional[SpreadArgs] = None,
    tm_args: Optional[TermArgs] = None,
    extra_c: Optional[torch.Tensor] = None,
):
    """Wrapper of kernel `wavefront`: the kernel for tensors on the card,
    the plain version for tensors on the CPU.  The carry tensors are
    copied first, so the input snapshot is left as it was."""
    if cluster.allocatable.device.type == "cpu":
        return wavefront_assign_plain(
            cluster, pods, sfeas_c, aff_c, taint_c, members, features,
            n_groups, cfg, sp_args, tm_args, extra_c,
        )
    from ..kernels import bindings

    return bindings.wavefront(
        cluster, pods, sfeas_c, aff_c, taint_c, members, features, n_groups, cfg,
        sp_args, tm_args, extra_c,
    )


def wavefront_assign(
    snapshot: Snapshot,
    wave_members=None,
    cfg: ScoreConfig = DEFAULT_SCORE_CONFIG,
    features: Optional[FeatureFlags] = None,
    n_groups: Optional[int] = None,
    topo_z: Optional[Tuple[int, int]] = None,
    statics=None,
) -> SolveResult:
    """Wave-parallel greedy solve with exact scan parity, on the device
    the snapshot's tensors lie on.  wave_members: i32[W, K] pod indices
    covering every batch position in solve order (-1 pads), from
    plan_waves (planned here with the default cap when not given).
    statics: the warm triple of the resident partials (see _solver_prep)."""
    if features is None:
        features = features_of(snapshot)
    if features.slices:
        # every shaped pod writes the free mask that every other shaped
        # pod's corner evaluation reads: wave-start evaluation cannot hold
        raise ValueError(
            "slice carve-out batches (features.slices) route to the "
            "classic greedy scan, not the wavefront solver"
        )
    if n_groups is None:
        n_groups = int(_np(snapshot.pods.group_id).max()) + 1
    if wave_members is None:
        wave_members = plan_waves(snapshot, features).members
    cluster, pods, sfeas_c, aff_c, taint_c, sp_args, tm_args, extra_c = _solver_prep(
        snapshot, features, topo_z, cfg, statics)
    members = torch.as_tensor(
        np.asarray(wave_members, dtype=np.int32)
        if not isinstance(wave_members, torch.Tensor) else wave_members,
    ).to(device=cluster.allocatable.device, dtype=torch.int32)
    (assignment, win_scores, feas_counts, reasons, requested, nonzero,
     port_bits, n_waves, n_fb) = wavefront(
        cluster, pods, sfeas_c, aff_c, taint_c, members, features, n_groups, cfg,
        sp_args, tm_args, extra_c,
    )[:9]
    final = cluster._replace(
        requested=requested, nonzero_requested=nonzero, port_bits=port_bits,
    )
    return SolveResult(
        assignment, win_scores, feas_counts, final, reasons,
        wave_count=n_waves, wave_fallbacks=n_fb,
    )


# -- single-pod evaluation (the extender's verbs) ----------------------------


def single_filter_plain(cluster: ClusterTensors, pods: PodBatch, srow: torch.Tensor,
                        features: FeatureFlags, sp_args: Optional[SpreadArgs] = None,
                        tm_args: Optional[TermArgs] = None):
    """Plain version of kernel `evaluate_single`'s filter stage: pod 0's
    (feas bool[N], the post-spread set bool[N] that the soft spread score
    normalises over, the carve-out bonus f32[N]).  srow: its static row
    (static filters and bound ports)."""
    feas = srow & fits_resources(cluster, pod_view(pods, 0))
    if features.spread:
        feas = feas & spread_filter(sp_args.state, sp_args.table, 0)
    feas_sp = feas
    if features.interpod:
        feas = feas & interpod_filter(tm_args.state, tm_args.table, 0)
    bonus = torch.zeros(feas.shape[0], dtype=torch.float32, device=feas.device)
    if features.slices:
        # a lone pod has no gang carry: a shaped pod is an anchor
        bonus, ok = carveout_eval(cluster, pods, 0, None, None, features)
        if features.slice_require:
            feas = feas & ok
    return feas, feas_sp, bonus


def single_score_plain(cluster: ClusterTensors, pods: PodBatch, feas, feas_sp, bonus,
                       arow, trow, extra, features: FeatureFlags, cfg: ScoreConfig,
                       sp_args: Optional[SpreadArgs] = None) -> torch.Tensor:
    """Plain version of kernel `evaluate_single`'s score stage: pod 0's
    where(feas, score, -inf) f32[N]."""
    sp_score = (spread_score(sp_args.state, sp_args.table, 0, feas_sp)
                if features.soft_spread else None)
    scores = score_from_raw(cluster, pod_view(pods, 0), feas, arow, trow, cfg,
                            spread_score=sp_score, extra=extra)
    if features.slices:
        scores = scores + bonus
    return torch.where(feas, scores, NEG_INF)


def single_filter(cluster, pods, srow, features, sp_args=None, tm_args=None):
    """Wrapper of kernel `evaluate_single`'s filter stage: the kernel for
    tensors on the card, the plain version for tensors on the CPU."""
    if cluster.allocatable.device.type == "cpu":
        return single_filter_plain(cluster, pods, srow, features, sp_args, tm_args)
    from ..kernels import bindings

    return bindings.evaluate_single_filter(cluster, pods, srow, features, sp_args, tm_args)


def single_score(cluster, pods, feas, feas_sp, bonus, arow, trow, extra, features, cfg,
                 sp_args=None):
    """Wrapper of kernel `evaluate_single`'s score stage: the kernel for
    tensors on the card, the plain version for tensors on the CPU."""
    if cluster.allocatable.device.type == "cpu":
        return single_score_plain(cluster, pods, feas, feas_sp, bonus, arow, trow, extra,
                                  features, cfg, sp_args)
    from ..kernels import bindings

    return bindings.evaluate_single_score(cluster, pods, feas, feas_sp, bonus, arow, trow,
                                          extra, features, cfg, sp_args)


def single_eval(cluster, pods, srow, arow, trow, features, cfg, sp_args=None, tm_args=None):
    """Both stages of kernel `evaluate_single` for a pod without an extra
    row (no preferred inter-pod term, no image): pod 0's (feas bool[N],
    where(feas, score, -inf) f32[N]) — one launch on the card, the two
    plain stages for tensors on the CPU."""
    if cluster.allocatable.device.type == "cpu":
        feas, feas_sp, bonus = single_filter_plain(cluster, pods, srow, features, sp_args,
                                                   tm_args)
        return feas, single_score_plain(cluster, pods, feas, feas_sp, bonus, arow, trow, None,
                                        features, cfg, sp_args)
    from ..kernels import bindings

    feas, _feas_sp, _bonus, masked = bindings.evaluate_single_fused(
        cluster, pods, srow, arow, trow, features, cfg, sp_args, tm_args)
    return feas, masked


def evaluate_single(
    snapshot: Snapshot,
    cfg: ScoreConfig = DEFAULT_SCORE_CONFIG,
    topo_z: Optional[int] = None,
    features: Optional[FeatureFlags] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(feasible bool[N], scores f32[N]) for pod 0 of the snapshot, on the
    device its tensors lie on: the full Filter + Score chain with no
    placement (what an extender's filter and prioritize verbs need: the
    node set, not one pick).  Held to the reference's evaluate_single
    line by line: the static row and the raw affinity / taint rows are
    kernel class_statics' for pod 0; the soft spread score normalises over
    the post-spread set (before the inter-pod and slice filters); the extra
    row normalises over the pod's whole feasible set (class_extras on the
    filter stage's output, not on the static row as in the solves); the
    slice stage is the anchor's (no gang carry).  A pod without an extra
    row takes both stages in one launch (single_eval)."""
    if features is None:
        features = features_of(snapshot)
    if topo_z is None:
        topo_z = required_topo_z(snapshot) if needs_topo(features) else 1
    cluster, pods, sel, pref = snapshot[:4]
    reps = torch.zeros(1, dtype=torch.int32, device=cluster.allocatable.device)
    sfeas, aff, taint, sel_mask = cold_statics(cluster, pods, sel, pref, reps,
                                               want_sel_mask=features.spread)
    sp_args = spread_prep(snapshot, sel_mask, features, topo_z)
    tm_args = terms_prep(snapshot, features, topo_z)
    if not (features.interpod_pref or features.images):
        return single_eval(cluster, pods, sfeas[0], aff[0], taint[0], features, cfg, sp_args,
                           tm_args)
    feas, feas_sp, bonus = single_filter(cluster, pods, sfeas[0], features, sp_args, tm_args)
    extra = extras_prep(snapshot, features, cfg, reps, feas[None], topo_z)
    masked = single_score(cluster, pods, feas, feas_sp, bonus, aff[0], taint[0], extra[0],
                          features, cfg, sp_args)
    return feas, masked
