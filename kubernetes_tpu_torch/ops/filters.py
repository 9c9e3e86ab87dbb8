"""Feasibility functions — the Filter extension point as boolean masks.

Plain-torch versions of the reference package's filters (same names, same
arguments, same axis order), plus the wrapper of the CUDA kernel
`match_terms` (csrc/match_terms.cu) that computes a table's match mask on
the card for the callers that need only masks (warm spread batches, the
preemption pass, feasible_batch); the cold statics prep evaluates its
rows inside kernel class_statics (ops.assign.cold_statics).  Covered
plugins:

  NodeResourcesFit     fitsRequest, noderesources/fit.go:421-480
  NodeName             nodename/node_name.go:52-72
  NodeUnschedulable    as the synthetic unschedulable taint (api.types.Node)
  TaintToleration      tainttoleration/taint_toleration.go Filter
  NodeAffinity         nodeaffinity/node_affinity.go Filter (required terms)
  NodePorts            nodeports/node_ports.go Filter

Bitsets arrive as int32 views of the encoder's uint32 words (ops.device).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .schema import (
    OP_NEG,
    OP_POS,
    TOPO_ANY_VALUE,
    ClusterTensors,
    PodBatch,
    PreferredTable,
    SelectorTable,
)

_PAD_ID = -1  # empty id slot in expr_ids

# Taint effect rows (schema.EFFECT_INDEX)
_NO_SCHEDULE = 0
_PREFER_NO_SCHEDULE = 1
_NO_EXECUTE = 2


class PodView(NamedTuple):
    """One pod's slices out of a PodBatch."""

    valid: torch.Tensor        # bool[]
    req: torch.Tensor          # f32[R]
    nonzero_req: torch.Tensor  # f32[R]
    name_id: torch.Tensor      # i32[]
    sel_idx: torch.Tensor      # i32[]
    tol_bits: torch.Tensor     # i32[3, TW]  (u32 words)
    tol_all: torch.Tensor      # bool[3]
    port_bits: torch.Tensor    # i32[PW]     (u32 words)
    pref_idx: torch.Tensor     # i32[MT]
    pref_weight: torch.Tensor  # f32[MT]


def pod_view(pods: PodBatch, i) -> PodView:
    return PodView(
        valid=pods.valid[i],
        req=pods.req[i],
        nonzero_req=pods.nonzero_req[i],
        name_id=pods.name_id[i],
        sel_idx=pods.sel_idx[i],
        tol_bits=pods.tol_bits[:, i, :],
        tol_all=pods.tol_all[:, i],
        port_bits=pods.port_bits[i],
        pref_idx=pods.pref_idx[i],
        pref_weight=pods.pref_weight[i],
    )


def _test_bits(label_bits: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Presence of each id in each node's bitset.

    label_bits: i32[N, W]; ids: i32[...]; returns bool[N, ...].
    """
    w = label_bits.shape[-1]
    word = torch.clamp(ids >> 5, 0, w - 1).long()
    bit = ids & 31
    words = label_bits[:, word]                       # i32[N, ...]
    present = (words >> bit) & 1
    return (present != 0) & (ids >= 0)


def match_terms(
    cluster: ClusterTensors,
    expr_ids: torch.Tensor,
    expr_op: torch.Tensor,
    expr_slot: torch.Tensor,
) -> torch.Tensor:
    """AND-of-expressions term matching (plain version).

    expr_ids: i32[..., E, K], expr_op/expr_slot: i32[..., E] ->
    bool[..., N] with the node axis appended last.  Label-set requirement
    semantics (apimachinery/pkg/labels/selector.go Requirement.Matches):
    OP_POS is satisfied when any expanded id is present, OP_NEG when none
    is, OP_PAD always.  Expressions over a topology slot compare value ids
    of topo_ids, where TOPO_ANY_VALUE means 'key present'.
    """
    tk = cluster.topo_ids.shape[1]

    in_labels = _test_bits(cluster.label_bits, expr_ids)     # bool[N, ..., E, K]

    if tk > 0:
        slot = torch.clamp(expr_slot, 0, tk - 1).long()      # [..., E]
        topo_val = cluster.topo_ids[:, slot]                 # i32[N, ..., E]
        ids = expr_ids
        in_topo = (topo_val[..., None] == ids) | (
            (ids == TOPO_ANY_VALUE) & (topo_val[..., None] >= 0)
        )
        in_topo = in_topo & (ids != _PAD_ID)
        present = torch.where(
            (expr_slot >= 0)[..., None], in_topo, in_labels
        )                                                    # bool[N, ..., E, K]
    else:
        present = in_labels
    any_present = present.any(dim=-1)                        # bool[N, ..., E]
    op = expr_op.expand(any_present.shape)
    sat = torch.where(
        op == OP_POS,
        any_present,
        torch.where(op == OP_NEG, ~any_present, torch.ones_like(any_present)),
    )
    all_sat = sat.all(dim=-1)                                # bool[N, ...]
    return torch.movedim(all_sat, 0, -1)                     # bool[..., N]


def match_rows_plain(
    cluster: ClusterTensors,
    expr_ids: torch.Tensor,
    expr_op: torch.Tensor,
    expr_slot: torch.Tensor,
    term_valid: torch.Tensor,
) -> torch.Tensor:
    """OR over valid terms of match_terms: bool[R, N] from R rows of
    T terms (i32[R, T, E, K] ids)."""
    term_ok = match_terms(cluster, expr_ids, expr_op, expr_slot)  # [R, T, N]
    return (term_ok & term_valid[:, :, None]).any(dim=1)


def match_rows(
    cluster: ClusterTensors,
    expr_ids: torch.Tensor,
    expr_op: torch.Tensor,
    expr_slot: torch.Tensor,
    term_valid: torch.Tensor,
) -> torch.Tensor:
    """Wrapper of kernel `match_terms` (the masks-only entry): the kernel
    for tensors on the card, the plain version for tensors on the CPU."""
    if cluster.label_bits.device.type == "cpu":
        return match_rows_plain(cluster, expr_ids, expr_op, expr_slot, term_valid)
    from ..kernels import bindings

    return bindings.match_terms(
        cluster.label_bits, cluster.topo_ids, expr_ids, expr_op, expr_slot,
        term_valid,
    )


def selector_match(cluster: ClusterTensors, sel: SelectorTable) -> torch.Tensor:
    """Match mask for every distinct required selector: bool[S, N].
    Terms are ORed (v1.NodeSelector semantics)."""
    return match_rows(
        cluster, sel.expr_ids, sel.expr_op, sel.expr_slot, sel.term_valid
    )


def preferred_match(cluster: ClusterTensors, pref: PreferredTable) -> torch.Tensor:
    """Match mask for every distinct preferred term: bool[F, N] (one term
    per row, valid rows only)."""
    return match_rows(
        cluster,
        pref.expr_ids[:, None],
        pref.expr_op[:, None],
        pref.expr_slot[:, None],
        pref.valid[:, None],
    )


def fits_resources(cluster: ClusterTensors, pod: PodView) -> torch.Tensor:
    """NodeResourcesFit: requested + pod <= allocatable, but only for
    resources the pod actually requests (fit.go:430-470 skips
    podRequest == 0; the pods-count row is always 1 so the per-pod
    capacity check rides the same comparison)."""
    return (
        (pod.req[None, :] <= 0)
        | (cluster.requested + pod.req[None, :] <= cluster.allocatable)
    ).all(dim=-1)


def ports_free(cluster: ClusterTensors, pod: PodView) -> torch.Tensor:
    """NodePorts: claimed host ports must be free on the node."""
    return ~((cluster.port_bits & pod.port_bits[None, :]) != 0).any(dim=-1)


def static_feasible_for_pod(
    cluster: ClusterTensors, pod: PodView, sel_match: torch.Tensor
) -> torch.Tensor:
    """The placement-independent Filter slice for one pod: bool[N].
    NodeName + TaintToleration + NodeAffinity + node validity."""
    n = cluster.allocatable.shape[0]

    # NodeName
    name_ok = (pod.name_id == -1) | (cluster.name_id == pod.name_id)

    # TaintToleration over NoSchedule / NoExecute (PreferNoSchedule only
    # affects scoring).  Untolerated taint present => infeasible.
    def effect_ok(e: int) -> torch.Tensor:
        untolerated = (
            (cluster.taint_bits[e] & ~pod.tol_bits[e][None, :]) != 0
        ).any(dim=-1)
        return pod.tol_all[e] | ~untolerated

    taints_ok = effect_ok(_NO_SCHEDULE) & effect_ok(_NO_EXECUTE)

    # NodeAffinity / nodeSelector
    sel_row = sel_match[torch.clamp(pod.sel_idx, 0, sel_match.shape[0] - 1).long()]
    sel_ok = torch.where(
        pod.sel_idx < 0,
        torch.ones(n, dtype=torch.bool, device=sel_row.device),
        sel_row,
    )

    return cluster.node_valid & pod.valid & name_ok & taints_ok & sel_ok


def _pod_rows(pod: PodView) -> PodBatch:
    """A one-pod batch of a PodView's fields (the others None)."""
    rows = {f: getattr(pod, f)[None] for f in PodView._fields}
    rows["tol_bits"] = pod.tol_bits[:, None, :]
    rows["tol_all"] = pod.tol_all[:, None]
    return PodBatch(**dict({f: None for f in PodBatch._fields}, **rows))


def filter_rows_plain(
    cluster: ClusterTensors, pods: PodBatch, sel_mask: torch.Tensor, full: bool
) -> torch.Tensor:
    """Plain version of kernel `pod_filters`: bool[P, N], per pod the
    static slice (static_feasible_for_pod), and with `full` the whole
    chain (static ∧ fits_resources ∧ ports_free, feasible_for_pod)."""
    rows = []
    for i in range(pods.valid.shape[0]):
        pod = pod_view(pods, i)
        ok = static_feasible_for_pod(cluster, pod, sel_mask)
        if full:
            ok = ok & fits_resources(cluster, pod) & ports_free(cluster, pod)
        rows.append(ok)
    return torch.stack(rows)


def filter_rows(
    cluster: ClusterTensors, pods: PodBatch, sel_mask: torch.Tensor, full: bool
) -> torch.Tensor:
    """Wrapper of kernel `pod_filters`: the kernel for tensors on the card,
    the plain version for tensors on the CPU."""
    if cluster.node_valid.device.type == "cpu":
        return filter_rows_plain(cluster, pods, sel_mask, full)
    from ..kernels import bindings

    return bindings.pod_filters(cluster, pods, sel_mask, full)


def static_filter_row(
    cluster: ClusterTensors, pod: PodView, sel_match: torch.Tensor
) -> torch.Tensor:
    """static_feasible_for_pod through the wrapper of kernel `pod_filters`
    (one pod): the kernel on the card, the plain version on the CPU."""
    return filter_rows(cluster, _pod_rows(pod), sel_match, full=False)[0]


def feasible_for_pod(
    cluster: ClusterTensors, pod: PodView, sel_match: torch.Tensor
) -> torch.Tensor:
    """The fused Filter chain for one pod against every node: bool[N].
    sel_match is the [S, N] selector mask from selector_match()."""
    return filter_rows(cluster, _pod_rows(pod), sel_match, full=True)[0]


def feasible_batch(
    cluster: ClusterTensors, pods: PodBatch, sel: SelectorTable
) -> torch.Tensor:
    """Filter the whole batch at once: bool[P, N] (no inter-pod
    interaction; the solves re-evaluate per step instead)."""
    return filter_rows(cluster, pods, selector_match(cluster, sel), full=True)
