"""Resident Filter/Score partials — the warm statics of the greedy scan
and the wavefront.

Every greedy-family solve hoists a per-class triple out of its scan
(ops.assign.cold_statics, kernel class_statics): static feasibility (NodeName + taints +
NodeAffinity + bound-port conflicts), the raw preferred-node-affinity
row and the raw PreferNoSchedule taint count — three [C, N] tables.
Churn batches re-present the same classes, and few node rows change
between batches, so models.partials.PartialsCache keeps the triple
RESIDENT on the device, one row per cached class signature, and
re-evaluates only what changed:

  ClassSpecs      per-slot static pod spec (what the triple derives from)
  PartialsStore   the resident [G, N] triple
  eval_store      every slot over every column (first sync, resync)
  refresh_rows    every slot over the columns dirtied since the last sync
  insert_slots    the slots of classes first seen this batch, every column
  gather_statics  the batch-ordered [C, N] view the solve consumes

The three evaluations, and a warm sync's grow, insert and refresh
together, are cases of one entry point, `update_store`: kernel
`partials_eval` (csrc/partials_eval.cu) writes a fresh store in one
launch, evaluating the listed columns for every slot, the columns from
the old width up and the missed slots' rows, and copying every other
entry from the old store.  Its plain version, `update_store_plain`, runs
`eval_cols_plain`, which runs `_eval_slot` — the port's own match_terms,
static_feasible_for_pod, node_affinity_raw and taint_toleration_raw on
the slot's stored spec — as the reference's `_eval_slot` runs the
reference's.  Every function is elementwise over the node axis, so a
column subset evaluated on gathered rows equals the same columns of a
full evaluation, and a slot's row equals class_statics' row for a batch
whose representative has the slot's spec.

Updates are out of place: every sync writes a fresh store, and
set_spec_rows fresh spec leaves (kernel mirror_rows copies the old leaf
with the rows overlaid), so a store or spec set a solve or a speculation
bookmark still holds never changes (the reference's arrays are
immutable; the port keeps that contract).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import device as device_ops
from .filters import PodView, match_terms, static_feasible_for_pod
from .schema import ClusterTensors
from .scores import node_affinity_raw, taint_toleration_raw


class ClassStatics(NamedTuple):
    """The per-class triple in BATCH class order — what class_statics
    computes, gathered from the resident store (C = padded class dim)."""

    sfeas: torch.Tensor  # bool[C, N]
    aff: torch.Tensor    # f32[C, N]
    taint: torch.Tensor  # f32[C, N]


class ClassSpecs(NamedTuple):
    """Resident per-slot static pod spec.  G = slot capacity; T/E/K, MT,
    TW, PW follow SnapshotLimits like the batch tables — slot rows are
    byte copies of the encoder's rows."""

    valid: torch.Tensor        # bool[G]
    name_id: torch.Tensor      # i32[G]
    has_sel: torch.Tensor      # bool[G]
    sel_ids: torch.Tensor      # i32[G, T, E, K]
    sel_op: torch.Tensor       # i32[G, T, E]
    sel_slot: torch.Tensor     # i32[G, T, E]
    sel_tv: torch.Tensor       # bool[G, T]
    tol_bits: torch.Tensor     # i32[3, G, TW]  (u32 words)
    tol_all: torch.Tensor      # bool[3, G]
    port_bits: torch.Tensor    # i32[G, PW]     (u32 words)
    pref_ids: torch.Tensor     # i32[G, MT, E, K]
    pref_op: torch.Tensor      # i32[G, MT, E]
    pref_slot: torch.Tensor    # i32[G, MT, E]
    pref_valid: torch.Tensor   # bool[G, MT]
    pref_weight: torch.Tensor  # f32[G, MT]


# the spec leaves whose slot axis is dim 1 (effect-major)
SPEC_AX1 = ("tol_bits", "tol_all")


class PartialsStore(NamedTuple):
    """The resident triple, one row per cached class slot."""

    sfeas: torch.Tensor  # bool[G, N]
    aff: torch.Tensor    # f32[G, N]
    taint: torch.Tensor  # f32[G, N]


def _eval_slot(cluster: ClusterTensors, specs: ClassSpecs, g: int):
    """One slot's triple over the given cluster rows — the chain
    class_statics runs per class representative, fed from the stored spec
    (the parity claim)."""
    dev = cluster.allocatable.device
    term_ok = match_terms(cluster, specs.sel_ids[g], specs.sel_op[g], specs.sel_slot[g])
    sel_mask = (term_ok & specs.sel_tv[g][:, None]).any(dim=0)[None, :]
    mt = specs.pref_valid.shape[1]
    arange = torch.arange(mt, dtype=torch.int32, device=dev)
    pv = PodView(
        valid=specs.valid[g],
        req=torch.zeros(1, dtype=torch.float32, device=dev),          # unused here
        nonzero_req=torch.zeros(1, dtype=torch.float32, device=dev),  # unused here
        name_id=specs.name_id[g],
        sel_idx=torch.where(specs.has_sel[g], 0, -1).to(torch.int32),
        tol_bits=specs.tol_bits[:, g, :],
        tol_all=specs.tol_all[:, g],
        port_bits=specs.port_bits[g],
        pref_idx=torch.where(specs.pref_valid[g], arange, -1),
        pref_weight=specs.pref_weight[g],
    )
    pref_mask = (
        match_terms(cluster, specs.pref_ids[g], specs.pref_op[g], specs.pref_slot[g])
        & specs.pref_valid[g][:, None]
    )
    sfeas = static_feasible_for_pod(cluster, pv, sel_mask) & ~(
        ((cluster.port_bits & pv.port_bits[None, :]) != 0).any(dim=-1)
    )
    return sfeas, node_affinity_raw(pv, pref_mask), taint_toleration_raw(cluster, pv)


def take_rows(cluster: ClusterTensors, idx: torch.Tensor) -> ClusterTensors:
    """The node rows of every cluster leaf at `idx` (taint_bits is
    effect-major: its node axis is dim 1)."""
    idx = idx.long()
    return ClusterTensors(*(
        leaf[:, idx] if f == "taint_bits" else leaf[idx]
        for f, leaf in zip(ClusterTensors._fields, cluster)
    ))


def take_specs(specs: ClassSpecs, idx: torch.Tensor) -> ClassSpecs:
    """The slot rows of the spec store at `idx` (tol leaves are
    effect-major: their slot axis is dim 1)."""
    idx = idx.long()
    return ClassSpecs(*(
        leaf[:, idx] if f in SPEC_AX1 else leaf[idx]
        for f, leaf in zip(ClassSpecs._fields, specs)
    ))


def eval_cols_plain(cluster: ClusterTensors, specs: ClassSpecs,
                    slot_idx: torch.Tensor, col_idx: Optional[torch.Tensor]):
    """Plain version of kernel `partials_eval`: (sfeas, aff, taint), each
    [len(slot_idx), len(col_idx)] (every column when col_idx is None)."""
    sub = cluster if col_idx is None else take_rows(cluster, col_idx)
    rows = [_eval_slot(sub, specs, g) for g in slot_idx.tolist()]
    n = sub.allocatable.shape[0]
    if not rows:
        dev = cluster.allocatable.device
        return (torch.zeros((0, n), dtype=torch.bool, device=dev),
                torch.zeros((0, n), dtype=torch.float32, device=dev),
                torch.zeros((0, n), dtype=torch.float32, device=dev))
    return tuple(torch.stack(x) for x in zip(*rows))


def _check_ascending(idx: Optional[torch.Tensor], what: str) -> None:
    if idx is not None and idx.numel() > 1 and not bool((idx[1:] > idx[:-1]).all()):
        raise ValueError(f"update_store: {what} must be ascending and distinct")


def update_store_plain(old: Optional[PartialsStore], specs: ClassSpecs,
                       cluster: ClusterTensors, slots: Optional[torch.Tensor],
                       cols: Optional[torch.Tensor]) -> PartialsStore:
    """Plain version of kernel `partials_eval`: a fresh [G, N] store with
    every slot evaluated at the columns `cols` and at every column from the
    old width up, the slots `slots` at every column (eval_cols_plain), and
    every other entry copied from `old` (every entry evaluated without
    one)."""
    _check_ascending(slots, "slots")
    _check_ascending(cols, "cols")
    g = specs.valid.shape[0]
    n = cluster.allocatable.shape[0]
    dev = cluster.allocatable.device
    old_n = 0 if old is None else old.aff.shape[1]
    out = PartialsStore(
        sfeas=torch.zeros((g, n), dtype=torch.bool, device=dev),
        aff=torch.zeros((g, n), dtype=torch.float32, device=dev),
        taint=torch.zeros((g, n), dtype=torch.float32, device=dev),
    )
    keep = min(old_n, n)
    if keep:
        for dst, src in zip(out, old):
            dst[:, :keep] = src[:, :keep]
    every = torch.arange(min(old_n, n), n, dtype=torch.int64, device=dev)   # grown columns
    if cols is not None and cols.numel():
        every = torch.cat([cols.long()[cols.long() < old_n], every])
    if every.numel():
        for dst, v in zip(out, eval_cols_plain(cluster, specs, _all_slots(specs), every)):
            dst[:, every] = v
    if slots is not None and slots.numel():
        for dst, v in zip(out, eval_cols_plain(cluster, specs, slots, None)):
            dst[slots.long()] = v
    return out


def update_store(old: Optional[PartialsStore], specs: ClassSpecs, cluster: ClusterTensors,
                 slots: Optional[torch.Tensor], cols: Optional[torch.Tensor]) -> PartialsStore:
    """One sync of the store: a FRESH store of the cluster's width, every
    slot evaluated at the columns `cols` (the dirty ones) and from the old
    store's width up (the grown ones), the slots `slots` (the missed
    classes') at every column, every other entry copied from `old` (None:
    every entry evaluated).  `slots` and `cols` are ascending, distinct
    int32 tensors (or None).  This is the reference's grow -> insert ->
    refresh sequence in one pass: each of those evaluates the same
    cluster, and an inserted slot's row is overwritten whole.  Wrapper of
    kernel `partials_eval` (one launch) for tensors on the card, its plain
    version for tensors on the CPU; `old` is only read."""
    if cluster.allocatable.device.type == "cpu":
        return update_store_plain(old, specs, cluster, slots, cols)
    from ..kernels import bindings

    return PartialsStore(*bindings.partials_eval(cluster, specs, old, slots, cols))


def _all_slots(specs: ClassSpecs) -> torch.Tensor:
    g = specs.valid.shape[0]
    return torch.arange(g, dtype=torch.int32, device=specs.valid.device)


def _ascending(idx: torch.Tensor) -> torch.Tensor:
    return torch.sort(idx.to(torch.int32)).values


def eval_store(cluster: ClusterTensors, specs: ClassSpecs) -> PartialsStore:
    """Full recompute: every slot over every column (a new store)."""
    return update_store(None, specs, cluster, None, None)


def refresh_rows(store: PartialsStore, specs: ClassSpecs, cluster: ClusterTensors,
                 idx: torch.Tensor) -> PartialsStore:
    """Every slot re-evaluated at the columns `idx` (the rows dirtied since
    the last sync, distinct), into a new store."""
    return update_store(store, specs, cluster, None, _ascending(idx))


def insert_slots(store: PartialsStore, specs: ClassSpecs, cluster: ClusterTensors,
                 idx: torch.Tensor) -> PartialsStore:
    """Full rows for the slots `idx` (classes first seen this batch,
    distinct), into a new store."""
    return update_store(store, specs, cluster, _ascending(idx), None)


def set_spec_rows(specs: ClassSpecs, rows: dict, idx: np.ndarray,
                  stage: device_ops.PinnedStage) -> ClassSpecs:
    """Freshly encoded spec rows (host numpy, one entry a field, slots on
    the field's slot axis) at slots `idx` (ascending) in fresh spec
    leaves: one packed copy and one `mirror_rows` launch, which copies
    each old leaf with the rows overlaid.  Slots given out of order are
    sorted with their rows (the kernel takes ascending rows)."""
    idx = np.asarray(idx, dtype=np.int32)
    order = np.argsort(idx, kind="stable")
    targets = [
        device_ops.RowTarget(getattr(specs, f), ax, idx[order],
                             np.take(np.asarray(rows[f]), order, axis=ax))
        for f, ax in ((f, 1 if f in SPEC_AX1 else 0) for f in ClassSpecs._fields)
    ]
    return ClassSpecs(*device_ops.set_rows(targets, stage, specs.valid.device))


def grow_store_cols(store: PartialsStore, dn: int) -> PartialsStore:
    """`dn` zero columns padded onto every resident row (the elastic node
    axis's grow); the caller re-evaluates the new columns at once, so the
    pad value never reaches a solve."""
    return PartialsStore(*(
        torch.cat([t, torch.zeros((t.shape[0], dn), dtype=t.dtype, device=t.device)], dim=1)
        for t in store
    ))


def shrink_store_cols(store: PartialsStore, n: int) -> PartialsStore:
    """The first `n` columns of every row (the post-dwell bucket shrink)."""
    return PartialsStore(*(t[:, :n].contiguous() for t in store))


def gather_statics(store: PartialsStore, slots: torch.Tensor) -> ClassStatics:
    """The batch-ordered [C, N] statics: store rows at `slots` (one slot a
    joint class; padded classes alias class 0's slot)."""
    idx = slots.long()
    return ClassStatics(*(t.index_select(0, idx) for t in store))
