"""InterPodAffinity as per-node bitsets.

The reference scheduler's PreFilter builds topology-pair count maps and its
Filter makes three checks per node (interpodaffinity/filtering.go:306-366):

  1. no existing pod's required anti-affinity term matches the incoming
     pod in the node's topology;
  2. none of the incoming pod's anti-affinity terms matches an existing
     pod in the node's topology;
  3. every affinity term has a matching existing pod in the node's
     topology, with the first-pod escape: every term unmatched anywhere,
     the pod matches its own terms and the node has the keys.

Every check reads only whether a count is non-zero, and counts only grow
during a batch solve, so the state is three bitsets over the term axis:

  present_bits[N, W]  term t has a matching pod in node n's topology
  blocked_bits[N, W]  a pod carrying anti-term t sits in n's topology
  global_any[W]       term t has a matching pod anywhere

The semantics are the reference package's (kubernetes_tpu/ops/interpod.py),
the multi-device branches left out.  Bitsets are int32 views of the u32
words (torch has no u32 shifts or adds on the CPU); a bit test `(w >> b) &
1` is exact under the arithmetic shift, and the CUDA kernels read the same
words as uint32_t.

The preferred (scoring) terms are `prep_pref_pod` / `pref_pod_raw`: the
domain sums of bound pods' matches and owner weights, and each pod's raw
row over them.

On the card both preps are kernel `family_prep` (entries terms and pref,
csrc/family_prep.cu); `prep_terms_plain` and `prep_pref_pod_plain` are
their plain twins.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .schema import ClusterTensors, PrefPodTable, TermTable

_F32 = torch.float32
_I32 = torch.int32


class TermState(NamedTuple):
    present_bits: torch.Tensor    # i32[N, W] carry
    blocked_bits: torch.Tensor    # i32[N, W] carry
    global_any: torch.Tensor      # i32[W] carry
    # static within a solve:
    key_bits: torch.Tensor        # i32[N, W] node has term t's topology key
    slot_v: torch.Tensor          # i32[U, N] node topology values of each used slot
    mi_slot_bits: torch.Tensor    # i32[U, P, W] matches_incoming split by term slot
    anti_slot_bits: torch.Tensor  # i32[U, P, W] own anti terms split by slot
    aff_bits: torch.Tensor        # i32[P, W] own required affinity terms
    anti_bits: torch.Tensor       # i32[P, W] own required anti-affinity terms


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as the int32 with the same low 32 bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(_I32)


def _pack_bits_t(mat: torch.Tensor) -> torch.Tensor:
    """bool[..., T] -> i32[..., ceil(T/32)], bit t%32 of word t//32.  The
    words are summed in int64 (bit 31 overflows int32) and wrapped."""
    t = mat.shape[-1]
    w = (t + 31) // 32
    pad = w * 32 - t
    if pad:
        mat = torch.cat(
            [mat, torch.zeros(mat.shape[:-1] + (pad,), dtype=torch.bool, device=mat.device)],
            dim=-1,
        )
    grouped = mat.reshape(mat.shape[:-1] + (w, 32)).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=mat.device) << torch.arange(
        32, device=mat.device)
    return _wrap32((grouped * weights).sum(dim=-1))


def _idx_to_bits(idx: torch.Tensor, t_dim: int) -> torch.Tensor:
    """i32[P, MA] term indices (-1 pad) -> bool[P, T] membership."""
    ar = torch.arange(t_dim, device=idx.device)
    return (ar[None, None, :] == idx[:, :, None]).any(dim=1)


def _unpack_bits_t(bits: torch.Tensor, t_dim: int) -> torch.Tensor:
    """i32[..., W] packed words -> bool[..., T]."""
    shifts = torch.arange(32, dtype=_I32, device=bits.device)
    expanded = (bits[..., :, None] >> shifts) & 1
    flat = expanded.reshape(*bits.shape[:-1], bits.shape[-1] * 32)
    return flat[..., :t_dim].to(torch.bool)


def used_slots(slots: Tuple[int, ...], tk: int) -> Tuple[int, ...]:
    """The topology-key slots the per-slot tables cover: the ones the
    batch's valid terms use (FeatureFlags.term_slots), or all tk slots."""
    return tuple(slots) or tuple(range(tk))


def _term_values(cluster: ClusterTensors, slot: torch.Tensor) -> torch.Tensor:
    """i32[T, N]: each node's topology value in each row's slot."""
    tk = cluster.topo_ids.shape[1]
    return cluster.topo_ids[:, torch.clamp(slot, 0, tk - 1).long()].T


def _domain_sum(v: torch.Tensor, ok: torch.Tensor, z: int, vals: torch.Tensor) -> torch.Tensor:
    """f32[R, Z]: vals summed per (row, topology value) over the ok nodes.
    Values are clipped into [0, z) as the reference clips them."""
    rows = v.shape[0]
    vc = torch.clamp(v, 0, z - 1).long()
    flat = (torch.arange(rows, device=v.device)[:, None] * z + vc).reshape(-1)
    out = torch.zeros(rows * z, dtype=_F32, device=v.device)
    out.index_add_(0, flat, (vals * ok).reshape(-1))
    return out.view(rows, z)


# coherence: rebuilt-per-solve -- affinity term grids derive from THIS
# snapshot's cluster tensors; a cached copy would score a stale generation
def prep_terms(
    cluster: ClusterTensors,
    terms: TermTable,
    z: int,
    slots: Tuple[int, ...] = (),
    has_bound: bool = True,
) -> TermState:
    """Wrapper of kernel `family_prep` (entry terms): the kernel for
    tensors on the card, prep_terms_plain for tensors on the CPU.  Every
    bit reads only whether a count is positive, and the counts are sums of
    non-negative pod counts, so the kernel's atomics (in no fixed order)
    give the reference's bits whatever the order."""
    if cluster.node_valid.device.type == "cpu":
        return prep_terms_plain(cluster, terms, z, slots, has_bound)
    from ..kernels import bindings

    return bindings.family_prep_terms(cluster, terms, z,
                                      used_slots(slots, cluster.topo_ids.shape[1]), has_bound)


def prep_terms_plain(
    cluster: ClusterTensors,
    terms: TermTable,
    z: int,
    slots: Tuple[int, ...] = (),
    has_bound: bool = True,
) -> TermState:
    """Plain version of kernel `family_prep`'s terms entry: the one-time
    assembly (the PreFilter analogue), a value-space count
    scatter mapped back to node-space presence, packed.  z bounds the
    topology values of the term slots; has_bound=False
    (FeatureFlags.bound_terms) leaves the bound-pod presence empty.  The
    counts are integers below 2^24, so the scatter's order of additions
    does not matter (index_add on the card adds in no fixed order)."""
    t_dim = terms.valid.shape[0]
    n = cluster.node_valid.shape[0]
    dev = cluster.node_valid.device
    v = _term_values(cluster, terms.slot)                       # [T, N]
    ok = (v >= 0) & cluster.node_valid[None, :] & terms.valid[:, None]
    if has_bound:
        cm = _domain_sum(v, ok, z, terms.node_matches)
        co = _domain_sum(v, ok, z, terms.node_owners)
        vc = torch.clamp(v, 0, z - 1).long()
        present = ok & (torch.gather(cm, 1, vc) > 0)
        blocked = ok & (torch.gather(co, 1, vc) > 0)
        global_any = _pack_bits_t((cm.sum(dim=-1) > 0) & terms.valid)
    else:
        present = torch.zeros((t_dim, n), dtype=torch.bool, device=dev)
        blocked = present
        global_any = _pack_bits_t(torch.zeros(t_dim, dtype=torch.bool, device=dev))

    valid_words = _pack_bits_t(terms.valid)                     # [W]
    mi_bits = terms.matches_incoming & valid_words[None, :]     # [P, W]
    used = used_slots(slots, cluster.topo_ids.shape[1])
    # one row per used slot, built from Python slot indices (no host-to-
    # card copy of an index tensor)
    slot_onehot = torch.stack([terms.slot == s for s in used])  # [U, T]
    slot_words = _pack_bits_t(slot_onehot)                      # [U, W]
    anti_membership = _idx_to_bits(terms.anti_idx, t_dim) & terms.valid[None, :]
    aff_membership = _idx_to_bits(terms.aff_idx, t_dim) & terms.valid[None, :]
    return TermState(
        present_bits=_pack_bits_t(present.T),
        blocked_bits=_pack_bits_t(blocked.T),
        global_any=global_any,
        key_bits=_pack_bits_t(ok.T),
        slot_v=torch.stack([cluster.topo_ids[:, s] for s in used]).contiguous(),
        mi_slot_bits=(mi_bits[None, :, :] & slot_words[:, None, :]).contiguous(),
        anti_slot_bits=_pack_bits_t(anti_membership[None, :, :] & slot_onehot[:, None, :]),
        aff_bits=_pack_bits_t(aff_membership),
        anti_bits=_pack_bits_t(anti_membership),
    )


def interpod_filter(state: TermState, terms: TermTable, p) -> torch.Tensor:
    """The three checks for pod p over all nodes: bool[N], as bit algebra.
    p may also be a tensor of K pod indices (bool[K, N]), so the auction
    checks its constraint classes with no host read of the indices."""
    mi_all = state.mi_slot_bits[0, p]
    for s in range(1, state.mi_slot_bits.shape[0]):
        mi_all = mi_all | state.mi_slot_bits[s, p]             # [..., W]

    # 1. existing pods' anti-affinity against the incoming pod
    viol_existing = ((state.blocked_bits & mi_all[..., None, :]) != 0).any(dim=-1)
    # 2. the incoming pod's anti-affinity against existing pods
    viol_own = ((state.present_bits & state.anti_bits[p][..., None, :]) != 0).any(dim=-1)
    # 3. the incoming pod's affinity, with the first-pod escape
    aff = state.aff_bits[p]                                     # [..., W]
    any_active = (aff != 0).any(dim=-1)
    all_here = ((aff[..., None, :] & ~state.present_bits) == 0).all(dim=-1)
    keys_ok = ((aff[..., None, :] & ~state.key_bits) == 0).all(dim=-1)
    none_anywhere = ((aff & state.global_any) == 0).all(dim=-1)
    fallback = (none_anywhere & terms.self_match_all[p])[..., None] & keys_ok
    aff_ok = ~any_active[..., None] | (all_here & keys_ok) | fallback
    return aff_ok & ~viol_existing & ~viol_own


def interpod_update(state: TermState, p: int, choice: int) -> TermState:
    """Account pod p placed on node `choice`: the terms it matches turn
    present (and global) on every node sharing the node's value in the
    term's slot, and its own anti terms turn blocked there."""
    present, blocked, global_any = state.present_bits, state.blocked_bits, state.global_any
    for j in range(state.slot_v.shape[0]):
        ta = state.slot_v[j, choice]
        node_mask = (state.slot_v[j] == ta) & (ta >= 0)
        mi_bits = state.mi_slot_bits[j, p]
        anti_bits = state.anti_slot_bits[j, p]
        present = present | torch.where(node_mask[:, None], mi_bits[None, :], 0)
        blocked = blocked | torch.where(node_mask[:, None], anti_bits[None, :], 0)
        global_any = global_any | torch.where(ta >= 0, mi_bits, 0)
    return state._replace(present_bits=present, blocked_bits=blocked, global_any=global_any)


class PrefPodState(NamedTuple):
    """Domain-summed preferred-term match data (prep_pref_pod)."""

    counts_dom: torch.Tensor   # f32[U, N] matching bound pods in n's topology
    ownerw_dom: torch.Tensor   # f32[U, N] sum of signed owner weights in n's topology


def prep_pref_pod(
    cluster: ClusterTensors, table: PrefPodTable, z: int, has_bound: bool = True,
) -> PrefPodState:
    """Wrapper of kernel `family_prep` (entry pref): the kernel for tensors
    on the card, prep_pref_pod_plain for tensors on the CPU.  The kernel
    adds with atomics in no fixed order; every addend is an integer (counts
    at most 110 a node, signed owner weights 1-100 a term), so a (row,
    value) sum is exact in any order while the magnitudes it adds stay
    below 2^24: 1,525 nodes of 110 pods each carrying weight-100 terms of
    one row in one domain, or 152,520 nodes of 110 pods at weight 1.  The
    cells run so far stay far below: the preferred cell is hostname-keyed
    at weight 1 (110 at most a domain), the extender's variant a zone of
    5,000 nodes with 40 bound pods and no owner weight."""
    if cluster.node_valid.device.type == "cpu":
        return prep_pref_pod_plain(cluster, table, z, has_bound)
    from ..kernels import bindings

    return bindings.family_prep_pref(cluster, table, z, has_bound)


def prep_pref_pod_plain(
    cluster: ClusterTensors, table: PrefPodTable, z: int, has_bound: bool = True,
) -> PrefPodState:
    """Plain version of kernel `family_prep`'s pref entry: domain-sum the
    per-node match counts and owner weights over each
    row's topology value (interpodaffinity/scoring.go PreScore builds the
    same topology-pair score map).  has_bound=False
    (FeatureFlags.bound_pref) gives the zero tables.  Counts and weights
    are integers (weights 1-100, the hard-affinity weight 1), so every sum
    below 2^24 is exact in any order."""
    u_dim = table.valid.shape[0]
    n = cluster.node_valid.shape[0]
    if not has_bound:
        zeros = torch.zeros((u_dim, n), dtype=_F32, device=cluster.node_valid.device)
        return PrefPodState(zeros, zeros.clone())
    v = _term_values(cluster, table.slot)                       # [U, N]
    ok = (v >= 0) & cluster.node_valid[None, :] & table.valid[:, None]
    vc = torch.clamp(v, 0, z - 1).long()
    cz = _domain_sum(v, ok, z, table.node_counts)
    wz = _domain_sum(v, ok, z, table.owner_weight)
    counts_dom = torch.where(ok, torch.gather(cz, 1, vc), 0.0)
    ownerw_dom = torch.where(ok, torch.gather(wz, 1, vc), 0.0)
    return PrefPodState(counts_dom, ownerw_dom)


def pref_pod_raw(state: PrefPodState, table: PrefPodTable, p) -> torch.Tensor:
    """Raw preferred-interpod score of pod p over all nodes: f32[N].  Both
    directions of scoring.go processExistingPod:
      sum_j weight(p, j) * |matching existing pods in n's topology|  (own terms)
      sum_u [p matches u] * sum of owner weights of u in n's topology (theirs)
    Integer products and sums below 2^24: exact, whatever the order."""
    u_dim = state.counts_dom.shape[0]
    idx = torch.clamp(table.pod_idx[p], 0, u_dim - 1).long()   # [MA]
    w = torch.where(table.pod_idx[p] >= 0, table.pod_weight[p], 0.0)
    own = (w[:, None] * state.counts_dom[idx]).sum(dim=0)
    mi = table.matches_incoming[p].to(_F32)                     # [U]
    theirs = (mi[:, None] * state.ownerw_dom).sum(dim=0)
    return own + theirs
