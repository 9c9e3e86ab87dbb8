"""Joint batched assignment — the auction route.

The greedy scan is sequential: one step per pod.  For large bursts and
gangs the reference package solves the batch *jointly*, in rounds:

  1. filtering and scoring run once per pod *class* (pods with identical
     specs see identical masks and score rows); each class's max-score
     tie nodes are listed in a per-(class, round) hashed order and the
     class's j-th active pod bids the j-th tie node, so identical pods
     bid distinct nodes while ties last;
  2. each node accepts its bidders in solve order (priority, then batch
     index) while they fit its remaining capacity — one stable sort by
     bid and a difference of global prefix sums;
  3. with the spread family, a repair releases accepted pods whose
     placements, taken together, would break a hard constraint (rank r
     in its (row, topology value) group kept iff count + r + 1 - globalMin
     <= maxSkew, in three admit passes whose admits raise the minimum);
     with inter-pod anti-affinity terms, a second repair keeps, in each
     (term, topology value) group holding an accepted carrier of the term,
     only the first involved pod in solve order;
  4. accepted pods commit (resources, spread counts and term bits);
     rejected and released pods bid again next round.

A round in which an unplaced pod still has a feasible node commits at
least one pod, so the loop ends; `max_rounds` bounds it regardless.
After the rounds, a staged filter pass names each unplaced pod's reason
and gangs with an unplaced member release every placement.

On the card the whole solve after the preps is one launch, kernel
`auction_loop`: one thread-block cluster runs every round — the bids,
the acceptance, the spread repair and count commit, the anti-affinity
repair (over the cluster; its term tables written in the launch) and
term-bit commit, the commit — until the device's continue flag falls, with no
host sync —
then, in the same launch, the reasons pass on the final state and, with
gangs, the gang post-pass (csrc/auction_common.cuh; the stage entry
points `auction_bids`, `auction_accept`, `auction_spread`,
`auction_interpod`, `auction_reasons` and `auction_gang` launch one stage
of the same kernel).  auction_assign reads every output of that launch.
The spread, inter-pod and preferred preps are kernel `family_prep`; the
preferred inter-pod and image extras are one row per joint class (kernel
`class_extras`), built once.  On the CPU the same steps are the plain
twins below: `_rounds_plain` (with the repair's dense tables,
`repair_tables`), `failure_reasons_plain` and `gang_post_pass_plain`.

The static, resource, gang, spread, inter-pod anti-affinity, preferred
inter-pod and ImageLocality families are covered; batches with in-batch
host ports or affinity-direction terms never route here
(auction_features_ok).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.vocab import pad_dim
from .assign import (
    NEG_INF,
    REASON_GANG,
    REASON_INTERPOD,
    REASON_NONE,
    REASON_RESOURCES,
    REASON_SPREAD,
    REASON_STATIC,
    FeatureFlags,
    SpreadArgs,
    TermArgs,
    _np,
    add_rows,
    cold_statics,
    extras_prep,
    family_z,
    features_of,
    solve_order,
    spread_prep,
    term_bits_copy,
    terms_prep,
)
from .interpod import _idx_to_bits, _pack_bits_t, _unpack_bits_t, interpod_filter, used_slots
from .filters import fits_resources, pod_view
from .schema import ClusterTensors, Snapshot
from .scores import (
    DEFAULT_SCORE_CONFIG,
    ScoreConfig,
    combine_scores,
    resource_score_parts,
)
from .topology import spread_filter, spread_min_match, spread_score

_U32 = 0xFFFFFFFF
HASH_GOLDEN = 0x9E3779B9
HASH_ROUND = 0x85EBCA6B
HASH_MIX = 0x27D4EB2F
# the reference's tie_seed as TPUBatchScheduler passes it (0); the hash
# mixes in tie_seed * 2 + 1
TIE_SEED = 0
# XLA's rewrite of a cumulative sum on the CPU: sequential sums within
# blocks of this many rows, the block totals summed the same way
SCAN_BLOCK = 16
# admit passes of one round's spread repair: each pass admits what fits
# under the current global minimum and commits it, so the next pass sees
# the raised minimum (the reference's SPREAD_REPAIR_ITERS)
SPREAD_REPAIR_ITERS = 3
_BIG_I = 2**30


class AuctionResult(NamedTuple):
    assignment: torch.Tensor    # i32[P]: node index, -1 unschedulable/dropped
    scores: torch.Tensor        # f32[P]: accepted bid's score (-inf if none)
    rounds: torch.Tensor        # i32[]: bidding rounds executed
    gang_dropped: torch.Tensor  # bool[P]: placed but released with its gang
    cluster: ClusterTensors     # post-solve cluster
    reasons: torch.Tensor = None  # i32[P]: REASON_* for unplaced pods
    debug_sp_counts: torch.Tensor = None  # f32[C, N] final spread counts
    # final inter-pod (present i32[N, W], blocked i32[N, W], global_any i32[W])
    debug_term_bits: tuple = None


def auction_features_ok(features: FeatureFlags) -> bool:
    """True when the joint solve covers this batch's constraint families
    (the reference's rule: in-batch host ports, affinity-direction
    inter-pod terms and slice carve-outs stay on the greedy routes)."""
    return not (features.ports or features.interpod_aff or features.slices)


def default_tie_k(snapshot: Snapshot) -> int:
    """Tie nodes listed per class per round: enough for the LARGEST class
    to bid distinct nodes, power-of-two bucketed, bounded by the node
    axis (host numpy, at encode time)."""
    cid = _np(snapshot.pods.class_id)
    live = cid[_np(snapshot.pods.valid)]
    biggest = int(np.bincount(live).max()) if live.size else 1
    return min(pad_dim(max(biggest, 64), 1), _np(snapshot.cluster.allocatable).shape[0])


def tie_keys(c: int, rnd: int, n: int, tie_seed: int, device) -> torch.Tensor:
    """i64[N] hashed tie key of every node for class c in round rnd:
    ((gid * 0x9E3779B9) ^ rot) >> 2 in wrapping u32 arithmetic, gid = node
    index + 1.  Torch has no u32 multiply/shift on the CPU, so this is
    int64 masked to 32 bits (every product stays below 2^63)."""
    seed_c = (tie_seed * 2 + 1) & _U32
    rot = (((c * HASH_GOLDEN) & _U32) ^ ((rnd * HASH_ROUND) & _U32) ^ seed_c)
    rot = (rot * HASH_MIX) & _U32
    gids = torch.arange(1, n + 1, dtype=torch.int64, device=device)
    return (((gids * HASH_GOLDEN) & _U32) ^ rot) >> 2


class AuctionStatics(NamedTuple):
    """Per-batch tables every round reads (built once, on the solve's
    device)."""

    sfeas_s: torch.Tensor  # bool[Cs, N] static feasibility per spec class
    aff_s: torch.Tensor    # f32[Cs, N]  raw affinity rows
    taint_s: torch.Tensor  # f32[Cs, N]  raw taint rows
    s_reps: torch.Tensor   # i32[Cs]     spec representatives (clipped)
    jspec: torch.Tensor    # i32[C]      spec class of each joint class (clipped)
    order: torch.Tensor    # i32[P]      solve order
    k_reps: torch.Tensor   # i32[Cc]     constraint-class representatives (clipped)
    jcons: torch.Tensor    # i32[C]      constraint class of each joint class (clipped)
    reps: torch.Tensor     # i32[C]      joint-class representatives (clipped)
    features: FeatureFlags
    sp: Optional[SpreadArgs] = None  # spread table + prep state (features.spread)
    tm: Optional[TermArgs] = None    # term table + prep state (features.interpod)
    extra: Optional[torch.Tensor] = None  # f32[C, N] each joint class's extras


def auction_prep(
    snapshot: Snapshot, features: Optional[FeatureFlags] = None,
    topo_z: Optional[Tuple[int, int]] = None,
    cfg: ScoreConfig = DEFAULT_SCORE_CONFIG,
) -> Tuple[ClusterTensors, object, AuctionStatics]:
    """The spec-class static tables and, with the spread family, the
    selector mask (kernel class_statics: one launch), the spread and
    inter-pod preps
    and each joint class's extra score row
    (kernel class_extras: the preferred inter-pod row of its constraint
    class's representative normalised over its spec class's static row,
    and that representative's image score) the rounds read.  topo_z:
    (z_spread, z_terms)."""
    if features is None:
        features = features_of(snapshot)
    cluster, pods, sel, pref = snapshot[:4]
    p = pods.req.shape[0]
    z_spread, z_terms = family_z(snapshot, features, topo_z)
    s_reps = torch.clamp(pods.spec_rep, 0, p - 1)
    sfeas_s, aff_s, taint_s, sel_mask = cold_statics(cluster, pods, sel, pref, s_reps,
                                                     want_sel_mask=features.spread)
    i32 = torch.int32
    jspec = torch.clamp(pods.joint_spec, 0, pods.spec_rep.shape[0] - 1)
    jcons = torch.clamp(pods.joint_cons, 0, pods.cons_rep.shape[0] - 1)
    k_reps = torch.clamp(pods.cons_rep, 0, p - 1).to(i32)
    order = solve_order(pods)
    tm_args = terms_prep(snapshot, features, z_terms)
    extra = extras_prep(snapshot, features, cfg, k_reps[jcons.long()], sfeas_s[jspec.long()],
                        z_terms)
    return cluster, pods, AuctionStatics(
        sfeas_s, aff_s, taint_s, s_reps.to(i32), jspec.to(i32), order,
        k_reps, jcons.to(i32), torch.clamp(pods.class_rep, 0, p - 1).to(i32),
        features, spread_prep(snapshot, sel_mask, features, z_spread),
        tm_args, extra,
    )


def repair_tables(terms, order: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The anti-affinity repair's dense tables, the plain loop's (on the
    card kernel auction_loop writes their live-term columns, both flags
    in a byte, into its scratch from terms.matches_incoming and
    terms.anti_idx): bool[P, T] the
    valid terms each pod matches, bool[P, T] the valid terms it carries as
    anti terms, and i32[P] each pod's position in the solve order."""
    t_dim = terms.valid.shape[0]
    mi_dense = _unpack_bits_t(terms.matches_incoming, t_dim) & terms.valid[None, :]
    anti_dense = _idx_to_bits(terms.anti_idx, t_dim) & terms.valid[None, :]
    solve_pos = torch.empty_like(order)
    solve_pos[order.long()] = torch.arange(order.shape[0], dtype=torch.int32,
                                           device=order.device)
    return mi_dense, anti_dense, solve_pos


def auction_bids_plain(
    cluster: ClusterTensors,
    pods,
    st: AuctionStatics,
    requested: torch.Tensor,
    nonzero: torch.Tensor,
    assigned: torch.Tensor,
    rnd: int,
    tie_k: int,
    cfg: ScoreConfig,
    sp_counts: Optional[torch.Tensor] = None,
    term_bits: Optional[tuple] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel `auction_bids`: one round's bids against
    the round's usage and (with the spread family) spread counts and
    (with the inter-pod family) term bits.  Returns (bid i32[P] — a node
    index, or N for no bid; val f32[P])."""
    n = cluster.allocatable.shape[0]
    p = pods.req.shape[0]
    dev = requested.device
    c_dim = pods.class_rep.shape[0]
    features = st.features
    cl = cluster._replace(requested=requested, nonzero_requested=nonzero)
    sp = spread = None
    spf_k = None
    if features.spread:
        spread = st.sp.table
        sp = st.sp.state._replace(counts_node=sp_counts)
        spf_k = [spread_filter(sp, spread, rep) for rep in st.k_reps.tolist()]
    ipf_k = None
    if features.interpod:
        tm = _term_state(st, term_bits)
        ipf_k = interpod_filter(tm, st.tm.table, st.k_reps.long())   # [Cc, N]
    fits_s, fit_s, bal_s = [], [], []
    for rep in st.s_reps.tolist():
        pod = pod_view(pods, rep)
        fit, bal = resource_score_parts(cl, pod, cfg)
        fits_s.append(fits_resources(cl, pod))
        fit_s.append(fit)
        bal_s.append(bal)
    inv_c = torch.zeros((c_dim, tie_k), dtype=torch.int64, device=dev)
    cnt_c = torch.zeros(c_dim, dtype=torch.int64, device=dev)
    best_c = torch.full((c_dim,), NEG_INF, dtype=torch.float32, device=dev)
    jcons, reps = st.jcons.tolist(), st.reps.tolist()
    for c, s in enumerate(st.jspec.tolist()):
        feas = st.sfeas_s[s] & fits_s[s]
        if features.spread:
            feas = feas & spf_k[jcons[c]]
        if features.interpod:
            feas = feas & ipf_k[jcons[c]]
        sp_score = (
            spread_score(sp, spread, reps[c], feas) if features.soft_spread else None
        )
        scores = combine_scores(
            fit_s[s], bal_s[s], st.aff_s[s], st.taint_s[s], feas, cfg,
            spread_score=sp_score,
            extra=st.extra[c] if st.extra is not None else None,
        )
        masked = torch.where(feas, scores, NEG_INF)
        best = torch.max(masked)
        tie = feas & (masked == best)
        key = torch.where(tie, tie_keys(c, rnd, n, TIE_SEED, dev), -1)
        # (key desc, index asc): lax.top_k's order
        order_k = torch.sort(key, descending=True, stable=True).indices
        inv_c[c] = order_k[:tie_k]
        cnt_c[c] = min(int(tie.sum()), tie_k)
        best_c[c] = best

    # within-class position j of each active pod, in solve order
    cls = torch.clamp(pods.class_id, 0, c_dim - 1).long()
    active = (assigned < 0) & pods.valid
    actkey = torch.where(active, cls, c_dim)
    order = st.order.long()
    sperm = order[torch.argsort(actkey[order], stable=True)]
    skey = actkey[sperm].contiguous()
    firstpos = torch.searchsorted(skey, skey, side="left")
    j = torch.zeros(p, dtype=torch.int64, device=dev)
    j[sperm] = torch.arange(p, device=dev) - firstpos
    cnt = cnt_c[cls]
    has = active & (best_c[cls] > NEG_INF) & (cnt > 0)
    slot = j % torch.clamp(cnt, min=1)
    bid = torch.where(has, inv_c[cls, slot], n).to(torch.int32)
    val = torch.where(has, best_c[cls], NEG_INF)
    return bid, val


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 prefix sum along axis 0, added in the order XLA's
    CPU backend adds jnp.cumsum: sequential sums within blocks of
    SCAN_BLOCK rows (zero-padded), the block totals prefix-summed the same
    way, then each block's exclusive total added to its rows.  torch.cumsum
    adds in another order (in double on the CPU), and once the sums pass
    float32's exact range the order decides the rounding."""
    n = x.shape[0]
    nb = -(-n // SCAN_BLOCK)
    pad = torch.zeros((nb * SCAN_BLOCK,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    pad[:n] = x
    blocks = pad.view((nb, SCAN_BLOCK) + tuple(x.shape[1:]))
    inner = torch.empty_like(blocks)
    run = torch.zeros_like(blocks[:, 0])
    for k in range(SCAN_BLOCK):
        run = run + blocks[:, k]
        inner[:, k] = run
    if nb > 1:
        outer = prefix_sum(inner[:, -1])
        inner[1:] = inner[1:] + outer[:-1, None]
    return inner.view(pad.shape)[:n]


def auction_decide_plain(
    allocatable: torch.Tensor,
    pods,
    order: torch.Tensor,
    bid: torch.Tensor,
    requested: torch.Tensor,
) -> torch.Tensor:
    """The acceptance half of kernel `auction_accept`: bool[P], pod
    accepted by its bid node.  Pods are pre-permuted into solve order,
    then stably sorted by bid; a pod's demand on its node is a difference
    of global prefix sums, added in the reference's order (prefix_sum);
    it equals the per-node running sum while every partial sum is exact in
    float32."""
    n = allocatable.shape[0]
    p = bid.shape[0]
    order = order.long()
    perm = order[torch.argsort(bid[order], stable=True)]
    sbid = bid[perm].contiguous()
    sreq = pods.req[perm]
    prefix = prefix_sum(sreq)
    first = torch.searchsorted(sbid, sbid, side="left")
    within = prefix - prefix[first] + sreq[first]
    remaining = (allocatable - requested)[torch.clamp(sbid, 0, n - 1).long()]
    ok = ((sreq <= 0) | (within <= remaining)).all(dim=-1) & (sbid < n)
    accept = torch.zeros(p, dtype=torch.bool, device=bid.device)
    accept[perm] = ok
    return accept


def auction_commit_plain(pods, accept, bid, val, requested, nonzero, assigned,
                         bid_scores):
    """The commit half of kernel `auction_accept`: (assigned, bid_scores,
    requested, nonzero) with the accepted pods placed."""
    tgt = bid[accept].long()
    requested = add_rows(requested, tgt, pods.req[accept])
    nonzero = add_rows(nonzero, tgt, pods.nonzero_req[accept])
    assigned = torch.where(accept, bid, assigned)
    bid_scores = torch.where(accept, val, bid_scores)
    return assigned, bid_scores, requested, nonzero


# -- the spread repair -------------------------------------------------------


def spread_slot_sorts(order: torch.Tensor, topo_pt: torch.Tensor, slots):
    """Per spread slot, (perm, inv, firstv) of the round's bid nodes'
    values: solve order stably sorted by value (-1 last), its inverse, and
    each sorted position's group start.  They depend only on the bids, so
    one round's admit passes share them."""
    out = {}
    p = order.shape[0]
    order = order.long()
    for s in slots:
        v_p = topo_pt[:, s]
        key = torch.where(v_p >= 0, v_p, _BIG_I)
        perm = order[torch.argsort(key[order], stable=True)]
        skey = key[perm].contiguous()
        firstv = torch.searchsorted(skey, skey, side="left")
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(p, device=perm.device)
        out[s] = (perm, inv, firstv)
    return out


def spread_ranks(cand, v_pc, spread, slot_sorts) -> torch.Tensor:
    """i32[P, C]: among the `cand` pods matching row c, each pod's 0-based
    position in solve order within its (row, bid-node value) group — a
    segmented exclusive count over the value-sorted order."""
    act_pc = cand[:, None] & spread.pod_matches & (v_pc >= 0)
    rank_pc = torch.zeros(act_pc.shape, dtype=torch.int32, device=cand.device)
    for s, (perm, inv, firstv) in slot_sorts.items():
        rows_s = spread.slot == s
        srt = (act_pc & rows_s[None, :])[perm].to(torch.int32)
        exc = torch.cumsum(srt, dim=0, dtype=torch.int32) - srt
        seg = exc - exc[firstv]
        rank_pc = torch.where(rows_s[None, :], seg[inv], rank_pc)
    return rank_pc


def commit_spread(accept, nodes, counts, sp: SpreadArgs):
    """Fold the accepted pods into the node-space counts (the batched
    spread_update): every row a placed pod matches, at an eligible node
    with a value, gains one on every node sharing that value.  The
    reference adds in value space by Precision.HIGHEST matmuls of 0/1
    one-hots over the spread slots' rows; the counts are integers below
    2^24, so a direct index add gives the same floats, and `eligible`
    already leaves out every row outside those slots (the invalid ones)."""
    table, st, z = sp
    c_dim = counts.shape[0]
    v_pc = st.v.T[nodes]                                     # [P, C]
    elig_pc = st.eligible.T[nodes]
    act = accept[:, None] & table.pod_matches & elig_pc & (v_pc >= 0)
    pi, ci = torch.nonzero(act, as_tuple=True)
    adds = torch.zeros(c_dim * z, dtype=counts.dtype, device=counts.device)
    adds.index_add_(0, ci * z + v_pc[pi, ci].long(),
                    torch.ones(pi.shape[0], dtype=counts.dtype, device=counts.device))
    vc = torch.clamp(st.v, 0, z - 1).long()
    delta = torch.gather(adds.view(c_dim, z), 1, vc)
    return counts + torch.where(st.v >= 0, delta, 0.0)


def spread_repair_plain(accept, bid, counts, st: AuctionStatics, topo_ids):
    """Plain version of kernel `auction_spread`: the repair of one round's
    accepted set (SPREAD_REPAIR_ITERS admit passes, each committing its
    admits into a working copy of the counts so the minimum rises within
    the round), then the commit of the kept pods into the counts.
    Returns (kept bool[P], counts after the commit)."""
    table, sps, _ = st.sp
    n = topo_ids.shape[0]
    p = accept.shape[0]
    nodes = torch.clamp(bid, 0, n - 1).long()
    topo_pt = topo_ids[nodes]                                # [P, TK]
    v_pc = sps.v.T[nodes]                                    # [P, C]
    sorts = spread_slot_sorts(st.order, topo_pt, st.features.spread_slots)
    ar = torch.arange(p, device=accept.device)
    kept = torch.zeros_like(accept)
    counts_it = counts
    cmax = counts.shape[0]
    for _ in range(SPREAD_REPAIR_ITERS):
        cand = accept & ~kept
        min_c = spread_min_match(
            sps._replace(counts_node=counts_it), table,
            torch.arange(cmax, device=accept.device),
        )
        rank_pc = spread_ranks(cand, v_pc, table, sorts)
        admit = cand
        for j in range(table.pod_idx.shape[1]):
            cidx = table.pod_idx[:, j]
            c = torch.clamp(cidx, 0, cmax - 1).long()
            own = cand & (cidx >= 0) & table.hard[c] & (v_pc[ar, c] >= 0)
            cnt = counts_it[c, nodes]
            self_m = table.pod_matches[ar, c].to(counts.dtype)
            allowed = table.max_skew[c] + min_c[c] - cnt + (1.0 - self_m)
            rank = rank_pc[ar, c].to(counts.dtype)
            admit = admit & ~(own & (rank >= allowed))
        kept = kept | admit
        counts_it = commit_spread(admit, nodes, counts_it, st.sp)
    return kept, commit_spread(kept, nodes, counts, st.sp)


# -- the inter-pod anti-affinity repair --------------------------------------


def _term_state(st: AuctionStatics, term_bits):
    """The prep's TermState with the round's (present, blocked,
    global_any) bits."""
    present, blocked, global_any = term_bits
    return st.tm.state._replace(present_bits=present, blocked_bits=blocked,
                                global_any=global_any)


def _term_groups(st: AuctionStatics, topo_pt: torch.Tensor, s: int):
    """For topology slot s: the terms of that slot (bool[T]), each pod's
    bid-node value there (i32[P]) and its (value, term) group index
    (i64[P, T]), values clipped into [0, z_terms) as the reference clips."""
    table, _, z = st.tm
    t_dim = table.valid.shape[0]
    v_p = topo_pt[:, s]
    flat = (torch.clamp(v_p, 0, z - 1).long()[:, None] * t_dim
            + torch.arange(t_dim, device=v_p.device)[None, :])
    return table.slot == s, v_p, flat


def commit_terms_plain(accept, nodes, st: AuctionStatics, topo_ids, term_bits, tables):
    """The batched interpod_update: every term an accepted pod matches
    turns present (and global) on each node sharing its bid node's value
    in the term's slot, and every anti term it carries turns blocked there
    — OR-ed in value space, then mapped back to the nodes and packed.
    `tables`: repair_tables' (mi_dense, anti_dense, solve_pos)."""
    table, _, z = st.tm
    t_dim = table.valid.shape[0]
    mi_dense, anti_dense, _pos = tables
    present, blocked, global_any = term_bits
    topo_pt = topo_ids[nodes]
    for s in used_slots(st.features.term_slots, topo_ids.shape[1]):
        rel_t, v_p, _flat = _term_groups(st, topo_pt, s)
        ok_p = accept & (v_p >= 0)
        vcp = torch.clamp(v_p, 0, z - 1).long()
        z_mi = torch.zeros((z, t_dim), dtype=torch.int32, device=nodes.device)
        z_an = torch.zeros_like(z_mi)
        z_mi.index_add_(0, vcp, (mi_dense & rel_t[None, :] & ok_p[:, None]).to(torch.int32))
        z_an.index_add_(0, vcp, (anti_dense & rel_t[None, :] & ok_p[:, None]).to(torch.int32))
        z_mi, z_an = z_mi > 0, z_an > 0
        v_n = topo_ids[:, s]
        vn = torch.clamp(v_n, 0, z - 1).long()
        has = (v_n >= 0)[:, None]
        present = present | _pack_bits_t(z_mi[vn] & has)
        blocked = blocked | _pack_bits_t(z_an[vn] & has)
        global_any = global_any | _pack_bits_t(z_mi.any(dim=0))
    return present, blocked, global_any


def interpod_repair_plain(accept, bid, st: AuctionStatics, topo_ids, term_bits, tables=None):
    """Plain version of kernel `auction_interpod`: release the round's
    within-round anti-affinity conflicts — in each (term, topology value)
    group holding an accepted CARRIER of the term, only the first accepted
    involved pod (matching or carrying the term) in solve order stays —
    then commit the kept pods' term bits.  `tables`: repair_tables' output
    (made here when None).  Returns (kept bool[P], bits)."""
    if tables is None:
        tables = repair_tables(st.tm.table, st.order)
    mi_dense, anti_dense, solve_pos = tables
    table, _, z = st.tm
    t_dim = table.valid.shape[0]
    n = topo_ids.shape[0]
    p = accept.shape[0]
    nodes = torch.clamp(bid, 0, n - 1).long()
    topo_pt = topo_ids[nodes]
    release = torch.zeros_like(accept)
    pos_p = solve_pos[:, None].expand(p, t_dim)
    for s in used_slots(st.features.term_slots, topo_ids.shape[1]):
        rel_t, v_p, flat = _term_groups(st, topo_pt, s)
        involved = ((mi_dense | anti_dense) & rel_t[None, :]
                    & accept[:, None] & (v_p >= 0)[:, None])
        pos = torch.where(involved, pos_p, _BIG_I)
        minpos = torch.full((z * t_dim,), _BIG_I, dtype=pos.dtype, device=pos.device)
        minpos = minpos.scatter_reduce(0, flat.reshape(-1), pos.reshape(-1), "amin")
        carrier = (involved & anti_dense).to(torch.int32)
        c_any = torch.zeros(z * t_dim, dtype=torch.int32, device=pos.device)
        c_any = c_any.index_add(0, flat.reshape(-1), carrier.reshape(-1)) > 0
        viol = involved & c_any[flat] & (pos_p > minpos[flat])
        release = release | viol.any(dim=1)
    kept = accept & ~release
    return kept, commit_terms_plain(kept, nodes, st, topo_ids, term_bits, tables)


def _rounds_plain(cluster, pods, st, tie_k, cfg, max_rounds):
    """The reference's while_loop with host control flow (CPU).  Returns
    (assigned, bid_scores, requested, nonzero, rounds, spread counts, and
    the inter-pod present, blocked and global_any bits; None for a family
    the batch does not use)."""
    p = pods.req.shape[0]
    dev = cluster.allocatable.device
    assigned = torch.full((p,), -1, dtype=torch.int32, device=dev)
    bid_scores = torch.full((p,), NEG_INF, dtype=torch.float32, device=dev)
    requested, nonzero = cluster.requested, cluster.nonzero_requested
    use_spread, use_terms = st.features.spread, st.features.interpod
    counts = st.sp.state.counts_node.clone() if use_spread else None
    bits = term_bits_copy(st.tm, st.features)
    tables = repair_tables(st.tm.table, st.order) if use_terms else None
    rnd, progress = 0, True
    while rnd < max_rounds and progress and bool(((assigned < 0) & pods.valid).any()):
        bid, val = auction_bids_plain(
            cluster, pods, st, requested, nonzero, assigned, rnd, tie_k, cfg,
            counts, bits,
        )
        accept = auction_decide_plain(
            cluster.allocatable, pods, st.order, bid, requested,
        )
        # a round that only releases still progresses: the released pods
        # bid again against the raised counts and bits
        progress = bool(accept.any())
        if use_spread:
            accept, counts = spread_repair_plain(
                accept, bid, counts, st, cluster.topo_ids,
            )
        if use_terms:
            accept, bits = interpod_repair_plain(accept, bid, st, cluster.topo_ids, bits, tables)
        assigned, bid_scores, requested, nonzero = auction_commit_plain(
            pods, accept, bid, val, requested, nonzero, assigned, bid_scores,
        )
        rnd += 1
    return (assigned, bid_scores, requested, nonzero,
            torch.tensor(rnd, dtype=torch.int32, device=dev), counts,
            *(bits if use_terms else (None, None, None)))


def auction_rounds(cluster, pods, st, tie_k, cfg, max_rounds=64):
    """All bidding rounds: (assigned, bid_scores, requested, nonzero,
    rounds, spread counts, inter-pod present, blocked and global_any bits;
    None for a family the batch does not use).  On the CPU the plain loop;
    on the card one launch of kernel auction_loop, which runs the rounds
    until the device's continue flag falls, with no host sync."""
    if cluster.allocatable.device.type == "cpu":
        return _rounds_plain(cluster, pods, st, tie_k, cfg, max_rounds)
    from ..kernels import bindings

    return bindings.auction_rounds(cluster, pods, st, tie_k, cfg, max_rounds)


def gang_release_plain(pods, assigned, dropped, requested, nonzero):
    """The gang post-pass's subtraction, plain: (requested, nonzero) less
    every dropped pod's requests on its node, each node's in pod index
    order (auction_loop's gang stage subtracts in the same order)."""
    n = requested.shape[0]
    tgt = torch.clamp(assigned, 0, n - 1).long()
    w = dropped[:, None].to(pods.req.dtype)
    return (add_rows(requested, tgt, -pods.req * w),
            add_rows(nonzero, tgt, -pods.nonzero_req * w))


def gang_post_pass_plain(pods, assigned, bid_scores, reasons, requested, nonzero,
                         n_groups: int):
    """Plain version of auction_loop's gang stage (the reference's gang
    post-pass): a gang with an unplaced valid member releases its placed
    members, whose requests leave their nodes (gang_release_plain), who
    take assigned -1, bid score -inf and REASON_GANG.  Returns (assigned,
    bid_scores, reasons, gang_dropped bool[P], requested, nonzero);
    n_groups == 0 returns the inputs and no drop."""
    if n_groups <= 0:
        return (assigned, bid_scores, reasons, torch.zeros_like(pods.valid), requested,
                nonzero)
    g = pods.group_id
    gc = torch.clamp(g, 0, n_groups - 1).long()
    unplaced = ((assigned < 0) & pods.valid & (g >= 0)).to(torch.int32)
    incomplete = torch.zeros(n_groups, dtype=torch.int32, device=g.device)
    incomplete = incomplete.index_add(0, gc, unplaced) > 0
    dropped = (g >= 0) & incomplete[gc] & (assigned >= 0)
    requested, nonzero = gang_release_plain(pods, assigned, dropped, requested, nonzero)
    return (torch.where(dropped, -1, assigned), torch.where(dropped, NEG_INF, bid_scores),
            torch.where(dropped, REASON_GANG, reasons), dropped, requested, nonzero)


def failure_reasons(cluster, pods, st: AuctionStatics, assigned, requested, nonzero,
                    sp_counts=None, term_bits=None) -> torch.Tensor:
    """Wrapper of the reasons pass: for tensors on the card the reasons
    stage of kernel auction_loop launched alone on the given state
    (bindings.auction_reasons; the loop's launch runs the same stage after
    its rounds, which is what auction_assign reads), for tensors on the CPU
    failure_reasons_plain."""
    if requested.device.type == "cpu":
        return failure_reasons_plain(cluster, pods, st, assigned, requested, nonzero,
                                     sp_counts, term_bits)
    from ..kernels import bindings

    return bindings.auction_reasons(cluster, pods, st, assigned, requested, nonzero,
                                    sp_counts, term_bits)


def failure_reasons_plain(cluster, pods, st: AuctionStatics, assigned, requested, nonzero,
                          sp_counts=None, term_bits=None) -> torch.Tensor:
    """Plain version of auction_loop's reasons stage: one staged filter
    pass per class against the final state — the first stage that empties
    the candidate set; a class with survivors at every stage parked on
    contention (a resource reason).  i32[P], REASON_NONE for placed pods."""
    c_dim = pods.class_rep.shape[0]
    cl_f = cluster._replace(requested=requested, nonzero_requested=nonzero)
    fits_f = torch.cat([
        fits_resources(cl_f, pod_view(pods, st.s_reps[s : s + 1].long()))
        for s in range(st.s_reps.shape[0])
    ])
    jspec = st.jspec.long()
    s_static = st.sfeas_s[jspec]                               # [C, N]
    any_static = s_static.any(dim=1)
    f = s_static & fits_f[jspec]
    a_res = f.any(dim=1)
    if st.features.spread:
        sp_f = st.sp.state._replace(counts_node=sp_counts)
        spf_k = spread_filter(sp_f, st.sp.table, st.k_reps.long())  # [K, N]
        f = f & spf_k[st.jcons.long()]
    a_spread = f.any(dim=1)
    if st.features.interpod:
        ipf_k = interpod_filter(_term_state(st, term_bits), st.tm.table,
                                st.k_reps.long())                    # [K, N]
        f = f & ipf_k[st.jcons.long()]
    a_inter = f.any(dim=1)
    reason_c = torch.where(
        a_inter, REASON_RESOURCES,
        torch.where(
            ~any_static, REASON_STATIC,
            torch.where(
                ~a_res, REASON_RESOURCES,
                torch.where(~a_spread, REASON_SPREAD, REASON_INTERPOD),
            ),
        ),
    ).to(torch.int32)
    cls_all = torch.clamp(pods.class_id, 0, c_dim - 1).long()
    return torch.where(assigned >= 0, REASON_NONE, reason_c[cls_all])


def auction_assign(
    snapshot: Snapshot,
    cfg: ScoreConfig = DEFAULT_SCORE_CONFIG,
    n_groups: int = 0,
    max_rounds: int = 64,
    features: Optional[FeatureFlags] = None,
    tie_k: Optional[int] = None,
    topo_z: Optional[Tuple[int, int]] = None,
) -> AuctionResult:
    """Jointly assign the pending batch on the device its tensors lie on:
    rounds of (bid → per-node prefix acceptance → commit), then the staged
    reasons pass and the gang post-pass (n_groups > 0) — on the card all in
    the one launch of kernel auction_loop."""
    if features is None:
        features = features_of(snapshot)
    if not auction_features_ok(features):
        raise ValueError(
            "auction_assign does not cover in-batch host ports, "
            "affinity-direction inter-pod terms or slice carve-outs; route "
            "this batch through the greedy solves"
        )
    n = snapshot.cluster.allocatable.shape[0]
    tie_k = min(default_tie_k(snapshot) if tie_k is None else tie_k, n)
    cluster, pods, st = auction_prep(snapshot, features, topo_z, cfg)
    if cluster.allocatable.device.type == "cpu":
        out = auction_rounds(cluster, pods, st, tie_k, cfg, max_rounds)
        (assigned, bid_scores, requested, nonzero, rounds, sp_counts, *term_bits) = out
        term_bits = tuple(term_bits) if features.interpod else None
        reasons = failure_reasons_plain(cluster, pods, st, assigned, requested, nonzero,
                                        sp_counts, term_bits)
        # all-or-nothing groups, after the reasons as in the reference
        assigned, bid_scores, reasons, gang_dropped, requested, nonzero = gang_post_pass_plain(
            pods, assigned, bid_scores, reasons, requested, nonzero, n_groups)
    else:
        # the rounds, the reasons pass and the gang post-pass: one launch
        from ..kernels import bindings

        out, reasons, gang_dropped = bindings.auction_solve(cluster, pods, st, tie_k, cfg,
                                                            max_rounds, n_groups)
        (assigned, bid_scores, requested, nonzero, rounds, sp_counts, *term_bits) = out
        term_bits = tuple(term_bits) if features.interpod else None

    final = cluster._replace(requested=requested, nonzero_requested=nonzero)
    return AuctionResult(assigned, bid_scores, rounds, gang_dropped, final, reasons,
                         sp_counts, term_bits)
