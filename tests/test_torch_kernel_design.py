"""The arithmetic of the redesigned greedy_scan and auction_spread, on the CPU.

Neither kernel runs here (no card, no nvcc), so their two new designs are
emulated in numpy step for step and held to the plain versions and to the
reference:

(a) auction_spread's rank stage (csrc/auction_common.cuh rank_rows): a
    warp walks a hard row's solve order 32 positions at a time;
    __match_any_sync groups the lanes by their bid node's value, a lane's
    rank is its value's running counter plus the matching peers in lower
    lanes, and the lowest lane of each value adds the value's matching
    peers to the counter.  The counters are a shared table when the value
    space fits SHARED_Z entries (a zone key), and then each of L hard rows
    gets WARPS // L warps over segments of the solve order (a counting
    sweep and an exclusive prefix give each segment its starting
    counters); otherwise (a hostname key) one warp walks the row with the
    row's slice of the global [C, Z] scratch.
    The emulated ranks equal the port's spread_ranks (the reference's
    _spread_ranks) and a brute-force count; the emulated repair — minima
    split over warps, the walk, the commits — equals spread_repair_plain,
    and with it in place of the plain repair the port's auction equals the
    reference's auction_assign on two spread seeds.
(b) greedy_scan's split pick (csrc/greedy_scan.cu ClusterTeam): each of G
    blocks reduces (score, index) over its own nodes (32-node chunks dealt
    round robin) under solve_common.cuh's ranks_above, and every block
    merges the G partials; for G = 1..16 the pick equals jnp.argmax and
    torch.argmax of the masked scores (ties across blocks, NaN, +inf, a
    padded tail with no feasible node, one feasible node), whatever the
    order of the nodes in a block and of the partials.  The pass-1 Step
    merge (flags OR, integer count, fmaxf / fminf) is order-free the same
    way.

The redesigned wavefront (csrc/wavefront.cu) and its new arithmetic:

(c) the split top list: each of G blocks reads its round-robin 32-node
    chunks a chunk at a time into a 32-lane list (a chunk enters only if
    one of its entries ranks above the list's last kept entry; the chunk
    is sorted by a bitonic network, then merged into the list by a
    bitonic merge), and the G lists are merged by the same merge.  For G =
    1..16 the list equals _top_stable's and jax.lax.top_k's on the same row
    (ties across blocks, NaN and +inf entries, an all -inf row, N < kk),
    and, holding only the entries that are neither NaN nor -inf, the same
    list with those dropped.
(d) the shortened list: member j (counting live members) keeps the top
    min(j + 1, kk - nan_j) entries that are neither NaN nor -inf; for
    every j and rows whose NaN count lies around kk - j, with earlier
    picks that repeat a node, the first unpicked entry above -inf equals
    the one _cheap_pick finds in the full kk list.
(e) one wave, emulated: the members' rows against the wave-start carry
    (a replica — same class, requests and ports — sharing an earlier
    member's row, and its list as a prefix of the longest the replicas
    need), the shortened lists built by (c), and the replicated one-warp
    mini-scan — lane jj holding pick jj, the flip test and the
    closed-form correction on the lanes against the replicated wave-start
    and live rows (added in member order), nan_max and the first-max index
    by butterfly reductions, a flip re-evaluated against the live carry —
    equal wavefront_assign_plain on the random partitions of
    tests/test_torch_wavefront.py::test_random_partitions_are_exact and on
    NaN-poisoned waves.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import auction as jauction
from kubernetes_tpu.ops import schema as jschema
from kubernetes_tpu.ops import scores as jscores
from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu_torch.ops import assign as tassign
from kubernetes_tpu_torch.ops import auction as tauction
from kubernetes_tpu_torch.ops import device as dv
from kubernetes_tpu_torch.ops import scores as tscores
from kubernetes_tpu_torch.ops.filters import pod_view

from test_torch_spread_solves import CONFIGS, assert_fields, build_case, encode

WARPS = 32          # the spread repair at 1,024 threads a block
SHARED_Z = 256      # auction_common.cuh kShZ (bindings.SPREAD_SHARED_Z)
REPAIR_ITERS = 3    # ops/auction.py SPREAD_REPAIR_ITERS
BIG = np.float32(1e9)
F32 = np.float32


# ---- (a) the rank walk --------------------------------------------------


def walk_ranks(order, cand, bid, v, matches, pod_idx, hard, z, shared_z=SHARED_Z):
    """ranks[P, C]: each candidate's rank in every hard row it is ranked in
    (-1 elsewhere), as rank_rows computes it: with shared tables and L <
    WARPS hard rows, WARPS // L warps a row, each over a segment of the
    solve order (a counting sweep, an exclusive prefix over the row's
    warps, then the walk from it); else one warp a row from zero."""
    p = order.shape[0]
    c_dim, n = v.shape
    ranks = np.full((p, c_dim), -1, np.int64)
    rows = [c for c in range(c_dim) if hard[c]]
    in_shared = z <= shared_z
    wpr = WARPS // len(rows) if in_shared and 0 < len(rows) < WARPS else 1
    seg = -(-p // (wpr * 32)) * 32
    below = [(1 << lane) - 1 for lane in range(32)]
    for c in rows:
        entries = []                         # (key, pod, from, ranked) a position
        for k in range(p):
            i = order[k]
            val = v[c, min(max(bid[i], 0), n - 1)]
            m = bool(matches[i, c])
            own = any(cx >= 0 and min(cx, c_dim - 1) == c for cx in pod_idx[i])
            act = bool(cand[i]) and val >= 0 and (m or own)
            entries.append((min(val, z - 1) if act else -1, i, act and m, act and own))
        starts, run = [], np.zeros(z, np.int64)
        for part in range(wpr):              # the counting sweep, then the prefix
            starts.append(run.copy())
            for key, _i, frm, _r in entries[part * seg:(part + 1) * seg]:
                if frm:
                    run[key] += 1
        for part in range(wpr):
            tab = starts[part].copy()        # a shared table, or the global row slice
            lo, hi = min(p, part * seg), min(p, (part + 1) * seg)
            for k0 in range(lo, hi, 32):     # __match_any_sync, one chunk at a time
                lanes = entries[k0:min(hi, k0 + 32)]
                lanes += [(-1, 0, False, False)] * (32 - len(lanes))
                keys = [ln[0] for ln in lanes]
                frm_mask = sum(1 << j for j, ln in enumerate(lanes) if ln[2])
                before = [tab[k] if k >= 0 else 0 for k in keys]
                for lane, (key, pod, _f, ranked) in enumerate(lanes):
                    peers = sum(1 << j for j, k in enumerate(keys) if k == key)
                    if ranked:
                        lower = peers & frm_mask & below[lane]
                        ranks[pod, c] = before[lane] + bin(lower).count("1")
                for lane, key in enumerate(keys):
                    peers = sum(1 << j for j, k in enumerate(keys) if k == key)
                    group = peers & frm_mask
                    if key >= 0 and group and lane == (peers & -peers).bit_length() - 1:
                        tab[key] = before[lane] + bin(group).count("1")
    return ranks


def brute_ranks(order, cand, bid, v, matches, pod_idx, hard):
    """The quadratic definition (the first kernel's loop): earlier candidates in
    solve order that match the row and bid a node of the same value."""
    p = order.shape[0]
    c_dim, n = v.shape
    node = np.clip(bid, 0, n - 1)
    ranks = np.full((p, c_dim), -1, np.int64)
    for k, i in enumerate(order):
        if not cand[i]:
            continue
        for cx in pod_idx[i]:
            c = min(cx, c_dim - 1)
            if cx < 0 or not hard[c] or v[c, node[i]] < 0:
                continue
            ranks[i, c] = sum(1 for q in order[:k] if cand[q] and matches[q, c]
                              and v[c, node[q]] == v[c, node[i]])
    return ranks


def row_minima(eligible, counts, min_domains, sizes):
    """row_minima: W / C warps a row (one when C >= W), each over the nodes
    nd with (nd // 32) % warps_a_row == its part, merged by fminf."""
    c_dim, n = counts.shape
    wpr = 1 if c_dim >= WARPS else WARPS // c_dim
    rows = WARPS // wpr
    part_of = (np.arange(n) // 32) % wpr
    minc = np.zeros(c_dim, F32)
    for base in range(0, c_dim, rows):
        for t in range(rows):
            c = base + t
            if c >= c_dim:
                continue
            parts = [np.where(eligible[c] & (part_of == q), counts[c], BIG).min()
                     for q in range(wpr)]
            m = F32(min(parts))
            if m >= BIG:
                m = F32(0)
            if min_domains[c] > 0 and sizes[c] < min_domains[c]:
                m = F32(0)
            minc[c] = m
    return minc


def commit(marked, bid, v, eligible, matches, counts, z):
    """commit_marked: integer adds in value space, read back per node."""
    c_dim, n = v.shape
    adds = np.zeros((c_dim, z), np.int64)
    for i in np.nonzero(marked)[0]:
        node = min(max(bid[i], 0), n - 1)
        for c in range(c_dim):
            if matches[i, c] and eligible[c, node] and v[c, node] >= 0:
                adds[c, min(v[c, node], z - 1)] += 1
    a = adds[np.arange(c_dim)[:, None], np.clip(v, 0, z - 1)]
    out = counts.copy()
    hit = (v >= 0) & (a != 0)
    out[hit] = (counts[hit] + a[hit].astype(F32)).astype(F32)
    return out


def emulated_repair(accept, bid, counts, t, shared_z=SHARED_Z):
    """The kernel's round: three admit passes (minima, the walk's admit
    test, the commit into the working counts), then the kept pods'
    commit.  t: the tables as numpy (spread_tables)."""
    kept = np.zeros_like(accept)
    counts_it = counts.copy()
    n = t["v"].shape[1]
    node = np.clip(bid, 0, n - 1)
    for _ in range(REPAIR_ITERS):
        cand = accept & ~kept
        minc = row_minima(t["eligible"], counts_it, t["min_domains"], t["sizes"])
        ranks = walk_ranks(t["order"], cand, bid, t["v"], t["matches"], t["pod_idx"],
                           t["hard"], t["z"], shared_z)
        admit = cand.copy()
        for i, c in zip(*np.nonzero(ranks >= 0)):
            self_m = F32(1) if t["matches"][i, c] else F32(0)
            allowed = (F32(t["max_skew"][c]) + minc[c]) - counts_it[c, node[i]] + (F32(1) - self_m)
            if F32(ranks[i, c]) >= allowed:
                admit[i] = False
        counts_it = commit(admit, bid, t["v"], t["eligible"], t["matches"], counts_it, t["z"])
        kept |= admit
    return kept, commit(kept, bid, t["v"], t["eligible"], t["matches"], counts, t["z"])


def spread_tables(st):
    table, state, z = st.sp
    return {"v": state.v.numpy(), "eligible": state.eligible.numpy(),
            "matches": table.pod_matches.numpy(), "pod_idx": table.pod_idx.numpy(),
            "hard": table.hard.numpy(), "max_skew": table.max_skew.numpy(),
            "min_domains": table.min_domains.numpy(), "sizes": state.sizes.numpy(),
            "order": st.order.numpy(), "z": int(z)}


def synthetic(seed, p, z_kind):
    """Random spread rows: TK topology slots of n nodes (a zone-sized or a
    hostname-sized value space, some nodes without the key), C rows on
    those slots (some soft), pods with 1-3 rows each (-1 padded), partial
    selector matches, bids with many ties, a random candidate set and a
    shuffled solve order."""
    rng = np.random.default_rng(seed)
    n = 300
    z = 8 if z_kind == "zone" else n
    tk, c_dim, mc = 3, 5, 3
    topo = rng.integers(0, z, size=(n, tk)).astype(np.int32)
    topo[rng.random((n, tk)) < 0.1] = -1
    slot = rng.integers(0, tk, size=c_dim).astype(np.int32)
    v = topo[:, slot].T.copy()
    hard = rng.random(c_dim) < 0.7
    hard[0] = True
    matches = rng.random((p, c_dim)) < 0.6
    pod_idx = np.full((p, mc), -1, np.int32)
    for i in range(p):
        k = int(rng.integers(1, mc + 1))
        pod_idx[i, :k] = rng.choice(c_dim, size=k, replace=False)
    bid = rng.integers(0, 24 if z_kind == "zone" else n, size=p).astype(np.int32)
    cand = rng.random(p) < 0.8
    order = rng.permutation(p).astype(np.int32)
    return order, cand, bid, v, matches, pod_idx, hard, z, topo, slot


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("z_kind", ["zone", "hostname"])
@pytest.mark.parametrize("p", [33, 257])
def test_walk_ranks_equal_spread_ranks(seed, z_kind, p):
    order, cand, bid, v, matches, pod_idx, hard, z, topo, slot = synthetic(seed, p, z_kind)
    got = walk_ranks(order, cand, bid, v, matches, pod_idx, hard, z)
    assert (z > SHARED_Z) == (z_kind == "hostname")
    assert (got >= 0).sum() > 0
    np.testing.assert_array_equal(got, brute_ranks(order, cand, bid, v, matches, pod_idx, hard))
    # the reference's path: one stable value sort a slot, a segmented count
    nodes = torch.as_tensor(np.clip(bid, 0, v.shape[1] - 1)).long()
    topo_pt = torch.as_tensor(topo)[nodes]
    table = type("Table", (), {"pod_matches": torch.as_tensor(matches),
                               "slot": torch.as_tensor(slot)})
    v_pc = torch.as_tensor(v).T[nodes]
    sorts = tauction.spread_slot_sorts(torch.as_tensor(order), topo_pt,
                                       sorted(set(slot.tolist())))
    want = tauction.spread_ranks(torch.as_tensor(cand), v_pc, table, sorts).numpy()
    ranked = got >= 0
    np.testing.assert_array_equal(got[ranked], want[ranked])


REPAIR_CASES = ["seed0-least", "seed1-most", "seed2-rtcr", "seed3-weight", "coupled",
                "carrier", "auction_complete"]


def round0(case):
    """A case's auction statics and round 0's bids, accepted set and counts
    on the port's plain path (CPU tensors)."""
    objs, cfg_name = build_case(case)
    _snap, tsnap = encode(objs)
    cfg = tscores.ScoreConfig(**CONFIGS[cfg_name])
    cluster, pods, st = tauction.auction_prep(tsnap, cfg=cfg)
    p = pods.req.shape[0]
    assigned = torch.full((p,), -1, dtype=torch.int32)
    counts = st.sp.state.counts_node.clone()
    bits = tauction.term_bits_copy(st.tm, st.features)
    bid, _val = tauction.auction_bids_plain(
        cluster, pods, st, cluster.requested, cluster.nonzero_requested, assigned, 0,
        tauction.default_tie_k(tsnap), cfg, counts, bits)
    accept = tauction.auction_decide_plain(cluster.allocatable, pods, st.order, bid,
                                           cluster.requested)
    return cluster, st, bid, accept, counts


@pytest.mark.parametrize("case", REPAIR_CASES)
@pytest.mark.parametrize("table", ["shared", "global"])
def test_emulated_repair_equals_plain(case, table):
    cluster, st, bid, accept, counts = round0(case)
    t = spread_tables(st)
    rng = np.random.default_rng(len(case))
    subsets = [accept.numpy(), accept.numpy() & (rng.random(accept.shape[0]) < 0.6),
               rng.random(accept.shape[0]) < 0.9]
    for acc in subsets:
        kept, got_counts = emulated_repair(acc.copy(), bid.numpy(), counts.numpy(), t,
                                           SHARED_Z if table == "shared" else 0)
        want_kept, want_counts = tauction.spread_repair_plain(
            torch.as_tensor(acc), bid, counts, st, cluster.topo_ids)
        np.testing.assert_array_equal(kept, want_kept.numpy())
        np.testing.assert_array_equal(got_counts, want_counts.numpy())


@pytest.mark.parametrize("case", ["seed0-least", "seed1-most"])
def test_auction_with_emulated_repair_matches_reference(case, monkeypatch):
    def repair(accept, bid, counts, st, topo_ids):
        kept, out = emulated_repair(accept.numpy().copy(), bid.numpy(), counts.numpy(),
                                    spread_tables(st))
        return torch.as_tensor(kept), torch.as_tensor(out)

    monkeypatch.setattr(tauction, "spread_repair_plain", repair)
    objs, cfg = build_case(case)
    snap, tsnap = encode(objs)
    n_groups = jschema.num_groups(snap)
    tie_k = jauction.default_tie_k(snap)
    want = jauction.auction_assign_jit(jscores.ScoreConfig(**CONFIGS[cfg]))(
        snap, n_groups=n_groups, tie_k=tie_k)
    got = tauction.auction_assign(tsnap, tscores.ScoreConfig(**CONFIGS[cfg]),
                                  n_groups=n_groups, tie_k=tie_k)
    assert_fields(want, got, ("assignment", "scores", "reasons", "gang_dropped", "rounds",
                              "debug_sp_counts"))


# ---- (b) the split-range pick ---------------------------------------------

INT_MAX = 0x7FFFFFFF


def ranks_above(s, i, best, idx):
    """solve_common.cuh ranks_above: NaN first, then score desc, index asc."""
    sn, bn = math.isnan(s), math.isnan(best)
    if sn != bn:
        return sn
    return i < idx if sn else (s > best or (s == best and i < idx))


def block_nodes(n, g, b):
    """greedy_scan.cu block_of: block b's nodes, the 32-node chunks q with
    q % g == b."""
    nd = np.arange(n)
    return nd[(nd // 32) % g == b]


def cluster_pick(scores, feasible, g, rng):
    """Each of g blocks over its own nodes in a shuffled order (a block
    reduces in a tree), then the g partials merged in a shuffled order."""
    n = scores.shape[0]
    parts = []
    for b in range(g):
        best, idx = -math.inf, INT_MAX
        for nd in rng.permutation(block_nodes(n, g, b)):
            if feasible[nd] and ranks_above(float(scores[nd]), int(nd), best, idx):
                best, idx = float(scores[nd]), int(nd)
        parts.append((best, idx))
    best, idx = -math.inf, INT_MAX
    for pb, pi in (parts[k] for k in rng.permutation(g)):
        if ranks_above(pb, pi, best, idx):
            best, idx = pb, pi
    return best, idx


def pick_row(kind, rng, n):
    """(scores, feasible) of one row: integer scores with ties across range
    boundaries, then NaN, +inf, or whole ranges of infeasible padding."""
    scores = rng.integers(0, 40, size=n).astype(np.float32)
    feasible = rng.random(n) < 0.7
    top = np.float32(100)
    if kind == "ties_across":
        at = rng.choice(n, size=6, replace=False)
        scores[at], feasible[at] = top, True
    elif kind == "nan":
        at = rng.choice(n, size=3, replace=False)
        scores[at], feasible[at] = np.nan, True
    elif kind == "inf":
        at = rng.choice(n, size=3, replace=False)
        scores[at], feasible[at] = np.inf, True
    elif kind == "padding_ranges":
        live = n // 3                      # the padded tail: no feasible node
        feasible[live:] = False
        scores[live:] = -np.inf
        at = rng.choice(live, size=2, replace=False)
        scores[at], feasible[at] = top, True
    elif kind == "one_feasible_last":
        feasible[:] = False
        feasible[n - 1] = True
    return scores, feasible


@pytest.mark.parametrize("g", [1, 2, 3, 4, 7, 8, 16])
@pytest.mark.parametrize("kind", ["ties_across", "nan", "inf", "padding_ranges",
                                  "one_feasible_last"])
def test_split_pick_equals_argmax(g, kind):
    rng = np.random.default_rng(1000 * g + len(kind))
    for n in (7, 64, 1000, 4096):
        scores, feasible = pick_row(kind, rng, n)
        masked = np.where(feasible, scores, np.float32(-np.inf)).astype(np.float32)
        best, idx = cluster_pick(scores, feasible, g, rng)
        want = int(jnp.argmax(jnp.asarray(masked)))
        assert idx == want == int(torch.argmax(torch.as_tensor(masked)))
        assert (math.isnan(best) and math.isnan(masked[want])) or best == masked[want]


def step_merge(a, b):
    return (a[0] | b[0], a[1] + b[1], max(a[2], b[2]), max(a[3], b[3]), max(a[4], b[4]),
            min(a[5], b[5]))


@pytest.mark.parametrize("g", [1, 2, 5, 8, 16])
def test_step_merge_is_order_free(g):
    """Pass 1's per-range Steps (stage flags, feasible count, the
    normalisation maxima, the spread raw max / min) merged across g ranges
    in any order give the whole row's Step."""
    rng = np.random.default_rng(g)
    n = 2048
    flags = rng.integers(0, 64, size=n)
    feas = rng.random(n) < 0.5
    aff = rng.integers(0, 50, size=n).astype(np.float32)
    taint = rng.integers(0, 9, size=n).astype(np.float32)
    raw = rng.integers(-5, 80, size=n).astype(np.float32)
    zero = (0, 0, np.float32(0), np.float32(0), np.float32(-1e9), np.float32(1e9))

    def step_of(nodes):
        s = zero
        for nd in nodes:
            s = step_merge(s, (int(flags[nd]), int(feas[nd]),
                               aff[nd] if feas[nd] else np.float32(0),
                               taint[nd] if feas[nd] else np.float32(0),
                               raw[nd] if feas[nd] else np.float32(-1e9),
                               raw[nd] if feas[nd] else np.float32(1e9)))
        return s

    whole = step_of(range(n))
    parts = [step_of(rng.permutation(block_nodes(n, g, b))) for b in range(g)]
    merged = zero
    for k in rng.permutation(g):
        merged = step_merge(merged, parts[k])
    assert merged == whole


# ---- (c) the split top list -------------------------------------------------

LANES = 32


def ranks_above_v(s, i, b, bi):
    """ranks_above lane by lane (numpy arrays)."""
    sn, bn = np.isnan(s), np.isnan(b)
    return np.where(sn != bn, sn, np.where(sn, i < bi, (s > b) | ((s == b) & (i < bi))))


def cmpx(v, i, j, desc):
    """wavefront.cu cmpx: lanes l and l ^ j exchange; the lower lane keeps
    the higher-ranked entry where desc[l]."""
    lanes = np.arange(LANES)
    ov, oi = v[lanes ^ j], i[lanes ^ j]
    lower = (lanes & j) == 0
    take = np.where(lower == desc, ranks_above_v(ov, oi, v, i), ranks_above_v(v, i, ov, oi))
    return np.where(take, ov, v), np.where(take, oi, i)


def warp_sort(v, i):
    lanes = np.arange(LANES)
    k = 2
    while k <= LANES:
        j = k >> 1
        while j > 0:
            v, i = cmpx(v, i, j, (lanes & k) == 0)
            j >>= 1
        k <<= 1
    return v, i


def warp_merge(lv, li, cv, ci):
    """wavefront.cu warp_merge: the top 32 of two sorted lists."""
    rv, ri = cv[::-1], ci[::-1]
    take = ranks_above_v(rv, ri, lv, li)
    lv, li = np.where(take, rv, lv), np.where(take, ri, li)
    for j in (16, 8, 4, 2, 1):
        lv, li = cmpx(lv, li, j, np.ones(LANES, bool))
    return lv, li


def empty_list():
    return np.full(LANES, -np.inf, np.float32), np.full(LANES, INT_MAX, np.int64)


def block_list(row, g, b, m, only_finite):
    """Block b's list of m entries over its chunks q (q % g == b), in the
    kernel's order; only_finite: the kernel's lists (no NaN, no -inf)."""
    n = row.shape[0]
    lv, li = empty_list()
    for q in range(b, -(-n // LANES), g):
        nd = q * LANES + np.arange(LANES)
        v = np.where(nd < n, row[np.minimum(nd, n - 1)], np.float32(-np.inf)).astype(np.float32)
        enter = ranks_above_v(v, nd, np.full(LANES, lv[m - 1]), np.full(LANES, li[m - 1]))
        if only_finite:
            enter &= ~np.isnan(v) & (v > -np.inf)
        if not enter.any():
            continue
        cv, ci = warp_sort(np.where(enter, v, np.float32(-np.inf)), np.where(enter, nd, INT_MAX))
        lv, li = warp_merge(lv, li, cv, ci)
    return lv, li


def split_list(row, g, m, only_finite):
    """The G blocks' lists (their first m lanes) merged in block order."""
    lv = li = None
    for b in range(g):
        bv, bi = block_list(row, g, b, m, only_finite)
        cv, ci = empty_list()
        cv[:m], ci[:m] = bv[:m], bi[:m]
        lv, li = (cv, ci) if lv is None else warp_merge(lv, li, cv, ci)
    return lv[:m], li[:m]


def top_row(kind, rng, n):
    """A row of integer scores with ties across blocks, then NaN, +inf,
    -inf (infeasible) entries, or all -inf."""
    row = rng.integers(0, 12, size=n).astype(np.float32)
    row[rng.random(n) < 0.3] = -np.inf
    if kind == "nan":
        row[rng.choice(n, size=min(n, 5), replace=False)] = np.nan
    elif kind == "inf":
        row[rng.choice(n, size=min(n, 4), replace=False)] = np.inf
    elif kind == "all_neg_inf":
        row[:] = -np.inf
    elif kind == "mixed":
        at = rng.choice(n, size=min(n, 6), replace=False)
        row[at[:2]], row[at[2:4]] = np.nan, np.inf
    return row


@pytest.mark.parametrize("g", [1, 2, 3, 5, 8, 16])
@pytest.mark.parametrize("kind", ["ties", "nan", "inf", "all_neg_inf", "mixed"])
def test_split_top_list_equals_top_k(g, kind):
    rng = np.random.default_rng(100 * g + len(kind))
    for n, k_dim in ((7, 32), (40, 32), (300, 8), (1100, 32)):
        kk = min(k_dim + 1, n)
        row = top_row(kind, rng, n)
        want_v, want_i = tassign._top_stable(torch.as_tensor(row), kk)
        jv, ji = jax.lax.top_k(jnp.asarray(row), kk)
        np.testing.assert_array_equal(np.asarray(ji), want_i.numpy())
        # a warp's list holds 32 entries; a member's needs at most K
        full = min(kk, LANES)
        lv, li = split_list(row, g, full, only_finite=False)
        np.testing.assert_array_equal(li, want_i.numpy()[:full])
        np.testing.assert_array_equal(lv.view(np.int32), want_v.numpy()[:full].view(np.int32))
        # the kernel's lists: the same order with NaN and -inf dropped
        keep = ~np.isnan(want_v.numpy()) & (want_v.numpy() > -np.inf)
        keep[full:] = False
        m = int(keep.sum())
        if m:
            fv, fi = split_list(row, g, m, only_finite=True)
            np.testing.assert_array_equal(fi, want_i.numpy()[keep])
            np.testing.assert_array_equal(fv, want_v.numpy()[keep])


# ---- (d) the shortened list -------------------------------------------------


def first_unpicked(vals, idxs, picks, n):
    """_cheap_pick's best unpicked candidate of a list: the first entry
    not picked and above -inf, else (-inf, n)."""
    for v, i in zip(vals, idxs):
        if int(i) not in picks and v > -np.inf:
            return np.float32(v), int(i)
    return np.float32(-np.inf), n


@pytest.mark.parametrize("n,k_dim", [(64, 8), (64, 32), (20, 32)])
@pytest.mark.parametrize("seed", range(2))
def test_shortened_list_first_unpicked(n, k_dim, seed):
    rng = np.random.default_rng(seed * 97 + n + k_dim)
    kk = min(k_dim + 1, n)
    checked = 0
    for j in range(k_dim):
        for nans in sorted({kk - j - 2, kk - j - 1, kk - j, kk - j + 1}):
            if not 0 <= nans <= n:
                continue
            row = rng.integers(0, 6, size=n).astype(np.float32)
            row[rng.random(n) < 0.2] = -np.inf
            row[rng.choice(n, size=2, replace=False)] = np.inf
            row[rng.choice(n, size=nans, replace=False)] = np.nan
            topv, topi = tassign._top_stable(torch.as_tensor(row), kk)
            topv, topi = topv.numpy(), topi.numpy()
            # j earlier members: some not placed, some on the same node,
            # most on this member's best nodes
            pool = [int(x) for x in topi] + list(rng.integers(0, n, size=4))
            picks = {int(rng.choice(pool)) for _ in range(j) if rng.random() < 0.85}
            want = first_unpicked(topv, topi, picks, n)
            m = min(j + 1, kk - min(kk, int(np.isnan(row).sum())))
            got = (np.float32(-np.inf), n)
            if m > 0:
                lv, li = split_list(row, int(rng.integers(1, 5)), m, only_finite=True)
                got = first_unpicked(lv, li, picks, n)
            assert got[1] == want[1], (j, nans, picks)
            assert np.float32(got[0]).view(np.int32) == np.float32(want[0]).view(np.int32)
            checked += 1
    assert checked


# ---- (e) one wave, emulated -------------------------------------------------


def nan_max(a, b):
    return np.float32(np.nan) if (np.isnan(a) or np.isnan(b)) else np.float32(max(a, b))


def butterfly(vals, op):
    """A warp's xor-shuffle reduction (offsets 16..1): lane 0's result."""
    vals = list(vals)
    for off in (16, 8, 4, 2, 1):
        vals = [op(vals[lane], vals[lane ^ off]) for lane in range(LANES)]
    return vals[0]


def fits(rq, cap, req):
    return bool(((req <= 0) | (rq + req <= cap)).all())


def score_parts(cluster, pod, cfg, cap, rq, nz):
    """(fit, bal) at one node with rows (cap, rq, nz): the port's score
    rows on a one-node cluster."""
    one = cluster._replace(allocatable=cap[None], requested=rq[None], nonzero_requested=nz[None])
    fit, bal = tscores.resource_score_parts(one, pod, cfg)
    return fit[0], bal[0]


def emulated_wavefront(cluster, pods, sfeas_c, aff_c, taint_c, members, features, n_groups,
                       cfg, g, sp_args=None, tm_args=None, extra_c=None):
    """wavefront.cu's wave loop on torch CPU tensors (see (e) above);
    returns what wavefront_assign_plain returns (its first nine fields)."""
    n, r = cluster.allocatable.shape
    p = pods.req.shape[0]
    c_dim = sfeas_c.shape[0]
    k_dim = members.shape[1]
    kk = min(k_dim + 1, n)
    requested = cluster.requested.clone()            # the device carry
    nonzero = cluster.nonzero_requested.clone()
    new_ports = torch.zeros_like(cluster.port_bits) if features.ports else None
    class_id = pods.class_id.tolist()
    assignment = torch.full((p,), -1, dtype=torch.int32)
    win = torch.full((p,), -np.inf, dtype=torch.float32)
    counts = torch.zeros(p, dtype=torch.int32)
    reasons = torch.full((p,), -1, dtype=torch.int32)
    n_waves = n_fb = 0
    sp, spread = tassign._spread_carry(sp_args, features)
    tm, terms = tassign._term_carry(tm_args, features)
    term_rows = tassign.wave_term_rows(terms) if features.interpod else None
    neg = np.float32(-np.inf)

    def record(i, choice, best, cnt, reason, found):
        assignment[i] = choice if found else -1
        win[i] = float(best) if found else float(neg)
        counts[i] = cnt
        reasons[i] = reason

    def commit_carry(i, nd):
        nonlocal sp, tm
        if features.ports:
            new_ports[nd] |= pods.port_bits[i]
        if features.spread:
            sp = tassign.spread_update(sp, spread, i, nd)
        if features.interpod:
            tm = tassign.interpod_update(tm, i, nd)

    for row in members.tolist():
        live = [(j, i) for j, i in enumerate(row) if i >= 0]
        if not live:
            continue
        n_waves += 1
        if not tassign._wave_safe(pods, [i for _, i in live], features, spread, term_rows):
            for _, i in live:
                cl = cluster._replace(requested=requested, nonzero_requested=nonzero)
                cls = min(max(class_id[i], 0), c_dim - 1)
                choice, best, cnt, reason, found = tassign._pick_full(
                    cl, pods, i, cls, sfeas_c, aff_c, taint_c, new_ports, sp, spread, features,
                    cfg, tm, terms, extra_c)
                record(i, choice, best, cnt, reason, found)
                if found:
                    requested[choice] += pods.req[i]
                    nonzero[choice] += pods.nonzero_req[i]
                    commit_carry(i, choice)
            n_fb += len(live)
            continue
        cl0 = cluster._replace(requested=requested.clone(), nonzero_requested=nonzero.clone())
        # a member whose class, requests and ports equal an earlier one's
        # shares its evaluation (not with the spread or inter-pod family)
        # and its list, as long as the last of them needs
        rep, part, lens = {}, {}, {}
        for rank, (j, i) in enumerate(live):
            cls = min(max(class_id[i], 0), c_dim - 1)
            rep[j] = j
            if not (features.spread or features.interpod):
                rep[j] = next((jj for jj, ii in live[:rank]
                               if class_id[ii] == class_id[i]
                               and torch.equal(pods.req[ii], pods.req[i])
                               and torch.equal(pods.nonzero_req[ii], pods.nonzero_req[i])
                               and torch.equal(pods.port_bits[ii], pods.port_bits[i])), j)
            if rep[j] == j:
                _, masked, found, reason, cnt = tassign._eval_pod(
                    cl0, pods, i, cls, sfeas_c, aff_c, taint_c, new_ports, sp, spread,
                    features, cfg, tm, terms, extra_c)
                part[j] = (masked.numpy(), found, reason, cnt)
            nans = int(np.isnan(part[rep[j]][0]).sum())
            lens[j] = max(min(rank + 1, kk - min(kk, nans)), 0)
        lists = {}
        for j, _i in live:
            longest = max(lens[jj] for jj, _ in live if rep[jj] == j) if rep[j] == j else 0
            if longest > 0:
                lists[j] = split_list(part[j][0], g, longest, only_finite=True)
        lists = {j: tuple(x[:lens[j]] for x in lists[rep[j]]) if lens[j] else
                 (np.zeros(0, np.float32), np.zeros(0, np.int64)) for j, _i in live}
        part = {j: part[rep[j]] for j, _i in live}
        # the mini-scan: lane jj holds pick jj; replicated rows per pick
        mine = [-1] * LANES
        r0, z0, rl, zl, cap = {}, {}, {}, {}, {}
        last = list(range(LANES))
        for j, i in live:
            row_np, found_k, reason_k, cnt_k = part[j]
            pod = pod_view(pods, i)
            cls = min(max(class_id[i], 0), c_dim - 1)
            req, nz = pod.req, pod.nonzero_req
            lv, li = lists[j]
            ok = [(v > -np.inf) and all(mine[jj] != int(x) for jj in range(LANES))
                  for v, x in zip(lv, li)]
            hit = next((t for t, o in enumerate(ok) if o), None)
            bu_v, bu_i = (np.float32(lv[hit]), int(li[hit])) if hit is not None else (neg, n)
            flip = False
            cand = [neg] * LANES
            for jj in range(j):
                nd = mine[jj]
                if nd < 0:
                    continue
                lst = last[jj]
                f0, fc = fits(r0[jj], cap[jj], req), fits(rl[lst], cap[jj], req)
                flip |= bool(sfeas_c[cls][nd]) and f0 != fc
                base = np.float32(row_np[nd])
                if base > -np.inf:
                    fit0, bal0 = score_parts(cluster, pod, cfg, cap[jj], r0[jj], z0[jj])
                    fitc, balc = score_parts(cluster, pod, cfg, cap[jj], rl[lst], zl[lst])
                    d = cfg.fit_weight * (fitc - fit0) + cfg.balanced_weight * (balc - bal0)
                    cand[jj] = np.float32((torch.tensor(base) + d).item())
            if flip:
                # every pick's live rows written by its owner, then the
                # member against the live carry
                for jj in range(j):
                    if mine[jj] >= 0 and last[jj] == jj:
                        requested[mine[jj]] = rl[jj]
                        nonzero[mine[jj]] = zl[jj]
                cl = cluster._replace(requested=requested, nonzero_requested=nonzero)
                choice, best, cnt, reason, found = tassign._pick_full(
                    cl, pods, i, cls, sfeas_c, aff_c, taint_c, new_ports, sp, spread, features,
                    cfg, tm, terms, extra_c)
                n_fb += 1
            else:
                best = nan_max(butterfly(cand, nan_max), bu_v)
                found = found_k and best > -np.inf
                choice = butterfly([mine[l] if cand[l] >= best and cand[l] > -np.inf else n
                                    for l in range(LANES)], min)
                if bu_v >= best and bu_v > -np.inf:
                    choice = min(choice, bu_i)
                choice = min(max(choice, 0), n - 1)
                cnt, reason = cnt_k, reason_k
            record(i, choice, best, cnt, reason, found)
            if found:
                same = [jj for jj in range(j) if mine[jj] == choice]
                if same:
                    r0[j], z0[j], cap[j] = r0[same[0]], z0[same[0]], cap[same[0]]
                    prev_r, prev_z = rl[same[-1]], zl[same[-1]]
                else:
                    r0[j], z0[j] = requested[choice].clone(), nonzero[choice].clone()
                    cap[j] = cluster.allocatable[choice]
                    prev_r, prev_z = r0[j], z0[j]
                rl[j], zl[j] = prev_r + pods.req[i], prev_z + pods.nonzero_req[i]
                for jj in same:
                    last[jj] = j
                mine[j] = choice
        # the wave's end: each picked node's live row once, then the
        # deferred port, spread and term commits in member order
        for j, i in live:
            if mine[j] >= 0 and last[j] == j:
                requested[mine[j]] = rl[j]
                nonzero[mine[j]] = zl[j]
        for j, i in live:
            if mine[j] >= 0:
                commit_carry(i, mine[j])
    if n_groups > 0:
        assignment, win, reasons, requested, nonzero = tassign._gang_release(
            assignment, win, reasons, requested, nonzero, pods, n_groups, n)
    ports = cluster.port_bits | new_ports if features.ports else cluster.port_bits
    return (assignment, win, counts, reasons, requested, nonzero, ports,
            torch.tensor(n_waves, dtype=torch.int32), torch.tensor(n_fb, dtype=torch.int32))


def partition_case(seed):
    """test_random_partitions_are_exact's batch and partition (seed)."""
    gi, mi = jw.GI, jw.MI
    rng = np.random.default_rng(100 + seed)
    nodes = [jw.make_node(f"n{i}").capacity(cpu_milli=4000, mem=8 * gi, pods=110)
             .zone(f"z{i % 2}").obj() for i in range(6)]
    pods = []
    for i in range(18):
        pw = jw.make_pod(f"p{i}").req(cpu_milli=int(rng.choice([500, 1000, 2500])), mem=512 * mi)
        if i % 3 == 0:
            pw.host_port(8080)
        pods.append(pw.obj())
    snap, _ = jschema.SnapshotBuilder().build(nodes, pods)
    prio = np.asarray(snap.pods.priority)
    p = prio.shape[0]
    order = np.argsort(-prio, kind="stable").astype(np.int32)
    k = 8
    cuts = sorted(rng.choice(np.arange(1, p), size=4, replace=False).tolist())
    chunks, start = [], 0
    for c in cuts + [p]:
        while c - start > k:
            chunks.append(order[start:start + k])
            start += k
        chunks.append(order[start:c])
        start = c
    chunks = [c for c in chunks if len(c)]
    members = np.full((max(8, 1 << (len(chunks) - 1).bit_length()), k), -1, dtype=np.int32)
    for wi, ch in enumerate(chunks):
        members[wi, :len(ch)] = ch
    return snap, members


def poisoned_case(share):
    """A 40-pod batch on 24 nodes in waves of 16, with `share` of the
    nodes' allocatable +inf (their scores NaN: the rows' NaN counts span
    the kk window)."""
    gi, mi = jw.GI, jw.MI
    rng = np.random.default_rng(int(share * 100))
    nodes = [jw.make_node(f"n{i}").capacity(cpu_milli=int(rng.choice([2000, 4000])),
                                            mem=8 * gi, pods=110).zone(f"z{i % 3}").obj()
             for i in range(24)]
    pods = [jw.make_pod(f"p{i}").req(cpu_milli=int(rng.choice([300, 900, 1700])),
                                     mem=256 * mi).obj() for i in range(40)]
    snap, _ = jschema.SnapshotBuilder().build(nodes, pods)
    order = np.argsort(-np.asarray(snap.pods.priority), kind="stable").astype(np.int32)
    members = np.full((4, 16), -1, dtype=np.int32)
    for wi in range(3):
        members[wi, :len(order[wi * 16:(wi + 1) * 16])] = order[wi * 16:(wi + 1) * 16]
    poisoned = rng.random(len(nodes)) < share
    return snap, members, poisoned


def wave_inputs(snap):
    tsnap = dv.to_device(dv.snapshot_from_numpy(snap), "cpu")
    features = tassign.features_of(tsnap)
    prep = tassign._solver_prep(tsnap, features)
    return features, prep


@pytest.mark.parametrize("g", [1, 3, 16])
@pytest.mark.parametrize("case", ["partition0", "partition1", "partition2", "poison_some",
                                  "poison_all"])
def test_emulated_wave_equals_plain(case, g):
    if case.startswith("partition"):
        snap, members = partition_case(int(case[-1]))
        poisoned = None
    else:
        snap, members, poisoned = poisoned_case(0.3 if case == "poison_some" else 1.0)
    features, prep = wave_inputs(snap)
    cluster, pods, sfeas, aff, taint, sp_args, tm_args, extra = prep
    if poisoned is not None:
        alloc = cluster.allocatable.clone()
        alloc[:poisoned.shape[0]][torch.as_tensor(poisoned)] = float("inf")
        cluster = cluster._replace(allocatable=alloc)
    n_groups = int(pods.group_id.max()) + 1
    m = torch.as_tensor(members)
    cfg = tscores.DEFAULT_SCORE_CONFIG
    want = tassign.wavefront_assign_plain(cluster, pods, sfeas, aff, taint, m, features,
                                          n_groups, cfg, sp_args, tm_args, extra)[:9]
    got = emulated_wavefront(cluster, pods, sfeas, aff, taint, m, features, n_groups, cfg, g,
                             sp_args, tm_args, extra)
    for k, (a, b) in enumerate(zip(got, want)):
        if a.is_floating_point():
            assert torch.equal(torch.isnan(a), torch.isnan(b)), k
            a, b = a[~torch.isnan(a)], b[~torch.isnan(b)]
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), k
        else:
            assert torch.equal(a, b), (k, a, b)
    if case.startswith("partition"):
        assert int(want[7]) >= 2
    else:
        assert bool(torch.isnan(torch.stack([w for w in (want[1],)])).any()) or int(
            (want[0] < 0).sum()) > 0
