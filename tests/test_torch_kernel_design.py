"""The arithmetic of the redesigned greedy_scan and auction_spread, on the CPU.

Neither kernel runs here (no card, no nvcc), so their two new designs are
emulated in numpy step for step and held to the plain versions and to the
reference:

(a) auction_spread's rank stage (csrc/auction_spread.cu rank_rows): a
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
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import auction as jauction
from kubernetes_tpu.ops import schema as jschema
from kubernetes_tpu.ops import scores as jscores
from kubernetes_tpu_torch.ops import auction as tauction
from kubernetes_tpu_torch.ops import scores as tscores

from test_torch_spread_solves import CONFIGS, assert_fields, build_case, encode

WARPS = 32          # auction_spread.cu: 1,024 threads
SHARED_Z = 256      # auction_spread.cu kShZ (bindings.SPREAD_SHARED_Z)
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
