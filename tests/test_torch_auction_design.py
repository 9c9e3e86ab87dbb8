"""The arithmetic of the auction program (csrc/auction_common.cuh), on the CPU.

The program runs only on the card (no nvcc, no card here), so its new
arithmetic is emulated in numpy step for step and held to the plain
versions and to the reference:

(e) the stable sort by bid (radix_sort): least-significant 8-bit digit
    first; in a pass each tile of blockDim positions ranks an item among
    the items of its digit in its warp (the lanes below it with the digit:
    __match_any_sync and a lanemask), a warp's digit counts give its first
    slot after the tile's warps before it, and the exclusive scan of the
    (digit, tile) counts in digit-major order gives each tile's first
    slot; each key's first sorted position is a run start of the sorted
    order.  Over the solve order (perm, firstpos) and over the pod index
    order (perm_idx), the sort equals numpy's stable argsort,
    torch.sort(stable=True) and the reference's jnp.argsort, and firstpos
    equals searchsorted-left: random bids with N (no bid), every pod on
    one node, P >> N, three passes at 65,536 nodes, a ragged last tile.
(f) j, a pod's position among the active pods of its class in solve
    order, as the class-key sort's position less its class's first: equal
    to the first design's count of earlier same-class pods and to the
    plain version's searchsorted.
(g) the class pass split over G blocks (32-node chunks dealt round robin):
    each block's best under ranks_above merged in any order, each block's
    tie histogram (10-bit buckets of the 30-bit keys) summed, each block's
    ties listed at its offset within each bucket (the lower-ranked blocks'
    counts) in any order, each listed tie placed by its rank within its
    bucket.  For G = 1..16 the top list equals one block's, lax.top_k's over
    the keys and the plain version's sort: NaN (no tie), +inf, every node
    tied, a padded tail, tie_k above and below the tie count.
(h) the loop emulated from (e)-(g) (the prefix in the program's split:
    level 0's 16-row blocks, the upper levels as prefix_sum, level 0's add
    on read; the commit per node group in perm_idx order; the repairs'
    plain versions, whose kernel bodies are unchanged) equals _rounds_plain
    and, in the port's auction_assign, the reference's auction_assign on
    testing/cases.py's mixed, contended, gang, capacity-edge, fractional,
    spread and inter-pod seeds.

And the program's launch arguments: bindings.AUCTION_INTS / AUCTION_PTRS
name the header's kI_* / kP_* enums in order, and bindings.STAGE its
kStage* flags.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import auction as jauction
from kubernetes_tpu.ops import schema as jschema
from kubernetes_tpu.ops import scores as jscores
from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu_torch.kernels import bindings
from kubernetes_tpu_torch.ops import auction as tauction
from kubernetes_tpu_torch.ops import device as dv
from kubernetes_tpu_torch.ops import scores as tscores
from kubernetes_tpu_torch.ops.filters import fits_resources, pod_view
from kubernetes_tpu_torch.ops.interpod import interpod_filter
from kubernetes_tpu_torch.ops.scores import combine_scores, resource_score_parts
from kubernetes_tpu_torch.ops.topology import spread_filter, spread_score
from kubernetes_tpu_torch.testing import cases

from test_torch_auction import CONFIGS, assert_results_equal

HEADER = Path(__file__).resolve().parent.parent / "kubernetes_tpu_torch/csrc/auction_common.cuh"
RADIX_BITS, WARP = 8, 32
KEY_BITS, BUCKET_BITS = 30, 10
GOLDEN, ROUND, MIX = 0x9E3779B9, 0x85EBCA6B, 0x27D4EB2F
U32 = 0xFFFFFFFF
BELOW = np.tril(np.ones((WARP, WARP), bool), -1)   # [lane, other]: other < lane


# ---- (e) the radix sort -------------------------------------------------------


def radix_sort(src, keys, key_max, tile):
    """csrc/auction_common.cuh radix_sort: the items of `src` stably sorted
    by keys[item] in [0, key_max], pass by pass as the kernel ranks them."""
    keys = np.asarray(keys, np.int64)
    cur = np.asarray(src, np.int64)
    p = cur.size
    tiles = -(-p // tile)
    passes = -(-max(int(key_max), 1).bit_length() // RADIX_BITS)
    for ps in range(passes):
        pad = np.full(tiles * tile, -1, np.int64)
        pad[:p] = cur
        d = np.where(pad >= 0, (keys[np.maximum(pad, 0)] >> (ps * RADIX_BITS)) & 255, 256)
        d = d.reshape(tiles, tile // WARP, WARP)
        inwarp = ((d[..., :, None] == d[..., None, :]) & BELOW).sum(-1)
        ti, wi, _li = np.indices(d.shape)
        wc = np.zeros((tiles, tile // WARP, 257), np.int64)
        np.add.at(wc, (ti.ravel(), wi.ravel(), d.ravel()), 1)
        wc = wc[..., :256]
        cnt = wc.sum(1)                                    # [tiles, digits]
        tot = cnt.sum(0)
        base = (np.cumsum(tot) - tot)[None, :] + np.cumsum(cnt, 0) - cnt
        first = base[:, None, :] + np.cumsum(wc, 1) - wc   # [tiles, warps, digits]
        ok = d < 256
        out = np.full(p, -1, np.int64)
        out[first[ti[ok], wi[ok], d[ok]] + inwarp[ok]] = pad.reshape(d.shape)[ok]
        assert (out >= 0).all()
        cur = out
    return cur


def first_positions(sorted_items, keys):
    """run_starts then a lookup: each sorted position's key's first
    position (firstpos, searchsorted-left)."""
    k = np.asarray(keys)[sorted_items]
    start = np.r_[True, k[1:] != k[:-1]]
    return np.maximum.accumulate(np.where(start, np.arange(k.size), 0))


def bid_case(case, rng):
    if case == "random":
        p, n = 1000, 300
        bids = rng.integers(0, n + 1, p)        # n: no bid
    elif case == "no_bids":
        p, n = 700, 64
        bids = np.where(rng.random(p) < 0.8, n, rng.integers(0, n, p))
    elif case == "one_node":
        p, n = 1024, 5000
        bids = np.full(p, 4321)
    elif case == "p_much_larger":
        p, n = 3000, 5
        bids = rng.integers(0, n + 1, p)
    elif case == "wide":
        p, n = 2048, 65536
        bids = rng.integers(0, n + 1, p)        # 17-bit keys: three passes
    else:  # "tail": P not a multiple of the tile, distinct bids
        p, n = 1537, 4096
        bids = rng.permutation(n)[:p]
    return p, n, bids.astype(np.int64)


@pytest.mark.parametrize("tile", [512, 1024])
@pytest.mark.parametrize("case", ["random", "no_bids", "one_node", "p_much_larger", "wide",
                                  "tail"])
def test_e_bid_sort_equals_stable_sorts(case, tile):
    rng = np.random.default_rng(len(case) * 7 + tile)
    p, n, bids = bid_case(case, rng)
    order = rng.permutation(p)
    perm = radix_sort(order, bids, n, tile)
    want = order[np.argsort(bids[order], kind="stable")]
    assert np.array_equal(perm, want)
    by_torch = torch.sort(torch.from_numpy(bids[order]), stable=True).indices.numpy()
    assert np.array_equal(perm, order[by_torch])
    by_ref = np.asarray(jnp.argsort(jnp.asarray(bids[order], jnp.int32), stable=True))
    assert np.array_equal(perm, order[by_ref])
    sb = bids[perm]
    assert np.array_equal(first_positions(perm, bids), np.searchsorted(sb, sb, side="left"))
    # the commit's order: (bid, pod index); its groups span perm's positions
    perm_idx = radix_sort(np.arange(p), bids, n, tile)
    assert np.array_equal(perm_idx, np.argsort(bids, kind="stable"))
    assert np.array_equal(bids[perm_idx], sb)


# ---- (f) j by the class-key sort ---------------------------------------------


@pytest.mark.parametrize("c_dim,tile", [(1, 512), (3, 1024), (64, 512), (300, 1024)])
def test_f_class_position_equals_the_count(c_dim, tile):
    rng = np.random.default_rng(c_dim)
    p = 1300
    cls = rng.integers(0, c_dim, p)
    active = rng.random(p) < 0.7
    order = rng.permutation(p)
    key = np.where(active, cls, c_dim)
    cperm = radix_sort(order, key, c_dim, tile)
    j = np.empty(p, np.int64)
    j[cperm] = np.arange(p) - first_positions(cperm, key)
    # the first design's pod_pass: active pods of the class earlier in
    # solve order
    pos = np.empty(p, np.int64)
    pos[order] = np.arange(p)
    same = (key[:, None] == key[None, :]) & (pos[None, :] < pos[:, None])
    assert np.array_equal(j[active], same.sum(1)[active])
    # the plain version's (auction_bids_plain)
    skey = key[order[np.argsort(key[order], kind="stable")]]
    plain = np.empty(p, np.int64)
    plain[order[np.argsort(key[order], kind="stable")]] = (
        np.arange(p) - np.searchsorted(skey, skey, side="left"))
    assert np.array_equal(j, plain)


# ---- (g) the class pass over G blocks -----------------------------------------


def class_rot(c, rnd):
    return (((((c * GOLDEN) & U32) ^ ((rnd * ROUND) & U32) ^ 1) * MIX) & U32)


def tie_key(rot, nd):
    return ((((np.asarray(nd, np.int64) + 1) * GOLDEN) & U32) ^ rot) >> 2


def ranks_above(s, i, best, idx):
    """solve_common.cuh ranks_above: NaN first, then larger, then lower index."""
    sn, bn = np.isnan(s), np.isnan(best)
    if sn != bn:
        return sn
    return i < idx if sn else (s > best or (s == best and i < idx))


def class_top_list(scores, feas, rot, tie_k, g, rng):
    """The class pass of csrc/auction_common.cuh over g blocks: (best, cnt,
    top list), every merge and listing in a random order."""
    n = scores.size
    owner = (np.arange(n) >> 5) % g
    parts = []
    for b in range(g):
        best, idx = -np.inf, 0x7FFFFFFF
        for nd in rng.permutation(np.nonzero((owner == b) & feas)[0]):
            if ranks_above(scores[nd], nd, best, idx):
                best, idx = scores[nd], nd
        parts.append((best, idx))
    best, idx = -np.inf, 0x7FFFFFFF
    for k in rng.permutation(g):
        if ranks_above(parts[k][0], parts[k][1], best, idx):
            best, idx = parts[k]
    found = bool(feas.any())
    mrow = np.where(feas, scores, -np.inf)
    tie = found & (mrow == best)
    keys = tie_key(rot, np.arange(n))
    bucket = keys >> (KEY_BITS - BUCKET_BITS)
    hist = np.zeros((g, 1 << BUCKET_BITS), np.int64)
    np.add.at(hist, (owner[tie], bucket[tie]), 1)
    tot = hist.sum(0)
    off = np.cumsum(hist, 0) - hist
    ties = int(tot.sum())
    cnt = min(ties, tie_k)
    if cnt == 0:
        return best, 0, np.zeros(0, np.int64)
    start = np.cumsum(tot[::-1])[::-1] - tot          # descending exclusive scan
    cand = next(int(start[b] + tot[b]) for b in range(tot.size)
                if start[b] < cnt <= start[b] + tot[b])
    slots = np.full(n, -1, np.int64)
    fill = off.copy()
    for b in rng.permutation(g):
        for nd in rng.permutation(np.nonzero(tie & (owner == b))[0]):
            bk = bucket[nd]
            if start[bk] < cnt:
                slots[start[bk] + fill[b, bk]] = nd
                fill[b, bk] += 1
    inv = np.full(cnt, -1, np.int64)
    for q in range(cand):
        nd = slots[q]
        bk = bucket[nd]
        lo, hi = start[bk], (start[bk - 1] if bk > 0 else ties)
        others = slots[lo:hi]
        rank = int(((keys[others] > keys[nd]) | ((keys[others] == keys[nd]) & (others < nd))).sum())
        if lo + rank < cnt:
            inv[lo + rank] = nd
    assert (inv >= 0).all()
    return best, cnt, inv


def score_row(case, rng):
    n = 3000 if case != "wide" else 20000
    scores = rng.integers(0, 12, n).astype(np.float32)
    feas = rng.random(n) < 0.8
    if case == "nan":
        scores[rng.integers(0, n, 3)] = np.nan
        feas[:] = True
    elif case == "inf":
        scores[rng.integers(0, n, 40)] = np.inf
    elif case == "all_tied":
        scores[:] = 7.0
        feas[:] = True
    elif case == "padded_tail":
        feas[n - 700:] = False             # the padded nodes: no feasible node
        scores[n - 700:] = 99.0
    elif case == "none":
        feas[:] = False
    return scores, feas


@pytest.mark.parametrize("case", ["random", "nan", "inf", "all_tied", "padded_tail", "none",
                                  "wide"])
def test_g_split_class_pass_equals_one_block_and_top_k(case):
    rng = np.random.default_rng(len(case))
    scores, feas = score_row(case, rng)
    n = scores.size
    rot = class_rot(3, 5)
    assert np.array_equal(tie_key(rot, np.arange(n)),
                          tauction.tie_keys(3, 5, n, 0, "cpu").numpy())
    for tie_k in (64, 4096):
        one = class_top_list(scores, feas, rot, tie_k, 1, rng)
        mrow = np.where(feas, scores, -np.inf)
        best = np.max(mrow) if feas.any() else -np.inf
        tie = feas & (mrow == best)
        key = np.where(tie, tie_key(rot, np.arange(n)), -1)
        cnt = min(int(tie.sum()), tie_k)
        assert one[1] == cnt and (np.isnan(one[0]) and np.isnan(best) or one[0] == best)
        if cnt:
            top = np.asarray(jax.lax.top_k(jnp.asarray(key, jnp.int32), cnt)[1])
            assert np.array_equal(one[2], top)
            plain = torch.sort(torch.from_numpy(key), descending=True, stable=True).indices
            assert np.array_equal(one[2], plain[:cnt].numpy())
        for g in range(2, 17):
            got = class_top_list(scores, feas, rot, tie_k, g, rng)
            assert got[1] == one[1] and np.array_equal(got[2], one[2])
            assert np.isnan(got[0]) == np.isnan(one[0])
            assert np.isnan(got[0]) or got[0] == one[0]


# ---- (h) the emulated loop -----------------------------------------------------


def program_shape(n):
    """cluster_common.cuh launch_shape: (blocks, threads)."""
    t = 512 if n <= 16 * 512 else 1024
    return max(2, min(16, -(-n // t))), t


def class_rows(cluster, pods, st, requested, nonzero, cfg, counts, bits):
    """Each joint class's (masked scores, feasible) rows, as the class
    pass's evaluation writes them (auction_bids_plain's per-class rows)."""
    features = st.features
    cl = cluster._replace(requested=requested, nonzero_requested=nonzero)
    sp = spread = spf_k = ipf_k = None
    if features.spread:
        spread = st.sp.table
        sp = st.sp.state._replace(counts_node=counts)
        spf_k = [spread_filter(sp, spread, rep) for rep in st.k_reps.tolist()]
    if features.interpod:
        ipf_k = interpod_filter(tauction._term_state(st, bits), st.tm.table, st.k_reps.long())
    spec = []
    for rep in st.s_reps.tolist():
        pod = pod_view(pods, rep)
        spec.append((fits_resources(cl, pod), *resource_score_parts(cl, pod, cfg)))
    jcons, reps = st.jcons.tolist(), st.reps.tolist()
    out = []
    for c, s in enumerate(st.jspec.tolist()):
        fits, fit, bal = spec[s]
        feas = st.sfeas_s[s] & fits
        if features.spread:
            feas = feas & spf_k[jcons[c]]
        if features.interpod:
            feas = feas & ipf_k[jcons[c]]
        sp_score = spread_score(sp, spread, reps[c], feas) if features.soft_spread else None
        scores = combine_scores(fit, bal, st.aff_s[s], st.taint_s[s], feas, cfg,
                                spread_score=sp_score,
                                extra=st.extra[c] if st.extra is not None else None)
        out.append((scores.numpy(), feas.numpy()))
    return out


def emulated_bids(cluster, pods, st, requested, nonzero, assigned, rnd, tie_k, cfg, counts,
                  bits, rng):
    n = cluster.allocatable.shape[0]
    p = pods.req.shape[0]
    c_dim = st.jspec.shape[0]
    g, tile = program_shape(n)
    cls = np.clip(pods.class_id.numpy(), 0, c_dim - 1)
    key = np.where((assigned.numpy() < 0) & pods.valid.numpy(), cls, c_dim)
    cperm = radix_sort(st.order.numpy(), key, c_dim, tile)
    j = np.empty(p, np.int64)
    j[cperm] = np.arange(p) - first_positions(cperm, key)
    rows = class_rows(cluster, pods, st, requested, nonzero, cfg, counts, bits)
    bid = np.full(p, n, np.int32)
    val = np.full(p, -np.inf, np.float32)
    for c in np.unique(key[key < c_dim]):
        scores, feas = rows[c]
        best, cnt, inv = class_top_list(scores, feas, class_rot(int(c), rnd), tie_k, g, rng)
        if not best > -np.inf or cnt == 0:
            continue
        mine = key == c
        bid[mine] = inv[j[mine] % max(cnt, 1)]
        val[mine] = best
    return torch.from_numpy(bid), torch.from_numpy(val)


def program_prefix(sreq):
    """The acceptance prefix as the program adds it: each 16-row block of
    level 0 in sequence, the block totals' prefix as prefix_sum (the upper
    levels on block 0), and each row's block's exclusive total added on
    read."""
    p = sreq.shape[0]
    nb = -(-p // 16)
    pad = np.zeros((nb * 16, sreq.shape[1]), np.float32)
    pad[:p] = sreq
    l0 = np.cumsum(pad.reshape(nb, 16, -1), axis=1, dtype=np.float32)
    out = l0.copy()
    if nb > 1:
        upper = tauction.prefix_sum(torch.from_numpy(l0[:, -1].copy())).numpy()
        out[1:] = (l0[1:] + upper[:-1, None, :]).astype(np.float32)
    return out.reshape(nb * 16, -1)[:p]


def emulated_accept(allocatable, pods, order, bid, requested, tile):
    n = allocatable.shape[0]
    bid = bid.numpy().astype(np.int64)
    perm = radix_sort(order.numpy(), bid, n, tile)
    f = first_positions(perm, bid)
    req = pods.req.numpy()
    sreq = req[perm]
    pre = program_prefix(sreq)
    assert np.array_equal(pre, tauction.prefix_sum(torch.from_numpy(sreq)).numpy())
    within = ((pre - pre[f]).astype(np.float32) + sreq[f]).astype(np.float32)
    b = np.minimum(bid[perm], n - 1)
    remaining = (allocatable.numpy() - requested.numpy()).astype(np.float32)[b]
    ok = ((sreq <= 0) | (within <= remaining)).all(axis=1) & (bid[perm] < n)
    accept = np.zeros(bid.size, bool)
    accept[perm] = ok
    return torch.from_numpy(accept)


def emulated_commit(pods, accept, bid, val, requested, nonzero, assigned, bid_scores, tile):
    """The program's commit: each node group's first position walks its
    group in perm_idx order (pod index order), adding the accepted pods'
    requests one at a time."""
    n = requested.shape[0]
    b_np = bid.numpy().astype(np.int64)
    perm_idx = radix_sort(np.arange(b_np.size), b_np, n, tile)
    rq, nz = requested.numpy().copy(), nonzero.numpy().copy()
    req, nzr, acc = pods.req.numpy(), pods.nonzero_req.numpy(), accept.numpy()
    for i in perm_idx:
        if b_np[i] < n and acc[i]:
            rq[b_np[i]] = rq[b_np[i]] + req[i]
            nz[b_np[i]] = nz[b_np[i]] + nzr[i]
    return (torch.where(accept, bid, assigned), torch.where(accept, val, bid_scores),
            torch.from_numpy(rq), torch.from_numpy(nz))


def emulated_rounds(cluster, pods, st, tie_k, cfg, max_rounds):
    """_rounds_plain with the program's arithmetic in place of the plain
    bids, acceptance and commit."""
    rng = np.random.default_rng(0)
    p = pods.req.shape[0]
    _g, tile = program_shape(cluster.allocatable.shape[0])
    assigned = torch.full((p,), -1, dtype=torch.int32)
    bid_scores = torch.full((p,), float("-inf"))
    requested, nonzero = cluster.requested, cluster.nonzero_requested
    counts = st.sp.state.counts_node.clone() if st.features.spread else None
    bits = tauction.term_bits_copy(st.tm, st.features)
    rnd, progress = 0, True
    while rnd < max_rounds and progress and bool(((assigned < 0) & pods.valid).any()):
        bid, val = emulated_bids(cluster, pods, st, requested, nonzero, assigned, rnd, tie_k,
                                 cfg, counts, bits, rng)
        accept = emulated_accept(cluster.allocatable, pods, st.order, bid, requested, tile)
        progress = bool(accept.any())
        if st.features.spread:
            accept, counts = tauction.spread_repair_plain(accept, bid, counts, st,
                                                          cluster.topo_ids)
        if st.features.interpod:
            accept, bits = tauction.interpod_repair_plain(accept, bid, st, cluster.topo_ids, bits)
        assigned, bid_scores, requested, nonzero = emulated_commit(
            pods, accept, bid, val, requested, nonzero, assigned, bid_scores, tile)
        rnd += 1
    return (assigned, bid_scores, requested, nonzero, torch.tensor(rnd, dtype=torch.int32),
            counts, *(bits if st.features.interpod else (None, None, None)))


def _no_ports(objs):
    nodes, pods, bound = objs
    for pod in pods:
        pod.spec.containers[0].ports = []
    return nodes, pods, bound


LOOP_CASES = {
    "mixed": lambda: _no_ports(cases.mixed_objects(jw, 0)),
    "contended": lambda: cases.contended_objects(jw, 32, 256, 16),
    "gang": lambda: cases.gang_objects(jw),
    "capacity_edge": lambda: cases.capacity_edge_objects(jw, 48, 1000, 7, 1),
    "fractional": lambda: cases.fractional_mix_objects(jw, 0),
    "spread": lambda: cases.spread_objects(jw, 0),
    "interpod": lambda: cases.interpod_objects(jw, 0, anti_only=True),
}


@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_h_emulated_loop_equals_plain_and_reference(case, monkeypatch):
    nodes, pods, bound = LOOP_CASES[case]()
    snap, _ = jschema.SnapshotBuilder().build(nodes, pods, bound_pods=bound)
    n_groups = jschema.num_groups(snap)
    tie_k = jauction.default_tie_k(snap)
    tsnap = dv.to_device(dv.snapshot_from_numpy(snap), "cpu")
    cfg = tscores.ScoreConfig(**CONFIGS["least"])
    cluster, tpods, st = tauction.auction_prep(tsnap, cfg=cfg)
    got = emulated_rounds(cluster, tpods, st, tie_k, cfg, 64)
    want = tauction._rounds_plain(cluster, tpods, st, tie_k, cfg, 64)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
    # the whole solve with the emulated loop against the reference
    monkeypatch.setattr(tauction, "auction_rounds", emulated_rounds)
    ref = jauction.auction_assign_jit(jscores.ScoreConfig(**CONFIGS["least"]))(
        snap, n_groups=n_groups, tie_k=tie_k)
    port = tauction.auction_assign(tsnap, cfg, n_groups=n_groups, tie_k=tie_k)
    assert_results_equal(ref, port)


# ---- the launch arguments ------------------------------------------------------


@pytest.mark.parametrize("enum,names", [("kI_", bindings.AUCTION_INTS),
                                        ("kP_", bindings.AUCTION_PTRS)])
def test_launch_arrays_follow_the_header(enum, names):
    src = HEADER.read_text()
    body = re.search(r"enum \{\s*(" + enum + r"N\b|" + enum + r"ALLOC\b)(.*?)\};", src, re.S)
    assert body, enum
    entries = [e.strip() for e in (body.group(1) + body.group(2)).replace("\n", " ").split(",")]
    entries = [e for e in entries if e]
    assert entries[-1] == f"{enum}COUNT"
    assert [e[len(enum):].lower() for e in entries[:-1]] == list(names)


@pytest.mark.parametrize("stage", sorted(bindings.STAGE))
def test_stage_flags_follow_the_header(stage):
    """bindings.STAGE, the flags AuctionRun passes to auction_loop's one
    entry point, equals the header's kStage* enum."""
    body = re.search(r"enum \{\s*(kStageAccept.*?)\};", HEADER.read_text(), re.S)
    assert body
    flags = dict((k.strip(), int(v)) for k, v in
                 (e.split("=") for e in body.group(1).replace("\n", " ").split(",") if e.strip()))
    assert flags[f"kStage{stage.capitalize()}"] == bindings.STAGE[stage]
