"""The auction program's reasons stage (csrc/auction_common.cuh
round_reasons), on the CPU.

The stage runs only on the card, so its design is emulated in numpy on a
cluster of G blocks of T threads (16 x 512 and 3 x 32): the joint classes
in groups of 32, each group's distinct spec and constraint classes found
as the warp's __match_any_sync leaders, each distinct constraint class's
hard spread rows with their minima taken per block over the block's
32-node chunks (dealt round robin) and merged by fminf in block order (one
cluster barrier a group), then one pass over the nodes: a thread's node
ORs the group's class masks of each spec class whose static row holds
(static) and whose requests fit (resources), and of each constraint class
whose hard spread rows and then inter-pod filter pass where some class
fits (the spread and inter-pod words are those masks ANDed with the fit);
the four words OR-ed over a thread's nodes, its warp and its block, each
in a shuffled order, the blocks' words merged after one cluster barrier;
class_reason's code; each pod its class's code or REASON_NONE.  It equals
failure_reasons_plain on the final state of the plain loop, and with the
gang post-pass the reference's auction_assign reasons field (and the
port's), with the cluster barriers counted: one a group with the spread
family and one for the flags, whatever the number of joint classes.  The
batches reach every code: REASON_STATIC, REASON_RESOURCES (a pod no node
fits, and pods parked on contention after max_rounds with feasible nodes
left), REASON_SPREAD, REASON_INTERPOD, REASON_GANG, and padded pods (valid
false) with their class's code; one batch has 39 joint classes over 16
spec and 8 constraint classes (two groups), with spread and inter-pod
rows.  Tolerance 0.
"""

import functools

import numpy as np
import pytest
import torch

from kubernetes_tpu.api import types as japi
from kubernetes_tpu.ops import auction as jauction
from kubernetes_tpu.ops import schema as jschema
from kubernetes_tpu.ops import scores as jscores
from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu_torch.ops import auction as tauction
from kubernetes_tpu_torch.ops import device as dv
from kubernetes_tpu_torch.ops import scores as tscores
from kubernetes_tpu_torch.ops.assign import (
    REASON_GANG,
    REASON_INTERPOD,
    REASON_NONE,
    REASON_RESOURCES,
    REASON_SPREAD,
    REASON_STATIC,
)
from kubernetes_tpu_torch.ops.filters import fits_resources, pod_view
from kubernetes_tpu_torch.ops.interpod import interpod_filter
from kubernetes_tpu_torch.testing.cases import interpod_objects, spread_objects

from test_torch_auction import assert_results_equal

GI = jw.GI


def reason_of(flags: int) -> int:
    """class_reason's code of a class's stage flags (bit 0 static, 1
    resources, 3 spread, 5 inter-pod): round_reasons' reason_of."""
    if flags & 32:
        return REASON_RESOURCES      # feasible yet unplaced: contention
    if not flags & 1:
        return REASON_STATIC
    if not flags & 2:
        return REASON_RESOURCES
    if not flags & 8:
        return REASON_SPREAD
    return REASON_INTERPOD


GROUP = 32       # auction_common.cuh kReasonGroup
BATCH = 2048     # joint classes merged in one exchange: kReasonWords / 4 * kReasonGroup
BIG = np.float32(1e9)   # kBig


def leaders(values):
    """The warp's __match_any_sync leaders over `values` (one a lane): the
    distinct values in lane order and each one's mask of lanes."""
    slots, masks = [], []
    for lane, v in enumerate(values):
        if v in slots:
            masks[slots.index(v)] |= 1 << lane
        else:
            slots.append(v)
            masks.append(1 << lane)
    return slots, masks


def block_or(words, owner, blocks: int, threads: int, rng) -> np.ndarray:
    """Each block's OR of per-node words: a thread's nodes, then its warp's
    lanes, then the block's warps in a shuffled order.  `owner`: each
    node's (block, thread)."""
    per_thread = np.zeros((blocks, threads), np.uint32)
    np.bitwise_or.at(per_thread, owner, words)
    warps = np.bitwise_or.reduce(per_thread.reshape(blocks, threads // 32, 32), axis=2)
    out = np.zeros(blocks, np.uint32)
    for b in range(blocks):
        for w in rng.permutation(threads // 32):
            out[b] |= warps[b, w]
    return out


def spread_rows_ok(st, counts, k_rep: int, owner_block, blocks: int) -> tuple:
    """A constraint class's hard spread rows at every node (pod_spread_rows,
    then spread_ok), each row's minimum the fminf in block order of the
    blocks' minima over their eligible nodes (kBig without one), then
    spread_min_final.  Returns (any hard row, bool[N])."""
    table, state = st.sp.table, st.sp.state
    counts = counts.numpy()
    eligible, v = state.eligible.numpy(), state.v.numpy()
    sizes = state.sizes.numpy()
    ok = np.ones(counts.shape[1], bool)
    any_hard = False
    for cidx in table.pod_idx[k_rep].tolist():
        c = min(max(cidx, 0), counts.shape[0] - 1)
        if cidx < 0 or not bool(table.hard[c]):
            continue
        any_hard = True
        m = BIG
        for b in range(blocks):
            own = (owner_block == b) & eligible[c]
            m = np.fmin(m, counts[c][own].min() if own.any() else BIG)
        md = np.float32(table.min_domains[c])
        if m >= BIG or (md > 0 and sizes[c] < md):
            m = np.float32(0.0)
        self_m = np.float32(1.0 if bool(table.pod_matches[k_rep, c]) else 0.0)
        skew = (counts[c] + self_m).astype(np.float32) - m
        ok &= (skew <= np.float32(table.max_skew[c])) & (v[c] >= 0)
    return any_hard, ok


def emulate_reasons(cluster, pods, st, final, shape, rng, batch: int = BATCH):
    """The reasons stage over a cluster of shape = (blocks, threads) on the
    loop's final state (_rounds_plain's tuple).  Returns (reasons i32[P],
    each class's flags, the cluster barriers the stage makes)."""
    blocks, threads = shape
    assigned, _bs, requested, nonzero, _r, counts, *bits = final
    n = cluster.allocatable.shape[0]
    c_dim, cs_dim, cc_dim = st.jspec.shape[0], st.s_reps.shape[0], st.k_reps.shape[0]
    # node nd: the thread (rank + G * warp) * 32 + lane = nd mod (G T) of block rank
    local = np.arange(n) % (blocks * threads)
    chunk = local >> 5
    owner = (chunk % blocks, (chunk // blocks) * 32 + (local & 31))
    cl = cluster._replace(requested=requested, nonzero_requested=nonzero)
    sfeas = st.sfeas_s.numpy()
    jspec = np.clip(st.jspec.numpy(), 0, cs_dim - 1)
    jcons = np.clip(st.jcons.numpy(), 0, cc_dim - 1)
    k_reps = st.k_reps.long()
    ipf = None
    if st.features.interpod:
        tm = st.tm.state._replace(present_bits=bits[0], blocked_bits=bits[1],
                                  global_any=bits[2])
        ipf = interpod_filter(tm, st.tm.table, k_reps).numpy()
    fits = {}
    flags_c = np.zeros(c_dim, np.int64)
    barriers = 0
    for base in range(0, c_dim, batch):
        end = min(c_dim, base + batch)
        if base > 0:
            barriers += 1               # the last batch's words pulled by every block
        words = []                      # each group's four words, a row a block
        for c0 in range(base, end, GROUP):
            spec_of, spec_mask = leaders(jspec[c0:min(end, c0 + GROUP)].tolist())
            cons_of, cons_mask = leaders(jcons[c0:min(end, c0 + GROUP)].tolist())
            hard = []
            if st.features.spread:
                hard = [spread_rows_ok(st, counts, int(st.k_reps[k]), owner[0], blocks)
                        for k in cons_of]
                barriers += 1           # the group's minima, one pull
            stat = np.zeros(n, np.uint32)
            fit = np.zeros(n, np.uint32)
            for s, m in zip(spec_of, spec_mask):
                if s not in fits:
                    fits[s] = fits_resources(cl, pod_view(pods, int(st.s_reps[s]))).numpy()
                stat |= np.where(sfeas[s], np.uint32(m), np.uint32(0))
                fit |= np.where(sfeas[s] & fits[s], np.uint32(m), np.uint32(0))
            spread = np.zeros(n, np.uint32)
            inter = np.zeros(n, np.uint32)
            for v, (k, m) in enumerate(zip(cons_of, cons_mask)):
                ok = (fit & np.uint32(m)) != 0
                if hard and hard[v][0]:
                    ok &= hard[v][1]
                spread |= np.where(ok, np.uint32(m), np.uint32(0))
                if ipf is not None:
                    ok &= ipf[k]
                inter |= np.where(ok, np.uint32(m), np.uint32(0))
            words.append([block_or(w, owner, blocks, threads, rng)
                          for w in (stat, fit, fit & spread, fit & inter)])
        barriers += 1                   # the flags, one pull
        for g, group in enumerate(words):
            merged = [np.uint32(0)] * 4
            for b in rng.permutation(blocks):          # the pull, in any order
                merged = [x | w[b] for x, w in zip(merged, group)]
            for c in range(base + g * GROUP, min(end, base + (g + 1) * GROUP)):
                bit = c % GROUP
                flags_c[c] = sum(int((merged[f] >> bit) & 1) << sh
                                 for f, sh in enumerate((0, 1, 3, 5)))
    reason_c = np.asarray([reason_of(int(f)) for f in flags_c])
    cls = np.clip(pods.class_id.numpy(), 0, c_dim - 1)
    out = np.where(assigned.numpy() >= 0, REASON_NONE, reason_c[cls])
    return out.astype(np.int32), flags_c.tolist(), barriers


def every_code_objects():
    """One batch whose pods end with every reason: placeable pods, a
    selector no node has (static), a request no node fits (resources), a
    spread pod whose only fitting nodes break maxSkew (spread), an
    anti-affinity pod with a matching pod on every node (inter-pod), and a
    gang of three of which two fit (gang; the third resources); nine pods,
    so the pod axis pads.  Seventy nodes, so the families' nodes lie in
    several 32-node chunks."""
    nodes = []
    for i in range(70):
        zone = "z0" if i % 2 == 0 else "z1"
        cpu = 4000 if zone == "z0" else 2000
        nodes.append(jw.make_node(f"n{i}").capacity(cpu_milli=cpu, mem=16 * GI, pods=20)
                     .zone(zone).obj())
    bound = [jw.make_pod(f"s-bound{i}").label("app", "s").req(cpu_milli=10)
             .node_name(f"n{2 * i}").obj() for i in range(3)]
    bound += [jw.make_pod(f"x{i}").label("app", "x").req(cpu_milli=10).node_name(f"n{i}").obj()
              for i in range(70)]
    pods = [
        jw.make_pod("ok").req(cpu_milli=100).obj(),
        jw.make_pod("ok2").req(cpu_milli=200).obj(),
        jw.make_pod("static").req(cpu_milli=100).node_selector(disk="ssd").obj(),
        jw.make_pod("big").req(cpu_milli=9000).obj(),
        # fits only the 4-CPU z0 nodes, which hold the constraint's 3
        # matching pods against 0 in z1: 3 + 1 - 0 > maxSkew 1 there
        jw.make_pod("spread").label("app", "s").req(cpu_milli=3000)
        .spread(1, japi.LABEL_ZONE, "DoNotSchedule", {"app": "s"}).obj(),
        jw.make_pod("anti").label("app", "i").req(cpu_milli=100)
        .pod_anti_affinity({"app": "x"}, japi.LABEL_HOSTNAME).obj(),
    ]
    # the gang: each member pinned to one node; two fit theirs, the third
    # asks more than its 2-CPU node has
    for i, (host, cpu) in enumerate((("n69", 1500), ("n67", 1500), ("n1", 2500))):
        pods.append(jw.make_pod(f"g{i}").req(cpu_milli=cpu).group("g", 3)
                    .node_selector_kv(japi.LABEL_HOSTNAME, host).obj())
    return nodes, pods, bound


def many_classes_objects():
    """every_code_objects' cluster with 32 pods over 8 requests x 4
    constraint signatures (none; a satisfiable zone spread; anti-affinity
    against the app=x pod on every node: REASON_INTERPOD; a satisfiable
    anti term), plus its static, resource, spread and gang pods: 39 joint
    classes (64 padded: two groups of 32) over 16 spec and 8 constraint
    classes, spread and inter-pod rows both on, every code reached."""
    nodes, _pods, bound = every_code_objects()
    pods = []
    for k, cpu in enumerate(range(100, 900, 100)):
        pods += [
            jw.make_pod(f"free{k}").req(cpu_milli=cpu).obj(),
            jw.make_pod(f"t{k}").label("app", "t").req(cpu_milli=cpu)
            .spread(5, japi.LABEL_ZONE, "DoNotSchedule", {"app": "t"}).obj(),
            jw.make_pod(f"ax{k}").label("app", "i").req(cpu_milli=cpu)
            .pod_anti_affinity({"app": "x"}, japi.LABEL_HOSTNAME).obj(),
            jw.make_pod(f"ay{k}").label("app", "j").req(cpu_milli=cpu)
            .pod_anti_affinity({"app": "y"}, japi.LABEL_HOSTNAME).obj(),
        ]
    pods += [p for p in _pods if p.meta.name in ("static", "big", "spread")
             or p.meta.name.startswith("g")]
    return nodes, pods, bound


def contention_objects():
    """Six identical pods of 400m onto two 1-CPU nodes with tie_k 1 and one
    round: the class's top list holds one node, so all six bid it, two are
    accepted, and four stay unplaced with the other node still feasible."""
    nodes = [jw.make_node(f"c{i}").capacity(cpu_milli=1000, mem=8 * GI, pods=10).obj()
             for i in range(2)]
    pods = [jw.make_pod(f"p{i}").req(cpu_milli=400).obj() for i in range(6)]
    return nodes, pods, []


CASES = {
    "every_code": (every_code_objects, {}),
    "many_classes": (many_classes_objects, {}),
    "contention": (contention_objects, {"tie_k": 1, "max_rounds": 1}),
    "spread_seed1": (lambda: spread_objects(jw, 1, n_nodes=80, n_pods=40), {}),
    "interpod_seed2": (lambda: interpod_objects(jw, 2, n_nodes=80, n_pods=40, anti_only=True),
                       {}),
}


@functools.lru_cache(maxsize=None)
def solve(case):
    build, kw = CASES[case]
    nodes, pods, bound = build()
    snap, _ = jschema.SnapshotBuilder().build(nodes, pods, bound_pods=bound)
    n_groups = jschema.num_groups(snap)
    tie_k = kw.get("tie_k", jauction.default_tie_k(snap))
    max_rounds = kw.get("max_rounds", 64)
    want = jauction.auction_assign_jit(jscores.ScoreConfig(), max_rounds=max_rounds)(
        snap, n_groups=n_groups, tie_k=tie_k)
    tsnap = dv.to_device(dv.snapshot_from_numpy(snap), "cpu")
    cfg = tscores.ScoreConfig()
    got = tauction.auction_assign(tsnap, cfg, n_groups=n_groups, tie_k=tie_k,
                                  max_rounds=max_rounds)
    assert_results_equal(want, got)
    cluster, tpods, st = tauction.auction_prep(tsnap, cfg=cfg)
    final = tauction._rounds_plain(cluster, tpods, st, tie_k, cfg, max_rounds)
    return tpods, cluster, st, final, want, got


SHAPES = ((16, 512), (3, 32))


@pytest.mark.parametrize("case", sorted(CASES))
def test_reasons_stage_equals_plain_and_reference(case):
    pods, cluster, st, final, want, got = solve(case)
    term_bits = tuple(final[6:]) if st.features.interpod else None
    plain = tauction.failure_reasons_plain(cluster, pods, st, final[0], final[2], final[3],
                                           final[5], term_bits)
    # the wrapper's CPU path is the plain version
    assert torch.equal(tauction.failure_reasons(cluster, pods, st, final[0], final[2],
                                                final[3], final[5], term_bits), plain)
    gang = np.asarray(want.gang_dropped)
    c_dim = st.jspec.shape[0]
    groups = -(-c_dim // GROUP)
    for k, shape in enumerate(SHAPES):
        emulated, _flags, barriers = emulate_reasons(cluster, pods, st, final, shape,
                                                     np.random.default_rng(k))
        assert np.array_equal(emulated, plain.numpy()), shape
        # the gang post-pass after the stage, as in both packages
        assert np.array_equal(np.where(gang, REASON_GANG, emulated), np.asarray(want.reasons))
        # a fixed number of cluster barriers: one a group with the spread
        # family (its minima), one for the flags — not one a joint class
        assert barriers == (groups if st.features.spread else 0) + 1
    # the batches of 2,048 classes the kernel merges at once, at 32 a batch
    emulated, _flags, barriers = emulate_reasons(cluster, pods, st, final, SHAPES[1],
                                                 np.random.default_rng(2), batch=GROUP)
    assert np.array_equal(emulated, plain.numpy())
    assert barriers == (groups if st.features.spread else 0) + 2 * groups - 1
    assert np.array_equal(got.reasons.numpy(), np.asarray(want.reasons))


def test_every_code_is_reached():
    """The batches above name every code, the many-classes batch alone too;
    padded pods take their class's."""
    seen = set()
    padded = 0
    for case in ("every_code", "contention", "many_classes"):
        pods, cluster, st, final, want, _got = solve(case)
        reasons = np.asarray(want.reasons)
        valid = pods.valid.numpy()
        seen |= set(reasons[valid].tolist())
        _emul, flags, _b = emulate_reasons(cluster, pods, st, final, SHAPES[0],
                                           np.random.default_rng(0))
        cls = np.clip(pods.class_id.numpy(), 0, len(flags) - 1)
        if case == "contention":
            # parked with a feasible node left: the contention branch
            unplaced = valid & (final[0].numpy() < 0)
            assert unplaced.sum() == 4
            assert all(flags[c] & 32 for c in cls[unplaced])
        if case == "many_classes":
            # two groups of joint classes over several constraint classes,
            # both families on, every code in the one batch
            assert st.features.spread and st.features.interpod
            assert st.jspec.shape[0] > GROUP and len(set(cls[valid].tolist())) > GROUP
            assert st.k_reps.shape[0] >= 4
            assert {REASON_NONE, REASON_STATIC, REASON_RESOURCES, REASON_SPREAD,
                    REASON_INTERPOD, REASON_GANG} <= set(reasons[valid].tolist())
        assert not valid.all()
        padded += int((~valid).sum())
        assert np.array_equal(reasons[~valid], np.asarray(
            [reason_of(flags[c]) for c in cls[~valid]], np.int32))
    assert {REASON_NONE, REASON_STATIC, REASON_RESOURCES, REASON_SPREAD, REASON_INTERPOD,
            REASON_GANG} <= seen
    assert padded > 0
