"""The gang burst through the port, on the CPU, against the reference.

The auction's gang post-pass (the reference's `incomplete`, `gang_dropped`
and masked release, kubernetes_tpu/ops/auction.py:825-843) is a stage of
kernel auction_loop on the card and `gang_post_pass_plain` here; the
anti-affinity repair's dense tables are written in the launch from the
term table's bits on the card and are `repair_tables`' rows here.  Held exactly against the JAX package:

- auction_assign on seeded gang batches with incomplete gangs and on
  fractional_gang_objects (usage past float32's exact range), every field;
- TorchBatchScheduler(mode="auto") against TPUBatchScheduler(mode="auto")
  on a reduced bench.py c5 (its generator: 1,000 pods in 20 gangs onto
  2,000 of its 32-CPU nodes), and the gang admission retry on the auction
  route under scarcity;
- a numpy emulation of the stage's design on a cluster of 16 x 512 and
  3 x 32 threads (the flags; each block's drops over its pod range and its
  count, the counts' exchange; with no drop nothing more; up to 8,192
  dropped pods their keys (node << bits(P)) | pod compacted in pod index
  order into one block and bitonic-sorted there; past that the dropped
  pods compacted and stably sorted by node over the cluster; then one walk
  a (node run, resource) in pod index order) against gang_post_pass_plain
  and the reference's scatter-add, with no drop, a few, more than 8,192
  (c5's scarcity solve on 200 nodes among them), and fractional usage past
  float32's exact range on nodes that hold several dropped pods;
- the launch's bit reads of terms.matches_incoming / terms.anti_idx against
  repair_tables and the reference's dense tables, T = 31, 32, 33, 65.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.models.batch_scheduler import TPUBatchScheduler
from kubernetes_tpu.ops import auction as jauction
from kubernetes_tpu.ops import interpod as jinterpod
from kubernetes_tpu.ops import schema as jschema
from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu_torch.models.batch_scheduler import TorchBatchScheduler
from kubernetes_tpu_torch.ops import assign as tassign
from kubernetes_tpu_torch.ops import auction as tauction
from kubernetes_tpu_torch.ops import device as dv
from kubernetes_tpu_torch.testing import wrappers as tw
from kubernetes_tpu_torch.testing.cases import FRACTIONAL_MEM, fractional_gang_objects


def seeded_gangs(w, seed: int):
    """Gangs of 2-6 members (cpu 300-1500m, memory not whole MiB) and loose
    pods on 6-9 nodes, priorities 0-2, from numpy's seeded generator; two
    gangs hold a member that fits no node, so the post-pass releases them."""
    rng = np.random.default_rng(seed)
    nodes = [w.make_node(f"n{i}").capacity(cpu_milli=int(rng.choice([4000, 6000, 8000])),
                                           mem=16 * w.GI, pods=110).zone(f"z{i % 3}").obj()
             for i in range(int(rng.integers(6, 10)))]
    pods = []
    n_gangs = int(rng.integers(4, 8))
    for g in range(n_gangs):
        for m in range(int(rng.integers(2, 7))):
            pods.append(w.make_pod(f"g{g}-{m}")
                        .req(cpu_milli=int(rng.choice([300, 700, 1500])),
                             mem=int(rng.integers(1, 4)) * FRACTIONAL_MEM)
                        .group(f"gang-{g}").priority(int(rng.integers(0, 3))).obj())
    for g in rng.choice(n_gangs, 2, replace=False):
        pods.append(w.make_pod(f"g{g}-huge").req(cpu_milli=64000).group(f"gang-{g}").obj())
    for i in range(int(rng.integers(3, 9))):
        pods.append(w.make_pod(f"loose-{i}").req(cpu_milli=500, mem=FRACTIONAL_MEM).obj())
    rng.shuffle(pods)
    return nodes, pods


def c5_nodes(w, n: int, zones: int = 10):
    """bench.py _mk_nodes: 32 CPU / 64Gi / 110 pods, `zones` zones."""
    return [w.make_node(f"node-{i}").capacity(cpu_milli=32000, mem=64 * w.GI, pods=110)
            .zone(f"zone-{i % zones}").obj() for i in range(n)]


def c5_pods(w, tag: str, n: int, gangs: int):
    """bench.py config5's generator (default_rng(5)), `n` pods in `gangs`
    gangs."""
    rng = np.random.default_rng(5)
    return [w.make_pod(f"c5-{tag}-{i}")
            .req(cpu_milli=int(rng.choice([100, 250, 500, 1000, 2000])),
                 mem=int(rng.choice([128, 256, 512, 1024, 2048])) * w.MI)
            .group(f"gang-{i % gangs}").obj()
            for i in range(n)]


def assert_auction_equal(want, got):
    for f in ("assignment", "scores", "reasons", "gang_dropped"):
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert int(want.rounds) == int(got.rounds)
    for f in ("requested", "nonzero_requested"):
        a, b = np.asarray(getattr(want.cluster, f)), getattr(got.cluster, f).numpy()
        assert np.array_equal(a, b), f


@pytest.mark.parametrize("case", ["seed0", "seed1", "seed2", "seed3", "fractional"])
def test_gang_auction_matches_reference(case):
    """auction_assign on gang batches: every field equal to the reference's
    jitted auction_assign; some gang is released, and on the fractional
    batch the nodes' usage is past float32's exact range."""
    if case == "fractional":
        nodes, pods, _ = fractional_gang_objects(jw, 1)
    else:
        nodes, pods = seeded_gangs(jw, int(case[4:]))
    snap, _ = jschema.SnapshotBuilder().build(nodes, pods)
    n_groups = jschema.num_groups(snap)
    tie_k = jauction.default_tie_k(snap)
    want = jauction.auction_assign_jit()(snap, n_groups=n_groups, tie_k=tie_k)
    got = tauction.auction_assign(dv.to_device(dv.snapshot_from_numpy(snap), "cpu"),
                                  n_groups=n_groups, tie_k=tie_k)
    assert_auction_equal(want, got)
    dropped = got.gang_dropped.numpy()
    assert dropped.any()
    assert (got.reasons.numpy()[dropped] == tassign.REASON_GANG).all()
    if case == "fractional":
        # requests are multiples of 2^-12 MiB: float32 sums them exactly
        # only below 4,096 MiB (testing/cases.py FRACTIONAL_MEM)
        assert float(np.asarray(want.cluster.requested).max()) > 4096


def _schedulers(n_nodes):
    js, ts = TPUBatchScheduler(mode="auto"), TorchBatchScheduler(mode="auto", device="cpu")
    for a, b in zip(c5_nodes(jw, n_nodes), c5_nodes(tw, n_nodes)):
        js.add_node(a)
        ts.add_node(b)
    return js, ts


def _complete_gangs(pods, names) -> int:
    groups = {}
    for p, n in zip(pods, names):
        groups.setdefault(p.spec.scheduling_group, []).append(n)
    return sum(all(n is not None for n in v) for v in groups.values())


def test_reduced_c5_matches_reference():
    """bench.py c5 cut to 2,000 nodes and 1,000 pods in 20 gangs: routed to
    the auction by both packages, every gang placed whole, names and every
    last_result field equal."""
    js, ts = _schedulers(2000)
    tp = c5_pods(tw, "run0", 1000, 20)
    _, meta = ts.encode_pending(tp)
    assert meta.route == "auction" and meta.n_groups == 20
    want = js.schedule_pending(c5_pods(jw, "run0", 1000, 20))
    got = ts.schedule_pending(tp)
    assert got == want and None not in got
    assert _complete_gangs(tp, got) == 20
    assert_auction_equal(js.last_result, ts.last_result)
    assert not ts.last_result.gang_dropped.any()


def test_gang_admission_retry_on_the_auction_route():
    """Scarcity on the auction route: c5's generator, 240 pods in 12 gangs
    onto 4 of its nodes (128 CPU for ~190 CPU of requests).  The full solve
    completes no gang, so the binary search admits gangs by priority; the
    names equal the reference's."""
    js, ts = _schedulers(4)
    tp, jp = c5_pods(tw, "s", 240, 12), c5_pods(jw, "s", 240, 12)
    _, meta = ts.encode_pending(tp)
    assert meta.route == "auction"
    assert _complete_gangs(tp, ts.schedule_pending_no_retry(tp)) == 0
    got, want = ts.schedule_pending(tp), js.schedule_pending(jp)
    assert got == want
    assert 0 < _complete_gangs(tp, got) < 12


GANG_CAP = 8192   # auction_common.cuh kGangCap


def bits_to_hold(x: int) -> int:
    return max(int(x), 1).bit_length()


def bitonic_sort(keys: np.ndarray) -> np.ndarray:
    """auction_common.cuh's bitonic network over a power-of-two count of
    u32 keys: for k = 2, 4, ..., for j = k / 2, ..., 1, pair t joins x =
    ((t & ~(j - 1)) << 1) | (t & (j - 1)) and x + j, ascending where x & k
    is 0."""
    keys = keys.copy()
    m = keys.size
    t = np.arange(m // 2)
    k = 2
    while k <= m:
        j = k // 2
        while j > 0:
            x = ((t & ~(j - 1)) << 1) | (t & (j - 1))
            y = x + j
            kx, ky = keys[x], keys[y]
            swap = (kx > ky) == ((x & k) == 0)
            keys[x] = np.where(swap, ky, kx)
            keys[y] = np.where(swap, kx, ky)
            j //= 2
        k *= 2
    return keys


def emulated_gang_stage(group_id, valid, assigned, bid_scores, reasons, req, nz, requested,
                        nonzero, n_groups, shape=(16, 512)):
    """auction_loop's gang stage in numpy on a cluster of shape = (blocks,
    threads): the [G] flags (back to 0 once read); each block's drops over
    its pod range [b P / G, (b + 1) P / G) (ceil) and its count; D and each
    block's offset; with D == 0 nothing more; up to GANG_CAP (and node and
    pod indices in 32 bits) each block's dropped pods, in chunks of its
    threads in pod index order (an exclusive scan), as (node << bits(P)) |
    pod at its offset in block 0's keys, sorted there by the kernel's
    bitonic network (which runs a key a thread with shuffles up to
    blockDim keys: the same pairs); else the pods compacted the same
    way and stably sorted by node (the radix sort); then one walk a (node
    run, resource), subtracting in float32 one pod at a time, and the
    dropped pods' rewrites.  Returns the plain twin's tuple and the path
    ("none", "block" or "cluster")."""
    blocks, threads = shape
    p, n = group_id.shape[0], requested.shape[0]
    gc = np.clip(group_id, 0, n_groups - 1)
    flags = np.zeros(n_groups, bool)          # 0 at the launch's entry
    marker = (group_id >= 0) & (assigned < 0) & valid
    flags[gc[marker]] = True
    dropped = (group_id >= 0) & flags[gc] & (assigned >= 0)
    flags[gc[marker]] = False                 # cleared by their markers after the counts
    assert not flags.any()
    per = -(-p // blocks)
    ranges = [(min(p, b * per), min(p, b * per + per)) for b in range(blocks)]
    counts = [int(dropped[lo:hi].sum()) for lo, hi in ranges]
    total = sum(counts)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(int)
    out_assigned, out_scores = assigned.copy(), bid_scores.copy()
    out_reasons, rq, nzr = reasons.copy(), requested.copy(), nonzero.copy()
    if total == 0:
        return (out_assigned, out_scores, out_reasons, dropped, rq, nzr), "none"
    node = np.minimum(assigned, n - 1).astype(np.int64)
    ib = bits_to_hold(p - 1)
    block_path = total <= GANG_CAP and ib + bits_to_hold(n - 1) <= 32
    listed = np.full(total, -1, np.int64)   # the compaction's slots
    for (lo, hi), off in zip(ranges, offsets):
        for base in range(lo, hi, threads):
            d = dropped[base:min(hi, base + threads)]
            pos = np.cumsum(d) - d                          # the block's exclusive scan
            idx = np.arange(base, base + d.size)[d]
            assert (listed[off + pos[d]] == -1).all()
            listed[off + pos[d]] = idx
            off += int(d.sum())
    assert (listed >= 0).all()
    if block_path:
        keys = (node[listed].astype(np.uint64) << ib) | listed.astype(np.uint64)
        m = 1 << bits_to_hold(total - 1) if total > 1 else 1
        keys = bitonic_sort(np.r_[keys, np.full(m - total, 0xFFFFFFFF, np.uint64)])[:total]
        path = "block"
        run_node, run_pod = (keys >> ib).astype(np.int64), (keys & ((1 << ib) - 1)).astype(
            np.int64)
    else:
        order = np.argsort(node[listed], kind="stable")
        run_pod = listed[order]
        run_node = node[run_pod]
        path = "cluster"
    starts = np.flatnonzero(np.r_[True, run_node[1:] != run_node[:-1]])
    ends = np.r_[starts[1:], total]
    for s0, s1 in zip(starts, ends):
        b, pods = run_node[s0], run_pod[s0:s1]
        rq[b] = np.subtract.accumulate(np.vstack([rq[b:b + 1], req[pods]]), axis=0,
                                       dtype=np.float32)[-1]
        nzr[b] = np.subtract.accumulate(np.vstack([nzr[b:b + 1], nz[pods]]), axis=0,
                                        dtype=np.float32)[-1]
    out_assigned[run_pod] = -1
    out_scores[run_pod] = -np.inf
    out_reasons[run_pod] = tassign.REASON_GANG
    return (out_assigned, out_scores, out_reasons, dropped, rq, nzr), path


def random_gang_state(seed, n_nodes, n_pods, n_groups, kind):
    """Seeded post-loop state: usage in [2^24, 2^26) with fractions (past
    float32's exact range), fractional requests, random gangs; `kind`
    "none" places every gang member (no drop)."""
    rng = np.random.default_rng(seed)
    r = 3
    requested = (rng.integers(2**24, 2**26, (n_nodes, r)) + rng.random((n_nodes, r))).astype(
        np.float32)
    nonzero = (requested * np.float32(1.5)).astype(np.float32)
    req = (rng.random((n_pods, r)) * 3e5).astype(np.float32)
    nz = (req + np.float32(0.37)).astype(np.float32)
    assigned = rng.integers(-1, n_nodes, n_pods).astype(np.int32)
    group_id = rng.integers(-1, n_groups, n_pods).astype(np.int32)
    valid = rng.random(n_pods) < 0.95
    if kind == "none":
        assigned = np.where(group_id >= 0, np.abs(assigned), assigned).astype(np.int32)
    bid_scores = rng.random(n_pods).astype(np.float32)
    reasons = np.where(assigned >= 0, tassign.REASON_NONE, tassign.REASON_RESOURCES).astype(
        np.int32)
    return group_id, valid, assigned, bid_scores, reasons, req, nz, requested, nonzero, n_groups


def s200_state():
    """c5's scarcity step's full solve: bench.py config5's 10,000 pods in
    100 gangs onto 200 of its nodes (256 padded), the port's plain loop and
    reasons on the CPU, before the post-pass; no gang completes."""
    ts = TorchBatchScheduler(mode="auto", device="cpu")
    for node in c5_nodes(tw, 200):
        ts.add_node(node)
    snap, meta = ts.encode_pending(c5_pods(tw, "scarce", 10000, 100))
    cluster, pods, st = tauction.auction_prep(snap, meta.features, meta.topo_split,
                                              ts.score_config)
    out = tauction._rounds_plain(cluster, pods, st, meta.tie_k, ts.score_config, 64)
    reasons = tauction.failure_reasons_plain(cluster, pods, st, out[0], out[2], out[3])
    return (pods.group_id.numpy(), pods.valid.numpy(), out[0].numpy(), out[1].numpy(),
            reasons.numpy(), pods.req.numpy(), pods.nonzero_req.numpy(), out[2].numpy(),
            out[3].numpy(), meta.n_groups)


@pytest.mark.parametrize("seed,n_nodes,n_pods,n_groups,kind", [
    pytest.param(0, 4, 300, 6, "block", id="0-4-300-6"),
    pytest.param(1, 16, 700, 40, "block", id="1-16-700-40"),
    pytest.param(2, 64, 2000, 300, "block", id="2-64-2000-300"),
    pytest.param(3, 3, 90, 1, "block", id="3-3-90-1"),
    pytest.param(6, 128, 6000, 60, "block", id="block-3102"),
    pytest.param(4, 16, 700, 40, "none", id="no-drop"),
    pytest.param(5, 64, 20000, 20, "cluster", id="above-cap"),
    pytest.param(None, None, None, None, "cluster", id="s200"),
])
def test_gang_stage_order_equals_plain_and_reference(seed, n_nodes, n_pods, n_groups, kind):
    """The stage's design at 16 x 512 and 3 x 32 threads, bit for bit:
    fractional requests onto nodes already past float32's exact range,
    against gang_post_pass_plain and the reference's masked scatter-add;
    no drop ends after the counts, a few (up to GANG_CAP) sort in one
    block, more than GANG_CAP over the cluster (c5's scarcity solve on 200
    nodes among them)."""
    state = s200_state() if seed is None else random_gang_state(seed, n_nodes, n_pods,
                                                                n_groups, kind)
    group_id, valid, assigned, bid_scores, reasons, req, nz, requested, nonzero, n_groups = state
    want, path = emulated_gang_stage(*state, shape=(16, 512))
    d = int(want[3].sum())
    assert path == kind
    assert (d == 0) == (kind == "none") and (d > GANG_CAP) == (kind == "cluster")
    if seed is not None and kind != "none":
        # fractional usage past 2^24 on a node holding several dropped pods
        held = np.bincount(assigned[want[3]], minlength=requested.shape[0])
        assert ((held >= 2) & (requested.max(axis=1) > 2**24)).any()
    other, other_path = emulated_gang_stage(*state, shape=(3, 32))
    assert other_path == path
    for a, b in zip(want, other):
        assert np.array_equal(a, b)

    class Pods:
        pass

    pods = Pods()
    pods.group_id, pods.valid = torch.from_numpy(group_id), torch.from_numpy(valid)
    pods.req, pods.nonzero_req = torch.from_numpy(req), torch.from_numpy(nz)
    got = tauction.gang_post_pass_plain(
        pods, torch.from_numpy(assigned), torch.from_numpy(bid_scores),
        torch.from_numpy(reasons), torch.from_numpy(requested), torch.from_numpy(nonzero),
        n_groups)
    for a, b in zip(want, got):
        assert np.array_equal(np.asarray(a), b.numpy())
    # the reference's release: dst.at[nodes].add(-req * mask) on the CPU
    nodes = jnp.clip(jnp.asarray(assigned), 0, requested.shape[0] - 1)
    mask = jnp.asarray(want[3]).astype(jnp.float32)[:, None]
    ref = jax.jit(lambda d, v: d.at[nodes].add(v * mask))
    assert np.array_equal(np.asarray(ref(jnp.asarray(requested), -jnp.asarray(req))), want[4])
    assert np.array_equal(np.asarray(ref(jnp.asarray(nonzero), -jnp.asarray(nz))), want[5])


@pytest.mark.parametrize("t_dim", [31, 32, 33, 65])
def test_repair_bit_reads_equal_dense_tables(t_dim):
    """The kernel's term_mi / term_anti (bit t of matches_incoming's word
    t / 32, t among anti_idx; each ANDed with valid) and its solve
    positions equal repair_tables' dense rows and the reference's."""
    rng = np.random.default_rng(t_dim)
    p, ma = 57, 3
    w = (t_dim + 31) // 32
    words = rng.integers(0, 2**32, (p, w), dtype=np.uint64).astype(np.uint32)
    anti_idx = np.where(rng.random((p, ma)) < 0.6, rng.integers(0, t_dim, (p, ma)), -1).astype(
        np.int32)
    valid = rng.random(t_dim) < 0.8
    order = rng.permutation(p).astype(np.int32)

    mi = np.zeros((p, t_dim), bool)
    anti = np.zeros((p, t_dim), bool)
    for i in range(p):
        for t in range(t_dim):
            mi[i, t] = valid[t] and bool((int(words[i, t >> 5]) >> (t & 31)) & 1)
            anti[i, t] = valid[t] and bool((anti_idx[i] == t).any())
    pos = np.empty(p, np.int32)
    pos[order] = np.arange(p)

    class Terms:
        pass

    terms = Terms()
    terms.matches_incoming = torch.from_numpy(words.view(np.int32))
    terms.anti_idx, terms.valid = torch.from_numpy(anti_idx), torch.from_numpy(valid)
    got = tauction.repair_tables(terms, torch.from_numpy(order))
    assert np.array_equal(got[0].numpy(), mi)
    assert np.array_equal(got[1].numpy(), anti)
    assert np.array_equal(got[2].numpy(), pos)
    ref_mi = jinterpod._unpack_bits_t(jnp.asarray(words), t_dim) & jnp.asarray(valid)[None, :]
    ref_anti = jinterpod._idx_to_bits(jnp.asarray(anti_idx), t_dim) & jnp.asarray(valid)[None, :]
    assert np.array_equal(np.asarray(ref_mi), mi)
    assert np.array_equal(np.asarray(ref_anti), anti)
