"""The port's auction solve equals the reference's auction_assign.

One snapshot, encoded by the reference package, goes to the reference's
jitted auction_assign and (as torch CPU tensors, so every kernel wrapper
runs its plain version) to the port's auction_assign, with the same
n_groups and tie_k.  Compared exactly: assignment, scores, rounds,
gang_dropped, reasons and the post-solve requested / nonzero_requested.
Cases follow tests/test_auction.py, plus contended identical-pod batches
(more pods than tie nodes), memory requests that are not whole MiB (sums
past float32's exact range) and checks of the tie hash and the prefix
sum themselves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.api import types as japi
from kubernetes_tpu.ops import auction as jauction
from kubernetes_tpu.ops import schema as jschema
from kubernetes_tpu.ops import scores as jscores
from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu_torch.ops import assign as tassign
from kubernetes_tpu_torch.ops import auction as tauction
from kubernetes_tpu_torch.ops import device as dv
from kubernetes_tpu_torch.ops import scores as tscores
from kubernetes_tpu_torch.testing.cases import (
    basic_objects,
    capacity_edge_objects,
    contended_objects,
    fractional_mix_objects,
    gang_objects,
    mixed_objects,
)

GI, MI = jw.GI, jw.MI

CONFIGS = {
    "least": dict(),
    "most": dict(fit_strategy="MostAllocated"),
    "rtcr": dict(fit_strategy="RequestedToCapacityRatio",
                 rtcr_shape=((0.0, 0.0), (50.0, 7.0), (100.0, 10.0))),
}


def solve_both(nodes, pods, bound=(), cfg_name="least", tie_k=None, max_rounds=64):
    snap, _ = jschema.SnapshotBuilder().build(nodes, pods, bound_pods=bound)
    n_groups = jschema.num_groups(snap)
    if tie_k is None:
        tie_k = jauction.default_tie_k(snap)
    want = jauction.auction_assign_jit(
        jscores.ScoreConfig(**CONFIGS[cfg_name]), max_rounds=max_rounds,
    )(snap, n_groups=n_groups, tie_k=tie_k)
    tsnap = dv.to_device(dv.snapshot_from_numpy(snap), "cpu")
    assert tauction.default_tie_k(tsnap) == jauction.default_tie_k(snap)
    got = tauction.auction_assign(
        tsnap, tscores.ScoreConfig(**CONFIGS[cfg_name]), n_groups=n_groups,
        max_rounds=max_rounds, tie_k=tie_k,
    )
    assert np.array_equal(tsnap.cluster.requested.numpy(), snap.cluster.requested)
    assert_results_equal(want, got)
    return snap, want, got


def assert_results_equal(want, got):
    for f in ("assignment", "scores", "reasons", "gang_dropped"):
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype, f
        assert np.array_equal(a, b), (f, a, b)
    assert int(want.rounds) == int(got.rounds)
    for f in ("requested", "nonzero_requested"):
        a, b = np.asarray(getattr(want.cluster, f)), getattr(got.cluster, f).numpy()
        assert np.array_equal(a, b), f


def test_no_contention_matches_greedy():
    nodes = [jw.make_node(f"n{i}").capacity(cpu_milli=8000, mem=16 * GI, pods=10)
             .zone(f"z{i}").obj() for i in range(8)]
    pods = [jw.make_pod(f"p{i}").req(cpu_milli=1000, mem=GI)
            .node_selector_kv(japi.LABEL_ZONE, f"z{i}").obj() for i in range(8)]
    snap, _, got = solve_both(nodes, pods)
    tsnap = dv.to_device(dv.snapshot_from_numpy(snap), "cpu")
    greedy = tassign.greedy_assign(tsnap)
    assert np.array_equal(got.assignment.numpy()[:8], greedy.assignment.numpy()[:8])


@pytest.mark.parametrize("seed", range(3))
def test_capacity_never_oversubscribed(seed):
    rng = np.random.default_rng(seed)
    nodes = [jw.make_node(f"n{i}").capacity(cpu_milli=4000, mem=8 * GI, pods=5).obj()
             for i in range(8)]
    pods = [jw.make_pod(f"p{i}").req(cpu_milli=int(rng.choice([500, 1000, 2000, 3000])), mem=GI).obj()
            for i in range(40)]
    snap, _, got = solve_both(nodes, pods)
    a = got.assignment.numpy()[:40]
    req = np.asarray(snap.pods.req)[:40]
    used = np.zeros_like(np.asarray(snap.cluster.allocatable))
    np.add.at(used, a[a >= 0], req[a >= 0])
    assert (used <= np.asarray(snap.cluster.allocatable)).all()
    assert np.array_equal(got.cluster.requested.numpy(), used)


def test_unschedulable_stays_unplaced():
    nodes = [jw.make_node("n0").capacity(cpu_milli=1000, mem=GI, pods=5).obj()]
    pods = [jw.make_pod("big").req(cpu_milli=64000).obj()]
    _, _, got = solve_both(nodes, pods)
    assert int(got.assignment[0]) == -1
    assert int(got.reasons[0]) == tassign.REASON_RESOURCES


def test_gang_all_or_nothing():
    nodes = [jw.make_node(f"n{i}").capacity(cpu_milli=4000, mem=8 * GI, pods=110).obj()
             for i in range(2)]
    pods = ([jw.make_pod(f"g1-{i}").req(cpu_milli=2000).group("g1").obj() for i in range(3)]
            + [jw.make_pod(f"g2-{i}").req(cpu_milli=1000).group("g2").obj() for i in range(4)])
    _, _, got = solve_both(nodes, pods)
    a = got.assignment.numpy()[:7]
    for arr in (a[:3], a[3:]):
        assert (arr >= 0).all() or (arr < 0).all(), a


def test_priority_wins_contended_slot():
    nodes = [jw.make_node("only").capacity(cpu_milli=1000, mem=8 * GI, pods=110).obj()]
    pods = [jw.make_pod("low").req(cpu_milli=1000).priority(1).obj(),
            jw.make_pod("high").req(cpu_milli=1000).priority(10).obj()]
    _, _, got = solve_both(nodes, pods)
    a = got.assignment.numpy()[:2]
    assert a[1] == 0 and a[0] == -1


def test_unported_and_unsupported_families_raise():
    """Slice carve-outs, in-batch host ports and affinity-direction
    inter-pod terms are outside the auction: ValueError, as the reference
    raises on each (the scheduler routes such batches to the scan)."""
    nodes = [jw.make_node("n0").capacity(cpu_milli=8000, mem=8 * GI).zone("z")
             .label(japi.LABEL_TPU_SLICE, "s0").label(japi.LABEL_TPU_TOPOLOGY, "1x1x1")
             .label(japi.LABEL_TPU_COORDS, "0,0,0").obj()]
    shaped = jw.make_pod("s0").req(cpu_milli=100).obj()
    shaped.spec.tpu_topology = "1x1x1"
    snap, _ = jschema.SnapshotBuilder().build(nodes, [shaped])
    with pytest.raises(ValueError):
        jauction.auction_assign(snap)
    with pytest.raises(ValueError, match="slice carve-outs"):
        tauction.auction_assign(dv.to_device(dv.snapshot_from_numpy(snap), "cpu"))
    aff = [jw.make_pod("p0").label("app", "x").pod_affinity({"app": "x"}, japi.LABEL_ZONE).obj()]
    snap, _ = jschema.SnapshotBuilder().build(nodes, aff)
    with pytest.raises(ValueError):
        tauction.auction_assign(dv.to_device(dv.snapshot_from_numpy(snap), "cpu"))
    ports = [jw.make_pod("q0").host_port(80).obj()]
    snap, _ = jschema.SnapshotBuilder().build(nodes, ports)
    with pytest.raises(ValueError):
        tauction.auction_assign(dv.to_device(dv.snapshot_from_numpy(snap), "cpu"))


@pytest.mark.parametrize("n_nodes,n_pods,slots", [(32, 256, 16), (6, 64, 110), (10, 300, 20)])
def test_contended_identical_pods(n_nodes, n_pods, slots):
    """Uniform cluster, identical pods, more pods than tie nodes: the
    class's j-th pod bids tie slot j mod cnt, so pods wrap onto shared
    nodes and contend for them round after round."""
    _, want, got = solve_both(*contended_objects(jw, n_nodes, n_pods, slots))
    # 4000m nodes, 250m pods: min(16, slots) pods a node
    assert int((got.assignment >= 0).sum()) == min(n_pods, n_nodes * min(16, slots))


def test_contended_small_tie_k():
    """A tie list shorter than the class (tie_k < pods): the wrap happens
    inside the list as well."""
    solve_both(*contended_objects(jw, 24, 96, 110), tie_k=8)


@pytest.mark.parametrize("seed,cfg_name", [(0, "least"), (1, "most"), (3, "rtcr")])
def test_basic_batches(seed, cfg_name):
    """SchedulingBasic-shaped batches with several classes, priorities and
    zone selectors, under each fit strategy."""
    solve_both(*basic_objects(jw, 40, 150, seed), cfg_name=cfg_name)


def test_gang_batch_releases_incomplete_group():
    _, _, got = solve_both(*gang_objects(jw))
    assert got.gang_dropped.any()
    assert (got.reasons.numpy() == tassign.REASON_GANG).any()


def test_max_rounds_cuts_the_loop():
    """Two tie nodes a round for 128 pods: three rounds place 96, and the
    loop stops at max_rounds with pods still unplaced."""
    _, _, got = solve_both(*contended_objects(jw, 8, 128, 110), tie_k=2, max_rounds=3)
    assert int(got.rounds) == 3
    assert int((got.assignment >= 0).sum()) == 96


def test_mixed_batches_without_ports():
    """The mixed batches with in-batch host ports stripped (those route to
    the greedy solves): selectors, taints, bound ports, NodeName,
    priorities and gangs through the auction."""
    for seed in (0, 1, 2):
        nodes, pods, bound = mixed_objects(jw, seed)
        for p in pods:
            p.spec.containers[0].ports = []
        solve_both(nodes, pods, bound)


@pytest.mark.parametrize("n_nodes,n_pods,per_node,priorities",
                         [(64, 1000, 10, 1), (48, 1000, 7, 1), (8, 1000, 110, 3)])
def test_capacity_edge_fractional_requests(n_nodes, n_pods, per_node, priorities):
    """Memory requests of 100M (not a whole number of MiB) on nodes that
    hold exactly per_node of them: the acceptance prefix passes 4,096 MiB,
    beyond float32's exact range for these values, and a node's last pod
    lands on its capacity, so acceptance follows the order in which the
    prefix is added.  The port adds in the reference's order
    (auction.prefix_sum); torch.cumsum's order places differently here."""
    _, _, got = solve_both(*capacity_edge_objects(jw, n_nodes, n_pods, per_node, priorities))
    assert int((got.assignment >= 0).sum()) == min(n_pods, n_nodes * per_node)


def test_prefix_sum_matches_reference_cumsum():
    """prefix_sum adds as jnp.cumsum does (bit for bit) at lengths around
    each level of its blocks, on values whose sums leave float32's exact
    range."""
    rng = np.random.default_rng(0)
    f = jax.jit(lambda a: jnp.cumsum(a, axis=0))
    for p in (1, 15, 16, 17, 255, 256, 257, 1000, 1024, 4097, 10240):
        x = (rng.integers(0, 400000, size=(p, 4)) / 4096.0).astype(np.float32)
        want = np.asarray(f(x))
        got = tauction.prefix_sum(torch.from_numpy(x)).numpy()
        assert np.array_equal(want, got), p


@pytest.mark.parametrize("seed", [0, 1])
def test_fractional_mix_commit_order(seed):
    """Several non-whole-MiB sizes in four priorities on 60 GB+ nodes: each
    node's committed sum passes float32's exact range, so requested depends
    on the order a round adds its accepted pods (the reference's
    scatter-add: pod index order, not solve order)."""
    solve_both(*fractional_mix_objects(jw, seed))


@pytest.mark.parametrize("rnd", [0, 1, 7, 63])
def test_tie_hash_matches_reference(rnd):
    """The reference's tie key (auction.py:433-442: wrapping u32 multiply,
    xor, logical >> 2, cast to i32) against the port's int64 version, for
    several classes, rounds, seeds and 70,000 nodes."""
    n = 70000
    for c in (0, 1, 5, 1023, 16383):
        for tie_seed in (0, 3):
            rot = (
                (jnp.uint32(c) * jnp.uint32(0x9E3779B9))
                ^ (jnp.uint32(rnd) * jnp.uint32(0x85EBCA6B))
                ^ jnp.uint32(tie_seed * 2 + 1)
            ) * jnp.uint32(0x27D4EB2F)
            gids = jnp.arange(n, dtype=jnp.uint32) + jnp.uint32(1)
            want = np.asarray(((gids * jnp.uint32(0x9E3779B9)) ^ rot) >> 2).astype(np.int32)
            got = tauction.tie_keys(c, rnd, n, tie_seed, "cpu").numpy()
            assert np.array_equal(want.astype(np.int64), got)
