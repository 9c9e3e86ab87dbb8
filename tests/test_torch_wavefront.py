"""The port's wavefront solve equals the reference's wavefront_assign.

One snapshot, encoded by the reference package, goes to the reference's
jitted wavefront_assign and (as torch CPU tensors, so the kernel wrapper
runs its plain version) to the port's wavefront_assign, with the same wave
plan.  Every field is compared exactly: assignment, scores, feasible
counts, reasons, the post-solve usage and ports, and the wave telemetry
(wave_count, wave_fallbacks).  The port's wavefront also equals the port's
greedy scan.  Cases follow tests/test_wavefront_parity.py, without the
spread and inter-pod families this slice does not solve.
"""

import numpy as np
import pytest

from kubernetes_tpu.api import types as japi
from kubernetes_tpu.ops import assign as jassign
from kubernetes_tpu.ops import schema as jschema
from kubernetes_tpu.ops import scores as jscores
from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu_torch.ops import assign as tassign
from kubernetes_tpu_torch.ops import device as dv
from kubernetes_tpu_torch.ops import scores as tscores
from kubernetes_tpu_torch.testing.cases import contended_objects, mixed_objects

GI, MI = jw.GI, jw.MI

CONFIGS = {
    "least": dict(),
    "most": dict(fit_strategy="MostAllocated"),
    "rtcr": dict(fit_strategy="RequestedToCapacityRatio",
                 rtcr_shape=((0.0, 0.0), (50.0, 7.0), (100.0, 10.0))),
}


def encode(nodes, pods, bound=()):
    snap, _ = jschema.SnapshotBuilder().build(nodes, pods, bound_pods=bound)
    return snap, dv.to_device(dv.snapshot_from_numpy(snap), "cpu")


def solve_both(snap, tsnap, members=None, wave_cap=8, cfg_name="least"):
    if members is None:
        members = jassign.plan_waves(snap, wave_cap=wave_cap).members
    want = jassign.wavefront_assign_jit(jscores.ScoreConfig(**CONFIGS[cfg_name]))(
        snap, wave_members=members
    )
    got = tassign.wavefront_assign(
        tsnap, wave_members=members, cfg=tscores.ScoreConfig(**CONFIGS[cfg_name])
    )
    assert np.array_equal(tsnap.cluster.requested.numpy(), snap.cluster.requested)
    return want, got


def assert_results_equal(want, got, telemetry=True):
    for f in ("assignment", "scores", "feasible_counts", "reasons"):
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype, f
        assert np.array_equal(a, b), (f, a, b)
    for f in ("requested", "nonzero_requested", "port_bits"):
        a, b = np.asarray(getattr(want.cluster, f)), getattr(got.cluster, f).numpy()
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        assert np.array_equal(a, b), f
    if telemetry:
        for f in ("wave_count", "wave_fallbacks"):
            assert int(getattr(want, f)) == int(getattr(got, f)), f


def check(nodes, pods, bound=(), members=None, wave_cap=8, cfg_name="least"):
    """Reference wavefront == port wavefront == port greedy scan."""
    snap, tsnap = encode(nodes, pods, bound)
    want, got = solve_both(snap, tsnap, members, wave_cap, cfg_name)
    assert_results_equal(want, got)
    scan = tassign.greedy_assign(tsnap, tscores.ScoreConfig(**CONFIGS[cfg_name]))
    assert_results_equal(got, scan, telemetry=False)
    return want, got


def one_wave_members(snap):
    """A hostile plan: the whole batch in a single wave."""
    prio = np.asarray(snap.pods.priority)
    p = prio.shape[0]
    order = np.argsort(-prio, kind="stable").astype(np.int32)
    k = max(8, 1 << (p - 1).bit_length())
    members = np.full((8, k), -1, dtype=np.int32)
    members[0, :p] = order
    return members


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("wave_cap", [4, 8, 32])
def test_plan_waves_matches_reference(seed, wave_cap):
    snap, tsnap = encode(*mixed_objects(jw, seed))
    want = jassign.plan_waves(snap, wave_cap=wave_cap)
    for src in (tsnap, dv.snapshot_from_numpy(snap)):
        got = tassign.plan_waves(src, wave_cap=wave_cap)
        assert got.n_waves == want.n_waves
        assert np.array_equal(got.members, want.members)


def test_resources_only_identical_pods():
    nodes = [jw.make_node(f"n{i}").capacity(cpu_milli=4000, mem=8 * GI, pods=110).obj()
             for i in range(6)]
    pods = [jw.make_pod(f"p{i}").req(cpu_milli=900, mem=1 * GI).obj() for i in range(20)]
    _, got = check(nodes, pods)
    assert int(got.wave_count) >= 1


def test_fit_flip_forces_full_reeval():
    nodes = [
        jw.make_node("n0").capacity(cpu_milli=1000, mem=2 * GI, pods=110).obj(),
        jw.make_node("n1").capacity(cpu_milli=700, mem=2 * GI, pods=110).obj(),
    ]
    pods = [jw.make_pod(f"p{i}").req(cpu_milli=600, mem=256 * MI).obj() for i in range(4)]
    snap, _ = encode(nodes, pods)
    _, got = check(nodes, pods, members=one_wave_members(snap))
    assert int(got.wave_fallbacks) > 0


def test_ports_conflict_serializes():
    nodes = [jw.make_node(f"n{i}").capacity(cpu_milli=8000, mem=16 * GI, pods=110).obj()
             for i in range(3)]
    pods = [jw.make_pod(f"w{i}").req(cpu_milli=500, mem=256 * MI).host_port(80).obj()
            for i in range(5)]
    snap, _ = encode(nodes, pods)
    # the planner splits on the shared port; a single hostile wave holds
    # them together and must serialize (every member is a fallback)
    check(nodes, pods)
    _, got = check(nodes, pods, members=one_wave_members(snap))
    assert int(got.wave_fallbacks) == int(snap.pods.valid.shape[0])


def test_gang_release():
    nodes = [jw.make_node(f"n{i}").capacity(cpu_milli=2000, mem=4 * GI, pods=110).obj()
             for i in range(4)]
    pods = [jw.make_pod(f"g{i}").req(cpu_milli=900, mem=512 * MI).group(f"gang-{i // 3}").obj()
            for i in range(9)]
    _, got = check(nodes, pods, wave_cap=4)
    assert (got.reasons.numpy() == tassign.REASON_GANG).any()


@pytest.mark.parametrize("seed", range(6))
def test_randomized_mixed(seed):
    """Mixed batches without spread or inter-pod terms, random wave cap
    and score strategy."""
    rng = np.random.default_rng(seed)
    zones = ["z1", "z2", "z3"]
    nodes = []
    for i in range(16):
        nw = jw.make_node(f"n{i}").capacity(
            cpu_milli=int(rng.choice([2000, 4000, 8000])),
            mem=int(rng.choice([4, 8, 16])) * GI,
            pods=int(rng.choice([5, 110])),
        ).zone(str(rng.choice(zones)))
        if rng.random() < 0.2:
            nw.taint("dedicated", "batch", japi.NO_SCHEDULE)
        nodes.append(nw.obj())
    pods = []
    for i in range(40):
        pw = jw.make_pod(f"p{i}").req(
            cpu_milli=int(rng.choice([100, 500, 1000, 2000])),
            mem=int(rng.choice([128, 512, 1024])) * MI,
        ).priority(int(rng.integers(-2, 3)))
        r = rng.random()
        if r < 0.2:
            pw.host_port(int(rng.choice([80, 443])))
        elif r < 0.4:
            pw.node_selector_kv(japi.LABEL_ZONE, str(rng.choice(zones)))
        if rng.random() < 0.15:
            pw.group(f"gang-{i % 3}")
        pods.append(pw.obj())
    check(nodes, pods, wave_cap=int(rng.choice([4, 8, 16])),
          cfg_name=("least", "most", "rtcr")[seed % 3])


@pytest.mark.parametrize("seed", range(3))
def test_random_partitions_are_exact(seed):
    """An arbitrary contiguous partition of the solve order (not the
    planner's) still equals the reference and the scan, including waves
    that share a host port and waves whose fit flips."""
    rng = np.random.default_rng(100 + seed)
    nodes = [jw.make_node(f"n{i}").capacity(cpu_milli=4000, mem=8 * GI, pods=110)
             .zone(f"z{i % 2}").obj() for i in range(6)]
    pods = []
    for i in range(18):
        pw = jw.make_pod(f"p{i}").req(cpu_milli=int(rng.choice([500, 1000, 2500])), mem=512 * MI)
        if i % 3 == 0:
            pw.host_port(8080)
        pods.append(pw.obj())
    snap, _ = encode(nodes, pods)
    prio = np.asarray(snap.pods.priority)
    p = prio.shape[0]
    order = np.argsort(-prio, kind="stable").astype(np.int32)
    k = 8
    cuts = sorted(rng.choice(np.arange(1, p), size=4, replace=False).tolist())
    chunks, start = [], 0
    for c in cuts + [p]:
        while c - start > k:
            chunks.append(order[start : start + k])
            start += k
        chunks.append(order[start:c])
        start = c
    chunks = [c for c in chunks if len(c)]
    w_pad = max(8, 1 << (len(chunks) - 1).bit_length())
    members = np.full((w_pad, k), -1, dtype=np.int32)
    for wi, ch in enumerate(chunks):
        members[wi, : len(ch)] = ch
    check(nodes, pods, members=members)


@pytest.mark.parametrize("seed,cfg_name", [(0, "least"), (1, "most"), (2, "rtcr"), (4, "least")])
def test_mixed_batches(seed, cfg_name):
    """The greedy route's mixed batches (selectors, taints, bound and
    in-batch ports, NodeName, priorities, gangs) through the wavefront."""
    check(*mixed_objects(jw, seed), wave_cap=8, cfg_name=cfg_name)


def test_uniform_cluster_tie_order():
    """Every node ties for every pod: the top list's (score desc, index
    asc) order decides each pick, and the picks walk the node axis."""
    nodes, pods, _ = contended_objects(jw, n_nodes=12, n_pods=40)
    _, got = check(nodes, pods, wave_cap=16)
    a = got.assignment.numpy()[:40]
    assert a[0] == 0 and (a >= 0).all()
