"""The port's greedy solve equals the reference's greedy_assign exactly.

One snapshot, encoded by the reference package, goes to the reference's
jitted greedy_assign and (as torch CPU tensors, so every kernel wrapper
runs its plain version) to the port's greedy_assign.  Every output field
is compared exactly: assignment, reasons and feasible counts are integers,
and the scores and post-solve usage are sums of floored, integer-valued
float32 terms that both sides compute in the same operation order.
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
from kubernetes_tpu_torch.ops import schema as tschema
from kubernetes_tpu_torch.ops import scores as tscores
from kubernetes_tpu_torch.testing.cases import mixed_objects

GI, MI = jw.GI, jw.MI

CONFIGS = {
    "least": dict(),
    "most": dict(fit_strategy="MostAllocated"),
    "rtcr": dict(fit_strategy="RequestedToCapacityRatio",
                 rtcr_shape=((0.0, 0.0), (50.0, 7.0), (100.0, 10.0))),
}


def solve_both(nodes, pods, bound=(), cfg_name="least"):
    snap, _ = jschema.SnapshotBuilder().build(nodes, pods, bound_pods=bound)
    want = jassign.greedy_assign_jit(jscores.ScoreConfig(**CONFIGS[cfg_name]))(snap)
    tsnap = dv.to_device(dv.snapshot_from_numpy(snap), "cpu")
    got = tassign.greedy_assign(tsnap, tscores.ScoreConfig(**CONFIGS[cfg_name]))
    # the input snapshot is left as it was
    assert np.array_equal(tsnap.cluster.requested.numpy(), snap.cluster.requested)
    return snap, want, got


def assert_results_equal(want, got):
    for f in ("assignment", "scores", "feasible_counts", "reasons"):
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype, f
        assert np.array_equal(a, b), (f, a, b)
    for f in ("requested", "nonzero_requested", "port_bits"):
        a, b = np.asarray(getattr(want.cluster, f)), getattr(got.cluster, f).numpy()
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        assert np.array_equal(a, b), f


@pytest.mark.parametrize(
    "seed,cfg_name",
    [(0, "least"), (1, "least"), (2, "most"), (3, "rtcr"), (4, "least"), (5, "rtcr")],
)
def test_mixed_batches(seed, cfg_name):
    _, want, got = solve_both(*mixed_objects(jw, seed), cfg_name=cfg_name)
    assert_results_equal(want, got)


def reason_case():
    nodes = [
        jw.make_node("small").capacity(cpu_milli=2000, mem=4 * GI, pods=110).label("disk", "ssd").obj(),
        jw.make_node("big").capacity(cpu_milli=8000, mem=16 * GI, pods=110).obj(),
    ]
    pods = [
        jw.make_pod("fits").req(cpu_milli=500, mem=512 * MI).obj(),
        jw.make_pod("no-label").required_affinity("disk", japi.OP_IN, ["nvme"]).obj(),
        jw.make_pod("too-big").req(cpu_milli=64000).obj(),
        jw.make_pod("port-a").host_port(9000).node_selector_kv("disk", "ssd").obj(),
        jw.make_pod("port-b").host_port(9000).node_selector_kv("disk", "ssd").obj(),
        jw.make_pod("bound-port").host_port(80).node_name("big").obj(),
        jw.make_pod("named").node_name("small").req(cpu_milli=100).obj(),
    ]
    bound = [jw.make_pod("b0").host_port(80).node_name("big").obj()]
    return nodes, pods, bound


def test_each_reason():
    snap, want, got = solve_both(*reason_case())
    assert_results_equal(want, got)
    reasons = got.reasons.numpy()[:7].tolist()
    assert reasons == [
        tassign.REASON_NONE, tassign.REASON_STATIC, tassign.REASON_RESOURCES,
        tassign.REASON_NONE, tassign.REASON_PORTS, tassign.REASON_STATIC,
        tassign.REASON_NONE,
    ]


def test_priorities_and_ties():
    """Identical nodes tie: first index wins; higher priority pops first."""
    nodes = [jw.make_node(f"n{i}").capacity(cpu_milli=4000, mem=8 * GI, pods=110).obj() for i in range(6)]
    pods = [
        jw.make_pod(f"p{i}").req(cpu_milli=1000 + 100 * (i % 3), mem=GI).priority(i % 4).obj()
        for i in range(20)
    ]
    _, want, got = solve_both(nodes, pods)
    assert_results_equal(want, got)
    order = tassign.solve_order(dv.to_device(dv.snapshot_from_numpy(
        jschema.SnapshotBuilder().build(nodes, pods)[0]), "cpu").pods).tolist()
    prios = [pods[i].spec.priority for i in order[:20]]
    assert prios == sorted(prios, reverse=True)


def test_gang_release():
    """A gang with an unplaceable member releases every member, and the
    released requests leave the post-solve usage."""
    nodes = [jw.make_node(f"n{i}").capacity(cpu_milli=4000, mem=8 * GI, pods=110).obj() for i in range(3)]
    pods = (
        [jw.make_pod(f"ok{i}").req(cpu_milli=1000).group("ok").obj() for i in range(3)]
        + [jw.make_pod(f"bad{i}").req(cpu_milli=1000).group("bad").obj() for i in range(2)]
        + [jw.make_pod("bad-huge").req(cpu_milli=9000).group("bad").obj()]
        + [jw.make_pod("solo").req(cpu_milli=500).obj()]
    )
    _, want, got = solve_both(nodes, pods)
    assert_results_equal(want, got)
    a = got.assignment.numpy()[:7]
    assert (a[:3] >= 0).all() and (a[3:6] < 0).all() and a[6] >= 0
    assert (got.reasons.numpy()[3:5] == tassign.REASON_GANG).all()


@pytest.mark.parametrize("family", ["spread", "anti-affinity", "pref-interpod", "image"])
def test_unported_families_raise(family):
    """A batch that mixes each family with TPU slice carve-outs (shaped
    pods on slice-labelled nodes; the last family ported) solves equal to
    the reference, field for field, the carve-out telemetry included."""
    nodes = [jw.make_node(f"n{i}").zone(f"z{i}").image("app:v1")
             .label(japi.LABEL_TPU_SLICE, "s0").label(japi.LABEL_TPU_TOPOLOGY, "2x2x1")
             .label(japi.LABEL_TPU_COORDS, f"{i % 2},{i // 2},0").obj() for i in range(3)]
    pod = jw.make_pod("p").req(cpu_milli=100)
    pod.pod.spec.tpu_topology = "2x1x1"
    if family == "spread":
        pod = pod.spread(selector={"app": "a"})
    elif family == "anti-affinity":
        pod = pod.pod_anti_affinity({"app": "a"})
    elif family == "pref-interpod":
        pod.pod.spec.affinity = japi.Affinity(pod_affinity=japi.PodAffinity(preferred=[
            japi.WeightedPodAffinityTerm(10, japi.PodAffinityTerm(japi.LabelSelector({"app": "a"})))]))
    else:
        pod = pod.image("app:v1")
    snap, _ = jschema.SnapshotBuilder().build(nodes, [pod.obj()])
    tsnap = dv.to_device(dv.snapshot_from_numpy(snap), "cpu")
    features = tassign.features_of(tsnap)
    assert features.slices and any(getattr(features, f) for f in (
        "spread", "interpod", "interpod_pref", "images"))
    want = jassign.greedy_assign(snap)
    got = tassign.greedy_assign(tsnap)
    assert_results_equal(want, got)
    for f in ("frag_score", "carveouts", "contiguous_gangs", "carveout_fallbacks"):
        assert np.array_equal(np.asarray(getattr(want, f)), getattr(got, f).numpy()), f
    assert int(got.assignment[0]) >= 0


@pytest.mark.parametrize("seed", range(3))
def test_routing_statics_match_reference(seed):
    """features_of, required_topo_z(_split) and num_groups: the host-side
    statics the scheduler derives before the transfer."""
    nodes, pods, bound = mixed_objects(jw, seed)
    snap, _ = jschema.SnapshotBuilder().build(nodes, pods, bound_pods=bound)
    tsnap = dv.snapshot_from_numpy(snap)
    for no_bound in (False, True):
        assert tuple(tassign.features_of(tsnap, no_bound_pods=no_bound)) == tuple(
            jassign.features_of(snap, no_bound_pods=no_bound)
        )
    assert tassign.required_topo_z(tsnap) == jassign.required_topo_z(snap)
    assert tassign.required_topo_z_split(tsnap) == jassign.required_topo_z_split(snap)
    assert tschema.num_groups(tsnap) == jschema.num_groups(snap)
    assert tassign.FeatureFlags._fields == jassign.FeatureFlags._fields
