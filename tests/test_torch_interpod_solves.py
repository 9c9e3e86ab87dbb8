"""Inter-pod affinity, preferred inter-pod affinity and ImageLocality through
the port's scan and wavefront, against the reference.

One snapshot, encoded by the reference package, goes to the reference's
jitted greedy_assign and wavefront_assign and (as torch CPU tensors, so
every kernel wrapper runs its plain version) to the port's, with the same
wave plans and score config.  Compared exactly: assignment, reasons,
feasible counts, scores, the post-solve requested / nonzero_requested and
the wave counters.  The port's final inter-pod bits are held against the
reference's interpod_update folded over the placed pods (the gang release
leaves them as they are, as the reference's does).  Cases: the inter-pod
cases of tests/test_constraints.py and tests/test_wavefront_parity.py (its
hostile one-wave plan too), the cases of tests/test_prefpod_scoring.py and
tests/test_image_locality.py, seeded batches of kubernetes_tpu_torch/
testing/cases.py under weights that are not powers of two (which pin that
the reference adds the extra row after the spread term, unfused), and the
scheduler_perf workloads SchedulingPodAntiAffinity and
SchedulingPodAffinity (and the preferred variant) scaled down through
TorchBatchScheduler() and TPUBatchScheduler() on each route.  The
workloads' objects are held to the repo's YAML templates.
"""

import copy
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest

from kubernetes_tpu.api import kubeyaml as jkubeyaml
from kubernetes_tpu.api import types as japi
from kubernetes_tpu.models.batch_scheduler import TPUBatchScheduler
from kubernetes_tpu.ops import assign as jassign
from kubernetes_tpu.ops import interpod as jinter
from kubernetes_tpu.ops import schema as jschema
from kubernetes_tpu.ops import scores as jscores
from kubernetes_tpu.perf import runner as jrunner
from kubernetes_tpu.perf import workload as jworkload
from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu_torch.models.batch_scheduler import TorchBatchScheduler
from kubernetes_tpu_torch.ops import assign as tassign
from kubernetes_tpu_torch.ops import device as dv
from kubernetes_tpu_torch.ops import schema as tschema
from kubernetes_tpu_torch.ops import scores as tscores
from kubernetes_tpu_torch.testing import cases
from kubernetes_tpu_torch.testing import wrappers as tw

GI, MI = jw.GI, jw.MI
make_node, make_pod = jw.make_node, jw.make_pod

CONFIGS = {
    "default": dict(),
    "odd": dict(interpod_weight=1.3, image_weight=0.7, spread_weight=1.7),
    "most": dict(fit_strategy="MostAllocated", interpod_weight=0.1, image_weight=3.3),
}


# -- cases (the reference test files' inter-pod, preferred and image cases) --


def _zoned(n, zones=3):
    return [make_node(f"n{i}").capacity(cpu_milli=4000, mem=16 * GI, pods=110)
            .zone(f"z{i % zones}").obj() for i in range(n)]


def anti_by_hostname():
    """tests/test_constraints.py:108."""
    pods = [make_pod(f"p{i}").labels(app="db").req(cpu_milli=100)
            .pod_anti_affinity({"app": "db"}, japi.LABEL_HOSTNAME).obj() for i in range(4)]
    return _zoned(3), pods, []


def affinity_colocates():
    """tests/test_constraints.py:122."""
    first = make_pod("lead").labels(app="grp").req(cpu_milli=100).obj()
    followers = [make_pod(f"f{i}").labels(app="grp").req(cpu_milli=100)
                 .pod_affinity({"app": "grp"}, japi.LABEL_ZONE).obj() for i in range(3)]
    return _zoned(6), [first] + followers, []


def first_pod_escape():
    """tests/test_constraints.py:136 and :150 in one batch: a self-matching
    pod escapes, one whose term matches nothing stays pending."""
    pods = [make_pod("solo").labels(app="self").req(cpu_milli=100)
            .pod_affinity({"app": "self"}, japi.LABEL_ZONE).obj(),
            make_pod("orphan").labels(app="other").req(cpu_milli=100)
            .pod_affinity({"app": "missing"}, japi.LABEL_ZONE).obj()]
    return _zoned(3), pods, []


def existing_anti_blocks():
    """tests/test_constraints.py:162."""
    bound = [make_pod("guard").labels(app="guard")
             .pod_anti_affinity({"app": "noisy"}, japi.LABEL_ZONE).node_name("n0").obj()]
    pods = [make_pod("noisy-1").labels(app="noisy").req(cpu_milli=100).obj()]
    return _zoned(2, 2), pods, bound


def batch_anti_carries():
    """tests/test_constraints.py:177."""
    pods = [make_pod("guard").labels(app="guard").req(cpu_milli=100)
            .pod_anti_affinity({"app": "noisy"}, japi.LABEL_ZONE).obj(),
            make_pod("noisy-1").labels(app="noisy").req(cpu_milli=100).obj()]
    return _zoned(2, 2), pods, []


def wave_anti_parity():
    """tests/test_wavefront_parity.py:162."""
    nodes = [make_node(f"n{i}").capacity(cpu_milli=32000, mem=64 * GI, pods=110).obj()
             for i in range(10)]
    pods = [make_pod(f"a{i}").req(cpu_milli=500, mem=256 * MI).label("app", f"s{i % 4}")
            .pod_anti_affinity({"app": f"s{i % 4}"}, japi.LABEL_HOSTNAME).obj()
            for i in range(20)]
    return nodes, pods, []


def wave_escape_parity():
    """tests/test_wavefront_parity.py:186."""
    nodes = [make_node(f"n{i}").capacity(cpu_milli=32000, mem=64 * GI, pods=110)
             .zone(f"z{i % 2}").obj() for i in range(6)]
    pods = [make_pod(f"co{i}").req(cpu_milli=500, mem=256 * MI).label("app", "web")
            .pod_affinity({"app": "web"}, japi.LABEL_ZONE).obj() for i in range(6)]
    return nodes, pods, []


def _pref(pw, selector, weight=50, anti=False, topo=japi.LABEL_ZONE):
    term = japi.WeightedPodAffinityTerm(weight, japi.PodAffinityTerm(
        japi.LabelSelector(match_labels=selector), topo))
    aff = pw.pod.spec.affinity or japi.Affinity()
    pw.pod.spec.affinity = aff
    if anti:
        aff.pod_anti_affinity = aff.pod_anti_affinity or japi.PodAntiAffinity()
        aff.pod_anti_affinity.preferred.append(term)
    else:
        aff.pod_affinity = aff.pod_affinity or japi.PodAffinity()
        aff.pod_affinity.preferred.append(term)
    return pw


def _zone2(n):
    return _zoned(n, 2)


def pref_attract_repel():
    """tests/test_prefpod_scoring.py:53 and :64: attraction to a matching
    bound pod's zone, repulsion by an anti term."""
    bound = [make_pod("b").label("app", "x").node_name("n1").obj(),
             make_pod("c").label("app", "y").node_name("n2").obj()]
    pods = [_pref(make_pod("p").req(cpu_milli=100), {"app": "x"}).obj(),
            _pref(make_pod("q").req(cpu_milli=100), {"app": "y"}, anti=True).obj()]
    return _zone2(4), pods, bound


def pref_owner_terms():
    """tests/test_prefpod_scoring.py:77 and :90: bound pods' preferred and
    required terms judge the incoming pod (hardPodAffinityWeight)."""
    owner = _pref(make_pod("owner").label("app", "o"), {"app": "z"}, weight=80)
    owner = owner.node_name("n1").obj()
    hard = (make_pod("hard").label("app", "h").pod_affinity({"app": "z"}, japi.LABEL_ZONE)
            .node_name("n2").obj())
    pods = [make_pod(f"p{i}").req(cpu_milli=100).label("app", "z").obj() for i in range(3)]
    return _zone2(6), pods, [owner, hard]


def pref_weights_balance():
    """tests/test_prefpod_scoring.py:123."""
    bound = [make_pod("bx").label("app", "x").node_name("n0").obj(),
             make_pod("by").label("app", "y").node_name("n1").obj()]
    pw = make_pod("p").req(cpu_milli=100)
    _pref(pw, {"app": "x"}, weight=10)
    _pref(pw, {"app": "y"}, weight=90)
    return _zone2(4), [pw.obj()], bound


BIG = 800 * 1024 * 1024


def image_cases():
    """tests/test_image_locality.py:23, :34 and :49 in one batch: a warm
    node, an aliased image, a tiny image below the threshold."""
    node = make_node("alias").obj()
    node.status.images.append(japi.ContainerImage(names=["app@sha256:abc", "app:latest"],
                                                  size_bytes=BIG))
    nodes = [make_node("cold").obj(), make_node("warm").image("ml:v1", BIG).obj(), node,
             make_node("tinyn").image("tiny:v1", 1024 * 1024).obj()]
    pods = [make_pod("p").req(cpu_milli=100).image("ml:v1").obj(),
            make_pod("q").req(cpu_milli=100).image("app:latest").obj(),
            make_pod("r").req(cpu_milli=100).image("tiny:v1").obj()]
    return nodes, pods, []


def mixed_families(seed):
    """Spread, required and preferred inter-pod terms and images in one
    batch (the seeded preferred batch on image nodes, some pods given a
    zone spread and a hostname anti term)."""
    nodes, pods, bound = cases.prefpod_objects(jw, seed)
    inodes, ipods, _ = cases.image_objects(jw, seed, n_nodes=len(nodes), n_pods=len(pods))
    for nd, ind in zip(nodes, inodes):
        nd.status.images = ind.status.images
    for k, (pod, ipod) in enumerate(zip(pods, ipods)):
        pod.spec.containers[0].image = ipod.spec.containers[0].image
        if k % 3 == 0:
            pod.meta.labels["svc"] = "s"
            pod.spec.topology_spread_constraints.append(japi.TopologySpreadConstraint(
                max_skew=2, topology_key=japi.LABEL_ZONE, when_unsatisfiable="DoNotSchedule",
                label_selector=japi.LabelSelector(match_labels={"svc": "s"})))
            aff = pod.spec.affinity or japi.Affinity()
            aff.pod_anti_affinity = aff.pod_anti_affinity or japi.PodAntiAffinity()
            aff.pod_anti_affinity.required.append(japi.PodAffinityTerm(
                japi.LabelSelector(match_labels={"svc": "s"}), japi.LABEL_HOSTNAME))
            pod.spec.affinity = aff
    return nodes, pods, bound


CASES = {
    "anti_host": (anti_by_hostname, "default"),
    "colocate": (affinity_colocates, "default"),
    "escape": (first_pod_escape, "default"),
    "existing_anti": (existing_anti_blocks, "default"),
    "batch_anti": (batch_anti_carries, "default"),
    "wave_anti": (wave_anti_parity, "default"),
    "wave_escape": (wave_escape_parity, "default"),
    "pref_attract": (pref_attract_repel, "default"),
    "pref_owner": (pref_owner_terms, "odd"),
    "pref_weights": (pref_weights_balance, "default"),
    "images": (image_cases, "odd"),
}
for _s, _cfgs in enumerate((("default", "odd", "most"), ("odd", "most", "default"),
                             ("most", "default", "odd"))):
    CASES[f"interpod{_s}"] = (lambda s=_s: cases.interpod_objects(jw, s), _cfgs[0])
    CASES[f"prefpod{_s}"] = (lambda s=_s: cases.prefpod_objects(jw, s), _cfgs[1])
    CASES[f"image{_s}"] = (lambda s=_s: cases.image_objects(jw, s), _cfgs[2])
for _s in range(2):
    CASES[f"mixed{_s}"] = (lambda s=_s: mixed_families(s), ("odd", "most")[_s])
ALL = sorted(CASES)


def encode(objs):
    nodes, pods, bound = objs
    snap, _ = jschema.SnapshotBuilder().build(nodes, pods, bound_pods=bound)
    f = jassign.features_of(snap)
    assert f.interpod or f.interpod_pref or f.images
    return snap, dv.to_device(dv.snapshot_from_numpy(snap), "cpu")


def assert_fields(want, got, fields):
    for f in fields:
        a, b = getattr(want, f), getattr(got, f)
        if a is None or b is None:
            assert a is None and b is None, f
            continue
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype, f
        assert np.array_equal(a, b), (f, np.nonzero(a != b))
    for f in ("requested", "nonzero_requested"):
        assert np.array_equal(np.asarray(getattr(want.cluster, f)),
                              getattr(got.cluster, f).numpy()), f


SOLVE_FIELDS = ("assignment", "scores", "feasible_counts", "reasons")


def reference_bits(snap, placed):
    """The reference's term bits after placing each (pod, node) of
    `placed`: prep_terms folded through interpod_update (ORs commute, so
    the order does not matter)."""
    features = jassign.features_of(snap)
    z = jassign.required_topo_z_split(snap)[1]
    st = jinter.prep_terms(jax.tree.map(np.asarray, snap.cluster), snap.terms, z,
                           slots=features.term_slots, has_bound=features.bound_terms)
    topo = np.asarray(snap.cluster.topo_ids)
    for i, node in placed:
        st = jinter.interpod_update(st, snap.terms, i, topo[node], True,
                                    slots=features.term_slots)
    return tuple(np.asarray(t) for t in (st.present_bits, st.blocked_bits, st.global_any))


def scan_bits(tsnap, cfg):
    """The port's scan with its final term bits (the plain version)."""
    features = tassign.features_of(tsnap)
    cl, pods, sf, aff, taint, sp, tm, extra = tassign._solver_prep(tsnap, features, cfg=cfg)
    out = tassign.greedy_assign_plain(cl, pods, sf, aff, taint, tassign.solve_order(pods),
                                      features, 0, cfg, sp, tm, extra)
    return out[0], out[-3:]


@pytest.mark.parametrize("case", ALL)
def test_scan_matches_reference(case):
    build, cfg = CASES[case]
    snap, tsnap = encode(build())
    jcfg, tcfg = jscores.ScoreConfig(**CONFIGS[cfg]), tscores.ScoreConfig(**CONFIGS[cfg])
    want = jassign.greedy_assign_jit(jcfg)(snap)
    got = tassign.greedy_assign(tsnap, tcfg)
    assert_fields(want, got, SOLVE_FIELDS)
    if jassign.features_of(snap).interpod:
        assignment, bits = scan_bits(tsnap, tcfg)
        placed = [(i, int(a)) for i, a in enumerate(assignment.tolist()) if a >= 0]
        for a, b in zip(reference_bits(snap, placed), bits):
            assert np.array_equal(a, b.numpy().view(np.uint32))


def one_wave_members(snap):
    """A hostile plan: the solve order in full waves of 32, so coupled
    inter-pod pods share waves."""
    prio = np.asarray(snap.pods.priority)
    order = np.argsort(-prio, kind="stable").astype(np.int32)
    w = -(-order.shape[0] // 32)
    members = np.full((-(-w // 8) * 8, 32), -1, dtype=np.int32)
    members.reshape(-1)[: order.shape[0]] = order
    return members


WAVE_PLANS = [(c, "planned") for c in ALL] + [
    (c, "one_wave") for c in ("wave_anti", "wave_escape", "interpod0", "mixed0")]


@pytest.mark.parametrize("case,plan", WAVE_PLANS)
def test_wavefront_matches_reference(case, plan):
    build, cfg = CASES[case]
    snap, tsnap = encode(build())
    members = (jassign.plan_waves(snap, wave_cap=8).members if plan == "planned"
               else one_wave_members(snap))
    jcfg, tcfg = jscores.ScoreConfig(**CONFIGS[cfg]), tscores.ScoreConfig(**CONFIGS[cfg])
    want = jassign.wavefront_assign_jit(jcfg)(snap, wave_members=members)
    got = tassign.wavefront_assign(tsnap, wave_members=members, cfg=tcfg)
    assert_fields(want, got, SOLVE_FIELDS + ("wave_count", "wave_fallbacks"))
    assert_fields(got, tassign.greedy_assign(tsnap, tcfg), SOLVE_FIELDS)


def test_coupled_wave_serializes_and_planner_separates():
    """Self-anti-affine pods crammed into one wave are serialized
    (fallbacks); the planner gives the same-service pods waves that do not
    couple (none)."""
    snap, tsnap = encode(wave_anti_parity())
    got = tassign.wavefront_assign(tsnap, wave_members=one_wave_members(snap))
    assert int(got.wave_fallbacks) > 0
    assert int(tassign.wavefront_assign(tsnap).wave_fallbacks) == 0


def test_gang_release_keeps_term_bits():
    """A gang with an unplaceable member releases its placements' requests
    but not their term bits (the reference's _gang_release touches only
    requested / nonzero): the later pod sees the released member's anti
    term, in both packages."""
    nodes = _zoned(3)
    pods = ([make_pod("g0").label("app", "g").req(cpu_milli=100).group("gang")
             .pod_anti_affinity({"app": "x"}, japi.LABEL_ZONE).obj(),
             make_pod("g1").req(cpu_milli=99000).group("gang").obj()]
            + [make_pod(f"x{i}").label("app", "x").req(cpu_milli=100).obj() for i in range(3)])
    snap, tsnap = encode((nodes, pods, []))
    n_groups = jschema.num_groups(snap)
    want = jassign.greedy_assign_jit()(snap, n_groups=n_groups)
    got = tassign.greedy_assign(tsnap, n_groups=n_groups)
    assert_fields(want, got, SOLVE_FIELDS)
    a = got.assignment.numpy()[:5]
    # g0 took n0 (zone z0) before its gang was released; the x pods still
    # avoid z0
    assert a[0] < 0 and a[1] < 0 and (a[2:] >= 0).all() and 0 not in a[2:]


def test_check_supported_raises_for_slices_only():
    """With slices ported no family is deferred (check_supported is gone);
    what remains for slices is the reference's routing: the auction
    declines exactly the families the reference's declines, and the
    wavefront raises on a slice batch only, with the reference's error."""
    from kubernetes_tpu.ops.auction import auction_features_ok as j_ok
    from kubernetes_tpu_torch.ops.auction import auction_features_ok as t_ok

    assert not hasattr(tassign, "check_supported")
    for flag in ("spread", "soft_spread", "interpod", "interpod_aff", "interpod_pref",
                 "images", "ports", "slices"):
        assert t_ok(tassign.FeatureFlags(**{flag: True})) == j_ok(
            jassign.FeatureFlags(**{flag: True})), flag
    with pytest.raises(ValueError, match="classic greedy scan"):
        tassign.wavefront_assign(None, None, features=tassign.FeatureFlags(
            interpod=True, slices=True))


# -- the scheduler_perf workloads through the scheduler, on each route -------

ROUTES = {
    # (builder, measured pods, route): 20 pad to 32 (scan), 100 to 128
    # (wavefront), 1,100 to 2,048 (auction; never with affinity terms)
    "anti-greedy-20": ("anti", 20, "greedy"),
    "anti-wavefront-100": ("anti", 100, "wavefront"),
    "anti-auction-1100": ("anti", 1100, "auction"),
    "affinity-greedy-20": ("affinity", 20, "greedy"),
    "affinity-wavefront-100": ("affinity", 100, "wavefront"),
    "preferred-wavefront-100": ("preferred", 100, "wavefront"),
    "preferred-auction-1100": ("preferred", 1100, "auction"),
}
BUILDERS = {"anti": cases.pod_anti_affinity_objects, "affinity": cases.pod_affinity_objects,
            "preferred": cases.preferred_affinity_objects}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_workloads_through_the_scheduler(case):
    """The workloads' shapes, scaled down (256 nodes in 8 zones, 32 init
    pods): TorchBatchScheduler() and TPUBatchScheduler() on their defaults
    take the same route and give the same names and last_result fields,
    batch after batch (on the anti-affinity auction most measured pods
    find no free node, so the repair and the reasons are exercised)."""
    kind, n_measure, route = ROUTES[case]
    jn, ji, jm = BUILDERS[kind](jw, 256, 32, n_measure)
    tn, ti, tm = BUILDERS[kind](tw, 256, 32, n_measure)
    js, ts = TPUBatchScheduler(), TorchBatchScheduler(device="cpu")
    for a, b in zip(jn, tn):
        js.add_node(a)
        ts.add_node(b)
    jnames, init_names = js.schedule_pending(ji), ts.schedule_pending(ti)
    assert jnames == init_names and None not in init_names
    for a, b, name in zip(ji, ti, init_names):
        js.assume(a, name)
        ts.assume(b, name)
    _, jmeta = js.encode_pending(jm)
    _, tmeta = ts.encode_pending(tm)
    assert jmeta.route == tmeta.route == route
    assert tuple(tmeta.features) == tuple(jmeta.features)
    assert tmeta.topo_split == jmeta.topo_split
    jnames, tnames = js.schedule_pending(jm), ts.schedule_pending(tm)
    assert jnames == tnames
    jr, tr = js.last_result, ts.last_result
    assert type(jr).__name__ == type(tr).__name__
    fields = ["assignment", "scores", "reasons"]
    fields += (["gang_dropped", "rounds"] if route == "auction"
               else ["feasible_counts", "wave_count", "wave_fallbacks"])
    assert_fields(jr, tr, fields)
    if kind == "anti":
        hosts = init_names + [n for n in tnames if n is not None]
        assert len(hosts) == len(set(hosts))  # no two color=green pods on a node


# -- the workloads' objects against the repo's scheduler_perf templates ------

ROOT = Path(__file__).resolve().parents[1]
PERF_CONFIG = ROOT / "kubernetes_tpu" / "perf" / "config" / "performance-config.yaml"
WORKLOADS = {"anti": "SchedulingPodAntiAffinity/5000Nodes",
             "affinity": "SchedulingPodAffinity/5000Nodes"}


def workload(kind):
    (wl,) = jworkload.select(jworkload.load_config(str(PERF_CONFIG)), name=WORKLOADS[kind])
    return wl


def template_objects(kind, n_nodes, n_init, n_measure):
    """The workload's nodes, init and measured pods rendered from the YAML
    templates as the perf runner renders them (each object named by its
    template's generateName and index, in its op's namespace)."""
    create_nodes, _ns, init_op, measure_op = workload(kind).ops

    def render(template, i, make, namespace=None):
        d = jrunner._substitute_index(copy.deepcopy(template), i)
        meta = d.setdefault("metadata", {})
        meta["name"] = f"{meta['generateName']}{i}"
        if namespace:
            meta["namespace"] = namespace
        return make(d)

    nodes = [render(create_nodes.node_template, i, jkubeyaml.node_from_dict)
             for i in range(n_nodes)]
    init = [render(init_op.pod_template, i, jkubeyaml.pod_from_dict, init_op.namespace)
            for i in range(n_init)]
    measured = [render(measure_op.pod_template, i, jkubeyaml.pod_from_dict,
                       measure_op.namespace) for i in range(n_measure)]
    return nodes, init, measured


@pytest.mark.parametrize("kind", sorted(WORKLOADS))
def test_workload_objects_match_templates(kind):
    """cases.pod_anti_affinity_objects / pod_affinity_objects equal the
    templates rendered from the YAML: every array of the encoded snapshot
    (the term tables included), every name and namespace, with the init
    pods bound as the init phase leaves them."""
    want = template_objects(kind, 24, 10, 30)
    got = BUILDERS[kind](tw, 24, 10, 30)
    for a, b in zip(want, got):
        assert [(o.meta.namespace, o.meta.name) for o in a] == \
            [(o.meta.namespace, o.meta.name) for o in b]
    for objs in (want, got):
        for i, pod in enumerate(objs[1]):
            pod.spec.node_name = objs[0][i % 24].meta.name
    ws, wm = tschema.SnapshotBuilder().build(want[0], want[2], bound_pods=want[1])
    gs, gm = tschema.SnapshotBuilder().build(got[0], got[2], bound_pods=got[1])
    assert list(wm.node_names) == list(gm.node_names)
    for table in ws._fields:
        wt, gt = getattr(ws, table), getattr(gs, table)
        for f in wt._fields:
            a, b = np.asarray(getattr(wt, f)), np.asarray(getattr(gt, f))
            assert a.dtype == b.dtype and a.shape == b.shape, (table, f)
            assert np.array_equal(a, b), (table, f)
    assert np.asarray(gs.terms.valid).any()


def test_chip_smoke_drives_the_5000_node_workloads():
    """chip_smoke.py's interpod phase runs SchedulingPodAntiAffinity and
    SchedulingPodAffinity at the counts of the repo's config."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for kind, counts in (("anti", smoke.ANTI), ("affinity", smoke.AFFINITY_POD)):
        create_nodes, _ns, init_op, measure_op = workload(kind).ops
        assert counts == (create_nodes.count, init_op.count, measure_op.count)
        assert (init_op.namespace, measure_op.namespace) == ("sched-0", "sched-1")
    assert smoke.PREFERRED == smoke.AFFINITY_POD
