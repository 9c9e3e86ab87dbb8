"""PodTopologySpread through the port's three solves, against the reference.

One snapshot, encoded by the reference package, goes to the reference's
jitted greedy_assign and wavefront_assign and (as torch CPU tensors, so
every kernel wrapper runs its plain version) to the port's, with the same
wave plans and score config (the auction: tests/test_torch_spread_auction.py,
on the same cases).  Compared exactly: assignment, reasons, feasible
counts, scores, the post-solve requested / nonzero_requested and the wave
counters (wave_count, wave_fallbacks).  Cases: the spread cases of
tests/test_constraints.py (the randomized parity with its inter-pod terms
left out), tests/test_wavefront_parity.py and
tests/test_auction_constraints.py, seeded spread batches of
kubernetes_tpu_torch/testing/cases.py under every fit strategy and a
spread weight that is not a power of two, and scheduler_perf's
TopologySpreading workload scaled down through TorchBatchScheduler() and
TPUBatchScheduler() on each route.  The workload's objects
(testing/cases.py topology_spreading_objects, which chip_smoke.py drives)
are held to the repo's scheduler_perf templates, field for field, in both
of its whenUnsatisfiable settings.
"""

import copy
import importlib.util
from pathlib import Path

import numpy as np
import pytest

from kubernetes_tpu.api import kubeyaml as jkubeyaml
from kubernetes_tpu.api import types as japi
from kubernetes_tpu.models.batch_scheduler import TPUBatchScheduler
from kubernetes_tpu.ops import assign as jassign
from kubernetes_tpu.ops import auction as jauction
from kubernetes_tpu.ops import schema as jschema
from kubernetes_tpu.ops import scores as jscores
from kubernetes_tpu.perf import runner as jrunner
from kubernetes_tpu.perf import workload as jworkload
from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu_torch.models.batch_scheduler import TorchBatchScheduler
from kubernetes_tpu_torch.ops import assign as tassign
from kubernetes_tpu_torch.ops import auction as tauction
from kubernetes_tpu_torch.ops import device as dv
from kubernetes_tpu_torch.ops import schema as tschema
from kubernetes_tpu_torch.ops import scores as tscores
from kubernetes_tpu_torch.testing import wrappers as tw
from kubernetes_tpu_torch.testing.cases import spread_objects, topology_spreading_objects

GI, MI = jw.GI, jw.MI
make_node, make_pod = jw.make_node, jw.make_pod

CONFIGS = {
    "least": dict(),
    "most": dict(fit_strategy="MostAllocated"),
    "rtcr": dict(fit_strategy="RequestedToCapacityRatio",
                 rtcr_shape=((0.0, 0.0), (50.0, 7.0), (100.0, 10.0))),
    "weight": dict(spread_weight=1.7),
}


# -- cases (reference test files' spread cases) -----------------------------


def _zoned_nodes(n, zones=3):
    return [make_node(f"n{i}").capacity(cpu_milli=4000, mem=16 * GI, pods=110)
            .zone(f"z{i % zones}").obj() for i in range(n)]


def hard_spread_by_zone():
    pods = [make_pod(f"p{i}").labels(app="web").req(cpu_milli=100)
            .spread(max_skew=1, topology_key=japi.LABEL_ZONE, selector={"app": "web"}).obj()
            for i in range(9)]
    return _zoned_nodes(6), pods, []


def spread_blocks_when_skew_exceeded():
    nodes = [make_node("a").capacity(cpu_milli=16000, mem=32 * GI, pods=110).zone("z0").obj(),
             make_node("b").capacity(cpu_milli=50, mem=32 * GI, pods=110).zone("z1").obj()]
    pods = [make_pod(f"p{i}").labels(app="x").req(cpu_milli=50)
            .spread(max_skew=1, topology_key=japi.LABEL_ZONE, selector={"app": "x"}).obj()
            for i in range(5)]
    return nodes, pods, []


def spread_requires_topology_key():
    nodes = [make_node("zoned").zone("z1").obj(), make_node("bare").obj()]
    pods = [make_pod("p").labels(app="x")
            .spread(max_skew=1, topology_key=japi.LABEL_ZONE, selector={"app": "x"}).obj()]
    return nodes, pods, []


def soft_spread_prefers_low_count_zone():
    bound = [make_pod(f"b{i}").labels(app="w").node_name("n0").obj() for i in range(3)]
    pods = [make_pod("p").labels(app="w").req(cpu_milli=100)
            .spread(max_skew=1, topology_key=japi.LABEL_ZONE,
                    when_unsatisfiable="ScheduleAnyway", selector={"app": "w"}).obj()]
    return _zoned_nodes(4, zones=2), pods, bound


def randomized_spread(seed):
    """tests/test_constraints.py's randomized parity, inter-pod terms
    left out (the pods that drew one carry no constraint)."""
    rng = np.random.default_rng(seed + 100)
    nodes = [make_node(f"n{i}").capacity(cpu_milli=int(rng.choice([4000, 8000])),
                                         mem=16 * GI, pods=20).zone(f"z{i % 3}").obj()
             for i in range(10)]
    apps = ["a", "b", "c"]
    pods = []
    for i in range(30):
        app = str(rng.choice(apps))
        pw = make_pod(f"p{i}").labels(app=app).req(cpu_milli=int(rng.choice([100, 500, 1000])))
        r = rng.random()
        if r < 0.25:
            pw.spread(max_skew=int(rng.choice([1, 2])), topology_key=japi.LABEL_ZONE,
                      when_unsatisfiable=str(rng.choice(["DoNotSchedule", "ScheduleAnyway"])),
                      selector={"app": app})
        elif r < 0.45:
            rng.choice([japi.LABEL_HOSTNAME, japi.LABEL_ZONE])  # keep the draws in step
        pods.append(pw.obj())
    return nodes, pods, []


def coupled_spread():
    """tests/test_wavefront_parity.py:112: same-service spread pods."""
    nodes = [make_node(f"n{i}").capacity(cpu_milli=32000, mem=64 * GI, pods=110)
             .zone(f"z{i % 3}").obj() for i in range(9)]
    pods = [make_pod(f"s{i}").req(cpu_milli=500, mem=256 * MI).label("app", "svc")
            .spread(1, japi.LABEL_ZONE, "DoNotSchedule", {"app": "svc"}).obj()
            for i in range(9)]
    return nodes, pods, []


def soft_spread_parity():
    """tests/test_wavefront_parity.py:142."""
    nodes = [make_node(f"n{i}").capacity(cpu_milli=32000, mem=64 * GI, pods=110)
             .zone(f"z{i % 4}").obj() for i in range(8)]
    pods = [make_pod(f"s{i}").req(cpu_milli=500, mem=256 * MI).label("app", f"svc{i % 3}")
            .spread(2, japi.LABEL_ZONE, "ScheduleAnyway", {"app": f"svc{i % 3}"}).obj()
            for i in range(12)]
    return nodes, pods, []


def auction_spread_completeness():
    """tests/test_auction_constraints.py:52."""
    nodes = [make_node(f"n{i}").capacity(cpu_milli=8000, mem=16 * GI, pods=110)
             .zone(f"z{i % 8}").obj() for i in range(64)]
    pods = [make_pod(f"p{i}").req(cpu_milli=250, mem=256 * MI).label("app", f"svc-{i % 4}")
            .spread(1, japi.LABEL_ZONE, "DoNotSchedule", {"app": f"svc-{i % 4}"}).obj()
            for i in range(256)]
    return nodes, pods, []


def auction_spread_blocks_infeasible():
    """tests/test_auction_constraints.py:76."""
    nodes = [make_node("big0").capacity(cpu_milli=64000, pods=110).zone("z0").obj(),
             make_node("small").capacity(cpu_milli=250, pods=110).zone("z1").obj()]
    pods = [make_pod(f"p{i}").req(cpu_milli=250).label("app", "s")
            .spread(1, japi.LABEL_ZONE, "DoNotSchedule", {"app": "s"}).obj() for i in range(10)]
    return nodes, pods, []


def auction_soft_spread():
    """tests/test_auction_constraints.py:183."""
    nodes = [make_node(f"n{i}").capacity(cpu_milli=8000, mem=16 * GI, pods=110)
             .zone(f"z{i % 4}").obj() for i in range(8)]
    pods = [make_pod(f"p{i}").req(cpu_milli=250, mem=256 * MI).label("app", "s")
            .spread(1, japi.LABEL_ZONE, "ScheduleAnyway", {"app": "s"}).obj() for i in range(16)]
    return nodes, pods, []


def auction_nonmatching_carrier():
    """tests/test_auction_constraints.py:206."""
    nodes = [make_node(f"n{i}").capacity(cpu_milli=8000, pods=110).zone(f"z{i % 2}").obj()
             for i in range(4)]
    bound = [make_pod(f"b{i}").label("app", "x").node_name(f"n{i}").obj() for i in range(2)]
    pods = ([make_pod("carrier").req(cpu_milli=100)
             .spread(1, japi.LABEL_ZONE, "DoNotSchedule", {"app": "x"}).obj()]
            + [make_pod(f"f{i}").req(cpu_milli=100).obj() for i in range(7)])
    return nodes, pods, bound


CASES = {
    "hard_by_zone": hard_spread_by_zone,
    "skew_exceeded": spread_blocks_when_skew_exceeded,
    "requires_key": spread_requires_topology_key,
    "soft_low_zone": soft_spread_prefers_low_count_zone,
    "random0": lambda: randomized_spread(0),
    "random1": lambda: randomized_spread(1),
    "random2": lambda: randomized_spread(2),
    "coupled": coupled_spread,
    "soft_parity": soft_spread_parity,
    "auction_complete": auction_spread_completeness,
    "auction_blocks": auction_spread_blocks_infeasible,
    "auction_soft": auction_soft_spread,
    "carrier": auction_nonmatching_carrier,
}
SEEDED = {f"seed{s}-{cfg}": (s, cfg) for s, cfg in
          ((0, "least"), (1, "most"), (2, "rtcr"), (3, "weight"))}


def build_case(name):
    if name in SEEDED:
        seed, cfg = SEEDED[name]
        return spread_objects(jw, seed), cfg
    return CASES[name](), "least"


def encode(objs):
    nodes, pods, bound = objs
    snap, _ = jschema.SnapshotBuilder().build(nodes, pods, bound_pods=bound)
    assert jassign.features_of(snap).spread
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
ALL_CASES = sorted(CASES) + sorted(SEEDED)


@pytest.mark.parametrize("case", ALL_CASES)
def test_scan_matches_reference(case):
    objs, cfg = build_case(case)
    snap, tsnap = encode(objs)
    want = jassign.greedy_assign_jit(jscores.ScoreConfig(**CONFIGS[cfg]))(snap)
    got = tassign.greedy_assign(tsnap, tscores.ScoreConfig(**CONFIGS[cfg]))
    assert_fields(want, got, SOLVE_FIELDS)


def one_wave_members(snap):
    """A hostile plan: the solve order in full waves of 32, so coupled
    spread pods share waves."""
    prio = np.asarray(snap.pods.priority)
    order = np.argsort(-prio, kind="stable").astype(np.int32)
    w = -(-order.shape[0] // 32)
    members = np.full((-(-w // 8) * 8, 32), -1, dtype=np.int32)
    members.reshape(-1)[: order.shape[0]] = order
    return members


# the hostile plan on the cases whose pods couple through spread rows
WAVE_PLANS = [(c, "planned") for c in ALL_CASES] + [
    (c, "one_wave") for c in ("coupled", "soft_parity", "random0", "seed3-weight")]


@pytest.mark.parametrize("case,plan", WAVE_PLANS)
def test_wavefront_matches_reference(case, plan):
    objs, cfg = build_case(case)
    snap, tsnap = encode(objs)
    members = (jassign.plan_waves(snap, wave_cap=8).members if plan == "planned"
               else one_wave_members(snap))
    jcfg, tcfg = jscores.ScoreConfig(**CONFIGS[cfg]), tscores.ScoreConfig(**CONFIGS[cfg])
    want = jassign.wavefront_assign_jit(jcfg)(snap, wave_members=members)
    got = tassign.wavefront_assign(tsnap, wave_members=members, cfg=tcfg)
    assert_fields(want, got, SOLVE_FIELDS + ("wave_count", "wave_fallbacks"))
    scan = tassign.greedy_assign(tsnap, tcfg)
    assert_fields(got, scan, SOLVE_FIELDS)


def test_coupled_wave_serializes_and_planner_separates():
    """Spread members crammed into one wave are serialized (fallbacks);
    the planner gives them one-pod waves (none)."""
    snap, tsnap = encode(coupled_spread())
    got = tassign.wavefront_assign(tsnap, wave_members=one_wave_members(snap))
    assert int(got.wave_fallbacks) > 0
    planned = tassign.wavefront_assign(tsnap)
    assert int(planned.wave_fallbacks) == 0
    assert int(planned.wave_count) == 9


# -- the slice through the scheduler, on each route -------------------------

ROUTES = {
    # measured pods: 20 pad to 32 (scan), 100 to 128 (wavefront), 1,100 to
    # 2,048 (auction with the repair)
    "greedy-20": (20, "greedy"),
    "wavefront-100": (100, "wavefront"),
    "auction-1100": (1100, "auction"),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_topology_spreading_through_the_scheduler(case):
    """TopologySpreading's shape, scaled down (64 nodes in 8 zones, 64
    init pods, maxSkew 5 on the zone): TorchBatchScheduler() and
    TPUBatchScheduler() on their defaults take the same route and give
    the same names and last_result fields, batch after batch."""
    n_measure, route = ROUTES[case]
    jn, ji, jm = topology_spreading_objects(jw, 64, 64, n_measure)
    tn, ti, tm = topology_spreading_objects(tw, 64, 64, n_measure)
    js, ts = TPUBatchScheduler(), TorchBatchScheduler(device="cpu")
    for a, b in zip(jn, tn):
        js.add_node(a)
        ts.add_node(b)
    jnames, tnames = js.schedule_pending(ji), ts.schedule_pending(ti)
    assert jnames == tnames and None not in tnames
    for a, b, name in zip(ji, ti, tnames):
        js.assume(a, name)
        ts.assume(b, name)
    _, jmeta = js.encode_pending(jm)
    _, tmeta = ts.encode_pending(tm)
    assert jmeta.route == tmeta.route == route
    assert tmeta.features.spread and tuple(tmeta.features) == tuple(jmeta.features)
    jnames, tnames = js.schedule_pending(jm), ts.schedule_pending(tm)
    assert jnames == tnames
    jr, tr = js.last_result, ts.last_result
    assert type(jr).__name__ == type(tr).__name__
    fields = ["assignment", "scores", "reasons"]
    fields += (["gang_dropped", "rounds", "debug_sp_counts"] if route == "auction"
               else ["feasible_counts", "wave_count", "wave_fallbacks"])
    assert_fields(jr, tr, fields)
    if route == "auction":
        assert int(tr.rounds) > 1  # the repair held pods back to later rounds


# -- the workload's objects against the repo's scheduler_perf templates -----

ROOT = Path(__file__).resolve().parents[1]
PERF_CONFIG = ROOT / "kubernetes_tpu" / "perf" / "config" / "performance-config.yaml"


def topology_spreading_workload():
    (wl,) = jworkload.select(jworkload.load_config(str(PERF_CONFIG)),
                             name="TopologySpreading/5000Nodes")
    return wl


def template_objects(n_nodes, n_init, n_measure, when):
    """TopologySpreading's nodes, init and measured pods rendered from the
    YAML templates as the perf runner renders them (each object named by
    its template's generateName and index), the measured template's
    whenUnsatisfiable set to `when`."""
    create_nodes, init_op, measure_op = topology_spreading_workload().ops
    measure_t = copy.deepcopy(measure_op.pod_template)
    for c in measure_t["spec"]["topologySpreadConstraints"]:
        c["whenUnsatisfiable"] = when

    def render(template, i, make):
        d = jrunner._substitute_index(template, i)
        meta = d.setdefault("metadata", {})
        meta["name"] = f"{meta['generateName']}{i}"
        return make(d)

    nodes = [render(create_nodes.node_template, i, jkubeyaml.node_from_dict)
             for i in range(n_nodes)]
    init = [render(init_op.pod_template, i, jkubeyaml.pod_from_dict) for i in range(n_init)]
    measured = [render(measure_t, i, jkubeyaml.pod_from_dict) for i in range(n_measure)]
    return nodes, init, measured


@pytest.mark.parametrize("when", ["DoNotSchedule", "ScheduleAnyway"])
def test_topology_spreading_objects_match_templates(when):
    """cases.topology_spreading_objects equals the templates rendered from
    the YAML: every array of the encoded snapshot (node capacity, zone and
    hostname labels, pod requests and labels, the spread table) and every
    name.  ScheduleAnyway is the measured template with that one field
    changed (upstream's PreferredTopologySpreading shape)."""
    want = template_objects(24, 10, 30, when)
    got = topology_spreading_objects(tw, 24, 10, 30, when=when)
    for a, b in zip(want, got):
        assert [o.meta.name for o in a] == [o.meta.name for o in b]
    ws, wm = tschema.SnapshotBuilder().build(want[0], want[1] + want[2])
    gs, gm = tschema.SnapshotBuilder().build(got[0], got[1] + got[2])
    assert list(wm.node_names) == list(gm.node_names)
    for table in ws._fields:
        wt, gt = getattr(ws, table), getattr(gs, table)
        for f in wt._fields:
            a, b = np.asarray(getattr(wt, f)), np.asarray(getattr(gt, f))
            assert a.dtype == b.dtype and a.shape == b.shape, (table, f)
            assert np.array_equal(a, b), (table, f)
    hard = np.asarray(gs.spread.hard)[np.asarray(gs.spread.valid)]
    assert hard.size and bool(hard.all()) == (when == "DoNotSchedule")


def test_chip_smoke_drives_the_5000_node_workload():
    """chip_smoke.py's spread phase runs TopologySpreading/5000Nodes at
    the counts and maxSkew of the repo's config and template."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    create_nodes, init_op, measure_op = topology_spreading_workload().ops
    assert smoke.SPREAD == (create_nodes.count, init_op.count, measure_op.count)
    (constraint,) = measure_op.pod_template["spec"]["topologySpreadConstraints"]
    assert smoke.SPREAD_MAX_SKEW == constraint["maxSkew"]
    assert constraint["whenUnsatisfiable"] == "DoNotSchedule"
