"""The port's TPU slice carve-out family equals the reference's, field for field.

Every device-side case of tests/test_slices.py runs through both packages:
one snapshot, encoded by the reference package, goes to the reference's
greedy_assign and (as torch CPU tensors, so every kernel wrapper runs its
plain version) to the port's.  assignment, scores, feasible counts,
reasons (REASON_SLICE included), the post-solve usage and the four
carve-out telemetry fields (frag_score, carveouts, contiguous_gangs,
carveout_fallbacks) are compared exactly (tolerance 0); the reference's
host Oracle is the second witness of the placements.  The schedulers are
held to each other through TorchBatchScheduler(device="cpu") against
TPUBatchScheduler, the c10 slice-packing churn included.
"""

import numpy as np
import pytest
import torch

from kubernetes_tpu.api import types as japi
from kubernetes_tpu.models.batch_scheduler import TPUBatchScheduler
from kubernetes_tpu.ops import assign as jassign
from kubernetes_tpu.ops import schema as jschema
from kubernetes_tpu.ops import scores as jscores
from kubernetes_tpu.ops import slices as jslices
from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu.testing.oracle import Oracle
from kubernetes_tpu_torch.models.batch_scheduler import TorchBatchScheduler
from kubernetes_tpu_torch.ops import assign as tassign
from kubernetes_tpu_torch.ops import auction as tauction
from kubernetes_tpu_torch.ops import device as dv
from kubernetes_tpu_torch.ops import scores as tscores
from kubernetes_tpu_torch.ops import slices as tslices
from kubernetes_tpu_torch.testing import cases
from kubernetes_tpu_torch.testing import wrappers as tw

RESULT_FIELDS = ("assignment", "scores", "feasible_counts", "reasons")
CARVE_FIELDS = ("frag_score", "carveouts", "contiguous_gangs", "carveout_fallbacks")


def host_gang_release(pods, names):
    """The gang all-or-nothing post-pass on the oracle's answers."""
    groups = {}
    for i, p in enumerate(pods):
        if p.spec.scheduling_group:
            groups.setdefault(p.spec.scheduling_group, []).append(i)
    for idx in groups.values():
        if any(names[i] is None for i in idx):
            for i in idx:
                names[i] = None
    return names


def bits(a) -> np.ndarray:
    """float32 as its bit pattern (so -0.0 and +0.0 differ)."""
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32)).view(np.int32)


def assert_solve_equal(want, got):
    for f in RESULT_FIELDS:
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype, f
        if a.dtype == np.float32:
            assert np.array_equal(bits(a), bits(b)), (f, a, b)
        assert np.array_equal(a, b), (f, a, b)
    for f in ("requested", "nonzero_requested"):
        assert np.array_equal(np.asarray(getattr(want.cluster, f)),
                              getattr(got.cluster, f).numpy()), f
    for f in CARVE_FIELDS:
        a, b = getattr(want, f), getattr(got, f)
        if a is None:
            assert b is None, f
            continue
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape == (), f
        assert np.array_equal(bits(a) if a.dtype == np.float32 else a,
                              bits(b) if b.dtype == np.float32 else b), (f, a, b)


def solve_both(nodes, pods, policy, bound=(), cfg=None):
    """(port names, oracle names, port result, features): the reference's
    greedy_assign and the port's on one snapshot, compared field for
    field."""
    snap, meta = jschema.SnapshotBuilder().build(nodes, pods, bound_pods=bound)
    jf = jassign.features_of(snap, slice_policy=policy)
    n_groups = jschema.num_groups(snap)
    want = jassign.greedy_assign(snap, cfg or jscores.DEFAULT_SCORE_CONFIG,
                                 features=jf, n_groups=n_groups)
    tsnap = dv.to_device(dv.snapshot_from_numpy(snap), "cpu")
    tf = tassign.features_of(tsnap, slice_policy=policy)
    assert tuple(tf) == tuple(jf)
    tcfg = tscores.ScoreConfig(**cfg.__dict__) if cfg is not None else tscores.DEFAULT_SCORE_CONFIG
    got = tassign.greedy_assign(tsnap, tcfg, features=tf, n_groups=n_groups)
    assert_solve_equal(want, got)
    names = [meta.node_name(int(i)) for i in got.assignment.numpy()[: len(pods)]]
    order = sorted(range(len(pods)), key=lambda i: (-pods[i].spec.priority, i))
    oracle = Oracle(nodes, bound_pods=bound, slice_policy=policy)
    want_names = [None] * len(pods)
    for i in order:
        want_names[i] = oracle.schedule_one(pods[i])
    return names, host_gang_release(pods, want_names), got, tf


def tcluster(snap):
    return dv.to_device(dv.snapshot_from_numpy(snap), "cpu").cluster


# -- the plain versions --------------------------------------------------------


def test_corner_mask_basic():
    import jax.numpy as jnp

    nodes = cases.mk_slices(jw, 1, (2, 2, 2))
    snap, meta = jschema.SnapshotBuilder().build(nodes, [jw.make_pod("p").obj()])
    jcl = type(snap.cluster)(*[jnp.asarray(x) for x in snap.cluster])
    want = np.asarray(jslices.corner_mask(
        jcl, jslices.free_devices(jcl), jnp.asarray([2, 2, 1], jnp.int32), 1, 2))
    cl = tcluster(snap)
    got = tslices.corner_mask(cl, tslices.free_devices(cl),
                              torch.tensor([2, 2, 1], dtype=torch.int32), 1, 2).numpy()
    assert np.array_equal(want, got)
    assert {meta.node_name(i) for i in np.flatnonzero(got)} == {"slice-0-000", "slice-0-001"}


def test_fragmentation_report():
    """The report off a scheduler's state, before and after one device of
    slice 0 is taken: equal to the reference's."""
    js, ts = TPUBatchScheduler(), TorchBatchScheduler(device="cpu")
    for a, b in zip(cases.mk_slices(jw, 2, (2, 2, 2)), cases.mk_slices(tw, 2, (2, 2, 2))):
        js.add_node(a)
        ts.add_node(b)
    rep = tslices.fragmentation_report(ts.state.tensors())
    assert rep == jslices.fragmentation_report(js.state.tensors())
    assert rep == {"score": 0.0, "largest_cube": [2, 2], "free_count": [8.0, 8.0]}
    js.assume(jw.make_pod("x").req(cpu_milli=100).obj(), "slice-0-000")
    ts.assume(tw.make_pod("x").req(cpu_milli=100).obj(), "slice-0-000")
    rep = tslices.fragmentation_report(ts.state.tensors())
    assert rep == jslices.fragmentation_report(js.state.tensors())
    assert rep["largest_cube"] == [1, 2] and rep["free_count"] == [7.0, 8.0]
    assert rep["score"] > 0.0


def test_multicore_coordinate_free_only_when_all_cores_free():
    import jax.numpy as jnp

    nodes = [
        cases.slice_node(jw, "s", 0, 0, 0, (2, 1, 1), core=0),
        cases.slice_node(jw, "s", 0, 0, 0, (2, 1, 1), core=1),
        cases.slice_node(jw, "s", 1, 0, 0, (2, 1, 1)),
    ]
    bound = jw.make_pod("b").req(cpu_milli=100).node_name(nodes[0].meta.name).obj()
    snap, _ = jschema.SnapshotBuilder().build(nodes, [jw.make_pod("p").obj()], bound_pods=[bound])
    jcl = type(snap.cluster)(*[jnp.asarray(x) for x in snap.cluster])
    want = np.asarray(jslices.corner_mask(
        jcl, jslices.free_devices(jcl), jnp.asarray([2, 1, 1], jnp.int32), 1, 2))
    cl = tcluster(snap)
    got = tslices.corner_mask(cl, tslices.free_devices(cl),
                              torch.tensor([2, 1, 1], dtype=torch.int32), 1, 2).numpy()
    assert np.array_equal(want, got) and not got[:3].any()
    # the solves agree on it too: a 2x1x1 gang has no free box
    pods = cases.gang(jw, "g", 2, "2x1x1")
    names, want_names, result, _ = solve_both(nodes, pods, "require", bound=[bound])
    assert names == want_names == [None, None]


def test_bonus_operands_are_exact_fused_or_not():
    """The carve-out bonuses' multiply-adds (anchor: 1e6 - 100 * leftover
    - 10 * coordsum; member: 1,010,000 - 10 * hops) hold exact integers
    below 2^24 over every operand the grid allows (leftover <= 64 slices
    x 4,096 nodes, coordinates <= 3 x 15), so a fused multiply-add rounds
    as the two plain operations do: the reference's compiler may fuse
    them or not, and the port's versions agree either way."""
    left = np.arange(0, 64 * 4096 + 1, dtype=np.float32)[:, None]
    csum = np.arange(0, 46, dtype=np.float32)[None, :]
    plain = (np.float32(1e6) - np.float32(100.0) * left) - np.float32(10.0) * csum
    t_left, t_csum = torch.from_numpy(left), torch.from_numpy(csum)
    fused = tscores.fma32(torch.full_like(t_csum, -10.0), t_csum,
                          tscores.fma32(torch.full_like(t_left, -100.0), t_left,
                                        torch.full_like(t_left, 1e6)))
    exact = 1e6 - 100.0 * left.astype(np.float64) - 10.0 * csum.astype(np.float64)
    assert np.array_equal(plain.astype(np.float64), exact)
    assert np.array_equal(fused.numpy().astype(np.float64), exact)
    hops = np.arange(0, 46, dtype=np.float32)
    member = np.float32(1_010_000.0) - np.float32(10.0) * hops
    assert np.array_equal(member.astype(np.float64), 1_010_000.0 - 10.0 * hops.astype(np.float64))


def test_unshaped_pod_score_gains_plus_zero():
    """Every pod of a slice batch gets the bonus added, unshaped ones
    included (the reference adds s_bonus for all): x + 0.0 turns a -0.0
    score into +0.0.  With every weight -0.0 each score is -0.0; in a
    slice batch the unshaped pod's winning score is +0.0 on both sides,
    outside one it stays -0.0."""
    cfg = jscores.ScoreConfig(fit_weight=-0.0, balanced_weight=-0.0,
                              node_affinity_weight=-0.0, taint_weight=-0.0)
    nodes = cases.mk_slices(jw, 1, (2, 2, 1))
    solo = jw.make_pod("solo").req(cpu_milli=100).obj()
    _, _, got, _ = solve_both(nodes, [solo] + cases.gang(jw, "g", 2, "2x1x1"), "prefer", cfg=cfg)
    assert bits(got.scores.numpy()[:1])[0] == 0           # +0.0
    _, _, got, features = solve_both(nodes, [solo], "prefer", cfg=cfg)
    assert not features.slices
    assert bits(got.scores.numpy()[:1])[0] == bits([-0.0])[0]


# -- solver parity -------------------------------------------------------------


@pytest.mark.parametrize("policy", ["prefer", "require"])
def test_gang_carveout_parity_basic(policy):
    nodes = cases.mk_slices(jw, 2, (2, 2, 2))
    pods = (cases.gang(jw, "g0", 4, "2x2x1") + cases.gang(jw, "g1", 8, "2x2x2")
            + cases.gang(jw, "g2", 2, "2x1x1"))
    got, want, result, _ = solve_both(nodes, pods, policy)
    assert got == want
    assert int(result.contiguous_gangs) == 3 and int(result.carveout_fallbacks) == 0


@pytest.mark.parametrize("policy", ["prefer", "require"])
def test_unfittable_gang_parity(policy):
    nodes = cases.mk_slices(jw, 1, (2, 2, 2))
    pods = cases.gang(jw, "big", 4, "3x3x3")
    got, want, result, _ = solve_both(nodes, pods, policy)
    assert got == want
    if policy == "require":
        assert got == [None] * 4
        assert (result.reasons.numpy()[:4] == tassign.REASON_SLICE).all()
        assert int(result.contiguous_gangs) == 0
    else:
        assert None not in got


def test_prefer_mode_counts_fallbacks():
    nodes = cases.mk_slices(jw, 1, (2, 2, 1))
    bound = jw.make_pod("b").req(cpu_milli=100).node_name("slice-0-000").obj()
    got, want, result, _ = solve_both(nodes, cases.gang(jw, "g", 2, "2x2x1"), "prefer",
                                      bound=[bound])
    assert got == want and None not in got
    assert int(result.carveout_fallbacks) == 1 and int(result.contiguous_gangs) == 0


def test_require_holds_capacity_feasible_but_fragmented():
    nodes = cases.mk_slices(jw, 1, (2, 2, 1))
    bound = jw.make_pod("b").req(cpu_milli=100).node_name("slice-0-000").obj()
    pods = cases.gang(jw, "g", 2, "2x1x1")
    got, want, _, _ = solve_both(nodes, pods, "require", bound=[bound])
    assert got == want and set(got) == {"slice-0-010", "slice-0-110"}
    bound2 = jw.make_pod("b2").req(cpu_milli=100).node_name("slice-0-110").obj()
    got2, want2, result2, _ = solve_both(nodes, pods, "require", bound=[bound, bound2])
    assert got2 == want2 == [None, None]
    assert (result2.reasons.numpy()[:2] == tassign.REASON_SLICE).all()


def test_best_fit_prefers_tighter_slice():
    nodes = cases.mk_slices(jw, 1, (2, 2, 2)) + [
        cases.slice_node(jw, "small", x, 0, 0, (2, 1, 1)) for x in range(2)]
    got, want, _, _ = solve_both(nodes, cases.gang(jw, "g", 2, "2x1x1"), "prefer")
    assert got == want and all(n.startswith("small") for n in got)


def test_off_policy_disarms_family():
    nodes = cases.mk_slices(jw, 1, (2, 2, 2))
    got, want, result, features = solve_both(nodes, cases.gang(jw, "g", 2, "3x3x3"), "off")
    assert not features.slices and None not in got
    assert all(getattr(result, f) is None for f in CARVE_FIELDS)


@pytest.mark.parametrize("seed", range(6))
def test_randomized_topology_parity(seed):
    """The reference's randomized parity suite (gangs that cannot fit
    included), both policies, against the reference and the Oracle."""
    nodes, pods, bound, policy = cases.random_slice_objects(jw, seed)
    got, want, _, features = solve_both(nodes, pods, policy, bound=bound)
    assert features.slices
    assert got == want, f"seed {seed} policy {policy}: {got} != {want}"


@pytest.mark.parametrize("policy", ["prefer", "require"])
def test_slices_with_other_families(policy):
    """Shaped gangs beside spread, anti-affinity, preferred-affinity and
    image pods, with host ports: the carve-out stage is the last filter
    and its bonus rides outside the normalised sum on every route of
    _eval_pod."""
    nodes = cases.mk_slices(jw, 2, (2, 2, 1))
    for nd in nodes:
        nd.meta.labels[japi.LABEL_ZONE] = f"z{nd.meta.name[-2]}"
        nd.status.images.append(japi.ContainerImage(names=["app:v1"], size_bytes=300 * jw.MI))
    pods = cases.gang(jw, "g", 3, "2x1x1") + cases.gang(jw, "h", 2, "1x2x1", priority=1)
    pods += [
        jw.make_pod("s").label("app", "a").spread(selector={"app": "a"}).obj(),
        jw.make_pod("x").label("app", "a").pod_anti_affinity({"app": "a"}).obj(),
        jw.make_pod("i").image("app:v1").host_port(8080).obj(),
    ]
    pods[-1].spec.affinity = japi.Affinity(pod_affinity=japi.PodAffinity(preferred=[
        japi.WeightedPodAffinityTerm(10, japi.PodAffinityTerm(japi.LabelSelector({"app": "a"})))]))
    got, want, _, features = solve_both(nodes, pods, policy)
    assert features.slices and features.spread and features.interpod and features.ports
    assert got == want


# -- routing and the other solves ------------------------------------------------


def test_route_pins_slice_batches_to_classic_greedy():
    js, ts = TPUBatchScheduler(), TorchBatchScheduler(device="cpu")
    for a, b in zip(cases.mk_slices(jw, 8, (2, 2, 2)), cases.mk_slices(tw, 8, (2, 2, 2))):
        js.add_node(a)
        ts.add_node(b)
    jp = [p for g in range(16) for p in cases.gang(jw, f"g{g}", 4, "2x2x1")]
    tp = [p for g in range(16) for p in cases.gang(tw, f"g{g}", 4, "2x2x1")]
    snap, meta = ts.encode_pending(tp)
    assert meta.features.slices and meta.route == "greedy"
    names = ts.finalize_pending(tp, ts.solve_encoded_async(snap, meta))
    assert names == js.schedule_pending(jp) and None not in names
    assert_solve_equal(js.last_result, ts.last_result)
    for f in CARVE_FIELDS:
        assert getattr(ts.last_solve, f) == getattr(js.last_solve, f), f


def test_wavefront_rejects_slice_features():
    snap, _ = jschema.SnapshotBuilder().build(cases.mk_slices(jw, 1, (2, 2, 2)),
                                              cases.gang(jw, "g", 2, "2x1x1"))
    tsnap = dv.to_device(dv.snapshot_from_numpy(snap), "cpu")
    with pytest.raises(ValueError, match="classic greedy scan"):
        jassign.wavefront_assign(snap, None, features=jassign.features_of(snap))
    with pytest.raises(ValueError, match="classic greedy scan"):
        tassign.wavefront_assign(tsnap, None, features=tassign.features_of(tsnap))


def test_auction_declines_slice_features():
    from kubernetes_tpu.ops.auction import auction_features_ok as j_ok

    for f in (dict(slices=True, slice_z=2, slice_dim=2), {}):
        assert tauction.auction_features_ok(tassign.FeatureFlags(**f)) == j_ok(
            jassign.FeatureFlags(**f))
    snap, _ = jschema.SnapshotBuilder().build(cases.mk_slices(jw, 1, (2, 2, 2)),
                                              cases.gang(jw, "g", 2, "2x1x1"))
    with pytest.raises(ValueError, match="slice carve-outs"):
        tauction.auction_assign(dv.to_device(dv.snapshot_from_numpy(snap), "cpu"))


def test_mirror_tracks_slice_label_updates():
    """A re-tessellated slice: the resident mirror's delta carries the new
    coordinates, as the reference's does (both schedulers warm)."""
    js = TPUBatchScheduler(carveout_policy="require")
    ts = TorchBatchScheduler(device="cpu", carveout_policy="require")
    jn, tn = cases.mk_slices(jw, 1, (2, 2, 1)), cases.mk_slices(tw, 1, (2, 2, 1))
    for a, b in zip(jn, tn):
        js.add_node(a)
        ts.add_node(b)
    got = ts.schedule_pending(cases.gang(tw, "g", 4, "2x2x1"))
    assert got == js.schedule_pending(cases.gang(jw, "g", 4, "2x2x1")) and None not in got
    for nodes, sched in ((jn, js), (tn, ts)):
        for nd in nodes:
            x, y, _z = japi.parse_coords(nd.meta.labels[japi.LABEL_TPU_COORDS])
            nd.meta.labels[japi.LABEL_TPU_TOPOLOGY] = "2x1x1"
            if y > 0:
                nd.meta.labels[japi.LABEL_TPU_COORDS] = f"{x},5,0"  # out of extent
            sched.update_node(nd)
    got = ts.schedule_pending(cases.gang(tw, "g2", 4, "2x2x1"))
    assert got == js.schedule_pending(cases.gang(jw, "g2", 4, "2x2x1")) == [None] * 4
    assert_solve_equal(js.last_result, ts.last_result)


def test_carveout_policy_is_validated():
    with pytest.raises(ValueError, match="carveout_policy"):
        TorchBatchScheduler(device="cpu", carveout_policy="sometimes")


@pytest.mark.parametrize("policy", ["prefer", "require"])
def test_c10_churn_matches_reference(policy):
    """bench.py's c10 mix, cut to 8 slices of 4x4x4 and 3 rounds, through
    both schedulers: every round's names, result fields and carve-out
    telemetry equal, departures drawn from one seed."""
    jc, tc = cases.SliceChurn(jw, n_slices=8), cases.SliceChurn(tw, n_slices=8)
    js = TPUBatchScheduler(carveout_policy=policy)
    ts = TorchBatchScheduler(device="cpu", carveout_policy=policy)
    for a, b in zip(jc.nodes(), tc.nodes()):
        js.add_node(a)
        ts.add_node(b)
    jlive, tlive = [], []
    for r in range(3):
        if r:
            for sched, churn, live in ((js, jc, jlive), (ts, tc, tlive)):
                for members in churn.depart(live):
                    for p, _n in members:
                        sched.forget(p)
        jp, tp = jc.round_pods(r), tc.round_pods(r)
        jn, tn = js.schedule_pending(jp), ts.schedule_pending(tp)
        assert tn == jn
        assert isinstance(ts.last_result, tassign.SolveResult)   # the scan's
        assert ts.last_result.wave_count is None
        assert_solve_equal(js.last_result, ts.last_result)
        for f in CARVE_FIELDS:
            assert getattr(ts.last_solve, f) == getattr(js.last_solve, f), (r, f)
        for sched, pods, names, live, churn in ((js, jp, jn, jlive, jc), (ts, tp, tn, tlive, tc)):
            for p, n in zip(pods, names):
                if n is not None:
                    sched.assume(p, n)
            live.extend(churn.placed_gangs(pods, names))
    assert tslices.fragmentation_report(ts.state.tensors()) == jslices.fragmentation_report(
        js.state.tensors())
