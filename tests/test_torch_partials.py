"""The port's resident partials against the reference's, on the CPU.

Two layers:

  * the store functions — eval_store, refresh_rows, insert_slots and
    gather_statics (kernel partials_eval's plain version, the row-set of
    the specs, the gather) — against the reference's on the same numpy
    cluster and spec tables carried across, and the gathered warm statics
    against the port's own cold class_statics;
  * TorchBatchScheduler(device="cpu") (mirror and partials on, the
    reference's defaults) against TPUBatchScheduler() on the same objects
    — every batch's assignment, scores, feasible counts, reasons,
    post-solve usage and wave counters, both residents' counters, and
    verify() — and against the cold port (use_mirror=False) as oracle:
    randomized churn on the scan, the wavefront and the auction, and the
    reference's cases (statics equal cold class_statics, gang retry and
    ports, vocab growth, struct growth, speculation rollback, periodic
    resync).

The fault-grade cases (a corrupt or failing solve.partials fault point)
wait for the port's fault points.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from kubernetes_tpu.api import kubeyaml as jkubeyaml
from kubernetes_tpu.models.batch_scheduler import TPUBatchScheduler
from kubernetes_tpu.ops import partials as jpops
from kubernetes_tpu.perf import runner as jrunner
from kubernetes_tpu.perf import workload as jworkload
from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu_torch.analysis import epochs
from kubernetes_tpu_torch.models.batch_scheduler import TorchBatchScheduler
from kubernetes_tpu_torch.ops import assign as tassign
from kubernetes_tpu_torch.ops import device as dv
from kubernetes_tpu_torch.ops import filters as tfilters
from kubernetes_tpu_torch.ops import partials as tpops
from kubernetes_tpu_torch.ops import schema as tschema
from kubernetes_tpu_torch.testing import wrappers as tw
from kubernetes_tpu_torch.testing.cases import Churn, mixed_churn_objects

ROOT = Path(__file__).resolve().parents[1]


def _canon(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(_canon(a)).copy())


class Trio:
    """The reference scheduler, the port's warm scheduler and the port's
    cold one, fed the same objects (each built from its own wrappers)."""

    def __init__(self, cold=True, **kw):
        self.j = TPUBatchScheduler(**kw)
        self.t = TorchBatchScheduler(device="cpu", **kw)
        self.c = TorchBatchScheduler(device="cpu", use_mirror=False, **kw) if cold else None

    def ports(self):
        return [s for s in (self.t, self.c) if s is not None]

    def each(self, fn):
        """Call fn(scheduler, wrappers) on all three."""
        fn(self.j, jw)
        for s in self.ports():
            fn(s, tw)

    def solve(self, build):
        """Schedule build(wrappers) on all three; every result field equal.
        Returns (reference pods, port pods, names)."""
        jp, tp = build(jw), build(tw)
        names = self.j.schedule_pending(jp)
        got = self.t.schedule_pending(tp)
        assert got == names
        assert_results_equal(self.j, self.t)
        if self.c is not None:
            assert self.c.schedule_pending(tp) == names
            assert_results_equal(self.j, self.c)
        return jp, tp, names

    def assume(self, jp, tp, names):
        for a, b, n in zip(jp, tp, names):
            if n is not None:
                self.j.assume(a, n)
                for s in self.ports():
                    s.assume(b, n)

    def check_residents(self):
        assert self.t._mirror.stats() == self.j._mirror.stats()
        jp, tp = self.j._partials, self.t._partials
        if jp is not None:
            assert tp.stats() == jp.stats()
            assert tp.verify(self.t._mirror.sync())


def assert_results_equal(js, ts):
    jr, tr = js.last_result, ts.last_result
    assert (jr is None) == (tr is None)
    if jr is None:
        return
    assert type(jr).__name__ == type(tr).__name__
    fields = ["assignment", "scores", "reasons"]
    if type(tr).__name__ == "AuctionResult":
        fields += ["gang_dropped", "rounds"]
    else:
        fields += ["feasible_counts", "wave_count", "wave_fallbacks"]
    for f in fields:
        a, b = getattr(jr, f), getattr(tr, f)
        if a is None or b is None:
            assert a is None and b is None, f
            continue
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=f)
    for f in ("requested", "nonzero_requested"):
        np.testing.assert_array_equal(np.asarray(getattr(jr.cluster, f)),
                                      getattr(tr.cluster, f).numpy(), err_msg=f)


# -- the store functions on carried-across inputs ---------------------------


@pytest.fixture(scope="module")
def carried():
    """A reference scheduler's resident cluster and spec store after two
    churn batches, as numpy, and the port's tensors of the same."""
    js = TPUBatchScheduler(mode="greedy")
    churn = Churn(jw, 11)
    for nd in churn.nodes(16):
        js.add_node(nd)
    for step in range(2):
        pods = churn.batch(step, 12)
        names = js.schedule_pending(pods)
        Churn.apply(churn.mutate(list(zip(pods, names))), js)
    pods = churn.batch(2, 12)
    snap, meta = js.encode_pending(pods)
    host_snap, _ = js.builder.build_from_state(js.state, pods)
    cluster = [np.asarray(x) for x in snap.cluster]
    specs = [np.asarray(x) for x in js._partials._specs]
    store = [np.asarray(x) for x in js._partials._store]
    return {
        "j": (snap.cluster, js._partials._specs, js._partials._store),
        "cluster": dv.schema.ClusterTensors(*(_t(x) for x in cluster)),
        "specs": tpops.ClassSpecs(*(_t(x) for x in specs)),
        "store": tpops.PartialsStore(*(_t(x) for x in store)),
        "statics": meta.statics, "host_snap": host_snap,
    }


def _assert_store(got, want):
    for f, a, b in zip(tpops.PartialsStore._fields, got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)


def test_eval_store_matches_reference(carried):
    jc, jspecs, jstore = carried["j"]
    got = tpops.eval_store(carried["cluster"], carried["specs"])
    _assert_store(got, jpops.eval_store_jit(jc, jspecs))
    _assert_store(got, jstore)  # the reference's resident store too


@pytest.mark.parametrize("cols", [[0], [3, 4, 9], [15, 2, 7, 11, 1]])
def test_refresh_rows_matches_reference(carried, cols):
    jc, jspecs, jstore = carried["j"]
    idx = np.asarray(cols, np.int32)
    stale = tpops.PartialsStore(*(torch.zeros_like(t) for t in carried["store"]))
    jstale = jpops.PartialsStore(*(np.zeros_like(np.asarray(t)) for t in jstore))
    got = tpops.refresh_rows(stale, carried["specs"], carried["cluster"], torch.from_numpy(idx))
    _assert_store(got, jpops.refresh_rows_jit(jstale, jspecs, jc, idx))
    assert not stale.aff.any()  # out of place: the input store is untouched


@pytest.mark.parametrize("slots", [[0], [1, 2], [2, 0, 1]])
def test_insert_slots_matches_reference(carried, slots):
    jc, jspecs, jstore = carried["j"]
    idx = np.asarray(slots, np.int32)
    stale = tpops.PartialsStore(*(torch.zeros_like(t) for t in carried["store"]))
    jstale = jpops.PartialsStore(*(np.zeros_like(np.asarray(t)) for t in jstore))
    got = tpops.insert_slots(stale, carried["specs"], carried["cluster"], torch.from_numpy(idx))
    _assert_store(got, jpops.insert_slots_jit(jstale, jspecs, jc, idx))


def test_set_spec_rows_and_gather_match_reference(carried):
    """The specs' row-set (through kernel mirror_rows' plain version) and
    the batch-ordered gather, against set_spec_rows and gather_statics."""
    _jc, jspecs, jstore = carried["j"]
    rows_j = jpops.take_specs(jspecs, np.array([2, 0], np.int32))
    g = carried["specs"].valid.shape[0]
    idx = np.array([g - 1, g - 2], np.int32)  # slots no class holds
    assert not carried["specs"].valid[-2:].any()
    want = jpops.set_spec_rows_jit(jspecs, rows_j, idx)
    rows = {f: np.asarray(getattr(rows_j, f)) for f in jpops.ClassSpecs._fields}
    got = tpops.set_spec_rows(carried["specs"], rows, idx, dv.PinnedStage())
    for f, a, b in zip(tpops.ClassSpecs._fields, got, want):
        np.testing.assert_array_equal(a.numpy(), _canon(b), err_msg=f)
    assert got.valid[-2:].all() and not carried["specs"].valid[-2:].any()  # out of place
    slots = np.array([1, 0, 0, 2], np.int32)
    g = tpops.gather_statics(carried["store"], torch.from_numpy(slots))
    w = jpops.gather_statics_jit(jstore, slots)
    for f, a, b in zip(tpops.ClassStatics._fields, g, w):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)


def test_warm_statics_match_cold_class_statics(carried):
    """The reference's gathered statics equal the port's cold class_statics
    (match_terms, then class_statics) on the same resident cluster."""
    snap = dv.snapshot_from_numpy(carried["host_snap"])
    cl, pods, sel, pref = dv.to_device(snap, "cpu")[:4]
    cluster = carried["cluster"]
    sm, pm = tfilters.selector_match(cluster, sel), tfilters.preferred_match(cluster, pref)
    cold = tassign.class_statics(cluster, pods, sm, pm)
    for f, a, b in zip(tpops.ClassStatics._fields, cold, carried["statics"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)


# -- the scheduler, warm against the reference and the cold port -------------


@pytest.mark.parametrize("route", ["greedy", "wavefront", "auction"])
def test_randomized_churn_parity(route):
    """Warm port == reference == cold port across seeded churn (assumes,
    forgets, node updates, node replacement, first-seen classes), with
    the residents' counters equal and the partials serving warm rows."""
    mode = "auction" if route == "auction" else "greedy"
    trio = Trio(mode=mode)
    n_pods = 70 if route == "wavefront" else 10
    churns = {"j": Churn(jw, 7), "t": Churn(tw, 7)}
    # the wavefront's 70-pod batches dirty up to ~45 rows: 100 nodes keep
    # them under half of the padded 128, so later batches are deltas
    n_nodes = 100 if route == "wavefront" else 24
    for nd_j, nd_t in zip(churns["j"].nodes(n_nodes), churns["t"].nodes(n_nodes)):
        trio.j.add_node(nd_j)
        for s in trio.ports():
            s.add_node(nd_t)
    ports = route != "auction"
    for step in range(4):
        jp, tp, names = trio.solve(
            lambda w: churns["j" if w is jw else "t"].batch(step, n_pods, ports=ports))
        assert _route_of(trio.t) == route
        trio.check_residents()
        Churn.apply(churns["j"].mutate(list(zip(jp, names))), trio.j)
        Churn.apply(churns["t"].mutate(list(zip(tp, names))), *trio.ports())
    assert trio.t._mirror.delta_syncs >= 2
    if route != "auction":
        stats = trio.t._partials.stats()
        assert stats["delta_syncs"] >= 2 and stats["hit_rows_total"] > 0


def _route_of(sched) -> str:
    res = sched.last_result
    if type(res).__name__ == "AuctionResult":
        return "auction"
    return "greedy" if res.wave_count is None else "wavefront"


def _nodes(trio, n, seed):
    rng = np.random.default_rng(seed)
    for i in range(n):
        flags = rng.random(3)

        def mk(s, w, i=i, flags=flags):
            nd = (w.make_node(f"n-{i}").capacity(cpu_milli=8000, mem=16 * w.GI, pods=110)
                  .zone(f"z-{i % 3}"))
            if flags[0] < 0.3:
                nd = nd.label("disk", "ssd")
            if flags[1] < 0.2:
                nd = nd.taint("dedicated", "gpu", w.api.PREFER_NO_SCHEDULE)
            if flags[2] < 0.1:
                nd = nd.taint("maint", "true", w.api.NO_SCHEDULE)
            s.add_node(nd.obj())
        trio.each(mk)


def _nodes_one(sched, n):
    for i in range(n):
        sched.add_node(tw.make_node(f"n-{i}").capacity(cpu_milli=8000, mem=16 * tw.GI, pods=110)
                       .zone(f"z-{i % 3}").obj())


def _mixed(step, p):
    """Mixed static specs: selectors, preferred terms, tolerations, host
    ports — every input of the partials triple."""
    def build(w):
        api = w.api
        pods = []
        for i in range(p):
            pw = w.make_pod(f"s{step}-p{i}").req(cpu_milli=[100, 250, 500][(i + step) % 3],
                                                 mem=256 * w.MI)
            r = i % 6
            if r == 0:
                pw = pw.required_affinity(api.LABEL_ZONE, api.OP_IN, [f"z-{i % 3}"])
            elif r == 1:
                pw = pw.preferred_affinity(10, "disk", api.OP_IN, ["ssd"])
            elif r == 2:
                pw = pw.toleration("dedicated", api.OP_EQUAL, "gpu", api.PREFER_NO_SCHEDULE)
            elif r == 3:
                pw = pw.toleration("maint", api.OP_EQUAL, "true", api.NO_SCHEDULE)
            elif r == 4:
                pw = pw.host_port(7000 + (i % 4))
            pods.append(pw.obj())
        return pods
    return build


def test_statics_match_cold_class_statics():
    """The warm triple each batch's solve consumes equals the port's cold
    class_statics on the same resident tensors, array for array, and the
    reference's warm triple."""
    trio = Trio(cold=False, mode="greedy")
    _nodes(trio, 12, 1)
    for step in range(3):
        build = _mixed(step, 10)
        jp, tp = build(jw), build(tw)
        _jsnap, jmeta = trio.j.encode_pending(jp)
        snap, meta = trio.t.encode_pending(tp)
        assert meta.statics is not None
        sm = tfilters.selector_match(snap.cluster, snap.selectors)
        pm = tfilters.preferred_match(snap.cluster, snap.preferred)
        cold = tassign.class_statics(snap.cluster, snap.pods, sm, pm)
        for f, a, b, c in zip(tpops.ClassStatics._fields, meta.statics, cold, jmeta.statics):
            assert torch.equal(a, b), f
            np.testing.assert_array_equal(a.numpy(), np.asarray(c), err_msg=f)
        for i, (a, b) in enumerate(zip(jp, tp)):
            if i % 3 == 0:
                trio.j.assume(a, f"n-{i % 12}")
                trio.t.assume(b, f"n-{i % 12}")
        assert trio.t._partials.verify(trio.t._mirror.sync())


def test_gang_retry_and_ports_parity():
    """Gang batches (all-or-nothing and the admission retry) and in-batch
    host-port conflicts ride the warm path unchanged."""
    trio = Trio(mode="greedy")
    _nodes(trio, 8, 5)
    for step in range(2):
        def build(w, step=step):
            pods = [w.make_pod(f"g{step}-{i}").req(cpu_milli=500, mem=256 * w.MI)
                    .group(f"gang-{i % 2}").obj() for i in range(8)]
            pods += [w.make_pod(f"hp{step}-{i}").req(cpu_milli=100, mem=128 * w.MI)
                     .host_port(9000 + (i % 2)).obj() for i in range(4)]
            return pods
        trio.solve(build)
        trio.check_residents()


def test_vocab_growth_flushes_cache():
    """A selector-relevant vocabulary growing between batches flushes the
    cache whole, and parity holds across the flush."""
    trio = Trio(mode="greedy")
    _nodes(trio, 8, 9)
    trio.solve(_mixed(0, 8))
    full0 = trio.t._partials.full_recomputes
    trio.each(lambda s, w: s.update_node(
        w.make_node("n-1").capacity(cpu_milli=8000, mem=16 * w.GI, pods=110)
        .zone("z-0").label("disk", "nvme").obj()))

    def build(w):
        return [w.make_pod("nv-0").req(cpu_milli=100, mem=128 * w.MI)
                .required_affinity("disk", w.api.OP_IN, ["nvme"]).obj()] + _mixed(1, 6)(w)
    trio.solve(build)
    trio.check_residents()
    assert trio.t._partials.full_recomputes > full0


def test_struct_growth_invalidates():
    """A bulk load across the padded node bucket takes the over-fraction
    full recompute (and a full upload), as in the reference."""
    trio = Trio(mode="greedy")
    _nodes(trio, 8, 11)
    trio.solve(_mixed(0, 8))
    full0 = trio.t._partials.full_recomputes
    for i in range(24):
        trio.each(lambda s, w, i=i: s.add_node(
            w.make_node(f"grow-{i}").capacity(cpu_milli=8000, mem=16 * w.GI, pods=110)
            .zone(f"z-{i % 3}").obj()))
    trio.solve(_mixed(1, 8))
    trio.check_residents()
    assert trio.t._partials.full_recomputes > full0


def test_speculation_rollback_parity():
    """rollback() restores the bookmarked residents (their tensors were
    never written: updates are out of place), the next sync re-refreshes
    everything dirtied since, and parity holds."""
    trio = Trio(mode="greedy")
    _nodes(trio, 12, 13)
    jp0, tp0, names0 = trio.solve(_mixed(0, 10))
    points = {}
    for k, s in (("j", trio.j), ("t", trio.t)):
        points[k] = (s._partials.speculation_point(), s._mirror.speculation_point())
    saved = [t.clone() for t in trio.t._partials._store]
    for k, s, pods in (("j", trio.j, jp0), ("t", trio.t, tp0)):
        w = jw if k == "j" else tw
        for p, n in zip(pods, names0):
            if n is not None:
                s.assume(p, n)
        s.schedule_pending([w.make_pod("spec-0").req(cpu_milli=100, mem=128 * w.MI)
                            .required_affinity(w.api.LABEL_ZONE, w.api.OP_NOT_IN, ["z-1"]).obj()])
        for p, n in zip(pods, names0):
            if n is not None:
                s.forget(p)
        s._mirror.rollback(points[k][1])
        s._partials.rollback(points[k][0])
    for a, b in zip(trio.t._partials._store, saved):
        assert torch.equal(a, b)  # the bookmarked store kept its rows
    assert trio.t._partials.rollbacks == 1
    for p_j, p_t in zip(jp0[:3], tp0[:3]):
        trio.j.assume(p_j, "n-2")
        for s in trio.ports():
            s.assume(p_t, "n-2")
    trio.solve(_mixed(1, 10))
    trio.check_residents()


def test_epoch_audits_are_clean():
    """Armed, the epoch auditor checks every warm batch at consume time
    (the mirror and the partials against the state's generations, and the
    pair at dispatch) and records no violation; a stale stamp is caught."""
    sched = TorchBatchScheduler(device="cpu", mode="greedy")
    _nodes_one(sched, 12)
    with epochs.tracked() as aud:
        for step in range(3):
            pods = _mixed(step, 8)(tw)
            for pod, name in zip(pods, sched.schedule_pending(pods)):
                if name is not None and step < 2:
                    sched.assume(pod, name)
        assert aud.audits_total >= 9 and not aud.violations
        stale = epochs.EpochStamp("mirror", 0, None, -1, 1)
        sched._mirror.epoch = lambda: stale
        sched.assume(tw.make_pod("late").req(cpu_milli=100, mem=tw.MI).obj(), "n-0")
        sched.schedule_pending(_mixed(9, 4)(tw))
        assert any("synced_gen" in v for v in aud.violations)
        with pytest.raises(epochs.CoherenceViolation):
            aud.assert_clean()


def test_periodic_resync_discipline():
    """Every `partials_resync_interval` delta syncs the cache recomputes in
    full (the periodic half of the parity discipline), as the reference."""
    trio = Trio(mode="greedy", partials_resync_interval=2)
    _nodes(trio, 8, 21)
    fulls = []
    for step in range(6):
        jp, tp, _ = trio.solve(_mixed(step, 8))
        trio.check_residents()
        fulls.append(trio.t._partials.full_recomputes)
        for i in range(2):
            trio.j.assume(jp[i], f"n-{(step * 2 + i) % 8}")
            for s in trio.ports():
                s.assume(tp[i], f"n-{(step * 2 + i) % 8}")
    assert fulls[-1] >= 2


# -- SchedulingWithMixedChurn against the repo's scheduler_perf templates ------

def mixed_churn_workload():
    config = ROOT / "kubernetes_tpu" / "perf" / "config" / "performance-config.yaml"
    (wl,) = jworkload.select(jworkload.load_config(str(config)),
                             name="SchedulingWithMixedChurn/5000Nodes")
    return wl


def test_mixed_churn_objects_match_templates():
    """cases.mixed_churn_objects equals SchedulingWithMixedChurn's templates
    rendered as the perf runner renders them (node-default.yaml,
    pod-default.yaml, the churn op's pod-large-cpu.yaml): every array of
    the encoded snapshot, the node and measured pod names; and
    chip_smoke.py runs the 5000Nodes counts and the churn op's number."""
    create_nodes, churn_op, create_pods = mixed_churn_workload().ops
    assert (create_nodes.opcode, churn_op.opcode, create_pods.opcode) == (
        "createNodes", "churn", "createPods")
    (churn_t,) = churn_op.templates

    def render(template, i, make, name=None):
        d = jrunner._substitute_index(template, i)
        meta = d.setdefault("metadata", {})
        meta["name"] = name or f"{meta['generateName']}{i}"
        return make(d)

    nodes = [render(create_nodes.node_template, i, jkubeyaml.node_from_dict) for i in range(24)]
    measured = [render(create_pods.pod_template, i, jkubeyaml.pod_from_dict) for i in range(30)]
    churn = [render(churn_t, i, jkubeyaml.pod_from_dict, f"pod-churn-3-{i}") for i in range(7)]
    got_nodes, got_measured, got_churn = mixed_churn_objects(tw, 24, 30)
    assert [o.meta.name for o in nodes] == [o.meta.name for o in got_nodes]
    assert [o.meta.name for o in measured] == [o.meta.name for o in got_measured]
    want, _ = tschema.SnapshotBuilder().build(nodes, churn + measured)
    got, _ = tschema.SnapshotBuilder().build(got_nodes, got_churn(3, 7) + got_measured)
    for table in want._fields:
        wt, gt = getattr(want, table), getattr(got, table)
        for f in wt._fields:
            a, b = np.asarray(getattr(wt, f)), np.asarray(getattr(gt, f))
            assert a.dtype == b.dtype and a.shape == b.shape, (table, f)
            assert np.array_equal(a, b), (table, f)
    assert float(np.asarray(got.pods.priority)[0]) == 10.0

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.CHURN == (create_nodes.count, create_pods.count)
    assert smoke.CHURN_PODS == churn_op.number
