"""The elastic node axis through the port's residents, on the CPU.

Node adds inside the pad bucket are row deltas; a bucket crossing grows
the resident mirror and the partials' columns in place (a pad on the
device, then the deltas) and stays bit-identical to a full rebuild
(`incremental_grow = False`, the oracle); invalidation, rollback and
compaction still hold across it.  Each case runs the port's
TorchBatchScheduler(device="cpu") or mirror beside the reference's, fed
the same objects, and holds placements, resident tensors and counters
equal.
"""

import numpy as np
import pytest
import torch

from kubernetes_tpu.models.batch_scheduler import TPUBatchScheduler
from kubernetes_tpu.models.mirror import DeviceClusterMirror as JMirror
from kubernetes_tpu.ops import schema as jschema
from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu_torch.models.batch_scheduler import TorchBatchScheduler
from kubernetes_tpu_torch.models.mirror import DeviceClusterMirror as TMirror
from kubernetes_tpu_torch.ops import schema as tschema
from kubernetes_tpu_torch.testing import wrappers as tw


def _canon(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _node(w, name, zone="z-0", cpu=8000):
    return w.make_node(name).capacity(cpu_milli=cpu, mem=16 * w.GI, pods=110).zone(zone).obj()


def _pods(w, prefix, n, zone=None):
    out = []
    for i in range(n):
        p = w.make_pod(f"{prefix}-{i}").req(cpu_milli=100, mem=64 * w.MI)
        if zone is not None:
            p = p.node_selector_kv("topology.kubernetes.io/zone", zone)
        out.append(p.obj())
    return out


class Pair:
    """TPUBatchScheduler and TorchBatchScheduler(device="cpu") on the same
    objects; every solve compared field for field."""

    def __init__(self, **kw):
        self.j = TPUBatchScheduler(mode="greedy", use_partials=True, **kw)
        self.t = TorchBatchScheduler(mode="greedy", device="cpu", **kw)

    def add(self, name, zone="z-0"):
        self.j.add_node(_node(jw, name, zone))
        self.t.add_node(_node(tw, name, zone))

    def remove(self, name):
        self.j.remove_node(name)
        self.t.remove_node(name)

    def solve(self, prefix, n, zone=None):
        names = self.j.schedule_pending(_pods(jw, prefix, n, zone))
        assert self.t.schedule_pending(_pods(tw, prefix, n, zone)) == names
        jr, tr = self.j.last_result, self.t.last_result
        for f in ("assignment", "scores", "feasible_counts", "reasons"):
            np.testing.assert_array_equal(np.asarray(getattr(jr, f)), getattr(tr, f).numpy(),
                                          err_msg=f)
        np.testing.assert_array_equal(np.asarray(jr.cluster.requested),
                                      tr.cluster.requested.numpy())
        assert self.t._mirror.stats() == self.j._mirror.stats()
        jp = dict(self.j._partials.stats())
        assert self.t._partials.stats() == jp
        return names


def _assert_resident(mirror, state):
    dev = mirror.sync()
    want = state.tensors()
    for f in tschema.ClusterTensors._fields:
        np.testing.assert_array_equal(getattr(dev, f).numpy(), _canon(getattr(want, f)),
                                      err_msg=f"leaf {f} diverged")
    return dev


def test_within_bucket_add_is_delta_only():
    """Nodes added inside the pad bucket ride the delta: no full upload,
    no resize, and the warm partials rows survive."""
    pair = Pair()
    for i in range(40):  # bucket 64
        pair.add(f"n-{i}", zone=f"z-{i % 3}")
    pair.solve("w0", 6, zone="z-0")
    pair.solve("w1", 6, zone="z-1")
    m0, p0 = dict(pair.t._mirror.stats()), dict(pair.t._partials.stats())
    slots0 = set(pair.t._partials._slots)
    for i in range(40, 45):
        pair.add(f"n-{i}", zone=f"z-{i % 3}")
    names = pair.solve("w2", 6, zone="z-2")
    assert all(n is not None for n in names)
    m1, p1 = pair.t._mirror.stats(), pair.t._partials.stats()
    assert m1["resync_total"] == m0["resync_total"]
    assert m1["grow_syncs"] == m0["grow_syncs"]
    assert m1["delta_rows_total"] > m0["delta_rows_total"]
    assert p1["full_recomputes"] == p0["full_recomputes"]
    assert slots0 <= set(pair.t._partials._slots)
    assert p1["hit_rows_total"] > p0["hit_rows_total"]


def test_node_churn_does_not_flush_partials():
    """Every new node interns a fresh hostname; the per-key expansion
    watermark ignores keys no selector references, so churn stays warm."""
    pair = Pair()
    for i in range(12):
        pair.add(f"n-{i}", zone=f"z-{i % 3}")
    pair.solve("w0", 6, zone="z-0")
    pair.solve("w1", 6, zone="z-1")
    full0 = pair.t._partials.full_recomputes
    for r in range(3):
        pair.remove(f"n-{r}")
        pair.add(f"fresh-{r}", zone=f"z-{r % 3}")
        assert all(n is not None for n in pair.solve(f"c{r}", 4, zone="z-1"))
    assert pair.t._partials.full_recomputes == full0


def test_bucket_oscillation_under_dwell_is_quiet():
    """Add/remove oscillation across a bucket boundary: one eager grow,
    then the shrink dwell pins the bucket — no more resizes, no full
    uploads, no partials reseeds."""
    pair = Pair()
    pair.j.state.configure_elastic_axis(shrink_dwell=8)
    pair.t.state.configure_elastic_axis(shrink_dwell=8)
    for i in range(15):  # bucket 16, one below the boundary
        pair.add(f"n-{i}", zone=f"z-{i % 3}")
    pair.solve("w0", 6, zone="z-0")
    pair.solve("w1", 6, zone="z-1")
    m0, p0 = dict(pair.t._mirror.stats()), dict(pair.t._partials.stats())
    shapes = set()
    for k in range(6):
        for j in range(3):
            if k % 2 == 0:
                pair.add(f"osc-{k}-{j}")
            else:
                pair.remove(f"osc-{k - 1}-{j}")
        assert all(n is not None for n in pair.solve(f"o{k}", 4, zone="z-1"))
        shapes.add(int(pair.t._mirror.sync().allocatable.shape[0]))
    m1, p1 = pair.t._mirror.stats(), pair.t._partials.stats()
    assert m1["resync_total"] == m0["resync_total"]
    assert m1["grow_syncs"] == m0["grow_syncs"] + 1
    assert shapes == {32}
    assert p1["full_recomputes"] == p0["full_recomputes"]
    assert p1["grows"] == p0["grows"] + 1


def _crossing():
    """The elastic port, its full-rebuild oracle and the reference, driven
    across the 8 -> 16 bucket crossing."""
    pair = Pair()
    oracle = TorchBatchScheduler(mode="greedy", device="cpu")
    oracle._mirror.incremental_grow = False
    oracle._partials.incremental_grow = False
    for i in range(8):
        pair.add(f"n-{i}", zone=f"z-{i % 3}")
        oracle.add_node(_node(tw, f"n-{i}", f"z-{i % 3}"))
    for prefix, zone in (("w0", "z-0"), ("w1", "z-1")):
        names = pair.solve(prefix, 6, zone=zone)
        assert oracle.schedule_pending(_pods(tw, prefix, 6, zone)) == names
    for i in range(8, 10):
        pair.add(f"g-{i}", zone="z-1")
        oracle.add_node(_node(tw, f"g-{i}", "z-1"))
    names = pair.solve("x", 8, zone="z-1")
    assert oracle.schedule_pending(_pods(tw, "x", 8, "z-1")) == names
    return pair, oracle


@pytest.fixture(scope="module")
def crossed():
    """One crossing shared by the cases that read it (the reconcile case
    invalidates the residents after the others have read them)."""
    return _crossing()


def test_crossing_grow_bit_identical(crossed):
    pair, oracle = crossed
    el = pair.t
    assert el._mirror.grow_syncs >= 1
    assert el._mirror.resync_total < oracle._mirror.resync_total
    assert el._partials.grows >= 1
    a, b = el._mirror.sync(), oracle._mirror.sync()
    for f in tschema.ClusterTensors._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f"leaf {f} diverged after grow"
    assert el._partials.verify(el._mirror.sync())


def test_reconcile_invalidate_after_grow(crossed):
    """After an in-place grow, invalidate() still forces one full upload
    and one full recompute, as in the reference."""
    pair, _oracle = crossed
    r0 = pair.t._mirror.resync_total
    f0 = pair.t._partials.full_recomputes
    for s in (pair.j, pair.t):
        s._mirror.invalidate()
        s._partials.invalidate()
    assert all(n is not None for n in pair.solve("post", 4, zone="z-0"))
    assert pair.t._mirror.resync_total == r0 + 1
    assert pair.t._partials.full_recomputes == f0 + 1
    _assert_resident(pair.t._mirror, pair.t.state)


def _states(n):
    js, ts = jschema.ClusterState(), tschema.ClusterState()
    for i in range(n):
        js.add_node(_node(jw, f"n-{i}", f"z-{i % 3}"))
        ts.add_node(_node(tw, f"n-{i}", f"z-{i % 3}"))
    return js, ts


def test_speculation_rollback_across_grow():
    """A bookmark taken before a bucket crossing rolls back cleanly: the
    next sync grows again from the bookmarked resident and lands on the
    live tensors, with the reference's counts."""
    js, ts = _states(8)
    jm, tm = JMirror(js), TMirror(ts, device="cpu")
    jm.sync()
    tm.sync()
    jpoint, tpoint = jm.speculation_point(), tm.speculation_point()
    for i in range(8, 11):
        js.add_node(_node(jw, f"g-{i}"))
        ts.add_node(_node(tw, f"g-{i}"))
    _assert_resident(tm, ts)
    jm.sync()
    assert tm.grow_syncs == 1 and tm.stats() == jm.stats()
    assert tpoint[0].allocatable.shape[0] == 8  # the bookmark kept its shape
    jm.rollback(jpoint)
    tm.rollback(tpoint)
    _assert_resident(tm, ts)
    jm.sync()
    js.add_pod(jw.make_pod("p").req(cpu_milli=100, mem=jw.MI).obj(), "n-0")
    ts.add_pod(tw.make_pod("p").req(cpu_milli=100, mem=tw.MI).obj(), "n-0")
    _assert_resident(tm, ts)
    jm.sync()
    assert tm.stats() == jm.stats()


def test_compaction_keeps_mirror_consistent():
    """Bounded compaction moves rows over several remove_node calls; each
    intermediate state delta-syncs exactly (moved rows are dirty rows, not
    struct events), with the reference's counts."""
    js, ts = _states(48)
    for s in (js, ts):
        s.configure_elastic_axis(compaction_batch_rows=4, shrink_dwell=2)
    jm, tm = JMirror(js), TMirror(ts, device="cpu")
    jm.sync()
    tm.sync()
    struct0 = ts.struct_generation
    for i in range(40):
        js.remove_node(f"n-{i}")
        ts.remove_node(f"n-{i}")
        if i % 5 == 0:
            _assert_resident(tm, ts)
            jm.sync()
            assert tm.stats() == jm.stats()
    for k in range(4):  # serve the dwell
        js.add_pod(jw.make_pod(f"t-{k}").req(cpu_milli=1, mem=1).obj(), "n-44")
        ts.add_pod(tw.make_pod(f"t-{k}").req(cpu_milli=1, mem=1).obj(), "n-44")
        _assert_resident(tm, ts)
        jm.sync()
    assert tm.stats() == jm.stats()
    assert ts.struct_generation == struct0
    assert ts.node_axis_bucket <= 16
    assert tm.grow_syncs >= 1  # the shrink was in place


@pytest.mark.parametrize("grow", [True, False])
def test_resize_resident_matches_full_upload(grow):
    """The in-place resize (pad of default rows, or a slice) followed by
    the delta equals a fresh full upload of the new bucket, leaf for leaf
    (the fills are ClusterState._alloc's defaults)."""
    ts = tschema.ClusterState()
    ts.configure_elastic_axis(shrink_dwell=1)
    n0 = 8 if grow else 20
    for i in range(n0):
        ts.add_node(_node(tw, f"n-{i}"))
    tm = TMirror(ts, device="cpu")
    tm.sync()
    if grow:
        for i in range(n0, n0 + 3):
            ts.add_node(_node(tw, f"n-{i}"))
    else:
        for i in range(15, n0):  # 20 -> 15 nodes: bucket 32 -> 16
            ts.remove_node(f"n-{i}")
        for k in range(3):
            ts.add_pod(tw.make_pod(f"d-{k}").req(cpu_milli=1, mem=1).obj(), "n-0")
            tm.sync()
    dev = _assert_resident(tm, ts)
    fresh = TMirror(ts, device="cpu").sync()
    for f in tschema.ClusterTensors._fields:
        assert torch.equal(getattr(dev, f), getattr(fresh, f)), f
    assert tm.grow_syncs >= 1 and tm.resync_total == 1
