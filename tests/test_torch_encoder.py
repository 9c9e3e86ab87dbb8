"""The port's numpy encoder equals the reference package's, array for array.

Both packages build the same objects from one seed (each through its own
wrapper set) and must produce identical Snapshots: every array of every
table, dtype and shape included, compared exactly — the encoder is integer
and bitset bookkeeping plus float32 copies of integer quantities, so there
is no rounding to tolerate.  ClusterState's row, free-list and compaction
discipline is held the same way through add / remove / re-add node and
assume / forget, because node row order decides first-max-index ties.
"""

import numpy as np
import pytest

from kubernetes_tpu.ops import schema as jschema
from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu_torch.ops import device as dv
from kubernetes_tpu_torch.ops import schema as tschema
from kubernetes_tpu_torch.testing import wrappers as tw
from kubernetes_tpu_torch.testing.cases import mixed_objects


def assert_snapshots_equal(js, ts):
    for table in jschema.Snapshot._fields:
        jt, tt = getattr(js, table), getattr(ts, table)
        assert type(jt)._fields == type(tt)._fields, table
        for f in type(jt)._fields:
            a, b = np.asarray(getattr(jt, f)), np.asarray(getattr(tt, f))
            assert a.dtype == b.dtype, (table, f, a.dtype, b.dtype)
            assert a.shape == b.shape, (table, f, a.shape, b.shape)
            assert np.array_equal(a, b), (table, f)


def assert_meta_equal(jm, tm):
    assert jm.num_nodes == tm.num_nodes
    assert jm.num_pods == tm.num_pods
    assert list(jm.node_names) == list(tm.node_names)
    assert list(jm.resource_names) == list(tm.resource_names)
    assert jm.topo_z == tm.topo_z
    assert jm.sel_stable == tm.sel_stable
    assert jm.pref_stable == tm.pref_stable


@pytest.mark.parametrize("seed", range(4))
def test_build_matches_reference(seed):
    jn, jp, jb = mixed_objects(jw, seed)
    tn, tp, tb = mixed_objects(tw, seed)
    js, jm = jschema.SnapshotBuilder().build(jn, jp, bound_pods=jb)
    ts, tm = tschema.SnapshotBuilder().build(tn, tp, bound_pods=tb)
    assert_snapshots_equal(js, ts)
    assert_meta_equal(jm, tm)


def test_build_reads_reference_objects():
    """Field names are identical, so the port's encoder reads the
    reference package's objects by duck typing."""
    jn, jp, jb = mixed_objects(jw, 1)
    js, _ = jschema.SnapshotBuilder().build(jn, jp, bound_pods=jb)
    ts, _ = tschema.SnapshotBuilder().build(jn, jp, bound_pods=jb)
    assert_snapshots_equal(js, ts)


def test_snapshot_from_numpy_round_trip():
    jn, jp, jb = mixed_objects(jw, 2)
    js, _ = jschema.SnapshotBuilder().build(jn, jp, bound_pods=jb)
    ts = dv.snapshot_from_numpy(js)
    assert_snapshots_equal(js, ts)
    as_dict = {t: getattr(js, t)._asdict() for t in jschema.Snapshot._fields}
    assert_snapshots_equal(js, dv.snapshot_from_numpy(as_dict))


def test_to_device_keeps_dtypes_and_bits():
    import torch

    tn, tp, tb = mixed_objects(tw, 0)
    snap, _ = tschema.SnapshotBuilder().build(tn, tp, bound_pods=tb)
    dev = dv.to_device(snap, "cpu")
    for table, ttab in zip(snap, dev):
        for a, t in zip(table, ttab):
            assert isinstance(t, torch.Tensor)
            want = a.view(np.int32) if a.dtype == np.uint32 else a
            assert t.numpy().dtype == want.dtype
            assert np.array_equal(t.numpy(), want)
    # a copy, not a view of the encoder's arrays
    dev.cluster.requested.add_(1.0)
    assert not np.array_equal(dev.cluster.requested.numpy(), snap.cluster.requested)


def _state_pair(columnar: bool = True):
    """Both packages' builders on the same encode path: the columnar one
    (both defaults) or the per-object one."""
    jb = jschema.SnapshotBuilder()
    tb = tschema.SnapshotBuilder()
    jb.columnar = tb.columnar = columnar
    return jschema.ClusterState(jb), tschema.ClusterState(tb)


def _compare_states(js, ts, jpending, tpending):
    jsnap, jm = js.builder.build_from_state(js, jpending)
    tsnap, tm = ts.builder.build_from_state(ts, tpending)
    assert_snapshots_equal(jsnap, tsnap)
    assert_meta_equal(jm, tm)
    assert js._high == ts._high
    assert sorted(js._free_set) == sorted(ts._free_set)
    assert js.node_names == ts.node_names


@pytest.mark.parametrize("columnar", [False, True])
def test_cluster_state_lifecycle(columnar):
    js, ts = _state_pair(columnar)
    jn, jp, jbound = mixed_objects(jw, 3, n_nodes=40, n_pods=30)
    tn, tp, tbound = mixed_objects(tw, 3, n_nodes=40, n_pods=30)
    for a, b in zip(jn, tn):
        js.add_node(a)
        ts.add_node(b)
    for a, b in zip(jbound, tbound):
        js.add_pod(a)
        ts.add_pod(b)
    _compare_states(js, ts, jp, tp)

    # remove a spread of nodes (holes + trailing trim + compaction), then
    # re-add one under its old name and update another in place
    for i in (3, 7, 8, 20, 35, 36, 37, 38, 39, 12, 13, 14, 15, 16, 17, 18):
        js.remove_node(f"n{i}")
        ts.remove_node(f"n{i}")
    _compare_states(js, ts, jp, tp)
    js.add_node(jn[7])
    ts.add_node(tn[7])
    jn[2].meta.labels["disk"] = "nvme"
    tn[2].meta.labels["disk"] = "nvme"
    js.update_node(jn[2])
    ts.update_node(tn[2])
    _compare_states(js, ts, jp, tp)

    # assume / forget: usage and port bits rebuilt from the remaining pods
    placed = [(a, b, f"n{i}") for i, (a, b) in enumerate(zip(jp, tp)) if i in (0, 1, 2, 4, 5)]
    for a, b, node in placed:
        a.spec.node_name = b.spec.node_name = ""
        js.add_pod(a, node)
        ts.add_pod(b, node)
    _compare_states(js, ts, jp[6:], tp[6:])
    for a, b, _node in placed[:3]:
        js.remove_pod(a)
        ts.remove_pod(b)
    _compare_states(js, ts, jp[6:], tp[6:])
    assert js.generation == ts.generation
    assert js.compactions_total == ts.compactions_total


def test_scheduling_basic_state():
    """SchedulingBasic's node-default / pod-default shape with bound init
    pods, grown past one pad bucket."""
    js, ts = _state_pair()
    for i in range(70):
        js.add_node(jw.make_node(f"node-{i}").capacity(cpu_milli=4000, mem=32 * jw.GI, pods=110).zone(f"zone-{i % 8}").obj())
        ts.add_node(tw.make_node(f"node-{i}").capacity(cpu_milli=4000, mem=32 * tw.GI, pods=110).zone(f"zone-{i % 8}").obj())
    for i in range(50):
        js.add_pod(jw.make_pod(f"init-{i}").req(cpu_milli=100, mem=500 * jw.MI).obj(), f"node-{i % 70}")
        ts.add_pod(tw.make_pod(f"init-{i}").req(cpu_milli=100, mem=500 * tw.MI).obj(), f"node-{i % 70}")
    jp = [jw.make_pod(f"m-{i}").req(cpu_milli=100, mem=500 * jw.MI).obj() for i in range(40)]
    tp = [tw.make_pod(f"m-{i}").req(cpu_milli=100, mem=500 * tw.MI).obj() for i in range(40)]
    _compare_states(js, ts, jp, tp)
