"""The port's filters and class statics equal the reference's jnp functions.

One snapshot is encoded by the reference package and handed to both: the
jnp functions get jnp arrays, the port gets torch CPU tensors from
snapshot_from_numpy (where every wrapper runs its plain version).  Masks,
integer counts and integer-valued float32 rows are compared exactly: the
functions are boolean algebra and small integer sums, with nothing to
round.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.api import types as japi
from kubernetes_tpu.ops import assign as jassign
from kubernetes_tpu.ops import filters as jfilters
from kubernetes_tpu.ops import schema as jschema
from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu_torch.kernels import bindings
from kubernetes_tpu_torch.ops import assign as tassign
from kubernetes_tpu_torch.ops import device as dv
from kubernetes_tpu_torch.ops import filters as tfilters
from kubernetes_tpu_torch.testing.cases import mixed_objects


def encode(nodes, pods, bound=()):
    snap, _ = jschema.SnapshotBuilder().build(nodes, pods, bound_pods=bound)
    jsnap = jax.tree.map(jnp.asarray, snap)
    tsnap = dv.to_device(dv.snapshot_from_numpy(snap), "cpu")
    return snap, jsnap, tsnap


def same(a, b):
    a = np.asarray(a)
    b = b.numpy()
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def operator_case():
    """Every selector operator over labels and topology slots, taints of
    each effect, tolerations incl. tol_all, NodeName and bound ports."""
    nodes = []
    for i in range(12):
        w = jw.make_node(f"n{i}").zone(f"z{i % 3}").label("gen", str(i % 5))
        if i % 2:
            w = w.label("disk", "ssd")
        if i % 4 == 1:
            w = w.taint("hard", "x", japi.NO_SCHEDULE)
        if i % 4 == 2:
            w = w.taint("soft", "y", japi.PREFER_NO_SCHEDULE).taint("soft2", "", japi.PREFER_NO_SCHEDULE)
        if i % 4 == 3:
            w = w.taint("evict", "z", japi.NO_EXECUTE)
        if i == 11:
            w = w.unschedulable()
        nodes.append(w.obj())
    mk = jw.make_pod
    pods = [
        mk("in").required_affinity("disk", japi.OP_IN, ["ssd"]).obj(),
        mk("notin").required_affinity("gen", japi.OP_NOT_IN, ["1", "2"]).obj(),
        mk("exists").required_affinity("disk", japi.OP_EXISTS).obj(),
        mk("dne").required_affinity("disk", japi.OP_DOES_NOT_EXIST).obj(),
        mk("gt").required_affinity("gen", japi.OP_GT, ["2"]).obj(),
        mk("lt").required_affinity("gen", japi.OP_LT, ["2"]).obj(),
        mk("zone").required_affinity(japi.LABEL_ZONE, japi.OP_IN, ["z1", "z2"]).obj(),
        mk("zone-not").required_affinity(japi.LABEL_ZONE, japi.OP_NOT_IN, ["z1"]).obj(),
        mk("zone-any").required_affinity(japi.LABEL_ZONE, japi.OP_EXISTS).obj(),
        mk("region-none").required_affinity(japi.LABEL_REGION, japi.OP_DOES_NOT_EXIST).obj(),
        mk("host").required_affinity(japi.LABEL_HOSTNAME, japi.OP_IN, ["n4", "n5"]).obj(),
        mk("or").required_affinity("gen", japi.OP_IN, ["0"]).required_affinity("disk", japi.OP_IN, ["ssd"]).obj(),
        mk("absent").required_affinity("disk", japi.OP_IN, ["floppy"]).obj(),
        mk("tol-hard").toleration("hard", japi.OP_EQUAL, "x", japi.NO_SCHEDULE).obj(),
        mk("tol-all").toleration().obj(),
        mk("tol-evict").toleration("evict", japi.OP_EXISTS).obj(),
        mk("tol-soft").toleration("soft", japi.OP_EXISTS, effect=japi.PREFER_NO_SCHEDULE).obj(),
        mk("tol-unsched").toleration(japi.TAINT_NODE_UNSCHEDULABLE, japi.OP_EXISTS).obj(),
        mk("named").node_name("n6").obj(),
        mk("named-unknown").node_name("nowhere").obj(),
        mk("port").host_port(80).obj(),
        mk("pref").preferred_affinity(30, "disk", japi.OP_IN, ["ssd"]).preferred_affinity(7, japi.LABEL_ZONE, japi.OP_IN, ["z0"]).obj(),
        mk("pref-neg").preferred_affinity(11, "gen", japi.OP_NOT_IN, ["3"]).obj(),
    ]
    bound = [jw.make_pod(f"b{i}").host_port(80).node_name(f"n{i}").obj() for i in (0, 3, 9)]
    return nodes, pods, bound


CASES = ["operators"] + [f"mixed{s}" for s in range(3)]


def case(name):
    if name == "operators":
        return operator_case()
    return mixed_objects(jw, int(name[len("mixed"):]))


@pytest.mark.parametrize("name", CASES)
def test_selector_and_preferred_match(name):
    _, js, ts = encode(*case(name))
    assert same(jfilters.selector_match(js.cluster, js.selectors),
                tfilters.selector_match(ts.cluster, ts.selectors))
    assert same(jfilters.preferred_match(js.cluster, js.preferred),
                tfilters.preferred_match(ts.cluster, ts.preferred))
    # the per-term AND before the OR, too
    sel = js.selectors
    assert same(
        jfilters.match_terms(js.cluster, sel.expr_ids, sel.expr_op, sel.expr_slot),
        tfilters.match_terms(ts.cluster, ts.selectors.expr_ids,
                             ts.selectors.expr_op, ts.selectors.expr_slot),
    )


@pytest.mark.parametrize("name", CASES)
def test_per_pod_filters(name):
    snap, js, ts = encode(*case(name))
    jsel = jfilters.selector_match(js.cluster, js.selectors)
    tsel = tfilters.selector_match(ts.cluster, ts.selectors)
    for i in range(int(snap.pods.valid.sum())):
        jp, tp = jfilters.pod_view(js.pods, i), tfilters.pod_view(ts.pods, i)
        assert same(jfilters.fits_resources(js.cluster, jp), tfilters.fits_resources(ts.cluster, tp))
        assert same(jfilters.ports_free(js.cluster, jp), tfilters.ports_free(ts.cluster, tp))
        assert same(jfilters.static_feasible_for_pod(js.cluster, jp, jsel),
                    tfilters.static_feasible_for_pod(ts.cluster, tp, tsel))


@pytest.mark.parametrize("name", CASES)
def test_class_statics(name):
    _, js, ts = encode(*case(name))
    jsel = jfilters.selector_match(js.cluster, js.selectors)
    jpref = jfilters.preferred_match(js.cluster, js.preferred)
    want = jassign.class_statics(js.cluster, js.pods, jsel, jpref)
    got = tassign.cold_statics(ts.cluster, ts.pods, ts.selectors, ts.preferred)[:3]
    for w, g in zip(want, got):
        assert same(w, g)


def test_operator_case_exercises_each_stage():
    """The structured case really reaches every branch it is named for."""
    snap, _, ts = encode(*operator_case())
    sel = tfilters.selector_match(ts.cluster, ts.selectors)
    n = 12
    rows = sel[:, :n].sum(dim=1).tolist()
    assert 0 in rows and n in rows and any(0 < r < n for r in rows)
    assert snap.pods.tol_all[:, 14].all()
    assert (snap.pods.name_id == -2).any()
    assert snap.cluster.port_bits.any()


def test_wrappers_never_fall_back_for_device_tensors(monkeypatch):
    """A tensor off the CPU goes to the kernel binding (which launches or
    raises); only CPU tensors reach the plain versions."""
    _, _, ts = encode(*operator_case())
    meta_cluster = type(ts.cluster)(*(t.to("meta") for t in ts.cluster))
    calls = []

    def boom(*args, **kwargs):
        calls.append(args)
        raise RuntimeError("kernel launch attempted")

    monkeypatch.setattr(bindings, "match_terms", boom)
    monkeypatch.setattr(bindings, "class_statics", boom)
    sel = type(ts.selectors)(*(t.to("meta") for t in ts.selectors))
    with pytest.raises(RuntimeError, match="kernel launch attempted"):
        tfilters.selector_match(meta_cluster, sel)
    pods = type(ts.pods)(*(t.to("meta") for t in ts.pods))
    pref = type(ts.preferred)(*(t.to("meta") for t in ts.preferred))
    for want_sel_mask in (False, True):
        with pytest.raises(RuntimeError, match="kernel launch attempted"):
            tassign.cold_statics(meta_cluster, pods, sel, pref, want_sel_mask=want_sel_mask)
    assert len(calls) == 3
    # and the CPU path never touches the bindings
    tfilters.selector_match(ts.cluster, ts.selectors)
    for want_sel_mask in (False, True):
        tassign.cold_statics(ts.cluster, ts.pods, ts.selectors, ts.preferred,
                             want_sel_mask=want_sel_mask)
    assert len(calls) == 3
