"""The port's extender, proto service and evaluate_single equal the reference's.

The ten cases of tests/test_extender.py and the three Python cases of
tests/test_protoserver.py run through the port (TorchBatchScheduler on the
CPU, so every kernel wrapper runs its plain version) and, on the same
objects, through the reference; every verb's result must equal the
reference backend's, and the reference tests' own assertions still hold.
The stores are the reference's `Store` (the backend is duck-typed over
list, get and update).  evaluate_single is held to the reference's on
mixed, spread, inter-pod, preferred, image and slice-anchor cases (both
policies), bit for bit; and snapshot.proto messages cross between the two
packages' generated modules in both directions.
"""

import json
import urllib.request

import numpy as np
import pytest

from kubernetes_tpu.api import store as st
from kubernetes_tpu.extender import ExtenderBackend as JBackend
from kubernetes_tpu.extender.protoserver import ProtoBackend as JProtoBackend
from kubernetes_tpu.extender.types import ExtenderArgs as JArgs
from kubernetes_tpu.ops import assign as jassign
from kubernetes_tpu.ops import schema as jschema
from kubernetes_tpu.proto import snapshot_pb2 as jpb
from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu_torch.extender import ExtenderBackend, ExtenderServer
from kubernetes_tpu_torch.extender.protoserver import (
    ProtoBackend,
    ProtoSchedulerServer,
    solve_over_socket,
)
from kubernetes_tpu_torch.extender.types import ExtenderArgs
from kubernetes_tpu_torch.models.batch_scheduler import TorchBatchScheduler
from kubernetes_tpu_torch.ops import assign as tassign
from kubernetes_tpu_torch.ops import device as dv
from kubernetes_tpu_torch.proto import snapshot_pb2 as tpb
from kubernetes_tpu_torch.testing import cases
from kubernetes_tpu_torch.testing import wrappers as tw

GI, MI = jw.GI, jw.MI

FILTER_REQUEST_FIXTURE = {
    "Pod": {
        "metadata": {"name": "p1", "namespace": "default", "labels": {"app": "web"}},
        "spec": {
            "containers": [
                {
                    "name": "c",
                    "resources": {"requests": {"cpu": "500m", "memory": "512Mi"}},
                }
            ]
        },
    },
    "Nodes": None,
    "NodeNames": ["n0", "n1", "tiny"],
}


class Pair:
    """The reference's backend and the port's, driven alike; each verb
    returns the port's result after checking it equals the reference's."""

    def __init__(self, jstore=None, tstore=None):
        self.j = JBackend(store=jstore)
        self.t = ExtenderBackend(TorchBatchScheduler(device="cpu"), store=tstore)

    def add_node(self, build):
        self.j.add_node(build(jw))
        self.t.add_node(build(tw))

    def verb(self, name, body):
        jarg = JArgs.from_dict(body) if name in ("filter", "prioritize") else body
        targ = ExtenderArgs.from_dict(body) if name in ("filter", "prioritize") else body
        want = getattr(self.j, name)(jarg)
        got = getattr(self.t, name)(targ)
        assert got == want, (name, got, want)
        return got


def _pair():
    be = Pair()
    be.add_node(lambda w: w.make_node("n0").capacity(cpu_milli=4000, mem=8 * GI, pods=10).obj())
    be.add_node(lambda w: w.make_node("n1").capacity(cpu_milli=4000, mem=8 * GI, pods=10).obj())
    be.add_node(lambda w: w.make_node("tiny").capacity(cpu_milli=100, mem=128 * MI, pods=10).obj())
    return be


def test_filter_result_wire_shape():
    res = _pair().verb("filter", FILTER_REQUEST_FIXTURE)
    assert set(res.keys()) == {
        "Nodes", "NodeNames", "FailedNodes", "FailedAndUnresolvableNodes", "Error"}
    assert sorted(res["NodeNames"]) == ["n0", "n1"]
    assert "tiny" in res["FailedNodes"] and res["Error"] == ""
    json.dumps(res)


def test_prioritize_wire_shape():
    out = _pair().verb("prioritize", FILTER_REQUEST_FIXTURE)
    assert isinstance(out, list)
    for item in out:
        assert set(item.keys()) == {"Host", "Score"} and 0 <= item["Score"] <= 10
    by_host = {i["Host"]: i["Score"] for i in out}
    assert by_host["tiny"] == 0 and max(by_host.values()) == 10


def test_filter_non_cache_mode_ships_nodes():
    req = {
        "Pod": FILTER_REQUEST_FIXTURE["Pod"],
        "Nodes": {"items": [{"metadata": {"name": "fresh"},
                             "status": {"capacity": {"cpu": "4", "memory": "8Gi", "pods": "10"}}}]},
        "NodeNames": None,
    }
    assert Pair().verb("filter", req)["NodeNames"] == ["fresh"]


def test_filter_respects_taints_and_affinity():
    be = Pair()
    be.add_node(lambda w: w.make_node("tainted").capacity(cpu_milli=4000, mem=8 * GI, pods=10)
                .taint("dedicated", "gpu").obj())
    be.add_node(lambda w: w.make_node("plain").capacity(cpu_milli=4000, mem=8 * GI, pods=10).obj())
    req = dict(FILTER_REQUEST_FIXTURE, NodeNames=["tainted", "plain"])
    assert be.verb("filter", req)["NodeNames"] == ["plain"]


def test_bind_through_store():
    jstore, tstore = st.Store(), st.Store()
    jstore.create(jw.make_pod("p1").req(cpu_milli=100).obj())
    tstore.create(tw.make_pod("p1").req(cpu_milli=100).obj())
    be = _pair()
    be.j.store, be.t.store = jstore, tstore
    res = be.verb("bind", {"PodName": "p1", "PodNamespace": "default", "PodUID": "u", "Node": "n0"})
    assert res == {"Error": ""}
    assert tstore.get("Pod", "p1").spec.node_name == "n0"


def test_preemption_passthrough():
    victims = {"n0": {"Pods": [{"UID": "u1"}], "NumPDBViolations": 0}}
    assert _pair().verb("preemption", {"NodeNameToMetaVictims": victims}) == {
        "NodeNameToMetaVictims": victims}


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req) as r:
        return json.load(r)


def test_http_server_end_to_end():
    be = _pair()
    srv = ExtenderServer(be.t).start()
    try:
        url = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(url + "/healthz") as r:
            assert json.load(r) == {"ok": True}
        res = _post(url + "/filter", FILTER_REQUEST_FIXTURE)
        assert res == be.j.filter(JArgs.from_dict(FILTER_REQUEST_FIXTURE))
        assert sorted(res["NodeNames"]) == ["n0", "n1"]
        scores = _post(url + "/prioritize", FILTER_REQUEST_FIXTURE)
        assert scores == be.j.prioritize(JArgs.from_dict(FILTER_REQUEST_FIXTURE))
        assert {i["Host"] for i in scores} == {"n0", "n1", "tiny"}
    finally:
        srv.stop()


def test_sync_store_accounts_bound_pods():
    be = Pair()
    for sched, w in ((be.j, jw), (be.t, tw)):
        store = st.Store()
        store.create(w.make_node("n0").capacity(cpu_milli=1000, mem=8 * GI, pods=10).obj())
        store.create(w.make_pod("existing").req(cpu_milli=900).node_name("n0").obj())
        sched.sync_store(store)
    req = {"Pod": {"metadata": {"name": "big"},
                   "spec": {"containers": [{"resources": {"requests": {"cpu": "500m"}}}]}},
           "Nodes": None, "NodeNames": ["n0"]}
    assert be.verb("filter", req)["NodeNames"] == []


def test_filter_non_cache_mode_echoes_node_objects():
    req = {
        "Pod": FILTER_REQUEST_FIXTURE["Pod"],
        "Nodes": {"items": [
            {"metadata": {"name": "okay"},
             "status": {"capacity": {"cpu": "4", "memory": "8Gi", "pods": "10"}}},
            {"metadata": {"name": "small"},
             "status": {"capacity": {"cpu": "100m", "memory": "64Mi", "pods": "10"}}},
        ]},
        "NodeNames": None,
    }
    res = Pair().verb("filter", req)
    assert [d["metadata"]["name"] for d in res["Nodes"]["items"]] == ["okay"]
    assert res["NodeNames"] == ["okay"]


def test_bind_accounts_capacity_in_extender_state():
    jstore, tstore = st.Store(), st.Store()
    jstore.create(jw.make_pod("a").req(cpu_milli=900).obj())
    tstore.create(tw.make_pod("a").req(cpu_milli=900).obj())
    be = Pair(jstore, tstore)
    be.add_node(lambda w: w.make_node("n0").capacity(cpu_milli=1000, mem=8 * GI, pods=10).obj())
    assert be.verb("bind", {"PodName": "a", "PodNamespace": "default", "Node": "n0"}) == {
        "Error": ""}
    req = {"Pod": {"metadata": {"name": "b"},
                   "spec": {"containers": [{"resources": {"requests": {"cpu": "500m"}}}]}},
           "Nodes": None, "NodeNames": ["n0"]}
    assert be.verb("filter", req)["NodeNames"] == []


# -- the proto service ---------------------------------------------------------


def _request(pb, n_nodes=50, n_pods=500, used_cpu=0.0, gangs=0):
    req = pb.SolveRequest()
    req.cluster.resources.names.extend(["cpu", "memory", "pods"])
    req.cluster.allocatable.rows = n_nodes
    req.cluster.allocatable.cols = 3
    for i in range(n_nodes):
        req.cluster.node_names.append(f"node-{i}")
        req.cluster.allocatable.data.extend([32000.0, 64.0 * MI, 110.0])
    if used_cpu:
        req.cluster.requested.rows = n_nodes
        req.cluster.requested.cols = 3
        for i in range(n_nodes):
            req.cluster.requested.data.extend([used_cpu, 0.0, 1.0])
    req.pods.requests.rows = n_pods
    req.pods.requests.cols = 3
    for i in range(n_pods):
        req.pods.pod_names.append(f"pod-{i}")
        req.pods.requests.data.extend([500.0, 0.5 * MI, 1.0])
        if gangs:
            req.pods.group_ids.append(f"gang-{i % gangs}")
    return req


def proto_round_trip(**kw):
    """The port's server answers a request serialised by the reference's
    generated module; the answer equals the reference backend's, but for
    solve_seconds."""
    jreq = _request(jpb, **kw)
    srv = ProtoSchedulerServer(ProtoBackend(device="cpu")).start()
    try:
        treq = tpb.SolveRequest()
        treq.ParseFromString(jreq.SerializeToString())
        resp = solve_over_socket("127.0.0.1", srv.port, treq)
    finally:
        srv.stop()
    want = JProtoBackend().solve(jreq)
    got = jpb.SolveResponse()
    got.ParseFromString(resp.SerializeToString())
    got.solve_seconds = want.solve_seconds = 0.0
    assert got == want
    return resp


def test_python_round_trip_500_pods():
    resp = proto_round_trip()
    placed = [a for a in resp.assignments if a.node_name]
    assert len(resp.assignments) == 500 and len(placed) == 500
    per_node = {}
    for a in placed:
        assert a.node_name == f"node-{a.node_index}"
        per_node[a.node_name] = per_node.get(a.node_name, 0) + 1
    assert max(per_node.values()) <= 110


def test_requested_rows_constrain_capacity():
    resp = proto_round_trip(used_cpu=30000.0)
    assert len([a for a in resp.assignments if a.node_name]) == 200
    assert {r for a, r in zip(resp.assignments, resp.reasons) if not a.node_name}


def test_gang_groups_all_or_nothing():
    resp = proto_round_trip(used_cpu=30000.0, gangs=10)
    by_gang = {}
    for i, a in enumerate(resp.assignments):
        by_gang.setdefault(f"gang-{i % 10}", []).append(bool(a.node_name))
    for gang, placed in by_gang.items():
        assert all(placed) or not any(placed), gang
    assert any(all(p) for p in by_gang.values())


def test_proto_messages_cross_both_ways():
    """The port's messages live in a private descriptor pool beside the
    reference's, and the wire format is the same in both directions."""
    jreq = _request(jpb, n_nodes=3, n_pods=4, used_cpu=100.0, gangs=2)
    treq = tpb.SolveRequest()
    treq.ParseFromString(jreq.SerializeToString())
    assert treq.SerializeToString() == jreq.SerializeToString()
    assert list(treq.pods.group_ids) == list(jreq.pods.group_ids)
    tresp = tpb.SolveResponse(solve_seconds=0.25)
    tresp.assignments.add(pod_name="p", node_name="n", node_index=2)
    tresp.reasons.extend([-1, 7])
    jresp = jpb.SolveResponse()
    jresp.ParseFromString(tresp.SerializeToString())
    assert (jresp.assignments[0].node_index, list(jresp.reasons), jresp.solve_seconds) == (
        2, [-1, 7], 0.25)
    assert tpb.DESCRIPTOR.pool is not jpb.DESCRIPTOR.pool


# -- evaluate_single -----------------------------------------------------------


def _eval_objects(name):
    if name == "mixed":
        return cases.mixed_objects(jw, 1)
    if name == "spread":
        return cases.spread_objects(jw, 2)
    if name == "interpod":
        return cases.interpod_objects(jw, 0)
    if name == "preferred":
        return cases.prefpod_objects(jw, 0)
    if name == "image":
        return cases.image_objects(jw, 0)
    nodes, pods, bound, _ = cases.random_slice_objects(jw, 3)
    pods = [p for p in pods if p.spec.tpu_topology] + [p for p in pods if not p.spec.tpu_topology]
    return nodes, pods, bound


def bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32)).view(np.int32)


@pytest.mark.parametrize("name,policy", [
    ("mixed", "prefer"), ("spread", "prefer"), ("interpod", "prefer"), ("preferred", "prefer"),
    ("image", "prefer"), ("slices", "prefer"), ("slices", "require")])
def test_evaluate_single_matches_reference(name, policy):
    """Pod by pod (up to 8 of the case's pending pods, each alone in its
    snapshot, over the case's nodes and bound pods): (feasible, scores)
    equal to the reference's, scores bit for bit."""
    nodes, pods, bound = _eval_objects(name)
    checked = sliced = 0
    for pod in pods[:8]:
        snap, _ = jschema.SnapshotBuilder().build(nodes, [pod], bound_pods=bound)
        jf = jassign.features_of(snap, slice_policy=policy)
        wf, ws = jassign.evaluate_single(snap, features=jf)
        tsnap = dv.to_device(dv.snapshot_from_numpy(snap), "cpu")
        tf = tassign.features_of(tsnap, slice_policy=policy)
        assert tuple(tf) == tuple(jf)
        gf, gs = tassign.evaluate_single(tsnap, features=tf)
        assert np.array_equal(np.asarray(wf), gf.numpy()), pod.meta.name
        assert np.array_equal(bits(ws), bits(gs.numpy())), (pod.meta.name, ws, gs)
        checked += int(np.asarray(wf).any())
        sliced += int(jf.slices)
    assert checked
    assert bool(sliced) == (name == "slices")
