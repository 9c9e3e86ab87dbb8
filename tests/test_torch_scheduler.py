"""The slice as a whole: TorchBatchScheduler on the CPU equals the
reference's TPUBatchScheduler and the host oracle — on the greedy family
(both pinned to mode="greedy") and on the default mode="auto", where both
route each batch to the greedy scan, the wavefront or the auction by its
padded size and its gangs.

SchedulingBasic's node-default / pod-default shape (4 CPU, 32Gi, 110 pods,
zone-$index_mod8; pods 100m / 500Mi) at a small node count, with bound
init pods.  Placements, reasons, feasible counts, scores and the
post-solve usage are compared exactly — the same encoded input, the same
float32 operation order, integer-valued scores.
"""

import numpy as np
import pytest
import torch

from kubernetes_tpu.models.batch_scheduler import TPUBatchScheduler
from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu.testing.oracle import Oracle
from kubernetes_tpu_torch.models.batch_scheduler import TorchBatchScheduler
from kubernetes_tpu_torch.testing import wrappers as tw
from kubernetes_tpu_torch.testing.cases import basic_objects, gang_objects, mixed_objects


def basic_nodes(w, n):
    return [
        w.make_node(f"node-{i}").capacity(cpu_milli=4000, mem=32 * w.GI, pods=110)
        .zone(f"zone-{i % 8}").obj()
        for i in range(n)
    ]


def basic_pods(w, n, prefix):
    return [w.make_pod(f"{prefix}-{i}").req(cpu_milli=100, mem=500 * w.MI).obj() for i in range(n)]


def assert_last_result_equal(jsched, tsched):
    jr, tr = jsched.last_result, tsched.last_result
    for f in ("assignment", "scores", "feasible_counts", "reasons"):
        assert np.array_equal(np.asarray(getattr(jr, f)), getattr(tr, f).numpy()), f
    for f in ("requested", "nonzero_requested"):
        assert np.array_equal(np.asarray(getattr(jr.cluster, f)), getattr(tr.cluster, f).numpy()), f


def test_scheduling_basic_incremental():
    """add_node + assume + schedule_pending, two batches, then node churn."""
    js, ts = TPUBatchScheduler(mode="greedy"), TorchBatchScheduler(device="cpu")
    jn, tn = basic_nodes(jw, 40), basic_nodes(tw, 40)
    for a, b in zip(jn, tn):
        js.add_node(a)
        ts.add_node(b)
    ji, ti = basic_pods(jw, 30, "init"), basic_pods(tw, 30, "init")
    jnames, tnames = js.schedule_pending(ji), ts.schedule_pending(ti)
    assert jnames == tnames and None not in tnames
    assert_last_result_equal(js, ts)
    init_names = tnames
    for a, b, name in zip(ji, ti, tnames):
        js.assume(a, name)
        ts.assume(b, name)
    jm, tm = basic_pods(jw, 70, "measured"), basic_pods(tw, 70, "measured")
    jnames, tnames = js.schedule_pending(jm), ts.schedule_pending(tm)
    assert jnames == tnames and None not in tnames
    assert_last_result_equal(js, ts)
    assert set(ts.last_timings) == {
        "encode_s", "compile_s", "solve_s", "decode_wait_s", "decode_overlap_s"
    }

    # the oracle, fed the same bound init pods, places the batch identically
    init_bound = [
        jw.make_pod(f"init-{i}").req(cpu_milli=100, mem=500 * jw.MI).node_name(name).obj()
        for i, name in enumerate(init_names)
    ]
    assert Oracle(jn, bound_pods=init_bound).schedule(basic_pods(jw, 70, "measured")) == tnames

    # node churn: remove, forget, re-add, and solve again
    for name in ("node-3", "node-17", "node-39"):
        js.remove_node(name)
        ts.remove_node(name)
    js.forget(ji[0])
    ts.forget(ti[0])
    js.add_node(jn[17])
    ts.add_node(tn[17])
    jnames, tnames = js.schedule_pending(basic_pods(jw, 20, "late")), ts.schedule_pending(basic_pods(tw, 20, "late"))
    assert jnames == tnames
    assert_last_result_equal(js, ts)


@pytest.mark.parametrize("seed", [0, 2])
def test_one_shot_schedule_mixed(seed):
    """schedule(nodes, pending, bound) on mixed batches: the reference, the
    port and the oracle agree.  The oracle solves in list order and has no
    gangs, so priorities and gangs are stripped here (both are held
    against the reference in test_torch_assign.py and below)."""
    jn, jp, jb = mixed_objects(jw, seed)
    tn, tp, tb = mixed_objects(tw, seed)
    for p in jp + tp:
        p.spec.scheduling_group = None
        p.spec.priority = 0
    js, ts = TPUBatchScheduler(mode="greedy"), TorchBatchScheduler(device="cpu")
    want = js.schedule(jn, jp, jb)
    got = ts.schedule(tn, tp, tb)
    assert got == want == Oracle(jn, bound_pods=jb).schedule(jp)
    assert_last_result_equal(js, ts)


def test_one_shot_scheduling_basic_matches_oracle():
    jn, tn = basic_nodes(jw, 24), basic_nodes(tw, 24)
    bound = [jw.make_pod(f"b-{i}").req(cpu_milli=100, mem=500 * jw.MI).node_name(f"node-{i % 24}").obj() for i in range(20)]
    tbound = [tw.make_pod(f"b-{i}").req(cpu_milli=100, mem=500 * tw.MI).node_name(f"node-{i % 24}").obj() for i in range(20)]
    got = TorchBatchScheduler(device="cpu").schedule(tn, basic_pods(tw, 50, "p"), tbound)
    want = TPUBatchScheduler(mode="greedy").schedule(jn, basic_pods(jw, 50, "p"), bound)
    assert got == want == Oracle(jn, bound_pods=bound).schedule(basic_pods(jw, 50, "p"))


def test_gang_admission_retry_matches_reference():
    """Scarcity: every gang goes partial, so the admission retry's binary
    search admits gangs by priority — same names as the reference."""
    def build(w):
        nodes = [w.make_node(f"n{i}").capacity(cpu_milli=2000, mem=8 * w.GI, pods=110).obj() for i in range(3)]
        pods = []
        for g in range(3):
            for m in range(3):
                pods.append(w.make_pod(f"g{g}-{m}").req(cpu_milli=900).group(f"g{g}").priority(g).obj())
        return nodes, pods
    jn, jp = build(jw)
    tn, tp = build(tw)
    want = TPUBatchScheduler(mode="greedy").schedule(jn, jp)
    got = TorchBatchScheduler(mode="greedy", device="cpu").schedule(tn, tp)
    assert got == want
    assert sum(n is not None for n in got) == 6


def test_default_device_is_the_card():
    """With no CUDA device, TorchBatchScheduler() raises instead of
    solving on the CPU."""
    if torch.cuda.is_available():
        assert TorchBatchScheduler().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchBatchScheduler()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchBatchScheduler(device="cuda")


def test_modes():
    """auto | greedy | auction, as in the reference package; "auction"
    now solves (it raised before the auction was ported)."""
    with pytest.raises(ValueError):
        TorchBatchScheduler(mode="wavefront", device="cpu")
    nodes, pods, _ = basic_objects(tw, 8, 20)
    for mode, want in (("greedy", "greedy"), ("auction", "auction"), ("auto", "greedy")):
        ts = TorchBatchScheduler(mode=mode, device="cpu")
        for n in nodes:
            ts.add_node(n)
        _, meta = ts.encode_pending(pods)
        assert meta.route == want
        assert None not in ts.schedule_pending(pods)


def test_unported_family_raises_through_the_scheduler():
    """A slice carve-out batch (shaped pods on slice-labelled nodes, with
    anti-affinity) through the scheduler: the port places it as
    TPUBatchScheduler does, on the scan, every result field equal."""
    ts, js = TorchBatchScheduler(device="cpu"), TPUBatchScheduler()
    names = {}
    for sched, w in ((ts, tw), (js, jw)):
        nodes = [n for n in basic_nodes(w, 4)]
        for i, n in enumerate(nodes):
            n.meta.labels.update({w.api.LABEL_TPU_SLICE: "s0", w.api.LABEL_TPU_TOPOLOGY: "2x2x1",
                                  w.api.LABEL_TPU_COORDS: f"{i % 2},{i // 2},0"})
        pod = w.make_pod("s").pod_anti_affinity({"app": "a"}).obj()
        pod.spec.tpu_topology = "2x1x1"
        names[w] = sched.schedule(nodes, [pod])
    assert names[tw] == names[jw] and names[tw][0] is not None
    assert_last_result_equal(js, ts)
    assert ts.last_result.frag_score is not None
    assert float(ts.last_result.frag_score) == float(js.last_result.frag_score)


def test_reservations_overlay_usage():
    """A nominated reservation fills its node in this snapshot only: the
    port and TPUBatchScheduler(mode="greedy") given the same nodes, pods
    and reservation agree on names and every last_result field, and
    neither keeps the reservation in its live state."""
    js, ts = TPUBatchScheduler(mode="greedy"), TorchBatchScheduler(device="cpu")
    for a, b in zip(basic_nodes(jw, 2), basic_nodes(tw, 2)):
        js.add_node(a)
        ts.add_node(b)
    jbig = jw.make_pod("nominated").req(cpu_milli=3950, mem=500 * jw.MI).obj()
    tbig = tw.make_pod("nominated").req(cpu_milli=3950, mem=500 * tw.MI).obj()
    jnames = js.schedule_pending(basic_pods(jw, 2, "p"), reservations=[("node-0", jbig)])
    tnames = ts.schedule_pending(basic_pods(tw, 2, "p"), reservations=[("node-0", tbig)])
    assert tnames == jnames == ["node-1", "node-1"]
    assert_last_result_equal(js, ts)
    assert not ts.state.requested[:2, 0].any()


def assert_route_results_equal(js, ts):
    """Every last_result field of either result type, and the wave
    telemetry DeviceSolve read back, exactly."""
    jr, tr = js.last_result, ts.last_result
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
        assert np.array_equal(np.asarray(a), b.numpy()), f
    for f in ("requested", "nonzero_requested"):
        assert np.array_equal(np.asarray(getattr(jr.cluster, f)), getattr(tr.cluster, f).numpy()), f
    assert (js.last_solve is None) == (ts.last_solve is None)
    if ts.last_solve is not None:  # the one-shot schedule() keeps none
        assert js.last_solve.wave_count == ts.last_solve.wave_count
        assert js.last_solve.wave_fallbacks == ts.last_solve.wave_fallbacks


ROUTE_CASES = {
    # name: (builder, route): 20 pods pad to 32, 100 to 128, 600 to 1,024
    "greedy-20": (lambda w: basic_objects(w, 16, 20, seed=1), "greedy"),
    "wavefront-100": (lambda w: basic_objects(w, 24, 100, seed=2), "wavefront"),
    "auction-600": (lambda w: basic_objects(w, 40, 600, seed=3), "auction"),
    "auction-gangs": (lambda w: gang_objects(w), "auction"),
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_default_route_matches_reference(case):
    """TorchBatchScheduler() and TPUBatchScheduler(), both on their
    defaults: the same route, the same names, every last_result field."""
    build, route = ROUTE_CASES[case]
    jn, jp, _ = build(jw)
    tn, tp, _ = build(tw)
    js, ts = TPUBatchScheduler(), TorchBatchScheduler(device="cpu")
    for a, b in zip(jn, tn):
        js.add_node(a)
        ts.add_node(b)
    _, jmeta = js.encode_pending(jp)
    _, tmeta = ts.encode_pending(tp)
    assert jmeta.route == tmeta.route == route
    assert jmeta.tie_k == tmeta.tie_k
    if route == "wavefront":
        assert np.array_equal(jmeta.wave_plan.members, tmeta.wave_plan.members)
    jnames, tnames = js.schedule_pending(jp), ts.schedule_pending(tp)
    assert jnames == tnames
    assert_route_results_equal(js, ts)
    if route == "auction":
        assert int(ts.last_result.rounds) >= 1


def test_default_route_incremental_and_one_shot():
    """SchedulingBasic's shape on defaults: a 600-pod init batch (auction)
    assumed, then a 100-pod batch (wavefront), then the one-shot
    schedule() of a gang batch (auction) — names and results equal the
    reference's at every step."""
    js, ts = TPUBatchScheduler(), TorchBatchScheduler(device="cpu")
    for a, b in zip(basic_nodes(jw, 64), basic_nodes(tw, 64)):
        js.add_node(a)
        ts.add_node(b)
    ji, ti = basic_pods(jw, 600, "init"), basic_pods(tw, 600, "init")
    jnames, tnames = js.schedule_pending(ji), ts.schedule_pending(ti)
    assert jnames == tnames and None not in tnames
    assert_route_results_equal(js, ts)
    assert type(ts.last_result).__name__ == "AuctionResult"
    for a, b, name in zip(ji, ti, tnames):
        js.assume(a, name)
        ts.assume(b, name)
    jnames = js.schedule_pending(basic_pods(jw, 100, "m"))
    tnames = ts.schedule_pending(basic_pods(tw, 100, "m"))
    assert jnames == tnames
    assert_route_results_equal(js, ts)
    assert ts.last_solve.wave_count is not None
    jn, jp, _ = gang_objects(jw, n_gangs=5)
    tn, tp, _ = gang_objects(tw, n_gangs=5)
    js1, ts1 = TPUBatchScheduler(), TorchBatchScheduler(device="cpu")
    assert js1.schedule(jn, jp) == ts1.schedule(tn, tp)
    assert_route_results_equal(js1, ts1)
