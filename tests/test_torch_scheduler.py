"""The slice as a whole: TorchBatchScheduler on the CPU equals the
reference's TPUBatchScheduler(mode="greedy") and the host oracle.

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
from kubernetes_tpu_torch.testing.cases import mixed_objects


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
    got = TorchBatchScheduler(device="cpu").schedule(tn, tp)
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
    with pytest.raises(NotImplementedError):
        TorchBatchScheduler(mode="auction", device="cpu")
    with pytest.raises(ValueError):
        TorchBatchScheduler(mode="wavefront", device="cpu")
    assert TorchBatchScheduler(mode="greedy", device="cpu")._route(None) == "greedy"


def test_unported_family_raises_through_the_scheduler():
    ts = TorchBatchScheduler(device="cpu")
    nodes = basic_nodes(tw, 4)
    pods = [tw.make_pod("s").spread(selector={"app": "a"}).obj()]
    with pytest.raises(NotImplementedError, match="PodTopologySpread"):
        ts.schedule(nodes, pods)


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
