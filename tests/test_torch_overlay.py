"""The reservations overlay adds nominated pods' requests in reservation order.

Past float32's exact range (memory requests that are not whole MiB, on a
node already holding more than 4,096 MiB of them) the order of additions
decides the rounding.  The reference adds a snapshot's reservations with
one scatter-add in reservation order; on the card torch's index_add adds a
row's duplicates by atomics in no fixed order, so the port adds them in
ranks (ops/device.py add_rows_in_order): launch j adds every node's j-th
reservation, and no launch names a node twice.  These tests pin that
order on the CPU; chip_smoke.py holds the card to it.
"""

import numpy as np
import torch

from kubernetes_tpu.models.batch_scheduler import TPUBatchScheduler
from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu_torch.models.batch_scheduler import TorchBatchScheduler
from kubernetes_tpu_torch.ops import device as dv
from kubernetes_tpu_torch.testing import wrappers as tw


def sequential(start: np.ndarray, rows, vals) -> np.ndarray:
    """float32 adds one after another, in list order."""
    out = start.astype(np.float32).copy()
    for r, v in zip(rows, vals):
        out[r] = np.float32(out[r] + v)
    return out


def discriminating_case():
    """Rows and values past the exact range where reservation order and its
    reverse round differently (a seeded search)."""
    rng = np.random.default_rng(0)
    rows = [0, 1, 0, 0, 1, 0]
    start = np.array([[5.0e9], [4.5e9]], dtype=np.float32)
    for _ in range(1000):
        vals = (rng.integers(1, 400, size=(len(rows), 1)) * 1_000_003).astype(np.float32)
        fwd = sequential(start, rows, vals)
        rev = sequential(start, rows[::-1], vals[::-1])
        if not np.array_equal(fwd, rev):
            return start, rows, vals, fwd
    raise AssertionError("no discriminating case found")


def test_add_rows_in_order_is_reservation_order(monkeypatch):
    start, rows, vals, want = discriminating_case()
    calls = []
    orig = torch.Tensor.index_add

    def spy(self, dim, index, source, **kw):
        calls.append(index.tolist())
        return orig(self, dim, index, source, **kw)

    monkeypatch.setattr(torch.Tensor, "index_add", spy)
    got = dv.add_rows_in_order(torch.from_numpy(start), rows, vals)
    assert np.array_equal(got.numpy(), want)
    # one launch a rank: node 0 has 4 reservations, so 4 launches, and no
    # launch holds a node twice
    assert len(calls) == 4
    assert all(len(set(c)) == len(c) for c in calls)
    # out of place: the resident usage is left as it was
    assert np.array_equal(start, np.array([[5.0e9], [4.5e9]], dtype=np.float32))


def test_fractional_reservations_on_one_node_match_reference():
    """Several nominated pods with 100M memory requests (not whole MiB) on
    one node already past 4,096 MiB of such requests: the overlay's usage
    and the batch's every result field equal TPUBatchScheduler's."""
    js, ts = TPUBatchScheduler(mode="greedy"), TorchBatchScheduler(device="cpu")
    for w, sched in ((jw, js), (tw, ts)):
        for i in range(2):
            sched.add_node(w.make_node(f"node-{i}")
                           .capacity(cpu_milli=64000, mem=64 * w.GI, pods=110).obj())
        for k in range(45):   # 4.5e9 bytes bound on node-0
            sched.assume(w.make_pod(f"bound-{k}").req(cpu_milli=10, mem=100_000_000).obj(),
                         "node-0")
    res = {}
    for w, sched in ((jw, js), (tw, ts)):
        nominated = [("node-0", w.make_pod(f"nom-{k}").req(cpu_milli=10, mem=100_000_000 + 7 * k)
                      .obj()) for k in range(5)] + [
            ("node-1", w.make_pod("nom-x").req(cpu_milli=10, mem=123_456_789).obj())]
        pods = [w.make_pod(f"p-{i}").req(cpu_milli=100, mem=100_000_000).obj() for i in range(3)]
        res[w] = sched.schedule_pending(pods, reservations=nominated)
    assert res[tw] == res[jw]
    jr, tr = js.last_result, ts.last_result
    for f in ("assignment", "scores", "feasible_counts", "reasons"):
        assert np.array_equal(np.asarray(getattr(jr, f)), getattr(tr, f).numpy()), f
    for f in ("requested", "nonzero_requested"):
        assert np.array_equal(np.asarray(getattr(jr.cluster, f)), getattr(tr.cluster, f).numpy()), f
    assert not ts.state.requested[1].any()   # the reservation stays out of the live state
