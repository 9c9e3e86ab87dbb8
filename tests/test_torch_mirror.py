"""The port's DeviceClusterMirror against the reference's, on the CPU.

Every case drives the reference mirror (kubernetes_tpu.models.mirror) and
the port's (kubernetes_tpu_torch.models.mirror, device="cpu") over two
ClusterStates built from the same objects and mutated the same way.  After
every sync the port's resident tensors equal state.tensors() exactly, the
reference's do too, and the two mirrors' counters (full uploads, delta
rows, delta syncs, grows) are equal.  Beside the reference's cases:
aliasing (a CPU mirror must copy, not view, the live arrays), "a solve
writes nothing resident", rollback (deltas are out of place, so a bookmark
keeps its contents) and the invalidation fence, and kernel mirror_rows'
plain version against the reference's _set_rows / _set_rows_ax1.
"""

import re
import pathlib

import numpy as np
import pytest
import torch

from kubernetes_tpu.models import mirror as jmirror
from kubernetes_tpu.ops import schema as jschema
from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu_torch.analysis import epochs
from kubernetes_tpu_torch.kernels import bindings
from kubernetes_tpu_torch.models import mirror as tmirror
from kubernetes_tpu_torch.models.batch_scheduler import TorchBatchScheduler
from kubernetes_tpu_torch.ops import device as dv
from kubernetes_tpu_torch.ops import schema as tschema
from kubernetes_tpu_torch.testing import wrappers as tw

PORT = pathlib.Path(__file__).resolve().parent.parent / "kubernetes_tpu_torch"


def _canon(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


class Pair:
    """One reference and one port ClusterState fed the same objects, each
    with a mirror (the port's on the CPU)."""

    def __init__(self, n=12, zones=3, **elastic):
        self.j = jschema.ClusterState()
        self.t = tschema.ClusterState()
        if elastic:
            self.j.configure_elastic_axis(**elastic)
            self.t.configure_elastic_axis(**elastic)
        self.jm = jmirror.DeviceClusterMirror(self.j)
        self.tm = tmirror.DeviceClusterMirror(self.t, device="cpu")
        for i in range(n):
            self.add_node(f"n-{i}", zone=f"z-{i % zones}")

    def both(self, fn):
        """fn(wrappers) -> object, built once per package."""
        return fn(jw), fn(tw)

    def add_node(self, name, cpu=8000, zone="z-0", **extra):
        def mk(w):
            nd = w.make_node(name).capacity(cpu_milli=cpu, mem=16 * w.GI, pods=110, **extra)
            return nd.zone(zone).obj()
        a, b = self.both(mk)
        self.j.add_node(a)
        self.t.add_node(b)

    def call(self, method, fn):
        a, b = self.both(fn)
        getattr(self.j, method)(a)
        getattr(self.t, method)(b)
        return a, b

    def check(self):
        jdev = self.jm.sync()
        tdev = self.tm.sync()
        want = self.t.tensors()
        jwant = self.j.tensors()
        for f in tschema.ClusterTensors._fields:
            w = _canon(getattr(want, f))
            np.testing.assert_array_equal(getattr(tdev, f).numpy(), w, err_msg=f)
            np.testing.assert_array_equal(_canon(getattr(jdev, f)), _canon(getattr(jwant, f)),
                                          err_msg=f"reference {f}")
            np.testing.assert_array_equal(w, _canon(getattr(jwant, f)), err_msg=f"states {f}")
        assert self.tm.stats() == self.jm.stats()
        return tdev


def _pod(w, name, cpu=500, mem_mi=256):
    return w.make_pod(name).req(cpu_milli=cpu, mem=mem_mi * w.MI).obj()


def _pod_usage(pair):
    pair.check()
    pods = [pair.both(lambda w, i=i: _pod(w, f"p-{i}")) for i in range(5)]
    for i, (a, b) in enumerate(pods):
        pair.j.add_pod(a, f"n-{i % 3}")
        pair.t.add_pod(b, f"n-{i % 3}")
    pair.check()
    for k in (0, 3):
        pair.j.remove_pod(pods[k][0])
        pair.t.remove_pod(pods[k][1])


def _node_lifecycle(pair):
    pair.check()
    pair.call("update_node", lambda w: w.make_node("n-1").capacity(
        cpu_milli=32000, mem=64 * w.GI, pods=200).zone("z-9").label("disk", "ssd").obj())
    pair.check()
    pair.j.remove_node("n-2")
    pair.t.remove_node("n-2")
    pair.check()
    pair.call("add_node", lambda w: w.make_node("n-new").capacity(
        cpu_milli=1000, mem=w.GI, pods=10).taint("dedicated", "gpu", w.api.NO_SCHEDULE).obj())


def _growth(pair):
    pair.check()
    gen0 = pair.t.struct_generation
    for i in range(200):  # crosses several buckets at once: a bulk load
        pair.add_node(f"g-{i}", cpu=4000)
    assert pair.t.struct_generation == gen0


def _resource_widen(pair):
    pair.check()
    pair.add_node("tpu-node", **{"google.com/tpu": 8})


def _compaction(pair):
    pair.check()
    for i in range(5, 40):
        pair.j.remove_node(f"n-{i}")
        pair.t.remove_node(f"n-{i}")


def _noop(pair):
    pair.check()


CASES = {
    "initial_and_noop": (12, _noop),
    "pod_usage_deltas": (12, _pod_usage),
    "node_lifecycle_deltas": (12, _node_lifecycle),
    "growth_is_not_a_struct_event": (4, _growth),
    "resource_widen_forces_struct_resync": (12, _resource_widen),
    "compaction_deltas": (40, _compaction),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mirror_matches_reference(case):
    n, drive = CASES[case]
    pair = Pair(n)
    drive(pair)
    pair.check()
    if case == "initial_and_noop":
        a, b = pair.tm.sync(), pair.tm.sync()
        assert a.allocatable is b.allocatable  # no mutation: the same tensors
    if case == "resource_widen_forces_struct_resync":
        assert pair.tm.resync_total == 2
    if case in ("pod_usage_deltas", "node_lifecycle_deltas"):
        assert pair.tm.delta_syncs >= 1 and pair.tm.resync_total == 1


def test_two_mirrors_one_state():
    """Profiles: two consumers sync independently through the shared
    generation counters."""
    pair = Pair()
    second_j = jmirror.DeviceClusterMirror(pair.j)
    second_t = tmirror.DeviceClusterMirror(pair.t, device="cpu")
    pair.check()
    a, b = pair.both(lambda w: _pod(w, "p", cpu=100, mem_mi=1))
    pair.j.add_pod(a, "n-0")
    pair.t.add_pod(b, "n-0")
    second_j.sync()
    second_t.sync()
    a, b = pair.both(lambda w: _pod(w, "q", cpu=100, mem_mi=1))
    pair.j.add_pod(a, "n-1")
    pair.t.add_pod(b, "n-1")
    pair.check()
    dev = second_t.sync()
    second_j.sync()
    assert second_t.stats() == second_j.stats()
    np.testing.assert_array_equal(dev.requested.numpy(), pair.t.tensors().requested)


def test_cpu_mirror_does_not_alias_live_state():
    """On the CPU a device tensor could be the live numpy memory itself; a
    mirror built that way is "always in sync" and every delta test passes
    vacuously.  Mutate the state without syncing: the resident tensors
    must not move."""
    pair = Pair()
    before = {f: t.clone() for f, t in zip(tschema.ClusterTensors._fields, pair.tm.sync())}
    _a, b = pair.both(lambda w: _pod(w, "p", cpu=700))
    pair.t.add_pod(b, "n-0")
    pair.call("update_node", lambda w: w.make_node("n-3").capacity(
        cpu_milli=1000, mem=w.GI, pods=5).label("disk", "ssd").obj())
    dev = pair.tm._dev
    for f in tschema.ClusterTensors._fields:
        assert torch.equal(getattr(dev, f), before[f]), f
    assert not np.array_equal(dev.requested.numpy(), pair.t.tensors().requested)
    synced = pair.tm.sync()  # a delta now brings it up to date
    np.testing.assert_array_equal(synced.requested.numpy(), pair.t.tensors().requested)
    assert pair.tm.delta_syncs == 1


@pytest.mark.parametrize("mode", ["greedy", "wavefront", "auction"])
def test_solve_writes_nothing_resident(mode):
    """After a solve with no assume the resident tensors still equal
    state.tensors(): the solves copy their carries, the reservations
    overlay is out of place, and the cached fills are never written."""
    sched = TorchBatchScheduler(device="cpu", mode="auction" if mode == "auction" else "greedy")
    for i in range(16):
        sched.add_node(tw.make_node(f"n-{i}").capacity(cpu_milli=4000, mem=32 * tw.GI, pods=110)
                       .zone(f"z-{i % 4}").obj())
    n_pods = 8 if mode == "greedy" else 70
    pods = [tw.make_pod(f"p-{i}").req(cpu_milli=100, mem=500 * tw.MI).host_port(80 + i % 3).obj()
            if mode != "auction" else tw.make_pod(f"p-{i}").req(cpu_milli=100, mem=500 * tw.MI).obj()
            for i in range(n_pods)]
    bound = tw.make_pod("b").req(cpu_milli=300, mem=tw.GI).host_port(443).obj()
    sched.assume(bound, "n-2")
    resv = [("n-5", tw.make_pod("r").req(cpu_milli=1000, mem=tw.GI).obj())]
    snap, meta = sched.encode_pending(pods, reservations=resv)
    assert meta.route == mode
    names = sched.solve_encoded(snap, meta)
    assert sum(n is not None for n in names) > 0
    dev = sched._mirror.sync()
    want = sched.state.tensors()
    for f in tschema.ClusterTensors._fields:
        np.testing.assert_array_equal(getattr(dev, f).numpy(), _canon(getattr(want, f)), err_msg=f)
    # the overlay reached the snapshot, not the resident copy
    row = sched.state._rows["n-5"]
    assert float(snap.cluster.requested[row, 0]) > float(dev.requested[row, 0])


def test_rollback_restores_the_bookmark():
    """speculation_point() holds the resident tensors; a later delta must
    write into fresh tensors, so the bookmark still holds the old rows
    (an in-place scatter would corrupt it) and rollback restores them.
    The reference, driven the same way, counts the same."""
    pair = Pair()
    dev0 = pair.check()
    saved = {f: t.clone() for f, t in zip(tschema.ClusterTensors._fields, dev0)}
    tpoint, jpoint = pair.tm.speculation_point(), pair.jm.speculation_point()
    pods = [pair.both(lambda w, i=i: _pod(w, f"s-{i}")) for i in range(3)]
    for i, (a, b) in enumerate(pods):
        pair.j.add_pod(a, f"n-{i}")
        pair.t.add_pod(b, f"n-{i}")
    pair.check()
    assert pair.tm.delta_syncs == 1
    for f, t in zip(tschema.ClusterTensors._fields, tpoint[0]):
        assert torch.equal(t, saved[f]), f"bookmark leaf {f} was written in place"
    for a, b in pods:  # the speculative batch is dropped
        pair.j.remove_pod(a)
        pair.t.remove_pod(b)
    pair.tm.rollback(tpoint)
    pair.jm.rollback(jpoint)
    assert pair.tm._dev.requested is tpoint[0].requested
    assert pair.tm.epoch() == tpoint[4]
    pair.check()  # re-sends every row dirtied since the bookmark
    assert pair.tm.resync_total == 1


def test_rollback_after_invalidate_is_fenced():
    """A bookmark taken before invalidate() must not resurrect the dropped
    buffer: the mirror stays invalidated and the next sync uploads in full
    under a new buffer id."""
    pair = Pair()
    pair.check()
    point = pair.tm.speculation_point()
    old_id = pair.tm.epoch().buffer_id
    with epochs.tracked() as aud:
        pair.tm.invalidate()
        pair.jm.invalidate()
        pair.tm.rollback(point)
        pair.jm.rollback(pair.jm.speculation_point())
    assert aud.rollbacks_blocked == 1
    assert pair.tm._dev is None and pair.tm.epoch() is None
    pair.check()
    assert pair.tm.resync_total == 2
    assert pair.tm.epoch().buffer_id != old_id


def _random_leaf(rng, shape, dtype):
    if dtype == np.bool_:
        return rng.random(shape) < 0.5
    if dtype == np.float32:
        return rng.standard_normal(shape).astype(np.float32)
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(dtype)


@pytest.mark.parametrize("seed", range(3))
def test_mirror_rows_plain_matches_set_rows(seed):
    """Kernel mirror_rows' plain version (one packed buffer, every leaf)
    against the reference's _set_rows (node axis 0) and _set_rows_ax1
    (effect-major, node axis 1) on random leaves of every dtype."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(8, 40))
    specs = [((n, 4), np.float32, 0), ((n,), np.bool_, 0), ((n, 3), np.int32, 0),
             ((n, 16), np.uint32, 0), ((3, n, 8), np.uint32, 1), ((3, n), np.bool_, 1)]
    targets, want = [], []
    for shape, dtype, ax in specs:
        base = _random_leaf(rng, shape, dtype)
        d = int(rng.integers(1, n))
        idx = np.sort(rng.choice(n, d, replace=False)).astype(np.int32)
        vshape = list(shape)
        vshape[ax] = d
        vals = _random_leaf(rng, tuple(vshape), dtype)
        setter = jmirror._set_rows if ax == 0 else jmirror._set_rows_ax1
        want.append(_canon(np.asarray(setter(base, idx, vals))))
        src = torch.from_numpy(_canon(base).copy())
        targets.append(dv.RowTarget(src, ax, idx, vals))
    before = [t.src.clone() for t in targets]
    stage = dv.PinnedStage()
    fresh = dv.set_rows(targets, stage, torch.device("cpu"))
    assert stage.bytes_sent > 0
    for t, f, w, b in zip(targets, fresh, want, before):
        np.testing.assert_array_equal(f.numpy(), w)
        assert torch.equal(t.src, b)  # the old leaf is only read


def test_scheduler_steps_use_mirror():
    """Repeated schedule_pending steps with assumes between them stay
    correct and equal the reference's, batch for batch, with deltas."""
    from kubernetes_tpu.models.batch_scheduler import TPUBatchScheduler

    js, ts = TPUBatchScheduler(), TorchBatchScheduler(device="cpu")
    for w, s in ((jw, js), (tw, ts)):
        for i in range(8):
            s.add_node(w.make_node(f"n-{i}").capacity(cpu_milli=4000, mem=8 * w.GI, pods=20).obj())
    for step in range(4):
        jp = [jw.make_pod(f"s{step}-p{i}").req(cpu_milli=1000, mem=jw.GI).obj() for i in range(3)]
        tp = [tw.make_pod(f"s{step}-p{i}").req(cpu_milli=1000, mem=tw.GI).obj() for i in range(3)]
        jn, tn = js.schedule_pending(jp), ts.schedule_pending(tp)
        assert jn == tn and None not in tn
        np.testing.assert_array_equal(ts.last_result.scores.numpy(), np.asarray(js.last_result.scores))
        for a, b, name in zip(jp, tp, tn):
            js.assume(a, name)
            ts.assume(b, name)
    assert ts._mirror.stats() == js._mirror.stats()
    assert ts._mirror.delta_syncs >= 2
    big_j = [jw.make_pod("big").req(cpu_milli=4000, mem=jw.GI).obj()]
    big_t = [tw.make_pod("big").req(cpu_milli=4000, mem=tw.GI).obj()]
    assert ts.schedule_pending(big_t) == js.schedule_pending(big_j) == [None]


@pytest.mark.parametrize("name", ["partials_eval", "mirror_rows"])
def test_new_launch_signatures_match_bindings(name):
    """The ctypes argument lists of the slice's kernels match their C
    launch signatures, and each source carries its note."""
    src = (PORT / "csrc" / f"{name}.cu").read_text()
    m = re.search(rf'extern "C" int {name}_launch\((.*?)\)\s*\{{', src, re.S)
    assert m, f"{name}_launch not found"
    params = [p.strip() for p in m.group(1).split(",")]
    kinds = ["p" if "*" in p else "i" for p in params]
    want = ["p" if t.__name__ == "c_void_p" else "i" for t in bindings._ARGTYPES[name]]
    assert kinds == want
    assert "Replaces:" in src and "Bound on this card:" in src and "Design:" in src
    assert dv.LEAF_DTYPE.itemsize == bindings.LEAF_BYTES == 64
