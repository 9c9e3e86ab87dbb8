"""The port's columnar encoder against its per-object encoder and against the
reference package's columnar encoder.

Three builders are fed identically — the reference's with `columnar` on
(its default), the port's with `columnar` on (its default) and the port's
with `columnar` off (the per-object parity oracle) — each over its own
ClusterState and its own package's objects, made from one numpy seed.
Every batch's Snapshot must be equal across the three, leaf for leaf
(dtype, shape and every value), and so must the stable selector and
preferred ids and the expansion watermark.  Exact: the encoder is integer
and bitset bookkeeping plus float32 copies of integer quantities.

The cases mirror tests/test_encoder_parity.py (randomized multi-batch
runs, vocabulary growth, resource-axis growth, empty and padded batches)
and add two staleness gates of the persistent spec store that it reaches
only inside other cases: a taint that arrives after a tolerating spec was
cached, and a node_name pod encoded before its node exists (its "-2" row
resolving once the node is added).
"""

import numpy as np
import pytest

from kubernetes_tpu.api import types as japi
from kubernetes_tpu.ops import schema as jschema
from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu_torch.api import types as tapi
from kubernetes_tpu_torch.ops import schema as tschema
from kubernetes_tpu_torch.testing import wrappers as tw

# (package, columnar): the reference's default, the port's default, the
# port's per-object oracle
SIDES = (("ref", True), ("port", True), ("port", False))
PKG = {"ref": (jschema, jw, japi), "port": (tschema, tw, tapi)}
N_NODES = 300


def test_columnar_is_the_default():
    assert tschema.SnapshotBuilder().columnar is True
    assert jschema.SnapshotBuilder().columnar is True


def _states():
    out = []
    for pkg, columnar in SIDES:
        schema = PKG[pkg][0]
        b = schema.SnapshotBuilder()
        b.columnar = columnar
        out.append((pkg, b, schema.ClusterState(b)))
    return out


def _each(states, fn):
    """fn(wrappers, api, state) on every side, with its own package."""
    for pkg, _b, st in states:
        _schema, wr, api = PKG[pkg]
        fn(wr, api, st)


def _pods(make):
    """make(wrappers, api) -> pods, once a package (the same objects)."""
    return {pkg: make(PKG[pkg][1], PKG[pkg][2]) for pkg in PKG}


def _assert_snap_equal(sa, sb, what):
    for table in jschema.Snapshot._fields:
        ta, tb = getattr(sa, table), getattr(sb, table)
        assert type(ta)._fields == type(tb)._fields, (what, table)
        for f in type(ta)._fields:
            a, b = np.asarray(getattr(ta, f)), np.asarray(getattr(tb, f))
            assert a.dtype == b.dtype, (what, table, f, a.dtype, b.dtype)
            assert a.shape == b.shape, (what, table, f, a.shape, b.shape)
            assert np.array_equal(a, b), (what, table, f)


def _snap_all(states, pods, hint=0):
    """Build `pods` on every side; all three equal.  Returns the port's
    columnar Snapshot."""
    got = []
    for pkg, b, st in states:
        snap, meta = b.build_from_state(st, pods[pkg], num_pods_hint=hint)
        got.append((pkg, b, snap, meta))
    _, b0, s0, m0 = got[0]
    for pkg, b, s, m in got[1:]:
        what = f"{pkg} columnar={b.columnar}"
        _assert_snap_equal(s0, s, what)
        assert m.sel_stable == m0.sel_stable, what
        assert m.pref_stable == m0.pref_stable, what
        assert b.expansion_watermark() == b0.expansion_watermark(), what
        assert m.num_pods == m0.num_pods and list(m.node_names) == list(m0.node_names)
    return got[1][2]


def _node(wr, api, i, extra_label=None, taint=None):
    w = (
        wr.make_node(f"n{i}")
        .capacity(cpu_milli=16000, mem=32 * wr.GI, pods=32)
        .zone(f"z{i % 3}")
        .label("disk", "ssd" if i % 2 else "hdd")
        .label("tier", ["a", "b", "c"][i % 3])
    )
    if extra_label:
        w = w.label(*extra_label)
    if taint:
        w = w.taint(*taint)
    return w.obj()


def _random_pod(wr, api, rng, i, known_nodes):
    """tests/test_encoder_parity.py's random pod, over either package."""
    p = wr.make_pod(f"p{i}").req(
        cpu_milli=int(rng.choice([100, 250, 1000])),
        mem=int(rng.choice([wr.GI, 2 * wr.GI])),
    )
    if rng.random() < 0.3:
        p = p.req(**{"example.com/widgets": int(rng.integers(1, 4))})
    if rng.random() < 0.2:
        p = p.node_name(
            rng.choice(known_nodes) if rng.random() < 0.7
            else f"future-n{int(rng.integers(0, 4))}"
        )
    if rng.random() < 0.3:
        p = p.node_selector(disk=str(rng.choice(["ssd", "hdd"])))
    if rng.random() < 0.3:
        p = p.toleration(key="dedicated", op=api.OP_EQUAL,
                         value=str(rng.choice(["infra", "batch"])),
                         effect=api.NO_SCHEDULE)
    if rng.random() < 0.2:
        p = p.toleration(op=api.OP_EXISTS)
    if rng.random() < 0.25:
        p = p.host_port(int(rng.choice([8080, 9090, 9443])))
    if rng.random() < 0.3:
        op = rng.choice([api.OP_IN, api.OP_NOT_IN, api.OP_EXISTS])
        vals = () if op == api.OP_EXISTS else ("a", "b")
        p = p.required_affinity("tier", op, vals)
    if rng.random() < 0.25:
        p = p.preferred_affinity(int(rng.integers(1, 100)), "disk",
                                 api.OP_IN, ("ssd",))
    if rng.random() < 0.2:
        p = p.spread(topology_key=api.LABEL_ZONE, selector={"app": "x"})
    if rng.random() < 0.15:
        p = p.group(f"g{int(rng.integers(0, 3))}")
    p = p.priority(int(rng.integers(0, 5)))
    return p.obj()


def _cluster(states, n=N_NODES):
    _each(states, lambda wr, api, st: [st.add_node(_node(wr, api, i)) for i in range(n)])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_columnar_matches_per_object_and_reference_randomized(seed):
    """Four batches on one incremental state, fresh pods plus a
    re-shuffled half of the earlier ones (warm rows in the store)."""
    states = _states()
    _cluster(states)
    known = [f"n{i}" for i in range(N_NODES)]
    # one generator a package, seeded alike: the same draws in the same
    # order make the same objects on both sides
    rngs = {pkg: np.random.default_rng(seed) for pkg in PKG}
    prev = {pkg: [] for pkg in PKG}
    for _batch in range(4):
        batch = {}
        for pkg, rng in rngs.items():
            _schema, wr, api = PKG[pkg]
            fresh = [_random_pod(wr, api, rng, int(rng.integers(0, 10_000)), known)
                     for _ in range(int(rng.integers(1, 24)))]
            resample = [prev[pkg][j] for j in rng.permutation(len(prev[pkg]))[: len(prev[pkg]) // 2]]
            batch[pkg] = fresh + resample
            prev[pkg].extend(fresh)
        _snap_all(states, batch)


def test_columnar_parity_across_vocab_growth():
    """A node add that (a) resolves an unknown node_name, (b) grows the
    taint vocabulary under a tolerated key, (c) grows the label ids under
    a referenced selector key."""
    states = _states()
    _cluster(states)

    def make(wr, api):
        return [
            wr.make_pod("named").req(cpu_milli=100).node_name("late-node").obj(),
            wr.make_pod("tol").req(cpu_milli=100)
            .toleration(key="dedicated", op=api.OP_EXISTS, effect=api.NO_SCHEDULE).obj(),
            wr.make_pod("sel").req(cpu_milli=100).required_affinity("tier", api.OP_EXISTS).obj(),
            wr.make_pod("selnot").req(cpu_milli=100)
            .required_affinity("tier", api.OP_NOT_IN, ("z",)).obj(),
        ]

    pods = _pods(make)
    _snap_all(states, pods)
    _each(states, lambda wr, api, st: st.add_node(
        wr.make_node("late-node").capacity(cpu_milli=8000, mem=8 * wr.GI).zone("z0").obj()))
    snap = _snap_all(states, pods)
    assert (np.asarray(snap.pods.name_id)[:1] >= 0).all()
    _each(states, lambda wr, api, st: st.add_node(
        _node(wr, api, N_NODES + 8, taint=("dedicated", "batch", api.NO_SCHEDULE))))
    _snap_all(states, pods)
    _each(states, lambda wr, api, st: st.add_node(
        _node(wr, api, N_NODES + 9, extra_label=("tier", "z"))))
    _snap_all(states, pods)


def test_columnar_parity_across_resource_axis_growth():
    """A later batch with a new scalar resource widens the resource axis;
    cached rows zero-widen exactly, before and after."""
    states = _states()
    _cluster(states)

    def base(wr, api):
        return [wr.make_pod("a").req(cpu_milli=100).obj(),
                wr.make_pod("b").req(cpu_milli=250, mem=wr.GI).obj()]

    def grown(wr, api):
        return base(wr, api) + [
            wr.make_pod("c").req(cpu_milli=100, **{"vendor.io/gadgets": 2}).obj()]

    before = _snap_all(states, _pods(base))
    after = _snap_all(states, _pods(grown))
    assert after.pods.req.shape[1] > before.pods.req.shape[1]
    _snap_all(states, _pods(base))


@pytest.mark.parametrize("n_pods,hint", [(0, 0), (1, 32), (17, 0)])
def test_columnar_empty_and_padded_batches(n_pods, hint):
    states = _states()
    _cluster(states)
    snap = _snap_all(states, _pods(lambda wr, api: [
        wr.make_pod(f"x{i}").req(cpu_milli=10).obj() for i in range(n_pods)]), hint=hint)
    assert int(np.asarray(snap.pods.valid).sum()) == n_pods


def test_columnar_taint_after_tolerating_spec_cached():
    """A tolerating spec is encoded and cached before any node carries a
    taint under its key; the taint's arrival re-encodes the cached row, so
    the next batch's toleration bits cover it (and equal the oracle's)."""
    states = _states()
    _cluster(states, n=40)

    def make(wr, api):
        return [
            wr.make_pod("tol-eq").req(cpu_milli=100)
            .toleration(key="gpu", op=api.OP_EQUAL, value="yes", effect=api.NO_SCHEDULE).obj(),
            wr.make_pod("tol-exists").req(cpu_milli=100)
            .toleration(key="gpu", op=api.OP_EXISTS).obj(),
            wr.make_pod("plain").req(cpu_milli=100).obj(),
        ]

    pods = _pods(make)
    cached = _snap_all(states, pods)
    bits_before = np.asarray(cached.pods.tol_bits).copy()
    _each(states, lambda wr, api, st: st.add_node(
        _node(wr, api, 90, taint=("gpu", "yes", api.NO_SCHEDULE))))
    after = _snap_all(states, pods)
    bits_after = np.asarray(after.pods.tol_bits)
    # the tolerating rows changed, the plain pod's did not
    assert not np.array_equal(bits_before[:, :2], bits_after[:, :2])
    assert np.array_equal(bits_before[:, 2], bits_after[:, 2])


def test_columnar_node_name_pod_before_its_node():
    """A node_name pod encoded before its node exists is a "-2" row; once
    the node is added the cached row resolves to the node's id."""
    states = _states()
    _cluster(states, n=40)
    pods = _pods(lambda wr, api: [
        wr.make_pod("early").req(cpu_milli=100).node_name("n-later").obj(),
        wr.make_pod("free").req(cpu_milli=100).obj(),
    ])
    snap = _snap_all(states, pods)
    assert int(np.asarray(snap.pods.name_id)[0]) == -2
    _each(states, lambda wr, api, st: st.add_node(
        wr.make_node("n-later").capacity(cpu_milli=8000, mem=8 * wr.GI).zone("z1").obj()))
    snap = _snap_all(states, pods)
    name_id = int(np.asarray(snap.pods.name_id)[0])
    assert name_id >= 0
    assert int(np.asarray(snap.pods.name_id)[1]) == -1
