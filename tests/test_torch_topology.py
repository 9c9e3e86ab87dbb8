"""The port's PodTopologySpread ops equal the reference's, exactly.

prep_spread, spread_filter, spread_score and spread_update of
kubernetes_tpu_torch/ops/topology.py against kubernetes_tpu/ops/topology.py
(jitted, as the reference's solves run them) on snapshots encoded by the
reference package: zone and hostname keys, hard and soft constraints,
minDomains, a carrier whose labels do not match its own selector, nodes
without the key, bound pods folded in or not (has_bound).  log32 against
jax.jit(jnp.log) on every integer 2..131,074 and on random floats; and
the fused multiply-add of the soft score pinned by an input on which the
unfused form rounds to another integer.  Tolerance 0 everywhere.
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
from kubernetes_tpu.ops import topology as jtopo
from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu_torch.ops import assign as tassign
from kubernetes_tpu_torch.ops import device as dv
from kubernetes_tpu_torch.ops import filters as tfilters
from kubernetes_tpu_torch.ops import schema as tschema
from kubernetes_tpu_torch.ops import topology as ttopo
from kubernetes_tpu_torch.testing.cases import spread_objects

_jfilter = jax.jit(jtopo.spread_filter)
_jscore = jax.jit(jtopo.spread_score)
_jupdate = jax.jit(jtopo.spread_update)


def special_objects():
    """minDomains above the zone count, a carrier whose labels do not
    match its selector (selfMatch 0), nodes without a zone label, a
    hostname constraint and a soft one, with matching bound pods."""
    nodes = [jw.make_node(f"n{i}").capacity(cpu_milli=8000, pods=50).zone(f"z{i % 3}").obj()
             for i in range(8)]
    nodes += [jw.make_node(f"bare{i}").capacity(cpu_milli=8000, pods=50).obj() for i in range(2)]
    pods = [
        jw.make_pod("md").label("app", "a").spread(2, japi.LABEL_ZONE, "DoNotSchedule", {"app": "a"}),
        jw.make_pod("carrier").label("app", "b").spread(1, japi.LABEL_ZONE, "DoNotSchedule",
                                                        {"app": "a"}),
        jw.make_pod("host").label("app", "a").spread(1, japi.LABEL_HOSTNAME, "DoNotSchedule",
                                                     {"app": "a"}),
        jw.make_pod("soft").label("app", "a").spread(3, japi.LABEL_ZONE, "ScheduleAnyway",
                                                     {"app": "a"})
        .spread(2, japi.LABEL_HOSTNAME, "ScheduleAnyway", {"app": "a"}),
    ]
    pods[0].pod.spec.topology_spread_constraints[-1].min_domains = 5
    bound = [jw.make_pod(f"b{i}").label("app", "a").node_name(f"n{i % 4}").obj()
             for i in range(6)]
    return nodes, [p.obj() for p in pods], bound


CASES = {f"seed{s}": (lambda s=s: spread_objects(jw, s)) for s in range(4)}
CASES["special"] = special_objects


def encode(build):
    nodes, pods, bound = build()
    snap, _ = jschema.SnapshotBuilder().build(nodes, pods, bound_pods=bound)
    return snap, dv.to_device(dv.snapshot_from_numpy(snap), "cpu")


def preps(snap, tsnap, has_bound):
    z = jassign.required_topo_z_split(snap)[0]
    assert z == tassign.required_topo_z_split(tsnap)[0]
    jsel = jfilters.selector_match(jax.tree.map(jnp.asarray, snap.cluster),
                                   jax.tree.map(jnp.asarray, snap.selectors))
    tsel = tfilters.selector_match(tsnap.cluster, tsnap.selectors)
    assert np.array_equal(np.asarray(jsel), tsel.numpy())
    js = jax.jit(jtopo.prep_spread, static_argnums=(3, 4, 5))(
        snap.cluster, jsel, snap.spread, z, None, has_bound)
    ts = ttopo.prep_spread(tsnap.cluster, tsel, tsnap.spread, z, has_bound=has_bound)
    return js, ts


def assert_state_equal(js, ts):
    for f in js._fields:
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        assert a.dtype == b.dtype, f
        assert np.array_equal(a, b), f


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("has_bound", [True, False])
def test_prep_filter_score_update_match_reference(case, has_bound):
    snap, tsnap = encode(CASES[case])
    js, ts = preps(snap, tsnap, has_bound)
    assert_state_equal(js, ts)
    p = int(np.asarray(snap.pods.valid).sum())
    rng = np.random.default_rng(len(case))
    n = ts.v.shape[1]
    for i in range(p):
        jf = np.asarray(_jfilter(js, snap.spread, jnp.int32(i)))
        tf = ttopo.spread_filter(ts, tsnap.spread, i)
        assert np.array_equal(jf, tf.numpy()), ("filter", i)
        feas = rng.random(n) < 0.8
        js_ = np.asarray(_jscore(js, snap.spread, jnp.int32(i), jnp.asarray(feas)))
        ts_ = ttopo.spread_score(ts, tsnap.spread, i, torch.from_numpy(feas))
        assert np.array_equal(js_, ts_.numpy()), ("score", i)
        node = int(rng.integers(0, n))
        js = _jupdate(js, snap.spread, jnp.int32(i), js.v[:, node], js.eligible[:, node],
                      jnp.bool_(True))
        ts = ttopo.spread_update(ts, tsnap.spread, i, node)
        assert np.array_equal(np.asarray(js.counts_node), ts.counts_node.numpy()), ("update", i)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("has_bound", [True, False])
def test_filter_of_many_pods_matches_reference(case, has_bound):
    """spread_filter given a tensor of pod indices (the auction's reasons
    pass checks every constraint class at once) equals the reference's
    filter of each pod, padded pods included."""
    snap, tsnap = encode(CASES[case])
    js, ts = preps(snap, tsnap, has_bound)
    p = tsnap.spread.pod_idx.shape[0]
    got = ttopo.spread_filter(ts, tsnap.spread, torch.arange(p).flip(0))
    want = np.stack([np.asarray(_jfilter(js, snap.spread, jnp.int32(i)))
                     for i in reversed(range(p))])
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), want)


def test_special_case_exercises_each_rule():
    """The special batch really has minDomains, selfMatch 0, keyless
    nodes, hostname rows and soft rows."""
    snap, tsnap = encode(special_objects)
    sp = snap.spread
    valid = np.asarray(sp.valid)
    assert (np.asarray(sp.min_domains)[valid] > 0).any()
    assert (~np.asarray(sp.hard)[valid]).any()
    assert len(set(np.asarray(sp.slot)[valid].tolist())) == 2
    pm = np.asarray(sp.pod_matches)
    idx = np.asarray(sp.pod_idx)
    assert not pm[1, idx[1, 0]]  # the carrier does not match its own row
    assert (np.asarray(snap.cluster.topo_ids) < 0).any()
    assert np.asarray(sp.node_matches).any()


def test_log32_equals_xla_log_on_integers():
    """Every integer 2..131,074 (twice the north star's padded hostname
    value count, plus 2): the weights log(sizes + 2) can take."""
    x = np.arange(2, 131_075, dtype=np.float32)
    want = np.asarray(jax.jit(jnp.log)(x))
    got = ttopo.log32(torch.from_numpy(x)).numpy()
    assert np.array_equal(want.view(np.int32), got.view(np.int32))
    # torch's own log is not the reference's
    assert not np.array_equal(want, torch.log(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("lo,hi", [(1e-37, 1e-3), (1e-3, 10.0), (10.0, 1e6), (1e6, 3e38)])
def test_log32_equals_xla_log_on_random_floats(lo, hi):
    rng = np.random.default_rng(int(np.log10(lo)) + 50)
    x = np.exp(rng.uniform(np.log(lo), np.log(hi), 400_000)).astype(np.float32)
    x = np.concatenate([x, np.array([0.0, -0.0, -1.0, np.inf, -np.inf, np.nan, 1e-45, 1.0],
                                    dtype=np.float32)])
    want = np.asarray(jax.jit(jnp.log)(x))
    got = ttopo.log32(torch.from_numpy(x)).numpy()
    same = (want.view(np.int32) == got.view(np.int32)) | (np.isnan(want) & np.isnan(got))
    assert same.all(), x[~same][:5]


def fma_state():
    """One soft row over three nodes; node 0's count is 878 at a
    topology size of 104 and maxSkew 4, where cnt * log(106) + 3 rounds
    to 4,097 when fused and to 4,098 in two steps, which moves node 2's
    normalized score (count 325) from 62 to 63."""
    counts = np.array([[878.0, 0.0, 325.0]], dtype=np.float32)
    state = dict(counts_node=counts, eligible=np.ones((1, 3), bool),
                 v=np.array([[0, 1, 2]], np.int32), sizes=np.array([104.0], np.float32))
    table = dict(
        valid=np.array([True]), slot=np.zeros(1, np.int32), max_skew=np.array([4.0], np.float32),
        min_domains=np.zeros(1, np.float32), hard=np.array([False]),
        owner_sel_idx=np.full(1, -1, np.int32), owner_keys=np.ones((1, 1), bool),
        node_matches=np.zeros((1, 3), np.float32), pod_matches=np.ones((1, 1), bool),
        pod_idx=np.array([[0, -1, -1, -1]], np.int32),
    )
    return state, table


def test_soft_score_fuses_the_multiply_add():
    state, table = fma_state()
    feas = np.ones(3, bool)
    want = np.asarray(_jscore(jtopo.SpreadState(**state), jschema.SpreadTable(**table),
                              jnp.int32(0), jnp.asarray(feas)))
    ts = ttopo.SpreadState(**{k: torch.from_numpy(v) for k, v in state.items()})
    tt = tschema.SpreadTable(**{k: torch.from_numpy(v) for k, v in table.items()})
    got = ttopo.spread_score(ts, tt, 0, torch.from_numpy(feas)).numpy()
    assert np.array_equal(want, got)
    # the same score with the multiply and the add rounded apart differs:
    # the input pins the fusion
    w = ttopo.log32(torch.tensor([106.0]))
    raw = torch.round(torch.from_numpy(state["counts_node"][0]) * w + 3.0)
    assert float(raw[0]) == 4098.0
    mx, mn = float(raw.max()), float(raw.min())
    unfused = torch.floor(100.0 * (mx + mn - raw) / mx).numpy()
    assert not np.array_equal(want, unfused)
