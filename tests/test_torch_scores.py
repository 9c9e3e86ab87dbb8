"""The port's scorers equal the reference's jnp scorers bit for bit.

Every score is a floor of float32 arithmetic that mimics Go's int64
truncation; one ulp of difference before a floor flips a whole point, so
the comparison is exact (np.array_equal on float32) and the port keeps
the jnp operation order.  The cases include floor boundaries, where
(c - q) * 100 / c is an exact integer, and random usage states.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import filters as jfilters
from kubernetes_tpu.ops import schema as jschema
from kubernetes_tpu.ops import scores as jscores
from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu_torch.ops import device as dv
from kubernetes_tpu_torch.ops import filters as tfilters
from kubernetes_tpu_torch.ops import scores as tscores
from kubernetes_tpu_torch.testing.cases import mixed_objects

CONFIGS = {
    "least": dict(),
    "most": dict(fit_strategy="MostAllocated"),
    "rtcr": dict(fit_strategy="RequestedToCapacityRatio",
                 rtcr_shape=((0.0, 0.0), (30.0, 2.0), (60.0, 7.5), (100.0, 10.0))),
    "rtcr-default": dict(fit_strategy="RequestedToCapacityRatio"),
    "weighted": dict(fit_resources=((0, 3.0), (1, 1.0)), balanced_resources=(0, 1),
                     fit_weight=2.0, taint_weight=1.0),
}


def usage_snapshot(seed: int, boundary: bool):
    """A snapshot whose requested / nonzero_requested state is drawn from
    the seed; with boundary=True every usage sits where (c - q) * 100 / c
    or q * 100 / c is an exact integer."""
    nodes, pods, bound = mixed_objects(jw, seed)
    snap, _ = jschema.SnapshotBuilder().build(nodes, pods, bound_pods=bound)
    rng = np.random.default_rng(seed)
    alloc = snap.cluster.allocatable
    n = alloc.shape[0]
    if boundary:
        pct = rng.integers(0, 101, size=(n, alloc.shape[1])).astype(np.float32)
        used = np.floor(alloc * pct / 100.0).astype(np.float32)
        # snap to quantities whose percentage is exact
        used = np.where(alloc % 100 == 0, alloc / 100 * pct, used).astype(np.float32)
    else:
        used = np.floor(alloc * rng.random(alloc.shape)).astype(np.float32)
    req = snap.cluster._replace(requested=used, nonzero_requested=used.copy())
    return snap._replace(cluster=req)


def both(snap):
    return (jax.tree.map(jnp.asarray, snap),
            dv.to_device(dv.snapshot_from_numpy(snap), "cpu"))


def same(a, b):
    a, b = np.asarray(a), b.numpy()
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
@pytest.mark.parametrize("seed,boundary", [(0, True), (1, False), (2, True)])
def test_resource_scorers(cfg_name, seed, boundary):
    js, ts = both(usage_snapshot(seed, boundary))
    jcfg = jscores.ScoreConfig(**CONFIGS[cfg_name])
    tcfg = tscores.ScoreConfig(**CONFIGS[cfg_name])
    p = int(np.asarray(js.pods.valid).sum())
    for i in range(0, p, 3):
        jp, tp = jfilters.pod_view(js.pods, i), tfilters.pod_view(ts.pods, i)
        jfit, jbal = jscores.resource_score_parts(js.cluster, jp, jcfg)
        tfit, tbal = tscores.resource_score_parts(ts.cluster, tp, tcfg)
        assert same(jfit, tfit), (cfg_name, i)
        assert same(jbal, tbal), (cfg_name, i)


@pytest.mark.parametrize("seed", range(3))
def test_each_scorer_and_combine(seed):
    js, ts = both(usage_snapshot(seed, seed % 2 == 0))
    jcfg, tcfg = jscores.DEFAULT_SCORE_CONFIG, tscores.DEFAULT_SCORE_CONFIG
    jpref = jfilters.preferred_match(js.cluster, js.preferred)
    tpref = tfilters.preferred_match(ts.cluster, ts.preferred)
    jsel = jfilters.selector_match(js.cluster, js.selectors)
    tsel = tfilters.selector_match(ts.cluster, ts.selectors)
    p = int(np.asarray(js.pods.valid).sum())
    for i in range(p):
        jp, tp = jfilters.pod_view(js.pods, i), tfilters.pod_view(ts.pods, i)
        for fn in ("least_allocated", "most_allocated",
                   "requested_to_capacity_ratio", "balanced_allocation"):
            assert same(getattr(jscores, fn)(js.cluster, jp, jcfg),
                        getattr(tscores, fn)(ts.cluster, tp, tcfg)), fn
        jaff = jscores.node_affinity_raw(jp, jpref)
        taff = tscores.node_affinity_raw(tp, tpref)
        jtaint = jscores.taint_toleration_raw(js.cluster, jp)
        ttaint = tscores.taint_toleration_raw(ts.cluster, tp)
        assert same(jaff, taff) and same(jtaint, ttaint)
        jfeas = jfilters.static_feasible_for_pod(js.cluster, jp, jsel) & jfilters.fits_resources(js.cluster, jp)
        tfeas = tfilters.static_feasible_for_pod(ts.cluster, tp, tsel) & tfilters.fits_resources(ts.cluster, tp)
        for rev in (False, True):
            assert same(jscores.normalize(jaff, jfeas, reverse=rev),
                        tscores.normalize(taff, tfeas, reverse=rev))
            assert same(jscores.normalize(jtaint, jfeas, reverse=rev),
                        tscores.normalize(ttaint, tfeas, reverse=rev))
        assert same(jscores.score_from_raw(js.cluster, jp, jfeas, jaff, jtaint, jcfg),
                    tscores.score_from_raw(ts.cluster, tp, tfeas, taff, ttaint, tcfg))


def test_normalize_edges():
    """max 0 (all-zero raw, empty feasible set) and non-integer ratios."""
    raw = np.array([0, 3, 7, 10, 1, 9], np.float32)
    for feas in ([1, 1, 1, 1, 1, 1], [0, 0, 0, 0, 0, 0], [0, 1, 0, 0, 1, 0], [1, 0, 0, 0, 0, 0]):
        f = np.array(feas, bool)
        for r in (raw, np.zeros_like(raw)):
            for rev in (False, True):
                want = jscores.normalize(jnp.asarray(r), jnp.asarray(f), reverse=rev)
                got = tscores.normalize(torch.from_numpy(r), torch.from_numpy(f), reverse=rev)
                assert same(want, got)


def test_popcount_matches_lax():
    rng = np.random.default_rng(7)
    words = rng.integers(0, 2**32, size=(64, 8), dtype=np.uint64).astype(np.uint32)
    words[0] = [0, 1, 0x80000000, 0xFFFFFFFF, 0x55555555, 0xAAAAAAAA, 0x0F0F0F0F, 0x7FFFFFFF]
    want = np.asarray(jax.lax.population_count(jnp.asarray(words))).astype(np.int64)
    got = tscores.popcount32(torch.from_numpy(words.view(np.int32))).numpy()
    assert np.array_equal(want, got)


def test_interp_matches_jnp():
    xs = np.array([0.0, 12.5, 12.5, 60.0, 100.0], np.float32)
    ys = np.array([0.0, 3.0, 4.0, 7.25, 10.0], np.float32)
    x = np.concatenate([np.linspace(-5, 105, 223, dtype=np.float32),
                        xs, np.array([33.333332, 99.99999], np.float32)])
    want = np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xs), jnp.asarray(ys)))
    got = tscores._interp(torch.from_numpy(x), torch.from_numpy(xs), torch.from_numpy(ys)).numpy()
    assert np.array_equal(want, got)
