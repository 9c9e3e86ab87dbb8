"""The port's preemption device programs equal the reference's, bit for bit.

The same seeded numpy inputs go through the reference's jitted functions
(kubernetes_tpu/ops/preemption.py, on the CPU) and the port's entry points
on CPU tensors, where each runs its plain version (ops/preemption.py,
ops/filters.py, ops/scores.py).  Everything is compared exactly: masks,
integer counts and float32 scores.

The victim prefix sums are float32; with requests that are not whole MiB
(100M = 95.367431640625 MiB) they leave float32's exact range, and the
order of additions decides which k fits.  The reference's compiler adds
jnp.cumsum in blocks of 16 (ops/auction.py prefix_sum); a sequential sum
or torch.cumsum differs from it on such data, which the K >= 32 cases
below assert, so they are not vacuous.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import filters as jfilters
from kubernetes_tpu.ops import preemption as jpre
from kubernetes_tpu.ops import schema as jschema
from kubernetes_tpu.ops import scores as jscores
from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu_torch.ops import device as dv
from kubernetes_tpu_torch.ops import filters as tfilters
from kubernetes_tpu_torch.ops import preemption as tpre
from kubernetes_tpu_torch.ops import scores as tscores
from kubernetes_tpu_torch.testing.cases import dry_run_inputs, mixed_objects

FRAC = 95.367431640625  # 100M in MiB


def t(a):
    return torch.from_numpy(np.array(a))


def same(a, b):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def run_batched(inputs):
    """(reference, port) results of batched_dry_run on one numpy batch."""
    want = jax.jit(jpre.batched_dry_run)(
        jpre.PreemptionBatch(*(jnp.asarray(a) for a in inputs)))
    got = tpre.run_batched_dry_run(tpre.PreemptionBatch(*(t(a) for a in inputs)))
    return want, got


def assert_batched_equal(inputs):
    want, got = run_batched(inputs)
    for name, w, g in zip(tpre.BatchDryRunResult._fields, want, got):
        assert same(w, g), name
    return got


# -- the reference's three kernel tests (tests/test_preemption.py:30-61) ---


def test_dry_run_min_k():
    free = np.zeros((1, 2), np.float32)
    victim_req = np.array([[[1, 0], [1, 0], [1, 0]]], np.float32)
    valid = np.ones((1, 3), bool)
    pod_req = np.array([2, 0], np.float32)
    r = tpre.dry_run_victims(t(free), t(victim_req), t(valid), t(pod_req))
    assert bool(r.feasible[0])
    assert int(r.min_k[0]) == 2


def test_dry_run_infeasible_even_after_all_evictions():
    free = np.zeros((1, 1), np.float32)
    victim_req = np.full((1, 2, 1), 1.0, np.float32)
    valid = np.ones((1, 2), bool)
    r = tpre.dry_run_victims(t(free), t(victim_req), t(valid), t(np.array([5.0], np.float32)))
    assert not bool(r.feasible[0])


def test_dry_run_padding_not_counted():
    # 1 real victim + 1 padding slot holding junk: k=2 must not be claimable
    free = np.zeros((1, 1), np.float32)
    victim_req = np.array([[[1.0], [99.0]]], np.float32)
    valid = np.array([[True, False]])
    r = tpre.dry_run_victims(t(free), t(victim_req), t(valid), t(np.array([2.0], np.float32)))
    assert not bool(r.feasible[0])


# -- dry_run_victims against the reference --------------------------------


@pytest.mark.parametrize("seed,k,frac", [(0, 4, False), (1, 20, False), (2, 32, True),
                                         (3, 64, True), (4, 7, True)])
def test_dry_run_victims_matches_reference(seed, k, frac):
    """Random candidates with a victim mask that is not a prefix, padding
    junk, rows where nothing fits and requests at 0."""
    c, r = 24, 4
    free, victim_req, _, _, _, pods_req, _ = dry_run_inputs(seed, n=c, k=k, r=r, frac=frac)
    rng = np.random.default_rng(100 + seed)
    valid = rng.random((c, k)) < 0.8
    for p in range(pods_req.shape[0]):
        want = jpre.dry_run_victims(free, victim_req, valid, pods_req[p])
        got = tpre.dry_run_victims(t(free), t(victim_req), t(valid), t(pods_req[p]))
        assert same(want.feasible, got.feasible), p
        assert same(want.min_k, got.min_k), p


# -- batched_dry_run against the reference --------------------------------


@pytest.mark.parametrize("seed,k,levels,frac", [
    (0, 4, 1, False), (1, 20, 3, False), (2, 32, 3, True), (3, 64, 2, True),
    (4, 128, 3, True), (5, 300, 1, True),
])
def test_batched_dry_run_matches_reference(seed, k, levels, frac):
    """Random batches: PDB reorders (perm not the identity, viol flags),
    elig_len 0 and past the slots, rows where nothing fits, L levels."""
    got = assert_batched_equal(dry_run_inputs(seed, n=40, k=k, r=4, levels=levels, frac=frac))
    assert got.feasible.any() and not got.feasible.all()


def first_fit(cum, req):
    """The smallest k (1-based) whose prefix sum reaches req, else None."""
    hit = np.nonzero(req <= cum)[0]
    return int(hit[0]) + 1 if len(hit) else None


@pytest.mark.parametrize("k", [32, 64])
def test_block_order_decides_the_fit(k):
    """Victims of not-whole-MiB memory whose sums pass float32's exact
    range.  A pod asks for memory between the block-order and the
    sequential sum of one prefix, so the order of additions decides its
    min_k: the port equals the reference, and a sequential sum (or
    torch.cumsum) would give another min_k."""
    rng = np.random.default_rng(k)
    n, r = 16, 4
    victim_req = np.zeros((n, k, r), np.float32)
    victim_req[:, :, 1] = (rng.integers(40, 90, size=(n, k)) * FRAC).astype(np.float32)
    victim_req[:, :, 3] = 1.0
    free = np.zeros((n, r), np.float32)
    free[:, 3] = 200.0
    block = np.moveaxis(tpre.prefix_sum(torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(victim_req, 1, 0)))).numpy(), 0, 1)             # [N, K, R]
    seq = np.zeros_like(block)
    run = np.zeros((n, r), np.float32)
    for j in range(k):
        run = (run + victim_req[:, j]).astype(np.float32)
        seq[:, j] = run
    differ = np.argwhere(block[:, :, 1] != seq[:, :, 1])
    assert len(differ), "a sequential sum matched the block order: the case is vacuous"
    node, j = differ[-1]
    pods_req = np.zeros((4, r), np.float32)
    pods_req[:, 1] = max(block[node, j, 1], seq[node, j, 1])
    perm = np.tile(np.arange(k, dtype=np.int32), (1, n, 1))
    inputs = (free, victim_req, perm, np.full((1, n), k, np.int32), np.zeros((1, n, k), bool),
              pods_req, np.zeros(4, np.int32))
    got = assert_batched_equal(inputs)
    req = pods_req[0, 1]
    got_k = int(got.min_k[0, node]) if bool(got.feasible[0, node]) else None
    assert got_k == first_fit(block[node, :, 1], req)
    assert first_fit(seq[node, :, 1], req) != first_fit(block[node, :, 1], req)
    tc = torch.cumsum(torch.from_numpy(victim_req), dim=1).numpy()
    assert not np.array_equal(tc, block)


def test_batched_prefix_holds_pdb_counts():
    """viol_k counts the violating victims inside each minimal prefix,
    after the level's PDB reorder."""
    n, k, r = 2, 4, 1
    free = np.zeros((n, r), np.float32)
    victim_req = np.ones((n, k, r), np.float32)
    perm = np.array([[[2, 3, 0, 1], [0, 1, 2, 3]]], np.int32)
    elig_len = np.array([[4, 3]], np.int32)
    viol = np.array([[[False, False, True, True], [False, True, True, True]]])
    pods_req = np.array([[3.0], [4.0], [1.0], [0.0]], np.float32)
    got = assert_batched_equal((free, victim_req, perm, elig_len, viol, pods_req,
                                np.zeros(4, np.int32)))
    assert got.min_k[0].tolist() == [3, 3] and got.viol_k[0].tolist() == [1, 2]
    assert got.feasible[1].tolist() == [True, False]
    assert got.min_k[3].tolist() == [0, 0] and got.feasible[3].all()


# -- the Filter chain ------------------------------------------------------


def encode(seed):
    nodes, pods, bound = mixed_objects(jw, seed)
    snap, _ = jschema.SnapshotBuilder().build(nodes, pods, bound_pods=bound)
    jsnap = jax.tree.map(jnp.asarray, snap)
    tsnap = dv.to_device(dv.snapshot_from_numpy(snap), "cpu")
    return jsnap, tsnap


@pytest.mark.parametrize("seed", range(4))
def test_static_feasible_batch_matches_reference(seed):
    jsnap, tsnap = encode(seed)
    want = jax.jit(jpre.static_feasible_batch)(jsnap.cluster, jsnap.pods, jsnap.selectors)
    got = tpre.run_static_feasible_batch(tsnap.cluster, tsnap.pods, tsnap.selectors)
    assert same(want, got)
    assert same(want, tpre.static_feasible_batch_plain(tsnap.cluster, tsnap.pods,
                                                       tsnap.selectors))


@pytest.mark.parametrize("seed", range(4))
def test_feasible_batch_and_for_pod_match_reference(seed):
    jsnap, tsnap = encode(seed)
    want = jax.jit(jfilters.feasible_batch)(jsnap.cluster, jsnap.pods, jsnap.selectors)
    got = tfilters.feasible_batch(tsnap.cluster, tsnap.pods, tsnap.selectors)
    assert same(want, got)
    # the full chain differs from the static slice somewhere (resources or ports)
    static = tpre.run_static_feasible_batch(tsnap.cluster, tsnap.pods, tsnap.selectors)
    assert not torch.equal(static, got)
    jsm = jfilters.selector_match(jsnap.cluster, jsnap.selectors)
    tsm = tfilters.selector_match(tsnap.cluster, tsnap.selectors)
    for i in range(0, tsnap.pods.valid.shape[0], 3):
        w = jfilters.feasible_for_pod(jsnap.cluster, jfilters.pod_view(jsnap.pods, i), jsm)
        g = tfilters.feasible_for_pod(tsnap.cluster, tfilters.pod_view(tsnap.pods, i), tsm)
        assert same(w, g), i
        w = jfilters.static_feasible_for_pod(jsnap.cluster, jfilters.pod_view(jsnap.pods, i), jsm)
        g = tfilters.static_filter_row(tsnap.cluster, tfilters.pod_view(tsnap.pods, i), tsm)
        assert same(w, g), i


@pytest.mark.parametrize("seed", range(3))
def test_score_for_pod_matches_reference(seed):
    jsnap, tsnap = encode(seed)
    jsm = jfilters.selector_match(jsnap.cluster, jsnap.selectors)
    tsm = tfilters.selector_match(tsnap.cluster, tsnap.selectors)
    jpm = jfilters.preferred_match(jsnap.cluster, jsnap.preferred)
    tpm = tfilters.preferred_match(tsnap.cluster, tsnap.preferred)
    for i in range(0, tsnap.pods.valid.shape[0], 2):
        jpv = jfilters.pod_view(jsnap.pods, i)
        tpv = tfilters.pod_view(tsnap.pods, i)
        feas = jfilters.feasible_for_pod(jsnap.cluster, jpv, jsm)
        want = jscores.score_for_pod(jsnap.cluster, jpv, feas, jpm)
        got = tscores.score_for_pod(tsnap.cluster, tpv, t(np.asarray(feas)), tpm)
        assert same(want, got), i
