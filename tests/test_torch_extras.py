"""The port's static score extras equal the reference's, exactly.

image_locality_score, normalize_minmax and static_extra of
kubernetes_tpu_torch/ops/scores.py against kubernetes_tpu/ops/scores.py
run as the reference runs them (jax.jit on the CPU), and the classes'
extra rows (class_extras_plain, the plain version of kernel class_extras)
against the reference's hoist.  ImageLocality's sizes times node counts
leave float32's exact range, so the order of its sums is part of the
result: XLA adds the [MI] terms one after another in slot order, and
`test_image_sum_order_pinned` holds the port to that on inputs where a
pairwise or a reversed sum gives another score (its products are 0 or 1
times a size, so whether the multiply-add is fused cannot matter).
static_extra's `total + w * x` steps are not fused by the reference's
compiler: weights that are not powers of two pin that (a fused form
differs on these inputs); combine_scores' `total + extra` is pinned
through the solves (tests/test_torch_interpod_solves.py).  Tolerance 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from types import SimpleNamespace as NS

from kubernetes_tpu.ops import assign as jassign
from kubernetes_tpu.ops import interpod as jinter
from kubernetes_tpu.ops import schema as jschema
from kubernetes_tpu.ops import scores as jscores
from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu_torch.ops import assign as tassign
from kubernetes_tpu_torch.ops import device as dv
from kubernetes_tpu_torch.ops import interpod as tinter
from kubernetes_tpu_torch.ops import scores as tscores
from kubernetes_tpu_torch.testing.cases import image_objects, prefpod_objects

MB = 1024 * 1024
WEIGHTS = {"default": (2.0, 1.0), "odd": (1.3, 0.7), "small": (0.1, 3.3)}


def _jimage(bits, valid, sizes, ids, n_cont, p):
    return jscores.image_locality_score(
        NS(image_bits=bits, node_valid=valid), NS(sizes=sizes, pod_ids=ids, n_containers=n_cont),
        p)


_jimage_jit = jax.jit(_jimage)


def _timage(bits, valid, sizes, ids, n_cont, p):
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return tscores.image_locality_score(
        NS(image_bits=as_t(bits.view(np.int32)), node_valid=as_t(valid)),
        NS(sizes=as_t(sizes), pod_ids=as_t(ids), n_containers=as_t(n_cont)), p).numpy()


def encode(objs):
    nodes, pods, bound = objs
    snap, _ = jschema.SnapshotBuilder().build(nodes, pods, bound_pods=bound)
    return snap, dv.to_device(dv.snapshot_from_numpy(snap), "cpu")


@pytest.mark.parametrize("seed", range(3))
def test_image_locality_matches_reference_on_batches(seed):
    """Every pod of a seeded image batch (sizes straddling both clamps,
    one to three containers, init containers, unknown images)."""
    snap, tsnap = encode(image_objects(jw, seed))
    f = jax.jit(jscores.image_locality_score)
    for i in range(snap.pods.req.shape[0]):
        assert np.array_equal(np.asarray(f(snap.cluster, snap.images, i)),
                              tscores.image_locality_score(
            tsnap.cluster, tsnap.images, i).numpy()), i


@pytest.mark.parametrize("seed", range(4))
def test_image_locality_matches_reference_on_random_tables(seed):
    """Random presence, node validity, sizes (whole MB and odd bytes, from
    1 MB to 3.8 GB), image lists with gaps and container counts 0-7."""
    rng = np.random.default_rng(seed)
    n, n_img, mi, p = 48, 40, 8, 64
    present = rng.random((n, n_img)) < rng.random()
    bits = np.zeros((n, 2), np.uint32)
    for nd, img in zip(*np.nonzero(present)):
        bits[nd, img // 32] |= np.uint32(1 << (img % 32))
    valid = rng.random(n) < 0.9
    sizes = np.where(rng.random(n_img) < 0.5,
                     rng.integers(1, 3800, n_img) * MB + rng.integers(0, MB, n_img),
                     rng.random(n_img) * 3800 * MB).astype(np.float32)
    ids = rng.integers(-1, n_img, size=(p, mi)).astype(np.int32)
    n_cont = rng.integers(0, 8, size=p).astype(np.float32)
    for i in range(p):
        want = np.asarray(_jimage_jit(bits, valid, sizes, ids, n_cont, i))
        assert np.array_equal(_timage(bits, valid, sizes, ids, n_cont, i), want), i


def _sum_orders(sizes):
    """ImageLocality's score of one node holding every image of size rows
    [M, 8] (one valid node: each term is its size), with the terms summed
    in slot order, pairwise, and in reverse."""
    lo, hi = np.float32(23 * MB), np.float32(1000 * MB) * np.float32(8)

    def score(raw):
        x = (np.float32(100) * (np.clip(raw, lo, hi) - lo).astype(np.float32)).astype(np.float32)
        return np.floor(x / np.float32(hi - lo))

    seq = np.zeros(sizes.shape[0], np.float32)
    for j in range(8):
        seq = (seq + sizes[:, j]).astype(np.float32)
    rev = np.zeros(sizes.shape[0], np.float32)
    for j in reversed(range(8)):
        rev = (rev + sizes[:, j]).astype(np.float32)
    t = sizes
    while t.shape[1] > 1:
        t = (t[:, 0::2] + t[:, 1::2]).astype(np.float32)
    return score(seq), score(t[:, 0]), score(rev)


def test_image_sum_order_pinned():
    """Inputs on which the order of ImageLocality's sum decides the score:
    a search over random sizes keeps those where slot order, pairwise and
    reversed sums round to different scores.  The reference (XLA on the
    CPU) gives the slot-order score on every one, and so does the port;
    a port that summed in another order would fail here."""
    rng = np.random.default_rng(1)
    sizes = (rng.uniform(100, 1000, size=(2_000_000, 8)) * MB).astype(np.float32)
    seq, pair, rev = _sum_orders(sizes)
    hits = np.nonzero((seq != pair) | (seq != rev))[0]
    assert hits.size >= 4
    bits = np.full((8, 1), 0xFF, np.uint32)
    valid = np.zeros(8, bool)
    valid[0] = True                       # one valid node: each term is its size
    ids = np.arange(8, dtype=np.int32)[None, :]
    n_cont = np.array([8.0], np.float32)
    for k in hits:
        want = float(np.asarray(_jimage_jit(bits, valid, sizes[k], ids, n_cont, 0))[0])
        got = float(_timage(bits, valid, sizes[k], ids, n_cont, 0)[0])
        assert got == want == seq[k], k
        assert (pair[k], rev[k]) != (want, want)


@pytest.mark.parametrize("case", ["random", "negative", "all_equal", "one_feasible", "empty"])
def test_normalize_minmax_matches_reference(case):
    rng = np.random.default_rng(len(case))
    n = 64
    raw = rng.integers(-300, 300, n).astype(np.float32)
    feas = rng.random(n) < 0.6
    if case == "negative":
        raw = -np.abs(raw) - 1
    elif case == "all_equal":
        raw[:] = 17.0
    elif case == "one_feasible":
        feas[:] = False
        feas[5] = True
    elif case == "empty":
        feas[:] = False
    want = np.asarray(jax.jit(jscores.normalize_minmax)(raw, feas))
    got = tscores.normalize_minmax(torch.from_numpy(raw), torch.from_numpy(feas)).numpy()
    assert np.array_equal(got, want)


def _extra_inputs(kind):
    objs = {"prefpod": lambda: prefpod_objects(jw, 3), "image": lambda: image_objects(jw, 3),
            "both": lambda: _both_objects()}[kind]()
    return encode(objs)


def _both_objects():
    """A preferred-term batch on nodes that hold images, pods with images."""
    nodes, pods, bound = prefpod_objects(jw, 5)
    inodes, ipods, _ = image_objects(jw, 5, n_nodes=len(nodes), n_pods=len(pods))
    for nd, ind in zip(nodes, inodes):
        nd.status.images = ind.status.images
    for pod, ipod in zip(pods, ipods):
        pod.spec.containers[0].image = ipod.spec.containers[0].image
    return nodes, pods, bound


@pytest.mark.parametrize("weights", sorted(WEIGHTS))
@pytest.mark.parametrize("kind", ["prefpod", "image", "both"])
def test_class_extras_match_reference(kind, weights):
    """The classes' extra rows: the reference's hoist (static_extra per
    class over its static row, as _solver_prep builds it) against the
    port's class_extras_plain, and each row against the port's
    static_extra."""
    snap, tsnap = _extra_inputs(kind)
    features = jassign.features_of(snap)
    assert features.interpod_pref or features.images
    w_pref, w_img = WEIGHTS[weights]
    jcfg = jscores.ScoreConfig(interpod_weight=w_pref, image_weight=w_img)
    tcfg = tscores.ScoreConfig(interpod_weight=w_pref, image_weight=w_img)
    z = jassign.required_topo_z_split(snap)
    want = np.asarray(jax.jit(lambda s: jassign._solver_prep(s, jcfg, max(z), features)[7])(snap))
    cluster, pods, sfeas, *_rest, extra = tassign._solver_prep(tsnap, features, z, tcfg)
    assert np.array_equal(extra.numpy(), want)


def test_static_extra_sums_unfused():
    """static_extra's `w1 * pref + w2 * image` is two roundings: on this
    batch a fused multiply-add (either way round) differs from the
    reference, and the port's unfused form does not."""
    snap, tsnap = _extra_inputs("both")
    features = jassign.features_of(snap)
    jcfg = jscores.ScoreConfig(interpod_weight=1.3, image_weight=0.7)
    tcfg = tscores.ScoreConfig(interpod_weight=1.3, image_weight=0.7)
    z = jassign.required_topo_z_split(snap)
    want = np.asarray(jax.jit(lambda s: jassign._solver_prep(s, jcfg, max(z), features)[7])(snap))
    _c, pods, sfeas, *_rest, extra = tassign._solver_prep(tsnap, features, z, tcfg)
    assert np.array_equal(extra.numpy(), want)
    pp = tinter.prep_pref_pod(tsnap.cluster, tsnap.prefpod, z[1], has_bound=features.bound_pref)
    reps = torch.clamp(pods.class_rep, 0, pods.req.shape[0] - 1).tolist()
    fused_a, fused_b = [], []
    for c, rep in enumerate(reps):
        nm = tscores.normalize_minmax(tinter.pref_pod_raw(pp, tsnap.prefpod, rep), sfeas[c])
        img = tscores.image_locality_score(tsnap.cluster, tsnap.images, rep)
        fused_a.append(tscores.fma32(0.7, img, 1.3 * nm))
        fused_b.append(tscores.fma32(1.3, nm, 0.7 * img))
    assert not np.array_equal(torch.stack(fused_a).numpy(), want)
    assert not np.array_equal(torch.stack(fused_b).numpy(), want)
