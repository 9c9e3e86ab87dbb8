"""The port's InterPodAffinity ops equal the reference's, exactly.

prep_terms, interpod_filter, interpod_update, prep_pref_pod, pref_pod_raw
and the bit packing of kubernetes_tpu_torch/ops/interpod.py against
kubernetes_tpu/ops/interpod.py (jitted, as the reference's solves run
them) on snapshots encoded by the reference package: seeded required-term
batches (hostname and zone keys, both directions, the first-pod escape,
terms limited to other namespaces, nodes without a zone, bound pods that
match or carry terms), with the bound pods folded in or not (has_bound),
with the batch's term slots or all slots; seeded preferred-term batches
(affinity and anti-affinity weights, owner terms of bound pods).  The
bitsets are compared as u32 words (the port holds their int32 views).
Tolerance 0 everywhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import assign as jassign
from kubernetes_tpu.ops import interpod as jinter
from kubernetes_tpu.ops import schema as jschema
from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu_torch.ops import assign as tassign
from kubernetes_tpu_torch.ops import device as dv
from kubernetes_tpu_torch.ops import interpod as tinter
from kubernetes_tpu_torch.testing.cases import interpod_objects, prefpod_objects

_jfilter = jax.jit(jinter.interpod_filter)
_jupdate = jax.jit(jinter.interpod_update, static_argnums=(5,))
_jraw = jax.jit(jinter.pref_pod_raw)


def u32(x):
    """A bitset as u32 words, from either package's representation."""
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.uint32) if a.dtype == np.int32 else a.astype(np.uint32)


def encode(objs):
    nodes, pods, bound = objs
    snap, _ = jschema.SnapshotBuilder().build(nodes, pods, bound_pods=bound)
    return snap, dv.to_device(dv.snapshot_from_numpy(snap), "cpu")


@pytest.mark.parametrize("t_dim", [1, 5, 31, 32, 33, 70])
def test_bit_packing_matches_reference(t_dim):
    """_pack_bits_t (bit 31 included: the words wrap to negative int32),
    _unpack_bits_t and _idx_to_bits against the reference's u32 versions."""
    rng = np.random.default_rng(t_dim)
    mat = rng.random((3, 7, t_dim)) < 0.5
    mat[0, 0, :] = True                     # every bit of a word set
    want = np.asarray(jinter._pack_bits_t(jnp.asarray(mat)))
    got = tinter._pack_bits_t(torch.from_numpy(mat))
    assert got.dtype == torch.int32 and np.array_equal(u32(got), want)
    assert np.array_equal(tinter._unpack_bits_t(got, t_dim).numpy(),
                          np.asarray(jinter._unpack_bits_t(jnp.asarray(want), t_dim)))
    idx = rng.integers(-1, t_dim, size=(9, 4)).astype(np.int32)
    assert np.array_equal(tinter._idx_to_bits(torch.from_numpy(idx), t_dim).numpy(),
                          np.asarray(jinter._idx_to_bits(jnp.asarray(idx), t_dim)))


TERM_CASES = {f"seed{s}": (s, False) for s in range(4)}
TERM_CASES["anti_only"] = (4, True)


def term_preps(name, has_bound, all_slots):
    seed, anti_only = TERM_CASES[name]
    snap, tsnap = encode(interpod_objects(jw, seed, anti_only=anti_only))
    features = jassign.features_of(snap)
    assert features.interpod
    z = jassign.required_topo_z_split(snap)[1]
    assert z == tassign.required_topo_z_split(tsnap)[1]
    slots = () if all_slots else features.term_slots
    js = jax.jit(jinter.prep_terms, static_argnums=(2, 3, 4, 5))(
        snap.cluster, snap.terms, z, None, slots, has_bound)
    ts = tinter.prep_terms(tsnap.cluster, tsnap.terms, z, slots=slots, has_bound=has_bound)
    return snap, tsnap, js, ts, slots


@pytest.mark.parametrize("has_bound", [True, False])
@pytest.mark.parametrize("all_slots", [False, True])
@pytest.mark.parametrize("name", sorted(TERM_CASES))
def test_prep_terms_matches_reference(name, has_bound, all_slots):
    _snap, _tsnap, js, ts, _slots = term_preps(name, has_bound, all_slots)
    for field in jinter.TermState._fields:
        a, b = getattr(js, field), getattr(ts, field)
        if field == "slot_v":
            assert np.array_equal(np.asarray(a), b.numpy()), field
        else:
            assert b.dtype == torch.int32, field
            assert np.array_equal(np.asarray(a), u32(b)), field


@pytest.mark.parametrize("name", sorted(TERM_CASES))
def test_filter_and_update_match_reference(name):
    """interpod_filter for every pod (one at a time and batched over all
    pods), then a sequence of placements through interpod_update, each
    followed by the filter again: the carry and the masks stay equal."""
    snap, tsnap, js, ts, slots = term_preps(name, True, False)
    p = snap.pods.req.shape[0]
    n = int(np.asarray(snap.cluster.node_valid).sum())
    topo = np.asarray(snap.cluster.topo_ids)
    rng = np.random.default_rng(7)
    for step in range(6):
        batched = tinter.interpod_filter(ts, tsnap.terms, torch.arange(p))
        for i in range(p):
            want = np.asarray(_jfilter(js, snap.terms, i))
            assert np.array_equal(tinter.interpod_filter(ts, tsnap.terms, i).numpy(), want), i
            assert np.array_equal(batched[i].numpy(), want), i
        i, choice = int(rng.integers(0, p)), int(rng.integers(0, n))
        js = _jupdate(js, snap.terms, i, topo[choice], True, slots)
        ts = tinter.interpod_update(ts, i, choice)
        for field in ("present_bits", "blocked_bits", "global_any"):
            assert np.array_equal(np.asarray(getattr(js, field)), u32(getattr(ts, field))), field


@pytest.mark.parametrize("has_bound", [True, False])
@pytest.mark.parametrize("seed", range(3))
def test_preferred_terms_match_reference(seed, has_bound):
    """prep_pref_pod's domain sums and every pod's pref_pod_raw row."""
    snap, tsnap = encode(prefpod_objects(jw, seed))
    assert jassign.features_of(snap).interpod_pref
    z = jassign.required_topo_z_split(snap)[1]
    js = jax.jit(jinter.prep_pref_pod, static_argnums=(2, 3, 4))(
        snap.cluster, snap.prefpod, z, None, has_bound)
    ts = tinter.prep_pref_pod(tsnap.cluster, tsnap.prefpod, z, has_bound=has_bound)
    for field in jinter.PrefPodState._fields:
        assert np.array_equal(np.asarray(getattr(js, field)), getattr(ts, field).numpy()), field
    for i in range(snap.pods.req.shape[0]):
        assert np.array_equal(np.asarray(_jraw(js, snap.prefpod, i)),
                              tinter.pref_pod_raw(ts, tsnap.prefpod, i).numpy()), i
