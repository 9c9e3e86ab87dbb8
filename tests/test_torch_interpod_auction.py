"""Inter-pod anti-affinity, preferred inter-pod affinity and ImageLocality on
the port's auction, against the reference.

One snapshot, encoded by the reference package, goes to the reference's
jitted auction_assign and (as torch CPU tensors: the plain rounds, the
plain anti-affinity repair `interpod_repair_plain` and the plain class
extras) to the port's, with the same tie_k and score config.  Compared
exactly: assignment, scores, reasons, rounds, gang_dropped and the
post-solve requested / nonzero_requested; the port's final term bits
against the reference's interpod_update folded over every pod a round
committed (the placed ones and the gang's released ones: neither package
rolls the bits back).  Cases: the anti-affinity cases of
tests/test_auction_constraints.py (:104, :131, :158 — spread and
anti-affinity mixed), contended self-anti-affine classes whose pods bid
shared nodes (the repair releases all but the first of a group; a round
that only releases still counts), a gang with an anti term, the auction
cases of tests/test_prefpod_scoring.py and tests/test_image_locality.py,
and seeded anti-only, preferred and image batches under weights that are
not powers of two.  Tolerance 0.
"""

import jax
import numpy as np
import pytest
import torch

from kubernetes_tpu.api import types as japi
from kubernetes_tpu.ops import assign as jassign
from kubernetes_tpu.ops import auction as jauction
from kubernetes_tpu.ops import interpod as jinter
from kubernetes_tpu.ops import schema as jschema
from kubernetes_tpu.ops import scores as jscores
from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu_torch.ops import auction as tauction
from kubernetes_tpu_torch.ops import device as dv
from kubernetes_tpu_torch.ops import scores as tscores
from kubernetes_tpu_torch.testing import cases

GI, MI = jw.GI, jw.MI
make_node, make_pod = jw.make_node, jw.make_pod
CONFIGS = {"default": dict(), "odd": dict(interpod_weight=1.3, image_weight=0.7,
                                          spread_weight=1.7)}


def anti_validity():
    """tests/test_auction_constraints.py:104."""
    nodes = [make_node(f"n{i}").capacity(cpu_milli=8000, mem=16 * GI).obj() for i in range(64)]
    pods = [make_pod(f"p{i}").req(cpu_milli=250, mem=256 * MI).label("app", f"svc-{i % 8}")
            .pod_anti_affinity({"app": f"svc-{i % 8}"}, japi.LABEL_HOSTNAME).obj()
            for i in range(256)]
    return nodes, pods, []


def anti_against_bound():
    """tests/test_auction_constraints.py:131."""
    nodes = [make_node(f"n{i}").capacity(cpu_milli=8000, mem=16 * GI).obj() for i in range(3)]
    bound = [make_pod("b0").label("app", "x").node_name("n0").obj(),
             make_pod("b1").label("app", "x").node_name("n1").obj()]
    pods = [make_pod(f"p{i}").req(cpu_milli=100).label("app", "x")
            .pod_anti_affinity({"app": "x"}, japi.LABEL_HOSTNAME).obj() for i in range(2)]
    return nodes, pods, bound


def mixed_spread_anti():
    """tests/test_auction_constraints.py:158."""
    nodes = [make_node(f"n{i}").capacity(cpu_milli=8000, mem=16 * GI, pods=110)
             .zone(f"z{i % 4}").obj() for i in range(32)]
    pods = [make_pod(f"p{i}").req(cpu_milli=250, mem=256 * MI).label("app", f"svc-{i % 2}")
            .spread(2, japi.LABEL_ZONE, "DoNotSchedule", {"app": f"svc-{i % 2}"})
            .pod_anti_affinity({"app": f"svc-{i % 2}"}, japi.LABEL_HOSTNAME).obj()
            for i in range(48)]
    return nodes, pods, []


def contended_anti(key, n_nodes, n_pods, zones=4):
    """One self-anti-affine class, more pods than nodes: the class's pods
    wrap onto shared tie nodes, the repair keeps the first of each group
    and the rest bid again until no node is left."""
    nodes = [make_node(f"n{i}").capacity(cpu_milli=8000, mem=16 * GI, pods=110)
             .zone(f"z{i % zones}").obj() for i in range(n_nodes)]
    pods = [make_pod(f"p{i}").req(cpu_milli=100).label("app", "a").priority(i % 3)
            .pod_anti_affinity({"app": "a"}, key).obj() for i in range(n_pods)]
    return nodes, pods, []


def cross_anti():
    """Two services, each anti-affine to the other on the zone: their
    carriers and matchers meet in the repair's groups."""
    nodes = [make_node(f"n{i}").capacity(cpu_milli=8000, mem=16 * GI, pods=110)
             .zone(f"z{i % 3}").obj() for i in range(12)]
    pods = [make_pod(f"p{i}").req(cpu_milli=100).label("app", "ab"[i % 2])
            .pod_anti_affinity({"app": "ba"[i % 2]}, japi.LABEL_ZONE).obj() for i in range(40)]
    return nodes, pods, []


def gang_anti():
    """A gang carrying an anti term, one member unplaceable: released after
    the rounds, its committed term bits stay."""
    nodes = [make_node(f"n{i}").capacity(cpu_milli=4000, mem=16 * GI, pods=110)
             .zone(f"z{i % 2}").obj() for i in range(4)]
    pods = ([make_pod(f"g{i}").label("app", "g").req(cpu_milli=100).group("gang")
             .pod_anti_affinity({"app": "x"}, japi.LABEL_ZONE).obj() for i in range(2)]
            + [make_pod("huge").req(cpu_milli=99000).group("gang").obj()]
            + [make_pod(f"x{i}").label("app", "x").req(cpu_milli=100).obj() for i in range(4)])
    return nodes, pods, []


def _pref_aff(pw, selector, weight):
    term = japi.WeightedPodAffinityTerm(weight, japi.PodAffinityTerm(
        japi.LabelSelector(match_labels=selector), japi.LABEL_ZONE))
    pw.pod.spec.affinity = japi.Affinity(pod_affinity=japi.PodAffinity(preferred=[term]))
    return pw


def pref_auction():
    """tests/test_prefpod_scoring.py:107."""
    nodes = [make_node(f"n{i}").capacity(cpu_milli=8000, mem=16 * GI, pods=110)
             .zone(f"z{i % 2}").obj() for i in range(8)]
    bound = [make_pod("b").label("app", "x").node_name("n1").obj()]
    pods = [_pref_aff(make_pod(f"p{i}").req(cpu_milli=100), {"app": "x"}, 90).obj()
            for i in range(4)]
    return nodes, pods, bound


def image_auction():
    """tests/test_image_locality.py:62."""
    nodes = ([make_node("warm").image("ml:v1", 800 * 1024 * 1024).obj()]
             + [make_node(f"cold{i}").obj() for i in range(7)])
    pods = [make_pod(f"p{i}").req(cpu_milli=100).image("ml:v1").obj() for i in range(2)]
    return nodes, pods, []


CASES = {
    "anti_validity": (anti_validity, "default"),
    "anti_bound": (anti_against_bound, "default"),
    "mixed_spread_anti": (mixed_spread_anti, "odd"),
    "contended_host": (lambda: contended_anti(japi.LABEL_HOSTNAME, 16, 40), "default"),
    "contended_zone": (lambda: contended_anti(japi.LABEL_ZONE, 8, 30), "odd"),
    "cross_anti": (cross_anti, "default"),
    "gang_anti": (gang_anti, "default"),
    "pref": (pref_auction, "odd"),
    "image": (image_auction, "odd"),
}
for _s in range(3):
    CASES[f"anti{_s}"] = (lambda s=_s: cases.interpod_objects(jw, s, anti_only=True),
                          ("default", "odd")[_s % 2])
    CASES[f"prefpod{_s}"] = (lambda s=_s: cases.prefpod_objects(jw, s), ("odd", "default")[_s % 2])
    CASES[f"image{_s}"] = (lambda s=_s: cases.image_objects(jw, s), ("odd", "default")[_s % 2])


def reference_bits(snap, placed):
    """The reference's term bits after committing each (pod, node) of
    `placed` (prep_terms folded through interpod_update)."""
    features = jassign.features_of(snap)
    z = jassign.required_topo_z_split(snap)[1]
    st = jinter.prep_terms(jax.tree.map(np.asarray, snap.cluster), snap.terms, z,
                           slots=features.term_slots, has_bound=features.bound_terms)
    topo = np.asarray(snap.cluster.topo_ids)
    for i, node in placed:
        st = jinter.interpod_update(st, snap.terms, i, topo[node], True,
                                    slots=features.term_slots)
    return tuple(np.asarray(t) for t in (st.present_bits, st.blocked_bits, st.global_any))


@pytest.mark.parametrize("case", sorted(CASES))
def test_auction_matches_reference(case):
    build, cfg = CASES[case]
    nodes, pods, bound = build()
    snap, _ = jschema.SnapshotBuilder().build(nodes, pods, bound_pods=bound)
    features = jassign.features_of(snap)
    assert jauction.auction_features_ok(features)
    assert features.interpod or features.interpod_pref or features.images
    n_groups = jschema.num_groups(snap)
    want = jauction.auction_assign_jit(jscores.ScoreConfig(**CONFIGS[cfg]))(
        snap, n_groups=n_groups)
    got = tauction.auction_assign(dv.to_device(dv.snapshot_from_numpy(snap), "cpu"),
                                  tscores.ScoreConfig(**CONFIGS[cfg]), n_groups=n_groups)
    for f in ("assignment", "scores", "reasons", "rounds", "gang_dropped"):
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), (f, np.nonzero(a != b))
    for f in ("requested", "nonzero_requested"):
        assert np.array_equal(np.asarray(getattr(want.cluster, f)),
                              getattr(got.cluster, f).numpy()), f
    if features.interpod:
        committed = got.assignment.clone()
        dropped = got.gang_dropped
        if bool(dropped.any()):
            # a released member's bid is its committed node: rerun the rounds
            _cl, _p, st = tauction.auction_prep(dv.to_device(dv.snapshot_from_numpy(snap), "cpu"),
                                                cfg=tscores.ScoreConfig(**CONFIGS[cfg]))
            rounds = tauction._rounds_plain(_cl, _p, st, jauction.default_tie_k(snap),
                                            tscores.ScoreConfig(**CONFIGS[cfg]), 64)
            committed = torch.where(dropped, rounds[0], committed)
        placed = [(i, int(a)) for i, a in enumerate(committed.tolist()) if a >= 0]
        for a, b in zip(reference_bits(snap, placed), got.debug_term_bits):
            assert np.array_equal(a, b.numpy().view(np.uint32))
    else:
        assert got.debug_term_bits is None


def test_repair_releases_and_counts_as_progress():
    """On a contended self-anti-affine class the first round's acceptance
    takes several pods a node and the repair releases all but the first of
    each node; the loop goes on (a round that only releases still
    counts), and every node ends with one pod."""
    nodes, pods, bound = contended_anti(japi.LABEL_HOSTNAME, 16, 40)
    snap, _ = jschema.SnapshotBuilder().build(nodes, pods, bound_pods=bound)
    tsnap = dv.to_device(dv.snapshot_from_numpy(snap), "cpu")
    cl, pd, st = tauction.auction_prep(tsnap)
    tie_k = jauction.default_tie_k(snap)
    bits = tauction.term_bits_copy(st.tm, st.features)
    assigned = torch.full((pd.req.shape[0],), -1, dtype=torch.int32)
    bid, _val = tauction.auction_bids_plain(cl, pd, st, cl.requested, cl.nonzero_requested,
                                            assigned, 0, tie_k, tscores.ScoreConfig(), None, bits)
    accept = tauction.auction_decide_plain(cl.allocatable, pd, st.order, bid, cl.requested)
    kept, _bits = tauction.interpod_repair_plain(accept, bid, st, cl.topo_ids, bits)
    assert int(accept.sum()) > int(kept.sum()) == 16
    got = tauction.auction_assign(tsnap)
    a = got.assignment.numpy()[:40]
    assert int(got.rounds) >= 2 and sorted(a[a >= 0].tolist()) == list(range(16))


# ---- the repair over the cluster (csrc/auction_common.cuh), emulated --------

BIG_I = 1 << 30


class ClusterRepair:
    """auction_common.cuh's inter-pod repair over a cluster of G blocks of
    `threads` threads, step for step in numpy, for one launch: the start's
    tables once (the live terms by (slot, term), the [P, L] pair flags, the
    solve positions, the reset groups), then a round per call.  Each block
    owns the pods [b P / G, (b + 1) P / G) (ceil), walked in chunks of its
    threads, the chunk's accepted pods compacted in any order, the pairs in
    any order, and the 32-node chunks q with q % G == b; the blocks run a
    pass in any order between barriers.  The group tables carry from round
    to round: after a round's clear (the groups of the pods accepted before
    the release) every group must be back at its reset value."""

    def __init__(self, st, topo_ids, groups: int, threads: int, seed: int):
        table, _state, z = st.tm
        self.g, self.threads, self.z = groups, threads, int(z)
        self.rng = np.random.default_rng(seed)
        self.topo = topo_ids.numpy()
        self.n, tk = self.topo.shape
        valid, slot = table.valid.numpy(), table.slot.numpy()
        self.live = sorted((min(max(int(slot[t]), 0), tk - 1) << 16) | t
                           for t in range(valid.shape[0]) if valid[t])
        mi = table.matches_incoming.numpy().view(np.uint32)
        anti = table.anti_idx.numpy()
        self.p = mi.shape[0]
        nl = len(self.live)
        self.inv = np.zeros((self.p, nl), np.uint8)
        for i in range(self.p):
            for k, key in enumerate(self.live):
                t = key & 0xFFFF
                self.inv[i, k] = ((int(mi[i, t >> 5]) >> (t & 31)) & 1) | (
                    int((anti[i] == t).any()) << 1)
        self.pos = np.empty(self.p, np.int64)
        self.pos[st.order.numpy()] = np.arange(self.p)
        self.minpos = np.full(self.z * nl, BIG_I, np.int64)
        self.flags = np.zeros((3, self.z * nl), np.uint8)   # carrier, z_mi, z_an
        self.release = np.zeros(self.p, np.uint8)
        self.rounds = 0
        # the partition covers every pod and node once
        per = -(-self.p // self.g)
        self.pods = [range(min(self.p, b * per), min(self.p, b * per + per))
                     for b in range(self.g)]
        self.nodes = [[nd for nd in range(self.n) if (nd >> 5) % self.g == b]
                      for b in range(self.g)]
        assert sorted(i for r in self.pods for i in r) == list(range(self.p))
        assert sorted(nd for b in self.nodes for nd in b) == list(range(self.n))

    def reset_state(self) -> bool:
        return ((self.minpos == BIG_I).all() and not self.flags.any()
                and not self.release.any())

    def pairs(self, b: int, keep, bid):
        """walk_pairs: block b's involved (pod, term, group, flags)."""
        nl = len(self.live)
        r = self.pods[b]
        for base in range(r.start, r.stop, self.threads):
            chunk = [i for i in range(base, min(base + self.threads, r.stop)) if keep(i)]
            self.rng.shuffle(chunk)
            pairs = [(i, k) for i in chunk for k in range(nl)]
            for e in self.rng.permutation(len(pairs)):
                i, k = pairs[e]
                if not self.inv[i, k]:
                    continue
                key = self.live[k]
                v = int(self.topo[min(max(int(bid[i]), 0), self.n - 1), key >> 16])
                if v >= 0:
                    yield i, key & 0xFFFF, min(v, self.z - 1) * nl + k, int(self.inv[i, k])

    def __call__(self, accept, bid, term_bits):
        assert self.reset_state()
        accept = accept.numpy().astype(np.uint8)
        bid = bid.numpy()
        present, blocked, gany = (t.numpy().view(np.uint32).copy() for t in term_bits)
        carrier, z_mi, z_an = self.flags
        for b in self.rng.permutation(self.g):                       # pass 1
            for i, _t, gi, inv in self.pairs(b, lambda i: accept[i], bid):
                self.minpos[gi] = min(self.minpos[gi], self.pos[i])
                if inv & 2:
                    carrier[gi] = 1
        for b in self.rng.permutation(self.g):                       # passes 2, 3
            for i, _t, gi, _inv in self.pairs(b, lambda i: accept[i], bid):
                if carrier[gi] and self.pos[i] > self.minpos[gi]:
                    self.release[i] = 1
            for i in self.pods[b]:
                if self.release[i]:
                    accept[i] = 0
            block_any = np.zeros_like(gany)
            for _i, t, gi, inv in self.pairs(b, lambda i: accept[i], bid):
                if inv & 1:
                    z_mi[gi] = 1
                    block_any[t >> 5] |= np.uint32(1 << (t & 31))
                if inv & 2:
                    z_an[gi] = 1
            gany |= block_any
        nl = len(self.live)
        for b in self.rng.permutation(self.g):                       # pass 4: nodes
            for nd in self.nodes[b]:
                slot, v = -1, -1
                for k, key in enumerate(self.live):
                    if key >> 16 != slot:
                        slot = key >> 16
                        v = int(self.topo[nd, slot])
                    if v < 0:
                        continue
                    gi, t = min(v, self.z - 1) * nl + k, key & 0xFFFF
                    if z_mi[gi]:
                        present[nd, t >> 5] |= np.uint32(1 << (t & 31))
                    if z_an[gi]:
                        blocked[nd, t >> 5] |= np.uint32(1 << (t & 31))
        for b in self.rng.permutation(self.g):                       # the clear
            for _i, _t, gi, _inv in self.pairs(b, lambda i: accept[i] | self.release[i], bid):
                self.minpos[gi] = BIG_I
                self.flags[:, gi] = 0
            for i in self.pods[b]:
                self.release[i] = 0
        assert self.reset_state(), "a group the round wrote survived its clear"
        self.rounds += 1
        return (torch.from_numpy(accept.astype(bool)),
                tuple(torch.from_numpy(x.view(np.int32)) for x in (present, blocked, gany)))


def many_terms():
    """cases.many_anti_terms_objects: 40 distinct terms (more than 32: a
    second word), valid and padding terms, hostname and zone slots."""
    return cases.many_anti_terms_objects(jw)


REPAIR_CASES = {f"anti{s}": (lambda s=s: cases.interpod_objects(jw, s, anti_only=True), None)
                for s in range(3)}
REPAIR_CASES.update({
    "contended_host": (lambda: contended_anti(japi.LABEL_HOSTNAME, 16, 40), None),
    "contended_zone": (lambda: contended_anti(japi.LABEL_ZONE, 8, 30), None),
    "cross_anti": (cross_anti, None),
    "many_terms": (many_terms, None),
    # hostname values past the term value capacity, clipped onto its last bin
    "many_terms_clipped": (many_terms, 5),
})


@pytest.mark.parametrize("shape", [(16, 512), (3, 32)])
@pytest.mark.parametrize("case", sorted(REPAIR_CASES))
def test_cluster_repair_matches_plain_and_reference(case, shape, monkeypatch):
    """The repair over the cluster, emulated (16 blocks of 512 threads, the
    A shape's; 3 blocks of 32, so a block walks several chunks), in place
    of the plain repair inside the port's plain rounds: every round's kept
    set and bits equal interpod_repair_plain's; the whole solve equals the
    reference's jitted auction_assign (its interpod_repair and
    commit_terms) where the value capacity is the reference's own."""
    build, z_terms = REPAIR_CASES[case]
    nodes, pods, bound = build()
    snap, _ = jschema.SnapshotBuilder().build(nodes, pods, bound_pods=bound)
    features = jassign.features_of(snap)
    assert features.interpod and jauction.auction_features_ok(features)
    tsnap = dv.to_device(dv.snapshot_from_numpy(snap), "cpu")
    topo_z = None
    if z_terms is not None:
        topo_z = (jassign.required_topo_z_split(snap)[0], z_terms)
    plain = tauction.interpod_repair_plain
    emulators = {}

    def repair(accept, bid, st, topo_ids, term_bits, tables=None):
        em = emulators.setdefault(id(tables), ClusterRepair(st, topo_ids, *shape,
                                                            seed=len(emulators)))
        got = em(accept, bid, term_bits)
        want = plain(accept, bid, st, topo_ids, term_bits, tables)
        assert torch.equal(got[0], want[0])
        for a, b in zip(got[1], want[1]):
            assert torch.equal(a, b)
        return got

    monkeypatch.setattr(tauction, "interpod_repair_plain", repair)
    got = tauction.auction_assign(tsnap, topo_z=topo_z)
    em = next(iter(emulators.values()))
    assert em.rounds == int(got.rounds) >= 1
    if case.startswith("contended") or case.startswith("many"):
        assert em.rounds >= 2            # the groups carried across rounds
    if case.startswith("many"):
        assert 32 < len(em.live) < snap.terms.valid.shape[0] == 64     # w = 2
        assert len({key >> 16 for key in em.live}) == 2
    if z_terms is not None:
        live_slots = sorted({key >> 16 for key in em.live})
        assert (em.topo[:, live_slots] >= z_terms).any()
        return
    want = jauction.auction_assign_jit(jscores.ScoreConfig())(snap, n_groups=0)
    for f in ("assignment", "scores", "reasons", "rounds"):
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    placed = [(i, int(a)) for i, a in enumerate(got.assignment.tolist()) if a >= 0]
    for a, b in zip(reference_bits(snap, placed), got.debug_term_bits):
        assert np.array_equal(a, b.numpy().view(np.uint32))
