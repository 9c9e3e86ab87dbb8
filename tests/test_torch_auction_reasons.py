"""The auction program's reasons stage (csrc/auction_common.cuh
round_reasons), on the CPU.

The stage runs only on the card, so it is emulated in numpy: every joint
class evaluated (the active ones and the rest), its stage anys (static
row, resource fit of its spec class's representative, the hard spread
filter and the inter-pod filter of its constraint class's) taken per block
of a G-block cluster over the block's 32-node chunks (dealt round robin)
and OR-merged in a shuffled block order, class_reason's code, then each
pod its class's code or REASON_NONE.  For G = 1, 2 and 16 it equals
failure_reasons_plain on the final state of the plain loop, and with the
gang post-pass the reference's auction_assign reasons field (and the
port's).  The batches reach every code: REASON_STATIC, REASON_RESOURCES
(a pod no node fits, and pods parked on contention after max_rounds with
feasible nodes left), REASON_SPREAD, REASON_INTERPOD, REASON_GANG, and
padded pods (valid false) with their class's code.  Tolerance 0.
"""

import functools

import numpy as np
import pytest
import torch

from kubernetes_tpu.api import types as japi
from kubernetes_tpu.ops import auction as jauction
from kubernetes_tpu.ops import schema as jschema
from kubernetes_tpu.ops import scores as jscores
from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu_torch.ops import auction as tauction
from kubernetes_tpu_torch.ops import device as dv
from kubernetes_tpu_torch.ops import scores as tscores
from kubernetes_tpu_torch.ops.assign import (
    REASON_GANG,
    REASON_INTERPOD,
    REASON_NONE,
    REASON_RESOURCES,
    REASON_SPREAD,
    REASON_STATIC,
)
from kubernetes_tpu_torch.ops.filters import fits_resources, pod_view
from kubernetes_tpu_torch.ops.interpod import interpod_filter
from kubernetes_tpu_torch.ops.topology import spread_filter
from kubernetes_tpu_torch.testing.cases import interpod_objects, spread_objects

from test_torch_auction import assert_results_equal

GI = jw.GI


def reason_of(flags: int) -> int:
    """class_reason's code of a class's stage flags (bit 0 static, 1
    resources, 3 spread, 5 inter-pod): round_reasons' reason_of."""
    if flags & 32:
        return REASON_RESOURCES      # feasible yet unplaced: contention
    if not flags & 1:
        return REASON_STATIC
    if not flags & 2:
        return REASON_RESOURCES
    if not flags & 8:
        return REASON_SPREAD
    return REASON_INTERPOD


def emulate_reasons(cluster, pods, st, final, g: int, rng) -> np.ndarray:
    """The reasons stage over a g-block cluster on the loop's final state
    (_rounds_plain's tuple).  Returns (reasons i32[P], each class's flags)."""
    assigned, _bs, requested, nonzero, _r, counts, *bits = final
    n = cluster.allocatable.shape[0]
    c_dim = pods.class_rep.shape[0]
    block = (np.arange(n) >> 5) % g
    cl = cluster._replace(requested=requested, nonzero_requested=nonzero)
    fits = [fits_resources(cl, pod_view(pods, int(rep))).numpy() for rep in st.s_reps]
    k_reps = st.k_reps.long()
    spf = (spread_filter(st.sp.state._replace(counts_node=counts), st.sp.table, k_reps).numpy()
           if st.features.spread else None)
    ipf = None
    if st.features.interpod:
        tm = st.tm.state._replace(present_bits=bits[0], blocked_bits=bits[1],
                                  global_any=bits[2])
        ipf = interpod_filter(tm, st.tm.table, k_reps).numpy()
    reason_c, flags_c = [], []
    for c in range(c_dim):                       # every class, active or not
        s, k = int(st.jspec[c]), int(st.jcons[c])
        stages = [st.sfeas_s[s].numpy()]
        stages.append(stages[-1] & fits[s])
        stages.append(stages[-1] & spf[k] if spf is not None else stages[-1])
        stages.append(stages[-1] & ipf[k] if ipf is not None else stages[-1])
        flags = 0
        for b in rng.permutation(g):             # the blocks' partials, merged by OR
            own = block == b
            for bit, rows in zip((1, 2, 8, 32), stages):
                if rows[own].any():
                    flags |= bit
        flags_c.append(flags)
        reason_c.append(reason_of(flags))
    cls = np.clip(pods.class_id.numpy(), 0, c_dim - 1)
    out = np.where(assigned.numpy() >= 0, REASON_NONE, np.asarray(reason_c)[cls])
    return out.astype(np.int32), flags_c


def every_code_objects():
    """One batch whose pods end with every reason: placeable pods, a
    selector no node has (static), a request no node fits (resources), a
    spread pod whose only fitting nodes break maxSkew (spread), an
    anti-affinity pod with a matching pod on every node (inter-pod), and a
    gang of three of which two fit (gang; the third resources); nine pods,
    so the pod axis pads.  Seventy nodes, so the families' nodes lie in
    several 32-node chunks."""
    nodes = []
    for i in range(70):
        zone = "z0" if i % 2 == 0 else "z1"
        cpu = 4000 if zone == "z0" else 2000
        nodes.append(jw.make_node(f"n{i}").capacity(cpu_milli=cpu, mem=16 * GI, pods=20)
                     .zone(zone).obj())
    bound = [jw.make_pod(f"s-bound{i}").label("app", "s").req(cpu_milli=10)
             .node_name(f"n{2 * i}").obj() for i in range(3)]
    bound += [jw.make_pod(f"x{i}").label("app", "x").req(cpu_milli=10).node_name(f"n{i}").obj()
              for i in range(70)]
    pods = [
        jw.make_pod("ok").req(cpu_milli=100).obj(),
        jw.make_pod("ok2").req(cpu_milli=200).obj(),
        jw.make_pod("static").req(cpu_milli=100).node_selector(disk="ssd").obj(),
        jw.make_pod("big").req(cpu_milli=9000).obj(),
        # fits only the 4-CPU z0 nodes, which hold the constraint's 3
        # matching pods against 0 in z1: 3 + 1 - 0 > maxSkew 1 there
        jw.make_pod("spread").label("app", "s").req(cpu_milli=3000)
        .spread(1, japi.LABEL_ZONE, "DoNotSchedule", {"app": "s"}).obj(),
        jw.make_pod("anti").label("app", "i").req(cpu_milli=100)
        .pod_anti_affinity({"app": "x"}, japi.LABEL_HOSTNAME).obj(),
    ]
    # the gang: each member pinned to one node; two fit theirs, the third
    # asks more than its 2-CPU node has
    for i, (host, cpu) in enumerate((("n69", 1500), ("n67", 1500), ("n1", 2500))):
        pods.append(jw.make_pod(f"g{i}").req(cpu_milli=cpu).group("g", 3)
                    .node_selector_kv(japi.LABEL_HOSTNAME, host).obj())
    return nodes, pods, bound


def contention_objects():
    """Six identical pods of 400m onto two 1-CPU nodes with tie_k 1 and one
    round: the class's top list holds one node, so all six bid it, two are
    accepted, and four stay unplaced with the other node still feasible."""
    nodes = [jw.make_node(f"c{i}").capacity(cpu_milli=1000, mem=8 * GI, pods=10).obj()
             for i in range(2)]
    pods = [jw.make_pod(f"p{i}").req(cpu_milli=400).obj() for i in range(6)]
    return nodes, pods, []


CASES = {
    "every_code": (every_code_objects, {}),
    "contention": (contention_objects, {"tie_k": 1, "max_rounds": 1}),
    "spread_seed1": (lambda: spread_objects(jw, 1, n_nodes=80, n_pods=40), {}),
    "interpod_seed2": (lambda: interpod_objects(jw, 2, n_nodes=80, n_pods=40, anti_only=True),
                       {}),
}


@functools.lru_cache(maxsize=None)
def solve(case):
    build, kw = CASES[case]
    nodes, pods, bound = build()
    snap, _ = jschema.SnapshotBuilder().build(nodes, pods, bound_pods=bound)
    n_groups = jschema.num_groups(snap)
    tie_k = kw.get("tie_k", jauction.default_tie_k(snap))
    max_rounds = kw.get("max_rounds", 64)
    want = jauction.auction_assign_jit(jscores.ScoreConfig(), max_rounds=max_rounds)(
        snap, n_groups=n_groups, tie_k=tie_k)
    tsnap = dv.to_device(dv.snapshot_from_numpy(snap), "cpu")
    cfg = tscores.ScoreConfig()
    got = tauction.auction_assign(tsnap, cfg, n_groups=n_groups, tie_k=tie_k,
                                  max_rounds=max_rounds)
    assert_results_equal(want, got)
    cluster, tpods, st = tauction.auction_prep(tsnap, cfg=cfg)
    final = tauction._rounds_plain(cluster, tpods, st, tie_k, cfg, max_rounds)
    return tpods, cluster, st, final, want, got


@pytest.mark.parametrize("case", sorted(CASES))
def test_reasons_stage_equals_plain_and_reference(case):
    pods, cluster, st, final, want, got = solve(case)
    term_bits = tuple(final[6:]) if st.features.interpod else None
    plain = tauction.failure_reasons_plain(cluster, pods, st, final[0], final[2], final[3],
                                           final[5], term_bits)
    # the wrapper's CPU path is the plain version
    assert torch.equal(tauction.failure_reasons(cluster, pods, st, final[0], final[2],
                                                final[3], final[5], term_bits), plain)
    gang = np.asarray(want.gang_dropped)
    for g in (1, 2, 16):
        emulated, _flags = emulate_reasons(cluster, pods, st, final, g,
                                           np.random.default_rng(g))
        assert np.array_equal(emulated, plain.numpy()), g
        # the gang post-pass after the stage, as in both packages
        assert np.array_equal(np.where(gang, REASON_GANG, emulated), np.asarray(want.reasons))
    assert np.array_equal(got.reasons.numpy(), np.asarray(want.reasons))


def test_every_code_is_reached():
    """The batches above name every code; padded pods take their class's."""
    seen = set()
    padded = 0
    for case in ("every_code", "contention"):
        pods, cluster, st, final, want, _got = solve(case)
        reasons = np.asarray(want.reasons)
        valid = pods.valid.numpy()
        seen |= set(reasons[valid].tolist())
        _emul, flags = emulate_reasons(cluster, pods, st, final, 16, np.random.default_rng(0))
        cls = np.clip(pods.class_id.numpy(), 0, len(flags) - 1)
        if case == "contention":
            # parked with a feasible node left: the contention branch
            unplaced = valid & (final[0].numpy() < 0)
            assert unplaced.sum() == 4
            assert all(flags[c] & 32 for c in cls[unplaced])
        assert not valid.all()
        padded += int((~valid).sum())
        assert np.array_equal(reasons[~valid], np.asarray(
            [reason_of(flags[c]) for c in cls[~valid]], np.int32))
    assert {REASON_NONE, REASON_STATIC, REASON_RESOURCES, REASON_SPREAD, REASON_INTERPOD,
            REASON_GANG} <= seen
    assert padded > 0
