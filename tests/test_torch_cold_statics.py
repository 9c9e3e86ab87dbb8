"""The cold statics prep: ops.assign.cold_statics (kernel class_statics on
the card: the selector and preferred rows the classes name, the class
tables and, when asked for, the selector mask, in one launch) against the
reference's selector_match, preferred_match and class_statics.

Three parts, all on the CPU:

- the wrapper, whose CPU path is selector_match + preferred_match +
  class_statics_plain, equals the reference's jnp functions exactly, on
  every field, with and without the mask, on seeded snapshots that reach
  each branch (zero-row tables, the NodeAffinity table's 32-row floor with
  one valid row, preferred terms, tol_all and PreferNoSchedule taints,
  bound-port conflicts, topology-slot expressions with TOPO_ANY_VALUE,
  OP_NEG);
- a numpy emulation of the kernel's tile plan (tiles of nodes, chunks of
  classes and of the row axis, the row marks, the warp's list, a match
  word a row, the classes reading only those words) gives the reference's
  tables and mask, evaluates every row a class names once a tile (once a
  class chunk past one row chunk) and no other row;
- the binding marshals its launch arrays in the order of class_statics.cu's
  enums, and the source's constants are the bindings'.

Masks and the integer-valued float32 rows are compared exactly: boolean
algebra and small integer sums, nothing to round.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.api import types as japi
from kubernetes_tpu.ops import assign as jassign
from kubernetes_tpu.ops import filters as jfilters
from kubernetes_tpu.ops import schema as jschema
from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu_torch.kernels import bindings
from kubernetes_tpu_torch.ops import assign as tassign
from kubernetes_tpu_torch.ops import device as dv
from kubernetes_tpu_torch.ops import filters as tfilters

CSRC = Path(__file__).resolve().parent.parent / "kubernetes_tpu_torch" / "csrc"
TILE = bindings.STATICS_TILE
ROW_CHUNK = bindings.STATICS_ROW_CHUNK
CLASS_CHUNK = bindings.STATICS_CLASS_CHUNK


# ---- seeded snapshots ----------------------------------------------------------


def _nodes(rng, n: int, taints: bool = True):
    nodes = []
    for i in range(n):
        w = jw.make_node(f"n{i}").zone(f"z{i % 4}")
        if rng.random() < 0.5:
            w = w.label("disk", "ssd" if rng.random() < 0.5 else "hdd")
        if rng.random() < 0.4:
            w = w.label("gen", str(int(rng.integers(1, 6))))
        if i % 5 == 0:
            w = w.label(japi.LABEL_REGION, f"r{i % 2}")
        if taints:
            if rng.random() < 0.2:
                w = w.taint("hard", "x", japi.NO_SCHEDULE)
            if rng.random() < 0.3:
                w = w.taint(f"soft{int(rng.integers(0, 3))}", "y", japi.PREFER_NO_SCHEDULE)
            if rng.random() < 0.1:
                w = w.taint("evict", "z", japi.NO_EXECUTE)
        nodes.append(w.obj())
    return nodes


def basic_case(seed: int):
    """SchedulingBasic's shape: no selector, no preferred term, no taint:
    both tables are the one-row pad with no valid row."""
    rng = np.random.default_rng(seed)
    pods = [jw.make_pod(f"p{i}").req(cpu_milli=100, mem=500 * jw.MI).obj() for i in range(12)]
    return _nodes(rng, 20, taints=False), pods, ()


def node_affinity_case(seed: int):
    """SchedulingNodeAffinity's: every pod requires zone In [z1, z2] (a
    topology-slot expression): the selector table floors at 32 rows, one
    of them valid."""
    rng = np.random.default_rng(seed)
    pods = [jw.make_pod(f"p{i}").required_affinity(japi.LABEL_ZONE, japi.OP_IN, ["z1", "z2"])
            .obj() for i in range(10)]
    return _nodes(rng, 24), pods, ()


def preferred_case(seed: int):
    """Preferred node-affinity terms over labels and topology slots, with
    seeded weights, some pods without any."""
    rng = np.random.default_rng(seed)
    pods = []
    for i in range(16):
        w = jw.make_pod(f"p{i}")
        for _ in range(int(rng.integers(0, 4))):
            kind = int(rng.integers(0, 3))
            wt = int(rng.integers(1, 101))
            if kind == 0:
                w = w.preferred_affinity(wt, "disk", japi.OP_IN, ["ssd"])
            elif kind == 1:
                w = w.preferred_affinity(wt, japi.LABEL_ZONE, japi.OP_IN, [f"z{rng.integers(0, 4)}"])
            else:
                w = w.preferred_affinity(wt, "gen", japi.OP_NOT_IN, [str(rng.integers(1, 6))])
        pods.append(w.obj())
    return _nodes(rng, 30), pods, ()


def operators_case(seed: int, n_nodes: int = 36):
    """Every operator over labels and topology slots (Exists as
    TOPO_ANY_VALUE, NotIn / DoesNotExist as OP_NEG), tolerations incl.
    tol_all, PreferNoSchedule taints, NodeName and bound-port conflicts."""
    rng = np.random.default_rng(seed)
    mk = jw.make_pod
    pods = [
        mk("in").required_affinity("disk", japi.OP_IN, ["ssd"]).obj(),
        mk("notin").required_affinity("gen", japi.OP_NOT_IN, ["1", "2"]).obj(),
        mk("exists").required_affinity("disk", japi.OP_EXISTS).obj(),
        mk("dne").required_affinity("disk", japi.OP_DOES_NOT_EXIST).obj(),
        mk("zone-any").required_affinity(japi.LABEL_ZONE, japi.OP_EXISTS).obj(),
        mk("region-any").required_affinity(japi.LABEL_REGION, japi.OP_EXISTS).obj(),
        mk("region-none").required_affinity(japi.LABEL_REGION, japi.OP_DOES_NOT_EXIST).obj(),
        mk("zone-not").required_affinity(japi.LABEL_ZONE, japi.OP_NOT_IN, ["z1"]).obj(),
        mk("host").required_affinity(japi.LABEL_HOSTNAME, japi.OP_IN, ["n4", "n5"]).obj(),
        mk("or").required_affinity("gen", japi.OP_IN, ["3"])
        .required_affinity("disk", japi.OP_IN, ["hdd"]).obj(),
        mk("tol-all").toleration().obj(),
        mk("tol-hard").toleration("hard", japi.OP_EQUAL, "x", japi.NO_SCHEDULE).obj(),
        mk("tol-soft").toleration("soft1", japi.OP_EXISTS, effect=japi.PREFER_NO_SCHEDULE).obj(),
        mk("tol-evict").toleration("evict", japi.OP_EXISTS).obj(),
        mk("named").node_name("n6").obj(),
        mk("port").host_port(80).obj(),
        mk("port2").host_port(8080).host_port(80).obj(),
        mk("pref").preferred_affinity(30, "disk", japi.OP_IN, ["ssd"])
        .preferred_affinity(7, japi.LABEL_ZONE, japi.OP_EXISTS).obj(),
    ]
    bound = [jw.make_pod(f"b{i}").host_port(80).node_name(f"n{i}").obj() for i in (0, 3, 9)]
    return _nodes(rng, n_nodes), pods, bound


CASES = {"basic": basic_case, "node_affinity": node_affinity_case,
         "preferred": preferred_case, "operators": operators_case}


def encode(snap):
    return jax.tree.map(jnp.asarray, snap), dv.to_device(dv.snapshot_from_numpy(snap), "cpu")


def build(name: str, seed: int = 0):
    nodes, pods, bound = CASES[name](seed)
    snap, _ = jschema.SnapshotBuilder().build(nodes, pods, bound_pods=bound)
    return snap


def same(a, b):
    a = np.asarray(a)
    b = b.numpy()
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def reference(js, reps):
    """The reference's masks and class tables."""
    jsel = jfilters.selector_match(js.cluster, js.selectors)
    jpref = jfilters.preferred_match(js.cluster, js.preferred)
    return jassign.class_statics(js.cluster, js.pods, jsel, jpref, reps), jsel


# ---- the wrapper against the reference -------------------------------------------


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("want_sel_mask", [False, True])
@pytest.mark.parametrize("reps", ["class_rep", "spec_rep", "pod0"])
def test_cold_statics_matches_reference(name, want_sel_mask, reps):
    snap = build(name)
    js, ts = encode(snap)
    p = snap.pods.req.shape[0]
    rep = (np.zeros(1, np.int32) if reps == "pod0"
           else np.clip(np.asarray(getattr(snap.pods, reps)), 0, p - 1).astype(np.int32))
    (want, jsel) = reference(js, jnp.asarray(rep))
    got = tassign.cold_statics(*ts[:4], torch.from_numpy(rep), want_sel_mask=want_sel_mask)
    for w, g in zip(want, got[:3]):
        assert same(w, g)
    if want_sel_mask:
        assert same(jsel, got[3])
    else:
        assert got[3] is None


def test_cold_statics_default_reps_are_class_rep():
    js, ts = encode(build("operators"))
    want, _ = reference(js, None)
    for w, g in zip(want, tassign.cold_statics(*ts[:4])[:3]):
        assert same(w, g)


def test_cases_reach_their_branches():
    """Each snapshot really holds what it is named for."""
    b = build("basic")
    assert b.selectors.term_valid.shape[0] == 1 and not b.selectors.term_valid.any()
    assert b.preferred.valid.shape[0] == 1 and not b.preferred.valid.any()
    w = build("node_affinity")
    assert w.selectors.term_valid.shape[0] == 32
    assert int(w.selectors.term_valid.any(axis=1).sum()) == 1
    assert (w.selectors.expr_slot[w.selectors.term_valid] >= 0).any()
    p = build("preferred")
    assert p.preferred.valid.sum() >= 3 and (p.pods.pref_idx >= 0).any()
    o = build("operators")
    live = o.selectors.expr_op > 0
    assert (o.selectors.expr_op == jschema.OP_NEG).any()
    assert (o.selectors.expr_ids[live] == jschema.TOPO_ANY_VALUE).any()
    assert o.pods.tol_all.any()
    assert o.cluster.taint_bits[1].any()              # PreferNoSchedule
    assert (o.cluster.port_bits != 0).any() and (o.pods.port_bits != 0).any()
    assert (o.pods.name_id >= 0).any()


# ---- the kernel's tile plan, emulated ------------------------------------------------


def emulate(ts, reps, want_sel_mask: bool, tile: int, row_chunk: int, class_chunk: int):
    """The class_statics launch, block by block, in numpy: per tile of
    `tile` nodes, per chunk of `class_chunk` classes and of `row_chunk`
    rows of the row axis (S selector rows, then F preferred rows), mark
    the rows the chunk's classes name (and every selector row for the mask,
    on the first class chunk), list the marked rows in order, evaluate
    each into a match word (the plain row match at the tile's nodes, the
    value statics::match_row gives), then let each class read only those
    words.  Past one row chunk the marks and words of a row chunk are
    dropped before the next, as the kernel reuses its shared memory.
    Returns (sfeas, aff, taint, mask, evaluations [(tile start, row)])."""
    cluster, pods, sel, pref = ts[:4]
    n = cluster.node_valid.shape[0]
    s, f = sel.term_valid.shape[0], pref.valid.shape[0]
    u, p, c, mt = s + f, pods.valid.shape[0], reps.shape[0], pods.pref_idx.shape[1]
    row_match = torch.cat([
        tfilters.match_rows_plain(cluster, sel.expr_ids, sel.expr_op, sel.expr_slot,
                                  sel.term_valid),
        tfilters.match_rows_plain(cluster, pref.expr_ids[:, None], pref.expr_op[:, None],
                                  pref.expr_slot[:, None], pref.valid[:, None]),
    ]).numpy()
    rep = np.clip(reps.numpy(), 0, p - 1)
    # the per-(class, node) body without its selector bit: the static
    # slice under an all-true selector row, and the taint count
    if c:
        base, _, taint = tassign.class_statics_plain(
            cluster, pods, torch.ones((s, n), dtype=torch.bool),
            torch.zeros((f, n), dtype=torch.bool), torch.from_numpy(rep))
        base, taint = base.numpy(), taint.numpy()
    else:
        base, taint = np.zeros((0, n), bool), np.zeros((0, n), np.float32)
    sel_idx, pref_idx = pods.sel_idx.numpy(), pods.pref_idx.numpy()
    weight = pods.pref_weight.numpy()

    def named(r, j):
        if j == 0:
            return -1 if sel_idx[r] < 0 else min(sel_idx[r], s - 1)
        pi = pref_idx[r, j - 1]
        return -1 if pi < 0 else s + min(pi, f - 1)

    sfeas = np.zeros((c, n), bool)
    aff = np.zeros((c, n), np.float32)
    mask = np.full((s, n), -1, np.int8)
    evals = []
    one_row_chunk = u <= row_chunk
    for t0 in range(0, n, tile):
        nodes = slice(t0, min(t0 + tile, n))
        nt = nodes.stop - t0
        mark = np.zeros(u, np.int8)   # 0 none, 1 to evaluate, 2 done
        word = {}
        for chunk in range(max(1, -(-c // class_chunk))):
            classes = range(chunk * class_chunk, min(c, (chunk + 1) * class_chunk))
            mask_now = want_sel_mask and chunk == 0
            csel = {i: np.ones(nt, bool) for i in classes if sel_idx[rep[i]] < 0}
            chit = {}
            for r0 in range(0, u, row_chunk):
                rows = range(r0, min(u, r0 + row_chunk))
                if not one_row_chunk:
                    mark[r0:rows.stop] = 0
                    word = {}
                for i in classes:
                    for j in range(1 + mt):
                        row = named(rep[i], j)
                        if row in rows and mark[row] == 0:
                            mark[row] = 1
                if mask_now:
                    for row in range(r0, min(rows.stop, s)):
                        if mark[row] == 0:
                            mark[row] = 1
                for row in [r for r in rows if mark[r] == 1]:
                    mark[row] = 2
                    evals.append((t0, row))
                    word[row] = row_match[row, nodes]
                    if mask_now and row < s:
                        mask[row, nodes] = word[row]
                for i in classes:
                    for j in range(1 + mt):
                        row = named(rep[i], j)
                        if row in rows:
                            if j == 0:
                                csel[i] = word[row]
                            else:
                                chit[i, j - 1] = word[row]
            for i in classes:
                r = rep[i]
                sfeas[i, nodes] = base[i, nodes] & csel[i]
                acc = np.zeros(nt, np.float32)
                for j in range(mt):
                    live = pref_idx[r, j] >= 0
                    w = np.float32(weight[r, j]) if live else np.float32(0.0)
                    hit = chit[i, j] if live else np.zeros(nt, bool)
                    acc = (acc + w * hit.astype(np.float32)).astype(np.float32)
                aff[i, nodes] = acc
    return sfeas, aff, taint, mask, evals


def synthetic(u: int, n: int, c: int, seed: int):
    """The operators snapshot reshaped: S + F = u rows (the selector rows
    and preferred rows drawn from its valid ones, a quarter padding rows
    with no valid term), n nodes (its first n), c classes drawn from 96
    pods resampled from its pods, whose selector and preferred indices
    name valid rows or none."""
    rng = np.random.default_rng(seed)
    nodes, pods, bound = operators_case(seed, max(n, 12))
    snap, _ = jschema.SnapshotBuilder().build(nodes, pods, bound_pods=bound)
    s = max(1, u // 2 + u % 2)
    f = u - s
    if f < 1:
        s, f = u - 1, 1
    sel, pref = snap.selectors, snap.preferred
    sv = np.flatnonzero(sel.term_valid.any(axis=1))
    pv = np.flatnonzero(pref.valid)
    s_pick = rng.choice(sv, s)
    f_pick = rng.choice(pv, f)
    s_pad = rng.random(s) < 0.25
    f_pad = rng.random(f) < 0.25
    sel = sel._replace(expr_ids=sel.expr_ids[s_pick], expr_op=sel.expr_op[s_pick],
                       expr_slot=sel.expr_slot[s_pick],
                       term_valid=sel.term_valid[s_pick] & ~s_pad[:, None])
    pref = pref._replace(expr_ids=pref.expr_ids[f_pick], expr_op=pref.expr_op[f_pick],
                         expr_slot=pref.expr_slot[f_pick], valid=pref.valid[f_pick] & ~f_pad)
    live_s = np.flatnonzero(~s_pad)
    live_f = np.flatnonzero(~f_pad)
    pods = snap.pods
    p = 96
    take = rng.integers(0, int(pods.valid.sum()), p)
    fields = {}
    for name in pods._fields:
        a = np.asarray(getattr(pods, name))
        if name in ("tol_bits", "tol_all"):
            fields[name] = a[:, take]
        elif a.ndim and a.shape[0] == pods.valid.shape[0] and name not in (
                "class_rep", "spec_rep", "joint_spec", "cons_rep", "joint_cons"):
            fields[name] = a[take]
        else:
            fields[name] = a
    mt = fields["pref_idx"].shape[1]
    fields["sel_idx"] = np.where(rng.random(p) < 0.3, -1,
                                 rng.choice(live_s, p) if live_s.size else -1).astype(np.int32)
    pidx = rng.choice(live_f, (p, mt)) if live_f.size else np.full((p, mt), -1)
    fields["pref_idx"] = np.where(rng.random((p, mt)) < 0.4, -1, pidx).astype(np.int32)
    fields["pref_weight"] = np.where(fields["pref_idx"] >= 0,
                                     rng.integers(1, 101, (p, mt)), 0).astype(np.float32)
    pods = type(pods)(**fields)
    cl = snap.cluster
    cl = type(cl)(*(np.asarray(a)[:, :n] if name == "taint_bits" else np.asarray(a)[:n]
                    for name, a in zip(cl._fields, cl)))
    snap = snap._replace(cluster=cl, pods=pods, selectors=sel, preferred=pref)
    reps = rng.choice(p, c, replace=c > p).astype(np.int32)
    return snap, reps


def check_plan(u, n, c, want_sel_mask, tile, row_chunk, class_chunk, seed=0):
    snap, reps = synthetic(u, n, c, seed)
    assert snap.cluster.node_valid.shape[0] == n
    js, ts = encode(snap)
    want, jsel = reference(js, jnp.asarray(reps))
    sfeas, aff, taint, mask, evals = emulate(ts, torch.from_numpy(reps), want_sel_mask,
                                             tile, row_chunk, class_chunk)
    for w, g in zip(want, (sfeas, aff, taint)):
        assert np.array_equal(np.asarray(w), g)
    s = snap.selectors.term_valid.shape[0]
    if want_sel_mask:
        assert (mask >= 0).all()                          # the mask is complete
        assert np.array_equal(np.asarray(jsel), mask.astype(bool))
    else:
        assert (mask < 0).all()
    # the rows evaluated at each tile: exactly those named (and the mask's)
    p = snap.pods.valid.shape[0]
    f = snap.preferred.valid.shape[0]
    sel_idx, pref_idx = snap.pods.sel_idx, snap.pods.pref_idx
    by_chunk = []
    for c0 in range(0, max(c, 1), class_chunk):
        rows = set()
        for r in np.clip(reps[c0:c0 + class_chunk], 0, p - 1):
            if sel_idx[r] >= 0:
                rows.add(min(int(sel_idx[r]), s - 1))
            rows.update(s + min(int(x), f - 1) for x in pref_idx[r] if x >= 0)
        by_chunk.append(rows)
    named = set().union(*by_chunk) | (set(range(s)) if want_sel_mask else set())
    one_row_chunk = s + f <= row_chunk
    for t0 in range(0, n, tile):
        got = [row for t, row in evals if t == t0]
        assert set(got) == named
        if one_row_chunk:
            assert len(got) == len(set(got))              # once a tile
        else:
            for row in set(got):   # once a class chunk that names it
                times = sum(row in rows for rows in by_chunk)
                times += int(want_sel_mask and row < s and row not in by_chunk[0])
                assert got.count(row) == times
    return len(evals)


# the row axis around the emulated chunk of 32 rows (S + F >= 2: each table
# keeps at least its pad row), the node axis around a tile, masks or not
@pytest.mark.parametrize("u", [2, 31, 32, 33, 64, 65])
@pytest.mark.parametrize("n", [1, TILE - 1, TILE, TILE + 1])
@pytest.mark.parametrize("want_sel_mask", [False, True])
def test_tile_plan_row_chunks_and_tiles(u, n, want_sel_mask):
    check_plan(u, n, 7, want_sel_mask, TILE, 32, 4)


@pytest.mark.parametrize("c", [3, 4, 5, 9])
@pytest.mark.parametrize("u", [9, 40])
@pytest.mark.parametrize("want_sel_mask", [False, True])
def test_tile_plan_class_chunks(c, u, want_sel_mask):
    """Class chunks at their edge (4 classes a chunk), with the row axis in
    one chunk (9 rows) and in two (40 rows past a chunk of 32)."""
    check_plan(u, 2 * TILE + 3, c, want_sel_mask, TILE, 32, 4)


@pytest.mark.parametrize("c", [CLASS_CHUNK - 1, CLASS_CHUNK, CLASS_CHUNK + 1])
def test_tile_plan_kernel_chunks(c):
    """The kernel's own constants: a tile of 32 nodes, 1,024 rows and 64
    classes a chunk."""
    assert check_plan(65, TILE + 1, c, True, TILE, ROW_CHUNK, CLASS_CHUNK) > 0


def test_tile_plan_no_classes_mask_only():
    """No class, the mask asked for: the launch evaluates every selector
    row and nothing else."""
    snap, _ = synthetic(20, TILE + 5, 1, 3)
    _, ts = encode(snap)
    s = snap.selectors.term_valid.shape[0]
    *_, mask, evals = emulate(ts, torch.zeros(0, dtype=torch.int32), True, TILE, 32, 4)
    assert (mask >= 0).all()
    assert sorted(evals) == sorted((t, r) for t in (0, TILE) for r in range(s))


# ---- the binding's launch arrays and the source's constants ----------------------------


def _enum(prefix: str, first: str):
    src = (CSRC / "class_statics.cu").read_text()
    body = re.search(r"enum \{\s*(" + prefix + first + r"\b.*?)\};", src, re.S)
    assert body, prefix
    return [e.strip() for e in body.group(1).replace("\n", " ").split(",") if e.strip()]


@pytest.mark.parametrize("prefix,first,names", [("kI_", "N", bindings.STATICS_INTS),
                                                ("kP_", "NODE_VALID", bindings.STATICS_PTRS)])
def test_launch_arrays_follow_the_source(prefix, first, names):
    entries = _enum(prefix, first)
    assert entries[-1] == f"{prefix}COUNT"
    assert [e[len(prefix):].lower() for e in entries[:-1]] == list(names)


def test_chunks_follow_the_source():
    src = (CSRC / "class_statics.cu").read_text()
    common = (CSRC / "statics_common.cuh").read_text()
    assert re.search(rf"constexpr int kTile = {TILE};", common)
    assert re.search(rf"constexpr int kRowChunk = {ROW_CHUNK};", src)
    assert re.search(rf"constexpr int kClassChunk = {CLASS_CHUNK};", src)
    assert "#include \"statics_common.cuh\"" in (CSRC / "match_terms.cu").read_text()


@pytest.mark.parametrize("want_sel_mask", [False, True])
def test_binding_marshals_the_launch_arrays(monkeypatch, want_sel_mask):
    """bindings.class_statics on CPU tensors with the C entry replaced:
    one call, the ints and pointers in the enums' order, each pointer the
    tensor named (the outputs' at their offsets in the one buffer), and
    the outputs views of that buffer."""
    _, ts = encode(build("operators"))
    cluster, pods, sel, pref = ts[:4]
    reps = torch.clamp(pods.spec_rep, 0, pods.valid.shape[0] - 1).to(torch.int32)
    seen = []

    def entry(arr_i, arr_p, stream):
        seen.append((list(arr_i), list(arr_p)))
        return 0

    monkeypatch.setattr(bindings, "_launcher", lambda name: entry)
    monkeypatch.setattr(bindings, "_stream", lambda dev: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: __import__("contextlib").nullcontext())
    before = bindings.LAUNCHES["class_statics"]
    sfeas, aff, taint, mask = bindings.class_statics(cluster, pods, sel, pref, reps,
                                                     want_sel_mask)
    assert bindings.LAUNCHES["class_statics"] == before + 1 and len(seen) == 1
    ints, ptrs = seen[0]
    n, lw = cluster.label_bits.shape
    s_rows, st, se, sk = sel.expr_ids.shape
    f_rows, fe, fk = pref.expr_ids.shape
    want_ints = dict(n=n, lw=lw, tk=cluster.topo_ids.shape[1], tw=cluster.taint_bits.shape[2],
                     pw=cluster.port_bits.shape[1], p=pods.valid.shape[0], c=reps.shape[0],
                     mt=pods.pref_idx.shape[1], s=s_rows, st=st, se=se, sk=sk, f=f_rows,
                     fe=fe, fk=fk, want_mask=int(want_sel_mask))
    assert ints == [want_ints[k] for k in bindings.STATICS_INTS]
    tensors = dict(
        node_valid=cluster.node_valid, node_name=cluster.name_id,
        label_bits=cluster.label_bits, topo_ids=cluster.topo_ids,
        taint_bits=cluster.taint_bits, node_ports=cluster.port_bits,
        sel_ids=sel.expr_ids, sel_op=sel.expr_op, sel_slot=sel.expr_slot,
        sel_tv=sel.term_valid, pref_ids=pref.expr_ids, pref_op=pref.expr_op,
        pref_slot=pref.expr_slot, pref_valid=pref.valid, reps=reps, pod_valid=pods.valid,
        pod_name=pods.name_id, sel_idx=pods.sel_idx, tol_bits=pods.tol_bits,
        tol_all=pods.tol_all, pod_ports=pods.port_bits, pref_idx=pods.pref_idx,
        pref_weight=pods.pref_weight, sfeas=sfeas, aff=aff, taint=taint, sel_mask=mask)
    for name, ptr in zip(bindings.STATICS_PTRS, ptrs):
        t = tensors[name]
        assert ptr == (t.data_ptr() if t is not None else None), name
    c = reps.shape[0]
    assert sfeas.shape == aff.shape == taint.shape == (c, n)
    assert sfeas.dtype == torch.bool and aff.dtype == taint.dtype == torch.float32
    base = aff.data_ptr()
    assert (taint.data_ptr(), sfeas.data_ptr()) == (base + 4 * c * n, base + 8 * c * n)
    if want_sel_mask:
        assert mask.shape == (s_rows, n) and mask.data_ptr() == base + 9 * c * n
    else:
        assert mask is None


def test_binding_refuses_bad_tables():
    _, ts = encode(build("operators"))
    cluster, pods, sel, pref = ts[:4]
    reps = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(TypeError):
        bindings.class_statics(cluster, pods, sel, pref, reps.to(torch.int64))
    with pytest.raises(ValueError):
        bindings.class_statics(cluster, pods, sel._replace(term_valid=sel.term_valid[:, :1]),
                               pref, reps)
    with pytest.raises(ValueError):
        bindings.class_statics(cluster, pods, sel, pref, reps[None])
