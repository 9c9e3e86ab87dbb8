"""The arithmetic of kernel family_prep (csrc/family_prep.cu), on the CPU.

The kernel runs only on the card, so its three entries are emulated in
numpy step for step and held, with the wrappers' CPU path, to the plain
versions (prep_spread_plain, prep_terms_plain, prep_pref_pod_plain) and to
the reference's prep_spread / prep_terms / prep_pref_pod (jitted, as the
reference's solves run them):

  * the scatter: a (row, node) pair at a time in a shuffled order (the
    atomics' order is free), each value clipped into [0, z) and masked
    with v >= 0, float32 adds that skip a zero addend; the spread entry's
    `sizes` by first-presence flips of a (row, value) flag;
  * the gather: the node words a node at a time, OR-ed from the valid
    terms listed for each word; the pod words and global_any by the
    ballot pack (bit t % 32 of word t / 32 from the lanes of a warp), the
    u32 word stored as its int32 view;
  * the clear: every valid row's bins and words back to zero, so a
    scratch kept between calls of any rows and z stays zero.

On testing/cases.py's spread, inter-pod and preferred seeds, and on
synthetic tables: topology values >= z and < 0, has_bound False, a subset
of the used slots, T = 31, 32, 33 and 65 terms (bit 31, a ragged last
word), a spread row with no eligible node, signed owner weights.  And the
kernel's launch arrays: bindings.FAMILY_INTS / FAMILY_PTRS / FAMILY_ENTRIES
name the source's kF_* / kQ_* / kEntry* enums in order.  Tolerance 0.
"""

import re
from pathlib import Path
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import assign as jassign
from kubernetes_tpu.ops import filters as jfilters
from kubernetes_tpu.ops import interpod as jinter
from kubernetes_tpu.ops import schema as jschema
from kubernetes_tpu.ops import topology as jtopo
from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu_torch.kernels import bindings
from kubernetes_tpu_torch.ops import device as dv
from kubernetes_tpu_torch.ops import filters as tfilters
from kubernetes_tpu_torch.ops import interpod as tinter
from kubernetes_tpu_torch.ops import schema as tschema
from kubernetes_tpu_torch.ops import topology as ttopo
from kubernetes_tpu_torch.testing.cases import interpod_objects, prefpod_objects, spread_objects

SOURCE = Path(__file__).resolve().parent.parent / "kubernetes_tpu_torch/csrc/family_prep.cu"

_jspread = jax.jit(jtopo.prep_spread, static_argnums=(3, 4, 5))
_jterms = jax.jit(jinter.prep_terms, static_argnums=(2, 3, 4, 5))
_jpref = jax.jit(jinter.prep_pref_pod, static_argnums=(2, 3, 4))


class Nodes(NamedTuple):
    """The cluster fields the preps read."""

    topo_ids: np.ndarray    # i32[N, TK]
    node_valid: np.ndarray  # bool[N]


def to_torch(tup):
    """A NamedTuple of numpy arrays as the port holds it (u32 as int32)."""
    return type(tup)(*(torch.from_numpy(np.ascontiguousarray(
        a.view(np.int32) if a.dtype == np.uint32 else a))
        if isinstance(a, np.ndarray) else a for a in tup))


def ballot(lanes: np.ndarray) -> np.ndarray:
    """__ballot_sync over the last axis (32 lanes): the u32 word with bit l
    set where lane l holds true, as its int32 view."""
    shifts = np.arange(32, dtype=np.uint64)
    word = (lanes.astype(np.uint64) << shifts).sum(axis=-1).astype(np.uint32)
    return word.view(np.int32)


def value_at(topo, nd, slot):
    """slot_value: the node's value in the row's slot, clipped into TK."""
    return int(topo[nd, min(max(int(slot), 0), topo.shape[1] - 1)])


def scratch_views(scratch, rows: int, z: int):
    """The kernel's scratch over an int32 buffer, which must be all zero on
    entry: sum_a f32[R, z], sum_b f32[R, z] (spread's presence flags are its
    words, seen i32[R, z]) and a word a row, row_count i32[R]."""
    words = 2 * rows * z + rows
    assert scratch.size >= words and not scratch.any()
    f = scratch.view(np.float32)
    return (f[: rows * z].reshape(rows, z), f[rows * z : 2 * rows * z].reshape(rows, z),
            scratch[rows * z : 2 * rows * z].reshape(rows, z), scratch[2 * rows * z : words])


def clear_scratch(scratch, row_valid, z: int) -> None:
    """Step 3 of the launch: every bin of every valid row in both tables and
    every row's word back to zero."""
    rows = row_valid.shape[0]
    f = scratch.view(np.float32)
    for r in np.nonzero(row_valid)[0]:
        f[r * z : (r + 1) * z] = 0.0
        f[(rows + r) * z : (rows + r + 1) * z] = 0.0
    scratch[2 * rows * z : 2 * rows * z + rows] = 0


def fresh_scratch(rows: int, z: int):
    return np.zeros(2 * rows * z + rows + 1, np.int32)


def scatter(rows, n, z, ok_value, tables, rng, sums=None):
    """The scatter kernel: a (row, node) pair at a time in a shuffled order;
    ok_value(r, nd) gives the node's value, or None where the pair adds
    nothing; each table's float32 value added at bin (r, min(v, z - 1)),
    a zero addend skipped, into `sums` (the scratch's tables; fresh zeros
    when None).  Returns the [R, Z] sums."""
    if sums is None:
        sums = [np.zeros((rows, z), np.float32) for _ in tables]
    for k in rng.permutation(rows * n):
        r, nd = divmod(int(k), n)
        v = ok_value(r, nd)
        if v is None:
            continue
        for s, tab in zip(sums, tables):
            x = np.float32(tab[r, nd])
            if x != 0.0:
                s[r, min(v, z - 1)] = np.float32(s[r, min(v, z - 1)] + x)
    return sums


# ---- spread ------------------------------------------------------------------


def emulate_spread(nodes: Nodes, sel: np.ndarray, table, z: int, has_bound: bool, rng,
                   scratch=None):
    topo, nv = nodes.topo_ids, nodes.node_valid
    c_dim, tk = table.owner_keys.shape
    n = nv.shape[0]
    s_dim = sel.shape[0]
    eligible = np.zeros((c_dim, n), bool)
    v = np.zeros((c_dim, n), np.int32)
    scratch = fresh_scratch(c_dim, z) if scratch is None else scratch
    sums, _sum_b, seen, row_count = scratch_views(scratch, c_dim, z)
    for k in rng.permutation(c_dim * n):
        c, nd = divmod(int(k), n)
        ok = bool(table.valid[c]) and bool(nv[nd])
        sidx = int(table.owner_sel_idx[c])
        if ok and sidx >= 0:
            ok = s_dim > 0 and bool(sel[min(sidx, s_dim - 1), nd])
        for t in range(tk):
            if ok and table.owner_keys[c, t] and topo[nd, t] < 0:
                ok = False
        val = value_at(topo, nd, table.slot[c])
        eligible[c, nd], v[c, nd] = ok, val
        if not ok or val < 0:
            continue
        b = min(val, z - 1)
        m = np.float32(table.node_matches[c, nd])
        if has_bound and m != 0.0:
            sums[c, b] = np.float32(sums[c, b] + m)
        if seen[c, b] == 0:         # atomicExch saw 0: the first presence
            seen[c, b] = 1
            row_count[c] += 1
    counts = np.zeros((c_dim, n), np.float32)
    for c in range(c_dim):
        for nd in range(n):
            if has_bound and v[c, nd] >= 0:
                counts[c, nd] = sums[c, min(v[c, nd], z - 1)]
    sizes = row_count.astype(np.float32)
    clear_scratch(scratch, table.valid, z)
    return counts, eligible, v, sizes


def spread_case(name):
    """(Nodes, sel_mask bool[S, N], SpreadTable, z) of a seeded batch or a
    synthetic table."""
    if name.startswith("seed"):
        nodes, pods, bound = spread_objects(jw, int(name[4:]))
        snap, _ = jschema.SnapshotBuilder().build(nodes, pods, bound_pods=bound)
        sel = np.asarray(jfilters.selector_match(jax.tree.map(jnp.asarray, snap.cluster),
                                                 jax.tree.map(jnp.asarray, snap.selectors)))
        tsnap = dv.to_device(dv.snapshot_from_numpy(snap), "cpu")
        tsel = tfilters.selector_match(tsnap.cluster, tsnap.selectors)
        assert np.array_equal(sel, tsel.numpy())
        return (Nodes(snap.cluster.topo_ids, snap.cluster.node_valid), sel, snap.spread,
                jassign.required_topo_z_split(snap)[0])
    # synthetic: values up to 9 against z = 6 (clipped onto bin 5), absent
    # values, invalid nodes and rows, a selector row no node passes (its
    # rows have no eligible node), owner keys some nodes lack
    rng = np.random.default_rng(11)
    n, tk, c_dim, s_dim = 40, 3, 7, 3
    topo = rng.integers(-1, 10, size=(n, tk)).astype(np.int32)
    nodes = Nodes(topo, rng.random(n) < 0.85)
    sel = rng.random((s_dim, n)) < 0.7
    sel[1] = False
    table = jschema.SpreadTable(
        valid=np.array([1, 1, 1, 0, 1, 1, 1], bool),
        slot=rng.integers(0, tk, size=c_dim).astype(np.int32),
        max_skew=np.ones(c_dim, np.float32), min_domains=np.zeros(c_dim, np.float32),
        hard=np.ones(c_dim, bool),
        owner_sel_idx=np.array([-1, 0, 1, 2, 1, -1, 0], np.int32),
        owner_keys=rng.random((c_dim, tk)) < 0.3,
        node_matches=(rng.integers(0, 4, size=(c_dim, n)) * (rng.random((c_dim, n)) < 0.6))
        .astype(np.float32),
        pod_matches=np.zeros((4, c_dim), bool), pod_idx=np.full((4, 1), -1, np.int32))
    return nodes, sel, table, 6


SPREAD_CASES = [f"seed{s}" for s in range(4)] + ["synthetic"]


@pytest.mark.parametrize("has_bound", [True, False])
@pytest.mark.parametrize("case", SPREAD_CASES)
def test_spread_entry(case, has_bound):
    nodes, sel, table, z = spread_case(case)
    want = _jspread(nodes, sel, table, z, None, has_bound)
    tnodes, ttable = to_torch(nodes), to_torch(table)
    plain = ttopo.prep_spread_plain(tnodes, torch.from_numpy(sel), ttable, z, has_bound)
    wrapped = ttopo.prep_spread(tnodes, torch.from_numpy(sel), ttable, z, has_bound)
    emulated = emulate_spread(nodes, sel, table, z, has_bound, np.random.default_rng(z))
    for k, f in enumerate(ttopo.SpreadState._fields):
        a = np.asarray(getattr(want, f))
        for got in (getattr(plain, f).numpy(), getattr(wrapped, f).numpy(), emulated[k]):
            assert got.dtype == a.dtype and np.array_equal(got, a), f
    if case == "synthetic":
        # the selector row no node passes leaves rows 2 and 4 no eligible node
        assert not emulated[1][[2, 4]].any() and (emulated[3][[2, 4]] == 0).all()
        assert (nodes.topo_ids >= z).any() and (nodes.topo_ids < 0).any()


# ---- terms -------------------------------------------------------------------


def emulate_terms(nodes: Nodes, table, z: int, used, has_bound: bool, rng, scratch=None):
    topo, nv = nodes.topo_ids, nodes.node_valid
    t_dim = table.valid.shape[0]
    n, p = nv.shape[0], table.matches_incoming.shape[0]
    w_dim = (t_dim + 31) // 32
    u = len(used)

    def ok_value(t, nd):
        if not (table.valid[t] and nv[nd]):
            return None
        v = value_at(topo, nd, table.slot[t])
        return v if v >= 0 else None

    # without bound pods no scatter runs and the scratch is not read
    scratch = fresh_scratch(t_dim, z) if scratch is None or not has_bound else scratch
    sum_m, sum_o, _seen, positive = scratch_views(scratch, t_dim, z)
    if has_bound:
        scatter(t_dim, n, z, ok_value, (table.node_matches, table.node_owners), rng,
                (sum_m, sum_o))
        for t in range(t_dim):
            for nd in range(n):
                if ok_value(t, nd) is not None and table.node_matches[t, nd] > 0:
                    positive[t] = 1
    # the node words, a thread a node: each word's bits from the valid terms
    # listed for it in row order (list_rows: first[w] .. first[w + 1])
    listed = [t for t in range(t_dim) if table.valid[t]]
    first = [sum(t < 32 * w for t in listed) for w in range(w_dim + 1)]
    out = {k: np.zeros((n, w_dim), np.uint32) for k in ("present", "blocked", "key")}
    slot_v = np.zeros((u, n), np.int32)
    for nd in range(n):
        for w in range(w_dim):
            for t in listed[first[w] : first[w + 1]] if nv[nd] else ():
                v = value_at(topo, nd, table.slot[t])
                if v < 0:
                    continue
                bit = np.uint32(1 << (t % 32))
                out["key"][nd, w] |= bit
                if has_bound:
                    if sum_m[t, min(v, z - 1)] > 0:
                        out["present"][nd, w] |= bit
                    if sum_o[t, min(v, z - 1)] > 0:
                        out["blocked"][nd, w] |= bit
        for j in range(u):
            slot_v[j, nd] = topo[nd, used[j]]
    out = {k: x.view(np.int32) for k, x in out.items()}
    # the pod words
    mi_in = table.matches_incoming.view(np.int32)
    aff_bits = np.zeros((p, w_dim), np.int32)
    anti_bits = np.zeros((p, w_dim), np.int32)
    mi_slot = np.zeros((u, p, w_dim), np.int32)
    anti_slot = np.zeros((u, p, w_dim), np.int32)
    for i in range(p):
        for w in range(w_dim):
            valid, aff, anti = (np.zeros(32, bool) for _ in range(3))
            slot = np.zeros(32, np.int64)
            live = np.zeros(32, bool)
            for lane in range(32):
                t = 32 * w + lane
                live[lane] = t < t_dim
                if not live[lane]:
                    continue
                slot[lane] = table.slot[t]
                valid[lane] = bool(table.valid[t])
                if valid[lane]:
                    aff[lane] = (table.aff_idx[i] == t).any()
                    anti[lane] = (table.anti_idx[i] == t).any()
            mi = mi_in[i, w] & ballot(valid)
            aff_bits[i, w], anti_bits[i, w] = ballot(aff), ballot(anti)
            for j, s in enumerate(used):
                in_slot = live & (slot == s)
                mi_slot[j, i, w] = mi & ballot(in_slot)
                anti_slot[j, i, w] = ballot(anti & in_slot)
    global_any = np.zeros(w_dim, np.int32)
    for w in range(w_dim):
        lanes = np.zeros(32, bool)
        for lane in range(32):
            t = 32 * w + lane
            lanes[lane] = has_bound and t < t_dim and bool(table.valid[t]) and positive[t]
        global_any[w] = ballot(lanes)
    if has_bound:
        clear_scratch(scratch, table.valid, z)
    return tinter.TermState(out["present"], out["blocked"], global_any, out["key"], slot_v,
                            mi_slot, anti_slot, aff_bits, anti_bits)


def synthetic_terms(t_dim: int):
    """Nodes and a TermTable of t_dim terms: values up to 9 against z = 6,
    absent values, invalid terms and nodes, every bit of some words set."""
    rng = np.random.default_rng(t_dim)
    n, tk, p, ma = 36, 3, 9, 3
    w_dim = (t_dim + 31) // 32
    topo = rng.integers(-1, 10, size=(n, tk)).astype(np.int32)
    nodes = Nodes(topo, rng.random(n) < 0.9)
    valid = rng.random(t_dim) < 0.85
    valid[31 % t_dim] = True                   # bit 31 of word 0 (or the last term)
    valid[-1] = True
    mi = rng.integers(0, 2**32, size=(p, w_dim), dtype=np.uint64).astype(np.uint32)
    mi[0] = 0xFFFFFFFF
    table = jschema.TermTable(
        valid=valid, slot=rng.integers(0, tk, size=t_dim).astype(np.int32),
        node_matches=(rng.integers(0, 3, size=(t_dim, n)) * (rng.random((t_dim, n)) < 0.3))
        .astype(np.float32),
        node_owners=(rng.integers(0, 3, size=(t_dim, n)) * (rng.random((t_dim, n)) < 0.2))
        .astype(np.float32),
        matches_incoming=mi,
        aff_idx=rng.integers(-1, t_dim, size=(p, ma)).astype(np.int32),
        anti_idx=rng.integers(-1, t_dim, size=(p, ma)).astype(np.int32),
        self_match_all=rng.random(p) < 0.5)
    table.anti_idx[1] = [t_dim - 1, 31 % t_dim, -1]
    return nodes, table, 6, (0, 2)


def terms_case(name):
    """(Nodes, TermTable, z, the batch's slots) of a seeded batch or a
    synthetic table of T terms."""
    if name.startswith("seed"):
        seed = int(name[4:])
        nodes, pods, bound = interpod_objects(jw, seed, anti_only=seed % 2 == 1)
        snap, _ = jschema.SnapshotBuilder().build(nodes, pods, bound_pods=bound)
        features = jassign.features_of(snap)
        return (Nodes(snap.cluster.topo_ids, snap.cluster.node_valid), snap.terms,
                jassign.required_topo_z_split(snap)[1], features.term_slots)
    return synthetic_terms(int(name[1:]))


TERM_CASES = ["seed0", "seed1", "T31", "T32", "T33", "T65"]


@pytest.mark.parametrize("all_slots", [False, True])
@pytest.mark.parametrize("has_bound", [True, False])
@pytest.mark.parametrize("case", TERM_CASES)
def test_terms_entry(case, has_bound, all_slots):
    nodes, table, z, slots = terms_case(case)
    tk = nodes.topo_ids.shape[1]
    slots = () if all_slots else tuple(slots)
    used = tinter.used_slots(slots, tk)
    if case.startswith("T") and not all_slots:
        assert len(used) < tk                  # a subset of the slots
    want = _jterms(nodes, table, z, None, slots, has_bound)
    tnodes, ttable = to_torch(nodes), to_torch(table)
    plain = tinter.prep_terms_plain(tnodes, ttable, z, slots, has_bound)
    wrapped = tinter.prep_terms(tnodes, ttable, z, slots, has_bound)
    emulated = emulate_terms(nodes, table, z, used, has_bound, np.random.default_rng(len(used)))
    for f in tinter.TermState._fields:
        a = np.asarray(getattr(want, f))
        a = a if f == "slot_v" else a.view(np.int32)
        for got in (getattr(plain, f).numpy(), getattr(wrapped, f).numpy(),
                    getattr(emulated, f)):
            assert got.dtype == a.dtype and np.array_equal(got, a), f
    if case != "T31" and case.startswith("T"):
        assert (emulated.key_bits < 0).any()   # bit 31 set: a negative int32 view


# ---- pref --------------------------------------------------------------------


def emulate_pref(nodes: Nodes, table, z: int, has_bound: bool, rng, scratch=None):
    topo, nv = nodes.topo_ids, nodes.node_valid
    u_dim, n = table.valid.shape[0], nv.shape[0]

    def ok_value(r, nd):
        if not (table.valid[r] and nv[nd]):
            return None
        v = value_at(topo, nd, table.slot[r])
        return v if v >= 0 else None

    counts = np.zeros((u_dim, n), np.float32)
    ownerw = np.zeros((u_dim, n), np.float32)
    if not has_bound:
        return counts, ownerw
    scratch = fresh_scratch(u_dim, z) if scratch is None else scratch
    sum_c, sum_w, _seen, _row_count = scratch_views(scratch, u_dim, z)
    scatter(u_dim, n, z, ok_value, (table.node_counts, table.owner_weight), rng, (sum_c, sum_w))
    for r in range(u_dim):
        for nd in range(n):
            v = ok_value(r, nd)
            if v is not None:
                counts[r, nd], ownerw[r, nd] = sum_c[r, min(v, z - 1)], sum_w[r, min(v, z - 1)]
    clear_scratch(scratch, table.valid, z)
    return counts, ownerw


def pref_case(name):
    if name.startswith("seed"):
        nodes, pods, bound = prefpod_objects(jw, int(name[4:]))
        snap, _ = jschema.SnapshotBuilder().build(nodes, pods, bound_pods=bound)
        return (Nodes(snap.cluster.topo_ids, snap.cluster.node_valid), snap.prefpod,
                jassign.required_topo_z_split(snap)[1])
    # synthetic: signed owner weights of 1-100 (sums that cancel), values
    # up to 9 against z = 6, absent values, invalid rows and nodes
    rng = np.random.default_rng(5)
    n, tk, u_dim, p = 40, 2, 6, 4
    nodes = Nodes(rng.integers(-1, 10, size=(n, tk)).astype(np.int32), rng.random(n) < 0.9)
    sign = np.where(rng.random((u_dim, n)) < 0.5, -1, 1)
    table = jschema.PrefPodTable(
        valid=np.array([1, 1, 0, 1, 1, 1], bool),
        slot=rng.integers(0, tk, size=u_dim).astype(np.int32),
        node_counts=rng.integers(0, 5, size=(u_dim, n)).astype(np.float32),
        owner_weight=(sign * rng.integers(0, 101, size=(u_dim, n))).astype(np.float32),
        matches_incoming=np.zeros((p, u_dim), bool), pod_idx=np.full((p, 1), -1, np.int32),
        pod_weight=np.zeros((p, 1), np.float32))
    return nodes, table, 6


@pytest.mark.parametrize("has_bound", [True, False])
@pytest.mark.parametrize("case", ["seed0", "seed1", "synthetic"])
def test_pref_entry(case, has_bound):
    nodes, table, z = pref_case(case)
    want = _jpref(nodes, table, z, None, has_bound)
    tnodes, ttable = to_torch(nodes), to_torch(table)
    plain = tinter.prep_pref_pod_plain(tnodes, ttable, z, has_bound)
    wrapped = tinter.prep_pref_pod(tnodes, ttable, z, has_bound)
    emulated = emulate_pref(nodes, table, z, has_bound, np.random.default_rng(z))
    for k, f in enumerate(tinter.PrefPodState._fields):
        a = np.asarray(getattr(want, f))
        for got in (getattr(plain, f).numpy(), getattr(wrapped, f).numpy(), emulated[k]):
            assert got.dtype == a.dtype and np.array_equal(got, a), f
    if case == "synthetic" and has_bound:
        assert (emulated[1] < 0).any()


# ---- the launch arrays -------------------------------------------------------------


def _enum(prefix: str, first: str):
    body = re.search(r"enum \{\s*(" + prefix + first + r"\b.*?)\};", SOURCE.read_text(), re.S)
    assert body, prefix
    return [e.strip() for e in body.group(1).replace("\n", " ").split(",") if e.strip()]


@pytest.mark.parametrize("prefix,first,names", [("kF_", "N", bindings.FAMILY_INTS),
                                                ("kQ_", "TOPO_IDS", bindings.FAMILY_PTRS)])
def test_launch_arrays_follow_the_source(prefix, first, names):
    entries = _enum(prefix, first)
    assert entries[-1] == f"{prefix}COUNT"
    assert [e[len(prefix):].lower() for e in entries[:-1]] == list(names)


def test_entries_follow_the_source():
    entries = _enum("kEntry", "Spread")
    flags = dict((k.strip(), int(v)) for k, v in (e.split("=") for e in entries if "=" in e))
    assert {f"kEntry{k.capitalize()}": v for k, v in bindings.FAMILY_ENTRIES.items()} == flags
    assert "family_prep" in bindings.LAUNCHES


# ---- one launch, one allocation, a scratch that clears itself ----------------


@pytest.mark.parametrize("dims", [dict(n=37, rows=5, p=11, w=2, u=3),
                                  dict(n=8192, rows=32, p=1024, w=1, u=1),
                                  dict(n=65536, rows=3, p=16, w=1, u=2),
                                  dict(n=0, rows=0, p=0, w=1, u=1)])
@pytest.mark.parametrize("entry", ["spread", "terms", "pref"])
def test_output_layout(entry, dims):
    """The outputs' one allocation: offsets 16-byte aligned, in
    FAMILY_OUTPUTS order, not overlapping, inside the allocation; each view
    of its shape and dtype at its offset, writes to one leaving the others."""
    layout, total = bindings.family_layout(entry, **dims)
    assert [(k, d) for k, d, _s, _o in layout] == list(bindings.FAMILY_OUTPUTS[entry])
    buf, views = bindings._family_outputs(entry, torch.device("cpu"), dims)
    assert buf.dtype == torch.int32 and buf.numel() * 4 >= total
    end = 0
    for name, dtype, shape, off in layout:
        size = int(np.prod(shape)) * (1 if dtype is torch.bool else 4)
        assert off % bindings.FAMILY_ALIGN == 0 and off >= end and off + size <= total
        end = off + size
        view = views[name]
        assert view.dtype is dtype and tuple(view.shape) == shape and view.is_contiguous()
        if size:
            assert view.data_ptr() == buf.data_ptr() + off
    buf.zero_()
    for k, (name, _dtype, _shape, _off) in enumerate(layout):
        views[name].view(torch.uint8).fill_(k + 1)
    for k, (name, _d, _s, _o) in enumerate(layout):
        assert bool((views[name].view(torch.uint8) == k + 1).all()), name


def test_output_offsets_follow_the_source():
    """make_args hands out the outputs at off[k] in FAMILY_OUTPUTS order,
    and the source's counts and alignment are the bindings'."""
    text = SOURCE.read_text()
    got = re.findall(r"a\.(\w+) = .*out \+ off\[(\d+)\]", text)
    names = [k for e in ("spread", "terms", "pref") for k, _d in bindings.FAMILY_OUTPUTS[e]]
    idx = [k for e in ("spread", "terms", "pref")
           for k in range(len(bindings.FAMILY_OUTPUTS[e]))]
    assert [(n, int(i)) for n, i in got] == list(zip(names, idx))
    outs = dict(re.findall(r"kOut(\w+) = (\d+)", text))
    assert {k.lower(): int(v) for k, v in outs.items()} == {
        e: len(bindings.FAMILY_OUTPUTS[e]) for e in ("spread", "terms", "pref")}
    assert int(re.search(r"kAlign = (\d+);", text).group(1)) == bindings.FAMILY_ALIGN
    assert int(re.search(r"kMaxRows = (\d+);", text).group(1)) == bindings.FAMILY_MAX_ROWS


def test_scratch_clears_itself_over_calls():
    """One scratch buffer, zero when it was made, through calls of every
    entry at different rows and z in turn (spread 7 x 6, terms 65 x 6,
    pref 6 x 6, then the seeds' own z): each call reads it as zero, leaves
    it zero, and equals the plain twin."""
    scratch = np.zeros(1 << 14, np.int32)
    rng = np.random.default_rng(3)
    calls = [("spread", "synthetic"), ("terms", "T65"), ("pref", "synthetic"),
             ("spread", "seed1"), ("terms", "seed0"), ("pref", "seed1"), ("terms", "T33")]
    widths = set()
    for entry, case in calls:
        if entry == "spread":
            nodes, sel, table, z = spread_case(case)
            got = emulate_spread(nodes, sel, table, z, True, rng, scratch)
            want = ttopo.prep_spread_plain(to_torch(nodes), torch.from_numpy(sel),
                                           to_torch(table), z, True)
            rows = table.valid.shape[0]
        elif entry == "terms":
            nodes, table, z, slots = terms_case(case)
            used = tinter.used_slots(tuple(slots), nodes.topo_ids.shape[1])
            got = emulate_terms(nodes, table, z, used, True, rng, scratch)
            want = tinter.prep_terms_plain(to_torch(nodes), to_torch(table), z, tuple(slots),
                                           True)
            rows = table.valid.shape[0]
        else:
            nodes, table, z = pref_case(case)
            got = emulate_pref(nodes, table, z, True, rng, scratch)
            want = tinter.prep_pref_pod_plain(to_torch(nodes), to_torch(table), z, True)
            rows = table.valid.shape[0]
        widths.add((rows, z))
        assert not scratch.any(), (entry, case)
        for g, w in zip(got, want):
            g = np.asarray(g)
            assert np.array_equal(g, w.numpy().view(g.dtype) if g.dtype != bool else w.numpy())
    assert len(widths) >= 5
