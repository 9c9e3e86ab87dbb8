"""The preemption kernels' redesign: preempt_dry_run (one launch, the
block-order prefix in shared memory chunk by chunk) and pod_filters (the
pods' selector rows evaluated from the node tile), on the CPU.

Four parts:

- the wrappers (their CPU paths: batched_dry_run_plain,
  dry_run_victims_plain, match_rows_plain + filter_rows_plain) equal the
  reference's jnp functions exactly, on every field, on seeded inputs with
  not-whole-MiB requests, PDB reorders, elig_len 0, masks that are not
  prefixes, +inf free and junk, and selector tables with no valid row;
- a numpy emulation of the dry run's plan — lane b sums 16-slot block b,
  lane b adds the chunk's totals 0..b-1 and the running total of the
  earlier 256-slot chunks; the first fit a walk over spans of at most 16
  k and ballots of up to 32 k past that, on rows of 4, 8 and 32 lanes —
  equals prefix_sum and the sequential first-fit walk bit for bit, at K
  around the blocks and the chunks and bounds 0, 1, K - 1, K;
- a numpy emulation of pod_filters' tile plan (the rows the pods name
  marked, listed and evaluated once a tile, pods in chunks) equals the
  reference's Filter slice and chain, and evaluates no other row;
- the bindings marshal their launch arrays in the order of the sources'
  enums (the binding functions run on CPU tensors with the C entries
  replaced), the pass's four outputs are views of one allocation, and the
  sources' constants are the bindings'.
"""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.api import types as japi
from kubernetes_tpu.ops import filters as jfilters
from kubernetes_tpu.ops import preemption as jpre
from kubernetes_tpu.ops import schema as jschema
from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu_torch.kernels import bindings
from kubernetes_tpu_torch.ops import auction as tauction
from kubernetes_tpu_torch.ops import device as dv
from kubernetes_tpu_torch.ops import filters as tfilters
from kubernetes_tpu_torch.ops import preemption as tpre
from kubernetes_tpu_torch.testing.cases import dry_run_edges, dry_run_inputs, victim_masks

CSRC = Path(__file__).resolve().parent.parent / "kubernetes_tpu_torch" / "csrc"
F32 = np.float32
BLOCK, CHUNK, GROUP = 16, bindings.DRY_RUN_CHUNK, bindings.DRY_RUN_POD_GROUP


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def same(a, b):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


# ---- the wrappers against the reference ------------------------------------------


@pytest.mark.parametrize("seed,k,levels,pods", [(0, 4, 1, 8), (1, 17, 3, 40), (2, 257, 2, 8)])
def test_batched_dry_run_edges_match_reference(seed, k, levels, pods):
    """Bounds 0, 1, K - 1, K and past the slots, PDB reorders, +inf free,
    +inf junk in and out of the prefix, not-whole-MiB memory; through the
    dry run alone and through the pass's one call."""
    inputs = dry_run_edges(dry_run_inputs(seed, n=24, k=k, r=4, levels=levels, pods=pods,
                                          frac=True), seed)
    want = jax.jit(jpre.batched_dry_run)(jpre.PreemptionBatch(*(jnp.asarray(a) for a in inputs)))
    batch = tpre.PreemptionBatch(*(t(a) for a in inputs))
    got = tpre.run_batched_dry_run(batch)
    for name, w, g in zip(tpre.BatchDryRunResult._fields, want, got):
        assert same(w, g), name
    assert got.feasible.any() and not got.feasible.all()
    assert (got.viol_k > 0).any()
    snap = mixed_snapshot(seed)
    result, static = tpre.run_preemption_pass(batch, *snap[1][:2], snap[1].selectors)
    for name, w, g in zip(tpre.BatchDryRunResult._fields, want, result):
        assert same(w, g), name
    js = snap[0]
    assert same(jax.jit(jpre.static_feasible_batch)(js.cluster, js.pods, js.selectors), static)


@pytest.mark.parametrize("seed,k", [(3, 5), (4, 33)])
def test_dry_run_victims_edges_match_reference(seed, k):
    """Masks that are not prefixes, bounds 0, 1, K - 1, K, +inf free and junk."""
    free, victim_req, *_rest, pods_req, _ = dry_run_edges(
        dry_run_inputs(seed, n=16, k=k, r=4, pods=6, frac=True), seed)
    valid = victim_masks(seed, 16, k)
    for p in range(pods_req.shape[0]):
        want = jpre.dry_run_victims(free, victim_req, valid, pods_req[p])
        got = tpre.dry_run_victims(t(free), t(victim_req), t(valid), t(pods_req[p]))
        assert same(want.feasible, got.feasible), p
        assert same(want.min_k, got.min_k), p


def mixed_snapshot(seed):
    from kubernetes_tpu_torch.testing.cases import mixed_objects

    nodes, pods, bound = mixed_objects(jw, seed)
    snap, _ = jschema.SnapshotBuilder().build(nodes, pods, bound_pods=bound)
    return jax.tree.map(jnp.asarray, snap), dv.to_device(dv.snapshot_from_numpy(snap), "cpu")


def no_selector_snapshot():
    """Pods without a selector: the table is its pad row alone, no valid
    term, and no pod names it."""
    nodes = [jw.make_node(f"n{i}").zone(f"z{i % 3}").obj() for i in range(10)]
    pods = [jw.make_pod(f"p{i}").req(cpu_milli=100 * (i + 1), mem=500 * jw.MI).obj()
            for i in range(5)]
    snap, _ = jschema.SnapshotBuilder().build(nodes, pods)
    assert not snap.selectors.term_valid.any() and (snap.pods.sel_idx < 0).all()
    return jax.tree.map(jnp.asarray, snap), dv.to_device(dv.snapshot_from_numpy(snap), "cpu")


@pytest.mark.parametrize("case", ["mixed0", "mixed3", "no_selector"])
def test_filter_slice_and_chain_match_reference(case):
    js, ts = no_selector_snapshot() if case == "no_selector" else mixed_snapshot(int(case[-1]))
    want = jax.jit(jpre.static_feasible_batch)(js.cluster, js.pods, js.selectors)
    assert same(want, tpre.run_static_feasible_batch(ts.cluster, ts.pods, ts.selectors))
    want = jax.jit(jfilters.feasible_batch)(js.cluster, js.pods, js.selectors)
    assert same(want, tfilters.feasible_batch(ts.cluster, ts.pods, ts.selectors))


# ---- the dry run's plan, emulated --------------------------------------------------


def emulate_prefix(x):
    """The kernel's prefix sum of x [rows, K, R] (float32), chunk by chunk:
    lane b's sequential sum of block b, then lane b's add of the chunk's
    totals 0..b-1 summed in order plus the earlier chunks' running total;
    the running total grows by the chunk's totals summed in order."""
    rows, k, r = x.shape
    out = np.empty_like(x)
    carry = np.zeros((rows, r), F32)
    for q in range(-(-k // CHUNK)):
        base = q * CHUNK
        cs = min(CHUNK, k - base)
        nblk = -(-cs // BLOCK)
        c = x[:, base:base + cs].copy()
        tot = np.zeros((rows, nblk, r), F32)
        for b in range(nblk):                     # level 0: lane b
            run = np.zeros((rows, r), F32)
            for j in range(b * BLOCK, min(cs, (b + 1) * BLOCK)):
                run = run + c[:, j]
                c[:, j] = run
            tot[:, b] = run
        for b in range(nblk):                     # level 1, + level 2's carry
            run = np.zeros((rows, r), F32)
            for i in range(b):
                run = run + tot[:, i]
            if b == 0 and q == 0:
                continue
            add = carry if b == 0 else (run + carry if q > 0 else run)
            blk = slice(b * BLOCK, min(cs, (b + 1) * BLOCK))
            c[:, blk] = c[:, blk] + add[:, None]
        run = np.zeros((rows, r), F32)
        for i in range(nblk):
            run = run + tot[:, i]
        carry = run if q == 0 else carry + run
        out[:, base:base + cs] = c
    return out


def emulate_first_fit(free, cum, req, kmax, flags, lanes=32):
    """One pod on one row, chunk by chunk over the chunk's candidate k (0
    in the first): spans of at most 16 k walked in order (a lane a pod);
    wider spans in ballots of W k (W = the span rounded up to a power of
    two, at most the row's `lanes`), the first set bit; viol_k from flag
    words of `lanes` bits and their popcounts.  (feasible, min_k, viol_k)."""
    k = cum.shape[0]
    words = [sum(1 << int(i) for i in np.flatnonzero(flags[w:w + lanes]))
             for w in range(0, k, lanes)]

    def test(kk, base):
        f = free + (F32(0.0) if kk == 0 else cum[kk - 1])
        return bool(np.all((req <= 0) | (req <= f)))

    def viol(kk, base, vbase):
        if kk == 0:
            return 0
        last = kk - 1 - base
        w0 = base // lanes
        v = vbase + sum(bin(words[w0 + w]).count("1") for w in range(last // lanes))
        bits = last % lanes + 1
        return v + bin(words[w0 + last // lanes] & ((1 << bits) - 1)).count("1")

    if kmax < 0:
        return False, 0, 0
    vbase = 0
    for q in range(-(-k // CHUNK)):
        base = q * CHUNK
        cs = min(CHUNK, k - base)
        k_lo, k_hi = (0 if q == 0 else base + 1), min(base + cs, kmax)
        if k_hi < k_lo:
            break
        span = k_hi - k_lo + 1
        if span <= 16:
            for kk in range(k_lo, k_hi + 1):
                if test(kk, base):
                    return True, kk, viol(kk, base, vbase)
        else:
            wk = 1
            while wk < span and wk < lanes:
                wk *= 2
            for j0 in range(0, span, wk):
                hit = sum(1 << off for off in range(wk)
                          if j0 + off < span and test(k_lo + j0 + off, base))
                if hit:
                    kk = k_lo + j0 + (hit & -hit).bit_length() - 1
                    return True, kk, viol(kk, base, vbase)
        vbase += sum(bin(words[w]).count("1")
                     for w in range(base // lanes, (base + cs + lanes - 1) // lanes))
    return False, 0, 0


def sequential_walk(free, cum, req, kmax, flags):
    """k = 0, 1, ... in turn: the first k <= kmax whose free + cum[k - 1]
    (free + 0.0 at k = 0) holds the request."""
    f = free[None, :] + np.concatenate([np.zeros_like(cum[:1]), cum])
    fits = np.all((req[None, :] <= 0) | (req[None, :] <= f), axis=1)
    fits &= np.arange(len(fits)) <= kmax
    if not fits.any():
        return False, 0, 0
    kk = int(np.argmax(fits))
    return True, kk, int(flags[:kk].sum())


@pytest.mark.parametrize("k", [1, 15, 16, 17, 255, 256, 257, 511, 512, 513, 4096])
def test_emulated_plan_equals_prefix_sum_and_the_walk(k):
    """The emulated chunks equal prefix_sum (the reference's order) bit for
    bit, and the emulated first fit (walks and ballots, rows of 4, 8 and
    32 lanes) the sequential walk, at bounds 0, 1, K - 1 and K.  Not-whole-MiB memory makes the order matter: past 512
    slots a sequential running sum differs from prefix_sum somewhere."""
    rng = np.random.default_rng(k)
    rows, r = 3, 2
    x = np.zeros((rows, k, r), F32)
    x[:, :, 0] = (rng.integers(40, 900, size=(rows, k)) * F32(95.367431640625)).astype(F32)
    x[:, :, 1] = rng.integers(0, 2, size=(rows, k)).astype(F32)
    x[2, :, 0] *= rng.random(k) < 0.7                    # a mask that is not a prefix
    got = emulate_prefix(x)
    want = tauction.prefix_sum(t(np.moveaxis(x, 1, 0))).numpy()
    assert np.array_equal(got.view(np.uint32), np.moveaxis(want, 0, 1).view(np.uint32))
    if k > 512:
        assert not np.array_equal(got, np.cumsum(x, axis=1, dtype=F32))
    flags = rng.random(k) < 0.3
    free = np.array([F32(100.0), F32(0.0)])
    for kmax in sorted({0, 1, k - 1, k}):
        for target in sorted({0, min(1, k - 1), k // 2, k - 1}):
            req = np.array([got[0, target, 0], F32(0.0)], F32)
            for row in range(rows):
                w = sequential_walk(free, got[row], req, kmax, flags)
                for lanes in (4, 8, 32):
                    e = emulate_first_fit(free, got[row], req, kmax, flags, lanes)
                    assert e == w, (kmax, target, row, lanes)
    # the whole dry run: the plain version (prefix_sum, _first_fit) agrees
    perm = np.tile(np.arange(k, dtype=np.int32), (1, rows, 1))
    elig = np.array([[k, k // 2, k]], np.int32)
    pods_req = np.stack([np.array([got[0, j, 0], F32(1.0)], F32) for j in (0, k // 3, k - 1)])
    batch = tpre.PreemptionBatch(t(np.zeros((rows, r), F32)), t(x), t(perm), t(elig),
                                 t(np.tile(flags, (1, rows, 1))), t(pods_req),
                                 t(np.zeros(3, np.int32)))
    plain = tpre.batched_dry_run_plain(batch)
    masked = x * (np.arange(k)[None, :, None] < elig[0][:, None, None])
    cum = emulate_prefix(masked.astype(F32))
    for p in range(3):
        for row in range(rows):
            want = (bool(plain.feasible[p, row]), int(plain.min_k[p, row]),
                    int(plain.viol_k[p, row]))
            got_p = emulate_first_fit(np.zeros(r, F32), cum[row], pods_req[p], int(elig[0, row]),
                                      flags & (np.arange(k) < elig[0, row]))
            assert got_p == want, (p, row)


# ---- pod_filters' tile plan, emulated ---------------------------------------------


def selector_snapshot(s: int, p: int, seed: int):
    """S selector rows (a quarter padding rows with no valid term, named by
    no pod) over 40 nodes, P pods naming live rows or none (-1), drawn from
    a snapshot of 40 distinct selectors over labels and topology slots."""
    rng = np.random.default_rng(seed)
    nodes = []
    for i in range(40):
        w = jw.make_node(f"n{i}").zone(f"z{i % 4}").label("gen", str(i % 7))
        if i % 3 == 0:
            w = w.label("disk", "ssd")
        if rng.random() < 0.2:
            w = w.taint("hard", "x", japi.NO_SCHEDULE)
        nodes.append(w.obj())
    mk = jw.make_pod
    pods = []
    for i in range(40):
        kind = i % 4
        if kind == 0:
            w = mk(f"s{i}").required_affinity("gen", japi.OP_IN, [str(i % 7), str(i % 5)])
        elif kind == 1:
            w = mk(f"s{i}").required_affinity(japi.LABEL_ZONE, japi.OP_NOT_IN, [f"z{i % 4}"]) \
                .required_affinity("disk", japi.OP_EXISTS)
        elif kind == 2:
            w = mk(f"s{i}").required_affinity(japi.LABEL_HOSTNAME, japi.OP_IN,
                                              [f"n{i}", f"n{(3 * i) % 40}"])
        else:
            w = mk(f"s{i}").required_affinity("disk", japi.OP_DOES_NOT_EXIST) \
                .required_affinity("gen", japi.OP_NOT_IN, [str(i % 7)])
        if i % 5 == 0:
            w = w.toleration("hard", japi.OP_EXISTS)
        pods.append(w.obj())
    snap, _ = jschema.SnapshotBuilder().build(nodes, pods)
    sel = snap.selectors
    live = np.flatnonzero(sel.term_valid.any(axis=1))
    pick = rng.choice(live, s)
    pad = rng.random(s) < 0.25
    sel = sel._replace(expr_ids=sel.expr_ids[pick], expr_op=sel.expr_op[pick],
                       expr_slot=sel.expr_slot[pick],
                       term_valid=sel.term_valid[pick] & ~pad[:, None])
    rows = np.flatnonzero(~pad)
    take = rng.integers(0, 40, p)
    pp = snap.pods
    fields = {}
    for name in pp._fields:
        a = np.asarray(getattr(pp, name))
        if name in ("tol_bits", "tol_all"):
            fields[name] = a[:, take]
        elif a.ndim and a.shape[0] == pp.valid.shape[0] and name not in (
                "class_rep", "spec_rep", "joint_spec", "cons_rep", "joint_cons"):
            fields[name] = a[take]
        else:
            fields[name] = a
    fields["sel_idx"] = np.where(rng.random(p) < 0.25, -1,
                                 rng.choice(rows, p) if rows.size else -1).astype(np.int32)
    return snap._replace(pods=type(pp)(**fields), selectors=sel)


def emulate_filters(ts, full: bool, tile: int, row_chunk: int, pod_chunk: int):
    """The pod_filters launch, block by block, in numpy: per tile of nodes,
    per chunk of pods and of selector rows, mark the rows the chunk's pods
    name, list and evaluate each (the plain row match at the tile's
    nodes: the word statics::match_row gives), each pod reading only its
    row's word; with S <= row_chunk the marks persist across pod chunks.
    The per-(pod, node) body is the Filter chain under an all-true
    selector row.  Returns (out [P, N], evaluations [(tile, row)])."""
    cluster, pods, sel = ts.cluster, ts.pods, ts.selectors
    n, p, s = cluster.node_valid.shape[0], pods.valid.shape[0], sel.term_valid.shape[0]
    row_match = tfilters.match_rows_plain(cluster, sel.expr_ids, sel.expr_op, sel.expr_slot,
                                          sel.term_valid).numpy()
    base = tfilters.filter_rows_plain(cluster, pods, torch.ones((s, n), dtype=torch.bool),
                                      full).numpy()
    sel_idx = pods.sel_idx.numpy()
    named = [-1 if x < 0 else min(int(x), s - 1) for x in sel_idx]
    out = np.zeros((p, n), bool)
    evals = []
    one_row_chunk = s <= row_chunk
    for t0 in range(0, n, tile):
        nodes = slice(t0, min(n, t0 + tile))
        nt = nodes.stop - t0
        mark = np.zeros(s, np.int8)
        word = {}
        for p0 in range(0, p, pod_chunk):
            chunk = range(p0, min(p, p0 + pod_chunk))
            psel = {i: np.ones(nt, bool) for i in chunk if named[i] < 0}
            for r0 in range(0, s, row_chunk):
                rows = range(r0, min(s, r0 + row_chunk))
                if not one_row_chunk:
                    mark[r0:rows.stop] = 0
                    word = {}
                for i in chunk:
                    if named[i] in rows and mark[named[i]] == 0:
                        mark[named[i]] = 1
                for row in [r for r in rows if mark[r] == 1]:
                    mark[row] = 2
                    evals.append((t0, row))
                    word[row] = row_match[row, nodes]
                for i in chunk:
                    if named[i] in rows:
                        psel[i] = word[named[i]]
            for i in chunk:
                out[i, nodes] = base[i, nodes] & psel[i]
    return out, evals


@functools.lru_cache(maxsize=None)
def plan_case(s: int, p: int):
    """(snapshot, its tensors on the CPU, the plain Filter slice and chain
    by mode) of a plan case."""
    snap = selector_snapshot(s, p, seed=s * 100 + p)
    ts = dv.to_device(dv.snapshot_from_numpy(snap), "cpu")
    sel = ts.selectors
    mask = tfilters.match_rows_plain(ts.cluster, sel.expr_ids, sel.expr_op, sel.expr_slot,
                                     sel.term_valid)
    plain = {full: tfilters.filter_rows_plain(ts.cluster, ts.pods, mask, full).numpy()
             for full in (False, True)}
    return snap, ts, plain


@pytest.mark.parametrize("s", [1, 31, 32, 33])
def test_filter_plan_cases_match_reference(s):
    """The plan cases' plain slice and chain (what the emulation is held
    to below) equal the reference's."""
    snap, _ts, plain = plan_case(s, 65)
    js = jax.tree.map(jnp.asarray, snap)
    assert np.array_equal(np.asarray(jax.jit(jpre.static_feasible_batch)(
        js.cluster, js.pods, js.selectors)), plain[False])
    assert np.array_equal(np.asarray(jax.jit(jfilters.feasible_batch)(
        js.cluster, js.pods, js.selectors)), plain[True])


@pytest.mark.parametrize("s", [1, 31, 32, 33])
@pytest.mark.parametrize("p,pod_chunk", [(3, 4), (4, 4), (5, 4), (63, 64), (64, 64), (65, 64)])
def test_filter_tile_plan(s, p, pod_chunk):
    """Rows chunked by 32 (the emulated kRowChunk), tiles of 32 nodes (40
    nodes: a whole tile and a partial one), pod chunks at their edges: the
    plan gives the plain slice and chain (the reference's), evaluates each
    named row once a tile (S <= 32) or once a pod chunk that names it
    (S = 33), and no other row — the padding rows never."""
    snap, ts, plain = plan_case(s, p)
    for full in (False, True):
        got, evals = emulate_filters(ts, full, bindings.STATICS_TILE, 32, pod_chunk)
        assert np.array_equal(plain[full], got), full
    named = [min(int(x), s - 1) for x in snap.pods.sel_idx if x >= 0]
    padding = set(np.flatnonzero(~snap.selectors.term_valid.any(axis=1)).tolist())
    assert not padding & set(named)
    for t0 in (0, bindings.STATICS_TILE):
        rows = [row for tt, row in evals if tt == t0]
        assert set(rows) == set(named)
        if s <= 32:
            assert len(rows) == len(set(rows))
        else:
            chunks = [{min(int(x), s - 1) for x in snap.pods.sel_idx[c0:c0 + pod_chunk]
                       if x >= 0} for c0 in range(0, p, pod_chunk)]
            for row in set(rows):
                assert rows.count(row) == sum(row in c for c in chunks)


# ---- the bindings' launch arrays and the sources' constants ---------------------------


def _enum(src_name: str, prefix: str, first: str):
    src = (CSRC / src_name).read_text()
    body = re.search(r"enum \{\s*(" + prefix + first + r"\b.*?)\};", src, re.S)
    assert body, (src_name, prefix)
    return [e.strip() for e in body.group(1).replace("\n", " ").split(",") if e.strip()]


@pytest.mark.parametrize("src,prefix,first,names", [
    ("preempt_dry_run.cu", "kI_", "L", bindings.DRY_RUN_INTS),
    ("preempt_dry_run.cu", "kP_", "FREE", bindings.DRY_RUN_PTRS),
    ("pod_filters.cu", "kI_", "N", bindings.FILTERS_INTS),
    ("pod_filters.cu", "kP_", "NODE_VALID", bindings.FILTERS_PTRS),
])
def test_launch_arrays_follow_the_sources(src, prefix, first, names):
    entries = _enum(src, prefix, first)
    assert entries[-1] == f"{prefix}COUNT"
    assert [e[len(prefix):].lower() for e in entries[:-1]] == list(names)


def test_constants_follow_the_sources():
    dry = (CSRC / "preempt_dry_run.cu").read_text()
    pf = (CSRC / "pod_filters.cu").read_text()
    assert re.search(r"constexpr int kScanBlock = 16;", dry)
    assert re.search(r"constexpr int kChunk = kScanBlock \* kScanBlock;", dry)
    assert re.search(r"constexpr int kMaxK = kChunk \* kScanBlock;", dry)
    assert CHUNK == 256 and bindings.MAX_VICTIM_SLOTS == CHUNK * 16
    assert re.search(rf"constexpr int kPodGroup = {GROUP};", dry)
    assert re.search(rf"constexpr int kRowChunk = {bindings.FILTERS_ROW_CHUNK};", pf)
    assert re.search(rf"constexpr int kPodChunk = {bindings.FILTERS_POD_CHUNK};", pf)
    assert '#include "statics_common.cuh"' in pf and "statics::tile_match" in pf
    # no global scratch and no per-thread array: one kernel, shared memory only
    assert len(re.findall(r"__global__", dry)) == 1
    assert not re.search(r"\b(float|int|int32_t)\s+\w+\[[^\]]+\];", dry)


@pytest.fixture
def entries(monkeypatch):
    """The C entries replaced: each call's (name, ints, pointers)."""
    seen = []

    def launcher(name):
        def entry(arr_i, arr_p, stream):
            seen.append((name, list(arr_i), list(arr_p)))
            return 0
        return entry

    monkeypatch.setattr(bindings, "_launcher", launcher)
    monkeypatch.setattr(bindings, "_stream", lambda dev: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: __import__("contextlib").nullcontext())
    return seen


def _batch(seed=0, k=9, levels=2, pods=5):
    return tpre.PreemptionBatch(*(t(a) for a in dry_run_inputs(seed, n=12, k=k, r=4,
                                                                levels=levels, pods=pods)))


def test_dry_run_binding_marshals_the_launch_arrays(entries):
    batch = _batch()
    before = bindings.LAUNCHES["preempt_dry_run"]
    feasible, min_k, viol_k = bindings.batched_dry_run(*batch)
    assert bindings.LAUNCHES["preempt_dry_run"] == before + 1 and len(entries) == 1
    name, ints, ptrs = entries[0]
    l, n, k = batch.perm.shape
    p, r = batch.pods_req.shape
    assert name == "preempt_dry_run" and ints == [l, n, k, r, p]
    want = dict(free=batch.free, victim_req=batch.victim_req, perm=batch.perm,
                elig_len=batch.elig_len, valid=None, viol=batch.viol, pods_req=batch.pods_req,
                pod_level=batch.pod_level, feasible=feasible, min_k=min_k, viol_k=viol_k)
    for key, ptr in zip(bindings.DRY_RUN_PTRS, ptrs):
        assert ptr == (want[key].data_ptr() if want[key] is not None else None), key
    base = min_k.data_ptr()
    assert (viol_k.data_ptr(), feasible.data_ptr()) == (base + 4 * p * n, base + 8 * p * n)
    assert feasible.dtype == torch.bool and min_k.shape == viol_k.shape == (p, n)


def test_victims_binding_marshals_the_launch_arrays(entries):
    free, victim_req, *_rest, pods_req, _ = dry_run_inputs(1, n=10, k=6)
    valid = victim_masks(1, 10, 6)
    args = (t(free), t(victim_req), t(valid), t(pods_req[0]))
    feasible, min_k = bindings.dry_run_victims(*args)
    name, ints, ptrs = entries[0]
    assert name == "preempt_dry_run" and ints == [1, 10, 6, 4, 1]
    want = dict(free=args[0], victim_req=args[1], perm=None, elig_len=None, valid=args[2],
                viol=None, pods_req=args[3], pod_level=None, feasible=feasible, min_k=min_k,
                viol_k=None)
    for key, ptr in zip(bindings.DRY_RUN_PTRS, ptrs):
        assert ptr == (want[key].data_ptr() if want[key] is not None else None), key
    assert feasible.data_ptr() == min_k.data_ptr() + 4 * 10


@pytest.mark.parametrize("full", [False, True])
def test_filters_binding_marshals_the_launch_arrays(entries, full):
    _js, ts = mixed_snapshot(2)
    cl, pods, sel = ts.cluster, ts.pods, ts.selectors
    out = bindings.pod_filters(cl, pods, sel, full)
    name, ints, ptrs = entries[0]
    n, lw = cl.label_bits.shape
    s, st, se, sk = sel.expr_ids.shape
    p = pods.valid.shape[0]
    want_ints = dict(n=n, lw=lw, tk=cl.topo_ids.shape[1], tw=cl.taint_bits.shape[2],
                     pw=cl.port_bits.shape[1], r=cl.allocatable.shape[1] if full else 0, p=p,
                     s=s, st=st, se=se, sk=sk, full=int(full))
    assert name == "pod_filters" and ints == [want_ints[k] for k in bindings.FILTERS_INTS]
    res = dict(requested=cl.requested, allocatable=cl.allocatable, pod_req=pods.req) if full \
        else dict(requested=None, allocatable=None, pod_req=None)
    want = dict(node_valid=cl.node_valid, node_name=cl.name_id, label_bits=cl.label_bits,
                topo_ids=cl.topo_ids, taint_bits=cl.taint_bits, node_ports=cl.port_bits,
                sel_ids=sel.expr_ids, sel_op=sel.expr_op, sel_slot=sel.expr_slot,
                sel_tv=sel.term_valid, pod_valid=pods.valid, pod_name=pods.name_id,
                sel_idx=pods.sel_idx, tol_bits=pods.tol_bits, tol_all=pods.tol_all,
                pod_ports=pods.port_bits, out=out, **res)
    for key, ptr in zip(bindings.FILTERS_PTRS, ptrs):
        assert ptr == (want[key].data_ptr() if want[key] is not None else None), key
    assert out.shape == (p, n) and out.dtype == torch.bool


def test_pass_is_one_call_two_launches_one_allocation(entries):
    batch = _batch(seed=2)
    _js, ts = mixed_snapshot(1)
    before = dict(bindings.LAUNCHES)
    feasible, min_k, viol_k, static = bindings.preemption_pass(batch, ts.cluster, ts.pods,
                                                               ts.selectors)
    assert [e[0] for e in entries] == ["preempt_dry_run", "pod_filters"]
    for k in ("preempt_dry_run", "pod_filters"):
        assert bindings.LAUNCHES[k] == before[k] + 1
    assert bindings.LAUNCHES["match_terms"] == before["match_terms"]
    p, n = batch.pods_req.shape[0], batch.free.shape[0]
    ps, ns = ts.pods.valid.shape[0], ts.cluster.node_valid.shape[0]
    base = min_k.data_ptr()
    assert [viol_k.data_ptr(), feasible.data_ptr(), static.data_ptr()] == \
        [base + 4 * p * n, base + 8 * p * n, base + 9 * p * n]
    assert static.untyped_storage().nbytes() == 9 * p * n + ps * ns
    assert entries[0][2][8:] == [feasible.data_ptr(), base, viol_k.data_ptr()]
    assert entries[1][2][-1] == static.data_ptr() and entries[1][1][-1] == 0  # static mode
    assert static.shape == (ps, ns) and static.dtype == feasible.dtype == torch.bool


def test_bindings_refuse_bad_tables():
    batch = _batch()
    _js, ts = mixed_snapshot(0)
    sel = ts.selectors
    with pytest.raises(ValueError):     # a selector table with no row
        bindings.pod_filters(ts.cluster, ts.pods, sel._replace(
            expr_ids=sel.expr_ids[:0], expr_op=sel.expr_op[:0], expr_slot=sel.expr_slot[:0],
            term_valid=sel.term_valid[:0]), False)
    with pytest.raises(TypeError):
        bindings.batched_dry_run(*batch._replace(perm=batch.perm.long()))
    with pytest.raises(ValueError):
        bindings.batched_dry_run(*batch._replace(elig_len=batch.elig_len[:, :-1]))
    wide = _batch(k=bindings.MAX_VICTIM_SLOTS + 1, pods=2)
    with pytest.raises(ValueError):
        bindings.batched_dry_run(*wide)
