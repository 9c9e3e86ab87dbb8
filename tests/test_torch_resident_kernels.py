"""The residents' two kernels, partials_eval and mirror_rows, on the CPU.

  * `ops.partials.update_store` (one sync of the store: kernel
    partials_eval's entry point, its plain version on the CPU) against
    the reference's grow -> insert -> refresh sequence
    (kubernetes_tpu/ops/partials.py grow_store_cols / insert_slots /
    refresh_rows) on one seed-made state carried across as numpy: misses
    only, dirty columns only, both, a grow with both, 0, 1, 31, 32 and 33
    dirty columns and the last column;
  * the fused row delta (`ops.device.set_rows`, kernel mirror_rows' plain
    version) against the reference's `_set_rows` / `_set_rows_ax1` on
    leaves of every dtype and both axes, and a numpy emulation of the
    kernel's block split over the packed buffer (the prefix table, the
    binary searches, the 16-, 4- and 1-byte units): every byte of every
    fresh leaf written exactly once, equal to the reference;
  * a numpy emulation of partials_eval's grid (copy blocks with their
    column bitmap, column tiles, node tiles): every store entry written
    exactly once, the evaluated ones exactly the union of the missed
    slots, the listed columns and the grown columns;
  * the out-of-place contract (a speculation_point()'s tensors unchanged
    after later syncs), one partials_eval launch a sync, and both
    residents' stats() equal to the reference's over a churn sequence.
"""

import bisect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from kubernetes_tpu.models import mirror as jmirror
from kubernetes_tpu.models.batch_scheduler import TPUBatchScheduler
from kubernetes_tpu.ops import partials as jpops
from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu_torch.kernels import bindings
from kubernetes_tpu_torch.models.batch_scheduler import TorchBatchScheduler
from kubernetes_tpu_torch.ops import device as dv
from kubernetes_tpu_torch.ops import partials as tpops
from kubernetes_tpu_torch.ops import schema as tschema
from kubernetes_tpu_torch.testing import wrappers as tw
from kubernetes_tpu_torch.testing.cases import Churn

CSRC = Path(__file__).resolve().parents[1] / "kubernetes_tpu_torch" / "csrc"


def _canon(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(_canon(a)).copy())


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)) if len(a) else None


# -- update_store against the reference's sequence ----------------------------


@pytest.fixture(scope="module")
def state():
    """A reference scheduler's resident cluster, specs and store after two
    churn batches over 40 nodes, as numpy, and the
    port's tensors of the same."""
    js = TPUBatchScheduler(mode="greedy")
    churn = Churn(jw, 16)
    for nd in churn.nodes(40):
        js.add_node(nd)
    for step in range(2):
        pods = churn.batch(step, 12)
        names = js.schedule_pending(pods)
        Churn.apply(churn.mutate(list(zip(pods, names))), js)
    snap, _meta = js.encode_pending(churn.batch(2, 12))
    cluster = [np.asarray(x) for x in snap.cluster]
    specs = [np.asarray(x) for x in js._partials._specs]
    store = [np.asarray(x) for x in js._partials._store]
    return {"j": (snap.cluster, js._partials._specs, store),
            "cluster": tschema.ClusterTensors(*(_t(x) for x in cluster)),
            "specs": tpops.ClassSpecs(*(_t(x) for x in specs)),
            "store": store}


# (missed slots, dirty columns: a count or "last", grown columns)
SYNCS = {
    "nothing": (0, 0, 0), "dirty1_last": (0, "last", 0), "dirty31": (0, 31, 0),
    "dirty32": (0, 32, 0), "dirty33": (0, 33, 0), "misses": (2, 0, 0),
    "both": (3, 33, 0), "grow": (0, 0, 16), "grow_both": (2, 32, 16),
    "grow_both_last": (1, "last", 9), "shrink_both": (2, 5, -8),
}


@pytest.mark.parametrize("name", list(SYNCS))
def test_update_store_equals_the_reference_sequence(state, name):
    """One update (the union of the grown columns, the dirty columns and
    the missed slots, against the current cluster and the final specs)
    equals the reference's grow -> refresh grown -> insert -> refresh
    dirty (or the shrink, then insert and refresh), on a store whose old
    width is the cluster's less the grown columns (or more); the old store
    is only read."""
    jc, jspecs, store = state["j"]
    misses, dirty, grow = SYNCS[name]
    g, n = store[0].shape
    assert n >= 40
    rng = np.random.default_rng(sum(map(ord, name)))
    old_n = n - grow
    miss = np.sort(rng.choice(g, misses, replace=False)).astype(np.int32)
    cols = (np.array([n - 1], np.int32) if dirty == "last"
            else np.sort(rng.choice(n, dirty, replace=False)).astype(np.int32))
    old = [a[:, :old_n].copy() if grow >= 0 else np.concatenate([a, a[:, :-grow]], axis=1)
           for a in store]
    want = jpops.PartialsStore(*old)
    if grow > 0:
        want = jpops.grow_store_cols_jit(want, grow)
        want = jpops.refresh_rows_jit(want, jspecs, jc, np.arange(old_n, n, dtype=np.int32))
    elif grow < 0:
        want = jpops.shrink_store_cols_jit(want, n)
    if misses:
        want = jpops.insert_slots_jit(want, jspecs, jc, miss)
    if cols.shape[0]:
        want = jpops.refresh_rows_jit(want, jspecs, jc, cols)
    old_t = tpops.PartialsStore(*(_t(a) for a in old))
    before = [t.clone() for t in old_t]
    grown = np.arange(min(old_n, n), n)
    got = tpops.update_store(old_t, state["specs"], state["cluster"], _i32(miss),
                             _i32(np.union1d(cols, grown).astype(np.int32)))
    for f, a, b in zip(tpops.PartialsStore._fields, got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    assert all(torch.equal(a, b) for a, b in zip(old_t, before))


def test_update_store_without_old_is_eval_store(state):
    jc, jspecs, _store = state["j"]
    got = tpops.update_store(None, state["specs"], state["cluster"], None, None)
    for f, a, b in zip(tpops.PartialsStore._fields, got, jpops.eval_store_jit(jc, jspecs)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)


def test_update_store_rejects_unsorted_lists(state):
    store = tpops.PartialsStore(*(_t(a) for a in state["store"]))
    with pytest.raises(ValueError):
        tpops.update_store(store, state["specs"], state["cluster"], None,
                           torch.tensor([5, 3], dtype=torch.int32))


# -- partials_eval's grid, emulated ----------------------------------------------

TILE, COPY_COLS = bindings.STATICS_TILE, bindings.PARTIALS_COPY_COLS


def partials_grid_writes(g, n, old_n, slots, cols, chunk_slots):
    """partials_eval_launch's grid and each block's write predicate
    (csrc/partials_eval.cu), over index lists, with tile blocks of
    `chunk_slots` slots (8 or 32): (writes a store entry gets, entries a
    tile evaluated)."""
    CHUNK = chunk_slots
    m, d = len(slots), len(cols)
    missed = set(int(s) for s in slots)
    width = min(old_n, n)
    tiles = -(-n // TILE)
    per_slot = -(-width // COPY_COLS)
    tile0 = 0 if m > 0 else (old_n // TILE if n > old_n else tiles)
    col_chunks = -(-g // CHUNK)
    node_chunks = -(-(g if n > old_n else m) // CHUNK)
    writes = np.zeros((g, n), np.int32)
    evaluated = np.zeros((g, n), bool)
    for b in range(g * per_slot):                       # copy blocks
        slot = b // per_slot
        c0 = (b - slot * per_slot) * COPY_COLS
        c1 = min(c0 + COPY_COLS, width)
        k = bisect.bisect_left(slots, slot)
        if k < m and slots[k] == slot:
            continue
        bits = np.zeros(COPY_COLS, bool)
        j0 = bisect.bisect_left(cols, c0)
        j1 = bisect.bisect_left(cols, c1, j0)
        bits[np.asarray(cols[j0:j1], dtype=np.int64) - c0] = True
        for c in range(c0, c1):
            if not bits[c - c0]:
                writes[slot, c] += 1
    for t in range(-(-d // TILE)):                      # column tiles
        for chunk in range(col_chunks):
            for slot in range(chunk * CHUNK, min((chunk + 1) * CHUNK, g)):
                if slot in missed:
                    continue
                for col in cols[t * TILE:(t + 1) * TILE]:
                    if col < old_n:
                        writes[slot, col] += 1
                        evaluated[slot, col] = True
    for t in range(tiles - tile0):                      # node tiles
        node0 = (tile0 + t) * TILE
        nt = min(TILE, n - node0)
        each = list(range(g)) if node0 + nt > old_n else slots
        for chunk in range(node_chunks):
            for slot in each[chunk * CHUNK:(chunk + 1) * CHUNK]:
                for col in range(node0, node0 + nt):
                    if slot in missed or col >= old_n:
                        writes[slot, col] += 1
                        evaluated[slot, col] = True
    return writes, evaluated


@pytest.mark.parametrize("g,n,old_n,m,d,chunk", [
    (32, 64, 0, 0, 0, 8), (32, 4160, 4160, 0, 500, 32), (32, 4160, 4160, 3, 0, 8),
    (64, 4096, 2000, 2, 33, 32), (40, 100, 130, 1, 31, 8), (32, 96, 96, 0, 0, 32),
])
def test_partials_grid_writes_each_entry_once(g, n, old_n, m, d, chunk):
    rng = np.random.default_rng(g + n + old_n + m + d)
    slots = sorted(rng.choice(g, m, replace=False).tolist())
    cols = sorted(rng.choice(n, d, replace=False).tolist())
    writes, evaluated = partials_grid_writes(g, n, old_n, slots, cols, chunk)
    assert (writes == 1).all()
    want = np.zeros((g, n), bool)
    want[slots, :] = True
    want[:, cols] = True
    want[:, old_n:] = True
    np.testing.assert_array_equal(evaluated, want)


# -- mirror_rows: the fused delta and its block split, emulated -------------------

LEAVES = [((4,), np.float32, 0, 0), ((), np.bool_, 0, 0), ((3,), np.int32, 0, 4),
          ((16,), np.uint32, 0, 0), ((3, None, 8), np.uint32, 1, 0), ((3, None), np.bool_, 1, 1),
          ((2,), np.float32, 0, 8), ((), np.bool_, 0, 3)]


def _random_leaf(rng, shape, dtype):
    if dtype == np.bool_:
        return rng.random(shape) < 0.5
    if dtype == np.float32:
        return rng.standard_normal(shape).astype(np.float32)
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(dtype)


def _delta(seed, n):
    """Random leaves of every dtype on both axes, some at addresses that
    allow only 4- or 1-byte units (views of a larger buffer), one delta
    of every row and one of the last row; the reference's results."""
    rng = np.random.default_rng(seed)
    targets, want = [], []
    for k, (tail, dtype, ax, shift) in enumerate(LEAVES):
        shape = tuple(n if x is None else x for x in tail) if ax else (n, *tail)
        base = _random_leaf(rng, shape, dtype)
        d = n if k == 6 else 1 if k == 7 else int(rng.integers(1, n))
        idx = (np.array([n - 1], np.int32) if k == 7 else
               np.sort(rng.choice(n, d, replace=False)).astype(np.int32))
        vshape = list(shape)
        vshape[ax] = idx.shape[0]
        vals = _random_leaf(rng, tuple(vshape), dtype)
        setter = jmirror._set_rows if ax == 0 else jmirror._set_rows_ax1
        want.append(_canon(np.asarray(setter(base, idx, vals))))
        host = _t(base)
        raw = torch.zeros(host.numel() * host.element_size() + shift, dtype=torch.uint8)
        src = raw[shift:].view(host.dtype).view(host.shape)
        src.copy_(host)
        targets.append(dv.RowTarget(src, ax, idx, vals))
    return targets, want


@pytest.mark.parametrize("seed,n", [(0, 37), (1, 64), (2, 300)])
def test_fused_delta_matches_reference(seed, n):
    targets, want = _delta(seed, n)
    before = [t.src.clone() for t in targets]
    stage = dv.PinnedStage()
    fresh = dv.set_rows(targets, stage, torch.device("cpu"))
    assert stage.bytes_sent > 0
    for t, f, w, b in zip(targets, fresh, want, before):
        np.testing.assert_array_equal(f.numpy(), w)
        assert torch.equal(t.src, b)


def _first_ending_after(idx, lo, hi, rb, p):
    while lo < hi:
        mid = (lo + hi) >> 1
        if (int(idx[mid]) + 1) * rb > p:
            hi = mid
        else:
            lo = mid + 1
    return lo


def emulate_mirror_rows(pack):
    """mirror_rows_kernel (csrc/mirror_rows.cu) over the packed buffer, a
    block at a time: (the output allocation's bytes, writes a byte got)."""
    buf = pack.buf.numpy()
    n = len(pack.layouts)
    desc = buf[: n * dv.LEAF_DTYPE.itemsize].view(dv.LEAF_DTYPE)
    prefix = buf[desc.nbytes: desc.nbytes + 4 * (n + 1)].view(np.int32)
    srcs = {s.data_ptr(): s.contiguous().view(-1).view(torch.uint8).numpy()
            for s in pack.srcs}
    out = np.zeros(max(pack.out_bytes, 1), np.uint8)
    writes = np.zeros_like(out, dtype=np.int32)
    for blk in range(int(prefix[n])):
        leaf = bisect.bisect_right(prefix[:n].tolist(), blk) - 1
        lf = desc[leaf]
        unit, rb, rows = int(lf["unit"]), int(lf["row_bytes"]), int(lf["rows"])
        assert int(lf["src"]) % unit == 0 and int(lf["slice_bytes"]) % unit == 0
        assert int(lf["chunk_bytes"]) % unit == 0 and int(lf["out_off"]) % dv.OUT_ALIGN == 0
        assert int(lf["vals_off"]) % 16 == 0 and int(lf["idx_off"]) % 16 == 0
        b = blk - int(prefix[leaf])
        o, c = divmod(b, int(lf["chunks"]))
        slice_bytes = int(lf["slice_bytes"])
        b0 = c * int(lf["chunk_bytes"])
        b1 = min(b0 + int(lf["chunk_bytes"]), slice_bytes)
        src = srcs[int(lf["src"])][o * slice_bytes:]
        vals = buf[int(lf["vals_off"]) + o * rows * rb:]
        idx = buf[int(lf["idx_off"]): int(lf["idx_off"]) + 4 * rows].view(np.int32)
        dst0 = int(lf["out_off"]) + o * slice_bytes
        j0 = _first_ending_after(idx, 0, rows, rb, b0)
        j1 = j0
        while j1 < rows and int(idx[j1]) * rb < b1:
            j1 += 1
        for p in range(b0, b1, unit):
            j = j1 if j0 == j1 else _first_ending_after(idx, j0, j1, rb, p)
            start = int(idx[j]) * rb if j < j1 else 1 << 62
            if start >= p + unit:
                piece = src[p: p + unit]
            elif rb % unit == 0 and start <= p:
                piece = vals[j * rb + p - start: j * rb + p - start + unit]
            else:
                piece = np.empty(unit, np.uint8)
                for q in range(unit):
                    at = p + q
                    while j < j1 and (int(idx[j]) + 1) * rb <= at:
                        j += 1
                    inside = j < j1 and int(idx[j]) * rb <= at
                    piece[q] = vals[j * rb + at - int(idx[j]) * rb] if inside else src[at]
            out[dst0 + p: dst0 + p + unit] = piece
            writes[dst0 + p: dst0 + p + unit] += 1
    return out, writes


@pytest.mark.parametrize("seed,n", [(3, 37), (4, 2100)])
def test_mirror_block_split_writes_each_byte_once(seed, n):
    targets, want = _delta(seed, n)
    pack = dv.pack_rows(targets, dv.PinnedStage(), torch.device("cpu"))
    assert {lay.unit for lay in pack.layouts} == {16, 4, 1}
    out, writes = emulate_mirror_rows(pack)
    for t, lay, w in zip(targets, pack.layouts, want):
        nb = t.src.numel() * t.src.element_size()
        assert (writes[lay.out_off: lay.out_off + nb] == 1).all()
        np.testing.assert_array_equal(out[lay.out_off: lay.out_off + nb],
                                      np.ascontiguousarray(w).view(np.uint8).reshape(-1))
    assert writes.sum() == sum(t.src.numel() * t.src.element_size() for t in targets)


def test_set_rows_rejects_unsorted_rows():
    src = torch.zeros((8, 4), dtype=torch.float32)
    target = dv.RowTarget(src, 0, np.array([3, 1], np.int32), np.zeros((2, 4), np.float32))
    with pytest.raises(ValueError):
        dv.set_rows([target], dv.PinnedStage(), torch.device("cpu"))


# -- the launch layouts ---------------------------------------------------------


def _enum(src: str, prefix: str, first: str):
    body = re.search(r"enum \{\s*(" + prefix + first + r"\b.*?)\};", src, re.S)
    assert body, prefix
    return [e.strip() for e in body.group(1).replace("\n", " ").split(",") if e.strip()]


def test_launch_layouts_follow_the_sources():
    src = (CSRC / "partials_eval.cu").read_text()
    for prefix, first, names in (("kI_", "N", bindings.PARTIALS_INTS),
                                 ("kP_", "NODE_VALID", bindings.PARTIALS_PTRS)):
        entries = _enum(src, prefix, first)
        assert entries[-1] == f"{prefix}COUNT"
        assert [e[len(prefix):].lower() for e in entries[:-1]] == list(names)
    assert re.search(rf"constexpr int kCopyCols = {bindings.PARTIALS_COPY_COLS};", src)
    assert re.search(rf"constexpr int kSlotChunk = {bindings.PARTIALS_SLOT_CHUNK};", src)
    assert re.search(r"constexpr int kFewSlots = 8;", src)
    assert re.search(rf"constexpr int kMaxSlots = {bindings.PARTIALS_MAX_SLOTS};", src)
    mirror = (CSRC / "mirror_rows.cu").read_text()
    fields = re.findall(r"^\s+(?:uint64_t|uint32_t|int32_t) (\w+)(?:\[2\])?;", mirror, re.M)
    assert fields == list(dv.LEAF_DTYPE.names)
    assert re.search(rf"constexpr int kChunk = {dv.ROW_CHUNK};", mirror)
    assert dv.ROW_CHUNK == bindings.MIRROR_CHUNK
    assert re.search(rf"constexpr int kBlock = {bindings.MIRROR_BLOCK};", mirror)


# -- the residents -----------------------------------------------------------------


def _nodes(w, n, prefix="n"):
    return [w.make_node(f"{prefix}-{i}").capacity(cpu_milli=4000, mem=8 * w.GI, pods=20)
            .zone(f"z-{i % 3}").obj() for i in range(n)]


def _pods(w, tag, k, zone=None):
    out = []
    for i in range(k):
        p = w.make_pod(f"{tag}-{i}").req(cpu_milli=200, mem=w.GI)
        if zone is not None:
            p = p.required_affinity(w.api.LABEL_ZONE, w.api.OP_IN, [zone])
        out.append(p.obj())
    return out


def _bytes(t):
    return t.contiguous().view(-1).view(torch.uint8).clone()


def test_speculation_point_tensors_never_change():
    """Both residents' bookmarked tensors are byte for byte unchanged after
    later syncs: a delta with dirty rows, new classes (misses and a spec
    insert) and a grow of the node axis."""
    s = TorchBatchScheduler(device="cpu", mode="greedy")
    for nd in _nodes(tw, 12):
        s.add_node(nd)
    first = _pods(tw, "a", 4) + _pods(tw, "a2", 1, zone="z-0")
    for pod, name in zip(first, s.schedule_pending(first)):
        s.assume(pod, name)
    s.encode_pending(_pods(tw, "b", 2))
    marks = (s._mirror.speculation_point(), s._partials.speculation_point())
    held = [*marks[0][0], *marks[1][0], *marks[1][1]]
    saved = [_bytes(t) for t in held]
    for pod, name in zip(_pods(tw, "x", 2), ["n-5", "n-6"]):
        s.assume(pod, name)
    for nd in _nodes(tw, 6, "m"):
        s.add_node(nd)
    extra = _pods(tw, "c", 3, zone="z-1") + _pods(tw, "d", 2, zone="z-2")
    names = s.schedule_pending(extra)
    assert s._mirror.stats()["grow_syncs"] >= 1 and s._partials.stats()["grows"] >= 1
    for pod, name in zip(extra, names):
        if name is not None:
            s.assume(pod, name)
    s.encode_pending(_pods(tw, "e", 2, zone="z-0"))
    assert s._mirror.stats()["delta_syncs"] >= 2
    for t, b in zip(held, saved):
        assert torch.equal(_bytes(t), b)


def test_a_warm_sync_is_one_partials_launch():
    """A sync with dirty rows and missed classes records one partials_eval
    launch, and two mirror_rows launches (the cluster's delta, the spec
    rows)."""
    s = TorchBatchScheduler(device="cpu", mode="greedy")
    for nd in _nodes(tw, 10):
        s.add_node(nd)
    first = _pods(tw, "a", 3) + _pods(tw, "a2", 1, zone="z-0")
    for pod, name in zip(first, s.schedule_pending(first)):
        s.assume(pod, name)
    _snap, meta = s.encode_pending(_pods(tw, "b", 2, zone="z-1") + _pods(tw, "c", 1, zone="z-2"))
    assert s._partials.stats()["full_recomputes"] == 1
    assert meta.statics is not None and s._mirror.last_sync == "delta"
    assert meta.resident_launches == {"mirror_rows": 2, "partials_eval": 1}


def test_stats_match_reference_over_churn():
    """Both residents' counters equal the reference's after every batch of
    a churn sequence (deltas, misses, node updates and removals)."""
    js, ts = TPUBatchScheduler(mode="greedy"), TorchBatchScheduler(device="cpu", mode="greedy")
    jc, tc = Churn(jw, 21), Churn(tw, 21)
    for nd in jc.nodes(20):
        js.add_node(nd)
    for nd in tc.nodes(20):
        ts.add_node(nd)
    for step in range(4):
        jp, tp = jc.batch(step, 10), tc.batch(step, 10)
        jn, tn = js.schedule_pending(jp), ts.schedule_pending(tp)
        assert jn == tn
        assert ts._mirror.stats() == js._mirror.stats()
        assert ts._partials.stats() == js._partials.stats()
        Churn.apply(jc.mutate(list(zip(jp, jn))), js)
        Churn.apply(tc.mutate(list(zip(tp, tn))), ts)
    assert ts._partials.stats()["delta_syncs"] >= 2
