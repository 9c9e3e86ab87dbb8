"""Host <-> device movement of encoded snapshots.

`to_device` moves a numpy `Snapshot` (ops.schema) onto a torch device,
keeping every dtype.  Two representation rules hold for the whole port:

  * u32 bitsets travel as their int32 view.  torch has no shifts, adds or
    max on uint32 on every backend; the bit tests `(w >> b) & 1` stay
    exact under an arithmetic shift, and the CUDA kernels read the same
    bits back as uint32_t.
  * bool stays torch.bool (kernels receive it as its uint8 storage).

The transfer path of a mirrored batch (models.batch_scheduler) is:

  * `device_fill_shortcut`: large constant pod/constraint leaves become
    cached device fills (no bytes moved);
  * `packed_device_put`: every other host leaf is packed into ONE pinned
    staging buffer with aligned segments, sent in one non-blocking copy,
    and handed out as dtype views of slices of the device buffer (no
    unpack kernel);
  * `set_rows`: a row delta of several resident leaves packed the same
    way and written by one launch of kernel `mirror_rows` into fresh
    leaves, each the old leaf with the delta's rows overlaid (the resident
    mirror's and the partials specs' deltas; the old leaves are only
    read).

A `PinnedStage` is reused batch after batch: before its host buffer is
rewritten it waits on the CUDA event recorded after its previous copy.

`snapshot_from_numpy` is the "state carried across" function: it takes a
snapshot encoded by the reference package (a NamedTuple or a plain nested
dict of numpy arrays, matched by field name, never imported) and returns
this package's `Snapshot`, so both packages can be fed one encoded input.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import schema


def _canon(a: Any) -> np.ndarray:
    """The numpy array as the port holds it on a device (u32 -> i32 view)."""
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _leaf_to_tensor(a: Any, device: torch.device) -> torch.Tensor:
    # always a copy: ClusterState hands out views of its live arrays, and a
    # later cache mutation must not leak into a snapshot already in flight
    t = torch.from_numpy(np.ascontiguousarray(_canon(a)))
    return t.to(device, copy=True)


def _map_table(table, fn):
    return type(table)(*(fn(x) for x in table))


def to_device(snapshot: schema.Snapshot, device) -> schema.Snapshot:
    """A copy of `snapshot` with every array as a torch tensor on `device`."""
    device = torch.device(device)
    return schema.Snapshot(
        *(_map_table(t, lambda x: _leaf_to_tensor(x, device)) for t in snapshot)
    )


# -- pinned staging ----------------------------------------------------------


class PinnedStage:
    """One reusable host staging buffer for one kind of host->device copy.

    On the card the buffer is pinned and the copy non-blocking; the event
    recorded after the copy is waited on before the buffer is rewritten,
    so a batch still in flight never reads a half-rewritten stage.  On the
    CPU the "device" buffer is a fresh copy of the stage."""

    def __init__(self) -> None:
        self._host: Optional[torch.Tensor] = None
        self._event = None
        self.bytes_sent = 0  # bytes of the most recent send

    def buffer(self, nbytes: int, device: torch.device) -> np.ndarray:
        """The first `nbytes` of the stage as a writable uint8 numpy array
        (grown when too small), safe to rewrite."""
        if self._event is not None:
            self._event.synchronize()
            self._event = None
        if self._host is None or self._host.numel() < nbytes:
            size = max(nbytes, 1 << 12, 2 * self._host.numel() if self._host is not None else 0)
            self._host = torch.empty(size, dtype=torch.uint8,
                                     pin_memory=device.type == "cuda")
        return self._host[:nbytes].numpy()

    def send(self, nbytes: int, device: torch.device) -> torch.Tensor:
        """The first `nbytes` of the stage as a new uint8 tensor on
        `device`: one host->device copy."""
        out = torch.empty(nbytes, dtype=torch.uint8, device=device)
        out.copy_(self._host[:nbytes], non_blocking=device.type == "cuda")
        if device.type == "cuda":
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(device))
        self.bytes_sent = nbytes
        return out


def _align(off: int, itemsize: int) -> int:
    a = max(4, itemsize)
    return (off + a - 1) // a * a


def _view(buf: torch.Tensor, off: int, a: np.ndarray) -> torch.Tensor:
    """The segment of `buf` at `off` as a tensor of a's dtype and shape."""
    seg = buf[off : off + a.nbytes]
    t = seg.view(torch.from_numpy(np.empty(0, a.dtype)).dtype)
    return t.reshape(a.shape)


def pack_leaves(arrs: Sequence[np.ndarray], stage: PinnedStage,
                device: torch.device) -> List[torch.Tensor]:
    """Host arrays -> device tensors through ONE staging copy: each array
    (canonical dtype) is written into its own 16-byte aligned segment of the
    stage, the stage is sent, and each tensor is a dtype view of its
    slice of the device buffer."""
    arrs = [np.ascontiguousarray(_canon(a)) for a in arrs]
    offsets, off = [], 0
    for a in arrs:
        # 16-byte segments: kernel mirror_rows copies a leaf in 16-byte
        # units where its address allows
        off = _align(off, 16)
        offsets.append(off)
        off += a.nbytes
    nbytes = _align(off, 8)
    host = stage.buffer(nbytes, device)
    for a, o in zip(arrs, offsets):
        host[o : o + a.nbytes] = a.reshape(-1).view(np.uint8)
    buf = stage.send(nbytes, device)
    return [_view(buf, o, a) for a, o in zip(arrs, offsets)]


def packed_device_put(snapshot: schema.Snapshot, stage: PinnedStage,
                      device) -> schema.Snapshot:
    """`snapshot` with every host (numpy) leaf moved to `device` in one
    packed copy; leaves already torch tensors (the resident cluster, cached
    fills) pass through untouched (the reference's `_packed_device_put`)."""
    device = torch.device(device)
    tables = [list(t) for t in snapshot]
    where = [(i, j) for i, t in enumerate(tables) for j, x in enumerate(t)
             if not isinstance(x, torch.Tensor)]
    outs = pack_leaves([tables[i][j] for i, j in where], stage, device)
    for (i, j), t in zip(where, outs):
        tables[i][j] = t
    return schema.Snapshot(*(type(t)(*v) for t, v in zip(snapshot, tables)))


# -- cached constant fills ---------------------------------------------------

FILL_CACHE_MAX = 64   # entries; evicted wholesale as shape buckets churn
FILL_MIN_SIZE = 65536  # below this a leaf rides the packed copy


def device_fill_shortcut(
    snapshot: schema.Snapshot,
    cache: Dict[tuple, torch.Tensor],
    device,
    no_bound_pods: bool = False,
    features=None,
) -> schema.Snapshot:
    """Replace large constant-filled pod/constraint leaves with cached
    device fills before the packed copy (the reference's
    `_device_fill_shortcut`).  The bound-pod count tables are zero by
    construction when no bound pod matches (features' bound_* flags, or
    no bound pods at all) and are filled without a scan; any other leaf of
    FILL_MIN_SIZE elements or more is filled when its min equals its max.
    Fills are shared by every later batch of the same shape: no consumer
    writes into a pod or constraint leaf in place.  The cluster half is
    left alone (it is resident already)."""
    device = torch.device(device)

    def fill(a: np.ndarray, value) -> torch.Tensor:
        key = (a.shape, a.dtype.str, value)
        hit = cache.get(key)
        if hit is None:
            if len(cache) >= FILL_CACHE_MAX:
                cache.clear()
            dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
            hit = cache[key] = torch.full(a.shape, value, dtype=dtype, device=device)
        return hit

    def shortcut(x):
        if isinstance(x, torch.Tensor):
            return x
        a = _canon(x)
        if a.size < FILL_MIN_SIZE:
            return x
        lo = a.min()
        return fill(a, lo.item()) if lo == a.max() else x

    def mark(x, is_zero: bool):
        a = _canon(x)
        if a.size < FILL_MIN_SIZE or not is_zero:
            return x  # rides the packed copy, no re-scan
        return fill(a, a.dtype.type(0).item())

    spread_z = terms_z = pref_z = no_bound_pods
    if features is not None and not no_bound_pods:
        spread_z = not features.bound_spread
        terms_z = not features.bound_terms
        pref_z = not features.bound_pref
    fixed = {}
    if no_bound_pods or features is not None:
        fixed = {
            ("spread", "node_matches"): mark(snapshot.spread.node_matches, spread_z),
            ("terms", "node_matches"): mark(snapshot.terms.node_matches, terms_z),
            ("terms", "node_owners"): mark(snapshot.terms.node_owners, terms_z),
            ("prefpod", "node_counts"): mark(snapshot.prefpod.node_counts, pref_z),
            ("prefpod", "owner_weight"): mark(snapshot.prefpod.owner_weight, pref_z),
        }
    tables = [snapshot.cluster]
    for tname, table in zip(schema.Snapshot._fields[1:], snapshot[1:]):
        tables.append(type(table)(*(
            fixed[(tname, f)] if (tname, f) in fixed else shortcut(x)
            for f, x in zip(type(table)._fields, table)
        )))
    return schema.Snapshot(*tables)


# -- packed row deltas (kernel mirror_rows) ----------------------------------

# one descriptor a leaf at the head of the packed buffer; the layout of
# csrc/mirror_rows.cu's `Leaf`
LEAF_DTYPE = np.dtype([
    ("src", "<u8"), ("out_off", "<u8"), ("slice_bytes", "<u8"),
    ("idx_off", "<u4"), ("vals_off", "<u4"), ("rows", "<i4"), ("row_bytes", "<i4"),
    ("outer", "<i4"), ("unit", "<i4"), ("chunk_bytes", "<i4"), ("chunks", "<i4"),
    ("pad", "<i4", (2,)),
])
assert LEAF_DTYPE.itemsize == 64
ROW_CHUNK = 16384   # mirror_rows.cu's kChunk: bytes a block copies, at most
OUT_ALIGN = 256     # each fresh leaf's offset in the launch's output allocation


class RowTarget(NamedTuple):
    """One leaf of a row delta: a fresh copy of `src` with vals written at
    its rows idx on `axis` (0, or 1 for the effect-major leaves)."""

    src: torch.Tensor   # the resident leaf, contiguous; only read
    axis: int
    idx: np.ndarray     # i32[D] ascending, distinct row indices
    vals: np.ndarray    # src's shape with D rows on `axis` (canonical dtype)


class RowLayout(NamedTuple):
    """Where one target's indices, rows and fresh leaf lie."""

    idx_off: int
    vals_off: int
    outer: int
    rows: int
    row_bytes: int
    out_off: int    # byte offset of the fresh leaf in the output allocation
    unit: int       # copy unit: 16, 4 or 1 bytes
    blocks: int     # the launch's blocks for this leaf


class RowPack(NamedTuple):
    """A packed row delta on its device: the buffer (descriptors, the
    prefix table of blocks, indices, rows), each target's layout, the old
    leaves, the launch's blocks and the bytes of its one output
    allocation."""

    buf: torch.Tensor
    layouts: List[RowLayout]
    srcs: List[torch.Tensor]
    blocks: int
    out_bytes: int


def _row_geometry(src: torch.Tensor, axis: int) -> Tuple[int, int]:
    """(outer count, row bytes) of src's row axis: src is contiguous, so
    rows lie row_bytes apart and outer slices rows * row_bytes apart."""
    shape = tuple(src.shape)
    outer = int(np.prod(shape[:axis], dtype=np.int64))
    return outer, int(np.prod(shape[axis + 1:], dtype=np.int64)) * src.element_size()


def _copy_unit(addr: int, slice_bytes: int) -> int:
    """The widest copy unit (16, 4 or 1 bytes) that the old leaf's address
    and its slice bytes allow (the fresh leaf lies at an OUT_ALIGN offset)."""
    for unit in (16, 4):
        if addr % unit == 0 and slice_bytes % unit == 0:
            return unit
    return 1


def pack_rows(targets: Sequence[RowTarget], stage: PinnedStage, device) -> RowPack:
    """Pack every target's descriptor, the prefix table of blocks, its
    indices and rows into the stage and send it in one copy.  Raises
    ValueError unless each target's indices are ascending and distinct
    (the kernel finds a block's rows by binary search) and its rows match
    its leaf."""
    device = torch.device(device)
    n = len(targets)
    off = _align(n * LEAF_DTYPE.itemsize + 4 * (n + 1), 16)
    layouts, desc, out_off, blocks = [], np.zeros(n, LEAF_DTYPE), 0, 0
    for i, t in enumerate(targets):
        if not t.src.is_contiguous():
            raise ValueError("set_rows: a target leaf is not contiguous")
        idx = np.asarray(t.idx)
        if idx.ndim != 1 or (idx.shape[0] > 1 and not (np.diff(idx) > 0).all()):
            raise ValueError("set_rows: row indices must be ascending and distinct")
        outer, row_bytes = _row_geometry(t.src, t.axis)
        rows = int(idx.shape[0])
        slice_bytes = int(t.src.shape[t.axis]) * row_bytes
        unit = _copy_unit(t.src.data_ptr(), slice_bytes)
        chunk = min(ROW_CHUNK, -(-slice_bytes // unit) * unit)
        chunks = -(-slice_bytes // chunk) if slice_bytes else 0
        idx_off = off
        off = _align(off + 4 * rows, 16)
        vals_off = off
        off = _align(off + outer * rows * row_bytes, 16)
        layouts.append(RowLayout(idx_off, vals_off, outer, rows, row_bytes, out_off, unit,
                                 outer * chunks))
        desc[i] = (t.src.data_ptr(), out_off, slice_bytes, idx_off, vals_off, rows, row_bytes,
                   outer, unit, chunk, chunks, (0, 0))
        out_off += -(-outer * slice_bytes // OUT_ALIGN) * OUT_ALIGN
        blocks += outer * chunks
    nbytes = _align(off, 16)
    host = stage.buffer(nbytes, device)
    prefix = np.zeros(n + 1, np.int32)
    for i, (t, lay) in enumerate(zip(targets, layouts)):
        prefix[i + 1] = prefix[i] + lay.blocks
        host[lay.idx_off : lay.idx_off + 4 * lay.rows] = (
            np.ascontiguousarray(t.idx, dtype=np.int32).view(np.uint8))
        vals = np.ascontiguousarray(_canon(t.vals))
        if (vals.dtype.itemsize != t.src.element_size()
                or vals.nbytes != lay.outer * lay.rows * lay.row_bytes):
            raise ValueError("set_rows: rows do not match their leaf")
        host[lay.vals_off : lay.vals_off + vals.nbytes] = vals.reshape(-1).view(np.uint8)
    host[: desc.nbytes] = desc.view(np.uint8)
    host[desc.nbytes : desc.nbytes + prefix.nbytes] = prefix.view(np.uint8)
    return RowPack(stage.send(nbytes, device), layouts, [t.src for t in targets], blocks,
                   out_off)


def set_rows_plain(pack: RowPack, targets: Sequence[RowTarget]) -> List[torch.Tensor]:
    """Plain version of kernel `mirror_rows`: read each target's indices
    and rows back out of the packed buffer; each fresh leaf is a clone of
    the old one with the rows index_copy_'d in."""
    buf, outs = pack.buf, []
    for t, lay in zip(targets, pack.layouts):
        idx = buf[lay.idx_off : lay.idx_off + 4 * lay.rows].view(torch.int32).long()
        seg = buf[lay.vals_off : lay.vals_off + lay.outer * lay.rows * lay.row_bytes]
        shape = list(t.src.shape)
        shape[t.axis] = lay.rows
        vals = seg.view(t.src.dtype).reshape(shape)
        out = t.src.clone()
        out.index_copy_(t.axis, idx.to(out.device), vals.to(out.device))
        outs.append(out)
    return outs


def set_rows(targets: Sequence[RowTarget], stage: PinnedStage, device) -> List[torch.Tensor]:
    """Each target's fresh leaf (its `src` with its rows written; `src`
    itself for a target with no rows): one packed copy, then kernel
    `mirror_rows` for tensors on the card (the fresh leaves views of its
    one output allocation) or its plain version for tensors on the CPU.
    The bytes sent are the stage's `bytes_sent`."""
    live = [t for t in targets if t.idx.shape[0]]
    stage.bytes_sent = 0
    if not live:
        return [t.src for t in targets]
    device = torch.device(device)
    pack = pack_rows(live, stage, device)
    if device.type == "cpu":
        fresh = iter(set_rows_plain(pack, live))
    else:
        from ..kernels import bindings

        fresh = iter(bindings.mirror_rows(pack))
    return [next(fresh) if t.idx.shape[0] else t.src for t in targets]


def add_rows_in_order(dst: torch.Tensor, rows: Sequence[int],
                      vals: np.ndarray) -> torch.Tensor:
    """dst (out of place) with vals[k] added to row rows[k], each row's
    additions in increasing k: the reference's scatter-add order, which
    decides the rounding once a row's sum leaves float32's exact range.
    On the card index_add adds a row's duplicates by atomics in no fixed
    order, so the additions go in ranks: launch j adds every row's j-th
    entry, and no launch names a row twice."""
    seen: Dict[int, int] = {}
    ranks = []
    for r in rows:
        ranks.append(seen.get(r, 0))
        seen[r] = ranks[-1] + 1
    ranks_np = np.asarray(ranks)
    rows_np = np.asarray(rows, dtype=np.int64)
    out = dst
    for j in range(max(seen.values(), default=0)):
        pick = ranks_np == j
        idx = torch.from_numpy(rows_np[pick]).to(dst.device)
        out = out.index_add(0, idx, torch.from_numpy(
            np.ascontiguousarray(vals[pick])).to(dst.device))
    return out


# -- the reference's snapshots ------------------------------------------------


def _field(obj: Any, name: str) -> Any:
    if isinstance(obj, Mapping):
        return obj[name]
    return getattr(obj, name)


def snapshot_from_numpy(fields: Any) -> schema.Snapshot:
    """Rebuild this package's numpy `Snapshot` from another encoder's
    snapshot, matched field by field (NamedTuple attributes or dict keys).
    Arrays are copied with their dtypes unchanged."""
    tables = []
    for table_name, cls in zip(schema.Snapshot._fields, _TABLE_TYPES):
        src = _field(fields, table_name)
        tables.append(
            cls(*(np.array(np.asarray(_field(src, f))) for f in cls._fields))
        )
    return schema.Snapshot(*tables)


_TABLE_TYPES = (
    schema.ClusterTensors,
    schema.PodBatch,
    schema.SelectorTable,
    schema.PreferredTable,
    schema.SpreadTable,
    schema.TermTable,
    schema.PrefPodTable,
    schema.ImageTable,
)


def table_to_device(table, device):
    """A copy of a NamedTuple of numpy arrays as torch tensors on `device`."""
    device = torch.device(device)
    return _map_table(table, lambda x: _leaf_to_tensor(x, device))


def readback(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """numpy copies of `tensors`, read back from the card in one wait:
    non-blocking copies into pinned buffers, then one event (tensors on
    the CPU are returned as they are)."""
    tensors = list(tensors)
    if tensors[0].device.type == "cpu":
        return [t.numpy() for t in tensors]
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(tensors[0].device))
    event.synchronize()
    return [h.numpy() for h in host]
