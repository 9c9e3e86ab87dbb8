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
    way and scattered by one launch of kernel `mirror_rows` (the resident
    mirror's and the partials specs' deltas).

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
    (canonical dtype) is written into its own aligned segment of the
    stage, the stage is sent, and each tensor is a dtype view of its
    slice of the device buffer."""
    arrs = [np.ascontiguousarray(_canon(a)) for a in arrs]
    offsets, off = [], 0
    for a in arrs:
        off = _align(off, a.itemsize)
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
    ("dst", "<u8"), ("outer_stride", "<u8"), ("row_stride", "<u8"),
    ("src_off", "<u4"), ("idx_off", "<u4"), ("rows", "<i4"),
    ("row_bytes", "<i4"), ("outer", "<i4"), ("unit", "<i4"),
])
assert LEAF_DTYPE.itemsize == 48


class RowTarget(NamedTuple):
    """One leaf of a row delta: write vals into dst's rows idx on `axis`
    (0, or 1 for the effect-major leaves)."""

    dst: torch.Tensor   # contiguous, on the target device; written in place
    axis: int
    idx: np.ndarray     # i32[D] distinct row indices
    vals: np.ndarray    # dst's shape with D rows on `axis` (canonical dtype)


class RowLayout(NamedTuple):
    """Where one target's indices and rows lie in the packed buffer."""

    idx_off: int
    src_off: int
    outer: int
    rows: int
    row_bytes: int
    unit: int


def _row_geometry(dst: torch.Tensor, axis: int) -> Tuple[int, int]:
    """(outer count, row bytes) of dst's row axis: dst is contiguous, so
    rows lie row_bytes apart and outer slices rows * row_bytes apart."""
    shape = tuple(dst.shape)
    outer = int(np.prod(shape[:axis], dtype=np.int64))
    return outer, int(np.prod(shape[axis + 1:], dtype=np.int64)) * dst.element_size()


def pack_rows(targets: Sequence[RowTarget], stage: PinnedStage,
              device: torch.device) -> Tuple[torch.Tensor, List[RowLayout], int]:
    """Pack every target's descriptor, indices and rows into the stage and
    send it in one copy.  Returns (device buffer, layouts, widest leaf's
    copy units)."""
    n = len(targets)
    off = _align(n * LEAF_DTYPE.itemsize, 8)
    layouts, max_units = [], 0
    for t in targets:
        if not t.dst.is_contiguous():
            raise ValueError("set_rows: a target leaf is not contiguous")
        outer, row_bytes = _row_geometry(t.dst, t.axis)
        rows = int(t.idx.shape[0])
        idx_off = off
        off = _align(off + 4 * rows, 4)
        src_off = off
        off = _align(off + outer * rows * row_bytes, 4)
        unit = 4 if row_bytes % 4 == 0 else 1
        max_units = max(max_units, outer * rows * (row_bytes // unit))
        layouts.append(RowLayout(idx_off, src_off, outer, rows, row_bytes, unit))
    nbytes = _align(off, 8)
    host = stage.buffer(nbytes, device)
    desc = np.zeros(n, LEAF_DTYPE)
    for i, (t, lay) in enumerate(zip(targets, layouts)):
        desc[i] = (t.dst.data_ptr(), t.dst.shape[t.axis] * lay.row_bytes, lay.row_bytes,
                   lay.src_off, lay.idx_off, lay.rows, lay.row_bytes, lay.outer, lay.unit)
        host[lay.idx_off : lay.idx_off + 4 * lay.rows] = (
            np.ascontiguousarray(t.idx, dtype=np.int32).view(np.uint8))
        vals = np.ascontiguousarray(_canon(t.vals))
        if vals.dtype.itemsize != t.dst.element_size() or vals.nbytes != lay.outer * lay.rows * lay.row_bytes:
            raise ValueError("set_rows: rows do not match their leaf")
        host[lay.src_off : lay.src_off + vals.nbytes] = vals.reshape(-1).view(np.uint8)
    host[: desc.nbytes] = desc.view(np.uint8)
    return stage.send(nbytes, device), layouts, max_units


def set_rows_plain(buf: torch.Tensor, targets: Sequence[RowTarget],
                   layouts: Sequence[RowLayout]) -> None:
    """Plain version of kernel `mirror_rows`: read each target's indices
    and rows back out of the packed buffer and index_copy_ them in."""
    for t, lay in zip(targets, layouts):
        idx = buf[lay.idx_off : lay.idx_off + 4 * lay.rows].view(torch.int32).long()
        seg = buf[lay.src_off : lay.src_off + lay.outer * lay.rows * lay.row_bytes]
        shape = list(t.dst.shape)
        shape[t.axis] = lay.rows
        vals = seg.view(t.dst.dtype).reshape(shape)
        t.dst.index_copy_(t.axis, idx.to(t.dst.device), vals.to(t.dst.device))


def set_rows(targets: Sequence[RowTarget], stage: PinnedStage, device) -> int:
    """Write every target's rows in place: one packed copy, then kernel
    `mirror_rows` for tensors on the card or its plain version for tensors
    on the CPU.  Returns the bytes sent."""
    targets = [t for t in targets if t.idx.shape[0]]
    if not targets:
        return 0
    device = torch.device(device)
    buf, layouts, max_units = pack_rows(targets, stage, device)
    if device.type == "cpu":
        set_rows_plain(buf, targets, layouts)
    else:
        from ..kernels import bindings

        bindings.mirror_rows(buf, len(targets), max_units)
    return int(buf.numel())


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
