"""Device-resident cluster mirror — row deltas instead of full snapshots.

The cluster half of a Snapshot (allocatable, requested, label bits, ...)
is most of its bytes and changes by a handful of rows a batch: assumes
touch `requested` on the placed nodes, node add/update/remove touches one
row.  This mirror keeps the last-synced cluster tensors resident on the
device and applies ClusterState's generation-tracked row deltas — the
device-side completion of the reference cache's incremental
UpdateSnapshot (walk nodes by generation, copy only what moved).

A sync is one of:

  * nothing: the state's generation has not moved;
  * a full upload (the whole table in one packed copy): the first sync,
    a struct event (ClusterState.struct_generation: the resource axis
    widened), more than FULL_SYNC_FRACTION of the rows dirty, or after
    invalidate();
  * a delta: the dirty rows of every leaf packed into one buffer, sent in
    one copy and written by one launch of kernel `mirror_rows`
    (ops/device.py set_rows), which copies each touched leaf with its
    dirty rows overlaid into a fresh leaf;
  * after a pad-bucket crossing: an in-place grow (a pad of default rows)
    or shrink (a slice) of every leaf on the device, then the delta.

Deltas and grows write FRESH tensors (the delta's launch copies each
touched leaf itself; a grow pads a new one), never into the buffer the
previous sync returned: that buffer may still be
read by a solve in flight, a snapshot a caller kept, or a
speculation_point() bookmark — the reference's arrays are immutable, and
the port keeps that contract.  `resync_total`, `delta_rows_total`,
`delta_syncs`, `grow_syncs` and `grow_rows_total` count as the
reference's do (real rows; the static and usage families counted apart).

The `mirror.grow` fault point (testing/faults.py) sits in the in-place
resize: a raised fault declines the resize (a full upload follows), and
CORRUPT fills the grown `allocatable` with +inf, as the reference's does.
The reference's `mesh` branches (a node-axis sharded resident) are not
ported yet.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..analysis import epochs
from ..ops import device as device_ops
from ..ops import schema
from ..testing import faults

# Leaves of ClusterTensors grouped by which mutation family dirties them
# (ClusterState._static_gen / _usage_gen).  taint_bits is static too; its
# node axis is axis 1.
_STATIC_LEAVES = (
    "allocatable", "node_valid", "name_id", "label_bits", "topo_ids",
    "image_bits", "slice_id", "torus_coords", "slice_dims", "slice_pos",
)
_USAGE_LEAVES = ("requested", "nonzero_requested", "port_bits")

# Pad-row fill per leaf for the in-place grow: ClusterState._alloc's
# defaults (leaves absent here fill with 0).
_GROW_FILLS = {
    "name_id": -1, "topo_ids": -1, "slice_id": -1, "torus_coords": -1,
    "slice_pos": -1,
}


def _node_axis(field: str) -> int:
    return 1 if field == "taint_bits" else 0


def _grow_rows(leaf: torch.Tensor, dn: int, fill, axis: int) -> torch.Tensor:
    shape = list(leaf.shape)
    shape[axis] = dn
    pad = torch.full(shape, fill, dtype=leaf.dtype, device=leaf.device)
    return torch.cat([leaf, pad], dim=axis)


def _shrink_rows(leaf: torch.Tensor, n: int, axis: int) -> torch.Tensor:
    return leaf.narrow(axis, 0, n).contiguous()


class DeviceClusterMirror:
    """One consumer's device copy of a ClusterState's cluster tensors.
    Each TorchBatchScheduler owns one; several schedulers sharing one
    ClusterState sync independently through its generation counters."""

    # deltas touching more rows than this fraction of the cluster take a
    # full upload instead
    FULL_SYNC_FRACTION = 0.5

    def __init__(self, state: schema.ClusterState, device="cuda"):
        self.state = state
        self.device = torch.device(device)
        self._dev: Optional[schema.ClusterTensors] = None  # resident: fault=mirror.grow chaos=NODE_CHURN_SEEDS oracle=full-resync
        self._synced_gen = 0
        self._struct_gen = 0
        self._shape: Optional[Tuple] = None
        # epoch stamp of the resident buffer (analysis/epochs.py); the
        # buffer id is minted per full upload, carried by deltas and
        # grows, restored by rollback
        self._epoch: Optional[epochs.EpochStamp] = None
        self._buffer_id = 0
        # invalidation fence: a rollback() to a bookmark older than the
        # last invalidate() must not resurrect the dropped buffer
        self._inval_gen = 0
        self.resync_total = 0      # full uploads (first sync included)
        self.delta_rows_total = 0  # real dirty rows scattered
        self.delta_syncs = 0       # syncs served by the delta path
        self.grow_syncs = 0        # in-place resident grows/shrinks
        self.grow_rows_total = 0   # axis rows added without a re-upload
        # False restores a full upload on every shape change (the oracle
        # the elastic-axis tests hold the in-place grow against)
        self.incremental_grow = True
        # host->device bytes of the most recent sync (0 when it moved none)
        self.last_sync_bytes = 0
        # what the most recent sync did: "none" | "full" | "delta" | "grow",
        # and its kernel launches ({name: count})
        self.last_sync = "none"
        self.last_launches: Dict[str, int] = {}
        self._stage = device_ops.PinnedStage()

    def sync(self) -> schema.ClusterTensors:
        """Device-resident cluster tensors matching the state's current
        contents.  Caller holds the cache lock (the host arrays are read
        here)."""
        state = self.state
        host = state.tensors()
        shape = tuple(np.shape(leaf) for leaf in host)
        n = host.allocatable.shape[0]
        stale_struct = self._dev is None or self._struct_gen < state.struct_generation
        shape_moved = not stale_struct and self._shape != shape
        self.last_sync_bytes = 0
        self.last_sync = "none"
        self.last_launches = {}
        if not stale_struct and not shape_moved and self._synced_gen == state.generation:
            return self._dev
        if stale_struct:
            dev = self._full_upload(host)
        else:
            static_idx, usage_idx = state.dirty_rows(self._synced_gen, n)
            if static_idx.shape[0] + usage_idx.shape[0] > self.FULL_SYNC_FRACTION * n:
                dev = self._full_upload(host)
            elif shape_moved:
                # the padded bucket moved while row identity held: resize
                # in place and let the delta carry the changed rows
                resized = self._resize_resident(shape)
                if resized is None:
                    dev = self._full_upload(host)
                else:
                    self._dev = resized
                    dev = self._apply_deltas(host, static_idx, usage_idx)
                    self.last_sync = "grow"
            else:
                dev = self._apply_deltas(host, static_idx, usage_idx)
        self._dev = dev
        self._synced_gen = state.generation
        self._struct_gen = state.struct_generation
        self._shape = shape
        self._epoch = epochs.EpochStamp(
            "mirror", self._struct_gen, None, self._synced_gen, self._buffer_id,
        )
        return dev

    def _resize_resident(self, shape) -> Optional[schema.ClusterTensors]:
        """Grow (pad default rows) or shrink (slice) every resident leaf to
        the new bucket on the device, carrying every kept row.  None
        declines (the valve is off, or a non-node axis moved): the caller
        takes a full upload."""
        old_n = self._shape[0][0]
        new_n = shape[0][0]
        if not self.incremental_grow or new_n == old_n:
            return None
        for f, old_s, new_s in zip(schema.ClusterTensors._fields, self._shape, shape):
            ax = _node_axis(f)
            if (old_s[:ax] + old_s[ax + 1:] != new_s[:ax] + new_s[ax + 1:]
                    or old_s[ax] != old_n or new_s[ax] != new_n):
                return None
        try:
            act = faults.fire("mirror.grow", old_n=old_n, new_n=new_n)
        except faults.FaultInjected:  # an injected grow fault: contained
            logging.getLogger(__name__).warning(
                "mirror.grow fault injected; falling back to full resync")
            return None
        dn = new_n - old_n
        updates = {}
        for f in schema.ClusterTensors._fields:
            leaf = getattr(self._dev, f)
            ax = _node_axis(f)
            updates[f] = (_grow_rows(leaf, dn, _GROW_FILLS.get(f, 0), ax) if dn > 0
                          else _shrink_rows(leaf, new_n, ax))
        self.grow_syncs += 1
        if dn > 0:
            self.grow_rows_total += dn
        if act == faults.CORRUPT:
            # poison the carried rows so the solve's fit scores go
            # (inf - req) / inf = NaN: the decode health check trips and
            # the retry's invalidation heals through a full upload
            updates["allocatable"] = torch.full_like(updates["allocatable"], float("inf"))
        return schema.ClusterTensors(**updates)

    def stats(self) -> dict:
        return {
            "resync_total": self.resync_total,
            "delta_rows_total": self.delta_rows_total,
            "delta_syncs": self.delta_syncs,
            "grow_syncs": self.grow_syncs,
            "grow_rows_total": self.grow_rows_total,
        }

    def epoch(self) -> Optional[epochs.EpochStamp]:
        """The resident buffer's epoch stamp (None when invalidated or
        never synced)."""
        return self._epoch

    def speculation_point(self) -> tuple:
        """Bookmark the resident buffer for a speculative encode: the
        current device tensors and generations.  Later syncs write into
        fresh tensors, so holding the reference is the double buffer."""
        return (
            self._dev, self._synced_gen, self._struct_gen, self._shape,
            self._epoch, self._buffer_id, self._inval_gen,
        )

    def rollback(self, point: tuple) -> None:
        """Restore a speculation_point() bookmark: the next sync re-sends
        every row dirtied since the bookmarked generation (or uploads in
        full when the struct generation moved past it).  Refused — the
        mirror stays invalidated — when invalidate() ran after the
        bookmark was taken."""
        dev, synced_gen, struct_gen, shape, epoch_stamp, buffer_id, inval_gen = point
        if inval_gen != self._inval_gen:
            epochs.note_rollback_blocked("mirror")
            return
        self._dev = dev
        self._synced_gen = synced_gen
        self._struct_gen = struct_gen
        self._shape = shape
        self._epoch = epoch_stamp
        self._buffer_id = buffer_id

    def invalidate(self) -> None:
        """Drop the resident copy: the next sync uploads in full."""
        self._dev = None
        self._synced_gen = 0
        self._struct_gen = 0
        self._shape = None
        self._epoch = None
        self._buffer_id = 0
        self._inval_gen += 1

    def _full_upload(self, host: schema.ClusterTensors) -> schema.ClusterTensors:
        # the packed copy copies: on the CPU a device tensor never aliases
        # the state's live numpy arrays
        self.resync_total += 1
        self._buffer_id = epochs.fresh_buffer_id()
        leaves = device_ops.pack_leaves(list(host), self._stage, self.device)
        self.last_sync_bytes = self._stage.bytes_sent
        self.last_sync = "full"
        return schema.ClusterTensors(*leaves)

    def _apply_deltas(self, host: schema.ClusterTensors, static_idx: np.ndarray,
                      usage_idx: np.ndarray) -> schema.ClusterTensors:
        dev = self._dev
        self.delta_syncs += 1
        self.delta_rows_total += int(static_idx.shape[0] + usage_idx.shape[0])
        self.last_sync = "delta"
        targets, names = [], []
        families = ((_STATIC_LEAVES + ("taint_bits",), static_idx),
                    (_USAGE_LEAVES, usage_idx))
        for leaves, idx in families:
            if not idx.shape[0]:
                continue
            for f in leaves:
                ax = _node_axis(f)
                vals = np.take(np.asarray(getattr(host, f)), idx, axis=ax)
                targets.append(device_ops.RowTarget(getattr(dev, f), ax, idx, vals))
                names.append(f)
        fresh = device_ops.set_rows(targets, self._stage, self.device)
        self.last_sync_bytes = self._stage.bytes_sent
        if targets:
            self.last_launches = {"mirror_rows": 1}
        return dev._replace(**dict(zip(names, fresh))) if names else dev
