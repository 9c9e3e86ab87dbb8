"""Host <-> device movement of encoded snapshots.

`to_device` moves a numpy `Snapshot` (ops.schema) onto a torch device,
keeping every dtype.  Two representation rules hold for the whole port:

  * u32 bitsets travel as their int32 view.  torch has no shifts, adds or
    max on uint32 on every backend; the bit tests `(w >> b) & 1` stay
    exact under an arithmetic shift, and the CUDA kernels read the same
    bits back as uint32_t.
  * bool stays torch.bool (kernels receive it as its uint8 storage).

`snapshot_from_numpy` is the "state carried across" function: it takes a
snapshot encoded by the reference package (a NamedTuple or a plain nested
dict of numpy arrays, matched by field name, never imported) and returns
this package's `Snapshot`, so both packages can be fed one encoded input.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from . import schema


def _leaf_to_tensor(a: Any, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    # always a copy: ClusterState hands out views of its live arrays, and a
    # later cache mutation must not leak into a snapshot already in flight
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device, copy=True)


def _map_table(table, fn):
    return type(table)(*(fn(x) for x in table))


def to_device(snapshot: schema.Snapshot, device) -> schema.Snapshot:
    """A copy of `snapshot` with every array as a torch tensor on `device`."""
    device = torch.device(device)
    return schema.Snapshot(
        *(_map_table(t, lambda x: _leaf_to_tensor(x, device)) for t in snapshot)
    )


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

