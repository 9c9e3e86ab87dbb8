"""Append-only vocabularies and bitset packing for tensorizing label sets.

The TPU solve cannot operate on strings, so every string-shaped piece of
cluster state (label key=value pairs, taint identities, host ports, node
names, topology values) is interned into a dense integer vocabulary on the
host and shipped to the device as packed uint32 bitsets.  Interning is
EXACT — unlike hashing there are no collisions, so filter semantics match
the reference bit-for-bit.

Set-membership machine model on device:
    node_bits : uint32[N, W]       (W = ceil(capacity/32) words)
    id i is present on node n  <=>  (node_bits[n, i>>5] >> (i & 31)) & 1

Vocabularies are append-only so node-side bitsets stay valid across
incremental snapshot updates (the device-side analogue of the reference's
generation-based incremental UpdateSnapshot,
pkg/scheduler/internal/cache/cache.go:185-260).
"""

from __future__ import annotations

from typing import Dict, Hashable, Iterable, List, Sequence, Tuple

import numpy as np


class Vocab:
    """Interns hashable items to dense ids [0, len)."""

    def __init__(self) -> None:
        self._ids: Dict[Hashable, int] = {}
        self._items: List[Hashable] = []

    def __len__(self) -> int:
        return len(self._items)

    def __contains__(self, item: Hashable) -> bool:
        return item in self._ids

    def intern(self, item: Hashable) -> int:
        i = self._ids.get(item)
        if i is None:
            i = len(self._items)
            self._ids[item] = i
            self._items.append(item)
        return i

    def get(self, item: Hashable, default: int = -1) -> int:
        return self._ids.get(item, default)

    def intern_many(self, items: Sequence[Hashable]) -> np.ndarray:
        """Bulk intern: one pass, one returned id vector (int32).  Ids
        are assigned in item order, identical to looping intern() —
        this is the columnar encode's batch interning primitive, hoisting
        the per-call overhead out of hot per-object loops."""
        get = self._ids.get
        out = np.empty(len(items), dtype=np.int32)
        for j, item in enumerate(items):
            i = get(item)
            if i is None:
                i = self.intern(item)
            out[j] = i
        return out

    def get_many(self, items: Sequence[Hashable], default: int = -1) -> np.ndarray:
        """Bulk lookup without growth: int32 id vector, `default` where
        absent."""
        get = self._ids.get
        return np.fromiter(
            (get(item, default) for item in items),
            dtype=np.int32,
            count=len(items),
        )

    def alias(self, item: Hashable, ident: int) -> None:
        """Map an additional name onto an existing id (image tags/digests
        aliasing one image).  Does not grow the id space."""
        self._ids[item] = ident

    def item(self, i: int) -> Hashable:
        return self._items[i]

    def items(self) -> Sequence[Hashable]:
        return self._items


class PairVocab(Vocab):
    """Vocabulary of (key, value) pairs with a key -> ids reverse index,
    used to expand `Exists key` expressions into the exact id set present
    in the cluster."""

    def __init__(self) -> None:
        super().__init__()
        self._by_key: Dict[str, List[int]] = {}

    def intern(self, item: Tuple[str, str]) -> int:
        known = item in self._ids
        i = super().intern(item)
        if not known:
            self._by_key.setdefault(item[0], []).append(i)
        return i

    def ids_for_key(self, key: str) -> List[int]:
        return list(self._by_key.get(key, ()))


def words_for(capacity: int) -> int:
    return max(1, (capacity + 31) // 32)


def pack_bits(ids: Iterable[int], num_words: int) -> np.ndarray:
    """Pack a set of ids into a uint32[num_words] bitset."""
    out = np.zeros(num_words, dtype=np.uint32)
    for i in ids:
        if i < 0:
            continue
        w = i >> 5
        if w >= num_words:
            raise OverflowError(
                f"id {i} exceeds bitset capacity {num_words * 32}; "
                "raise the corresponding SnapshotLimits field"
            )
        out[w] |= np.uint32(1 << (i & 31))
    return out


def set_bit(bits: np.ndarray, i: int) -> None:
    w = i >> 5
    if w >= bits.shape[-1] or i < 0:
        raise OverflowError(
            f"id {i} exceeds bitset capacity {bits.shape[-1] * 32}; "
            "raise the corresponding SnapshotLimits capacity"
        )
    bits[w] |= np.uint32(1 << (i & 31))


def pad_ids(ids: Sequence[int], k: int, fill: int = -1) -> np.ndarray:
    """Fixed-width id list (int32[k]), -1 padded."""
    if len(ids) > k:
        raise OverflowError(f"{len(ids)} ids exceed slot width {k}")
    out = np.full(k, fill, dtype=np.int32)
    out[: len(ids)] = np.asarray(list(ids), dtype=np.int32)
    return out


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def pad_dim(n: int, minimum: int = 8) -> int:
    """Round a dimension up to a compile-friendly bucket (powers of two,
    floored at `minimum`) so repeated snapshots reuse the XLA executable."""
    size = max(n, minimum)
    bucket = 1 << (size - 1).bit_length()
    return bucket


def is_pad_bucket(n: int, minimum: int = 1) -> bool:
    """True when n is a value pad_dim can produce (a power of two no
    smaller than the floor) — the recompile-discipline pass's landing
    check for encode-determined axes (analysis/shapes.py)."""
    minimum = pad_dim(minimum, 1) if minimum > 1 else 1
    return n >= minimum and (n & (n - 1)) == 0


def is_constraint_bucket(n: int) -> bool:
    """True when n is a value pad_constraint_dim can produce: 1 (no
    rows) or a power of two floored at 32."""
    return n == 1 or (n >= 32 and is_pad_bucket(n))


def pad_constraint_dim(n: int) -> int:
    """Constraint-table row dims (selector/spread/term/preferred rows).
    Zero rows stay at dim 1 — the feature flags gate the whole family
    off and the [1, N] zero table costs one cached fill.  NONZERO rows
    floor at 32: straggler batches (retries, late arrivals) carry
    arbitrary subsets of the main batch's constraint classes, and
    per-power-of-two row dims would compile a fresh executable for
    nearly every straggler composition — the dominant in-window compile
    source for constraint workloads."""
    if n == 0:
        return 1
    return pad_dim(n, 32)
