"""In-memory object store: the part of the reference package's `Store`
(kubernetes_tpu/api/store.py:1016) that preemption reads and writes.

Objects are keyed by (kind, namespace/name) and carry a monotonically
increasing resourceVersion.  `create`, `get`, `update` (optimistic
concurrency: a stale resourceVersion raises Conflict) and `delete` deep-copy
across the boundary, as the reference does, so a caller's object is never
the stored one.  `list` returns (items, resourceVersion).

Not copied: watches and their fan-out, shards, the journal and its framing,
admission, finalizers' two-phase delete and the wave transaction — they
come with the scheduler loop.
"""

from __future__ import annotations

import copy
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import types as api


class NotFound(KeyError):
    pass


class AlreadyExists(ValueError):
    pass


class Conflict(ValueError):
    """Stale resourceVersion on update."""


def _key(namespace: str, name: str) -> str:
    return f"{namespace}/{name}" if namespace else name


class Store:
    def __init__(self):
        self._lock = threading.Lock()
        self._objects: Dict[str, Dict[str, Any]] = {}
        self._rv = 0

    @staticmethod
    def _kind_of(obj: Any) -> str:
        kind = getattr(obj, "KIND", None)
        if not kind:
            raise TypeError(f"object {obj!r} has no KIND")
        return kind

    @staticmethod
    def _namespace(kind: str, namespace: str) -> str:
        return "" if kind in api.CLUSTER_SCOPED_KINDS else namespace

    def create(self, obj: Any) -> Any:
        kind = self._kind_of(obj)
        obj = copy.deepcopy(obj)
        obj.meta.namespace = self._namespace(kind, obj.meta.namespace)
        key = _key(obj.meta.namespace, obj.meta.name)
        with self._lock:
            objs = self._objects.setdefault(kind, {})
            if key in objs:
                raise AlreadyExists(f"{kind} {key} exists")
            if not obj.meta.creation_timestamp:
                obj.meta.creation_timestamp = time.time()
            self._rv += 1
            obj.meta.resource_version = self._rv
            objs[key] = obj
            return copy.deepcopy(obj)

    def get(self, kind: str, name: str, namespace: str = "default") -> Any:
        key = _key(self._namespace(kind, namespace), name)
        with self._lock:
            try:
                return copy.deepcopy(self._objects[kind][key])
            except KeyError:
                raise NotFound(f"{kind} {key}") from None

    def update(self, obj: Any, *, force: bool = False) -> Any:
        """Optimistic-concurrency update: obj.meta.resource_version must
        match the stored version unless force."""
        kind = self._kind_of(obj)
        obj = copy.deepcopy(obj)
        obj.meta.namespace = self._namespace(kind, obj.meta.namespace)
        key = _key(obj.meta.namespace, obj.meta.name)
        with self._lock:
            objs = self._objects.get(kind, {})
            if key not in objs:
                raise NotFound(f"{kind} {key}")
            current = objs[key].meta.resource_version
            if not force and obj.meta.resource_version != current:
                raise Conflict(f"{kind} {key}: rv {obj.meta.resource_version} != {current}")
            self._rv += 1
            obj.meta.resource_version = self._rv
            objs[key] = obj
            return copy.deepcopy(obj)

    def delete(self, kind: str, name: str, namespace: str = "default") -> Any:
        key = _key(self._namespace(kind, namespace), name)
        with self._lock:
            objs = self._objects.get(kind, {})
            if key not in objs:
                raise NotFound(f"{kind} {key}")
            self._rv += 1
            return objs.pop(key)

    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        selector: Optional[Callable[[Any], bool]] = None,
    ) -> Tuple[List[Any], int]:
        """(items, resourceVersion): deep copies of every object of `kind`
        (in `namespace`, passing `selector`), in creation order."""
        with self._lock:
            refs = list(self._objects.get(kind, {}).values())
            rv = self._rv
        items = [
            copy.deepcopy(o) for o in refs
            if (namespace is None or o.meta.namespace == namespace)
            and (selector is None or selector(o))
        ]
        return items, rv

    @property
    def resource_version(self) -> int:
        return self._rv
