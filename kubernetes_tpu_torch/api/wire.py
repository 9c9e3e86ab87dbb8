"""Generic dataclass ⇄ JSON codec for api.types objects.

The reference persists every object through a versioned codec into etcd
(storage/etcd3/store.go:106, runtime serializers); this is our
process-boundary serialization: type-tagged JSON with recursive
dataclass walking, decoding against the api.types namespace.  Used by
the API server, its REST client and the webhook callouts (the
reference's store also journals through it; this package's store keeps
no journal).

A copy of the reference package's api/wire.py: it decodes
against this package's api.types and api.crd.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from . import types as api

_TYPE_KEY = "__t"


def to_wire(obj: Any) -> Any:
    # dynamic kinds (CRD instances): kind travels in the document since
    # there is no dataclass to recover it from
    from .crd import DynamicObject

    if isinstance(obj, DynamicObject):
        return {
            _TYPE_KEY: "DynamicObject",
            "kind": obj.KIND,
            "meta": to_wire(obj.meta),
            "spec": to_wire(obj.spec),
            "status": to_wire(obj.status),
        }
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {_TYPE_KEY: type(obj).__name__}
        for f in dataclasses.fields(obj):
            out[f.name] = to_wire(getattr(obj, f.name))
        return out
    if isinstance(obj, dict):
        return {k: to_wire(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_wire(v) for v in obj]
    return obj


def from_wire(doc: Any) -> Any:
    if isinstance(doc, dict):
        if _TYPE_KEY in doc:
            name = doc[_TYPE_KEY]
            if name == "DynamicObject":
                from .crd import DynamicObject

                return DynamicObject(
                    doc.get("kind", ""),
                    meta=from_wire(doc.get("meta")),
                    spec=from_wire(doc.get("spec") or {}),
                    status=from_wire(doc.get("status") or {}),
                )
            cls = getattr(api, name, None)
            if cls is None:
                # apiextensions dataclasses live beside, not in, types
                from . import crd as crdmod

                cls = getattr(crdmod, name, None)
            if cls is None or not dataclasses.is_dataclass(cls):
                raise ValueError(f"unknown wire type {name!r}")
            kwargs = {
                k: from_wire(v) for k, v in doc.items() if k != _TYPE_KEY
            }
            # tolerate fields added/removed across versions
            valid = {f.name for f in dataclasses.fields(cls)}
            return cls(**{k: v for k, v in kwargs.items() if k in valid})
        return {k: from_wire(v) for k, v in doc.items()}
    if isinstance(doc, list):
        return [from_wire(v) for v in doc]
    return doc
