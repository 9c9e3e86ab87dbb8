"""CRD-lite: CustomResourceDefinitions registering dynamic kinds at
runtime.

Reference: staging/src/k8s.io/apiextensions-apiserver (62.7k LoC).  The
load-bearing core for an in-process control plane is much smaller than
the reference's aggregation machinery, because our store, informers,
REST server, and watch streams are already kind-agnostic (they key on
the string `obj.KIND`):

  * CustomResourceDefinition — the API object declaring a new kind
    with an openAPI-ish structural schema
    (apiextensions/v1 CustomResourceDefinitionSpec reduced).
  * DynamicObject — the runtime representation of an instance of a
    dynamic kind (unstructured.Unstructured): meta + free-form
    spec/status dicts, serialized by the wire codec so instances
    stream over REST and through informers like built-ins.
  * validate_custom_resource — admission validation of instances
    against their CRD's schema (the structural-schema validation
    pruned to: type, required, minimum/maximum, enum).

The PodGroup used by coscheduling (scheduler/coscheduling.py) is the
proving instance: install_podgroup_crd() + PodGroupDirectory drive gang
sizes from API objects instead of an out-of-band dict.

A copy of the reference package's api/crd.py, whole.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from . import types as api
from .admission import AdmissionError


@dataclass
class CRDNames:
    kind: str = ""
    plural: str = ""
    singular: str = ""


@dataclass
class CustomResourceDefinitionSpec:
    group: str = ""
    names: CRDNames = field(default_factory=CRDNames)
    scope: str = "Namespaced"  # Namespaced | Cluster
    # openAPI-ish structural schema for .spec:
    #   {"properties": {"minMember": {"type": "integer", "minimum": 1}},
    #    "required": ["minMember"]}
    schema: Dict[str, Any] = field(default_factory=dict)


@dataclass
class CustomResourceDefinition:
    meta: api.ObjectMeta = field(default_factory=api.ObjectMeta)
    spec: CustomResourceDefinitionSpec = field(
        default_factory=CustomResourceDefinitionSpec
    )

    KIND = "CustomResourceDefinition"


class DynamicObject:
    """An instance of a CRD-declared kind (unstructured.Unstructured).
    KIND is per-instance, so the kind-agnostic store/informers/REST
    machinery treats dynamic kinds exactly like built-ins."""

    def __init__(
        self,
        kind: str,
        meta: Optional[api.ObjectMeta] = None,
        spec: Optional[Dict[str, Any]] = None,
        status: Optional[Dict[str, Any]] = None,
    ):
        self.KIND = kind
        self.meta = meta or api.ObjectMeta()
        self.spec = dict(spec or {})
        self.status = dict(status or {})

    def __repr__(self) -> str:
        return (
            f"DynamicObject({self.KIND!r}, "
            f"{self.meta.namespace}/{self.meta.name})"
        )

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, DynamicObject)
            and self.KIND == other.KIND
            and self.meta == other.meta
            and self.spec == other.spec
            and self.status == other.status
        )


# -- schema validation --------------------------------------------------------

_TYPES = {
    "string": str,
    "integer": int,
    "number": (int, float),
    "boolean": bool,
    "array": list,
    "object": dict,
}


def _validate_value(path: str, value: Any, schema: Dict[str, Any]) -> None:
    typ = schema.get("type")
    if typ:
        py = _TYPES.get(typ)
        if py is None:
            raise AdmissionError(f"{path}: unknown schema type {typ!r}")
        if typ == "integer" and isinstance(value, bool):
            raise AdmissionError(f"{path}: expected integer, got bool")
        if not isinstance(value, py):
            raise AdmissionError(
                f"{path}: expected {typ}, got {type(value).__name__}"
            )
    if "enum" in schema and value not in schema["enum"]:
        raise AdmissionError(
            f"{path}: {value!r} not one of {schema['enum']}"
        )
    if "minimum" in schema and isinstance(value, (int, float)):
        if value < schema["minimum"]:
            raise AdmissionError(
                f"{path}: {value} < minimum {schema['minimum']}"
            )
    if "maximum" in schema and isinstance(value, (int, float)):
        if value > schema["maximum"]:
            raise AdmissionError(
                f"{path}: {value} > maximum {schema['maximum']}"
            )
    if typ == "object" and "properties" in schema and isinstance(value, dict):
        _validate_object(path, value, schema)
    if typ == "array" and "items" in schema and isinstance(value, list):
        for i, item in enumerate(value):
            _validate_value(f"{path}[{i}]", item, schema["items"])


def _validate_object(path: str, doc: Dict[str, Any], schema: Dict[str, Any]) -> None:
    for req in schema.get("required", ()):
        if req not in doc:
            raise AdmissionError(f"{path}.{req}: required field missing")
    for name, sub in (schema.get("properties") or {}).items():
        if name in doc:
            _validate_value(f"{path}.{name}", doc[name], sub)


def crd_for_kind(store, kind: str) -> Optional[CustomResourceDefinition]:
    for crd in store.list("CustomResourceDefinition")[0]:
        if crd.spec.names.kind == kind:
            return crd
    return None


def validate_custom_resource(obj: Any, operation: str, store=None) -> None:
    """Admission: a DynamicObject must name a registered CRD and its
    spec must satisfy the CRD's structural schema."""
    if not isinstance(obj, DynamicObject) or store is None:
        return
    if operation == "DELETE":
        return
    crd = crd_for_kind(store, obj.KIND)
    if crd is None:
        raise AdmissionError(
            f"no CustomResourceDefinition registered for kind {obj.KIND!r}"
        )
    if crd.spec.schema:
        _validate_object("spec", obj.spec, crd.spec.schema)


validate_custom_resource.wants_store = True


def validate_crd(obj: Any, operation: str) -> None:
    if not isinstance(obj, CustomResourceDefinition):
        return
    if not obj.spec.names.kind:
        raise AdmissionError("crd: spec.names.kind is required")
    for typ in _walk_types(obj.spec.schema):
        if typ not in _TYPES:
            raise AdmissionError(f"crd: unknown schema type {typ!r}")


def _walk_types(schema: Dict[str, Any]):
    for sub in (schema.get("properties") or {}).values():
        if "type" in sub:
            yield sub["type"]
        yield from _walk_types(sub)
    if "items" in schema:
        if "type" in schema["items"]:
            yield schema["items"]["type"]
        yield from _walk_types(schema["items"])


# -- PodGroup: the proving instance ------------------------------------------


PODGROUP_CRD = CustomResourceDefinition(
    meta=api.ObjectMeta(name="podgroups.scheduling.x-k8s.io", namespace=""),
    spec=CustomResourceDefinitionSpec(
        group="scheduling.x-k8s.io",
        names=CRDNames(kind="PodGroup", plural="podgroups", singular="podgroup"),
        schema={
            "properties": {
                "minMember": {"type": "integer", "minimum": 1},
                "scheduleTimeoutSeconds": {"type": "number", "minimum": 0},
            },
            "required": ["minMember"],
        },
    ),
)


def install_podgroup_crd(store) -> None:
    try:
        store.create(PODGROUP_CRD)
    except Exception:  # AlreadyExists
        pass


def pod_group(name: str, min_member: int, namespace: str = "default",
              timeout_s: Optional[float] = None) -> DynamicObject:
    spec: Dict[str, Any] = {"minMember": min_member}
    if timeout_s is not None:
        spec["scheduleTimeoutSeconds"] = timeout_s
    return DynamicObject(
        "PodGroup",
        meta=api.ObjectMeta(name=name, namespace=namespace),
        spec=spec,
    )


class PodGroupDirectory:
    """Resolves gang sizes from PodGroup API objects for the
    coscheduling Permit plugin (the PodGroup minMember read the
    out-of-tree plugin does through its informer)."""

    def __init__(self, store):
        self.store = store

    def size_for(self, namespace: str, group: str) -> Optional[int]:
        try:
            pg = self.store.get("PodGroup", group, namespace)
        except KeyError:
            return None
        return pg.spec.get("minMember")

    def timeout_for(self, namespace: str, group: str) -> Optional[float]:
        try:
            pg = self.store.get("PodGroup", group, namespace)
        except KeyError:
            return None
        return pg.spec.get("scheduleTimeoutSeconds")
