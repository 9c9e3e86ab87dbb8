"""Admission: the mutating → validating plugin chain on API writes.

Reference: apiserver/pkg/admission ({chain,interfaces}.go) — every
create/update runs mutators (defaulting) then validators (reject) before
the storage commit.  Ours is a chain of plain callables installed on the
Store; the built-in set covers the defaulting/validation the scheduler
stack depends on (the slice of pkg/registry/core/pod/strategy.go and
pkg/apis/core/validation that would otherwise let malformed objects
poison batch encodes).

A copy of the reference package's api/admission.py, whole.
"""

from __future__ import annotations

from typing import Any, Callable, List

from . import types as api


class AdmissionError(ValueError):
    """A validating plugin rejected the write (HTTP 400/422 family)."""


Mutator = Callable[[Any, str], None]    # (obj, operation) — edit in place
Validator = Callable[[Any, str], None]  # raise AdmissionError to reject


class AdmissionChain:
    def __init__(self):
        self.mutators: List[Mutator] = []
        self.validators: List[Validator] = []
        # set by the Store that owns this chain: plugins marked
        # `wants_store` receive it (the reference's admission plugins
        # get informers/clients via plugin initializers —
        # apiserver/pkg/admission/initializer)
        self.store = None

    def register_mutator(self, fn: Mutator) -> None:
        self.mutators.append(fn)

    def register_validator(self, fn: Validator) -> None:
        self.validators.append(fn)

    def admit(self, obj: Any, operation: str) -> Any:
        """Run the chain (mutate, then validate).  Raises AdmissionError
        on rejection; returns the (mutated) object."""
        for m in self.mutators:
            if getattr(m, "wants_store", False):
                m(obj, operation, self.store)
            else:
                m(obj, operation)
        for v in self.validators:
            if getattr(v, "wants_store", False):
                v(obj, operation, self.store)
            else:
                v(obj, operation)
        return obj


# -- built-in plugins -------------------------------------------------------


def default_pod(obj: Any, operation: str) -> None:
    """Pod defaulting (strategy.PrepareForCreate slice): ensure at least
    one container and a restart policy."""
    if not isinstance(obj, api.Pod):
        return
    if not obj.spec.containers:
        obj.spec.containers = [api.Container()]
    if not obj.spec.restart_policy:
        obj.spec.restart_policy = "Always"


def validate_meta(obj: Any, operation: str) -> None:
    meta = getattr(obj, "meta", None)
    if meta is None or not meta.name:
        raise AdmissionError("metadata.name is required")
    if any(c.isspace() or c == "/" for c in meta.name):
        raise AdmissionError(f"invalid name {meta.name!r}")


def validate_pod(obj: Any, operation: str) -> None:
    """The validation slice that protects the scheduler: non-negative
    requests, sane priority/gang fields, known spread/affinity enums
    (pkg/apis/core/validation ValidatePodSpec reduced)."""
    if not isinstance(obj, api.Pod):
        return
    for c in obj.spec.containers + obj.spec.init_containers:
        for k, v in c.requests.items():
            if v < 0:
                raise AdmissionError(f"negative request {k}={v}")
    if obj.spec.preemption_policy not in ("PreemptLowerPriority", "Never"):
        raise AdmissionError(
            f"invalid preemptionPolicy {obj.spec.preemption_policy!r}"
        )
    gsize = obj.spec.scheduling_group_size
    if gsize is not None and gsize < 1:
        raise AdmissionError(f"schedulingGroupSize must be >= 1, got {gsize}")
    if gsize and not obj.spec.scheduling_group:
        raise AdmissionError("schedulingGroupSize set without schedulingGroup")
    for con in obj.spec.topology_spread_constraints:
        if con.max_skew < 1:
            raise AdmissionError(f"maxSkew must be >= 1, got {con.max_skew}")
        if con.when_unsatisfiable not in ("DoNotSchedule", "ScheduleAnyway"):
            raise AdmissionError(
                f"invalid whenUnsatisfiable {con.when_unsatisfiable!r}"
            )


def default_service(obj: Any, operation: str, store=None) -> None:
    """ClusterIP allocation (the apiserver Service REST strategy's
    allocator, pkg/registry/core/service/ipallocator): a deterministic
    hash into 10.96.0.0/12, linear-probed against the Services already
    stored so two names hashing together never share a VIP (the bitmap
    allocator's uniqueness guarantee).  "None" (headless) and explicit
    IPs pass through."""
    if not isinstance(obj, api.Service):
        return
    if obj.spec.type == "ExternalName" or obj.spec.cluster_ip:
        return
    if operation == "CREATE":
        import zlib

        used = set()
        if store is not None:
            services, _ = store.list("Service")
            used = {s.spec.cluster_ip for s in services if s.spec.cluster_ip}
        space = (1 << 20) - 2  # /12 host space, avoiding .0.0.0
        h = zlib.crc32(
            f"{obj.meta.namespace}/{obj.meta.name}".encode()
        ) % space + 1
        for _ in range(space):
            ip = f"10.{96 + (h >> 16)}.{(h >> 8) & 0xFF}.{h & 0xFF}"
            if ip not in used:
                obj.spec.cluster_ip = ip
                return
            h = h % space + 1
        raise AdmissionError("cluster IP space exhausted")


default_service.wants_store = True


def default_secret(obj: Any, operation: str) -> None:
    """stringData is WRITE-ONLY (core/v1 Secret docs): fold it into
    data base64-encoded at admission and clear it, so readers always
    find secret.data[...] and plaintext never persists in the journal
    under a side field."""
    if not isinstance(obj, api.Secret) or not obj.string_data:
        return
    import base64

    for k, v in obj.string_data.items():
        obj.data[k] = base64.b64encode(v.encode()).decode()
    obj.string_data = {}


def validate_service(obj: Any, operation: str) -> None:
    if not isinstance(obj, api.Service):
        return
    if obj.spec.type == "ExternalName":
        if not obj.spec.external_name:
            raise AdmissionError("externalName required for ExternalName type")
        return
    if not obj.spec.ports:
        raise AdmissionError("service must declare at least one port")
    seen = set()
    for p in obj.spec.ports:
        if not (0 < p.port < 65536):
            raise AdmissionError(f"invalid service port {p.port}")
        if (p.name, p.protocol, p.port) in seen:
            raise AdmissionError(f"duplicate service port {p.port}")
        seen.add((p.name, p.protocol, p.port))
    if len(obj.spec.ports) > 1 and any(not p.name for p in obj.spec.ports):
        raise AdmissionError("multi-port services require port names")


def validate_node(obj: Any, operation: str) -> None:
    if not isinstance(obj, api.Node):
        return
    for k, v in obj.status.allocatable.items():
        if v < 0:
            raise AdmissionError(f"negative allocatable {k}={v}")
    for t in obj.spec.taints:
        if t.effect not in api.TAINT_EFFECTS:
            raise AdmissionError(f"invalid taint effect {t.effect!r}")


def default_chain() -> AdmissionChain:
    chain = AdmissionChain()
    chain.register_mutator(default_pod)
    chain.register_mutator(default_service)
    chain.register_mutator(default_secret)
    # serviceaccount admission (plugin/pkg/admission/serviceaccount)
    from ..controllers.serviceaccount import default_service_account

    chain.register_mutator(default_service_account)
    chain.register_validator(validate_meta)
    chain.register_validator(validate_pod)
    chain.register_validator(validate_node)
    chain.register_validator(validate_service)
    # quota enforcement (plugin/pkg/admission/resourcequota)
    from ..controllers.resourcequota import quota_validator

    chain.register_validator(quota_validator)
    # CRD schema validation (apiextensions structural schemas)
    from .crd import validate_crd, validate_custom_resource

    chain.register_validator(validate_crd)
    chain.register_validator(validate_custom_resource)
    # dynamic admission: webhook callouts + expression policies
    # (admissionregistration.k8s.io; mutating hooks run LAST among
    # mutators, validating hooks/policies last among validators — the
    # reference's chain position, server/config.go:983)
    from .webhooks import (
        mutating_webhooks,
        validate_policy_object,
        validating_policies,
        validating_webhooks,
    )

    chain.register_mutator(mutating_webhooks)
    chain.register_validator(validate_policy_object)
    chain.register_validator(validating_webhooks)
    chain.register_validator(validating_policies)
    return chain
