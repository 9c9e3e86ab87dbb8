"""ResourceQuota: admission-enforced namespace budgets + the status
controller.

Reference: the quota evaluator wired into admission
(plugin/pkg/admission/resourcequota) rejects creates that would exceed
status.hard, and pkg/controller/resourcequota recomputes status.used
from the live objects.  Tracked resources: "pods" (count),
CPU ("cpu", milli) and MEMORY (bytes) as requests totals — the
pod-centric core of the reference's evaluator registry.

A copy of the reference package's controllers/resourcequota.py,
whole.
"""

from __future__ import annotations

from typing import Any, Dict

from ..api import admission as adm
from ..api import store as st
from ..api import types as api
from .base import Controller, split_key

TRACKED = ("pods", api.CPU, api.MEMORY)


def _usage_of(pods) -> Dict[str, int]:
    used: Dict[str, int] = {"pods": 0, api.CPU: 0, api.MEMORY: 0}
    for p in pods:
        if p.status.phase in ("Succeeded", "Failed"):
            continue  # terminal pods release their quota (evaluator's
            # QuotaV1Pod scope check)
        used["pods"] += 1
        req = p.resource_requests()
        used[api.CPU] += req.get(api.CPU, 0)
        used[api.MEMORY] += req.get(api.MEMORY, 0)
    return used


def quota_validator(obj: Any, operation: str, store=None) -> None:
    """Admission enforcement: a Pod create that would push any tracked
    resource past a quota's hard limit is rejected with the reference's
    'exceeded quota' error shape."""
    if store is None or operation != "CREATE" or not isinstance(obj, api.Pod):
        return
    quotas = [
        q
        for q in store.list("ResourceQuota")[0]
        if q.meta.namespace == obj.meta.namespace
    ]
    if not quotas:
        return
    pods = [
        p
        for p in store.list("Pod")[0]
        if p.meta.namespace == obj.meta.namespace
    ]
    used = _usage_of(pods)
    req = obj.resource_requests()
    incoming = {
        "pods": 1,
        api.CPU: req.get(api.CPU, 0),
        api.MEMORY: req.get(api.MEMORY, 0),
    }
    for q in quotas:
        for resource, hard in q.spec.hard.items():
            if resource not in TRACKED:
                continue
            would = used.get(resource, 0) + incoming.get(resource, 0)
            if would > hard:
                raise adm.AdmissionError(
                    f"exceeded quota: {q.meta.name}, requested "
                    f"{resource}={incoming.get(resource, 0)}, used "
                    f"{used.get(resource, 0)}, limited {hard}"
                )


quota_validator.wants_store = True


class ResourceQuotaController(Controller):
    """Keeps status.hard/used current (pkg/controller/resourcequota's
    replenishment loop: pod events re-sync the namespace's quotas)."""

    KIND = "ResourceQuota"

    def register(self) -> None:
        self.informers.informer("ResourceQuota").add_handler(self._on_quota)
        self.informers.informer("Pod").add_handler(self._on_pod)

    def _on_quota(self, typ: str, q, old) -> None:
        self.enqueue(q)

    def _on_pod(self, typ: str, pod, old) -> None:
        for q in self.informers.informer("ResourceQuota").list():
            if q.meta.namespace == pod.meta.namespace:
                self.enqueue(q)

    def sync(self, key: str) -> None:
        namespace, name = split_key(key)
        try:
            quota = self.store.get("ResourceQuota", name, namespace)
        except st.NotFound:
            return
        pods = [
            p
            for p in self.informers.informer("Pod").list()
            if p.meta.namespace == namespace
        ]
        used = _usage_of(pods)
        relevant = {
            r: used.get(r, 0) for r in quota.spec.hard if r in TRACKED
        }
        if (
            quota.status.used != relevant
            or quota.status.hard != quota.spec.hard
        ):
            quota.status.hard = dict(quota.spec.hard)
            quota.status.used = relevant
            self.store.update(quota, force=True)
