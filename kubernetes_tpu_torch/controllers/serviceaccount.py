"""ServiceAccount + TTL-after-finished controllers.

Reference: pkg/controller/serviceaccount (ensures every namespace has a
"default" ServiceAccount; pods are defaulted to it at admission —
plugin/pkg/admission/serviceaccount) and pkg/controller/ttlafterfinished
(deletes finished Jobs after spec.ttlSecondsAfterFinished; their pods
follow via the GC's ownerReference cascade).

A copy of the reference package's controllers/serviceaccount.py,
whole.
"""

from __future__ import annotations

import threading
import time
from typing import Any

from ..api import admission as adm
from ..api import store as st
from ..api import types as api
from .base import Controller, split_key


def default_service_account(obj: Any, operation: str) -> None:
    """Admission defaulter: every pod runs as a ServiceAccount."""
    if isinstance(obj, api.Pod) and not obj.spec.service_account:
        obj.spec.service_account = "default"


class ServiceAccountController(Controller):
    KIND = "ServiceAccount"

    def register(self) -> None:
        self.informers.informer("Namespace").add_handler(self._on_namespace)
        self.informers.informer("ServiceAccount").add_handler(self._on_sa)

    def _on_namespace(self, typ: str, ns, old) -> None:
        if typ != st.DELETED:
            self.queue.add(f"{ns.meta.name}/default")

    def _on_sa(self, typ: str, sa, old) -> None:
        if typ == st.DELETED:
            # recreate the default account if it goes missing
            self.enqueue(sa)

    def sync(self, key: str) -> None:
        namespace, name = split_key(key)
        if name != "default":
            return
        try:
            ns = self.store.get("Namespace", namespace, "")
        except st.NotFound:
            return
        if ns.status.phase == "Terminating":
            return
        try:
            self.store.get("ServiceAccount", "default", namespace)
        except st.NotFound:
            try:
                self.store.create(
                    api.ServiceAccount(
                        meta=api.ObjectMeta(
                            name="default", namespace=namespace
                        )
                    )
                )
            except st.AlreadyExists:
                pass


class TTLAfterFinishedController(Controller):
    """Deletes Jobs spec.ttl_seconds_after_finished seconds after they
    complete (ttlafterfinished/ttlafterfinished_controller.go); a timer
    re-queues jobs whose TTL hasn't expired yet."""

    KIND = "Job"
    NAME = "TTLAfterFinished"  # manager key (JobController owns "Job")

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.clock = time.time
        self._timers: list = []

    def register(self) -> None:
        self.informers.informer("Job").add_handler(self._on_job)

    def _on_job(self, typ: str, job, old) -> None:
        if typ != st.DELETED:
            self.enqueue(job)

    def sync(self, key: str) -> None:
        namespace, name = split_key(key)
        try:
            job = self.store.get("Job", name, namespace)
        except st.NotFound:
            return
        ttl = job.spec.ttl_seconds_after_finished
        if ttl is None:
            return
        # the job controller stamps completion_time for success AND
        # backoff-limit failure — that's the finished signal
        if job.status.completion_time is None:
            return
        remaining = job.status.completion_time + ttl - self.clock()
        if remaining <= 0:
            try:
                self.store.delete("Job", name, namespace)
            except st.NotFound:
                pass
            return
        t = threading.Timer(remaining, lambda: self.queue.add(key))
        t.daemon = True
        t.start()
        self._timers.append(t)

    def stop(self) -> None:
        for t in self._timers:
            t.cancel()
        super().stop()
