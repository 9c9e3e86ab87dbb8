"""The scheduling queue's pod identities (kubernetes_tpu/scheduler/
queue.py:65-75).  The queue itself comes with the scheduler loop."""

from __future__ import annotations

from typing import Optional

from ..api import types as api


def pod_key(pod: api.Pod) -> str:
    return f"{pod.meta.namespace}/{pod.meta.name}"


def gang_key(pod: api.Pod) -> Optional[str]:
    """The queue's gang identity: "namespace/group", or None for
    ungrouped pods.  Same-named groups in different namespaces are
    distinct gangs."""
    group = pod.spec.scheduling_group
    return f"{pod.meta.namespace}/{group}" if group else None
