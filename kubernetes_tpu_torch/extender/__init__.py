"""Scheduler-extender endpoint: the out-of-tree integration contract
(kube-scheduler extender v1 wire protocol) backed by the port's
single-pod evaluation on the card, and the proto snapshot service backed
by its batch solve."""

from .server import ExtenderBackend, ExtenderServer
from .types import MAX_EXTENDER_PRIORITY, ExtenderArgs

__all__ = [
    "ExtenderArgs",
    "ExtenderBackend",
    "ExtenderServer",
    "MAX_EXTENDER_PRIORITY",
]
