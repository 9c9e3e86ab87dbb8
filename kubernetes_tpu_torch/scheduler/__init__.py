"""The scheduler's host side around TorchBatchScheduler: the scheduler
cache (cache.py), the configuration (config.py), the profiles and their
extension points (framework.py), the scheduling queue (queue.py), the
Permit wait map (waitingpods.py), the metrics (metrics.py) and the
PostFilter preemption evaluator (preemption.py).  The scheduling loop
itself (the reference's scheduler.py) is not ported yet.
"""

from .cache import SchedulerCache
from .metrics import Registry
from .queue import QueuedPodInfo, SchedulingQueue, pod_key

__all__ = [
    "SchedulerCache", "SchedulingQueue", "QueuedPodInfo", "Registry",
    "pod_key",
]
