"""The scheduler's host side around TorchBatchScheduler: the scheduling
loop (scheduler.py: `Scheduler`, fed by informers over the API store,
committing bind waves through it; `OverloadController`), the scheduler
cache (cache.py), the configuration (config.py), the profiles and their
extension points (framework.py), the scheduling queue (queue.py), the
Permit wait map (waitingpods.py), the metrics (metrics.py), the PostFilter
preemption evaluator (preemption.py), the volume and device-claim
binders (volumebinding.py, deviceclaims.py), the cache debugger
(debugger.py: `CacheComparer`) and the health and metrics server
(http.py: `HealthServer`, `render_prometheus`).
"""

from .cache import SchedulerCache
from .metrics import Registry
from .queue import QueuedPodInfo, SchedulingQueue, pod_key
from .scheduler import OverloadController, Scheduler

__all__ = [
    "Scheduler", "OverloadController", "SchedulerCache", "SchedulingQueue",
    "QueuedPodInfo", "Registry", "pod_key",
]
