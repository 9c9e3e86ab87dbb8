"""Client layer: shared informers + listers over the API store's watch
streams, the scheduler's event recorder and Lease-based leader election
— the client-go tools/cache, tools/record and tools/leaderelection
analogue (copies of kubernetes_tpu/client/informers.py, events.py and
leaderelection.py; the work queue is not ported yet)."""

from .events import EventRecorder
from .informers import InformerFactory, RelistGate, SharedInformer
from .leaderelection import LeaderElector

__all__ = ["EventRecorder", "InformerFactory", "LeaderElector", "RelistGate",
           "SharedInformer"]
