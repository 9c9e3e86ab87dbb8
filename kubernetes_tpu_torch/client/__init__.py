"""Client layer: shared informers + listers over the API store's watch
streams, and the scheduler's event recorder — the client-go tools/cache
and tools/record analogue (copies of kubernetes_tpu/client/informers.py
and events.py; the work queue and leader election are not ported yet)."""

from .events import EventRecorder
from .informers import InformerFactory, RelistGate, SharedInformer

__all__ = ["EventRecorder", "InformerFactory", "RelistGate", "SharedInformer"]
