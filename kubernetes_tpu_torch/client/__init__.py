"""Client layer: shared informers + listers over the API store's watch
streams, the scheduler's event recorder, Lease-based leader election, the
rate-limited work queue and the API server's REST client — the
client-go tools/cache, tools/record, tools/leaderelection,
util/workqueue and rest analogue (copies of the reference package's
client/informers.py, events.py, leaderelection.py, workqueue.py and
rest.py)."""

from .events import EventRecorder
from .informers import InformerFactory, RelistGate, SharedInformer
from .leaderelection import LeaderElector
from .rest import RestClient
from .workqueue import WorkQueue

__all__ = ["EventRecorder", "InformerFactory", "LeaderElector", "RelistGate",
           "RestClient", "SharedInformer", "WorkQueue"]
