"""scheduler_perf port: JSON workloads driving the host scheduler on the
CUDA card through the store, with throughput/metrics collectors emitting
DataItems (reference: test/integration/scheduler_perf; a copy of
kubernetes_tpu/perf, its YAML config shipped as JSON).

  from kubernetes_tpu_torch.perf import load_config, run_workloads, select
  wls = select(load_config(DEFAULT_CONFIG), label="performance")
  result = run_workloads(wls)                 # cuda; raises without a card
  result = run_workloads(wls, device="cpu")   # the plain versions
"""

import os

from .collectors import DataItem, MetricsCollector, ThroughputCollector
from .runner import WorkloadRunner, run_workloads
from .workload import Workload, load_config, select

DEFAULT_CONFIG = os.path.join(
    os.path.dirname(__file__), "config", "performance-config.json"
)

__all__ = [
    "DataItem",
    "DEFAULT_CONFIG",
    "MetricsCollector",
    "ThroughputCollector",
    "Workload",
    "WorkloadRunner",
    "load_config",
    "run_workloads",
    "select",
]
