"""scheduler_perf runner: executes workloads against the HOST scheduler
through the store — the full informer/cache/queue/solve/bind path, not
the solver directly.  A copy of kubernetes_tpu/perf/runner.py whose
`Scheduler` solves on the CUDA card: `WorkloadRunner(device=None)` builds
each workload's `Scheduler(store, device=None)`, which raises without a
card; `device="cpu"` runs the plain versions of the kernels.

Reference: mustSetupCluster + runWorkload
(test/integration/scheduler_perf/{util.go:82,scheduler_perf.go:700ish}):
a real apiserver+etcd in-process, nodes and pods created as API objects,
collectors sampling while measured pods schedule.  Ours: the in-memory
Store is the apiserver, Scheduler runs its informer-fed loop in a
thread, and opcodes mutate the store exactly like a client would.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional

from ..api import store as st
from ..api import types as api
from ..scheduler import Scheduler
from ..api import kubeyaml
from .collectors import (
    DataItem,
    MetricsCollector,
    ThroughputCollector,
    histogram_baseline,
)
from .workload import Op, Workload

_DEFAULT_NODE = {
    "metadata": {"labels": {"topology.kubernetes.io/zone": "zone-$index_mod8"}},
    "status": {
        "allocatable": {"cpu": "32", "memory": "64Gi", "pods": "110"}
    },
}
_DEFAULT_POD = {
    "spec": {
        "containers": [
            {"resources": {"requests": {"cpu": "500m", "memory": "500Mi"}}}
        ]
    }
}


def _substitute_index(obj: Any, index: int) -> Any:
    """Replace $index / $index_modN tokens in template string values."""
    if isinstance(obj, dict):
        return {k: _substitute_index(v, index) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_substitute_index(v, index) for v in obj]
    if isinstance(obj, str) and "$index" in obj:
        out = obj
        while "$index_mod" in out:
            pos = out.find("$index_mod")
            tail = out[pos + len("$index_mod"):]
            digits = ""
            for ch in tail:
                if ch.isdigit():
                    digits += ch
                else:
                    break
            mod = int(digits) if digits else 1
            out = out.replace(f"$index_mod{digits}", str(index % mod), 1)
        return out.replace("$index", str(index))
    return obj


class WorkloadRunner:
    def __init__(
        self,
        batch_size: int = 4096,
        sample_interval: float = 0.1,
        warmup: bool = True,
        device=None,
    ):
        self.batch_size = batch_size
        self.sample_interval = sample_interval
        # where each workload's Scheduler solves: None is the CUDA card
        # (Scheduler raises without one), "cpu" the plain versions
        self.device = device
        # Build and load the solver kernels before the measured window
        # (Scheduler.warmup): the framework's analogue of the reference
        # binary's ahead-of-time compilation.  The harness reports the
        # warm window as WallClockThroughput, the warmup cost as
        # WarmupDuration, and the cold total as
        # WallClockThroughputIncludingWarmup — disable with --no-warmup
        # for fully cold numbers.
        self.warmup = warmup

    def run(self, workload: Workload) -> List[DataItem]:
        """Execute one workload; returns its DataItems."""
        store = st.Store()
        sched = Scheduler(store, batch_size=self.batch_size, device=self.device)
        sched.start()
        created = {"nodes": 0, "pods": 0, "namespaces": []}
        items: List[DataItem] = []
        try:
            for op in workload.ops:
                self._execute(op, store, sched, created, items, workload)
        finally:
            sched.stop()
        if not created.get("metrics_done"):
            # no measured op collected a window: summarize the whole run
            items.extend(
                MetricsCollector(
                    sched.metrics,
                    labels={"Name": workload.full_name},
                ).collect()
            )
        return items

    # -- opcodes -----------------------------------------------------------

    def _execute(
        self,
        op: Op,
        store: st.Store,
        sched: Scheduler,
        created: Dict[str, Any],
        items: List[DataItem],
        workload: Workload,
    ) -> None:
        if op.opcode == "createNodes":
            template = op.node_template or _DEFAULT_NODE
            base = created["nodes"]
            for i in range(op.count):
                d = _substitute_index(template, base + i)
                d.setdefault("metadata", {})["name"] = f"node-{base + i}"
                store.create(kubeyaml.node_from_dict(d))
            created["nodes"] += op.count
        elif op.opcode == "createNamespaces":
            for i in range(op.count):
                created["namespaces"].append(f"{op.prefix}-{i}")
        elif op.opcode == "createPods":
            self._create_pods(op, store, sched, created, items, workload)
        elif op.opcode == "churn":
            self._churn(op, store)
        elif op.opcode == "barrier":
            self._barrier(store, op.namespace, sched=sched)
        elif op.opcode == "sleep":
            time.sleep(op.duration_s)
        else:
            raise ValueError(f"unsupported opcode {op.opcode}")

    def _warmup(self, op, sched, created, items, workload) -> float:
        """Build and load the kernels this op's pods will need, outside
        the measured window, using pods built from the op's own template
        so feature flags and constraint-table shapes match."""
        template = op.pod_template or _DEFAULT_POD
        namespace = op.namespace or "default"
        # the informer must have delivered every created node to the
        # scheduler cache first — warmup solves at the node bucket
        deadline = time.monotonic() + 60.0
        while (
            len(sched.tpu.state._rows) < created["nodes"]
            and time.monotonic() < deadline
        ):
            time.sleep(0.01)
        base = created["pods"]
        pods = []
        for i in range(min(op.count, self.batch_size)):
            d = _substitute_index(template, base + i)
            meta = d.setdefault("metadata", {})
            meta["name"] = f"warmup-{base + i}"
            meta["namespace"] = namespace
            pods.append(kubeyaml.pod_from_dict(d))
        dt = sched.warmup(pods)
        items.append(
            DataItem(
                {"Average": dt},
                "s",
                {"Name": workload.full_name, "Metric": "WarmupDuration"},
            )
        )
        return dt

    def _create_pods(self, op, store, sched, created, items, workload) -> None:
        template = op.pod_template or _DEFAULT_POD
        namespace = op.namespace or "default"
        base = created["pods"]
        collector = None
        warmup_s = 0.0
        if op.collect_metrics:
            # drain the init-phase backlog FIRST: (a) leftover init pods
            # binding inside the measured window pollute its percentiles
            # and jump to unwarmed merged-batch buckets; (b) warmup's
            # round-B phantom assume must not coexist with live pending
            # pods, or they could be repelled by the phantom
            sched.wait_for_idle(timeout=300)
        if op.collect_metrics and self.warmup:
            warmup_s = self._warmup(op, sched, created, items, workload)
        if op.collect_metrics:
            measured = {f"pod-{base + i}" for i in range(op.count)}
            collector = ThroughputCollector(
                store,
                namespaces=[namespace],
                interval=self.sample_interval,
                labels={"Name": workload.full_name},
                pod_names=measured,
                lister=(
                    sched.informers.informer("Pod").list
                    if sched is not None else None
                ),
            ).start()
        baseline = (
            histogram_baseline(sched.metrics) if op.collect_metrics else None
        )
        t0 = time.monotonic()
        for i in range(op.count):
            d = _substitute_index(template, base + i)
            meta = d.setdefault("metadata", {})
            meta["name"] = f"pod-{base + i}"
            meta["namespace"] = namespace
            store.create(kubeyaml.pod_from_dict(d))
        created["pods"] += op.count
        if collector is not None:
            # the barrier reads the scheduler's informer cache, which can
            # LAG the creations just written — a first poll that sees no
            # pending pods yet would declare victory with 0 scheduled.
            # Wait for the cache to observe every measured pod first.
            measured = {f"pod-{base + i}" for i in range(op.count)}
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline:
                seen = sum(
                    1
                    for p in self._pods_snapshot(store, sched)
                    if p.meta.name in measured
                )
                if seen >= op.count:
                    break
                time.sleep(0.01)
            # measured pods: wait for them all to schedule, then collect
            self._barrier(store, namespace, sched=sched)
            wall = time.monotonic() - t0
            collector.stop()
            items.extend(collector.collect())
            scheduled = self._scheduled(store, namespace, sched=sched)
            items.append(
                DataItem(
                    {"Average": scheduled / wall if wall > 0 else 0.0},
                    "pods/s",
                    {"Name": workload.full_name, "Metric": "WallClockThroughput"},
                )
            )
            # the cold view: what a fresh process pays including the
            # pre-window kernel warmup (0 when warmup is disabled —
            # then WallClockThroughput itself is the cold number)
            if warmup_s > 0:
                cold = scheduled / (wall + warmup_s)
                items.append(
                    DataItem(
                        {"Average": cold},
                        "pods/s",
                        {
                            "Name": workload.full_name,
                            "Metric": "WallClockThroughputIncludingWarmup",
                        },
                    )
                )
            # window-scoped attempt/algorithm percentiles (diffed over
            # the pre-window baseline, metricsCollector-style)
            items.extend(
                MetricsCollector(
                    sched.metrics,
                    labels={"Name": workload.full_name},
                    baseline=baseline,
                ).collect()
            )
            created["metrics_done"] = True

    @staticmethod
    def _pods_snapshot(
        store: st.Store, sched: Optional[Scheduler]
    ) -> List[api.Pod]:
        """Pods for polling loops.  The scheduler's informer cache is
        the cheap source: store.list deep-copies every object per call,
        and a 50ms poll over thousands of pods becomes a GIL-saturating
        copy storm that starves the commit loop it is waiting on
        (observed: 15 pods/s in TopologySpreading until the barrier
        stopped hammering store.list)."""
        if sched is not None:
            return sched.informers.informer("Pod").list()
        return store.list("Pod")[0]

    @classmethod
    def _scheduled(
        cls,
        store: st.Store,
        namespace: Optional[str],
        sched: Optional[Scheduler] = None,
    ) -> int:
        return sum(
            1
            for p in cls._pods_snapshot(store, sched)
            if p.spec.node_name
            and (namespace is None or p.meta.namespace == namespace)
        )

    def _barrier(
        self,
        store: st.Store,
        namespace: Optional[str],
        sched: Optional[Scheduler] = None,
        timeout: float = 300.0,
    ) -> None:
        """Wait until every created pod (in namespace, or all) is either
        scheduled or provably unschedulable-and-parked (barrierOp,
        scheduler_perf.go:593 — reference waits for scheduled only; we
        also accept parked pods so Unschedulable-style workloads
        terminate)."""
        deadline = time.monotonic() + timeout
        pending: List[api.Pod] = []
        stable = 0
        last_sig = None
        while time.monotonic() < deadline:
            pods = self._pods_snapshot(store, sched)
            pending = [
                p
                for p in pods
                if not p.spec.node_name
                and (namespace is None or p.meta.namespace == namespace)
            ]
            if not pending:
                return
            if sched is not None:
                qs = sched.queue.stats()
                live = qs["active"] + qs["inflight"] + qs["backoff"]
                parked = qs["unschedulable"] + qs["gated"] + qs["gang_staged"]
                # preemption (or any event) can un-park pods, so parked
                # counts only terminate the barrier once the system has
                # been quiescent for ~1s (20 consecutive identical polls)
                sig = (
                    len(pending),
                    parked,
                    sched.metrics.preemption_attempts.total,
                )
                stable = stable + 1 if (live == 0 and sig == last_sig) else 0
                last_sig = sig
                if stable >= 20 and parked >= len(pending):
                    return  # everything left is provably parked
            time.sleep(0.05)
        raise TimeoutError(
            f"barrier: {len(pending)} pods still unscheduled after {timeout}s"
        )

    def _churn(self, op: Op, store: st.Store) -> None:
        """Create (or create+delete) churn objects at an interval, once
        through `number` iterations (churnOp, scheduler_perf.go:540-588;
        the reference churns in a background goroutine for the workload's
        remainder — we run the iterations inline, which bounds runtime
        deterministically)."""
        ns = op.namespace or "churn"
        for i in range(op.number):
            objs = []
            for t, template in enumerate(op.templates or [_DEFAULT_POD]):
                d = _substitute_index(template, i)
                meta = d.setdefault("metadata", {})
                meta["name"] = f"churn-{t}-{i}"
                meta["namespace"] = ns
                obj = (
                    kubeyaml.node_from_dict(d)
                    if d.get("kind") == "Node"
                    else kubeyaml.pod_from_dict(d)
                )
                store.create(obj)
                objs.append(obj)
            if op.mode == "recreate":
                for obj in objs:
                    store.delete(
                        obj.KIND, obj.meta.name, obj.meta.namespace
                    )
            time.sleep(op.interval_ms / 1000.0)


def run_workloads(
    workloads: List[Workload], out_path: Optional[str] = None, **kw
) -> Dict[str, Any]:  # kw: batch_size / sample_interval / warmup / device
    """Run a list of workloads; returns (and optionally writes) the
    reference's result-JSON shape {version, dataItems}."""
    runner = WorkloadRunner(**kw)
    all_items: List[DataItem] = []
    for wl in workloads:
        all_items.extend(runner.run(wl))
    result = {"version": "v1", "dataItems": all_items}
    if out_path:
        with open(out_path, "w") as f:
            json.dump(result, f, indent=2)
    return result
