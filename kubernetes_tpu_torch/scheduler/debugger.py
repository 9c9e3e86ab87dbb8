"""Cache debugger: dual-bookkeeping comparison + state dump — a copy of
kubernetes_tpu/scheduler/debugger.py over this package's SchedulerCache
and Store (host objects only: it reads the cache's row and pod maps,
never a tensor).

Reference: internal/cache/debugger — CacheComparer diffs the scheduler
cache against the informer's authoritative view (comparer.go:135) and
CacheDumper snapshots it, both wired to SIGUSR2 (signal.go:26).  The
race-detection value is the invariant: after any interleaving of
informer events and solve/assume/forget traffic, the tensor state must
equal what the store says.
"""

from __future__ import annotations

import signal
from typing import Dict, List, Tuple

from ..api import store as st
from .cache import SchedulerCache
from .queue import pod_key


class CacheComparer:
    def __init__(self, store: st.Store, cache: SchedulerCache):
        self.store = store
        self.cache = cache

    def compare(self) -> List[str]:
        """Differences between the store's authoritative state and the
        scheduler cache's tensor bookkeeping; empty list = consistent.
        Assumed-but-unconfirmed pods are expected deltas and excluded
        (the comparer tolerates in-flight assumes, comparer.go:68)."""
        problems: List[str] = []
        with self.cache.lock:
            state = self.cache.state
            assumed = set(self.cache._assumed.keys())
            waiting = {
                k
                for by_node in self.cache._waiting_on_node.values()
                for k in by_node.keys()
            }

            nodes, _ = self.store.list("Node")
            store_nodes = {n.meta.name for n in nodes}
            cache_nodes = set(state._rows.keys())
            for missing in store_nodes - cache_nodes:
                problems.append(f"node {missing} in store but not cache")
            for extra in cache_nodes - store_nodes:
                problems.append(f"node {extra} in cache but not store")

            pods, _ = self.store.list("Pod")
            store_bound = {
                pod_key(p): p.spec.node_name
                for p in pods
                if p.spec.node_name and p.spec.node_name in cache_nodes
            }
            cache_bound = dict(state._pod_node)
            for k, node in store_bound.items():
                if k in waiting:
                    continue  # delivered before its node; parked by design
                got = cache_bound.get(k)
                if got is None and k not in assumed:
                    problems.append(f"pod {k} bound to {node} missing from cache")
                elif got is not None and got != node:
                    problems.append(
                        f"pod {k}: store says {node}, cache says {got}"
                    )
            for k, node in cache_bound.items():
                if k not in store_bound and k not in assumed:
                    problems.append(f"pod {k} on {node} in cache but not store")
        return problems

    def dump(self) -> Dict[str, object]:
        """The CacheDumper analogue: a host-readable snapshot summary."""
        with self.cache.lock:
            state = self.cache.state
            return {
                "nodes": len(state._rows),
                "bound_pods": len(state._pods),
                "assumed": len(self.cache._assumed),
                "waiting_on_node": sum(
                    len(v) for v in self.cache._waiting_on_node.values()
                ),
                "nominated": len(self.cache._nominated),
            }

    def install_signal_handler(self, signum=signal.SIGUSR2) -> None:
        """Dump + compare on SIGUSR2 (debugger/signal.go:26)."""

        def handler(_sig, _frame):
            import logging

            log = logging.getLogger(__name__)
            log.warning("cache dump: %s", self.dump())
            for p in self.compare():
                log.warning("cache comparer: %s", p)

        signal.signal(signum, handler)
