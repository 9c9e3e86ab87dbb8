"""Coscheduling at Permit — gangs held in the waiting-pods map.

The out-of-tree coscheduling plugin's real mechanism: each gang member
returns Wait at Permit; when the last member arrives, the plugin walks
the waiting map and Allows the whole group; a timeout rejects the
stragglers and the group retries.  Our queue already stages gangs
pre-solve (SchedulingQueue gang staging) — this plugin is the
alternative hold point for groups whose size is declared out-of-band
(no scheduling_group_size on the pods), and the proof that the Permit
seam carries the protocol real plugins need.

Usage (sizes from PodGroup API objects — the real plugin's shape):
    from ..api import crd
    crd.install_podgroup_crd(store)
    store.create(crd.pod_group("my-gang", min_member=4))
    cos = CoschedulingPermit(
        scheduler.waiting, directory=crd.PodGroupDirectory(store)
    )
    for fwk in scheduler.profiles:
        fwk.register("permit", cos.permit)

Usage (out-of-band dict, kept for tests/embedding):
    cos = CoschedulingPermit(scheduler.waiting, sizes={"my-gang": 4})

Release is quorum-of-currently-waiting: a member that times out and
requeues re-enters Permit on its retry, so stale arrivals can never
release a partial gang.

Slice carve-out preference (docs/scheduler_loop.md "TPU slice
topology"): with a `node_lookup` wired, the release point additionally
checks whether the gang's placements realize a contiguous carve-out —
one slice, pairwise-distinct coordinates, bounding-box volume equal to
the member count.  `carveout="prefer"` only counts the outcome
(gang_contiguous_placements_total / slice_carveout_fallbacks_total
when a metrics registry is given); `carveout="require"` REJECTS a
non-contiguous gang instead of allowing it — every member requeues and
re-solves (the solver's require-mode filter then steers the retry onto
a contiguous sub-cuboid), so a fragmented release can never bind.

A copy of the reference package's scheduler/coscheduling.py, whole.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from ..api import types as api
from .waitingpods import WaitingPodsMap

DEFAULT_PERMIT_TIMEOUT = 30.0


def carveout_contiguous(nodes) -> bool:
    """True when the node set realizes a contiguous carve-out: every
    node slice-labelled, one slice, pairwise-distinct coordinates, and
    the axis-aligned bounding box exactly filled (volume == count) —
    the host-policy half of the ops/slices.py semantics contract."""
    infos = []
    for node in nodes:
        if node is None:
            return False
        labels = node.meta.labels
        name = labels.get(api.LABEL_TPU_SLICE)
        coords = api.parse_coords(labels.get(api.LABEL_TPU_COORDS))
        if not name or coords is None:
            return False
        infos.append((name, coords))
    if not infos:
        return False
    if len({name for name, _ in infos}) != 1:
        return False
    coords = [c for _, c in infos]
    if len(set(coords)) != len(coords):
        return False
    vol = 1
    for axis in range(3):
        vals = [c[axis] for c in coords]
        vol *= max(vals) - min(vals) + 1
    return vol == len(coords)


class CoschedulingPermit:
    def __init__(
        self,
        waiting: WaitingPodsMap,
        sizes: Optional[Dict[str, int]] = None,
        timeout: float = DEFAULT_PERMIT_TIMEOUT,
        directory=None,  # api.crd.PodGroupDirectory: sizes from PodGroups
        carveout: str = "prefer",   # prefer | require | off
        node_lookup=None,           # name -> api.Node, for carve-out checks
        metrics=None,               # scheduler.metrics.Registry (optional)
    ):
        self.waiting = waiting
        self.sizes = dict(sizes or {})
        self.timeout = timeout
        self.directory = directory
        if carveout not in ("prefer", "require", "off"):
            raise ValueError(
                f"carveout must be prefer|require|off, got {carveout!r}"
            )
        self.carveout = carveout
        self.node_lookup = node_lookup
        self.metrics = metrics
        self._lock = threading.Lock()

    def _gang_shaped(self, pods) -> bool:
        return any(api.parse_topology(p.spec.tpu_topology) for p in pods)

    def _check_carveout(self, pods, node_names) -> Optional[bool]:
        """None = not applicable (policy off / unshaped gang / no node
        lookup); else whether the placements realize a carve-out."""
        if self.carveout == "off" or self.node_lookup is None:
            return None
        if not self._gang_shaped(pods):
            return None
        return carveout_contiguous(
            [self.node_lookup(name) for name in node_names]
        )

    def _size_of(self, pod: api.Pod) -> Optional[int]:
        g = pod.spec.scheduling_group
        if g is None:
            return None
        if g in self.sizes:
            return self.sizes[g]
        if self.directory is not None:
            return self.directory.size_for(pod.meta.namespace, g)
        return None

    def _timeout_of(self, pod: api.Pod) -> float:
        if self.directory is not None:
            t = self.directory.timeout_for(
                pod.meta.namespace, pod.spec.scheduling_group
            )
            if t:
                return float(t)
        return self.timeout

    def group_of(self, pod: api.Pod) -> Optional[str]:
        g = pod.spec.scheduling_group
        return g if self._size_of(pod) is not None else None

    def _waiting_members(self, namespace: str, group: str):
        """Members of (namespace, group) CURRENTLY parked at Permit.
        Release decisions read the live waiting map, never an arrival
        history — a member that timed out and was requeued must not
        count toward the quorum (it will re-enter Permit on retry), and
        same-named gangs in different namespaces must not pool."""
        return [
            wp for wp in self.waiting.iterate()
            if wp.pod.spec.scheduling_group == group
            and wp.pod.meta.namespace == namespace
        ]

    def permit(self, pod: api.Pod, node: str):
        """The Permit plugin callable: Wait until the declared member
        count is simultaneously parked at Permit, then Allow the whole
        group (this pod itself returns allow — it never enters the
        map).  Release is two-phase (WaitingPod.try_claim then allow):
        a member timing out between the quorum snapshot and the release
        makes its claim fail, the claims roll back, and this pod waits —
        a partial gang can never be allowed."""
        group = pod.spec.scheduling_group
        if group is None:
            return "allow", 0.0
        # ONE size lookup: the directory reads live API objects, and a
        # PodGroup deleted between two lookups must not surface as a
        # TypeError mid-Permit
        size = self._size_of(pod)
        if size is None:
            return "allow", 0.0
        timeout = self._timeout_of(pod)
        with self._lock:
            parked = self._waiting_members(pod.meta.namespace, group)
            if len(parked) + 1 < size:
                return "wait", timeout
            claimed = [wp for wp in parked if wp.try_claim()]
            if len(claimed) + 1 < size:
                for wp in claimed:
                    wp.release_claim()
                return "wait", timeout
            # carve-out check at the release point: the whole gang's
            # placements are known only here
            contiguous = self._check_carveout(
                [wp.pod for wp in claimed] + [pod],
                [wp.node for wp in claimed] + [node],
            )
            if contiguous is not None and self.metrics is not None:
                if contiguous:
                    self.metrics.gang_contiguous_placements.inc()
                else:
                    self.metrics.slice_carveout_fallbacks.inc()
            if contiguous is False and self.carveout == "require":
                # reject instead of binding a fragmented gang: claims
                # roll back first (reject defers to a held claim), then
                # every member requeues and re-solves under the
                # require-mode carve-out filter
                for wp in claimed:
                    wp.release_claim()
                for wp in claimed:
                    wp.reject("slice carve-out not contiguous")
                return "reject", 0.0
            for wp in claimed:
                wp.allow()
            return "allow", 0.0
