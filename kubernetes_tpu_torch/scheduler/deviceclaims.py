"""Dynamic resource allocation — device claims: a copy of
kubernetes_tpu/scheduler/deviceclaims.py, host code only.

The reference's DynamicResources plugin (plugins/dynamicresources/
dynamicresources.go:275,1145 — 2,161 LoC of PreEnqueue/PreFilter/
Filter/Reserve/Unreserve/PreBind over ResourceClaim objects) walks
nodes matching claim allocations.  The batched design reuses the two
primitives the rest of scheduling already rides:

  * device CAPACITY is a node-published countable resource
    (`devices/<class>`, api.device_resource) — an UNALLOCATED claim's
    device count folds into the consuming pod's effective requests and
    the NodeResourcesFit kernel does the filtering;
  * an ALLOCATED claim pins its consumers to the allocation's node via
    a hostname selector term riding the static-feasibility bitsets —
    which is how claim SHARING co-locates pods (the DRA property device
    plugins can't express).

Host side (this module): claim/class indexes fed by informers, the
Reserve/Unreserve assume cache, and PreBind allocation writes — the
same protocol shape as scheduler/volumebinding.py.

Accounting model: device usage rides the consuming pods' effective
requests, with one CARRIER per claim (recorded on the claim at
allocation): the carrier's requests include the device count for the
claim's whole lifetime — from its own solve (claim unallocated then)
through cache add and remove — so the node's usage vector stays exact
and symmetric; sharers contribute only the co-location pin.  Reserve
rejects a placement whose node disagrees with an existing allocation
(two sharers solved in one batch re-solve under the pin).

Carrier death with surviving sharers HANDS OFF: on_consumer_delete
promotes a surviving consumer to carrier (claim status write + cache
re-account under the cache lock), so the allocation's devices stay
charged to the node until the LAST consumer is gone — the reference's
allocation-holds-until-deallocate semantics (dynamicresources.go:275).
Consumers are tracked in an O(1) index fed by the scheduler's pod
events, so the delete path no longer lists every pod.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

from ..api import store as st
from ..api import types as api

_IMPOSSIBLE = api.NodeSelector(
    terms=[
        api.NodeSelectorTerm(
            match_expressions=[
                api.Requirement(
                    "resource.kubernetes.io/unsatisfiable", api.OP_IN,
                    ["true"],
                )
            ]
        )
    ]
)


def _pin(node_name: str) -> api.NodeSelector:
    return api.NodeSelector(
        terms=[
            api.NodeSelectorTerm(
                match_expressions=[
                    api.Requirement(
                        api.LABEL_HOSTNAME, api.OP_IN, [node_name]
                    )
                ]
            )
        ]
    )


# -- topology-shaped claims ---------------------------------------------------
#
# A claim with spec.topology = "AxBxC" requests a contiguous carve-out
# of one TPU slice instead of `count` loose devices.  The prospective
# carrier solves WITH the shape (pod_shape -> SnapshotBuilder
# pod_shape_hook), so the batched carve-out kernels steer it onto a
# free-box corner; Reserve then records the carve-out anchored at the
# landing node's coordinates and every consumer — carrier and sharers —
# is pinned INSIDE the box by slice/coord label selector terms, which
# the batched static-feasibility filter evaluates like any other
# selector (no host Python on the match path).


def format_carveout(slice_name: str, lo, shape) -> str:
    return (
        f"slice={slice_name};lo={lo[0]},{lo[1]},{lo[2]};"
        f"shape={shape[0]}x{shape[1]}x{shape[2]}"
    )


def parse_carveout(text: str):
    """(slice, (x,y,z), (a,b,c)) or None for empty/malformed."""
    if not text:
        return None
    fields = dict(
        part.split("=", 1) for part in text.split(";") if "=" in part
    )
    lo = api.parse_coords(fields.get("lo"))
    shape = api.parse_topology(fields.get("shape"))
    name = fields.get("slice")
    if not name or lo is None or shape is None:
        return None
    return name, lo, shape


def _pin_carveout(carve) -> api.NodeSelector:
    """Selector pinning a consumer inside a recorded carve-out: slice
    name + the enumerated coordinate strings of the box (the host-side
    expansion into explicit value sets is exactly how every selector
    reaches the device bitsets — ops/schema.py module docstring)."""
    name, (x0, y0, z0), (a, b, c) = carve
    coords = [
        f"{x},{y},{z}"
        for z in range(z0, z0 + c)
        for y in range(y0, y0 + b)
        for x in range(x0, x0 + a)
    ]
    return api.NodeSelector(
        terms=[
            api.NodeSelectorTerm(
                match_expressions=[
                    api.Requirement(api.LABEL_TPU_SLICE, api.OP_IN, [name]),
                    api.Requirement(api.LABEL_TPU_COORDS, api.OP_IN, coords),
                ]
            )
        ]
    )


def _node_slice_info(node: api.Node):
    """(slice, coords) of a node's TPU labels, or None (the host half of
    the ops/schema.py encode semantics — malformed degrades to absent)."""
    labels = node.meta.labels
    name = labels.get(api.LABEL_TPU_SLICE)
    if not name:
        return None
    dims = api.parse_topology(labels.get(api.LABEL_TPU_TOPOLOGY))
    coords = api.parse_coords(labels.get(api.LABEL_TPU_COORDS))
    if dims is None or coords is None:
        return None
    if any(cc >= d for cc, d in zip(coords, dims)):
        return None
    return name, coords


class DeviceClaimBinder:
    """Host-side DRA state + the Reserve/PreBind protocol."""

    def __init__(self, store: st.Store):
        self.store = store
        self._mu = threading.RLock()
        self._claims: Dict[str, api.ResourceClaim] = {}   # ns/name
        self._classes: Dict[str, api.DeviceClass] = {}
        # assume cache: claim key -> (node, carrier pod key) at Reserve
        self._assumed: Dict[str, Tuple[str, str]] = {}
        # assumed carve-outs of topology-shaped claims: claim key ->
        # formatted carveout string (written through at PreBind)
        self._assumed_carve: Dict[str, str] = {}
        # consumer index: claim key -> live consumer pod keys (fed by
        # the scheduler's pod events; replaces O(pods) delete scans)
        self._consumers: Dict[str, set] = {}

    # -- informer handlers -------------------------------------------------

    def on_claim(self, typ: str, claim: api.ResourceClaim, old) -> None:
        key = f"{claim.meta.namespace}/{claim.meta.name}"
        with self._mu:
            if typ == st.DELETED:
                self._claims.pop(key, None)
                self._assumed.pop(key, None)
                self._assumed_carve.pop(key, None)
            else:
                self._claims[key] = claim
                if claim.status.allocated_node:
                    # the written allocation supersedes the assume
                    self._assumed.pop(key, None)
                    self._assumed_carve.pop(key, None)

    def on_class(self, typ: str, dc: api.DeviceClass, old) -> None:
        with self._mu:
            if typ == st.DELETED:
                self._classes.pop(dc.meta.name, None)
            else:
                self._classes[dc.meta.name] = dc

    # -- the pod_transform hook --------------------------------------------

    def _allocation(self, key: str, claim) -> Tuple[str, str]:
        """(node, carrier) for a claim — from written status or the
        assume cache.  Callers hold self._mu."""
        if claim.status.allocated_node:
            return claim.status.allocated_node, claim.status.carrier
        return self._assumed.get(key, ("", ""))

    def _carveout(self, key: str, claim):
        """The claim's recorded carve-out (written status or the assume
        cache), parsed, or None.  Callers hold self._mu."""
        return parse_carveout(
            claim.status.carveout or self._assumed_carve.get(key, "")
        )

    def pod_shape(self, pod: api.Pod):
        """SnapshotBuilder.pod_shape_hook: the carve-out extent the
        pod's FIRST unallocated topology-shaped claim requests, or None.
        Once a carve-out is recorded, consumers pin inside it via the
        box selector instead (pod_requirements) and solve unshaped."""
        with self._mu:
            for claim_name in pod.spec.resource_claims:
                key = f"{pod.meta.namespace}/{claim_name}"
                claim = self._claims.get(key)
                if claim is None or not claim.spec.topology:
                    continue
                node, _carrier = self._allocation(key, claim)
                if node:
                    continue
                shape = api.parse_topology(claim.spec.topology)
                if shape is not None:
                    return shape
        return None

    def pod_requirements(
        self, pod: api.Pod
    ) -> Tuple[Optional[api.NodeSelector], Dict[str, int]]:
        pkey = f"{pod.meta.namespace}/{pod.meta.name}"
        selector: Optional[api.NodeSelector] = None
        requests: Dict[str, int] = {}
        with self._mu:
            for claim_name in pod.spec.resource_claims:
                key = f"{pod.meta.namespace}/{claim_name}"
                claim = self._claims.get(key)
                if claim is None:
                    return _IMPOSSIBLE, {}
                if claim.spec.device_class_name not in self._classes:
                    return _IMPOSSIBLE, {}
                node, carrier = self._allocation(key, claim)
                res = api.device_resource(claim.spec.device_class_name)
                if node:
                    # allocated: every consumer co-locates; the CARRIER
                    # keeps carrying the device count so the node's
                    # usage stays accounted for the claim's lifetime.
                    # A topology-shaped allocation pins consumers INSIDE
                    # the carve-out box (matched in the batched filter)
                    # instead of onto the carrier's single node.
                    carve = self._carveout(key, claim)
                    pin = _pin_carveout(carve) if carve else _pin(node)
                    selector = api.and_selectors(selector, pin)
                    if carrier == pkey:
                        requests[res] = (
                            requests.get(res, 0) + claim.spec.count
                        )
                    continue
                requests[res] = requests.get(res, 0) + claim.spec.count
        return selector, requests

    # -- Reserve / Unreserve / PreBind ------------------------------------

    def reserve(self, pod: api.Pod, node: api.Node) -> bool:
        """Assume allocations for the pod's unallocated claims on the
        chosen node (capacity was already enforced by the fit kernel via
        the synthetic requests).  A claim already allocated/assumed to a
        DIFFERENT node rejects the placement — two sharers solved in one
        batch (both seeing the claim unallocated) would otherwise bind
        to different nodes; the loser re-solves under the pin."""
        pkey = f"{pod.meta.namespace}/{pod.meta.name}"
        with self._mu:
            picked = []

            def rollback():
                for k in picked:
                    self._assumed.pop(k, None)
                    self._assumed_carve.pop(k, None)

            for claim_name in pod.spec.resource_claims:
                key = f"{pod.meta.namespace}/{claim_name}"
                claim = self._claims.get(key)
                if claim is None:
                    rollback()
                    return False
                alloc_node, _carrier = self._allocation(key, claim)
                if alloc_node:
                    carve = self._carveout(key, claim)
                    if carve is not None:
                        # topology-shaped allocation: any node INSIDE
                        # the carve-out is the allocation's home
                        info = _node_slice_info(node)
                        sname, lo, shape = carve
                        inside = (
                            info is not None
                            and info[0] == sname
                            and all(
                                l <= c < l + s
                                for c, l, s in zip(info[1], lo, shape)
                            )
                        )
                        if not inside:
                            rollback()
                            return False
                    elif alloc_node != node.meta.name:
                        rollback()
                        return False
                    continue
                self._assumed[key] = (node.meta.name, pkey)
                if claim.spec.topology:
                    # anchor the carve-out at the carrier's landing
                    # coordinates (the carve-out kernels steered the
                    # shaped solve onto a free-box corner); a claim
                    # landing off-slice degrades to the plain node pin
                    shape = api.parse_topology(claim.spec.topology)
                    info = _node_slice_info(node)
                    if shape is not None and info is not None:
                        self._assumed_carve[key] = format_carveout(
                            info[0], info[1], shape
                        )
                picked.append(key)
            return True

    def unreserve(self, pod: api.Pod) -> None:
        pkey = f"{pod.meta.namespace}/{pod.meta.name}"
        with self._mu:
            for claim_name in pod.spec.resource_claims:
                key = f"{pod.meta.namespace}/{claim_name}"
                if self._assumed.get(key, ("", ""))[1] == pkey:
                    self._assumed.pop(key, None)
                    self._assumed_carve.pop(key, None)

    def prebind(self, pod: api.Pod, node_name: str) -> None:
        """Write assumed allocations through the API (the PreBind claim
        status update, dynamicresources.go:1145)."""
        for claim_name in pod.spec.resource_claims:
            key = f"{pod.meta.namespace}/{claim_name}"
            with self._mu:
                assumed = self._assumed.get(key)
                carve = self._assumed_carve.get(key, "")
            if assumed is None:
                continue
            node, carrier = assumed
            claim = self.store.get(
                "ResourceClaim", claim_name, pod.meta.namespace
            )
            if not claim.status.allocated_node:
                claim.status.allocated_node = node
                claim.status.carrier = carrier
                claim.status.carveout = carve
                claim.status.phase = "Allocated"
                self.store.update(claim)
            # the assume stays until the informer echoes the write back
            # into _claims — dropping it earlier would briefly account
            # the carrier's devices as unallocated again
            with self._mu:
                cached = self._claims.get(key)
                if cached is not None and cached.status.allocated_node:
                    self._assumed.pop(key, None)

    # -- consumer tracking + deallocation ----------------------------------

    def track_pod(self, typ: str, pod: api.Pod) -> None:
        """Maintain the claim→consumers index from the scheduler's pod
        informer events (pods without claims never reach here)."""
        pkey = f"{pod.meta.namespace}/{pod.meta.name}"
        with self._mu:
            for claim_name in pod.spec.resource_claims:
                key = f"{pod.meta.namespace}/{claim_name}"
                if typ == st.DELETED:
                    self._consumers.get(key, set()).discard(pkey)
                else:
                    self._consumers.setdefault(key, set()).add(pkey)

    def on_consumer_delete(self, claim_key: str, deleted_pkey: str,
                           cache=None) -> None:
        """A consumer died.  Last one out deallocates the claim; a dead
        CARRIER with surviving sharers hands its accounting to a
        survivor (claim-status write + cache re-account) so the devices
        stay charged until deallocation (dynamicresources.go:275)."""
        with self._mu:
            claim = self._claims.get(claim_key)
            survivors = set(self._consumers.get(claim_key, ()))
        survivors.discard(deleted_pkey)
        if claim is None or not claim.status.allocated_node:
            return
        if not survivors:
            self._consumers.pop(claim_key, None)
            try:
                fresh = self.store.get(
                    "ResourceClaim", claim.meta.name, claim.meta.namespace
                )
                fresh.status.allocated_node = ""
                fresh.status.carrier = ""
                fresh.status.carveout = ""
                fresh.status.phase = "Pending"
                self.store.update(fresh)
            except (st.NotFound, st.Conflict):
                pass
            return
        if claim.status.carrier != deleted_pkey:
            return  # a sharer died; the carrier still accounts
        self._transfer_carrier(claim, survivors, cache)

    def _transfer_carrier(self, claim, survivors, cache) -> None:
        """Promote a survivor (preferring one bound to the allocation's
        node) to carrier.  Order matters for accounting symmetry: the
        survivor is UN-accounted under the old carrier identity, the
        carrier flips, then it is re-accounted — its usage now includes
        the devices.  An unbound survivor needs no re-account; it will
        account as carrier when it binds."""
        alloc_node = claim.status.allocated_node
        chosen, chosen_pod = None, None
        for pkey in sorted(survivors):
            ns, _, name = pkey.partition("/")
            try:
                p = self.store.get("Pod", name, ns)
            except st.NotFound:
                continue
            if p.spec.node_name == alloc_node:
                chosen, chosen_pod = pkey, p
                break
            if chosen is None:
                chosen, chosen_pod = pkey, p
        if chosen is None:
            return
        key = f"{claim.meta.namespace}/{claim.meta.name}"
        lock = cache.lock if cache is not None else threading.RLock()
        with lock:
            bound_here = (
                cache is not None
                and chosen_pod.spec.node_name == alloc_node
                and cache.state.has_pod(chosen_pod)
            )
            if bound_here:
                cache.state.remove_pod(chosen_pod)  # usage sans devices
            with self._mu:
                cached = self._claims.get(key)
                if cached is not None:
                    cached.status.carrier = chosen
            if bound_here:
                cache.state.add_pod(chosen_pod)     # usage with devices
        try:
            fresh = self.store.get(
                "ResourceClaim", claim.meta.name, claim.meta.namespace
            )
            fresh.status.carrier = chosen
            self.store.update(fresh)
        except (st.NotFound, st.Conflict):
            pass

    def maybe_deallocate(self, claim_key: str) -> None:
        """Back-compat shim for direct callers: consult the consumer
        index (falling back to a store list when the index never saw
        this claim) and deallocate when empty."""
        with self._mu:
            known = claim_key in self._consumers
            survivors = set(self._consumers.get(claim_key, ()))
            claim = self._claims.get(claim_key)
        if claim is None or not claim.status.allocated_node:
            return
        if not known:
            pods, _ = self.store.list("Pod", namespace=claim.meta.namespace)
            survivors = {
                f"{p.meta.namespace}/{p.meta.name}"
                for p in pods
                if claim.meta.name in p.spec.resource_claims
            }
        if survivors:
            return
        try:
            fresh = self.store.get(
                "ResourceClaim", claim.meta.name, claim.meta.namespace
            )
            fresh.status.allocated_node = ""
            fresh.status.carrier = ""
            fresh.status.carveout = ""
            fresh.status.phase = "Pending"
            self.store.update(fresh)
        except (st.NotFound, st.Conflict):
            pass
