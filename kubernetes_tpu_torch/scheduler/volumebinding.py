"""VolumeBinding — the storage-topology scheduling family: a copy of
kubernetes_tpu/scheduler/volumebinding.py, host code only.

The reference's VolumeBinding plugin (pkg/scheduler/framework/plugins/
volumebinding/volume_binding.go:69,248 — PreFilter/Filter/Reserve/
PreBind over an assume cache, 2,119 LoC) walks every node in Filter and
re-matches PVs against claims per node.  The batched design moves the
whole per-node feasibility question INTO the existing tensor pipeline
instead of adding a new device kernel:

  * a bound PVC's PV carries a NodeSelector (VolumeNodeAffinity) — that
    IS a required node selector, so it is ANDed into the pod's effective
    selector and rides the static-feasibility bitset kernels;
  * an unbound PVC's eligible PVs form an OR over their node
    affinities — exactly a NodeSelector's OR-of-AND term list;
  * WaitForFirstConsumer dynamic provisioning contributes the storage
    class's allowedTopologies as another OR term;
  * CSI attach limits are node-published countable resources
    (`attachable-volumes-<driver>`, mirroring nodevolumelimits/csi.go) —
    they ride the NodeResourcesFit kernel as scalar resources.

So Filter costs nothing new on device; this module is the HOST half:
claim/volume indexing, the per-pod requirement derivation
(SnapshotBuilder.pod_transform), Reserve/Unreserve with an assume cache
(util/assumecache/assume_cache.go), and PreBind API writes.

A claim that cannot be satisfied at all (missing PVC, no candidate PV
and no provisioner) yields an IMPOSSIBLE selector — the pod solves to
unschedulable with the static-failure reason and PV/PVC cluster events
requeue it (the UnschedulableAndUnresolvable analogue).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from ..api import store as st
from ..api import types as api

# a label key no node can carry: ANDing this into a selector makes it
# statically infeasible everywhere
_IMPOSSIBLE = api.NodeSelector(
    terms=[
        api.NodeSelectorTerm(
            match_expressions=[
                api.Requirement(
                    "volume.kubernetes.io/unsatisfiable", api.OP_IN, ["true"]
                )
            ]
        )
    ]
)


and_selectors = api.and_selectors  # canonical definition: api.types


def _host_pin(node_name: str) -> api.NodeSelector:
    return api.NodeSelector(terms=[
        api.NodeSelectorTerm(match_expressions=[
            api.Requirement(api.LABEL_HOSTNAME, api.OP_IN, [node_name])
        ])
    ])


class VolumeBinder:
    """Host-side volume state + the Reserve/PreBind protocol.

    Thread model: informer handlers mutate the indexes under self._mu;
    pod_requirements runs under the scheduler cache lock during encode
    (single scheduling thread), reserve/prebind/unreserve run on the
    scheduling thread only.
    """

    def __init__(self, store: st.Store):
        self.store = store
        self._mu = threading.RLock()
        self._pvs: Dict[str, api.PersistentVolume] = {}
        # claimRef -> pv name, for O(1) half-bound crash repair
        self._claimref_index: Dict[str, str] = {}
        self._pvcs: Dict[str, api.PersistentVolumeClaim] = {}  # ns/name
        self._classes: Dict[str, api.StorageClass] = {}
        # assume cache (util/assumecache): pv name -> claim key it is
        # reserved for, and claim key -> (pv name | None for provision)
        self._assumed_pv: Dict[str, str] = {}
        self._assumed_claim: Dict[str, Optional[str]] = {}
        # drivers with at least one node publishing an attach limit —
        # absent limit means unlimited (nodevolumelimits: no CSINode
        # entry, no cap), so attach requests are only emitted for
        # limited drivers
        self._limited_drivers: set = set()
        # claim key -> {pod key: node}: bound consumers per claim (the
        # VolumeRestrictions multi-attach input)
        self._claim_consumers: Dict[str, Dict[str, str]] = {}

    # -- informer handlers -------------------------------------------------

    def on_pv(self, typ: str, pv: api.PersistentVolume, old) -> None:
        with self._mu:
            if typ == st.DELETED:
                gone = self._pvs.pop(pv.meta.name, None)
                if gone is not None and gone.spec.claim_ref:
                    self._claimref_index.pop(gone.spec.claim_ref, None)
            else:
                prev = self._pvs.get(pv.meta.name)
                if (
                    prev is not None
                    and prev.spec.claim_ref
                    and prev.spec.claim_ref != pv.spec.claim_ref
                ):
                    self._claimref_index.pop(prev.spec.claim_ref, None)
                self._pvs[pv.meta.name] = pv
                if pv.spec.claim_ref:
                    self._claimref_index[pv.spec.claim_ref] = pv.meta.name

    def on_pvc(self, typ: str, pvc: api.PersistentVolumeClaim, old) -> None:
        key = f"{pvc.meta.namespace}/{pvc.meta.name}"
        with self._mu:
            if typ == st.DELETED:
                self._pvcs.pop(key, None)
            else:
                self._pvcs[key] = pvc

    def on_class(self, typ: str, sc: api.StorageClass, old) -> None:
        with self._mu:
            if typ == st.DELETED:
                self._classes.pop(sc.meta.name, None)
            else:
                self._classes[sc.meta.name] = sc

    def on_node(self, typ: str, node: api.Node, old) -> None:
        with self._mu:
            for key in node.status.allocatable:
                if key.startswith(api.ATTACH_LIMIT_PREFIX):
                    self._limited_drivers.add(
                        key[len(api.ATTACH_LIMIT_PREFIX):]
                    )

    def on_pod(self, typ: str, pod: api.Pod, old) -> None:
        """Track which node each claim's BOUND consumers run on — the
        VolumeRestrictions multi-attach input
        (plugins/volumerestrictions/volume_restrictions.go:306): a
        ReadWriteOnce volume in use on node X forces later consumers to
        co-locate on X."""
        claims = [
            v.persistent_volume_claim
            for v in pod.spec.volumes
            if v.persistent_volume_claim
        ]
        if not claims:
            return
        pkey = f"{pod.meta.namespace}/{pod.meta.name}"
        with self._mu:
            for claim in claims:
                key = f"{pod.meta.namespace}/{claim}"
                consumers = self._claim_consumers.setdefault(key, {})
                if (
                    typ == st.DELETED
                    or not pod.spec.node_name
                    # terminal pods release the attachment — an evicted
                    # consumer must not pin replacements to its node
                    or pod.status.phase in ("Succeeded", "Failed")
                ):
                    consumers.pop(pkey, None)
                    if not consumers:
                        self._claim_consumers.pop(key, None)
                else:
                    consumers[pkey] = pod.spec.node_name

    # -- the pod_transform hook (encode-time requirement derivation) -------

    def pod_requirements(
        self, pod: api.Pod
    ) -> Tuple[Optional[api.NodeSelector], Dict[str, int]]:
        """(extra required selector, extra scalar requests) for the pod's
        PVC-backed volumes — the PreFilter analogue, folded into the
        snapshot encode so the device Filter pass needs no volume
        kernel."""
        selector: Optional[api.NodeSelector] = None
        attach: Dict[str, int] = {}
        with self._mu:
            for vol in pod.spec.volumes:
                claim = vol.persistent_volume_claim
                if not claim:
                    continue
                key = f"{pod.meta.namespace}/{claim}"
                pvc = self._pvcs.get(key)
                if pvc is None:
                    return _IMPOSSIBLE, {}  # claim object missing
                sel, driver = self._claim_constraint(key, pvc)
                if sel is _IMPOSSIBLE:
                    return _IMPOSSIBLE, {}
                selector = and_selectors(selector, sel)
                if driver and driver in self._limited_drivers:
                    res = api.attach_limit_resource(driver)
                    attach[res] = attach.get(res, 0) + 1
        return selector, attach

    def _claim_constraint(
        self, key: str, pvc: api.PersistentVolumeClaim
    ) -> Tuple[Optional[api.NodeSelector], str]:
        """One claim's node constraint + its attach-limit driver.

        Driver note: for an UNBOUND claim the attach-limit driver is
        taken from the first eligible PV (falling back to the class
        provisioner), assuming one driver per storage class — the
        overwhelmingly common deployment shape, and what the class's
        provisioner field implies.  Mixed-driver PVs under one class
        could charge the attach count to the wrong
        `attachable-volumes-<driver>` scalar until Reserve picks the
        concrete PV (documented divergence)."""
        bound_pv = pvc.spec.volume_name or self._assumed_claim.get(key)
        if bound_pv:
            pv = self._pvs.get(bound_pv)
            if pv is None:
                return _IMPOSSIBLE, ""  # bound to a vanished volume
            sel = pv.spec.node_affinity
            if set(pv.spec.access_modes) == {"ReadWriteOnce"}:
                # multi-attach restriction: an RWO volume mounts on ONE
                # node — consumers co-locate with the current attachment
                nodes = set(self._claim_consumers.get(key, {}).values())
                if len(nodes) == 1:
                    sel = api.and_selectors(sel, _host_pin(next(iter(nodes))))
            return sel, pv.spec.driver
        if key in self._assumed_claim:  # assumed for provisioning
            return None, ""
        # Crash repair (the PV controller's syncVolume half,
        # pkg/controller/volume/persistentvolume/pv_controller.go): a
        # PV whose claimRef already points at this PVC means a prebind
        # wrote the PV side and died before the PVC write — finish the
        # PVC side and treat the pair as bound, instead of skipping the
        # PV (claimRef set) and resolving the claim IMPOSSIBLE forever.
        # O(1): the claimRef index is maintained by the PV informer.
        ref_pv = self._claimref_index.get(key)
        if ref_pv is not None:
            pv = self._pvs.get(ref_pv)
            if pv is not None:
                self._finish_half_bound(key, pvc, pv.meta.name)
                return pv.spec.node_affinity, pv.spec.driver
        # unbound: OR over eligible PVs' affinities; a PV without a node
        # affinity is mountable anywhere -> the claim is unconstrained
        candidates = self._eligible_pvs(pvc)
        sc = self._classes.get(pvc.spec.storage_class_name)
        terms: List[api.NodeSelectorTerm] = []
        unconstrained = False
        driver = ""
        for pv in candidates:
            driver = driver or pv.spec.driver
            if pv.spec.node_affinity is None:
                unconstrained = True
            else:
                terms.extend(pv.spec.node_affinity.terms)
        if sc is not None and sc.provisioner:
            driver = driver or sc.provisioner
            if sc.allowed_topologies is None:
                unconstrained = True
            else:
                terms.extend(sc.allowed_topologies.terms)
        if unconstrained:
            return None, driver
        if not terms:
            return _IMPOSSIBLE, ""  # no PV fits and nothing can provision
        return api.NodeSelector(terms=terms), driver

    def _finish_half_bound(
        self, key: str, pvc: api.PersistentVolumeClaim, pv_name: str
    ) -> None:
        """Complete the PVC side of a half-written binding (journal
        replay after a crash between prebind's two writes)."""
        try:
            fresh = self.store.get(
                "PersistentVolumeClaim", pvc.meta.name, pvc.meta.namespace
            )
            if not fresh.spec.volume_name:
                fresh.spec.volume_name = pv_name
                fresh.status.phase = api.PVC_BOUND
                self.store.update(fresh)
            # local cache: don't wait for the informer echo
            pvc.spec.volume_name = pv_name
        except Exception:
            # best-effort; the informer-driven next pass retries
            pvc.spec.volume_name = pv_name

    def _eligible_pvs(
        self, pvc: api.PersistentVolumeClaim
    ) -> List[api.PersistentVolume]:
        """Available volumes matching class, access modes, and size
        (volumebinding binder.go findMatchingVolumes)."""
        want_modes = set(pvc.spec.access_modes)
        out = []
        for pv in self._pvs.values():
            if pv.spec.claim_ref or pv.meta.name in self._assumed_pv:
                continue
            if pv.status.phase != api.PV_AVAILABLE:
                continue
            if pv.spec.storage_class_name != pvc.spec.storage_class_name:
                continue
            if not want_modes.issubset(set(pv.spec.access_modes)):
                continue
            if pv.storage() < pvc.requested_storage():
                continue
            out.append(pv)
        return out

    # -- Reserve / Unreserve / PreBind ------------------------------------

    def reserve(self, pod: api.Pod, node: api.Node) -> bool:
        """Pick concrete volumes for the pod's unbound claims on the
        chosen node and assume the bindings (Reserve,
        volume_binding.go:369).  Returns False when no eligible volume
        fits the node — the placement is rejected and the pod retries."""
        with self._mu:
            picked: List[Tuple[str, Optional[str]]] = []
            for vol in pod.spec.volumes:
                claim = vol.persistent_volume_claim
                if not claim:
                    continue
                key = f"{pod.meta.namespace}/{claim}"
                pvc = self._pvcs.get(key)
                if pvc is None:
                    self._rollback(picked)
                    return False
                if pvc.spec.volume_name or key in self._assumed_claim:
                    continue  # already bound/assumed
                pv = self._pick_pv(pvc, node)
                if pv is not None:
                    self._assumed_pv[pv.meta.name] = key
                    self._assumed_claim[key] = pv.meta.name
                    picked.append((key, pv.meta.name))
                    continue
                sc = self._classes.get(pvc.spec.storage_class_name)
                if sc is not None and sc.provisioner and (
                    sc.allowed_topologies is None
                    or _selector_matches(sc.allowed_topologies, node)
                ):
                    # dynamic provisioning deferred to PreBind
                    self._assumed_claim[key] = None
                    picked.append((key, None))
                    continue
                self._rollback(picked)
                return False
            return True

    def _pick_pv(
        self, pvc: api.PersistentVolumeClaim, node: api.Node
    ) -> Optional[api.PersistentVolume]:
        """Smallest sufficient topology-compatible volume
        (binder.go FindBestMatchVolume)."""
        best = None
        for pv in self._eligible_pvs(pvc):
            if pv.spec.node_affinity is not None and not _selector_matches(
                pv.spec.node_affinity, node
            ):
                continue
            if best is None or pv.storage() < best.storage():
                best = pv
        return best

    def unreserve(self, pod: api.Pod) -> None:
        """Roll back this pod's assumed bindings (Unreserve — bind
        failed or a later plugin rejected the placement)."""
        with self._mu:
            for vol in pod.spec.volumes:
                claim = vol.persistent_volume_claim
                if not claim:
                    continue
                key = f"{pod.meta.namespace}/{claim}"
                pv_name = self._assumed_claim.pop(key, None)
                if pv_name:
                    self._assumed_pv.pop(pv_name, None)

    def _rollback(self, picked: List[Tuple[str, Optional[str]]]) -> None:
        for key, pv_name in picked:
            self._assumed_claim.pop(key, None)
            if pv_name:
                self._assumed_pv.pop(pv_name, None)

    def prebind(self, pod: api.Pod, node_name: str) -> None:
        """Write the assumed bindings through the API (PreBind,
        volume_binding.go:248: BindPodVolumes).  Dynamic provisioning is
        satisfied in-process: the control plane provisions a PV pinned
        to the chosen node's topology (the integration-test PV
        controller's role; real clusters have an external provisioner)."""
        node = None
        for vol in pod.spec.volumes:
            claim = vol.persistent_volume_claim
            if not claim:
                continue
            key = f"{pod.meta.namespace}/{claim}"
            with self._mu:
                pv_name = self._assumed_claim.get(key)
            if key not in self._assumed_claim and pv_name is None:
                continue  # already bound earlier
            pvc = self.store.get(
                "PersistentVolumeClaim", claim, pod.meta.namespace
            )
            if pvc.spec.volume_name:
                continue
            if pv_name is None:
                if node is None:
                    node = self.store.get("Node", node_name, namespace="")
                pv = self._provision(pvc, node)
                pv_name = pv.meta.name
            pv = self.store.get("PersistentVolume", pv_name)
            pv.spec.claim_ref = key
            pv.spec.claim_uid = pvc.meta.uid
            pv.status.phase = api.PV_BOUND
            self.store.update(pv)
            pvc.spec.volume_name = pv_name
            pvc.status.phase = api.PVC_BOUND
            self.store.update(pvc)
            with self._mu:
                self._assumed_claim.pop(key, None)
                self._assumed_pv.pop(pv_name, None)

    def _provision(
        self, pvc: api.PersistentVolumeClaim, node: api.Node
    ) -> api.PersistentVolume:
        sc = self._classes.get(pvc.spec.storage_class_name)
        topo_val = node.meta.labels.get(api.LABEL_ZONE)
        affinity = None
        if topo_val is not None:
            affinity = api.NodeSelector(
                terms=[
                    api.NodeSelectorTerm(
                        match_expressions=[
                            api.Requirement(
                                api.LABEL_ZONE, api.OP_IN, [topo_val]
                            )
                        ]
                    )
                ]
            )
        pv = api.PersistentVolume(
            meta=api.ObjectMeta(
                name=f"pvc-{pvc.meta.namespace}-{pvc.meta.name}"
            ),
            spec=api.PersistentVolumeSpec(
                capacity={api.STORAGE: pvc.requested_storage()},
                access_modes=list(pvc.spec.access_modes),
                storage_class_name=pvc.spec.storage_class_name,
                node_affinity=affinity,
                driver=sc.provisioner if sc else "",
            ),
        )
        self.store.create(pv)
        return pv


def _selector_matches(sel: api.NodeSelector, node: api.Node) -> bool:
    """Host-side OR-of-AND selector evaluation against one node."""
    return sel.matches(node.meta.labels)
