"""Builder-style test object constructors (Pod/Node subset, and the
storage objects the volume binder reads).

The equivalent of the reference's st.MakePod()/MakeNode() wrappers
(pkg/scheduler/testing/wrappers.go) — fluent builders so tests and
benchmarks construct clusters in one expression.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from ..api import types as api

MI = 1 << 20
GI = 1 << 30


class PodWrapper:
    def __init__(self, name: str, namespace: str = "default"):
        self.pod = api.Pod(meta=api.ObjectMeta(name=name, namespace=namespace))
        self.pod.spec.containers.append(api.Container(name="c0"))

    def obj(self) -> api.Pod:
        return self.pod

    def pvc(self, claim_name: str) -> "PodWrapper":
        """Mount a PVC-backed volume (core/v1 Volume.persistentVolumeClaim)."""
        self.pod.spec.volumes.append(
            api.Volume(
                name=f"vol-{len(self.pod.spec.volumes)}",
                persistent_volume_claim=claim_name,
            )
        )
        return self

    def req(self, cpu_milli: int = 0, mem: int = 0, **scalars: int) -> "PodWrapper":
        r = self.pod.spec.containers[0].requests
        if cpu_milli:
            r[api.CPU] = cpu_milli
        if mem:
            r[api.MEMORY] = mem
        r.update(scalars)
        return self

    def labels(self, **kv: str) -> "PodWrapper":
        self.pod.meta.labels.update({k.replace("_", "-"): v for k, v in kv.items()})
        return self

    def label(self, key: str, value: str) -> "PodWrapper":
        self.pod.meta.labels[key] = value
        return self

    def node_name(self, name: str) -> "PodWrapper":
        self.pod.spec.node_name = name
        return self

    def node_selector(self, **kv: str) -> "PodWrapper":
        self.pod.spec.node_selector.update(kv)
        return self

    def node_selector_kv(self, key: str, value: str) -> "PodWrapper":
        self.pod.spec.node_selector[key] = value
        return self

    def priority(self, p: int) -> "PodWrapper":
        self.pod.spec.priority = p
        return self

    def group(self, name: str, size: Optional[int] = None) -> "PodWrapper":
        """Gang/coscheduling group (PodSpec.scheduling_group); size is the
        declared member count (scheduling_group_size, PodGroup minMember)."""
        self.pod.spec.scheduling_group = name
        self.pod.spec.scheduling_group_size = size
        return self

    def toleration(
        self, key: str = "", op: str = api.OP_EXISTS, value: str = "", effect: str = ""
    ) -> "PodWrapper":
        self.pod.spec.tolerations.append(
            api.Toleration(key=key, op=op, value=value, effect=effect)
        )
        return self

    def image(self, name: str) -> "PodWrapper":
        self.pod.spec.containers[0].image = name
        return self

    def host_port(self, port: int, protocol: str = "TCP") -> "PodWrapper":
        self.pod.spec.containers[0].ports.append(
            api.ContainerPort(container_port=port, host_port=port, protocol=protocol)
        )
        return self

    def _affinity(self) -> api.Affinity:
        if self.pod.spec.affinity is None:
            self.pod.spec.affinity = api.Affinity()
        return self.pod.spec.affinity

    def _node_affinity(self) -> api.NodeAffinity:
        aff = self._affinity()
        if aff.node_affinity is None:
            aff.node_affinity = api.NodeAffinity()
        return aff.node_affinity

    def required_affinity(
        self, key: str, op: str = api.OP_IN, values: Sequence[str] = ()
    ) -> "PodWrapper":
        """Adds one requirement as its own term (new term ORs)."""
        na = self._node_affinity()
        if na.required is None:
            na.required = api.NodeSelector()
        na.required.terms.append(
            api.NodeSelectorTerm(
                match_expressions=[api.Requirement(key, op, list(values))]
            )
        )
        return self

    def preferred_affinity(
        self, weight: int, key: str, op: str = api.OP_IN, values: Sequence[str] = ()
    ) -> "PodWrapper":
        na = self._node_affinity()
        na.preferred.append(
            api.PreferredSchedulingTerm(
                weight=weight,
                preference=api.NodeSelectorTerm(
                    match_expressions=[api.Requirement(key, op, list(values))]
                ),
            )
        )
        return self

    def spread(
        self,
        max_skew: int = 1,
        topology_key: str = api.LABEL_ZONE,
        when_unsatisfiable: str = "DoNotSchedule",
        selector: Optional[Dict[str, str]] = None,
    ) -> "PodWrapper":
        self.pod.spec.topology_spread_constraints.append(
            api.TopologySpreadConstraint(
                max_skew=max_skew,
                topology_key=topology_key,
                when_unsatisfiable=when_unsatisfiable,
                label_selector=api.LabelSelector(match_labels=selector or {}),
            )
        )
        return self

    def pod_anti_affinity(
        self, selector: Dict[str, str], topology_key: str = api.LABEL_HOSTNAME
    ) -> "PodWrapper":
        aff = self._affinity()
        if aff.pod_anti_affinity is None:
            aff.pod_anti_affinity = api.PodAntiAffinity()
        aff.pod_anti_affinity.required.append(
            api.PodAffinityTerm(
                label_selector=api.LabelSelector(match_labels=selector),
                topology_key=topology_key,
            )
        )
        return self

    def pod_affinity(
        self, selector: Dict[str, str], topology_key: str = api.LABEL_HOSTNAME
    ) -> "PodWrapper":
        aff = self._affinity()
        if aff.pod_affinity is None:
            aff.pod_affinity = api.PodAffinity()
        aff.pod_affinity.required.append(
            api.PodAffinityTerm(
                label_selector=api.LabelSelector(match_labels=selector),
                topology_key=topology_key,
            )
        )
        return self


class NodeWrapper:
    def __init__(self, name: str):
        self.node = api.Node(meta=api.ObjectMeta(name=name, namespace=""))
        self.node.meta.labels[api.LABEL_HOSTNAME] = name
        self.capacity(cpu_milli=32000, mem=64 * GI, pods=110)

    def obj(self) -> api.Node:
        return self.node

    def capacity(
        self, cpu_milli: int = 0, mem: int = 0, pods: int = 0, **scalars: int
    ) -> "NodeWrapper":
        a = self.node.status.allocatable
        if cpu_milli:
            a[api.CPU] = cpu_milli
        if mem:
            a[api.MEMORY] = mem
        if pods:
            a[api.PODS] = pods
        a.update(scalars)
        self.node.status.capacity = dict(a)
        return self

    def label(self, key: str, value: str) -> "NodeWrapper":
        self.node.meta.labels[key] = value
        return self

    def zone(self, z: str) -> "NodeWrapper":
        return self.label(api.LABEL_ZONE, z)

    def taint(self, key: str, value: str = "", effect: str = api.NO_SCHEDULE) -> "NodeWrapper":
        self.node.spec.taints.append(api.Taint(key, value, effect))
        return self

    def image(self, name: str, size_bytes: int = 500 * 1024 * 1024) -> "NodeWrapper":
        self.node.status.images.append(
            api.ContainerImage(names=[name], size_bytes=size_bytes)
        )
        return self

    def unschedulable(self, flag: bool = True) -> "NodeWrapper":
        self.node.spec.unschedulable = flag
        return self


def make_pv(
    name: str,
    storage: int,
    storage_class: str = "",
    zone: Optional[str] = None,
    driver: str = "",
    access_modes: Sequence[str] = ("ReadWriteOnce",),
) -> api.PersistentVolume:
    affinity = None
    if zone is not None:
        affinity = api.NodeSelector(
            terms=[
                api.NodeSelectorTerm(
                    match_expressions=[
                        api.Requirement(api.LABEL_ZONE, api.OP_IN, [zone])
                    ]
                )
            ]
        )
    return api.PersistentVolume(
        meta=api.ObjectMeta(name=name),
        spec=api.PersistentVolumeSpec(
            capacity={api.STORAGE: storage},
            access_modes=list(access_modes),
            storage_class_name=storage_class,
            node_affinity=affinity,
            driver=driver,
        ),
    )


def make_pvc(
    name: str,
    storage: int,
    storage_class: str = "",
    namespace: str = "default",
    access_modes: Sequence[str] = ("ReadWriteOnce",),
) -> api.PersistentVolumeClaim:
    return api.PersistentVolumeClaim(
        meta=api.ObjectMeta(name=name, namespace=namespace),
        spec=api.PersistentVolumeClaimSpec(
            access_modes=list(access_modes),
            storage_class_name=storage_class,
            resources={api.STORAGE: storage},
        ),
    )


def make_storage_class(
    name: str,
    provisioner: str = "",
    mode: str = api.VOLUME_BINDING_WAIT,
    zones: Optional[Sequence[str]] = None,
) -> api.StorageClass:
    topo = None
    if zones is not None:
        topo = api.NodeSelector(
            terms=[
                api.NodeSelectorTerm(
                    match_expressions=[
                        api.Requirement(api.LABEL_ZONE, api.OP_IN, [z])
                    ]
                )
                for z in zones
            ]
        )
    return api.StorageClass(
        meta=api.ObjectMeta(name=name),
        provisioner=provisioner,
        volume_binding_mode=mode,
        allowed_topologies=topo,
    )


def make_pod(name: str, namespace: str = "default") -> PodWrapper:
    return PodWrapper(name, namespace)


def make_node(name: str) -> NodeWrapper:
    return NodeWrapper(name)


def make_nodes(
    n: int, prefix: str = "node", cpu_milli: int = 0, mem: int = 0, pods: int = 0
) -> List[api.Node]:
    out = []
    for i in range(n):
        nw = make_node(f"{prefix}-{i}")
        if cpu_milli or mem or pods:
            nw.capacity(cpu_milli=cpu_milli, mem=mem, pods=pods)
        out.append(nw.obj())
    return out
