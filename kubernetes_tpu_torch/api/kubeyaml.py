"""Kubernetes JSON/YAML objects -> api.types, for the wire surfaces.

A copy of the reference package's api/kubeyaml.py: the scheduler_perf
harness's pod and node converters, the extender's wire types, and
`CONVERTERS`, the kinds the API server's discovery document lists.
Quantities parse per apimachinery resource.Quantity suffixes (binary
Ki..Ei, decimal k..E, milli): cpu normalizes to millicores, everything
else to base units (bytes for memory).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from . import types as api

_BINARY = {"Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50, "Ei": 2**60}
_DECIMAL = {"k": 10**3, "M": 10**6, "G": 10**9, "T": 10**12, "P": 10**15, "E": 10**18}


def parse_quantity(v: Any, *, cpu: bool = False) -> int:
    """'500m' → 500 (cpu) / 0.5 (non-cpu, rounded); '512Mi' → bytes;
    bare ints pass through (cpu ints are CORES in k8s — scaled to milli)."""
    if isinstance(v, (int, float)):
        return int(v * 1000) if cpu else int(v)
    s = str(v).strip()
    if s.endswith("m"):
        n = float(s[:-1])
        return int(n) if cpu else int(n / 1000)
    for suf, mult in _BINARY.items():
        if s.endswith(suf):
            base = float(s[: -len(suf)]) * mult
            return int(base * 1000) if cpu else int(base)
    for suf, mult in _DECIMAL.items():
        if s.endswith(suf):
            base = float(s[: -len(suf)]) * mult
            return int(base * 1000) if cpu else int(base)
    return int(float(s) * 1000) if cpu else int(float(s))


def _requests(d: Dict[str, Any]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for k, v in (d or {}).items():
        out[k] = parse_quantity(v, cpu=(k == api.CPU))
    return out


def _label_selector(d: Optional[Dict[str, Any]]) -> Optional[api.LabelSelector]:
    if d is None:
        return None
    exprs = [
        api.Requirement(
            key=e["key"], op=e["operator"], values=list(e.get("values") or [])
        )
        for e in d.get("matchExpressions") or []
    ]
    return api.LabelSelector(
        match_labels=dict(d.get("matchLabels") or {}), match_expressions=exprs
    )


def _node_selector_term(d: Dict[str, Any]) -> api.NodeSelectorTerm:
    exprs = [
        api.Requirement(
            key=e["key"], op=e["operator"], values=list(e.get("values") or [])
        )
        for e in d.get("matchExpressions") or []
    ]
    return api.NodeSelectorTerm(match_expressions=exprs)


def _pod_affinity_term(d: Dict[str, Any]) -> api.PodAffinityTerm:
    return api.PodAffinityTerm(
        label_selector=_label_selector(d.get("labelSelector")),
        topology_key=d.get("topologyKey", api.LABEL_HOSTNAME),
        namespaces=list(d.get("namespaces") or []),
        match_label_keys=list(d.get("matchLabelKeys") or []),
    )


def _affinity(d: Optional[Dict[str, Any]]) -> Optional[api.Affinity]:
    if not d:
        return None
    aff = api.Affinity()
    na = d.get("nodeAffinity")
    if na:
        node_aff = api.NodeAffinity()
        req = na.get("requiredDuringSchedulingIgnoredDuringExecution")
        if req:
            node_aff.required = api.NodeSelector(
                terms=[_node_selector_term(t) for t in req.get("nodeSelectorTerms") or []]
            )
        for p in na.get("preferredDuringSchedulingIgnoredDuringExecution") or []:
            node_aff.preferred.append(
                api.PreferredSchedulingTerm(
                    weight=int(p.get("weight", 1)),
                    preference=_node_selector_term(p.get("preference") or {}),
                )
            )
        aff.node_affinity = node_aff
    for src, cls, attr in (
        ("podAffinity", api.PodAffinity, "pod_affinity"),
        ("podAntiAffinity", api.PodAntiAffinity, "pod_anti_affinity"),
    ):
        pa = d.get(src)
        if pa:
            obj = cls()
            for t in pa.get("requiredDuringSchedulingIgnoredDuringExecution") or []:
                obj.required.append(_pod_affinity_term(t))
            for p in pa.get("preferredDuringSchedulingIgnoredDuringExecution") or []:
                obj.preferred.append(
                    api.WeightedPodAffinityTerm(
                        weight=int(p.get("weight", 1)),
                        term=_pod_affinity_term(p.get("podAffinityTerm") or {}),
                    )
                )
            setattr(aff, attr, obj)
    return aff


def _probe(d: Optional[Dict[str, Any]]) -> Optional[api.Probe]:
    """core/v1 Probe timing fields (the action — exec/httpGet/tcpSocket —
    is carried out by the node agent's hollow runtime)."""
    if not d:
        return None
    return api.Probe(
        initial_delay_seconds=float(d.get("initialDelaySeconds", 0)),
        period_seconds=float(d.get("periodSeconds", 1)),
        failure_threshold=int(d.get("failureThreshold", 3)),
        success_threshold=int(d.get("successThreshold", 1)),
        timeout_seconds=float(d.get("timeoutSeconds", 1)),
    )


def pod_from_dict(d: Dict[str, Any]) -> api.Pod:
    meta = d.get("metadata") or {}
    spec = d.get("spec") or {}
    pod = api.Pod(
        meta=api.ObjectMeta(
            name=meta.get("name", ""),
            namespace=meta.get("namespace", "default"),
            labels=dict(meta.get("labels") or {}),
        )
    )
    containers: List[api.Container] = []
    for c in spec.get("containers") or []:
        cont = api.Container(
            name=c.get("name", "c"),
            image=c.get("image", ""),
            requests=_requests((c.get("resources") or {}).get("requests")),
            limits=_requests((c.get("resources") or {}).get("limits")),
        )
        cont.readiness_probe = _probe(c.get("readinessProbe"))
        cont.liveness_probe = _probe(c.get("livenessProbe"))
        cont.startup_probe = _probe(c.get("startupProbe"))
        for p in c.get("ports") or []:
            cont.ports.append(
                api.ContainerPort(
                    name=p.get("name", ""),
                    container_port=int(p.get("containerPort", 0)),
                    host_port=int(p.get("hostPort", 0)),
                    protocol=p.get("protocol", "TCP"),
                    host_ip=p.get("hostIP", ""),
                )
            )
        containers.append(cont)
    pod.spec.containers = containers or [api.Container()]
    pod.spec.node_name = spec.get("nodeName", "")
    pod.spec.node_selector = dict(spec.get("nodeSelector") or {})
    pod.spec.affinity = _affinity(spec.get("affinity"))
    pod.spec.priority = int(spec.get("priority", 0))
    if spec.get("preemptionPolicy"):
        pod.spec.preemption_policy = spec["preemptionPolicy"]
    if spec.get("schedulerName"):
        pod.spec.scheduler_name = spec["schedulerName"]
    pod.spec.scheduling_gates = [
        g["name"] for g in spec.get("schedulingGates") or []
    ]
    for t in spec.get("tolerations") or []:
        pod.spec.tolerations.append(
            api.Toleration(
                key=t.get("key", ""),
                op=t.get("operator", "Equal"),
                value=t.get("value", ""),
                effect=t.get("effect", ""),
            )
        )
    for c in spec.get("topologySpreadConstraints") or []:
        pod.spec.topology_spread_constraints.append(
            api.TopologySpreadConstraint(
                max_skew=int(c.get("maxSkew", 1)),
                topology_key=c.get("topologyKey", api.LABEL_ZONE),
                when_unsatisfiable=c.get("whenUnsatisfiable", "DoNotSchedule"),
                label_selector=_label_selector(c.get("labelSelector")),
                min_domains=c.get("minDomains"),
                match_label_keys=list(c.get("matchLabelKeys") or []),
            )
        )
    for v in spec.get("volumes") or []:
        pvc = (v.get("persistentVolumeClaim") or {}).get("claimName")
        if pvc:
            pod.spec.volumes.append(
                api.Volume(name=v.get("name", ""), persistent_volume_claim=pvc)
            )
    pod.spec.resource_claims = [
        rc.get("resourceClaimName") or rc.get("name", "")
        for rc in spec.get("resourceClaims") or []
    ]
    return pod


def node_from_dict(d: Dict[str, Any]) -> api.Node:
    meta = d.get("metadata") or {}
    spec = d.get("spec") or {}
    status = d.get("status") or {}
    node = api.Node(
        meta=api.ObjectMeta(
            name=meta.get("name", ""),
            namespace="",
            labels=dict(meta.get("labels") or {}),
        )
    )
    node.meta.labels.setdefault(api.LABEL_HOSTNAME, node.meta.name)
    alloc = status.get("allocatable") or status.get("capacity") or {}
    node.status.allocatable = {
        k: parse_quantity(v, cpu=(k == api.CPU)) for k, v in alloc.items()
    }
    node.status.capacity = dict(node.status.allocatable)
    node.spec.unschedulable = bool(spec.get("unschedulable", False))
    for t in spec.get("taints") or []:
        node.spec.taints.append(
            api.Taint(
                key=t.get("key", ""),
                value=t.get("value", ""),
                effect=t.get("effect", api.NO_SCHEDULE),
            )
        )
    return node


def _pod_template_from_dict(d: Dict[str, Any]) -> api.PodTemplateSpec:
    meta = d.get("metadata") or {}
    pod = pod_from_dict({"spec": d.get("spec") or {}})
    return api.PodTemplateSpec(
        meta=api.ObjectMeta(name="", labels=dict(meta.get("labels") or {})),
        spec=pod.spec,
    )


def deployment_from_dict(d: Dict[str, Any]) -> api.Deployment:
    meta = d.get("metadata") or {}
    spec = d.get("spec") or {}
    return api.Deployment(
        meta=api.ObjectMeta(
            name=meta.get("name", ""),
            namespace=meta.get("namespace", "default"),
            labels=dict(meta.get("labels") or {}),
        ),
        spec=api.DeploymentSpec(
            replicas=int(spec.get("replicas", 1)),
            selector=_label_selector(spec.get("selector")) or api.LabelSelector(),
            template=_pod_template_from_dict(spec.get("template") or {}),
        ),
    )


def _job_spec_from_dict(spec: Dict[str, Any]) -> api.JobSpec:
    return api.JobSpec(
        parallelism=int(spec.get("parallelism", 1)),
        completions=(
            int(spec["completions"]) if "completions" in spec else 1
        ),
        template=_pod_template_from_dict(spec.get("template") or {}),
        backoff_limit=int(spec.get("backoffLimit", 6)),
    )


def job_from_dict(d: Dict[str, Any]) -> api.Job:
    meta = d.get("metadata") or {}
    return api.Job(
        meta=api.ObjectMeta(
            name=meta.get("name", ""),
            namespace=meta.get("namespace", "default"),
            labels=dict(meta.get("labels") or {}),
        ),
        spec=_job_spec_from_dict(d.get("spec") or {}),
    )


def _meta_from_dict(d: Dict[str, Any], namespace="default") -> api.ObjectMeta:
    meta = d.get("metadata") or {}
    return api.ObjectMeta(
        name=meta.get("name", ""),
        namespace=meta.get("namespace", namespace),
        labels=dict(meta.get("labels") or {}),
        annotations=dict(meta.get("annotations") or {}),
    )


def statefulset_from_dict(d: Dict[str, Any]) -> api.StatefulSet:
    spec = d.get("spec") or {}
    return api.StatefulSet(
        meta=_meta_from_dict(d),
        spec=api.StatefulSetSpec(
            replicas=int(spec.get("replicas", 1)),
            selector=_label_selector(spec.get("selector")) or api.LabelSelector(),
            template=_pod_template_from_dict(spec.get("template") or {}),
            service_name=spec.get("serviceName", ""),
            pod_management_policy=spec.get("podManagementPolicy", "OrderedReady"),
            volume_claim_templates=[
                pvc_from_dict(t) for t in spec.get("volumeClaimTemplates") or []
            ],
        ),
    )


def daemonset_from_dict(d: Dict[str, Any]) -> api.DaemonSet:
    spec = d.get("spec") or {}
    return api.DaemonSet(
        meta=_meta_from_dict(d),
        spec=api.DaemonSetSpec(
            selector=_label_selector(spec.get("selector")) or api.LabelSelector(),
            template=_pod_template_from_dict(spec.get("template") or {}),
        ),
    )


def cronjob_from_dict(d: Dict[str, Any]) -> api.CronJob:
    spec = d.get("spec") or {}
    job_tpl = (spec.get("jobTemplate") or {}).get("spec") or {}
    return api.CronJob(
        meta=_meta_from_dict(d),
        spec=api.CronJobSpec(
            schedule=spec.get("schedule", "* * * * *"),
            suspend=bool(spec.get("suspend", False)),
            concurrency_policy=spec.get("concurrencyPolicy", "Allow"),
            starting_deadline_seconds=(
                float(spec["startingDeadlineSeconds"])
                if "startingDeadlineSeconds" in spec else None
            ),
            job_template=_job_spec_from_dict(job_tpl),
        ),
    )


def pvc_from_dict(d: Dict[str, Any]) -> api.PersistentVolumeClaim:
    spec = d.get("spec") or {}
    storage = parse_quantity(
        ((spec.get("resources") or {}).get("requests") or {}).get("storage", 0)
    )
    return api.PersistentVolumeClaim(
        meta=_meta_from_dict(d),
        spec=api.PersistentVolumeClaimSpec(
            access_modes=list(spec.get("accessModes") or []),
            storage_class_name=spec.get("storageClassName", ""),
            resources={api.STORAGE: storage} if storage else {},
            volume_name=spec.get("volumeName", ""),
        ),
    )


def pv_from_dict(d: Dict[str, Any]) -> api.PersistentVolume:
    spec = d.get("spec") or {}
    affinity = None
    na = (spec.get("nodeAffinity") or {}).get("required")
    if na:
        affinity = api.NodeSelector(
            terms=[
                _node_selector_term(t)
                for t in na.get("nodeSelectorTerms") or []
            ]
        )
    storage = parse_quantity((spec.get("capacity") or {}).get("storage", 0))
    csi = spec.get("csi") or {}
    return api.PersistentVolume(
        meta=_meta_from_dict(d, namespace=""),
        spec=api.PersistentVolumeSpec(
            capacity={api.STORAGE: storage} if storage else {},
            access_modes=list(spec.get("accessModes") or []),
            storage_class_name=spec.get("storageClassName", ""),
            node_affinity=affinity,
            driver=csi.get("driver", ""),
            reclaim_policy=spec.get(
                "persistentVolumeReclaimPolicy", "Retain"
            ),
        ),
    )


def storageclass_from_dict(d: Dict[str, Any]) -> api.StorageClass:
    topo = None
    allowed = d.get("allowedTopologies")
    if allowed:
        terms = []
        for entry in allowed:
            exprs = [
                api.Requirement(
                    e.get("key", ""), api.OP_IN, list(e.get("values") or [])
                )
                for e in entry.get("matchLabelExpressions") or []
            ]
            terms.append(api.NodeSelectorTerm(match_expressions=exprs))
        topo = api.NodeSelector(terms=terms)
    return api.StorageClass(
        meta=_meta_from_dict(d, namespace=""),
        provisioner=d.get("provisioner", ""),
        volume_binding_mode=d.get("volumeBindingMode", api.VOLUME_BINDING_IMMEDIATE),
        allowed_topologies=topo,
    )


def pdb_from_dict(d: Dict[str, Any]) -> api.PodDisruptionBudget:
    spec = d.get("spec") or {}
    return api.PodDisruptionBudget(
        meta=_meta_from_dict(d),
        spec=api.PodDisruptionBudgetSpec(
            selector=_label_selector(spec.get("selector")),
            min_available=(
                int(spec["minAvailable"]) if "minAvailable" in spec else None
            ),
            max_unavailable=(
                int(spec["maxUnavailable"])
                if "maxUnavailable" in spec else None
            ),
        ),
    )


def namespace_from_dict(d: Dict[str, Any]) -> api.Namespace:
    return api.Namespace(meta=_meta_from_dict(d, namespace=""))


def resourceclaim_from_dict(d: Dict[str, Any]) -> api.ResourceClaim:
    spec = d.get("spec") or {}
    return api.ResourceClaim(
        meta=_meta_from_dict(d),
        spec=api.ResourceClaimSpec(
            device_class_name=spec.get("deviceClassName", ""),
            count=int(spec.get("count", 1)),
        ),
    )


def deviceclass_from_dict(d: Dict[str, Any]) -> api.DeviceClass:
    return api.DeviceClass(
        meta=_meta_from_dict(d, namespace=""),
        driver=(d.get("spec") or {}).get("driver", d.get("driver", "")),
    )


# kind -> converter, the CLI's `create -f` dispatch table
def service_from_dict(d: Dict[str, Any]) -> api.Service:
    """core/v1 Service (types.go:5517): selector + ports + clusterIP."""
    spec = d.get("spec") or {}
    ports = []
    for p in spec.get("ports") or []:
        tp = p.get("targetPort", 0)
        ports.append(
            api.ServicePort(
                name=p.get("name", ""),
                protocol=p.get("protocol", "TCP"),
                port=int(p.get("port", 0)),
                target_port=int(tp) if isinstance(tp, int) else 0,
                target_port_name=tp if isinstance(tp, str) else "",
                node_port=int(p.get("nodePort", 0)),
            )
        )
    return api.Service(
        meta=_meta_from_dict(d),
        spec=api.ServiceSpec(
            selector=dict(spec.get("selector") or {}),
            ports=ports,
            cluster_ip=spec.get("clusterIP", ""),
            type=spec.get("type", "ClusterIP"),
            external_name=spec.get("externalName", ""),
            session_affinity=spec.get("sessionAffinity", "None"),
            publish_not_ready_addresses=bool(
                spec.get("publishNotReadyAddresses", False)
            ),
        ),
    )


def configmap_from_dict(d: Dict[str, Any]) -> api.ConfigMap:
    return api.ConfigMap(
        meta=_meta_from_dict(d),
        data={k: str(v) for k, v in (d.get("data") or {}).items()},
        binary_data=dict(d.get("binaryData") or {}),
        immutable=bool(d.get("immutable", False)),
    )


def secret_from_dict(d: Dict[str, Any]) -> api.Secret:
    return api.Secret(
        meta=_meta_from_dict(d),
        type=d.get("type", "Opaque"),
        data=dict(d.get("data") or {}),
        string_data={
            k: str(v) for k, v in (d.get("stringData") or {}).items()
        },
        immutable=bool(d.get("immutable", False)),
    )


CONVERTERS = {
    "Service": service_from_dict,
    "ConfigMap": configmap_from_dict,
    "Secret": secret_from_dict,
    "Node": node_from_dict,
    "Pod": pod_from_dict,
    "Deployment": deployment_from_dict,
    "Job": job_from_dict,
    "StatefulSet": statefulset_from_dict,
    "DaemonSet": daemonset_from_dict,
    "CronJob": cronjob_from_dict,
    "PersistentVolume": pv_from_dict,
    "PersistentVolumeClaim": pvc_from_dict,
    "StorageClass": storageclass_from_dict,
    "PodDisruptionBudget": pdb_from_dict,
    "Namespace": namespace_from_dict,
    "ResourceClaim": resourceclaim_from_dict,
    "DeviceClass": deviceclass_from_dict,
}
