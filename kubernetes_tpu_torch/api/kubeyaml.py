"""Kubernetes JSON/YAML objects -> api.types, for the wire surfaces.

A copy of the reference package's api/kubeyaml.py, cut to the two
converters the extender's wire types read (`pod_from_dict`,
`node_from_dict`) and what they call.  Quantities parse per
apimachinery resource.Quantity suffixes (binary Ki..Ei, decimal k..E,
milli): cpu normalizes to millicores, everything else to base units
(bytes for memory).
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
