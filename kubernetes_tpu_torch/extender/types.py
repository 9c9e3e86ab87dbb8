"""kube-scheduler extender v1 wire types.

JSON shapes match staging/src/k8s.io/kube-scheduler/extender/v1/types.go:73-132
byte-for-byte at the key level: the Go structs carry no json tags, so
encoding/json uses the exported field names verbatim ("Pod", "NodeNames",
"FailedNodes", "Error", "Host", "Score", ...).  A stock kube-scheduler
configured with this extender POSTs exactly these documents
(pkg/scheduler/extender.go:86-455, send() at :397).

Pods arrive as v1.Pod JSON and are decoded through api.kubeyaml; in
nodeCacheCapable mode (extender/v1/types.go:79-81) only node NAMES cross
the wire and the solver side resolves them against its own cluster state.
A copy of the reference package's extender/types.py.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..api import kubeyaml
from ..api import types as api


class ExtenderArgs:
    """extender/v1/types.go:73 — filter/prioritize request."""

    def __init__(
        self,
        pod: api.Pod,
        node_names: Optional[List[str]] = None,
        nodes: Optional[List[api.Node]] = None,
        raw_nodes: Optional[List[Dict[str, Any]]] = None,
    ):
        self.pod = pod
        self.node_names = node_names
        self.nodes = nodes
        # original v1.Node JSON items (non-cache mode): the RESPONSE must
        # echo passing nodes as full objects — HTTPExtender.Filter reads
        # result.Nodes.Items when nodeCacheCapable is off (extender.go)
        self.raw_nodes = raw_nodes

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExtenderArgs":
        pod = kubeyaml.pod_from_dict(d.get("Pod") or {})
        node_names = d.get("NodeNames")
        nodes = raw = None
        if d.get("Nodes") is not None:
            raw = list(d["Nodes"].get("items") or [])
            nodes = [kubeyaml.node_from_dict(item) for item in raw]
        return cls(pod, node_names, nodes, raw)


def filter_result(
    node_names: Optional[List[str]] = None,
    nodes: Optional[List[Dict[str, Any]]] = None,
    failed: Optional[Dict[str, str]] = None,
    failed_unresolvable: Optional[Dict[str, str]] = None,
    error: str = "",
) -> Dict[str, Any]:
    """ExtenderFilterResult (types.go:88).  nodeCacheCapable callers read
    NodeNames; non-cache callers read Nodes.items — populate whichever
    matches the request's shape."""
    return {
        "Nodes": {"items": nodes} if nodes is not None else None,
        "NodeNames": node_names,
        "FailedNodes": failed or {},
        "FailedAndUnresolvableNodes": failed_unresolvable or {},
        "Error": error,
    }


def host_priority_list(scores: Dict[str, int]) -> List[Dict[str, Any]]:
    """HostPriorityList (types.go:125-132)."""
    return [{"Host": h, "Score": int(s)} for h, s in scores.items()]


def binding_result(error: str = "") -> Dict[str, Any]:
    return {"Error": error}


# MaxExtenderPriority — the scheduler scales extender scores by
# weight * MaxNodeScore / MaxExtenderPriority (schedule_one.go:827)
MAX_EXTENDER_PRIORITY = 10
