"""scheduler_perf workload config loader: a copy of
kubernetes_tpu/perf/workload.py that reads JSON.

Accepts the reference's performance-config schema verbatim
(test/integration/scheduler_perf/scheduler_perf.go:66-78; config format
in config/performance-config.json, the upstream YAML's documents as
JSON): a list of test cases, each with a workloadTemplate (ordered
opcodes) and named workloads supplying params.  `$param` strings and
`countParam` references resolve against the workload's params at
expansion time.

Opcodes implemented (of scheduler_perf.go's ten): createNodes,
createNamespaces, createPods, churn, barrier, sleep — the set the
non-DRA/PV cases use.  Unknown opcodes raise (silent skips would turn a
coverage gap into a fake pass).

Documents are read with `json`; a path ending in .yaml or .yml is read
with PyYAML, imported only then (the shipped config and its templates
are JSON, so the card path needs no PyYAML; without it a YAML path
raises ImportError).  Template paths resolve relative to the config
file; templates are Kubernetes objects parsed by api/kubeyaml.py.
`$index` appearing in template metadata/label string values is
substituted with the object's creation index (how the shipped configs
express per-node zones; reference configs without it are unaffected).
"""

from __future__ import annotations

import copy
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class Op:
    opcode: str
    count: int = 0
    namespace: Optional[str] = None
    prefix: str = ""
    collect_metrics: bool = False
    pod_template: Optional[dict] = None
    node_template: Optional[dict] = None
    # churn
    mode: str = "recreate"
    number: int = 1
    interval_ms: int = 500
    templates: List[dict] = field(default_factory=list)
    # sleep
    duration_s: float = 0.0
    # barrier
    wait_for_pods_scheduled: bool = True


@dataclass
class Workload:
    case_name: str
    name: str
    labels: List[str]
    ops: List[Op]

    @property
    def full_name(self) -> str:
        return f"{self.case_name}/{self.name}"


def _resolve(value: Any, params: Dict[str, Any]) -> Any:
    if isinstance(value, str) and value.startswith("$"):
        key = value[1:]
        if key not in params:
            raise KeyError(f"workload param {value} not supplied")
        return params[key]
    return value


def _load_template(path: Optional[str], base_dir: str) -> Optional[dict]:
    if not path:
        return None
    full = path if os.path.isabs(path) else os.path.join(base_dir, path)
    # reference configs reference templates under "config/"; ours live
    # next to the config file — try both
    if not os.path.exists(full):
        alt = os.path.join(base_dir, os.path.basename(path))
        if os.path.exists(alt):
            full = alt
    return _read_document(full)


def _read_document(path: str) -> Any:
    """One JSON document; a .yaml / .yml path through PyYAML."""
    with open(path) as f:
        if path.endswith((".yaml", ".yml")):
            import yaml

            return yaml.safe_load(f)
        return json.load(f)


def _parse_duration(v: Any) -> float:
    """Go-style duration strings ('5s', '100ms', '1m') or numbers."""
    if isinstance(v, (int, float)):
        return float(v)
    s = str(v).strip()
    for suf, mult in (("ms", 0.001), ("s", 1.0), ("m", 60.0), ("h", 3600.0)):
        if s.endswith(suf):
            return float(s[: -len(suf)]) * mult
    return float(s)


def _expand_op(
    raw: Dict[str, Any], params: Dict[str, Any], base_dir: str, default_pod: Optional[dict]
) -> Op:
    opcode = raw.get("opcode")
    if opcode == "createNodes":
        count = int(_resolve(raw.get("countParam", raw.get("count", 0)), params))
        return Op(
            opcode=opcode,
            count=count,
            node_template=_load_template(raw.get("nodeTemplatePath"), base_dir),
        )
    if opcode == "createNamespaces":
        return Op(
            opcode=opcode,
            count=int(_resolve(raw.get("countParam", raw.get("count", 0)), params)),
            prefix=raw.get("prefix", "ns"),
        )
    if opcode == "createPods":
        return Op(
            opcode=opcode,
            count=int(_resolve(raw.get("countParam", raw.get("count", 0)), params)),
            namespace=raw.get("namespace"),
            collect_metrics=bool(raw.get("collectMetrics", False)),
            pod_template=_load_template(raw.get("podTemplatePath"), base_dir)
            or default_pod,
        )
    if opcode == "churn":
        templates = [
            _load_template(p, base_dir) for p in raw.get("templatePaths") or []
        ]
        return Op(
            opcode=opcode,
            mode=raw.get("mode", "recreate"),
            number=int(_resolve(raw.get("numberParam", raw.get("number", 1)), params)),
            interval_ms=int(raw.get("intervalMilliseconds", 500)),
            namespace=raw.get("namespace"),
            templates=[t for t in templates if t],
        )
    if opcode == "barrier":
        return Op(opcode=opcode, namespace=raw.get("namespace"))
    if opcode == "sleep":
        return Op(opcode=opcode, duration_s=_parse_duration(raw.get("duration", 0)))
    raise ValueError(f"unsupported opcode {opcode!r} (scheduler_perf.go:66-78)")


def load_config(path: str) -> List[Workload]:
    """Parse a performance-config document into expanded workloads."""
    base_dir = os.path.dirname(os.path.abspath(path))
    cases = _read_document(path)
    out: List[Workload] = []
    for case in cases:
        default_pod = _load_template(case.get("defaultPodTemplatePath"), base_dir)
        template = case.get("workloadTemplate") or []
        for wl in case.get("workloads") or []:
            params = dict(wl.get("params") or {})
            ops = [
                _expand_op(copy.deepcopy(op), params, base_dir, default_pod)
                for op in template
            ]
            out.append(
                Workload(
                    case_name=case["name"],
                    name=wl["name"],
                    labels=list(wl.get("labels") or []),
                    ops=ops,
                )
            )
    return out


def select(
    workloads: List[Workload], label: Optional[str] = None, name: Optional[str] = None
) -> List[Workload]:
    picked = workloads
    if label:
        picked = [w for w in picked if label in w.labels]
    if name:
        picked = [w for w in picked if name in w.full_name]
    return picked
