"""The scheduler-extender HTTP endpoint over the port's solver: a stock
kube-scheduler configured with this extender delegates Filter and
Prioritize (and optionally Bind) to `evaluate_single` on the card
(pkg/scheduler/extender.go:86-455; wire types in .types).  A copy of the
reference package's extender/server.py with TorchBatchScheduler in place
of its scheduler.

Verbs (HTTP POST, JSON bodies; paths are configured on the kube side via
KubeSchedulerConfiguration extenders[].{filterVerb,prioritizeVerb,...}):

  /filter      ExtenderArgs -> ExtenderFilterResult
  /prioritize  ExtenderArgs -> HostPriorityList
  /bind        ExtenderBindingArgs -> ExtenderBindingResult
  /preemption  ExtenderPreemptionArgs -> ExtenderPreemptionResult
  /healthz, /readyz  GET liveness/readiness

nodeCacheCapable=true is the intended mode: the request ships node NAMES
only and the extender evaluates against its own incremental ClusterState
(fed by add_node/remove_node, or by sync_store() from an API store).
Non-cache mode (full Node objects in the request) is also accepted: nodes
are upserted into the state before evaluating.

The store is duck-typed: the backend calls only `list(kind)` (returning
(items, resource_version)), `get(kind, name, namespace)` and
`update(obj)`, so any store with those methods serves.

Every request encodes the live state on the host (the reference's
build_from_state), copies the snapshot to the scheduler's device and runs
`ops.assign.evaluate_single` there: kernels class_statics (the cold
statics prep, one launch) and evaluate_single (one launch; with an extra
row its two stages, with
class_extras between them for a pod with preferred inter-pod terms or a
known image).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from ..api import types as api
from ..models.batch_scheduler import TorchBatchScheduler
from ..ops import assign as assign_ops
from ..ops import device as device_ops
from . import types as wire


class ExtenderBackend:
    """The verb implementations, HTTP-free (tests drive this directly).
    tpu: the TorchBatchScheduler whose state and device the verbs use
    (default: a new one on the card)."""

    def __init__(
        self,
        tpu: Optional[TorchBatchScheduler] = None,
        store=None,
        lock: Optional[threading.RLock] = None,
    ):
        self.tpu = tpu or TorchBatchScheduler()
        self.store = store
        self.lock = lock or threading.RLock()

    # -- node inventory ----------------------------------------------------

    def add_node(self, node: api.Node) -> None:
        with self.lock:
            self.tpu.state.add_node(node)

    def remove_node(self, name: str) -> None:
        with self.lock:
            self.tpu.state.remove_node(name)

    def sync_store(self, store) -> None:
        """Feed the state from an API store's current nodes + bound pods
        (one-shot)."""
        self.store = store
        with self.lock:
            nodes, _ = store.list("Node")
            for n in nodes:
                self.tpu.state.add_node(n)
            pods, _ = store.list("Pod")
            for p in pods:
                if p.spec.node_name and not self.tpu.state.has_pod(p):
                    self.tpu.state.add_pod(p)

    # -- verbs -------------------------------------------------------------

    def _evaluate(
        self, pod: api.Pod
    ) -> Tuple[Dict[str, bool], Dict[str, float]]:
        """(feasible-by-node-name, score-by-node-name) over live state."""
        with self.lock:
            snap, meta = self.tpu.builder.build_from_state(
                self.tpu.state, [pod]
            )
            # the statics are derived while the snapshot is host numpy
            features = assign_ops.features_of(snap)
            topo_z = (assign_ops.required_topo_z(snap)
                      if assign_ops.needs_topo(features) else 1)
            dsnap = device_ops.to_device(snap, self.tpu.device)
            feas, scores = assign_ops.evaluate_single(
                dsnap, topo_z=topo_z, features=features)
            feas = feas.cpu().numpy()
            scores = scores.cpu().numpy()
            names = meta.node_names
        out_f: Dict[str, bool] = {}
        out_s: Dict[str, float] = {}
        for row, name in enumerate(names):
            if name is None:
                continue
            out_f[name] = bool(feas[row])
            out_s[name] = float(scores[row]) if feas[row] else 0.0
        return out_f, out_s

    def _candidates(self, args: wire.ExtenderArgs) -> List[str]:
        """Candidate node names; non-cache mode also upserts the shipped
        Node objects so both verbs work without a pre-fed inventory."""
        if args.nodes is not None:
            with self.lock:
                for n in args.nodes:
                    self.tpu.state.add_node(n)
            return [n.meta.name for n in args.nodes]
        return args.node_names or []

    def filter(self, args: wire.ExtenderArgs) -> dict:
        try:
            candidates = self._candidates(args)
            feas, _ = self._evaluate(args.pod)
            passed = [n for n in candidates if feas.get(n)]
            failed = {
                n: "node infeasible for pod (TPU batch filter)"
                for n in candidates
                if not feas.get(n)
            }
            if args.raw_nodes is not None:
                # non-cache callers read Nodes.items, not NodeNames
                passed_set = set(passed)
                items = [
                    d for d in args.raw_nodes
                    if (d.get("metadata") or {}).get("name") in passed_set
                ]
                return wire.filter_result(
                    node_names=passed, nodes=items, failed=failed
                )
            return wire.filter_result(node_names=passed, failed=failed)
        except Exception as e:  # wire errors, never tracebacks
            return wire.filter_result(node_names=[], error=str(e))

    def prioritize(self, args: wire.ExtenderArgs) -> List[dict]:
        try:
            candidates = self._candidates(args)
            _, scores = self._evaluate(args.pod)
        except Exception:
            # HostPriorityList has no Error field (types.go:125); a zeroed
            # list keeps the scheduling cycle alive
            return wire.host_priority_list({})
        vals = [scores.get(n, 0.0) for n in candidates]
        hi = max(vals) if vals else 0.0
        out: Dict[str, int] = {}
        for n, v in zip(candidates, vals):
            # scale into [0, MaxExtenderPriority]; the scheduler rescales
            # by weight * MaxNodeScore / MaxExtenderPriority
            # (schedule_one.go:827)
            out[n] = (
                int(round(v * wire.MAX_EXTENDER_PRIORITY / hi)) if hi > 0 else 0
            )
        return wire.host_priority_list(out)

    def bind(self, body: dict) -> dict:
        if self.store is None:
            return wire.binding_result("extender has no API store to bind through")
        name = body.get("PodName", "")
        namespace = body.get("PodNamespace", "default")
        node = body.get("Node", "")
        try:
            pod = self.store.get("Pod", name, namespace)
            pod.spec.node_name = node
            pod.status.phase = "Running"
            self.store.update(pod)
            # account the placement in the extender's own state so later
            # filters see the consumed capacity (sync_store is one-shot)
            with self.lock:
                if not self.tpu.state.has_pod(pod):
                    self.tpu.state.add_pod(pod, node)
            return wire.binding_result()
        except Exception as e:
            return wire.binding_result(str(e))

    def preemption(self, body: dict) -> dict:
        """ProcessPreemption: the scheduler proposes victims; an extender
        may veto or shrink the sets.  The proposal is accepted unchanged."""
        victims = body.get("NodeNameToMetaVictims") or {}
        return {"NodeNameToMetaVictims": victims}


class _Handler(BaseHTTPRequestHandler):
    backend: ExtenderBackend  # set by ExtenderServer

    def log_message(self, fmt, *args):  # quiet
        pass

    def _reply(self, obj, code=200) -> None:
        data = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self) -> None:
        if self.path in ("/healthz", "/readyz", "/livez"):
            self._reply({"ok": True})
        else:
            self._reply({"error": f"unknown path {self.path}"}, 404)

    def do_POST(self) -> None:
        length = int(self.headers.get("Content-Length", 0))
        try:
            body = json.loads(self.rfile.read(length) or b"{}")
        except json.JSONDecodeError as e:
            self._reply({"Error": f"bad JSON: {e}"}, 400)
            return
        be = self.backend
        if self.path == "/filter":
            self._reply(be.filter(wire.ExtenderArgs.from_dict(body)))
        elif self.path == "/prioritize":
            self._reply(be.prioritize(wire.ExtenderArgs.from_dict(body)))
        elif self.path == "/bind":
            self._reply(be.bind(body))
        elif self.path == "/preemption":
            self._reply(be.preemption(body))
        else:
            self._reply({"Error": f"unknown verb {self.path}"}, 404)


class ExtenderServer:
    """Threaded HTTP server around an ExtenderBackend."""

    def __init__(self, backend: Optional[ExtenderBackend] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.backend = backend or ExtenderBackend()
        handler = type("BoundHandler", (_Handler,), {"backend": self.backend})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> "ExtenderServer":
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name="extender", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
