"""The proto snapshot service: foreign control planes drive the port's
batch solve with dense tensors.

Where the HTTP extender (extender/server.py) speaks the reference's
per-node JSON (extender/v1/types.go), this service speaks
kubernetes_tpu_torch/proto/snapshot.proto: column-ordered matrices that
decode into the solver's object model, so a Go or C++ scheduler core can
hand off an entire batch in one round trip.  A copy of the reference
package's extender/protoserver.py with TorchBatchScheduler in place of its
scheduler: each request is one stateless `TorchBatchScheduler.schedule` on
the backend's device (the card unless the caller passes device="cpu").

Transport: protobuf messages over TCP with 4-byte big-endian length
framing (the standard protobuf stream framing).

Wire contract notes:
  * request `requested` rows describe CURRENT node usage; the backend
    accounts them as one synthetic bound pod per non-empty row, so the
    solve sees the same free vectors the caller's cache holds.
  * group_ids drive gang all-or-nothing through the solver's gang
    machinery.
"""

from __future__ import annotations

import socket
import socketserver
import struct
import threading
import time
from typing import Optional

import numpy as np

from ..api import types as api
from ..models.batch_scheduler import TorchBatchScheduler
from ..proto import snapshot_pb2 as pb

MAX_MESSAGE = 256 * 1024 * 1024


def _read_exact(rfile, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = rfile.read(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-message")
        buf += chunk
    return buf


def read_frame(rfile) -> bytes:
    (n,) = struct.unpack(">I", _read_exact(rfile, 4))
    if n > MAX_MESSAGE:
        raise ValueError(f"frame of {n} bytes exceeds {MAX_MESSAGE}")
    return _read_exact(rfile, n)


def write_frame(wfile, payload: bytes) -> None:
    wfile.write(struct.pack(">I", len(payload)) + payload)
    wfile.flush()


def _matrix(m: pb.DenseMatrix) -> np.ndarray:
    a = np.asarray(m.data, dtype=np.float32)
    if m.rows * m.cols != a.size:
        raise ValueError(
            f"matrix {m.rows}x{m.cols} carries {a.size} values"
        )
    return a.reshape(m.rows, m.cols)


class ProtoBackend:
    """Decodes SolveRequests into the solver's object model and runs
    one stateless batched solve per request on `device` (None: the
    card)."""

    def __init__(self, device=None):
        self.device = device

    def solve(self, req: pb.SolveRequest) -> pb.SolveResponse:
        t0 = time.perf_counter()
        vocab = list(req.cluster.resources.names)
        alloc = _matrix(req.cluster.allocatable)
        node_names = list(req.cluster.node_names)
        if alloc.shape[0] != len(node_names):
            raise ValueError("allocatable rows != node_names")
        used = (
            _matrix(req.cluster.requested)
            if req.cluster.requested.rows
            else None
        )
        nodes, bound = [], []
        for i, name in enumerate(node_names):
            nodes.append(
                api.Node(
                    meta=api.ObjectMeta(
                        name=name,
                        namespace="",
                        labels={api.LABEL_HOSTNAME: name},
                    ),
                    status=api.NodeStatus(
                        allocatable={
                            vocab[j]: int(alloc[i, j])
                            for j in range(len(vocab))
                            if alloc[i, j]
                        }
                    ),
                )
            )
            if used is not None and used[i].any():
                # current usage rides one synthetic bound pod per node —
                # the public accounting path, so free vectors match the
                # caller's cache exactly
                p = api.Pod(
                    meta=api.ObjectMeta(name=f"__usage-{name}"),
                    spec=api.PodSpec(
                        node_name=name,
                        containers=[
                            api.Container(
                                requests={
                                    vocab[j]: int(used[i, j])
                                    for j in range(len(vocab))
                                    if used[i, j]
                                }
                            )
                        ],
                    ),
                )
                bound.append(p)
        reqs = _matrix(req.pods.requests)
        pods = []
        for i, name in enumerate(req.pods.pod_names):
            spec = api.PodSpec(
                containers=[
                    api.Container(
                        requests={
                            vocab[j]: int(reqs[i, j])
                            for j in range(len(vocab))
                            if reqs[i, j]
                        }
                    )
                ]
            )
            if i < len(req.pods.priorities):
                spec.priority = req.pods.priorities[i]
            if i < len(req.pods.group_ids) and req.pods.group_ids[i]:
                spec.scheduling_group = req.pods.group_ids[i]
            pods.append(
                api.Pod(meta=api.ObjectMeta(name=name), spec=spec)
            )
        solver = TorchBatchScheduler(device=self.device)
        names = solver.schedule(nodes, pods, bound=bound)
        result = solver.last_result
        reasons = (
            [int(r) for r in result.reasons[: len(pods)].cpu().tolist()]
            if result is not None and result.reasons is not None
            else [-1] * len(pods)
        )
        node_index = {n: i for i, n in enumerate(node_names)}
        resp = pb.SolveResponse(solve_seconds=time.perf_counter() - t0)
        for pod, node in zip(pods, names):
            resp.assignments.add(
                pod_name=pod.meta.name,
                node_name=node or "",
                node_index=node_index.get(node, -1) if node else -1,
            )
        resp.reasons.extend(reasons)
        return resp


class _Handler(socketserver.StreamRequestHandler):
    def handle(self) -> None:
        while True:
            try:
                payload = read_frame(self.rfile)
            except (ConnectionError, struct.error):
                return
            req = pb.SolveRequest()
            req.ParseFromString(payload)
            resp = self.server.backend.solve(req)  # type: ignore[attr-defined]
            write_frame(self.wfile, resp.SerializeToString())


class ProtoSchedulerServer:
    """TCP server speaking length-framed snapshot.proto messages."""

    def __init__(
        self,
        backend: Optional[ProtoBackend] = None,
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        self.server = socketserver.ThreadingTCPServer(
            (host, port), _Handler, bind_and_activate=True
        )
        self.server.daemon_threads = True
        self.server.backend = backend or ProtoBackend()
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.server.server_address[1]

    def start(self) -> "ProtoSchedulerServer":
        self._thread = threading.Thread(
            target=self.server.serve_forever, name="proto-scheduler",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        if self._thread:
            self._thread.join(timeout=5)


def solve_over_socket(host: str, port: int, req: pb.SolveRequest) -> pb.SolveResponse:
    """Client helper: one framed round trip (what a Go/C++ client does
    with its own generated code)."""
    with socket.create_connection((host, port)) as s:
        f = s.makefile("rwb")
        write_frame(f, req.SerializeToString())
        resp = pb.SolveResponse()
        resp.ParseFromString(read_frame(f))
        return resp
