"""TorchBatchScheduler: the batched scheduler on one CUDA card.

Owns the incremental cluster state (persistent vocabularies) and runs the
greedy batch solve (ops.assign.greedy_assign) on the device the scheduler
was built for.  The surface is the one the host scheduler and the bench
drive:

    sched = TorchBatchScheduler()                  # on "cuda"
    placements = sched.schedule(nodes, pending_pods, bound_pods)

    sched.add_node(n) / sched.remove_node(name)
    sched.assume(pod, node_name) / sched.forget(pod)
    placements = sched.schedule_pending(pending_pods)

Every batch is encoded on the host and transferred in full (no resident
mirror yet), solved by the three kernels, and read back once through
pinned host buffers and a CUDA event (DeviceSolve).  There is no host
fallback: a device fault raises to the caller.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..api import types as api
from ..ops import assign as assign_ops
from ..ops import device as device_ops
from ..ops import schema
from ..ops.scores import DEFAULT_SCORE_CONFIG, ScoreConfig


class SolveUnhealthy(RuntimeError):
    """A device solve returned a corrupt result (non-finite scores)."""


class DeviceSolve:
    """A dispatched solve held as device futures.

    The decode (device->host readback) is deferred until `names()` or
    `reasons()` is first called.  On the card the readback is already
    queued at dispatch: non-blocking copies into pinned host buffers and
    a CUDA event recorded after them, so `ready()` is the event's query
    and the decode only waits on the event."""

    def __init__(self, result: assign_ops.SolveResult, meta: schema.SnapshotMeta,
                 clock=time.perf_counter):
        self.result = result
        self.meta = meta
        self._clock = clock
        self._decoded = None
        dev = result.assignment.device
        fields = (result.assignment, result.scores, result.reasons)
        if dev.type == "cuda":
            self._host = tuple(
                torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in fields
            )
            for h, t in zip(self._host, fields):
                h.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(dev))
        else:
            self._host = fields
            self._event = None
        self.dispatched_at = clock()
        # step wall split, filled by schedule_pending_async / _decode
        self.encode_s = 0.0        # snapshot encode + host->device transfer
        self.dispatch_s = 0.0      # kernel enqueue
        self.decode_wait_s = 0.0   # time blocked on the readback
        self.deferred_s = 0.0      # dispatch -> decode-start gap (overlap)

    def ready(self) -> bool:
        """Non-blocking: has the device finished the solve and its readback?"""
        return self._event is None or bool(self._event.query())

    def _decode(self):
        if self._decoded is None:
            t0 = self._clock()
            self.deferred_s = t0 - self.dispatched_at
            if self._event is not None:
                self._event.synchronize()
            self.decode_wait_s = self._clock() - t0
            assignment, scores, reasons = (h.numpy() for h in self._host)
            # health check: a NaN score, or a placed pod whose winning score
            # is non-finite, means none of this batch's placements can be
            # trusted
            s = scores[: self.meta.num_pods]
            placed = assignment[: self.meta.num_pods] >= 0
            if np.isnan(s).any() or not np.isfinite(s[placed]).all():
                raise SolveUnhealthy("non-finite score tensor in device solve")
            self._decoded = (assignment.copy(), reasons.copy())
        return self._decoded

    def names(self) -> List[Optional[str]]:
        assignment = self._decode()[0][: self.meta.num_pods]
        return [self.meta.node_name(int(i)) for i in assignment]

    def reasons(self) -> Optional[List[int]]:
        return [int(r) for r in self._decode()[1][: self.meta.num_pods]]


class TorchBatchScheduler:
    """Owns the incremental cluster state and solves batches on `device`.

    device: None means the CUDA card; without one the constructor raises
    rather than carry on on the CPU (pass device="cpu" for the plain
    versions).  mode: "auto" or "greedy" (both route to the greedy solve
    in this port); "auction" is not ported yet and raises."""

    def __init__(
        self,
        score_config: ScoreConfig = DEFAULT_SCORE_CONFIG,
        limits: Optional[schema.SnapshotLimits] = None,
        mode: str = "auto",
        state: Optional[schema.ClusterState] = None,
        device=None,
    ):
        if mode == "auction":
            raise NotImplementedError(
                "the auction solve is not ported yet: use mode='greedy'"
            )
        if mode not in ("auto", "greedy"):
            raise ValueError(f"mode must be auto|greedy, got {mode!r}")
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchBatchScheduler: no CUDA device is available; pass "
                "device='cpu' to run the plain-torch versions on the CPU"
            )
        if state is not None:
            self.builder = state.builder
            self.state = state
        else:
            self.builder = schema.SnapshotBuilder(limits)
            self.state = schema.ClusterState(self.builder)
        self.score_config = score_config
        self.mode = mode
        self.last_result: Optional[assign_ops.SolveResult] = None
        self.last_solve: Optional[DeviceSolve] = None
        self.last_timings: Dict[str, float] = {}

    # -- incremental cluster state ---------------------------------------

    def add_node(self, node: api.Node) -> None:
        self.state.add_node(node)

    def update_node(self, node: api.Node) -> None:
        self.state.update_node(node)

    def remove_node(self, name: str) -> None:
        self.state.remove_node(name)

    def assume(self, pod: api.Pod, node_name: str) -> None:
        """Account a placement immediately (cache.go AssumePod)."""
        self.state.add_pod(pod, node_name)

    def forget(self, pod: api.Pod) -> None:
        """Undo an assume / remove a bound pod (ForgetPod/RemovePod)."""
        self.state.remove_pod(pod)

    # -- scheduling -------------------------------------------------------

    def _route(self, features: assign_ops.FeatureFlags) -> str:
        """The solve route: the greedy scan (the only route ported)."""
        return "greedy"

    def _annotate(self, snap: schema.Snapshot, meta: schema.SnapshotMeta,
                  no_bound_pods: bool = False) -> None:
        """Routing statics, derived while the snapshot is host numpy."""
        meta.features = assign_ops.features_of(snap, no_bound_pods=no_bound_pods)
        meta.topo_split = assign_ops.required_topo_z_split(snap)
        meta.n_groups = schema.num_groups(snap)
        meta.route = self._route(meta.features)

    def encode_pending(
        self,
        pending: Sequence[api.Pod],
        num_pods_hint: int = 0,
        lock=None,
        reservations: Sequence[Tuple[str, api.Pod]] = (),
    ) -> Tuple[schema.Snapshot, schema.SnapshotMeta]:
        """Encode pending pods + live cluster state and copy the snapshot to
        the device.  `lock` (the scheduler cache's mutex) is held across
        the encode and the copy: build_from_state returns views aliasing
        live arrays.  reservations: (node_name, pod) pairs whose requests
        overlay the named node's usage in THIS snapshot only."""
        with lock if lock is not None else contextlib.nullcontext():
            snap, meta = self.builder.build_from_state(
                self.state, pending, num_pods_hint=num_pods_hint
            )
            rows, reqs, nzs = [], [], []
            for node_name, pod in reservations:
                row = self.state._rows.get(node_name)
                if row is None:
                    continue  # nominated node left the cluster
                req, nz, _ = self.builder.pod_usage(pod, self.state._r)
                rows.append(row)
                reqs.append(req)
                nzs.append(nz)
            self._annotate(snap, meta, no_bound_pods=not self.state._pods)
            snap = device_ops.to_device(snap, self.device)
        if rows:
            idx = torch.tensor(rows, dtype=torch.long, device=self.device)
            cl = snap.cluster
            cluster = cl._replace(
                requested=cl.requested.index_add(
                    0, idx, torch.from_numpy(np.stack(reqs)).to(self.device)
                ),
                nonzero_requested=cl.nonzero_requested.index_add(
                    0, idx, torch.from_numpy(np.stack(nzs)).to(self.device)
                ),
            )
            snap = snap._replace(cluster=cluster)
        return snap, meta

    def _dispatch(self, snap: schema.Snapshot, meta: schema.SnapshotMeta):
        if meta.features is None:
            self._annotate(snap, meta)
        return assign_ops.greedy_assign(
            snap, self.score_config, features=meta.features,
            n_groups=meta.n_groups,
        )

    def solve_encoded_async(
        self, snap: schema.Snapshot, meta: schema.SnapshotMeta
    ) -> DeviceSolve:
        """Dispatch a prebuilt snapshot; the result stays a device future
        (DeviceSolve) read back on first names()/reasons() access."""
        result = self._dispatch(snap, meta)
        self.last_result = result
        return DeviceSolve(result, meta)

    def solve_encoded(
        self, snap: schema.Snapshot, meta: schema.SnapshotMeta
    ) -> List[Optional[str]]:
        """Dispatch a prebuilt snapshot and decode node names (blocking)."""
        return self.solve_encoded_async(snap, meta).names()

    def schedule_pending_async(
        self,
        pending: Sequence[api.Pod],
        num_pods_hint: int = 0,
        lock=None,
        reservations: Sequence[Tuple[str, api.Pod]] = (),
    ) -> Optional[DeviceSolve]:
        """Encode + dispatch one batch without blocking on the device.
        Returns None for an empty batch; finish with finalize_pending()."""
        if not pending:
            return None
        t0 = time.perf_counter()
        snap, meta = self.encode_pending(
            pending, num_pods_hint=num_pods_hint, lock=lock,
            reservations=reservations,
        )
        t1 = time.perf_counter()
        ds = self.solve_encoded_async(snap, meta)
        ds.encode_s = t1 - t0
        ds.dispatch_s = ds.dispatched_at - t1
        return ds

    def finalize_pending(
        self,
        pending: Sequence[api.Pod],
        ds: Optional[DeviceSolve],
        lock=None,
        reservations: Sequence[Tuple[str, api.Pod]] = (),
    ) -> List[Optional[str]]:
        """Decode a dispatched batch, record the encode/solve/decode wall
        split, and run the gang admission retry if the batch needs it."""
        if ds is None:
            return []
        names = ds.names()
        self.last_solve = ds
        self.last_timings = {
            "encode_s": ds.encode_s,
            "compile_s": ds.dispatch_s,
            "solve_s": ds.deferred_s + ds.decode_wait_s,
            "decode_wait_s": ds.decode_wait_s,
            "decode_overlap_s": ds.deferred_s,
        }
        return self._gang_admission_retry(
            pending, names,
            lambda subset: self.schedule_pending_no_retry(
                subset, lock=lock, reservations=reservations,
                num_pods_hint=len(pending),
            ),
        )

    def schedule_pending(
        self,
        pending: Sequence[api.Pod],
        num_pods_hint: int = 0,
        lock=None,
        reservations: Sequence[Tuple[str, api.Pod]] = (),
    ) -> List[Optional[str]]:
        """One batched scheduling step against the incremental state.
        Returns one node name (or None) per pending pod.  Placements are
        NOT auto-assumed — the caller assumes/binds explicitly."""
        ds = self.schedule_pending_async(
            pending, num_pods_hint=num_pods_hint, lock=lock,
            reservations=reservations,
        )
        return self.finalize_pending(
            pending, ds, lock=lock, reservations=reservations
        )

    def schedule_pending_no_retry(
        self, pending, lock=None, reservations=(), num_pods_hint: int = 0
    ) -> List[Optional[str]]:
        snap, meta = self.encode_pending(
            pending, lock=lock, reservations=reservations,
            num_pods_hint=num_pods_hint,
        )
        return self.solve_encoded(snap, meta)

    def _gang_admission_retry(
        self,
        pending: Sequence[api.Pod],
        names: List[Optional[str]],
        solve_subset,
    ) -> List[Optional[str]]:
        """Gang scarcity packing: when gangs are present and NONE placed
        completely, admit gangs by priority until capacity runs out — a
        binary search over the priority-ordered gang prefix (if the k
        highest-priority gangs don't fit, k+1 don't either), O(log G)
        extra solves, only on the everything-parked path."""
        groups: Dict[str, List[int]] = {}
        for i, p in enumerate(pending):
            g = p.spec.scheduling_group
            if g:
                groups.setdefault(g, []).append(i)
        if not groups:
            return names
        complete = [
            g for g, idx in groups.items()
            if all(names[i] is not None for i in idx)
        ]
        if complete:
            return names  # scarcity handled: some gang(s) landed
        full_result = self.last_result
        # admission order: priority desc, then smaller gangs first
        order = sorted(
            groups,
            key=lambda g: (
                -max(pending[i].spec.priority for i in groups[g]),
                len(groups[g]),
                g,
            ),
        )
        nongang = [
            i for i, p in enumerate(pending) if not p.spec.scheduling_group
        ]

        def attempt(k: int) -> Optional[List[Optional[str]]]:
            idx = list(nongang)
            for g in order[:k]:
                idx.extend(groups[g])
            idx.sort()
            sub = [pending[i] for i in idx]
            sub_names = solve_subset(sub)
            admitted = {i for g in order[:k] for i in groups[g]}
            pos = {orig: j for j, orig in enumerate(idx)}
            if any(sub_names[pos[i]] is None for i in admitted):
                return None  # an admitted gang still doesn't fit
            out: List[Optional[str]] = [None] * len(pending)
            for orig, j in pos.items():
                out[orig] = sub_names[j]
            return out

        lo, hi, best = 0, len(order), None
        while lo < hi:
            mid = (lo + hi + 1) // 2
            got = attempt(mid)
            if got is not None:
                best, lo = got, mid
            else:
                hi = mid - 1
        if best is None:
            self.last_result = full_result  # re-align reasons with names
            return names
        # last_result belongs to the final SUBSET solve; its reasons no
        # longer align with the merged name list
        self.last_result = None
        return best

    # -- stateless (one-shot) ---------------------------------------------

    def snapshot(
        self,
        nodes: Sequence[api.Node],
        pending: Sequence[api.Pod],
        bound: Sequence[api.Pod] = (),
        num_pods_hint: int = 0,
    ) -> Tuple[schema.Snapshot, schema.SnapshotMeta]:
        return self.builder.build(
            nodes, pending, bound_pods=bound, num_pods_hint=num_pods_hint
        )

    def schedule(
        self,
        nodes: Sequence[api.Node],
        pending: Sequence[api.Pod],
        bound: Sequence[api.Pod] = (),
    ) -> List[Optional[str]]:
        """One-shot: encode nodes + pending (+ bound) and solve."""
        if not pending:
            return []

        def solve(pods):
            # pad every gang-retry subset into the full batch's bucket
            snap, meta = self.snapshot(
                nodes, pods, bound, num_pods_hint=len(pending)
            )
            self._annotate(snap, meta)
            snap = device_ops.to_device(snap, self.device)
            return self.solve_encoded_async(snap, meta).names()

        return self._gang_admission_retry(pending, solve(pending), solve)
