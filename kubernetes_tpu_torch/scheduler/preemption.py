"""PostFilter: preemption evaluator driving the tensorized dry-run.

The reference flow (framework/preemption/preemption.go:150 Preempt):
  1. candidates: nodes where removing lower-priority pods admits the pod
     (findCandidates → dry-run per node, parallel goroutines)
  2. pick the least-disruption candidate (SelectCandidate :316)
  3. prepare: DELETE the victims through the API, clear lower-priority
     nominations (prepareCandidate, default_preemption.go:345)
  4. nominate: pod.status.nominatedNodeName = node; pod requeues and
     schedules onto the freed space on a later cycle

Ours: the dry-run loop is batched at PASS granularity.  A PostFilter
pass opens a shared context (``shared_pass``) that walks
``state._pods_by_node`` ONCE, encodes the per-node victim tensors
(sorted by priority, PDB-aware eviction order per preemptor priority
level) and runs ONE ``[P, N, K]`` device dry-run plus one batched
static-feasibility dispatch for EVERY failed pod of the cycle
(ops.preemption.batched_dry_run).  Each ``preempt()`` call then ranks
its candidates from the shared tensors; selection is the same
lexicographic criteria (PDB violations first), victims are deleted
through the store (informers unaccount them), and the chosen candidate
is verified by a real re-solve with the victims masked out of the
cluster state before anything is deleted — so every nomination is
backed by an actual placement, including spread/inter-pod families the
resource dry-run can't see.

Cross-preemptor conflicts resolve with a wavefront-style pass
(mirroring ops.assign.plan_waves' coupling discipline): preemptors are
processed in priority order, and the shared dry-run stays valid for a
pod exactly while no earlier preemptor of the pass evicted on its
candidate nodes.  A node an earlier eviction TOUCHED is recomputed
from live state (counted in preemption_conflict_serializations), so two
preemptors never claim overlapping victims or double-count freed
capacity — batched results are identical to running the sequential
``preempt()`` loop (tests/test_preemption.py parity suite).

The sequential per-pod path (no shared context) is kept bit-for-bit as
the exact-parity fallback: any batched-dispatch failure (after one retry)
falls the pass back to it.  That path runs on the card too (kernels
preempt_dry_run and pod_filters, one pod at a time): it is not a host
fallback.

A copy of kubernetes_tpu/scheduler/preemption.py on TorchBatchScheduler:
the batched dry-run is kernel preempt_dry_run, the static slice kernel
pod_filters (its selector rows evaluated in its launch), both enqueued by
one binding call (ops/preemption.py run_preemption_pass); every input is
copied to `tpu.device` through ops/device.py and the pass's results come
back in one readback.  The kernels are built once, so there is no prewarm hook.
`tpu.breaker` is the scheduler's SolveCircuitBreaker: a batched pass that
fails twice trips it, and while it is open every pass runs the per-pod
path (kernel preempt_dry_run's second entry, the port of
`dry_run_victims`).  On the card only an injected fault and a corrupt
result (SolveUnhealthy) take that path; a kernel or CUDA error re-raises
(models/batch_scheduler.py solve_fault_recoverable).
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..api import store as st
from ..api import types as api
from ..models.batch_scheduler import (
    SolveUnhealthy, TorchBatchScheduler, solve_fault_recoverable)
from ..ops import device as device_ops
from ..ops import preemption as pre_ops
from ..ops.filters import pod_view, static_filter_row
from ..testing import faults
from ..utils.vocab import pad_dim
from .cache import SchedulerCache
from .metrics import Registry
from .queue import pod_key

# Reference caps: minCandidateNodesAbsolute=100, percentage 10%
# (defaultpreemption DefaultPreemptionArgs); we keep one flat cap — the
# dry-run is one dispatch so a larger pool costs little.
MAX_CANDIDATES = 256
# How many ranked candidates to verify with a real re-solve before
# giving up (each verification is a single-pod device solve).
MAX_VERIFY = 8

# sentinel: pod not covered by the active shared pass — route to the
# classic per-pod path (distinct from None = "no candidates")
_MISS = object()


class PreemptionResult:
    __slots__ = ("nominated_node", "victims")

    def __init__(self, nominated_node: str, victims: List[api.Pod]):
        self.nominated_node = nominated_node
        self.victims = victims


class _SharedPass:
    """One PostFilter pass's shared preemption state: the single
    ``_pods_by_node`` walk, the batched device dry-run results, and the
    conflict bookkeeping (``touched``) that keeps batched == sequential.
    Built under the cache lock by ``_begin_shared``; consumed lock-free
    except for touched-node recomputes."""

    __slots__ = (
        "fallback", "empty", "min_prio", "index", "level_of", "nodes",
        "victims", "free", "elig_len", "perm", "viol", "feasible",
        "min_k", "viol_k", "static_ok", "pods_req", "pdbs", "touched",
        "touch_all", "_ordered", "inputs", "timings",
    )

    def __init__(self):
        self.fallback = False    # breaker open / batched dispatch failed
        self.empty = True        # no candidate nodes encoded
        self.min_prio: Optional[int] = None
        self.index: Dict[str, int] = {}     # pod key -> batch row
        self.level_of: Dict[int, int] = {}  # priority -> level row
        self.nodes: List[Tuple[int, str]] = []   # (state row, node name)
        self.victims: List[List[api.Pod]] = []   # per node, (prio, key) asc
        self.free: Optional[np.ndarray] = None       # f32[N, R]
        self.elig_len: Optional[np.ndarray] = None   # i32[L, N]
        self.perm: Optional[np.ndarray] = None       # i32[L, N, K]
        self.viol: Optional[np.ndarray] = None       # bool[L, N, K]
        self.feasible: Optional[np.ndarray] = None   # bool[P, N]
        self.min_k: Optional[np.ndarray] = None      # i32[P, N]
        self.viol_k: Optional[np.ndarray] = None     # i32[P, N]
        self.static_ok: Optional[np.ndarray] = None  # bool[P, rows]
        self.pods_req: Optional[np.ndarray] = None   # f32[P, R]
        self.pdbs: List[api.PodDisruptionBudget] = []
        self.touched: set = set()   # node names an eviction dirtied
        self.touch_all = False      # a victim's node was unknown: degrade
        self._ordered: Dict[Tuple[int, int], Tuple[list, list]] = {}
        # the device inputs of the batched dispatch (PreemptionBatch, the
        # static snapshot) and its wall split (encode_s: the walk and the
        # copies to the device; dispatch_s: the kernels and the readback),
        # kept for measurement while the pass is open
        self.inputs = None
        self.timings: Dict[str, float] = {}

    def ordered(self, lvl: int, j: int) -> Tuple[list, list]:
        """(victims, pdb flags) of node j in level lvl's eviction order
        (PDB-clean first, priority ascending within each partition)."""
        key = (lvl, j)
        hit = self._ordered.get(key)
        if hit is None:
            e = int(self.elig_len[lvl, j])
            vs = [self.victims[j][i] for i in self.perm[lvl, j, :e]]
            flags = [bool(f) for f in self.viol[lvl, j, :e]]
            hit = self._ordered[key] = (vs, flags)
        return hit


class PreemptionEvaluator:
    def __init__(
        self,
        tpu: TorchBatchScheduler,
        cache: SchedulerCache,
        store: st.Store,
        metrics: Optional[Registry] = None,
    ):
        self.tpu = tpu
        self.cache = cache
        self.store = store
        self.metrics = metrics
        # optional client.events.EventRecorder (set by the Scheduler)
        self.events = None
        # PDBAwarePreemption feature gate (set by the Scheduler): off
        # means victim ranking ignores disruption budgets
        self.pdb_aware = True
        # the active shared PostFilter pass (None outside shared_pass);
        # only the scheduling thread opens/consumes it
        self._shared: Optional[_SharedPass] = None

    # -- eligibility (PodEligibleToPreemptOthers) --------------------------

    def min_existing_priority(self) -> Optional[int]:
        """The cluster's lowest bound/assumed pod priority, or None when
        no pods exist — computed ONCE per PostFilter pass (shared_pass
        caches it) instead of scanning ``state._pods`` per failed pod."""
        state = self.tpu.state
        with self.cache.lock:
            return min(
                (p.spec.priority for p in state._pods.values()),
                default=None,
            )

    def eligible(self, pod: api.Pod) -> bool:
        if pod.spec.preemption_policy == "Never":
            return False
        ctx = self._shared
        if ctx is not None:
            min_prio = ctx.min_prio
        else:
            min_prio = self.min_existing_priority()
        return min_prio is not None and min_prio < pod.spec.priority

    # -- the batched PostFilter pass ---------------------------------------

    @contextlib.contextmanager
    def shared_pass(self, pods: Sequence[api.Pod]):
        """Open the shared preemption context for one PostFilter pass:
        every ``preempt()`` call inside the block consumes the single
        batched encode + dry-run instead of walking the cluster itself.
        Nested entry is a passthrough (one context per pass)."""
        if self._shared is not None:
            yield self._shared
            return
        ctx = self._begin_shared(list(pods))
        self._shared = ctx
        try:
            yield ctx
        finally:
            self._shared = None

    def preempt_batch(
        self, pods: Sequence[api.Pod]
    ) -> List[Optional[PreemptionResult]]:
        """Batched PostFilter: one shared encode + device dry-run for the
        whole failed-pod set, then the per-pod select/verify/evict tail
        in order.  Results are identical to calling ``preempt()``
        sequentially on the same set (the conflict pass recomputes
        touched nodes); on a tripped breaker or a failed batched
        dispatch the pass transparently IS that sequential loop."""
        out: List[Optional[PreemptionResult]] = []
        with self.shared_pass(pods):
            for pod in pods:
                if not self.eligible(pod):
                    out.append(None)
                    continue
                out.append(self.preempt(pod))
        return out

    def _begin_shared(self, pods: List[api.Pod]) -> _SharedPass:
        ctx = _SharedPass()
        ctx.min_prio = self.min_existing_priority()
        elig = [
            p for p in pods
            if p.spec.preemption_policy != "Never"
            and ctx.min_prio is not None
            and ctx.min_prio < p.spec.priority
        ]
        if not elig:
            return ctx
        breaker = getattr(self.tpu, "breaker", None)
        if breaker is not None and breaker.state_code() != 0.0:
            # device path is sick: the pass runs on the exact-parity
            # per-pod fallback until the breaker closes again
            ctx.fallback = True
            return ctx
        dev = torch.device(self.tpu.device)
        try:
            self._encode_and_dispatch(ctx, elig)
        except Exception as exc:  # noqa: BLE001 — batched dispatch fault
            if not solve_fault_recoverable(exc, dev):
                raise
            logging.getLogger(__name__).exception(
                "batched preemption dry-run failed; retrying once"
            )
            try:
                self._encode_and_dispatch(ctx, elig)
            except Exception as exc2:  # noqa: BLE001
                if not solve_fault_recoverable(exc2, dev):
                    raise
                if breaker is not None:
                    breaker.record_failure()
                logging.getLogger(__name__).exception(
                    "batched preemption retry failed; falling back to the "
                    "per-pod path for this pass"
                )
                ctx.fallback = True
        return ctx

    def _encode_and_dispatch(
        self, ctx: _SharedPass, elig: List[api.Pod]
    ) -> None:
        """The tentpole: walk ``_pods_by_node`` once, build the padded
        victim tensors + per-level eviction orders, dispatch ONE batched
        dry-run and ONE batched static-feasibility solve for the whole
        failed-pod set."""
        t0 = time.perf_counter()
        state = self.tpu.state
        pdbs = self._pdbs()
        levels = sorted({p.spec.priority for p in elig})
        prio_max = levels[-1]
        with self.cache.lock:
            assumed = set(self.cache._assumed.keys())
            r = state._r
            nodes: List[Tuple[int, str]] = []
            victims_l: List[List[api.Pod]] = []
            prios_l: List[np.ndarray] = []
            free_l: List[np.ndarray] = []
            usage: Dict[str, np.ndarray] = {}
            for name, keys in state._pods_by_node.items():
                row = state._rows.get(name)
                if row is None:
                    continue
                vs = [
                    state._pods[k]
                    for k in keys
                    if state._pods[k].spec.priority < prio_max
                    and k not in assumed
                ]
                if not vs:
                    continue
                vs.sort(key=lambda p: (p.spec.priority, pod_key(p)))
                nodes.append((row, name))
                victims_l.append(vs)
                prios_l.append(
                    np.array([v.spec.priority for v in vs], dtype=np.int64)
                )
                free_l.append(
                    (state.allocatable[row] - state.requested[row]).copy()
                )
                for v in vs:
                    vk = pod_key(v)
                    if vk not in usage:
                        usage[vk] = state.builder.pod_usage(v, r)[0]
            ctx.pods_req = np.stack(
                [state.builder.pod_usage(p, r)[0] for p in elig]
            ).astype(np.float32)
            # the static-feasibility snapshot for ALL preemptors at once
            # (copied to the device under the lock: the cluster leaves
            # alias the live state)
            snap, _ = self.tpu.builder.build_from_state(state, elig)
            snap = device_ops.to_device(snap, self.tpu.device)
        ctx.pdbs = pdbs
        ctx.index = {pod_key(p): i for i, p in enumerate(elig)}
        ctx.level_of = {prio: i for i, prio in enumerate(levels)}
        ctx.nodes = nodes
        ctx.victims = victims_l
        if self.metrics:
            self.metrics.preemption_batch_size.observe(float(len(elig)))
        if not nodes:
            # no node holds an evictable pod: nothing to dry-run, but the
            # static mask is unneeded too — every preempt() returns None
            ctx.empty = True
            if self.metrics:
                self.metrics.preemption_solve_duration.observe(
                    time.perf_counter() - t0
                )
            return
        n = len(nodes)
        k_max = max(len(v) for v in victims_l)
        n_pad = pad_dim(n, 8)
        k_pad = pad_dim(k_max, 4)
        l_pad = pad_dim(len(levels), 1)
        p_pad = pad_dim(len(elig), 4)
        r = ctx.pods_req.shape[1]
        free = np.zeros((n_pad, r), dtype=np.float32)
        victim_req = np.zeros((n_pad, k_pad, r), dtype=np.float32)
        perm = np.tile(
            np.arange(k_pad, dtype=np.int32), (l_pad, n_pad, 1)
        )
        elig_len = np.zeros((l_pad, n_pad), dtype=np.int32)
        viol = np.zeros((l_pad, n_pad, k_pad), dtype=bool)
        for j, vs in enumerate(victims_l):
            free[j] = free_l[j]
            for vi, v in enumerate(vs[:k_pad]):
                victim_req[j, vi] = usage[pod_key(v)]
        for li, level in enumerate(levels):
            for j, vs in enumerate(victims_l):
                e = int(np.searchsorted(prios_l[j], level, side="left"))
                elig_len[li, j] = e
                if e == 0:
                    continue
                if pdbs:
                    flags = self._pdb_flags(vs[:e], pdbs)
                    if any(flags):
                        # eviction preference: non-violating victims
                        # first, stably (the prefix-eviction analogue of
                        # the reference's reprieve pass)
                        order = sorted(range(e), key=lambda i: flags[i])
                        perm[li, j, :e] = np.array(order, dtype=np.int32)
                        viol[li, j, :e] = np.array(
                            [flags[i] for i in order], dtype=bool
                        )
        pods_req = np.zeros((p_pad, r), dtype=np.float32)
        pods_req[: len(elig)] = ctx.pods_req
        pod_level = np.zeros(p_pad, dtype=np.int32)
        for i, p in enumerate(elig):
            pod_level[i] = ctx.level_of[p.spec.priority]
        batch = device_ops.table_to_device(pre_ops.PreemptionBatch(
            free=free, victim_req=victim_req, perm=perm,
            elig_len=elig_len, viol=viol, pods_req=pods_req,
            pod_level=pod_level,
        ), self.tpu.device)
        t1 = time.perf_counter()
        act = faults.fire("batch.preemption", pods=len(elig), nodes=n)
        result, static = pre_ops.run_preemption_pass(
            batch, snap.cluster, snap.pods, snap.selectors
        )
        # one coalesced readback
        res_feasible, min_k, res_viol_k, static_np = device_ops.readback(
            (*result, static))
        if act == faults.CORRUPT:
            # injected device corruption: poison the result so the
            # health check below trips (the NaN-grade fault family)
            min_k = np.full_like(min_k, -1)
        if (min_k < 0).any() or (min_k > k_pad).any():
            # health check (the breaker's non-finite-score analogue): a
            # structurally-broken result means none of this pass's
            # candidate stats can be trusted
            raise SolveUnhealthy(
                "batched preemption dry-run returned out-of-range victim "
                "counts — result untrusted"
            )
        ctx.free = free
        ctx.elig_len = elig_len
        ctx.perm = perm
        ctx.viol = viol
        ctx.feasible = res_feasible[: len(elig), :n]
        ctx.min_k = min_k[: len(elig), :n]
        ctx.viol_k = res_viol_k[: len(elig), :n]
        ctx.static_ok = static_np[: len(elig)]
        ctx.empty = False
        ctx.inputs = (batch, snap)
        ctx.timings = {"encode_s": t1 - t0, "dispatch_s": time.perf_counter() - t1}
        if self.metrics:
            self.metrics.preemption_solve_duration.observe(
                time.perf_counter() - t0
            )

    # -- the PostFilter entry ----------------------------------------------

    def preempt(self, pod: api.Pod) -> Optional[PreemptionResult]:
        """Find victims admitting `pod`, verify by re-solve, evict through
        the store, and nominate.  Returns None when no candidate works."""
        # The preemptor must still exist — evicting running pods on behalf
        # of a deleted pod is the worst failure mode (the reference
        # re-fetches the pod before preparing candidates, getUpdatedPod).
        try:
            self.store.get("Pod", pod.meta.name, pod.meta.namespace)
        except KeyError:
            return None
        if self.metrics:
            self.metrics.preemption_attempts.inc("attempted")
        if pod.spec.scheduling_group:
            plan = self._plan_gang(pod)
        else:
            single = self._plan(pod)
            plan = ([(pod, single[0])], single[1]) if single else None
        if plan is None:
            if self.metrics:
                self.metrics.preemption_attempts.inc("no_candidate")
            return None
        nominations, victims = plan
        node_name = next(
            (n for p, n in nominations if pod_key(p) == pod_key(pod)),
            nominations[0][1],
        )
        # Evict: delete through the API *and* unaccount from the cache
        # immediately (remove_pod is idempotent, so the informer's echo of
        # the delete is a no-op).  Without the synchronous unaccount, the
        # next batch could race ahead of the informer, see the pod still
        # unschedulable, and evict a second victim set.
        ctx = self._shared
        for v in victims:
            if ctx is not None:
                # conflict bookkeeping: a later preemptor of this pass
                # must not trust the shared dry-run on this node
                if v.spec.node_name:
                    ctx.touched.add(v.spec.node_name)
                else:
                    ctx.touch_all = True
            try:
                self.store.delete("Pod", v.meta.name, v.meta.namespace)
            except KeyError:
                pass  # already gone — the freed space is still freed
            self.cache.remove_pod(v)
            if self.events:
                self.events.eventf(
                    v, "Normal", "Preempted",
                    f"Preempted by {pod.meta.namespace}/{pod.meta.name} on "
                    f"node {node_name}",
                )
        # reserve the freed space for the nominee(s): other batches see
        # the reservation; each nominee's own batch excludes it.  Gangs
        # nominate EVERY member to its verified node so the whole group's
        # space is held until the gang lands (all-or-nothing).
        for p, n in nominations:
            self._nominate(p, n)
            self.cache.nominate(p, n)
        if self.metrics:
            self.metrics.preemption_attempts.inc("nominated")
            self.metrics.preemption_victims.observe(len(victims))
        return PreemptionResult(node_name, victims)

    def _nominate(self, pod: api.Pod, node_name: str) -> None:
        # Best-effort status write (the reference's nominatedNodeName
        # PATCH is equally fire-and-forget).  Conflict is a ValueError,
        # not a KeyError — an uncaught race here after victims were
        # already evicted would kill the scheduler thread, so retry once
        # against the fresh object and then give up: the in-cache
        # nomination (cache.nominate) still reserves the space.  NotFound
        # and Conflict are caught as their bases (KeyError, ValueError), so
        # the reference package's store works here too.
        for _ in range(2):
            try:
                current = self.store.get(
                    "Pod", pod.meta.name, pod.meta.namespace
                )
                current.status.nominated_node_name = node_name
                self.store.update(current)
                return
            except KeyError:  # st.NotFound
                return  # pod deleted while we worked
            except ValueError:  # st.Conflict
                continue  # concurrent writer; re-read and retry once

    # -- planning (findCandidates + SelectCandidate + verify) --------------

    def _plan(
        self, pod: api.Pod
    ) -> Optional[Tuple[str, List[api.Pod]]]:
        """Choose (node, victims) for the pod, verified by a dry-run
        re-solve against the state with the victims removed.

        Lock discipline mirrors schedule_batch's: host-side reads of the
        shared state and snapshot encodes run under the cache lock
        (inside _candidates); the device dispatches (which can hit
        tens-of-seconds first-time XLA compiles) run OUTSIDE it, so
        informer event handling never stalls behind a compile."""
        base = self._candidates(pod)
        if base is None:
            return None
        cands, ranked, min_k = base
        for ci in ranked[:MAX_VERIFY]:
            row, name, victims, _flags = cands[ci]
            chosen = victims[: int(min_k[ci])]
            if self._verify(pod, name, chosen):
                return name, chosen
        self._note_budget_exhausted(pod, len(ranked))
        return None

    def _plan_gang(
        self, pod: api.Pod
    ) -> Optional[Tuple[List[Tuple[api.Pod, str]], List[api.Pod]]]:
        """Gang preemption: victims must admit the WHOLE group, possibly
        spanning nodes.  Greedy multi-node eviction: walk the ranked
        single-node candidates accumulating their victim sets; after each
        addition re-solve ALL pending members with the accumulated
        victims removed (the solver's gang post-pass enforces
        all-or-nothing), stopping at the first victim set under which the
        gang fully places.  Evicting for one member alone could free
        space a still-partial gang can never use — the failure mode that
        previously made gang pods preemption-ineligible."""
        group = pod.spec.scheduling_group
        pods_all, _ = self.store.list("Pod")
        members = [
            p for p in pods_all
            if p.spec.scheduling_group == group and not p.spec.node_name
        ]
        if not members:
            return None
        members.sort(key=pod_key)
        base = self._candidates(pod)
        if base is None:
            return None
        cands, ranked, min_k = base
        victims_accum: List[api.Pod] = []
        chunks: List[List[api.Pod]] = []  # per-candidate contributions
        for ci in ranked[:MAX_VERIFY]:
            row, name, victims, _flags = cands[ci]
            chunk = victims[: int(min_k[ci])]
            victims_accum.extend(chunk)
            chunks.append(chunk)
            placements = self._verify_multi(members, victims_accum)
            if placements and all(n is not None for n in placements):
                return self._shrink_gang_plan(members, chunks, placements)
        self._note_budget_exhausted(pod, len(ranked))
        return None

    def _shrink_gang_plan(self, members, chunks, placements):
        """Shrink pass: an early candidate's victims may be unnecessary
        once later candidates joined the accumulation (the gang fit
        thanks to them alone).  Try dropping each contribution —
        earliest first, since later ones completed the fit —
        re-verifying the remainder; keep any drop that still fully
        places.  Bounded: one re-solve per contributing candidate
        (<= MAX_VERIFY extra dry-runs, only on the success path)."""
        kept = list(chunks)
        best = placements
        for i in range(len(kept) - 1):  # the last chunk completed the fit
            if not kept[i]:
                continue
            trial_victims = [
                v for j, c in enumerate(kept) if j != i for v in c
            ]
            p = self._verify_multi(members, trial_victims)
            if p and all(n is not None for n in p):
                kept[i] = []
                best = p
        victims = [v for c in kept for v in c]
        return list(zip(members, best)), victims

    def _note_budget_exhausted(self, pod: api.Pod, n_ranked: int) -> None:
        """Distinguish 'no candidate' from 'verification budget ran out'
        — a silent cap here reads as full coverage (review finding r3)."""
        if n_ranked <= MAX_VERIFY:
            return
        if self.metrics:
            self.metrics.preemption_attempts.inc("verify_budget_exhausted")
        logging.getLogger(__name__).info(
            "preemption for %s: %d ranked candidates, verification budget "
            "%d exhausted without a confirmed placement",
            pod_key(pod), n_ranked, MAX_VERIFY,
        )

    def _candidates(self, pod: api.Pod):
        """Collect + rank candidate (node, victims) sets: the tensorized
        findCandidates/SelectCandidate half, shared by single-pod and
        gang planning.  Returns (cands, ranked indices, min_k) with
        cands entries (row, node_name, victims, pdb_violation_flags).

        Inside an active shared pass the stats come from the batched
        dry-run (one encode + one dispatch for the whole pass);
        otherwise — and for pods the pass did not cover — the classic
        per-pod walk runs (the exact-parity fallback)."""
        ctx = self._shared
        if ctx is not None and not ctx.fallback:
            got = self._candidates_shared(pod, ctx)
            if got is not _MISS:
                return got
        return self._candidates_classic(pod)

    def _candidates_shared(self, pod: api.Pod, ctx: _SharedPass):
        pi = ctx.index.get(pod_key(pod))
        if pi is None:
            return _MISS
        if ctx.empty:
            return None
        lvl = ctx.level_of[pod.spec.priority]
        cands: List[Tuple[int, str, List[api.Pod], List[bool]]] = []
        feas_list: List[bool] = []
        min_k_list: List[int] = []
        viol_list: List[int] = []
        with self.cache.lock:
            for j, (row, name) in enumerate(ctx.nodes):
                if ctx.touch_all or name in ctx.touched:
                    # wavefront conflict serialization: an earlier
                    # preemptor of this pass evicted here — the shared
                    # dry-run no longer describes this node, recompute
                    # it from live state (exactly what the sequential
                    # loop would see)
                    rec = self._recompute_node(ctx, name, row, pod)
                    if self.metrics:
                        self.metrics.preemption_conflict_serializations.inc()
                    if rec is None:
                        continue
                    victims, flags, feas, mk, vk = rec
                else:
                    if int(ctx.elig_len[lvl, j]) == 0:
                        continue
                    victims, flags = ctx.ordered(lvl, j)
                    feas = bool(ctx.feasible[pi, j])
                    mk = int(ctx.min_k[pi, j])
                    vk = int(ctx.viol_k[pi, j])
                cands.append((row, name, victims, flags))
                feas_list.append(feas)
                min_k_list.append(mk)
                viol_list.append(vk)
                if len(cands) >= MAX_CANDIDATES:
                    break
        if not cands:
            return None
        static_ok = ctx.static_ok[pi]
        keep = [i for i, c in enumerate(cands) if static_ok[c[0]]]
        cands = [cands[i] for i in keep]
        feas_list = [feas_list[i] for i in keep]
        min_k_list = [min_k_list[i] for i in keep]
        viol_list = [viol_list[i] for i in keep]
        if not cands:
            return None
        min_k = np.array(min_k_list, dtype=np.int32)
        # min_k == 0 means the pod already fits — that is a scheduling
        # outcome, not a preemption candidate (see _rank_classic)
        feasible = np.array(feas_list, dtype=bool) & (min_k > 0)
        ranked = self._order_candidates(
            cands, feasible, min_k, np.array(viol_list, dtype=np.int64)
        )
        if not ranked:
            return None
        return cands, ranked, min_k

    def _recompute_node(
        self, ctx: _SharedPass, name: str, row: int, pod: api.Pod
    ):
        """Per-node recompute against LIVE state (caller holds the cache
        lock): the single-node slice of the classic walk plus a host
        mirror of the kernel's f32 cumulative dry-run — bit-identical to
        what a sequential ``preempt()`` would compute after the earlier
        evictions.  Returns (victims, flags, feasible, min_k, viol_k) or
        None when the node no longer holds an eligible victim."""
        state = self.tpu.state
        prio = pod.spec.priority
        assumed = set(self.cache._assumed.keys())
        keys = state._pods_by_node.get(name, ())
        victims = [
            state._pods[k]
            for k in keys
            if state._pods[k].spec.priority < prio and k not in assumed
        ]
        if not victims:
            return None
        victims.sort(key=lambda p: (p.spec.priority, pod_key(p)))
        flags = self._pdb_flags(victims, ctx.pdbs)
        paired = sorted(zip(victims, flags), key=lambda vf: vf[1])
        victims = [v for v, _ in paired]
        flags = [f for _, f in paired]
        r = state._r
        free = (
            state.allocatable[row] - state.requested[row]
        ).astype(np.float32)
        reqs = np.stack(
            [state.builder.pod_usage(v, r)[0] for v in victims]
        ).astype(np.float32)
        cum = np.cumsum(reqs, axis=0)                      # f32, like the kernel
        free_k = np.concatenate(
            [free[None, :], free[None, :] + cum], axis=0
        )                                                  # [K+1, R]
        pod_req = ctx.pods_req[ctx.index[pod_key(pod)]]
        fits = (
            (pod_req[None, :] <= 0) | (pod_req[None, :] <= free_k)
        ).all(axis=-1)
        feasible = bool(fits.any())
        mk = int(np.argmax(fits)) if feasible else 0
        vk = int(sum(flags[:mk]))
        return victims, flags, feasible, mk, vk

    def _candidates_classic(self, pod: api.Pod):
        """The sequential per-pod walk (the exact-parity fallback the
        breaker routes to): one ``_pods_by_node`` scan, one single-pod
        static snapshot, one per-pod device dry-run."""
        got = self._classic_inputs(pod)
        if got is None:
            return None
        ranked, min_k = self._rank(*got)
        if not ranked:
            return None
        return got[0], ranked, min_k

    def _classic_inputs(self, pod: api.Pod):
        """The per-pod walk's candidates, copied out under the lock and
        kept where the preemptor passes the static filters: (candidates,
        their free rows, victim usage by pod key, the pod's request), or
        None without a candidate."""
        state = self.tpu.state
        prio = pod.spec.priority
        pdbs = self._pdbs()
        with self.cache.lock:
            # assumed pods are mid-bind — not evictable (the reference's
            # dry-run also works off the snapshot of *confirmed* state)
            assumed = set(self.cache._assumed.keys())
            static_snap = self._encode_static(pod)
            # candidate victim data is copied out (free vectors, victim
            # usage) so ranking can run lock-free on a consistent view
            cands: List[Tuple[int, str, List[api.Pod], List[bool]]] = []
            free_rows: List[np.ndarray] = []
            usage: Dict[str, np.ndarray] = {}
            r = state._r
            for name, keys in state._pods_by_node.items():
                row = state._rows.get(name)
                if row is None:
                    continue
                victims = [
                    state._pods[k]
                    for k in keys
                    if state._pods[k].spec.priority < prio and k not in assumed
                ]
                if not victims:
                    continue
                victims.sort(key=lambda p: (p.spec.priority, pod_key(p)))
                flags = self._pdb_flags(victims, pdbs)
                # eviction preference: non-violating victims first
                # (stably, keeping priority order within each partition)
                # — the prefix-eviction analogue of the reference's
                # reprieve pass, which tries hardest to KEEP
                # PDB-violating victims (preemption.go:198)
                paired = sorted(
                    zip(victims, flags), key=lambda vf: vf[1]
                )
                victims = [v for v, _ in paired]
                flags = [f for _, f in paired]
                cands.append((row, name, victims, flags))
                free_rows.append(
                    (state.allocatable[row] - state.requested[row]).copy()
                )
                for v in victims:
                    usage[pod_key(v)] = state.builder.pod_usage(v, r)[0]
                if len(cands) >= MAX_CANDIDATES:
                    break
            if not cands:
                return None
            pod_req = state.builder.pod_usage(pod, r)[0]

        static_ok = self._static_row_from_snap(static_snap)
        keep = [i for i, c in enumerate(cands) if static_ok[c[0]]]
        cands = [cands[i] for i in keep]
        free_rows = [free_rows[i] for i in keep]
        if not cands:
            return None
        return cands, free_rows, usage, pod_req

    def _pdbs(self) -> List[api.PodDisruptionBudget]:
        if not self.pdb_aware:
            return []
        try:
            pdbs, _ = self.store.list("PodDisruptionBudget")
        except Exception:
            return []
        return [p for p in pdbs if p.spec.selector is not None]

    @staticmethod
    def _pdb_flags(
        victims: Sequence[api.Pod], pdbs: Sequence[api.PodDisruptionBudget]
    ) -> List[bool]:
        """Per-victim PDB-violation flags (filterPodsWithPDBViolation,
        preemption.go:290): walking the victims in order, each budget's
        first `disruptions_allowed` matching evictions are tolerated;
        evictions past that violate it."""
        if not pdbs:
            return [False] * len(victims)
        allow = [p.status.disruptions_allowed for p in pdbs]
        flags = []
        for v in victims:
            matched = [i for i, p in enumerate(pdbs) if p.matches(v)]
            viol = any(allow[i] <= 0 for i in matched)
            if not viol:
                for i in matched:
                    allow[i] -= 1
            flags.append(viol)
        return flags

    def _rank(
        self,
        cands: Sequence[Tuple[int, str, List[api.Pod], List[bool]]],
        free_rows: Sequence[np.ndarray],
        usage: Dict[str, np.ndarray],
        pod_req: np.ndarray,
    ) -> Tuple[List[int], np.ndarray]:
        """Run the per-pod device dry-run over all candidates (lock-free
        — inputs were copied out under the lock); return candidate
        indices ranked most-preferred first (feasible only) plus
        per-candidate victim counts."""
        result = pre_ops.dry_run_victims(
            *self._victim_tables(cands, free_rows, usage, pod_req))
        feasible, min_k = device_ops.readback(result)
        feasible = feasible[: len(cands)]
        min_k = min_k[: len(cands)]
        # min_k == 0 means the pod already fits — that is a scheduling
        # outcome, not a preemption candidate (the reference only reaches
        # PostFilter when no node passed filters; a zero-victim candidate
        # here is a stale-state race and must not cause a nomination)
        feasible = feasible & (min_k > 0)
        n_viol = np.zeros(len(cands), dtype=np.int64)
        for ci, (_, _, _victims, flags) in enumerate(cands):
            if feasible[ci]:
                n_viol[ci] = sum(flags[: int(min_k[ci])])
        ranked = self._order_candidates(cands, feasible, min_k, n_viol)
        return ranked, min_k

    def _victim_tables(self, cands, free_rows, usage, pod_req) -> Tuple[torch.Tensor, ...]:
        """The per-pod dry-run's inputs on `tpu.device`: (free [C, R],
        victim_req [C, K, R], victim_valid [C, K], pod_req [R]), C and K
        padded."""
        r = pod_req.shape[0]
        c_dim = pad_dim(len(cands), 8)
        k_dim = pad_dim(max(len(c[2]) for c in cands), 4)
        free = np.zeros((c_dim, r), dtype=np.float32)
        victim_req = np.zeros((c_dim, k_dim, r), dtype=np.float32)
        victim_valid = np.zeros((c_dim, k_dim), dtype=bool)
        for ci, (row, _, victims, _flags) in enumerate(cands):
            free[ci] = free_rows[ci]
            for vi, v in enumerate(victims[:k_dim]):
                victim_req[ci, vi] = usage[pod_key(v)]
                victim_valid[ci, vi] = True
        dev = self.tpu.device
        return tuple(torch.from_numpy(a).to(dev)
                     for a in (free, victim_req, victim_valid, pod_req.astype(np.float32)))

    def _order_candidates(
        self,
        cands: Sequence[Tuple[int, str, List[api.Pod], List[bool]]],
        feasible: np.ndarray,
        min_k: np.ndarray,
        n_viol_arr: np.ndarray,
    ) -> List[int]:
        """The shared SelectCandidate ordering (both the batched and the
        classic path land here so they cannot diverge): ranking stats
        with exact integer math (priorities reach ~2e9, past f32's exact
        envelope) and node-row tie-break — both must match
        testing/oracle Oracle.preempt for the parity contract.  PDB
        violations rank first (fewest preferred —
        pickOneNodeForPreemption's minNumPDBViolatingScoreFunc,
        preemption.go:463)."""
        big = np.iinfo(np.int64).max
        max_prio = np.full(len(cands), big, dtype=np.int64)
        sum_prio = np.zeros(len(cands), dtype=np.int64)
        n_viol = np.full(len(cands), big, dtype=np.int64)
        rows = np.array([c[0] for c in cands], dtype=np.int64)
        blocked = 0
        for ci, (_, _, victims, _flags) in enumerate(cands):
            if feasible[ci]:
                k = int(min_k[ci])
                prios = [v.spec.priority for v in victims[:k]]
                max_prio[ci] = max(prios)
                sum_prio[ci] = sum(prios)
                n_viol[ci] = int(n_viol_arr[ci])
                if n_viol[ci] > 0:
                    blocked += 1
        if blocked and self.metrics:
            # feasible candidates whose minimal eviction set would
            # violate a disruption budget: the ranking pushes them last
            self.metrics.preemption_pdb_blocked_total.inc(by=float(blocked))
        order = np.lexsort((rows, min_k, sum_prio, max_prio, n_viol))
        return [int(i) for i in order if feasible[i]]

    def _verify(
        self, pod: api.Pod, node_name: str, victims: List[api.Pod]
    ) -> bool:
        """Dry-run re-solve: under the lock, remove the victims from live
        state, encode a snapshot (device_put copies), and restore; solve
        OUTSIDE the lock.  True iff the pod lands on the expected node.
        This is the all-families check the resource-only kernel can't do
        (the reference re-runs the full filter chain in its dry-run)."""
        placements = self._verify_multi([pod], victims, node_name)
        return bool(placements) and placements[0] == node_name

    def _verify_multi(
        self,
        pods: List[api.Pod],
        victims: List[api.Pod],
        fallback_node: Optional[str] = None,
    ) -> Optional[List[Optional[str]]]:
        """Solve `pods` against the state with `victims` removed (state
        restored before returning); placements list, or None on encode
        failure.  The gang path feeds all pending members so the solver's
        all-or-nothing post-pass judges the whole group.

        OTHER preemptors' nominations overlay their nodes as
        reservations (the filters-with-nominated-pods analogue,
        runtime/framework.go:962): without them, a node an earlier
        preemptor of the pass just freed attracts this verify solve,
        failing the legitimate candidate — observed steering evictions
        onto PDB-guarded victims whose node merely had a lower row
        index than the reserved one."""
        state = self.tpu.state
        with self.cache.lock:
            reservations = self.cache.nominations_excluding(
                {pod_key(p) for p in pods}
            )
            removed = []
            try:
                for v in victims:
                    if state.has_pod(v):
                        state.remove_pod(v)
                        removed.append(v)
                snap, meta = self.tpu.encode_pending(
                    pods, reservations=reservations
                )
            finally:
                for v in removed:
                    state.add_pod(v, v.spec.node_name or fallback_node)
        return self.tpu.solve_encoded(snap, meta)

    # -- static feasibility (non-resource filters) --------------------------

    def _encode_static(self, pod: api.Pod):
        """Encode (under the caller-held lock) the single-pod snapshot the
        static-feasibility kernels read, copied to the device (the cluster
        leaves alias the live state, so later cache mutation can't leak
        in)."""
        snap, _ = self.tpu.builder.build_from_state(self.tpu.state, [pod])
        return device_ops.to_device(snap, self.tpu.device)

    def _static_row_from_snap(self, snap) -> np.ndarray:
        """bool[rows]: NodeName/taints/affinity/validity feasibility of the
        preemptor on every node (resources deliberately excluded — that is
        what eviction frees).  Pure device dispatch — no lock needed:
        kernel pod_filters (one pod, its selector row evaluated in the
        launch) on the card."""
        feas = static_filter_row(snap.cluster, pod_view(snap.pods, 0), snap.selectors)
        return device_ops.readback([feas])[0]
