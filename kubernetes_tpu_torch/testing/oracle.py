"""Pure-Python scheduling oracle: a copy of kubernetes_tpu/testing/oracle.py
over this package's api/types.py and ops/schema.py.  It is the port's
second witness (tests/test_torch_oracle.py holds it to the reference's
Oracle) and the solver of TorchBatchScheduler._host_fallback, the circuit
breaker's degraded mode.

An independent re-implementation of the reference's per-pod Filter/Score
cycle used to validate the kernels.

Deliberately written the slow, obvious way (per-node Python loops over the
api object model, no tensors, no shared code with ops/) so that a bug in
the snapshot encoder or a kernel cannot cancel itself out in tests.
Semantics follow the same reference code paths the kernels cite:

  filter: noderesources/fit.go:421, nodename, tainttoleration,
          nodeports (wildcard-IP simplification, same as the kernel),
          nodeaffinity required terms
  score:  least_allocated.go:30, balanced_allocation.go:138,
          nodeaffinity preferred + DefaultNormalizeScore,
          tainttoleration PreferNoSchedule count + reversed normalize
  loop:   one pod at a time with assume between picks
          (schedule_one.go:66-133), first-index tie-break.

Resource quantities are converted to the same device units the schema uses
(schema.DEVICE_UNIT_DIVISOR) so score floors land on identical integers.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..api import types as api
from ..ops.schema import DEVICE_UNIT_DIVISOR

MAX_SCORE = 100


def _units(requests: Dict[str, int]) -> Dict[str, float]:
    return {k: v / DEVICE_UNIT_DIVISOR.get(k, 1) for k, v in requests.items()}


@dataclass
class _NodeState:
    node: api.Node
    allocatable: Dict[str, float]
    requested: Dict[str, float] = field(default_factory=dict)
    nonzero_requested: Dict[str, float] = field(default_factory=dict)
    used_ports: Set[Tuple[str, int]] = field(default_factory=set)
    pods: List[api.Pod] = field(default_factory=list)

    def add_pod(self, pod: api.Pod) -> None:
        self.pods.append(pod)
        req = _units(pod.resource_requests())
        req[api.PODS] = req.get(api.PODS, 0) + 1
        for k, v in req.items():
            self.requested[k] = self.requested.get(k, 0) + v
        nz = dict(req)
        nz_cpu, nz_mem = pod.nonzero_requests()
        nz[api.CPU] = nz_cpu
        nz[api.MEMORY] = nz_mem / DEVICE_UNIT_DIVISOR[api.MEMORY]
        for k, v in nz.items():
            self.nonzero_requested[k] = self.nonzero_requested.get(k, 0) + v
        for proto, _ip, port in pod.host_ports():
            self.used_ports.add((proto, port))


class Oracle:
    """Schedules pods one at a time with reference semantics."""

    def __init__(
        self,
        nodes: Sequence[api.Node],
        bound_pods: Sequence[api.Pod] = (),
        fit_strategy: str = "LeastAllocated",
        slice_policy: str = "prefer",
    ):
        self.states: List[_NodeState] = [
            _NodeState(node=n, allocatable=_units(n.status.allocatable)) for n in nodes
        ]
        self.fit_strategy = fit_strategy
        # TPU slice carve-outs (ops/slices.py semantics contract):
        # per-node slice info from labels, per-gang anchored carve-outs
        self.slice_policy = slice_policy
        self._slice_infos = [self._parse_slice(st) for st in self.states]
        self._has_slices = any(i is not None for i in self._slice_infos)
        self._gang_carve: Dict[str, Tuple[str, Tuple[int, int, int]]] = {}
        by_name = {s.node.meta.name: s for s in self.states}
        for p in bound_pods:
            st = by_name.get(p.spec.node_name)
            if st is not None:
                st.add_pod(p)

    # -- TPU slice carve-outs (ops/slices.py parity twin) -----------------
    #
    # The slow, obvious reimplementation of the carve-out semantics
    # contract: python dict grids instead of value-space tensors.  Only
    # the score WEIGHTS are shared (ops.slices constants) — they define
    # the semantics, not the implementation.

    @staticmethod
    def _parse_slice(st: _NodeState):
        labels = st.node.meta.labels
        name = labels.get(api.LABEL_TPU_SLICE)
        if not name:
            return None
        dims = api.parse_topology(labels.get(api.LABEL_TPU_TOPOLOGY))
        coords = api.parse_coords(labels.get(api.LABEL_TPU_COORDS))
        if dims is None or coords is None:
            return None
        if any(c >= d for c, d in zip(coords, dims)):
            return None
        return name, coords, dims

    @staticmethod
    def _node_free(st: _NodeState) -> bool:
        return st.requested.get(api.PODS, 0) == 0

    def _slice_grids(self):
        """(cells, dims, free_nodes): per-slice coordinate→free map (a
        coordinate shared by several nodes/cores is free only when all
        are), declared extents, and free NODE counts (the best-fit
        leftover signal)."""
        cells: Dict[str, Dict[tuple, bool]] = {}
        dims_of: Dict[str, tuple] = {}
        free_nodes: Dict[str, int] = {}
        for st, info in zip(self.states, self._slice_infos):
            if info is None:
                continue
            name, coords, dims = info
            free = self._node_free(st)
            d = cells.setdefault(name, {})
            d[coords] = d.get(coords, True) and free
            prev = dims_of.get(name, (0, 0, 0))
            dims_of[name] = tuple(max(a, b) for a, b in zip(prev, dims))
            free_nodes[name] = free_nodes.get(name, 0) + (1 if free else 0)
        return cells, dims_of, free_nodes

    def _corner_ok(self, cells, dims_of, info, shape) -> bool:
        name, (x, y, z), _dims = info
        dx, dy, dz = dims_of[name]
        a, b, c = shape
        if x + a > dx or y + b > dy or z + c > dz:
            return False
        grid = cells[name]
        for i in range(x, x + a):
            for j in range(y, y + b):
                for k in range(z, z + c):
                    if not grid.get((i, j, k), False):
                        return False
        return True

    def _carveout_ctx(self, pod: api.Pod):
        """Per-cycle carve-out context: (shape, anchored carve-out or
        None, grids) — None when the family is off for this pod."""
        if self.slice_policy == "off" or not self._has_slices:
            return None
        shape = api.parse_topology(pod.spec.tpu_topology)
        if shape is None:
            return None
        group = pod.spec.scheduling_group
        carve = self._gang_carve.get(group) if group else None
        cells, dims_of, free_nodes = self._slice_grids()
        return {
            "shape": shape,
            "carve": carve,
            "cells": cells,
            "dims_of": dims_of,
            "free_nodes": free_nodes,
        }

    def _carveout_ok(self, st_idx: int, sctx) -> bool:
        """require-mode filter: anchors need a free-box corner, anchored
        members the carved cuboid."""
        info = self._slice_infos[st_idx]
        if sctx["carve"] is not None:
            sname, lo = sctx["carve"]
            if info is None or info[0] != sname:
                return False
            if not self._node_free(self.states[st_idx]):
                return False  # one member per device
            coords, shape = info[1], sctx["shape"]
            return all(
                l <= c < l + s for c, l, s in zip(coords, lo, shape)
            )
        if info is None or not self._node_free(self.states[st_idx]):
            return False
        return self._corner_ok(
            sctx["cells"], sctx["dims_of"], info, sctx["shape"]
        )

    def _carveout_bonus(self, st_idx: int, sctx) -> float:
        from ..ops.slices import (
            BONUS_CARVE, BONUS_SLICE, W_CORNER, W_HOP, W_LEFTOVER,
        )

        info = self._slice_infos[st_idx]
        shape = sctx["shape"]
        if sctx["carve"] is not None:
            if info is None or not self._node_free(self.states[st_idx]):
                return 0.0  # one member per device: occupied earns nothing
            sname, lo = sctx["carve"]
            name, coords, _dims = info
            if name != sname:
                return 0.0
            hop = sum(abs(c - l) for c, l in zip(coords, lo))
            if all(l <= c < l + s for c, l, s in zip(coords, lo, shape)):
                return BONUS_CARVE + BONUS_SLICE - W_HOP * hop
            return BONUS_SLICE - W_HOP * hop
        if (
            info is None
            or not self._node_free(self.states[st_idx])
            or not self._corner_ok(sctx["cells"], sctx["dims_of"], info, shape)
        ):
            return 0.0
        vol = shape[0] * shape[1] * shape[2]
        leftover = max(sctx["free_nodes"].get(info[0], 0) - vol, 0)
        coordsum = sum(info[1])
        return BONUS_CARVE - W_LEFTOVER * leftover - W_CORNER * coordsum

    def _record_carve(self, pod: api.Pod, st_idx: int, sctx) -> None:
        """Anchor the gang's carve-out at the first member's landing
        coordinates (only when the node is slice-labelled — an
        off-slice prefer-mode landing leaves the gang unanchored,
        matching the kernel's -1 sentinel write)."""
        group = pod.spec.scheduling_group
        if not group or sctx["carve"] is not None:
            return
        info = self._slice_infos[st_idx]
        if info is not None:
            self._gang_carve[group] = (info[0], info[1])

    # -- topology spread (filtering.go) ----------------------------------

    def _spread_eligible(self, pod: api.Pod, st: _NodeState) -> bool:
        """Node counted for the pod's spread constraints: passes the pod's
        node selector/affinity and has every constraint's topology key."""
        sel = pod.required_node_selector()
        if sel is not None and not sel.matches(st.node.meta.labels):
            return False
        return all(
            c.topology_key in st.node.meta.labels
            for c in pod.spec.topology_spread_constraints
        )

    def _spread_counts(self, pod: api.Pod, c: api.TopologySpreadConstraint):
        """(counts per topology value over eligible nodes, min count)."""
        sel = c.label_selector or api.LabelSelector()
        counts: Dict[str, int] = {}
        for st in self.states:
            if not self._spread_eligible(pod, st):
                continue
            val = st.node.meta.labels.get(c.topology_key)
            if val is None:
                continue
            counts.setdefault(val, 0)
            counts[val] += sum(
                1
                for q in st.pods
                if q.meta.namespace == pod.meta.namespace
                and sel.matches(q.meta.labels)
            )
        return counts, (min(counts.values()) if counts else 0)

    # -- inter-pod affinity (interpodaffinity/filtering.go) --------------

    @staticmethod
    def _term_matches(term: api.PodAffinityTerm, owner_ns: str, q: api.Pod) -> bool:
        namespaces = term.namespaces or [owner_ns]
        if q.meta.namespace not in namespaces:
            return False
        sel = term.label_selector or api.LabelSelector()
        return sel.matches(q.meta.labels)

    def _pod_context(self, pod: api.Pod) -> dict:
        """Node-independent per-cycle state, computed once per pod — the
        oracle's PreFilter.  Keeps _feasible O(1)-ish per node so parity
        tests stay O(N * pods) instead of O(N^2 * pods)."""
        ctx: dict = {}

        # spread: counts + min per hard constraint, self-match flags
        hard = [
            c
            for c in pod.spec.topology_spread_constraints
            if c.when_unsatisfiable == "DoNotSchedule"
        ]
        ctx["spread"] = []
        for c in hard:
            counts, min_match = self._spread_counts(pod, c)
            sel = c.label_selector or api.LabelSelector()
            self_match = 1 if sel.matches(pod.meta.labels) else 0
            ctx["spread"].append((c, counts, min_match, self_match))

        # existing pods' anti-affinity terms that match this pod:
        # (topologyKey, value) pairs that block it
        blockers = set()
        for other in self.states:
            for q in other.pods:
                qaff = q.spec.affinity
                for t in (
                    qaff.pod_anti_affinity.required
                    if qaff and qaff.pod_anti_affinity
                    else []
                ):
                    if not self._term_matches(t, q.meta.namespace, pod):
                        continue
                    qv = other.node.meta.labels.get(t.topology_key)
                    if qv is not None:
                        blockers.add((t.topology_key, qv))
        ctx["blockers"] = blockers

        # per own-term: topology values with a matching existing pod
        aff = pod.spec.affinity
        aff_terms = aff.pod_affinity.required if aff and aff.pod_affinity else []
        anti_terms = aff.pod_anti_affinity.required if aff and aff.pod_anti_affinity else []

        def values_with_match(t: api.PodAffinityTerm) -> Set[str]:
            vals = set()
            for other in self.states:
                ov = other.node.meta.labels.get(t.topology_key)
                if ov is None:
                    continue
                if any(
                    self._term_matches(t, pod.meta.namespace, q) for q in other.pods
                ):
                    vals.add(ov)
            return vals

        ctx["aff_terms"] = [(t, values_with_match(t)) for t in aff_terms]
        ctx["anti_terms"] = [(t, values_with_match(t)) for t in anti_terms]
        ctx["self_match"] = bool(aff_terms) and all(
            self._term_matches(t, pod.meta.namespace, pod) for t in aff_terms
        )
        return ctx

    def _spread_ok(self, pod: api.Pod, st: _NodeState, ctx: dict) -> bool:
        for c, counts, min_match, self_match in ctx["spread"]:
            val = st.node.meta.labels.get(c.topology_key)
            if val is None:
                return False
            if counts.get(val, 0) + self_match - min_match > c.max_skew:
                return False
        return True

    def _interpod_ok(self, pod: api.Pod, st: _NodeState, ctx: dict) -> bool:
        labels = st.node.meta.labels
        # 1. existing pods' anti-affinity vs the incoming pod
        for key, val in ctx["blockers"]:
            if labels.get(key) == val:
                return False
        # 2. incoming pod's anti-affinity
        for t, vals in ctx["anti_terms"]:
            v = labels.get(t.topology_key)
            if v is not None and v in vals:
                return False
        # 3. incoming pod's affinity (with first-pod escape)
        if ctx["aff_terms"]:
            if any(t.topology_key not in labels for t, _ in ctx["aff_terms"]):
                return False
            all_here = all(
                labels[t.topology_key] in vals for t, vals in ctx["aff_terms"]
            )
            if not all_here:
                none_anywhere = all(not vals for _, vals in ctx["aff_terms"])
                if not (none_anywhere and ctx["self_match"]):
                    return False
        return True

    # -- filter ----------------------------------------------------------

    def _feasible(self, pod: api.Pod, st: _NodeState, ctx: dict) -> bool:
        req = _units(pod.resource_requests())
        req[api.PODS] = req.get(api.PODS, 0) + 1
        for k, v in req.items():
            if v == 0:
                continue
            if st.requested.get(k, 0) + v > st.allocatable.get(k, 0):
                return False
        if not self._static_ok(pod, st):
            return False
        for proto, _ip, port in pod.host_ports():
            if (proto, port) in st.used_ports:
                return False
        if not self._spread_ok(pod, st, ctx):
            return False
        if not self._interpod_ok(pod, st, ctx):
            return False
        return True

    # -- score -----------------------------------------------------------

    def _fit_score(self, pod: api.Pod, st: _NodeState) -> int:
        nz_cpu, nz_mem = pod.nonzero_requests()
        pod_nz = {api.CPU: nz_cpu, api.MEMORY: nz_mem / DEVICE_UNIT_DIVISOR[api.MEMORY]}
        total = wsum = 0
        for res in (api.CPU, api.MEMORY):
            cap = st.allocatable.get(res, 0)
            if cap <= 0:
                continue
            q = st.nonzero_requested.get(res, 0) + pod_nz[res]
            if self.fit_strategy == "MostAllocated":
                s = math.floor(q * MAX_SCORE / cap) if q <= cap else 0
            else:
                s = math.floor((cap - q) * MAX_SCORE / cap) if q <= cap else 0
            total += s
            wsum += 1
        return math.floor(total / wsum) if wsum else 0

    def _balanced_score(self, pod: api.Pod, st: _NodeState) -> int:
        req = _units(pod.resource_requests())
        fracs = []
        for res in (api.CPU, api.MEMORY):
            cap = st.allocatable.get(res, 0)
            if cap <= 0:
                continue
            f = (st.requested.get(res, 0) + req.get(res, 0)) / cap
            fracs.append(min(f, 1.0))
        if len(fracs) < 2:
            std = 0.0
        else:
            mean = sum(fracs) / len(fracs)
            std = math.sqrt(sum((f - mean) ** 2 for f in fracs) / len(fracs))
        return math.floor((1 - std) * MAX_SCORE)

    @staticmethod
    def _affinity_raw(pod: api.Pod, st: _NodeState) -> int:
        return sum(
            t.weight
            for t in pod.preferred_node_affinity()
            if t.preference.matches(st.node.meta.labels)
        )

    @staticmethod
    def _taint_raw(pod: api.Pod, st: _NodeState) -> int:
        return sum(
            1
            for t in st.node.effective_taints()
            if t.effect == api.PREFER_NO_SCHEDULE
            and not api.tolerations_tolerate_taint(pod.spec.tolerations, t)
        )

    @staticmethod
    def _normalize(raws: List[int], reverse: bool = False) -> List[int]:
        m = max(raws) if raws else 0
        if m == 0:
            return [MAX_SCORE if reverse else 0 for _ in raws]
        out = [math.floor(MAX_SCORE * r / m) for r in raws]
        if reverse:
            out = [MAX_SCORE - s for s in out]
        return out

    def _spread_scores(self, pod: api.Pod, feasible: List[Tuple[int, _NodeState]]) -> List[int]:
        """PodTopologySpread soft-constraint scores, normalized
        (scoring.go Score + NormalizeScore)."""
        soft = [
            c
            for c in pod.spec.topology_spread_constraints
            if c.when_unsatisfiable == "ScheduleAnyway"
        ]
        if not soft:
            return [0] * len(feasible)
        ignored = [
            any(c.topology_key not in st.node.meta.labels for c in soft)
            for _, st in feasible
        ]
        raws: List[Optional[int]] = []
        counts = {id(c): self._spread_counts(pod, c)[0] for c in soft}
        # Distinct values over *eligible* nodes, matching the kernel's
        # prep-time sizes (the reference uses the per-cycle feasible set;
        # see ops/topology.py spread_score for why this is equivalent in
        # the single-constraint case).
        sizes = {
            id(c): len(
                {
                    st.node.meta.labels[c.topology_key]
                    for st in self.states
                    if self._spread_eligible(pod, st)
                    and c.topology_key in st.node.meta.labels
                }
            )
            for c in soft
        }
        for (_, st), ign in zip(feasible, ignored):
            if ign:
                raws.append(None)
                continue
            s = 0.0
            for c in soft:
                val = st.node.meta.labels[c.topology_key]
                cnt = counts[id(c)].get(val, 0)
                s += cnt * math.log(sizes[id(c)] + 2) + (c.max_skew - 1)
            raws.append(round(s))
        valid = [r for r in raws if r is not None]
        mx, mn = (max(valid), min(valid)) if valid else (0, 0)
        out = []
        for r in raws:
            if r is None:
                out.append(0)
            elif mx <= 0:
                out.append(MAX_SCORE)
            else:
                out.append(math.floor(MAX_SCORE * (mx + mn - r) / mx))
        return out

    # -- cycle -----------------------------------------------------------

    def schedule_one(self, pod: api.Pod) -> Optional[str]:
        ctx = self._pod_context(pod)
        sctx = self._carveout_ctx(pod)
        feasible = [
            (i, st)
            for i, st in enumerate(self.states)
            if self._feasible(pod, st, ctx)
            and (
                sctx is None
                or self.slice_policy != "require"
                or self._carveout_ok(i, sctx)
            )
        ]
        if not feasible:
            return None
        aff = self._normalize([self._affinity_raw(pod, st) for _, st in feasible])
        taint = self._normalize([self._taint_raw(pod, st) for _, st in feasible], reverse=True)
        spread = self._spread_scores(pod, feasible)
        best_i, best_score = None, None
        for j, (i, st) in enumerate(feasible):
            score = (
                1 * self._fit_score(pod, st)
                + 1 * self._balanced_score(pod, st)
                + 2 * aff[j]
                + 3 * taint[j]
                + 2 * spread[j]
            )
            if sctx is not None:
                score += self._carveout_bonus(i, sctx)
            if best_score is None or score > best_score:
                best_i, best_score = i, score
        st = self.states[best_i]
        st.add_pod(pod)
        if sctx is not None:
            self._record_carve(pod, best_i, sctx)
        return st.node.meta.name

    def schedule(self, pods: Sequence[api.Pod]) -> List[Optional[str]]:
        return [self.schedule_one(p) for p in pods]

    # -- preemption (scheduler/preemption.py policy mirror) ---------------

    def _static_ok(self, pod: api.Pod, st: _NodeState) -> bool:
        """Non-resource, placement-independent filters only — the slice
        the preemption dry-run keeps (eviction can't change these)."""
        if pod.spec.node_name and pod.spec.node_name != st.node.meta.name:
            return False
        for taint in st.node.effective_taints():
            if taint.effect in (api.NO_SCHEDULE, api.NO_EXECUTE):
                if not api.tolerations_tolerate_taint(pod.spec.tolerations, taint):
                    return False
        sel = pod.required_node_selector()
        if sel is not None and not sel.matches(st.node.meta.labels):
            return False
        return True

    def preempt(self, pod: api.Pod):
        """Victim-selection oracle mirroring the documented policy of
        kubernetes_tpu.scheduler.preemption: per node, evict the minimal
        lowest-priority-first prefix that admits the pod (resource math
        only, over static-feasible nodes); across nodes, pick
        lexicographically by (highest victim priority, priority sum,
        victim count, node index).  Returns (node_name, [victim pods]) or
        None."""
        candidates = []
        pod_req = _units(pod.resource_requests())
        pod_req[api.PODS] = pod_req.get(api.PODS, 0) + 1
        for idx, st in enumerate(self.states):
            if not self._static_ok(pod, st):
                continue
            victims = sorted(
                (q for q in st.pods if q.spec.priority < pod.spec.priority),
                key=lambda q: (q.spec.priority, f"{q.meta.namespace}/{q.meta.name}"),
            )
            if not victims:
                continue
            freed: Dict[str, float] = {}
            chosen = None
            for k in range(len(victims) + 1):
                fits = all(
                    v <= 0
                    or st.requested.get(res, 0) - freed.get(res, 0) + v
                    <= st.allocatable.get(res, 0)
                    for res, v in pod_req.items()
                )
                if fits:
                    chosen = k
                    break
                if k < len(victims):
                    vreq = _units(victims[k].resource_requests())
                    vreq[api.PODS] = vreq.get(api.PODS, 0) + 1
                    for res, v in vreq.items():
                        freed[res] = freed.get(res, 0) + v
            if chosen is None or chosen == 0:
                continue
            evicted = victims[:chosen]
            candidates.append(
                (
                    max(q.spec.priority for q in evicted),
                    sum(q.spec.priority for q in evicted),
                    len(evicted),
                    idx,
                    st.node.meta.name,
                    evicted,
                )
            )
        if not candidates:
            return None
        candidates.sort(key=lambda c: c[:4])
        _, _, _, _, name, evicted = candidates[0]
        return name, evicted
