"""Drive the torch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py

Phases (one JSON line each on stdout):

  build      build the six CUDA kernels from kubernetes_tpu_torch/csrc
  parity     each kernel against its plain torch version on the card, exact,
             on mixed small batches (selectors, taints, ports, gangs, all
             three fit strategies): the greedy scan; the wavefront with the
             planner's waves and with random partitions (coupled waves and
             fit flips); the auction's two kernels round by round and the
             whole enqueued round loop, on batches without in-batch ports
  main       SchedulingBasic/5000Nodes through TorchBatchScheduler() on its
             default route: 5,000 nodes, 1,000 init pods scheduled and
             assumed, then a measured 1,000-pod batch; both pad to 1,024
             pods and take the auction
  greedy     the same measured batch through TorchBatchScheduler(
             mode="greedy", use_wavefront=False): the classic scan
  wavefront  SchedulingNodeAffinity/5000Nodes: 5,000 nodes, 1,000 init and
             1,000 measured pods with a required zone affinity, in batches
             of 500 (padded to 512: the wavefront route)
  kernels    each kernel against its plain version at the shapes of the
             phase that launches it, exact, timed with CUDA events, with
             the bound of its work on this run's data
  small      SchedulingBasic/500Nodes on the card against the plain path on
             the CPU, default route: identical placements and scores
  north      one 10,000-pod batch onto 50,000 nodes (the auction)

In main, greedy and wavefront the launch counters are reset just before
the phase and read just after; each phase fails unless every kernel of
its route was launched and no kernel of another route was.  Then the
card's name and power limit, the `kernels` summary object, and as the
last line {"ok": true, "device": {...}}.  Any failed check raises and the
script exits non-zero; with no CUDA device it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

# SchedulingBasic templates (kubernetes_tpu/perf/config: node-default.yaml,
# pod-default.yaml): 4 CPU / 32Gi / 110 pods, zone-$index_mod8; 100m / 500Mi
NODE_CPU_MILLI, NODE_MEM_GI, NODE_PODS, ZONES = 4000, 32, 110, 8
POD_CPU_MILLI, POD_MEM_MI = 100, 500
# SchedulingBasic/5000Nodes and /500Nodes (performance-config.yaml:23-28),
# and the north-star batch (BASELINE.json): (nodes, init pods, measured pods)
MAIN = (5000, 1000, 1000)
SMALL = (500, 500, 1000)
NORTH = (50000, 0, 10000)
# SchedulingNodeAffinity/5000Nodes (performance-config.yaml:90-112,
# pod-with-node-affinity.yaml: required zone In [zone-1, zone-2]), solved in
# batches of 500 (the scheduler's batchSize knob, scheduler/config.py)
AFFINITY = (5000, 1000, 1000)
AFFINITY_BATCH = 500
AFFINITY_ZONES = ("zone-1", "zone-2")

# H100 SXM published peaks (NVIDIA data sheet: HBM3 rate, non-tensor float32 rate)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

SOURCES = {
    "match_terms": ("kubernetes_tpu_torch/csrc/match_terms.cu",
                    "kubernetes_tpu/ops/filters.py:88"),
    "class_statics": ("kubernetes_tpu_torch/csrc/class_statics.cu",
                      "kubernetes_tpu/ops/assign.py:316"),
    "greedy_scan": ("kubernetes_tpu_torch/csrc/greedy_scan.cu",
                    "kubernetes_tpu/ops/assign.py:591"),
    "wavefront": ("kubernetes_tpu_torch/csrc/wavefront.cu",
                  "kubernetes_tpu/ops/assign.py:1090"),
    "auction_bids": ("kubernetes_tpu_torch/csrc/auction_bids.cu",
                     "kubernetes_tpu/ops/auction.py:355"),
    "auction_accept": ("kubernetes_tpu_torch/csrc/auction_accept.cu",
                       "kubernetes_tpu/ops/auction.py:680"),
}

# the kernels each route launches (match_terms and class_statics: all)
ROUTE_KERNELS = {
    "greedy": ("match_terms", "class_statics", "greedy_scan"),
    "wavefront": ("match_terms", "class_statics", "wavefront"),
    "auction": ("match_terms", "class_statics", "auction_bids", "auction_accept"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def make_cluster(wrappers, n_nodes: int, prefix: str = "node"):
    gi = wrappers.GI
    return [
        wrappers.make_node(f"{prefix}-{i}")
        .capacity(cpu_milli=NODE_CPU_MILLI, mem=NODE_MEM_GI * gi, pods=NODE_PODS)
        .zone(f"zone-{i % ZONES}")
        .obj()
        for i in range(n_nodes)
    ]


def make_pods(wrappers, n_pods: int, prefix: str):
    mi = wrappers.MI
    return [
        wrappers.make_pod(f"{prefix}-{i}")
        .req(cpu_milli=POD_CPU_MILLI, mem=POD_MEM_MI * mi)
        .obj()
        for i in range(n_pods)
    ]


def cuda_ms(fn, iters: int, torch) -> float:
    """Mean milliseconds of fn() on the card: CUDA events around `iters`
    launches after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def max_abs_err(a, b, torch) -> float:
    """Largest |a - b| over matching outputs (0.0 when equal; inf when
    infinities or non-finite entries differ)."""
    worst = 0.0
    for x, y in zip(a, b):
        if x.dtype == torch.bool:
            x, y = x.to(torch.int32), y.to(torch.int32)
        x, y = x.double(), y.double()
        fin = torch.isfinite(x) & torch.isfinite(y)
        if not torch.equal(torch.isfinite(x), torch.isfinite(y)) or not torch.equal(x[~fin], y[~fin]):
            return float("inf")
        if fin.any():
            worst = max(worst, float((x[fin] - y[fin]).abs().max()))
    return worst


def check_equal(name: str, got, want, torch) -> float:
    err = max_abs_err(got, want, torch)
    same = all(torch.equal(x, y) for x, y in zip(got, want))
    if not same or err != 0.0:
        raise AssertionError(f"kernel {name} differs from its plain version: max_abs_err {err}")
    return err


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def match_terms_need(n: int, expr_ids, expr_op, expr_slot, term_valid, torch) -> tuple:
    """(bytes, operations) one match_terms launch needs on this data: the
    table, the output, and per node the label words and topology ids that
    the valid expressions test (two integer operations per tested id)."""
    live = term_valid[:, :, None] & ((expr_op == 1) | (expr_op == 2))
    ids = expr_ids[live]                      # [M, K]
    slots = expr_slot[live]                   # [M]
    label = ids[(slots < 0)[:, None].expand_as(ids) & (ids >= 0)]
    words = int(torch.unique(label >> 5).numel()) if label.numel() else 0
    topo = int(torch.unique(slots[slots >= 0]).numel())
    need = (nbytes(expr_ids, expr_op, expr_slot, term_valid)
            + n * 4 * (words + topo) + term_valid.shape[0] * n)
    ops = n * int((ids != -1).sum()) * 2
    return need, ops


def class_statics_need(cluster, pods, reps, torch) -> tuple:
    """(bytes, operations) one class_statics launch needs on this data: the
    representatives' pod fields; per node the valid byte, the name id only
    where a class pins a node, the taint words of each effect that some
    class does not tolerate wholesale, the port words that some class
    claims (a zero claim word conflicts with nothing), one byte of each
    selector and preferred mask row a class reads; the three [C, N]
    outputs.  Two integer operations a tested word or live term."""
    n = cluster.node_valid.shape[0]
    c = reps.shape[0]
    r = reps.long()
    tw = cluster.taint_bits.shape[2]
    mt = pods.pref_idx.shape[1]
    pod_bytes = nbytes(reps, pods.valid[r], pods.name_id[r], pods.sel_idx[r],
                       pods.tol_bits[:, r], pods.tol_all[:, r], pods.port_bits[r],
                       pods.pref_idx[r], pods.pref_weight[r])
    effects = int((~pods.tol_all[:, r]).any(dim=1).sum())
    port_words = int((pods.port_bits[r] != 0).any(dim=0).sum())
    sel = pods.sel_idx[r]
    sel_rows = int(torch.unique(sel[sel >= 0]).numel())
    pref = pods.pref_idx[r]
    live_pref = pref >= 0
    pref_rows = int(torch.unique(pref[live_pref]).numel())
    names = n * 4 if bool((pods.name_id[r] != -1).any()) else 0
    node_bytes = n * (1 + 4 * effects * tw + 4 * port_words + sel_rows + pref_rows) + names
    need = pod_bytes + node_bytes + c * n * 9
    per_class = (2 * tw * int((~pods.tol_all[:, r]).sum())
                 + 2 * port_words * c + 2 * int(live_pref.sum()) + 8 * c)
    return need, n * per_class


def greedy_scan_need(cluster, pods, sfeas, feas_counts, features, torch) -> tuple:
    """Bytes: inputs once, outputs once.  Operations: per step, the
    fit test on every static-feasible node (2 flops a resource the pod
    requests; a resource it does not request is not tested) and the
    ~60 flops of the scores on every feasible node (LeastAllocated and
    BalancedAllocation over cpu+memory, two normalisations, the sum)."""
    n, r = cluster.allocatable.shape
    p = pods.req.shape[0]
    ins = nbytes(cluster.allocatable, cluster.requested, cluster.nonzero_requested,
                 sfeas, pods.req, pods.nonzero_req, pods.class_id, pods.priority)
    ins += 2 * sfeas.numel() * 4  # aff, taint rows
    outs = p * 16 + 2 * n * r * 4
    if features.ports:
        ins += nbytes(cluster.port_bits, pods.port_bits)
        outs += nbytes(cluster.port_bits)
    static_rows = sfeas.sum(dim=1).to(torch.float64)
    per_pod_static = static_rows[torch.clamp(pods.class_id.long(), 0, sfeas.shape[0] - 1)]
    tested = (pods.req > 0).sum(dim=1).to(torch.float64)
    ops = float((per_pod_static * 2 * tested).sum()) + float(feas_counts.double().sum()) * 60
    return ins + outs, ops


def auction_bids_need(cluster, pods, st, requested, tie_k, torch) -> tuple:
    """(bytes, operations) one bidding round needs on this data: the
    resource rows, the spec classes' static, affinity and taint rows, the
    pods' class, validity, assignment and solve order, the bids out and the
    tie lists out.  Operations: per class the fit test on its static-feasible
    nodes (2 flops a requested resource), ~60 flops of scores on each
    feasible node, 4 integer operations of hash on each tie node; per pod
    4 (a counting pass for its position in its class)."""
    n, r = cluster.allocatable.shape
    p = pods.req.shape[0]
    c = st.jspec.shape[0]
    ins = nbytes(cluster.allocatable, requested, cluster.nonzero_requested,
                 st.sfeas_s, st.aff_s, st.taint_s, pods.class_id, pods.valid, st.order)
    ins += p * 4  # assignment
    outs = p * 8 + c * (tie_k * 4 + 8)
    ops = 0.0
    for s, rep in enumerate(st.s_reps.tolist()):
        stat = st.sfeas_s[s]
        tested = int((pods.req[rep] > 0).sum())
        fits = ((pods.req[rep][None, :] <= 0)
                | (requested + pods.req[rep][None, :] <= cluster.allocatable)).all(dim=1)
        n_static = int(stat.sum())
        n_feas = int((stat & fits).sum())
        per_joint = int((st.jspec == s).sum())
        ops += per_joint * (n_static * 2 * tested + n_feas * 60 + n_feas * 4)
    return ins + outs, ops + p * 4


def auction_accept_need(cluster, pods, bid, torch) -> tuple:
    """(bytes, operations) one acceptance round needs: the bids, values,
    solve order, requests and validity of every pod; allocatable and the
    two usage rows of every node bid on, read and written once; the pods'
    assignment and score in and out.  Operations: a stable sort of the P
    bids (P log2 P comparisons), the prefix, the capacity test and the
    commit (about 5 flops a pod and resource)."""
    import math

    n, r = cluster.allocatable.shape
    p = bid.shape[0]
    nodes = int(torch.unique(bid[bid < n]).numel())
    ins = nbytes(bid, pods.req, pods.nonzero_req, pods.valid) + p * 4 * 4
    rows = nodes * r * 4 * (1 + 2 * 2)
    outs = p * 8
    ops = p * max(1, math.ceil(math.log2(max(p, 2)))) + 5 * p * r
    return ins + rows + outs, float(ops)


def solve_order_need(pods) -> tuple:
    """torch.argsort(-priority, stable=True): P floats in, P indices out,
    P log2 P comparisons."""
    import math

    p = pods.priority.shape[0]
    return p * 8, float(p * max(1, math.ceil(math.log2(max(p, 2)))))


def bound(need_bytes: float, ops: float) -> tuple:
    t_bytes = need_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def drive_phase(name, route, fn, bindings):
    """Run fn() with every launch counter at 0 and check the counters just
    after: every kernel of `route` launched, none of another route."""
    import torch

    torch.cuda.synchronize()
    bindings.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    launches = dict(bindings.LAUNCHES)
    for k in ROUTE_KERNELS[route]:
        if launches[k] <= 0:
            raise AssertionError(f"phase {name}: kernel {k} was not launched")
    others = {k for r, ks in ROUTE_KERNELS.items() if r != route for k in ks}
    for k in others - set(ROUTE_KERNELS[route]):
        if launches[k]:
            raise AssertionError(f"phase {name}: kernel {k} of another route was launched")
    return out, launches


def affinity_pods(wrappers, n_pods: int, prefix: str):
    api = wrappers.api
    mi = wrappers.MI
    return [
        wrappers.make_pod(f"{prefix}-{i}")
        .req(cpu_milli=POD_CPU_MILLI, mem=POD_MEM_MI * mi)
        .required_affinity(api.LABEL_ZONE, api.OP_IN, list(AFFINITY_ZONES))
        .obj()
        for i in range(n_pods)
    ]


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 3
    try:
        from kubernetes_tpu_torch.kernels import bindings, build
        from kubernetes_tpu_torch.models.batch_scheduler import TorchBatchScheduler
        from kubernetes_tpu_torch.ops import assign, auction, device as dv, filters
        from kubernetes_tpu_torch.testing import wrappers
    except ImportError as exc:
        print(f"chip_smoke: the kubernetes_tpu_torch package is missing ({exc})",
              file=sys.stderr)
        return 4

    card = card_line()
    kind = torch.cuda.get_device_name(0)

    # ---- build --------------------------------------------------------
    t0 = time.perf_counter()
    secs = build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_kernel_s": secs, "card": card})

    # ---- parity on mixed small batches ------------------------------------
    import numpy as np
    from kubernetes_tpu_torch.ops import schema, scores
    from kubernetes_tpu_torch.testing.cases import (
        capacity_edge_objects, contended_objects, fractional_mix_objects,
        gang_objects, mixed_objects,
    )

    cfgs = (
        scores.ScoreConfig(),
        scores.ScoreConfig(fit_strategy="MostAllocated"),
        scores.ScoreConfig(
            fit_strategy="RequestedToCapacityRatio",
            rtcr_shape=((0.0, 0.0), (50.0, 7.0), (100.0, 10.0)),
        ),
    )
    checked = {"greedy": 0, "wavefront": 0, "auction": 0, "rounds": 0}
    fallbacks = 0
    for seed in range(6):
        nodes, pending, bound_pods = mixed_objects(wrappers, seed)
        snap, _meta = schema.SnapshotBuilder().build(nodes, pending, bound_pods=bound_pods)
        cfg = cfgs[seed % 3]
        ts = dv.to_device(snap, "cuda")
        features = assign.features_of(snap)
        n_groups = int(snap.pods.group_id.max()) + 1
        run_kernels(ts, features, n_groups, cfg, assign, filters, bindings, torch)
        checked["greedy"] += 1
        rng = np.random.default_rng(seed)
        for members in (assign.plan_waves(snap, features, 8).members,
                        random_partition(snap, rng, 8, np),
                        random_partition(snap, rng, 32, np)):
            fallbacks += run_wavefront(ts, features, n_groups, cfg, members, assign, bindings, torch)
            checked["wavefront"] += 1
        for p in pending:  # in-batch ports route away from the auction
            p.spec.containers[0].ports = []
        snap, _meta = schema.SnapshotBuilder().build(nodes, pending, bound_pods=bound_pods)
        checked["rounds"] += run_auction(dv.to_device(snap, "cuda"), cfg, None, auction, bindings, torch)
        checked["auction"] += 1
    for (nodes, pending, _b), tie_k, on_cpu in (
            (contended_objects(wrappers, 32, 256, 16), None, False),
            (contended_objects(wrappers, 10, 300, 20), None, False),
            (contended_objects(wrappers, 24, 96, 110), 8, False),
            (gang_objects(wrappers), None, False),
            # requests that are not whole MiB, sums past float32's exact
            # range: the prefix's and the commit's order of additions show
            (capacity_edge_objects(wrappers, 64, 1000, 10), None, True),
            (fractional_mix_objects(wrappers, 0), None, True)):
        snap, _meta = schema.SnapshotBuilder().build(nodes, pending)
        checked["rounds"] += run_auction(dv.to_device(snap, "cuda"), cfgs[0], tie_k, auction,
                                         bindings, torch,
                                         cpu_snap=dv.to_device(snap, "cpu") if on_cpu else None)
        checked["auction"] += 1
    torch.cuda.synchronize()
    if not fallbacks:
        raise AssertionError("parity: no wavefront fallback was exercised")
    emit({"phase": "parity", "cases": checked, "wavefront_fallbacks": fallbacks, "exact": True})

    # ---- main path: SchedulingBasic/5000Nodes, default route ---------------
    sched = TorchBatchScheduler()
    for node in make_cluster(wrappers, MAIN[0]):
        sched.add_node(node)
    init_pods = make_pods(wrappers, MAIN[1], "init")
    measured = make_pods(wrappers, MAIN[2], "measured")
    # the measured batch's snapshot as the main path will encode it, kept
    # for the kernel comparison (an encode launches no kernel)
    timing = {}

    def run_main():
        t = time.perf_counter()
        init_names = sched.schedule_pending(init_pods)
        timing["init_s"] = time.perf_counter() - t
        timing["init_rounds"] = int(sched.last_result.rounds)
        for pod, name in zip(init_pods, init_names):
            if name is None:
                raise AssertionError(f"init pod {pod.meta.name} was not placed")
            sched.assume(pod, name)
        timing["snap"] = sched.encode_pending(measured)
        if timing["snap"][1].route != "auction":
            raise AssertionError(f"main: measured batch took route {timing['snap'][1].route}")
        torch.cuda.synchronize()
        t = time.perf_counter()
        names = sched.schedule_pending(measured)
        timing["measured_s"] = time.perf_counter() - t
        return init_names, names

    (init_names, names), main_launches = drive_phase("main", "auction", run_main, bindings)
    if any(n is None for n in names):
        raise AssertionError("a measured pod was not placed")
    rounds = int(sched.last_result.rounds)
    for pod, name in zip(measured, names):
        sched.assume(pod, name)
    check_capacity(sched.state)
    snap_k, meta_k = timing["snap"]
    emit({"phase": "main", "workload": "SchedulingBasic/5000Nodes", "route": "auction",
          "placed": len(names) + len(init_names),
          "init_s": timing["init_s"], "measured_s": timing["measured_s"],
          "pods_per_s": len(measured) / timing["measured_s"],
          "rounds": rounds, "init_rounds": timing["init_rounds"], "tie_k": meta_k.tie_k,
          "last_timings": sched.last_timings, "launches": main_launches,
          "card": card})

    # ---- the greedy scan on the same measured batch ------------------------
    gsched = TorchBatchScheduler(mode="greedy", use_wavefront=False)
    for node in make_cluster(wrappers, MAIN[0]):
        gsched.add_node(node)
    for pod, name in zip(init_pods, init_names):
        gsched.assume(pod, name)
    _gsnap, gmeta = gsched.encode_pending(measured)  # same state and pods as snap_k

    def run_greedy():
        t = time.perf_counter()
        out = gsched.schedule_pending(measured)
        timing["greedy_s"] = time.perf_counter() - t
        return out

    gnames, greedy_launches = drive_phase("greedy", "greedy", run_greedy, bindings)
    if gmeta.route != "greedy" or any(n is None for n in gnames):
        raise AssertionError("greedy: wrong route or an unplaced pod")
    emit({"phase": "greedy", "workload": "SchedulingBasic/5000Nodes (measured batch)",
          "route": "greedy", "measured_s": timing["greedy_s"],
          "pods_per_s": len(measured) / timing["greedy_s"],
          "last_timings": gsched.last_timings, "launches": greedy_launches,
          "card": card})

    # ---- the wavefront: SchedulingNodeAffinity/5000Nodes -------------------
    wsched = TorchBatchScheduler()
    for node in make_cluster(wrappers, AFFINITY[0]):
        wsched.add_node(node)
    w_init = affinity_pods(wrappers, AFFINITY[1], "aff-init")
    w_meas = affinity_pods(wrappers, AFFINITY[2], "aff-measured")
    zone_of = {f"node-{i}": f"zone-{i % ZONES}" for i in range(AFFINITY[0])}
    wave = {"batches": []}

    def run_wavefront_phase():
        for label, pods in (("init", w_init), ("measured", w_meas)):
            for lo in range(0, len(pods), AFFINITY_BATCH):
                batch = pods[lo : lo + AFFINITY_BATCH]
                snap_w, meta_w = wsched.encode_pending(batch)
                if meta_w.route != "wavefront":
                    raise AssertionError(f"wavefront: a batch took route {meta_w.route}")
                if label == "measured" and "snap" not in wave:
                    wave["snap"] = (snap_w, meta_w)
                torch.cuda.synchronize()
                t = time.perf_counter()
                got = wsched.schedule_pending(batch)
                dt = time.perf_counter() - t
                for pod, name in zip(batch, got):
                    if name is None or zone_of[name] not in AFFINITY_ZONES:
                        raise AssertionError(f"wavefront: {pod.meta.name} placed on {name}")
                    wsched.assume(pod, name)
                wave["batches"].append({
                    "batch": label, "pods": len(batch), "s": dt,
                    "wave_count": wsched.last_solve.wave_count,
                    "wave_fallbacks": wsched.last_solve.wave_fallbacks,
                    "solve_s": wsched.last_timings["solve_s"],
                    "encode_s": wsched.last_timings["encode_s"],
                })

    _, wave_launches = drive_phase("wavefront", "wavefront", run_wavefront_phase, bindings)
    check_capacity(wsched.state)
    meas = [b for b in wave["batches"] if b["batch"] == "measured"]
    meas_s = sum(b["s"] for b in meas)
    emit({"phase": "wavefront", "workload": "SchedulingNodeAffinity/5000Nodes",
          "route": "wavefront", "batch_size": AFFINITY_BATCH, "batches": wave["batches"],
          "measured_s": meas_s, "pods_per_s": AFFINITY[2] / meas_s,
          "launches": wave_launches, "card": card})

    # ---- each kernel against its plain version at its phase's shapes -------
    summary = run_kernels(
        snap_k, meta_k.features, meta_k.n_groups, sched.score_config,
        assign, filters, bindings, torch, timed=True,
    )
    snap_w, meta_w = wave["snap"]
    summary.append(run_wavefront(
        snap_w, meta_w.features, meta_w.n_groups, wsched.score_config,
        meta_w.wave_plan.members, assign, bindings, torch, timed=True,
    ))
    summary.extend(run_auction(
        snap_k, sched.score_config, meta_k.tie_k, auction, bindings, torch, timed=True,
    ))
    launches_of = {"greedy_scan": greedy_launches, "wavefront": wave_launches}
    for row in summary:
        row["launches"] = launches_of.get(row["name"], main_launches)[row["name"]]
    order_ms = cuda_ms(lambda: assign.solve_order(snap_k.pods), 50, torch)
    order_bound = bound(*solve_order_need(snap_k.pods))
    emit({"phase": "kernels", "card": card,
          "shapes": {"match_terms, class_statics, auction_*": "SchedulingBasic/5000Nodes measured batch",
                     "greedy_scan": "the same batch, mode=greedy",
                     "wavefront": "SchedulingNodeAffinity/5000Nodes first measured batch"},
          "kernels": [dict({k: row[k] for k in ("name", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms")},
                           equal=True) for row in summary],
          "solve_order": {"ms": order_ms, "bound_ms": order_bound[0], "bound_by": order_bound[1]}})

    # ---- small input against the plain path on the CPU ------------------
    small = {}
    for dev in ("cuda", "cpu"):
        s = TorchBatchScheduler(device=dev)
        for node in make_cluster(wrappers, SMALL[0]):
            s.add_node(node)
        first = make_pods(wrappers, SMALL[1], "init")
        got = s.schedule_pending(first)
        routes = [type(s.last_result).__name__]
        for pod, name in zip(first, got):
            s.assume(pod, name)
        second = s.schedule_pending(make_pods(wrappers, SMALL[2], "measured"))
        routes.append(type(s.last_result).__name__)
        small[dev] = (got, second, s.last_result.scores.cpu(), routes)
    if small["cuda"][:2] != small["cpu"][:2] or not torch.equal(small["cuda"][2], small["cpu"][2]):
        raise AssertionError("SchedulingBasic/500Nodes: card and CPU placements differ")
    emit({"phase": "small", "workload": "SchedulingBasic/500Nodes",
          "results": small["cuda"][3],
          "placements_equal_cpu": True, "placed": sum(n is not None for n in small["cuda"][1])})

    # ---- north star: 10,000 pods onto 50,000 nodes -------------------------
    big = TorchBatchScheduler()
    t0 = time.perf_counter()
    for node in make_cluster(wrappers, NORTH[0]):
        big.add_node(node)
    t_nodes = time.perf_counter() - t0
    pods = make_pods(wrappers, NORTH[2], "burst")

    def run_north():
        t = time.perf_counter()
        out = big.schedule_pending(pods)
        timing["north_s"] = time.perf_counter() - t
        return out

    got, north_launches = drive_phase("north", "auction", run_north, bindings)
    if any(n is None for n in got):
        raise AssertionError("north star: a pod was not placed")
    north_rounds = int(big.last_result.rounds)
    for pod, name in zip(pods, got):
        big.assume(pod, name)
    check_capacity(big.state)
    emit({"phase": "north", "nodes": NORTH[0], "pods": NORTH[2], "route": "auction",
          "add_nodes_s": t_nodes, "batch_s": timing["north_s"],
          "pods_per_s": len(pods) / timing["north_s"], "rounds": north_rounds,
          "solve_s": big.last_timings["solve_s"], "last_timings": big.last_timings,
          "launches": north_launches, "card": card})

    print(card, flush=True)
    kernels = []
    for row in summary:
        src, replaces = SOURCES[row["name"]]
        kernels.append({
            "name": row["name"], "route": "cuda", "source": src,
            "replaces": replaces, "launches": row["launches"],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
        })
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


def check_capacity(state) -> None:
    """No node's accounted requests exceed its allocatable resources."""
    h = state._high
    over = state.requested[:h] > state.allocatable[:h]
    if over.any():
        rows = sorted(set(over.nonzero()[0].tolist()))[:5]
        raise AssertionError(f"nodes over allocatable: rows {rows}")


def random_partition(snap, rng, k: int, np):
    """A random contiguous partition of the solve order into waves of at
    most k pods (not the planner's: waves may couple through ports and
    flip fits)."""
    prio = np.asarray(snap.pods.priority)
    p = prio.shape[0]
    order = np.argsort(-prio, kind="stable").astype(np.int32)
    cuts = sorted(rng.choice(np.arange(1, p), size=min(4, p - 1), replace=False).tolist())
    chunks, start = [], 0
    for c in cuts + [p]:
        while c - start > k:
            chunks.append(order[start : start + k])
            start += k
        chunks.append(order[start:c])
        start = c
    chunks = [c for c in chunks if len(c)]
    members = np.full((max(8, 1 << (len(chunks) - 1).bit_length()), k), -1, dtype=np.int32)
    for wi, ch in enumerate(chunks):
        members[wi, : len(ch)] = ch
    return members


def time_plain(fn, torch) -> float:
    """Milliseconds of one host-timed run of a plain version on the card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def run_wavefront(snap, features, n_groups, cfg, members, assign, bindings, torch,
                  timed: bool = False):
    """Kernel wavefront against its plain version on the card (and the
    plain scan), exact.  Returns the fallbacks taken, or with timed=True
    the kernel's summary row."""
    cluster, pods, sfeas, aff, taint = assign._solver_prep(snap)
    m = torch.as_tensor(members, dtype=torch.int32, device=cluster.allocatable.device)

    def kern():
        return bindings.wavefront(cluster, pods, sfeas, aff, taint, m, features, n_groups, cfg)

    def plain():
        return assign.wavefront_assign_plain(cluster, pods, sfeas, aff, taint, m, features, n_groups, cfg)

    out = kern()
    want = plain()
    err = check_equal("wavefront", out, want, torch)
    if not timed:
        scan = assign.greedy_assign_plain(cluster, pods, sfeas, aff, taint,
                                          assign.solve_order(pods), features, n_groups, cfg)
        check_equal("wavefront (against the scan)", out[:7], scan, torch)
        return int(out[8])
    ms = cuda_ms(kern, 10, torch)
    plain_ms = time_plain(plain, torch)
    bms, by = bound(*greedy_scan_need(cluster, pods, sfeas, out[2], features, torch))
    return {"name": "wavefront", "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by}


def run_auction(snap, cfg, tie_k, auction, bindings, torch, timed: bool = False,
                cpu_snap=None):
    """Kernels auction_bids and auction_accept against their plain versions
    on the card, round by round along the plain trajectory, then the whole
    enqueued round loop against the plain loop, exact (given cpu_snap, the
    same snapshot on the CPU, also against the plain loop there).  Returns the rounds, or with
    timed=True the two kernels' summary rows (one round each, at round
    0)."""
    n = snap.cluster.allocatable.shape[0]
    tie_k = min(auction.default_tie_k(snap) if tie_k is None else tie_k, n)
    cluster, pods, st = auction.auction_prep(snap)
    p = pods.req.shape[0]
    dev = cluster.allocatable.device
    assigned = torch.full((p,), -1, dtype=torch.int32, device=dev)
    bid_scores = torch.full((p,), float("-inf"), device=dev)
    req, nz = cluster.requested, cluster.nonzero_requested
    max_rounds = 64
    bufs = bindings.auction_buffers(cluster, pods, tie_k)
    rnd, errs, rows = 0, [0.0, 0.0], []
    while rnd < max_rounds and bool(((assigned < 0) & pods.valid).any()):
        state = bindings.auction_state(rnd, True, dev)
        got = bindings.auction_bids(cluster, pods, st, req, nz, assigned, state, tie_k, cfg,
                                    bufs)[:2]
        bid, val = auction.auction_bids_plain(cluster, pods, st, req, nz, assigned, rnd, tie_k, cfg)
        errs[0] = max(errs[0], check_equal("auction_bids", got, (bid, val), torch))
        kr, kn, ka, ks = req.clone(), nz.clone(), assigned.clone(), bid_scores.clone()
        state = bindings.auction_state(rnd, True, dev)
        bindings.auction_accept(cluster.allocatable, pods, st.order, bid, val, kr, kn, ka, ks,
                                state, max_rounds, bufs)
        want = auction.auction_accept_plain(cluster.allocatable, pods, st.order, bid, val,
                                            req, nz, assigned, bid_scores)
        errs[1] = max(errs[1], check_equal("auction_accept", (ka, ks, kr, kn), want[:4], torch))
        if int(state[2]) != int(want[4]):
            raise AssertionError("auction_accept: progress differs from its plain version")
        if timed and rnd == 0:
            rows = time_auction_round(cluster, pods, st, req, nz, assigned, bid_scores,
                                      bid, val, tie_k, cfg, max_rounds, bufs, auction,
                                      bindings, torch)
        assigned, bid_scores, req, nz, progress = want
        rnd += 1
        if not progress:
            break
    got = bindings.auction_rounds(cluster, pods, st, tie_k, cfg, max_rounds)
    want = auction._rounds_plain(cluster, pods, st, tie_k, cfg, max_rounds)
    check_equal("auction rounds", got, want, torch)
    if cpu_snap is not None:
        on_cpu = auction._rounds_plain(*auction.auction_prep(cpu_snap), tie_k, cfg, max_rounds)
        check_equal("auction rounds (card against CPU)", [t.cpu() for t in got], on_cpu, torch)
    if not timed:
        return int(got[4])
    for row, err in zip(rows, errs):
        row["max_abs_err"] = err
    return rows


def time_auction_round(cluster, pods, st, req, nz, assigned, bid_scores, bid, val,
                       tie_k, cfg, max_rounds, bufs, auction, bindings, torch):
    """CUDA-event times of one round of each auction kernel (the state is
    reset before every launch, so each runs the round) and host times of
    their plain versions, with their bounds."""
    dev = req.device
    go = bindings.auction_state(0, True, dev)
    state = go.clone()

    def k_bids():
        state.copy_(go)
        return bindings.auction_bids(cluster, pods, st, req, nz, assigned, state, tie_k, cfg,
                                     bufs)

    kr, kn, ka, ks = req.clone(), nz.clone(), assigned.clone(), bid_scores.clone()

    def k_accept():
        state.copy_(go)
        kr.copy_(req)
        kn.copy_(nz)
        ka.copy_(assigned)
        ks.copy_(bid_scores)
        bindings.auction_accept(cluster.allocatable, pods, st.order, bid, val, kr, kn, ka, ks,
                                state, max_rounds, bufs)

    bids_ms = cuda_ms(k_bids, 20, torch)
    accept_ms = cuda_ms(k_accept, 20, torch)
    bids_plain = time_plain(lambda: auction.auction_bids_plain(
        cluster, pods, st, req, nz, assigned, 0, tie_k, cfg), torch)
    accept_plain = time_plain(lambda: auction.auction_accept_plain(
        cluster.allocatable, pods, st.order, bid, val, req, nz, assigned, bid_scores), torch)
    b1 = bound(*auction_bids_need(cluster, pods, st, req, tie_k, torch))
    b2 = bound(*auction_accept_need(cluster, pods, bid, torch))
    return [
        {"name": "auction_bids", "ms": bids_ms, "plain_ms": bids_plain,
         "bound_ms": b1[0], "bound_by": b1[1]},
        {"name": "auction_accept", "ms": accept_ms, "plain_ms": accept_plain,
         "bound_ms": b2[0], "bound_by": b2[1]},
    ]


def run_kernels(snap, features, n_groups, cfg, assign, filters, bindings, torch,
                timed: bool = False):
    """Run the three kernels of the greedy route on a snapshot on the card
    and hold each against its plain version on the same inputs.  With
    timed=True also time kernel and plain version and work out each
    kernel's bound."""
    cluster, pods, sel, pref = snap[:4]
    pref_rows = (pref.expr_ids[:, None], pref.expr_op[:, None],
                 pref.expr_slot[:, None], pref.valid[:, None])
    sel_rows = (sel.expr_ids, sel.expr_op, sel.expr_slot, sel.term_valid)
    rows = []

    def k1():
        return (bindings.match_terms(cluster.label_bits, cluster.topo_ids, *sel_rows),
                bindings.match_terms(cluster.label_bits, cluster.topo_ids, *pref_rows))

    def p1():
        return (filters.match_rows_plain(cluster, *sel_rows),
                filters.match_rows_plain(cluster, *pref_rows))

    sel_mask, pref_mask = k1()
    err1 = check_equal("match_terms", (sel_mask, pref_mask), p1(), torch)
    reps = torch.clamp(pods.class_rep, 0, pods.req.shape[0] - 1)

    def k2():
        return bindings.class_statics(cluster, pods, sel_mask, pref_mask, reps)

    def p2():
        return assign.class_statics_plain(cluster, pods, sel_mask, pref_mask, reps)

    statics = k2()
    err2 = check_equal("class_statics", statics, p2(), torch)
    order = assign.solve_order(pods)

    def k3():
        return bindings.greedy_scan(cluster, pods, *statics, order, features, n_groups, cfg)

    def p3():
        return assign.greedy_assign_plain(cluster, pods, *statics, order, features, n_groups, cfg)

    out = k3()
    t0 = time.perf_counter()
    want = p3()
    torch.cuda.synchronize()
    plain3_ms = (time.perf_counter() - t0) * 1e3
    err3 = check_equal("greedy_scan", out, want, torch)
    if not timed:
        return rows
    k1_ms = cuda_ms(k1, 50, torch)
    p1_ms = cuda_ms(p1, 10, torch)
    k2_ms = cuda_ms(k2, 50, torch)
    p2_ms = cuda_ms(p2, 10, torch)
    k3_ms = cuda_ms(k3, 3, torch)
    n = cluster.label_bits.shape[0]
    b1 = [match_terms_need(n, *sel_rows, torch), match_terms_need(n, *pref_rows, torch)]
    need1 = (sum(x[0] for x in b1), sum(x[1] for x in b1))
    need2 = class_statics_need(cluster, pods, reps, torch)
    need3 = greedy_scan_need(cluster, pods, statics[0], out[2], features, torch)
    for name, err, ms, pms, need in (
        ("match_terms", err1, k1_ms, p1_ms, need1),
        ("class_statics", err2, k2_ms, p2_ms, need2),
        ("greedy_scan", err3, k3_ms, plain3_ms, need3),
    ):
        bms, by = bound(*need)
        rows.append({"name": name, "max_abs_err": err, "ms": ms, "plain_ms": pms,
                     "bound_ms": bms, "bound_by": by})
    return rows


if __name__ == "__main__":
    sys.exit(main())
