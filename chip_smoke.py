"""Drive the torch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (one JSON line each on stdout):

  build    build the three CUDA kernels from kubernetes_tpu_torch/csrc
  parity   each kernel against its plain torch version on the card, exact,
           on mixed small batches (selectors, taints, ports, gangs, all
           three fit strategies)
  main     SchedulingBasic/5000Nodes through TorchBatchScheduler on the
           card: 5,000 nodes, 1,000 init pods scheduled and assumed, then
           a measured 1,000-pod batch; launch counters reset just before
           and read just after
  kernels  each kernel against its plain version on the measured batch's
           snapshot, exact, timed with CUDA events
  small    SchedulingBasic/500Nodes on the card against the plain path on
           the CPU: identical placements and scores
  north    one 10,000-pod batch onto 50,000 nodes

Then the card's name and power limit, the `kernels` summary object, and
as the last line {"ok": true, "device": {...}}.  Any failed check raises
and the script exits non-zero; with no CUDA device it exits non-zero and
prints no result.
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


def bound(need_bytes: float, ops: float) -> tuple:
    t_bytes = need_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
        from kubernetes_tpu_torch.ops import assign, device as dv, filters
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
    from kubernetes_tpu_torch.ops import schema, scores
    from kubernetes_tpu_torch.testing.cases import mixed_objects

    cfgs = (
        scores.ScoreConfig(),
        scores.ScoreConfig(fit_strategy="MostAllocated"),
        scores.ScoreConfig(
            fit_strategy="RequestedToCapacityRatio",
            rtcr_shape=((0.0, 0.0), (50.0, 7.0), (100.0, 10.0)),
        ),
    )
    checked = 0
    for seed in range(6):
        nodes, pending, bound = mixed_objects(wrappers, seed)
        snap, _meta = schema.SnapshotBuilder().build(nodes, pending, bound_pods=bound)
        cfg = cfgs[seed % 3]
        ts = dv.to_device(snap, "cuda")
        features = assign.features_of(snap)
        n_groups = int(snap.pods.group_id.max()) + 1
        run_kernels(ts, features, n_groups, cfg, assign, filters, bindings, torch)
        checked += 1
    torch.cuda.synchronize()
    emit({"phase": "parity", "cases": checked, "exact": True})

    # ---- main path: SchedulingBasic/5000Nodes ------------------------------
    sched = TorchBatchScheduler()
    for node in make_cluster(wrappers, MAIN[0]):
        sched.add_node(node)
    init_pods = make_pods(wrappers, MAIN[1], "init")
    measured = make_pods(wrappers, MAIN[2], "measured")
    bindings.reset_launches()
    t_init = time.perf_counter()
    init_names = sched.schedule_pending(init_pods)
    t_init = time.perf_counter() - t_init
    for pod, name in zip(init_pods, init_names):
        if name is None:
            raise AssertionError(f"init pod {pod.meta.name} was not placed")
        sched.assume(pod, name)
    # the measured batch's snapshot as the main path encodes it, kept for
    # the kernel comparison below (an encode launches no kernel)
    snap_k, meta_k = sched.encode_pending(measured)
    torch.cuda.synchronize()
    t_meas = time.perf_counter()
    names = sched.schedule_pending(measured)
    t_meas = time.perf_counter() - t_meas
    main_launches = dict(bindings.LAUNCHES)
    if any(n is None for n in names):
        raise AssertionError("a measured pod was not placed")
    for name, count in main_launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    for pod, name in zip(measured, names):
        sched.assume(pod, name)
    check_capacity(sched.state)
    emit({"phase": "main", "workload": "SchedulingBasic/5000Nodes",
          "placed": len(names) + len(init_names),
          "init_s": t_init, "measured_s": t_meas,
          "pods_per_s": len(measured) / t_meas,
          "last_timings": sched.last_timings, "launches": main_launches,
          "card": card})

    # ---- each kernel against its plain version at the main path's shapes ---
    summary = run_kernels(
        snap_k, meta_k.features, meta_k.n_groups, sched.score_config,
        assign, filters, bindings, torch, timed=True,
    )
    for row in summary:
        row["launches"] = main_launches[row["name"]]
    emit({"phase": "kernels", "workload": "SchedulingBasic/5000Nodes",
          "card": card,
          "kernels": [dict({k: row[k] for k in ("name", "launches", "max_abs_err", "ms", "plain_ms")},
                           equal=True) for row in summary]})

    # ---- small input against the plain path on the CPU ------------------
    small = {}
    for dev in ("cuda", "cpu"):
        s = TorchBatchScheduler(device=dev)
        for node in make_cluster(wrappers, SMALL[0]):
            s.add_node(node)
        first = make_pods(wrappers, SMALL[1], "init")
        got = s.schedule_pending(first)
        for pod, name in zip(first, got):
            s.assume(pod, name)
        second = s.schedule_pending(make_pods(wrappers, SMALL[2], "measured"))
        small[dev] = (got, second, s.last_result.scores.cpu())
    if small["cuda"][:2] != small["cpu"][:2] or not torch.equal(small["cuda"][2], small["cpu"][2]):
        raise AssertionError("SchedulingBasic/500Nodes: card and CPU placements differ")
    emit({"phase": "small", "workload": "SchedulingBasic/500Nodes",
          "placements_equal_cpu": True, "placed": sum(n is not None for n in small["cuda"][1])})

    # ---- north star: 10,000 pods onto 50,000 nodes -------------------------
    big = TorchBatchScheduler()
    t0 = time.perf_counter()
    for node in make_cluster(wrappers, NORTH[0]):
        big.add_node(node)
    t_nodes = time.perf_counter() - t0
    pods = make_pods(wrappers, NORTH[2], "burst")
    bindings.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = big.schedule_pending(pods)
    t_solve = time.perf_counter() - t0
    north_launches = dict(bindings.LAUNCHES)
    if any(n is None for n in got):
        raise AssertionError("north star: a pod was not placed")
    for pod, name in zip(pods, got):
        big.assume(pod, name)
    check_capacity(big.state)
    emit({"phase": "north", "nodes": NORTH[0], "pods": NORTH[2],
          "add_nodes_s": t_nodes, "batch_s": t_solve,
          "pods_per_s": len(pods) / t_solve, "last_timings": big.last_timings,
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


def run_kernels(snap, features, n_groups, cfg, assign, filters, bindings, torch,
                timed: bool = False):
    """Run the three kernels on a snapshot on the card and hold each
    against its plain version on the same inputs.  With timed=True also
    time kernel and plain version and work out each kernel's bound."""
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
