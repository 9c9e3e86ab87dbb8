"""Time one kernel built from two sources, in one run on one card.

    python3 kernel_ab.py KERNEL OTHER_CSRC_DIR [SHAPE]
    python3 kernel_ab.py statics OTHER_CSRC_DIR [SHAPE ...]

KERNEL and its shapes (the first is the default):

  greedy_scan     B  SchedulingBasic/5000Nodes' measured batch (8,192
                     padded nodes, 1,024 pods; the greedy phase's state)
                  C  c10's batch after its six rounds (4,096 nodes, 256
                     padded pods, 26 gangs; the slices phase's timed batch)
                  L  16 pods onto 50,000 nodes (65,536 padded; the scan is
                     the reference's route for a batch this small)
  wavefront       W  SchedulingNodeAffinity/5000Nodes' first measured
                     500-pod batch, the planner's waves (16 of 32 pods)
                  S  TopologySpreading/5000Nodes' first 500-pod batch of the
                     measured pods (the spread phase's wavefront run: one-pod
                     waves)
                  F  SchedulingPodAffinity/5000Nodes' measured batch (one-pod
                     waves)
  evaluate_single E  one pod-default pod against SchedulingBasic/5000Nodes
                     behind the extender (8,192 padded nodes, no extra row)
                  E+ the same with a preferred inter-pod term (an extra row:
                     filter, then score; class_extras is made once, outside
                     the timing)
  auction         B  the whole round loop of SchedulingBasic/5000Nodes'
                     measured batch (8,192 padded nodes, 1,024 pods)
                  T  TopologySpreading/5000Nodes' measured batch (the spread
                     repair; 2,048 padded pods)
                  A  SchedulingPodAntiAffinity/5000Nodes' measured batch (the
                     inter-pod repair)
                  P  the preferred-affinity variant's measured batch (an
                     extra row a class)
                  N  the north star's first batch (65,536 padded nodes,
                     16,384 padded pods)
  statics         the cold statics prep (match_terms x2 + class_statics
                  in an earlier tree, one class_statics launch in a tree
                  with ops.assign.cold_statics), each shape named runs in
                  one process, in this order (default B):
                  B  SchedulingBasic/5000Nodes' measured batch
                  W  SchedulingNodeAffinity/5000Nodes' first measured
                     batch (a 32-row selector table, one valid row)
                  P  the preferred-affinity variant's measured batch
                  E  one pod-default pod behind the extender
                  N  the north star's first batch
                  G  bench.py c5's first batch (100 gangs, 65,536 padded
                     nodes)

Builds kubernetes_tpu_torch/csrc/KERNEL.cu ("change") and
OTHER_CSRC_DIR/KERNEL.cu ("other") with build.py's flags plus -Xptxas -v,
each with its own directory's headers into its own library: pass a whole
csrc/ directory, for example another commit's unpacked with `git archive`
into a git-ignored directory.  Both must keep KERNEL's C interface, but
for `auction`, whose sequence is the other tree's own: OTHER_CSRC_DIR's
package (its parent directory) is loaded under another name and its
bindings.auction_rounds runs (an earlier tree's per-round enqueue), beside
this tree's (one launch; both calls make their buffers and launch
arguments), and each tree's launch alone where its bindings have one
("change_loop", "other_loop": AuctionRun.loop with its arrays made
beforehand, CUDA events behind a spin of the card, chip_smoke.launch_ms;
other, change, change, other); the ptxas reports are of every auction
source of either tree.  The
inputs come from chip_smoke.py's builders of the timed shapes.  Both
outputs must equal the plain version's on the same inputs.  Each library
runs its own sequence: evaluate_single's fused launch where the library
has one (evaluate_single_fused_stage) and the pod no extra row, else its
two stages.  The two libraries run in the order other, change, change,
other, twice; each time is the mean of CUDA events around a shape's
launches after a warm-up, with the host clock around the same calls (no
sync) beside it; evaluate_single, whose calls the host bounds, also
replays 20 calls from one CUDA graph (the card's time alone).  Prints the card's name and power limit, then one JSON
object with every time, the cluster blocks at the shape and each
library's ptxas report (registers, shared memory, spills).
`statics` loads the other tree's package as `kt_other` (its match_terms
and class_statics built by build_library) and runs each tree's own calls
on the same inputs: every call of a prep alone and the whole prep, the
card's time behind a spin and the host clock of the call
(chip_smoke.launch_ms), other, change, change, other, each result equal
to the plain prep's; it prints one JSON line a shape as it goes, then
the card line and the ptxas reports.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import chip_smoke

# kernel -> shape -> (launches a timing, what the shape is)
SHAPES = {
    "greedy_scan": {
        "B": (5, "SchedulingBasic/5000Nodes measured batch, the scan"),
        "C": (10, "c10 batch after six rounds (4,096 nodes, 256 padded pods), the scan"),
        "L": (20, "16 pods onto 50,000 nodes (65,536 padded), the scan"),
    },
    "wavefront": {
        "W": (10, "SchedulingNodeAffinity/5000Nodes first measured batch"),
        "S": (5, "TopologySpreading/5000Nodes first 500-pod measured batch, one-pod waves"),
        "F": (5, "SchedulingPodAffinity/5000Nodes measured batch, one-pod waves"),
    },
    "evaluate_single": {
        "E": (200, "one pod-default pod against SchedulingBasic/5000Nodes, no extra row"),
        "E+": (200, "the same with a preferred inter-pod term (an extra row)"),
    },
    "statics": {
        "B": (50, "SchedulingBasic/5000Nodes measured batch (8,192 padded nodes, 1,024 "
                  "pods), the auction's spec classes"),
        "W": (50, "SchedulingNodeAffinity/5000Nodes first measured 500-pod batch (a 32-row "
                  "selector table, one valid row), the wavefront's classes"),
        "P": (50, "the preferred-affinity variant's measured batch, the auction's spec "
                  "classes"),
        "E": (50, "one pod-default pod behind the extender (8,192 padded nodes), its one "
                  "class"),
        "N": (20, "the north star's first batch (65,536 padded nodes, 16,384 padded pods), "
                  "the auction's spec classes"),
        "G": (20, "bench.py c5's first batch (65,536 padded nodes, 100 gangs), the "
                  "auction's spec classes"),
    },
    "auction": {
        "B": (10, "SchedulingBasic/5000Nodes measured batch, the whole round loop"),
        "T": (5, "TopologySpreading/5000Nodes measured batch, the whole round loop"),
        "A": (5, "SchedulingPodAntiAffinity/5000Nodes measured batch, the whole round loop"),
        "P": (5, "preferred-affinity variant's measured batch, the whole round loop"),
        "N": (3, "the north star's first batch (50,000 nodes, 10,000 pods), the whole loop"),
    },
}


def auction_sources(csrc: Path) -> list:
    """The auction's sources in a csrc/ directory (this tree's program and
    release; an earlier tree's stage kernels)."""
    return sorted(p.stem for p in csrc.glob("auction_*.cu"))


def build_library(kernel: str, csrc: Path, out_dir: Path) -> tuple:
    """(library, ptxas report lines) of csrc/KERNEL.cu built with csrc's
    own headers."""
    from kubernetes_tpu_torch.kernels import build

    src = csrc / f"{kernel}.cu"
    flags = (*build.NVCC_FLAGS, "-Xptxas", "-v")
    digest = hashlib.sha256(
        src.read_bytes()
        + b"".join(h.read_bytes() for h in sorted(csrc.glob("*.cuh")))
        + " ".join(flags).encode()
    ).hexdigest()[:16]
    out = out_dir / f"lib{kernel}-{digest}.so"
    saved = out.with_suffix(".ptxas.json")   # a library built by an earlier run
    if out.exists() and saved.exists():
        report = json.loads(saved.read_text())
    else:
        proc = subprocess.run([build.nvcc_path(), *flags, "-I", str(csrc), "-o", str(out),
                               str(src)], capture_output=True, text=True, check=True)
        report = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
                  if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        saved.write_text(json.dumps(report))
    lib = ctypes.CDLL(str(out))
    err = getattr(lib, f"{kernel}_error_string")
    err.restype, err.argtypes = ctypes.c_char_p, [ctypes.c_int]
    return lib, report


def make_case(kernel: str, shape: str, torch):
    """(kern, want, view, n): the kernel's launch on the shape's inputs, its
    plain version's result, the part of the launch's result that the plain
    version gives, and the padded node axis."""
    from kubernetes_tpu_torch.kernels import bindings
    from kubernetes_tpu_torch.models.batch_scheduler import TorchBatchScheduler
    from kubernetes_tpu_torch.ops import assign
    from kubernetes_tpu_torch.testing import wrappers

    if kernel == "greedy_scan":
        if shape == "C":
            snap, meta = chip_smoke.c10_timed_snapshot(wrappers, TorchBatchScheduler, torch)
            cfg = assign.DEFAULT_SCORE_CONFIG
        else:
            build = chip_smoke.basic_snapshot if shape == "B" else (
                lambda w, t: chip_smoke.wide_snapshot(w, t, chip_smoke.WIDE[2]))
            sched, snap, meta = build(wrappers, TorchBatchScheduler)
            cfg = sched.score_config
        kern, plain, _prep = chip_smoke.scan_case(snap, meta.features, meta.n_groups, cfg,
                                                  assign, bindings, torch)
        return kern, plain(), lambda got: got, snap.cluster.allocatable.shape[0]
    if kernel == "evaluate_single":
        snap, features = chip_smoke.single_snapshot(wrappers, TorchBatchScheduler, shape == "E+")
        kern, plain = single_case(snap, features, assign, bindings, torch)
        return kern, plain(), lambda got: got, snap.cluster.allocatable.shape[0]
    if kernel == "wavefront":
        build = {"W": chip_smoke.affinity_snapshot, "S": chip_smoke.spread_wave_snapshot,
                 "F": chip_smoke.pod_affinity_snapshot}[shape]
        sched, snap, meta = build(wrappers, TorchBatchScheduler)
        if meta.route != "wavefront":
            raise AssertionError(f"shape {shape} took route {meta.route}")
        kern, plain, _prep = chip_smoke.wavefront_case(
            snap, meta.features, meta.n_groups, sched.score_config, meta.wave_plan.members,
            assign, bindings, torch)
        return kern, plain(), lambda got: got, snap.cluster.allocatable.shape[0]
    raise ValueError(f"no case for kernel {kernel}")


def auction_case(shape: str, torch):
    """(cluster, pods, st, tie_k, cfg, want, n) of an auction shape: the
    auction's prep of the shape's snapshot on the card and the plain
    loop's result on CPU copies."""
    from kubernetes_tpu_torch.models.batch_scheduler import TorchBatchScheduler
    from kubernetes_tpu_torch.ops import auction
    from kubernetes_tpu_torch.testing import wrappers

    build = {
        "B": chip_smoke.basic_snapshot, "T": chip_smoke.spread_snapshot,
        "A": lambda w, t: chip_smoke.measured_snapshot(w, t, "pod_anti_affinity_objects",
                                                       chip_smoke.ANTI),
        "P": lambda w, t: chip_smoke.measured_snapshot(w, t, "preferred_affinity_objects",
                                                       chip_smoke.PREFERRED),
        "N": chip_smoke.north_snapshot,
    }[shape]
    sched, snap, meta = build(wrappers, TorchBatchScheduler)
    if meta.route != "auction":
        raise AssertionError(f"shape {shape} took route {meta.route}")
    cfg = sched.score_config
    cluster, pods, st = auction.auction_prep(snap, meta.features, meta.topo_split, cfg)
    want = auction._rounds_plain(*chip_smoke.cpu_args((cluster, pods, st), torch), meta.tie_k,
                                 cfg, 64)
    return cluster, pods, st, meta.tie_k, cfg, want, snap.cluster.allocatable.shape[0]


def load_other_bindings(csrc: Path, out_dir: Path, names=None):
    """The other tree's kernels.bindings (its package, csrc's parent,
    loaded as `kt_other`), with its libraries of `names` (default: its
    auction sources) built by build_library (ptxas reports returned)."""
    import importlib
    import importlib.util

    pkg = csrc.parent
    spec = importlib.util.spec_from_file_location(
        "kt_other", pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["kt_other"] = mod
    spec.loader.exec_module(mod)
    other = importlib.import_module("kt_other.kernels.bindings")
    other_build = importlib.import_module("kt_other.kernels.build")
    names = auction_sources(csrc) if names is None else names
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(lambda name: build_library(name, csrc, out_dir), names))
    reports = {}
    for name, (lib, report) in zip(names, built):
        other_build._libs[name], reports[name] = lib, report
    return other, reports


def other_statics(st):
    """st as the other tree's ops.auction.AuctionStatics: an earlier tree
    (before the launch wrote them itself) carries the inter-pod
    repair's dense tables, made here by this tree's repair_tables."""
    import importlib

    from kubernetes_tpu_torch.ops import auction

    fields = importlib.import_module("kt_other.ops.auction").AuctionStatics._fields
    vals = st._asdict()
    if "mi_dense" in fields and st.features.interpod:
        vals.update(zip(("mi_dense", "anti_dense", "solve_pos"),
                        auction.repair_tables(st.tm.table, st.order)))
    cls = importlib.import_module("kt_other.ops.auction").AuctionStatics
    return cls(**{k: vals.get(k) for k in fields})


def auction_ab(shape: str, other_dir: Path, out_dir: Path, torch) -> dict:
    """The auction's whole round loop, this tree's program against the
    other tree's own sequence, on the same inputs, both equal to the plain
    loop; other, change, change, other, twice; then each tree's launch
    alone (the other's where its bindings have AuctionRun): other, change,
    change, other."""
    from kubernetes_tpu_torch.kernels import bindings, build

    names = auction_sources(build.CSRC_DIR)
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(lambda name: build_library(name, build.CSRC_DIR, out_dir),
                              names))
    change_reports = {}
    for name, (lib, report) in zip(names, built):
        build._libs[name], change_reports[name] = lib, report
    other, other_reports = load_other_bindings(other_dir, out_dir)
    build.build_all([k for k in build.KERNELS if k not in names])   # the inputs' kernels
    cluster, pods, st, tie_k, cfg, want, n_nodes = auction_case(shape, torch)
    iters, workload = SHAPES["auction"][shape]
    st_other = other_statics(st)
    runs = {
        "other": lambda: other.auction_rounds(cluster, pods, st_other, tie_k, cfg, 64),
        "change": lambda: bindings.auction_rounds(cluster, pods, st, tie_k, cfg, 64),
    }
    # each tree's launch alone where its bindings have one (AuctionRun:
    # one loop launch a batch), in turns
    loops = {"change_loop": bindings.AuctionRun}
    if hasattr(other, "AuctionRun"):
        loops["other_loop"] = other.AuctionRun
    times = {k: [] for k in (*runs, *loops)}
    host = {k: [] for k in times}
    for which in ("other", "change", "change", "other") * 2:
        chip_smoke.check_equal(f"auction ({which})", runs[which](), want, torch)
        ms, host_ms = chip_smoke.cuda_host_ms(runs[which], iters, torch)
        times[which].append(ms)
        host[which].append(host_ms)
    loop_runs = {}
    for name, cls in loops.items():
        run = cls(cluster, pods, st_other if name == "other_loop" else st, tie_k, cfg, 64)
        start = [t.clone() for t in (run.requested, run.nonzero, run.assigned, run.bid_scores)]
        counts = run.counts.clone() if run.counts is not None else None
        bits = [t.clone() for t in run.bits] if run.bits else None
        loop_runs[name] = (run, lambda run=run, start=start, counts=counts, bits=bits,
                           go=bool(run.state[1]): run.load(0, *start, counts, bits, go=go))
    for name in ("other_loop", "change_loop", "change_loop", "other_loop"):
        if name not in loop_runs:
            continue
        run, reset = loop_runs[name]
        ms, host_ms = chip_smoke.launch_ms(run.loop, reset, iters, torch)
        chip_smoke.check_equal(f"auction ({name})", run.result(), want, torch)
        times[name].append(ms)
        host[name].append(host_ms)
    rounds = int(want[4])
    return {"kernel": "auction", "shape": shape, "workload": workload,
            "other_source": str(other_dir), "launches_a_timing": iters, "rounds": rounds,
            "classes": int(st.jspec.shape[0]), "padded_pods": int(pods.req.shape[0]),
            "ms": times, "median_ms": {k: statistics.median(v) for k, v in times.items()},
            "host_ms": host,
            "median_host_ms": {k: statistics.median(v) for k, v in host.items()},
            "equal_plain": True, "padded_nodes": n_nodes,
            "cluster_blocks_threads": bindings.scan_shape(n_nodes),
            "ptxas": {"change": change_reports, "other": other_reports}}


def statics_case(shape: str, torch):
    """(cluster, pods, sel, pref, reps, n) of a statics shape on the card:
    the shape's snapshot and the class representatives its route's cold
    prep reads (the auction's spec classes, the wavefront's classes, the
    extender's pod 0)."""
    from kubernetes_tpu_torch.models.batch_scheduler import TorchBatchScheduler
    from kubernetes_tpu_torch.testing import wrappers

    if shape == "E":
        snap, _features = chip_smoke.single_snapshot(wrappers, TorchBatchScheduler, False)
        reps = torch.zeros(1, dtype=torch.int32, device=snap.pods.req.device)
    else:
        build = {
            "B": chip_smoke.basic_snapshot, "W": chip_smoke.affinity_snapshot,
            "P": lambda w, t: chip_smoke.measured_snapshot(w, t, "preferred_affinity_objects",
                                                           chip_smoke.PREFERRED),
            "N": chip_smoke.north_snapshot, "G": chip_smoke.c5_snapshot,
        }[shape]
        _sched, snap, meta = build(wrappers, TorchBatchScheduler)
        rep = snap.pods.class_rep if meta.route != "auction" else snap.pods.spec_rep
        reps = torch.clamp(rep, 0, snap.pods.req.shape[0] - 1).to(torch.int32)
    cluster, pods, sel, pref = snap[:4]
    return cluster, pods, sel, pref, reps, cluster.allocatable.shape[0]


def cold_prep_calls(bindings, assign, cluster, pods, sel, pref, reps) -> dict:
    """A tree's cold statics prep as its bindings run it, by name: a tree
    with ops.assign.cold_statics makes it one class_statics call ("prep",
    and "prep_mask" with the selector mask asked for); an earlier tree
    makes three ("match_terms_sel", "match_terms_pref", "class_statics"
    over masks made once beforehand, and "prep", the three in turn).
    Each value is (call, what it returns that the plain prep gives)."""
    if hasattr(assign, "cold_statics"):
        return {
            "prep": (lambda: bindings.class_statics(cluster, pods, sel, pref, reps),
                     lambda out: out[:3]),
            "prep_mask": (lambda: bindings.class_statics(cluster, pods, sel, pref, reps,
                                                         want_sel_mask=True),
                          lambda out: out),
        }
    sel_rows = (sel.expr_ids, sel.expr_op, sel.expr_slot, sel.term_valid)
    pref_rows = (pref.expr_ids[:, None], pref.expr_op[:, None], pref.expr_slot[:, None],
                 pref.valid[:, None])
    nodes = (cluster.label_bits, cluster.topo_ids)
    masks = (bindings.match_terms(*nodes, *sel_rows), bindings.match_terms(*nodes, *pref_rows))

    def prep():
        sm = bindings.match_terms(*nodes, *sel_rows)
        pm = bindings.match_terms(*nodes, *pref_rows)
        return (*bindings.class_statics(cluster, pods, sm, pm, reps), sm)

    return {
        "match_terms_sel": (lambda: bindings.match_terms(*nodes, *sel_rows), None),
        "match_terms_pref": (lambda: bindings.match_terms(*nodes, *pref_rows), None),
        "class_statics": (lambda: bindings.class_statics(cluster, pods, *masks, reps),
                          lambda out: out),
        "prep": (prep, lambda out: out[:3]),
        "prep_mask": (prep, lambda out: out),
    }


def statics_ab(shapes, other_dir: Path, out_dir: Path, torch) -> list:
    """The cold statics prep at each shape: the other tree's own calls
    against this tree's, both equal to the plain prep (match_rows_plain,
    class_statics_plain) on the same inputs; other, change, change, other;
    each call's card time alone and host clock (chip_smoke.launch_ms:
    events behind a spin of the card).  One row a shape."""
    import importlib

    from kubernetes_tpu_torch.kernels import bindings, build
    from kubernetes_tpu_torch.ops import assign, filters

    names = ["match_terms", "class_statics"]
    change_reports = {}
    for name in names:
        build._libs[name], change_reports[name] = build_library(name, build.CSRC_DIR, out_dir)
    other, other_reports = load_other_bindings(other_dir, out_dir, names)
    other_assign = importlib.import_module("kt_other.ops.assign")
    build.build_all([k for k in build.KERNELS if k not in names])   # the inputs' kernels
    rows = []
    for shape in shapes:
        cluster, pods, sel, pref, reps, n_nodes = statics_case(shape, torch)
        iters, workload = SHAPES["statics"][shape]
        sm = filters.match_rows_plain(cluster, sel.expr_ids, sel.expr_op, sel.expr_slot,
                                      sel.term_valid)
        pm = filters.match_rows_plain(cluster, pref.expr_ids[:, None], pref.expr_op[:, None],
                                      pref.expr_slot[:, None], pref.valid[:, None])
        want = (*assign.class_statics_plain(cluster, pods, sm, pm, reps), sm)
        calls = {"other": cold_prep_calls(other, other_assign, cluster, pods, sel, pref, reps),
                 "change": cold_prep_calls(bindings, assign, cluster, pods, sel, pref, reps)}
        card = {w: {k: [] for k in calls[w]} for w in calls}
        host = {w: {k: [] for k in calls[w]} for w in calls}
        for which in ("other", "change", "change", "other"):
            for name, (call, view) in calls[which].items():
                if view is not None:
                    got = view(call())
                    chip_smoke.check_equal(f"cold statics {shape} ({which} {name})", got,
                                           want[: len(got)], torch)
                ms, host_ms = chip_smoke.launch_ms(call, lambda: None, iters, torch)
                card[which][name].append(ms)
                host[which][name].append(host_ms)
        need = chip_smoke.cold_statics_need(cluster, pods, sel, pref, reps, False, torch)
        need_mask = chip_smoke.cold_statics_need(cluster, pods, sel, pref, reps, True, torch)
        med = lambda d: {w: {k: statistics.median(v) for k, v in d[w].items()} for w in d}
        rows.append({
            "kernel": "statics", "shape": shape, "workload": workload,
            "other_source": str(other_dir), "launches_a_timing": iters,
            "padded_nodes": n_nodes, "classes": int(reps.shape[0]),
            "selector_rows": int(sel.term_valid.shape[0]),
            "valid_selector_rows": int(sel.term_valid.any(dim=1).sum()),
            "preferred_rows": int(pref.valid.shape[0]),
            "valid_preferred_rows": int(pref.valid.sum()),
            "card_ms": card, "median_card_ms": med(card),
            "host_ms": host, "median_host_ms": med(host),
            "bound_ms": chip_smoke.bound(*need), "bound_ms_mask": chip_smoke.bound(*need_mask),
            "equal_plain": True,
        })
        print(json.dumps(rows[-1]), flush=True)
    for row in rows:
        row["ptxas"] = {"change": change_reports, "other": other_reports}
    return rows


def single_case(snap, features, assign, bindings, torch):
    """(kern, plain) of evaluate_single on a one-pod snapshot on the card:
    the loaded library's own sequence — its fused launch where it has one
    and the pod no extra row, else the filter stage, then the score stage
    (with the extra row made once beforehand from the plain filter's
    feasible row) — and the plain stages on the same inputs, each giving
    (feas, feas_sp, bonus, masked)."""
    cluster, pods, sel, pref = snap[:4]
    topo_z = assign.required_topo_z(snap) if assign.needs_topo(features) else 1
    reps = torch.zeros(1, dtype=torch.int32, device=cluster.allocatable.device)
    sel_mask = assign.selector_match(cluster, sel)
    sfeas, aff, taint = bindings.class_statics(cluster, pods, sel_mask,
                                               assign.preferred_match(cluster, pref), reps)
    sp_args = assign.spread_prep(snap, sel_mask, features, topo_z)
    tm_args = assign.terms_prep(snap, features, topo_z)
    stage1 = assign.single_filter_plain(cluster, pods, sfeas[0], features, sp_args, tm_args)
    extra = assign.extras_prep(snap, features, assign.DEFAULT_SCORE_CONFIG, reps,
                               stage1[0][None], topo_z)
    extra = extra[0] if extra is not None else None
    cfg = assign.DEFAULT_SCORE_CONFIG

    def kern():
        if extra is None and bindings.fused_single_stage() >= 0:
            return bindings.evaluate_single_fused(cluster, pods, sfeas[0], aff[0], taint[0],
                                                  features, cfg, sp_args, tm_args)
        feas, feas_sp, bonus = bindings.evaluate_single_filter(cluster, pods, sfeas[0],
                                                               features, sp_args, tm_args)
        return feas, feas_sp, bonus, bindings.evaluate_single_score(
            cluster, pods, feas, feas_sp, bonus, aff[0], taint[0], extra, features, cfg, sp_args)

    def plain():
        return (*stage1, assign.single_score_plain(cluster, pods, *stage1, aff[0], taint[0],
                                                   extra, features, cfg, sp_args))

    return kern, plain


def main() -> int:
    import torch

    many = len(sys.argv) > 1 and sys.argv[1] == "statics"
    if len(sys.argv) < 3 or sys.argv[1] not in SHAPES or (len(sys.argv) > 4 and not many):
        print(__doc__, file=sys.stderr)
        return 2
    kernel, other_dir = sys.argv[1], Path(sys.argv[2]).resolve()
    shapes = sys.argv[3:] or [next(iter(SHAPES[kernel]))]
    if any(shape not in SHAPES[kernel] for shape in shapes):
        print(f"kernel_ab: {kernel} has shapes {sorted(SHAPES[kernel])}", file=sys.stderr)
        return 2
    shape = shapes[0]
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 3
    from kubernetes_tpu_torch.kernels import bindings, build

    out_dir = build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    if kernel == "statics":
        rows = statics_ab(shapes, other_dir, out_dir, torch)
        print(chip_smoke.card_line(), flush=True)
        print(json.dumps({"kernel": "statics", "shapes": shapes,
                          "ptxas": rows[0]["ptxas"] if rows else None}), flush=True)
        return 0
    if kernel == "auction":
        result = auction_ab(shape, other_dir, out_dir, torch)
        print(chip_smoke.card_line(), flush=True)
        print(json.dumps(result), flush=True)
        return 0
    change, change_report = build_library(kernel, build.CSRC_DIR, out_dir)
    other, other_report = build_library(kernel, other_dir, out_dir)
    # the other library is bound here, so the package's check of its own
    # build's limits (greedy_scan_limits, ...) is not asked of it
    fn = getattr(other, f"{kernel}_launch")
    fn.restype, fn.argtypes = ctypes.c_int, bindings._ARGTYPES[kernel]
    libs = {"change": change, "other": other}

    iters, workload = SHAPES[kernel][shape]
    build.build_all()   # the kernels that prepare the inputs
    kern, want, view, n_nodes = make_case(kernel, shape, torch)
    times = {"other": [], "change": []}
    host = {"other": [], "change": []}
    device = {"other": [], "change": []}   # evaluate_single: replayed from a CUDA graph
    for which in ("other", "change", "change", "other") * 2:
        build._libs[kernel] = libs[which]
        chip_smoke.check_equal(f"{kernel} ({which})", view(kern()), want, torch)
        ms, host_ms = chip_smoke.cuda_host_ms(kern, iters, torch)
        times[which].append(ms)
        host[which].append(host_ms)
        if kernel == "evaluate_single":
            device[which].append(chip_smoke.graph_ms(kern, 20, 10, torch))
    build._libs[kernel] = change
    result = {"kernel": kernel, "shape": shape, "workload": workload,
              "other_source": str(other_dir), "launches_a_timing": iters, "ms": times,
              "median_ms": {k: statistics.median(v) for k, v in times.items()},
              "host_ms": host,
              "median_host_ms": {k: statistics.median(v) for k, v in host.items()},
              "device_ms": device,
              "median_device_ms": {k: statistics.median(v) for k, v in device.items() if v},
              "equal_plain": True, "padded_nodes": n_nodes,
              "ptxas": {"change": change_report, "other": other_report}}
    if kernel in ("greedy_scan", "wavefront", "evaluate_single"):
        result["cluster_blocks"], result["block_threads"] = bindings.scan_shape(n_nodes)
    if kernel == "wavefront":   # the change's dynamic shared memory at this shape
        smem = change.wavefront_smem_bytes
        smem.restype, smem.argtypes = ctypes.c_int, [ctypes.c_int] * 4
        result["dynamic_smem_bytes"] = smem(n_nodes, bindings.MAX_WAVE, 0, 0)
    print(chip_smoke.card_line(), flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
