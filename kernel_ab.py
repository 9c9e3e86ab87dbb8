"""Time one kernel built from two sources, in one run on one card.

    python3 kernel_ab.py KERNEL OTHER_CSRC_DIR [SHAPE]
    python3 kernel_ab.py statics OTHER_CSRC_DIR [SHAPE ...]
    python3 kernel_ab.py preempt OTHER_CSRC_DIR [SHAPE ...]
    python3 kernel_ab.py residents OTHER_CSRC_DIR [SHAPE ...]
    python3 kernel_ab.py interpod OTHER_CSRC_DIR [SHAPE ...] [--change CHANGE_CSRC_DIR]
    python3 kernel_ab.py family OTHER_CSRC_DIR [SHAPE ...] [--change CHANGE_CSRC_DIR]
    python3 kernel_ab.py tail OTHER_CSRC_DIR [SHAPE ...] [--change CHANGE_CSRC_DIR]
    python3 kernel_ab.py extras OTHER_CSRC_DIR [SHAPE ...] [--change CHANGE_CSRC_DIR]
    python3 kernel_ab.py slices OTHER_CSRC_DIR [SHAPE ...] [--change CHANGE_CSRC_DIR]

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
  interpod        the auction_interpod stage alone (AuctionRun.interpod
                  after AuctionRun.load, on round 0's inputs along the
                  plain trajectory), each shape named (default all):
                  A  SchedulingPodAntiAffinity/5000Nodes' measured batch
                  W2 cases.many_anti_terms_objects at 5,000 nodes: 40
                     valid of 64 terms (two words), hostname and zone
  family          the family_prep binding calls of a batch (each entry it
                  uses), each shape named (default all):
                  T  TopologySpreading/5000Nodes' measured batch (spread)
                  A  SchedulingPodAntiAffinity/5000Nodes' (terms)
                  P  the preferred-affinity variant's (pref)
                  WIDE  chip_smoke.wide_family_snapshot's batch at 65,536
                     padded nodes (all three entries)
  tail            the auction's tail stages alone, each on its batch's
                  state after the loop (AuctionRun.reasons_stage /
                  gang_stage after AuctionRun.load), each shape named
                  (default all):
                  reasons/B  SchedulingBasic/5000Nodes' measured batch
                  reasons/T  TopologySpreading/5000Nodes' (spread rows)
                  reasons/A  SchedulingPodAntiAffinity/5000Nodes' (terms)
                  reasons/N  the north star's first batch (65,536 padded
                     nodes, 16,384 padded pods)
                  reasons/G  bench.py c5's first batch (100 gangs, 32
                     padded classes)
                  reasons/S200  the c5 batch onto 200 nodes (the gang
                     phase's scarcity step, its full solve)
                  gang/PG    the parity phase's fractional gang batch
                  gang/G     c5 with three gangs given an unplaceable
                     member (the gang phase's drops step)
                  gang/G0    c5's first batch (every gang complete: no drop)
                  gang/E0    the same launch with no gang (n_groups 0): the
                     launch's start and last barrier alone, the floor
                  gang/S200  the scarcity step's full solve (no gang
                     complete: every placed pod drops)
  extras          the class_extras binding call alone on a batch's pairs,
                  each shape named (default all):
                  P  the preferred-affinity variant's measured batch (the
                     auction's class pairs)
                  I  the synthetic image batch (5,000 nodes, 1,000 pods: the
                     auction's 1,024 class pairs)
                  E+ one pod with a preferred term behind the extender (one
                     pair: the filter stage's feasible row)
  slices          the slice_stats binding call alone after a c10 scan,
                  each shape named (default all):
                  C  c10's batch after its six rounds (4,096 nodes, 64
                     slices of 4x4x4, 256 padded pods, 26 gangs)
                  C0 the same pods each alone (no gang: no carve-out carry)
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
                  G  bench.py c5's first batch (100 gangs; the loop's
                     rounds and reasons)
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
  preempt         a PostFilter pass's device work (match_terms +
                  pod_filters + preempt_dry_run in a tree before the pass
                  had one binding call; bindings.preemption_pass, or its
                  kernels alone, in a tree with it), each shape named in
                  one process, in this order (default Q):
                  Q  PreemptionBasic/5000Nodes' first pass (8,192 padded
                     candidate nodes, K 4, L 1, 16 preemptors)
                  K  c9's batched pass (32,768 padded nodes, K 4, L 4)
                  V  the per-pod dry-run of chip_smoke's `faults` step 8
                     (dry_run_victims)
                  K1 one preemptor's static row on c9's snapshot (the
                     classic walk's Filter slice)
                  S64 the Filter chain's full mode, 64 pods at
                     SchedulingBasic/5000Nodes
                  D  end to end: each tree's own chip_smoke.py helpers in a
                     fresh process from the tree's root (OTHER_CSRC_DIR's
                     grandparent), other, change, change, other: the
                     PreemptionBasic/5000Nodes passes' dispatch_s and c9's
                     batched pass (batched_s)

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
the card line and the ptxas reports.  `preempt` does the same with
each tree's preemption calls (preempt_calls), each result equal to the
plain versions' (batched_dry_run_plain, static_feasible_batch_plain,
filter_rows_plain, dry_run_victims_plain).  `interpod` and `family` run
each tree's own calls the same way (the other tree's package as
`kt_other`; with --change, the change side another tree's package,
`kt_change`, so the parent on both sides is step 0): other, change,
change, other, each result equal to the plain version
(interpod_repair_plain; the plain family preps), the card alone behind a
spin and the host clock (chip_smoke.launch_ms), one JSON line a shape;
`family` also counts each call's device operations (torch.profiler).
`tail` does the same with each tree's auction_loop library: the state
each shape's stage starts from comes from the change side's loop launch
without gangs (the rounds and the reasons), each tree's stage alone runs on it
(the other tree's AuctionRun with its own statics), other, change, change,
other, each result equal to the plain twin on CPU copies
(failure_reasons_plain, gang_post_pass_plain), with the bound and the
shape's class and drop counts in its JSON line.  `extras` and `slices` do
the same with each tree's class_extras and slice_stats bindings on the
same inputs, each result equal to the plain version on CPU copies
(class_extras_plain, carve_stats_plain), the bound beside each.
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
from types import SimpleNamespace

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
    "preempt": {
        "Q": (50, "PreemptionBasic/5000Nodes first pass (8,192 padded candidate nodes, "
                  "K 4, L 1, 16 preemptors)"),
        "K": (50, "c9's batched pass (20,000 nodes, 32,768 padded, 16 preemptors)"),
        "V": (50, "faults step 8's per-pod dry-run (PreemptionBasic/500Nodes after one "
                  "pass, the next preemptor)"),
        "K1": (50, "one preemptor's static row on c9's snapshot (the classic walk)"),
        "S64": (50, "64 pod-default pods at SchedulingBasic/5000Nodes, the full Filter "
                    "chain"),
        "D": (4, "end to end: PreemptionBasic/5000Nodes passes' dispatch_s (4 cycles) and "
                 "c9's batched pass, a fresh process a tree"),
    },
    "residents": {
        "R": (50, "the resident phase's store (SchedulingNodeAffinity/5000Nodes warm: 32 "
                  "slots x 8,192 columns), every entry evaluated"),
        "R500": (50, "the same store, 500 random columns (ascending) re-evaluated"),
        "VR": (50, "one PreemptionBasic/5000Nodes verify solve's partials sync (the last "
                   "verify of the first cycle's pass)"),
        "RI": (50, "the resident phase's crossing (8,192 -> 16,384 columns) with 4 new "
                   "classes: grow, misses and dirty columns in one sync"),
        "U500": (50, "a 500-row usage delta (requested, nonzero_requested, port_bits) at "
                     "R's cluster"),
        "S64": (50, "a 64-row static delta (the 10 static leaves and taint_bits) at R's "
                    "cluster"),
        "VM": (50, "the same verify solve's mirror delta"),
        "SP": (50, "RI's spec rows: 4 missed slots x the 15 spec leaves"),
    },
    "interpod": {
        "A": (20, "SchedulingPodAntiAffinity/5000Nodes measured batch, round 0's repair "
                  "(32 terms, 1 valid, hostname-keyed; 8,192 padded nodes, 1,024 pods)"),
        "W2": (20, "cases.many_anti_terms_objects at 5,000 nodes, 20 services x 50 pods "
                   "(40 valid of 64 terms: two words; hostname and zone), round 0's repair"),
    },
    "family": {
        "T": (50, "TopologySpreading/5000Nodes measured batch, entry spread"),
        "A": (50, "SchedulingPodAntiAffinity/5000Nodes measured batch, entry terms"),
        "P": (50, "the preferred-affinity variant's measured batch, entry pref"),
        "WIDE": (50, "the wide family batch at 65,536 padded nodes (hostname-keyed spread "
                     "rows), entries spread, terms and pref"),
    },
    "tail": {
        # in an order that builds each 50,000-node cluster once
        "reasons/B": (20, "SchedulingBasic/5000Nodes measured batch, the reasons stage"),
        "reasons/T": (20, "TopologySpreading/5000Nodes measured batch, the reasons stage"),
        "reasons/A": (20, "SchedulingPodAntiAffinity/5000Nodes measured batch, the reasons "
                          "stage"),
        "reasons/N": (20, "the north star's first batch (65,536 padded nodes, 16,384 padded "
                          "pods), the reasons stage"),
        "reasons/G": (20, "bench.py c5's first batch (65,536 padded nodes, 100 gangs), the "
                          "reasons stage"),
        "gang/G0": (20, "bench.py c5's first batch (every gang complete), the gang stage"),
        "gang/E0": (20, "the same launch with no gang (n_groups 0: the stage skipped, the "
                        "launch's start and last barrier alone)"),
        "reasons/S200": (20, "the c5 batch onto 200 nodes (the scarcity step's full solve), "
                             "the reasons stage"),
        "gang/S200": (20, "the c5 batch onto 200 nodes (no gang complete), the gang stage"),
        "gang/PG": (20, "the parity phase's fractional gang batch, the gang stage"),
        "gang/G": (20, "bench.py c5 with three gangs given an unplaceable member (the drops "
                       "step), the gang stage"),
    },
    "extras": {
        "P": (20, "the preferred-affinity variant's measured batch, the auction's class "
                  "pairs"),
        "I": (20, "the synthetic image batch (5,000 nodes, 1,000 pods), the auction's class "
                  "pairs"),
        "E+": (20, "one pod with a preferred term behind the extender, its one pair"),
    },
    "slices": {
        "C": (50, "c10's batch after six rounds (4,096 nodes, 256 padded pods, 26 gangs), "
                  "after the scan"),
        "C0": (50, "the same pods each alone (no gang), after the scan"),
    },
    "auction": {
        "B": (10, "SchedulingBasic/5000Nodes measured batch, the whole round loop"),
        "T": (5, "TopologySpreading/5000Nodes measured batch, the whole round loop"),
        "A": (5, "SchedulingPodAntiAffinity/5000Nodes measured batch, the whole round loop"),
        "P": (5, "preferred-affinity variant's measured batch, the whole round loop"),
        "N": (3, "the north star's first batch (50,000 nodes, 10,000 pods), the whole loop"),
        "G": (3, "bench.py c5's first batch (50,000 nodes, 10,000 pods in 100 gangs), the "
                 "whole loop (its rounds and reasons; the gang stage is not in "
                 "auction_rounds)"),
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


# chip_smoke's builders of the auction batches' shapes: (scheduler, snapshot, meta)
AUCTION_BUILDS = {
    "B": chip_smoke.basic_snapshot, "T": chip_smoke.spread_snapshot,
    "A": lambda w, t: chip_smoke.measured_snapshot(w, t, "pod_anti_affinity_objects",
                                                   chip_smoke.ANTI),
    "P": lambda w, t: chip_smoke.measured_snapshot(w, t, "preferred_affinity_objects",
                                                   chip_smoke.PREFERRED),
    "N": chip_smoke.north_snapshot, "G": chip_smoke.c5_snapshot,
    "GD": chip_smoke.c5_drops_snapshot, "S200": chip_smoke.c5_scarce_snapshot,
}


def auction_case(shape: str, torch):
    """(cluster, pods, st, tie_k, cfg, want, n) of an auction shape: the
    auction's prep of the shape's snapshot on the card and the plain
    loop's result on CPU copies."""
    from kubernetes_tpu_torch.models.batch_scheduler import TorchBatchScheduler
    from kubernetes_tpu_torch.ops import auction
    from kubernetes_tpu_torch.testing import wrappers

    sched, snap, meta = AUCTION_BUILDS[shape](wrappers, TorchBatchScheduler)
    if meta.route != "auction":
        raise AssertionError(f"shape {shape} took route {meta.route}")
    cfg = sched.score_config
    cluster, pods, st = auction.auction_prep(snap, meta.features, meta.topo_split, cfg)
    want = auction._rounds_plain(*chip_smoke.cpu_args((cluster, pods, st), torch), meta.tie_k,
                                 cfg, 64)
    return cluster, pods, st, meta.tie_k, cfg, want, snap.cluster.allocatable.shape[0]


def load_other_bindings(csrc: Path, out_dir: Path, names=None, module: str = "kt_other"):
    """The other tree's kernels.bindings (its package, csrc's parent,
    loaded as `module`), with its libraries of `names` (default: its
    auction sources) built by build_library (ptxas reports returned)."""
    import importlib
    import importlib.util

    pkg = csrc.parent
    spec = importlib.util.spec_from_file_location(
        module, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[module] = mod
    spec.loader.exec_module(mod)
    other = importlib.import_module(f"{module}.kernels.bindings")
    other_build = importlib.import_module(f"{module}.kernels.build")
    names = auction_sources(csrc) if names is None else names
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(lambda name: build_library(name, csrc, out_dir), names))
    reports = {}
    for name, (lib, report) in zip(names, built):
        other_build._libs[name], reports[name] = lib, report
    return other, reports


def other_statics(st, module: str = "kt_other"):
    """st as the other tree's ops.auction.AuctionStatics: an earlier tree
    (before the launch wrote them itself) carries the inter-pod
    repair's dense tables, made here by this tree's repair_tables."""
    import importlib

    from kubernetes_tpu_torch.ops import auction

    fields = importlib.import_module(f"{module}.ops.auction").AuctionStatics._fields
    vals = st._asdict()
    if "mi_dense" in fields and st.features.interpod:
        vals.update(zip(("mi_dense", "anti_dense", "solve_pos"),
                        auction.repair_tables(st.tm.table, st.order)))
    cls = importlib.import_module(f"{module}.ops.auction").AuctionStatics
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


def preempt_calls(bindings, filters, kind: str, inputs) -> dict:
    """A tree's device work of a preemption shape as its bindings run it,
    by name: (call, view) with view(call()) what the plain versions give
    ("want" of preempt_want), or None for a call with no plain twin of its
    own.  A tree with bindings.preemption_pass hands pod_filters the
    selector table; an earlier tree makes the mask with match_terms
    first (once beforehand for the kernels timed alone)."""
    if kind == "victims":
        return {"dry_run_victims": (lambda: bindings.dry_run_victims(*inputs),
                                    lambda out: out)}
    batch, snap = inputs if kind == "pass" else (None, inputs)
    cl, sel = snap.cluster, snap.selectors
    pods = filters._pod_rows(filters.pod_view(snap.pods, 0)) if kind == "static_row" \
        else snap.pods
    full = kind == "full"
    one = "pass" if kind == "pass" else "filters"
    if hasattr(bindings, "preemption_pass"):
        calls = {"pod_filters": (lambda: bindings.pod_filters(cl, pods, sel, full),
                                 lambda out: (out,))}
        if kind == "pass":
            calls["preempt_dry_run"] = (lambda: bindings.batched_dry_run(*batch),
                                        lambda out: out)
            calls["pass"] = (lambda: bindings.preemption_pass(batch, cl, pods, sel),
                             lambda out: out)
        else:
            calls[one] = calls["pod_filters"]
        return calls
    rows = (cl.label_bits, cl.topo_ids, sel.expr_ids, sel.expr_op, sel.expr_slot,
            sel.term_valid)
    mask = bindings.match_terms(*rows)

    def whole():
        out = (bindings.pod_filters(cl, pods, bindings.match_terms(*rows), full),)
        return (*bindings.batched_dry_run(*batch), *out) if kind == "pass" else out

    calls = {"match_terms": (lambda: bindings.match_terms(*rows), None),
             "pod_filters": (lambda: bindings.pod_filters(cl, pods, mask, full),
                             lambda out: (out,)),
             one: (whole, lambda out: out)}
    if kind == "pass":
        calls["preempt_dry_run"] = (lambda: bindings.batched_dry_run(*batch),
                                    lambda out: out)
    return calls


def preempt_want(kind: str, inputs, filters, pre) -> dict:
    """The plain versions' results of a preemption shape, by call name."""
    if kind == "victims":
        return {"dry_run_victims": tuple(pre.dry_run_victims_plain(*inputs))}
    batch, snap = inputs if kind == "pass" else (None, inputs)
    cl, sel = snap.cluster, snap.selectors
    pods = filters._pod_rows(filters.pod_view(snap.pods, 0)) if kind == "static_row" \
        else snap.pods
    mask = filters.match_rows_plain(cl, sel.expr_ids, sel.expr_op, sel.expr_slot,
                                    sel.term_valid)
    rows = (filters.filter_rows_plain(cl, pods, mask, kind == "full"),)
    if kind != "pass":
        return {"pod_filters": rows, "filters": rows}
    dry = tuple(pre.batched_dry_run_plain(batch))
    return {"pod_filters": rows, "preempt_dry_run": dry, "pass": (*dry, *rows)}


# each tree's PreemptionBasic passes and c9's batched pass, end to end, in a
# fresh process from the tree's root; only chip_smoke.py helpers that every
# tree whose chip_smoke.py has the preemption phases has
E2E_CODE = """
import json, sys, time
import torch
import chip_smoke as c
from kubernetes_tpu_torch.models.batch_scheduler import TorchBatchScheduler
from kubernetes_tpu_torch.testing import wrappers as w
T = c.recording(TorchBatchScheduler)
from kubernetes_tpu_torch.testing.cases import c9_objects
s, ca, ev, pods = c.preemption_basic(w, T, c.PREEMPT)
keys, recs, _pods, wall = c.preemption_run(s, ca, ev, pods, int(sys.argv[1]))
nodes, victims, failed, pdb = c9_objects(w, *c.C9)
_s, _c, ev9 = c.preemption_setup(T, nodes, victims, failed, [pdb])
batched, split = [], []
for i in range(4):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ev9.shared_pass(failed) as ctx:
        [ev9._candidates(p) for p in failed]
        torch.cuda.synchronize()
        batched.append(time.perf_counter() - t0)
        split.append(dict(ctx.timings))
print(json.dumps({"dispatch_s": [r["dispatch_s"] for r in recs],
                  "encode_s": [r["encode_s"] for r in recs],
                  "pass_s": [r["pass_s"] for r in recs], "preempted": len(keys),
                  "c9_batched_s": batched, "c9_pass_split": split}))
"""


def preempt_e2e(other_dir: Path, cycles: int) -> dict:
    """dispatch_s of PreemptionBasic/5000Nodes' passes and c9's batched_s
    (the first of its four passes pays the shapes' first use), each tree
    in a fresh process from its root: other, change, change, other."""
    roots = {"other": other_dir.parent.parent, "change": Path(__file__).resolve().parent}
    runs = {"other": [], "change": []}
    for which in ("other", "change", "change", "other"):
        proc = subprocess.run([sys.executable, "-c", E2E_CODE, str(cycles)], cwd=roots[which],
                              capture_output=True, text=True, check=True)
        runs[which].append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps({"kernel": "preempt", "shape": "D", "tree": which,
                          **runs[which][-1]}), flush=True)
    return {"kernel": "preempt", "shape": "D", "workload": SHAPES["preempt"]["D"][1],
            "roots": {k: str(v) for k, v in roots.items()}, "runs": runs}


def preempt_ab(shapes, other_dir: Path, out_dir: Path, torch) -> list:
    """The preemption calls at each shape: the other tree's own sequence
    against this tree's, each result equal to the plain versions' on the
    same inputs; other, change, change, other; each call's card time
    alone and host clock (chip_smoke.launch_ms).  One row a shape."""
    import importlib

    from kubernetes_tpu_torch.kernels import bindings, build
    from kubernetes_tpu_torch.models.batch_scheduler import TorchBatchScheduler
    from kubernetes_tpu_torch.ops import filters
    from kubernetes_tpu_torch.ops import preemption as pre
    from kubernetes_tpu_torch.testing import wrappers

    names = ["pod_filters", "preempt_dry_run"]
    change_reports = {}
    for name in names:
        build._libs[name], change_reports[name] = build_library(name, build.CSRC_DIR, out_dir)
    other_names = names + (["match_terms"] if (other_dir / "match_terms.cu").exists() else [])
    other, other_reports = load_other_bindings(other_dir, out_dir, other_names)
    other_filters = importlib.import_module("kt_other.ops.filters")
    build.build_all([k for k in build.KERNELS if k not in names])   # the inputs' kernels
    rows = []
    for shape in shapes:
        iters, workload = SHAPES["preempt"][shape]
        if shape == "D":
            rows.append(preempt_e2e(other_dir, iters))
            continue
        kind, inputs = chip_smoke.preempt_shape(wrappers, chip_smoke.recording(
            TorchBatchScheduler), shape)
        torch.cuda.synchronize()
        want = preempt_want(kind, inputs, filters, pre)
        calls = {"other": preempt_calls(other, other_filters, kind, inputs),
                 "change": preempt_calls(bindings, filters, kind, inputs)}
        card = {w: {k: [] for k in calls[w]} for w in calls}
        host = {w: {k: [] for k in calls[w]} for w in calls}
        for which in ("other", "change", "change", "other"):
            for name, (call, view) in calls[which].items():
                if view is not None:
                    chip_smoke.check_equal(f"preempt {shape} ({which} {name})", view(call()),
                                           want[name], torch)
                ms, host_ms = chip_smoke.launch_ms(call, lambda: None, iters, torch)
                card[which][name].append(ms)
                host[which][name].append(host_ms)
        med = lambda d: {w: {k: statistics.median(v) for k, v in d[w].items()} for w in d}
        row = {"kernel": "preempt", "shape": shape, "workload": workload,
               "other_source": str(other_dir), "launches_a_timing": iters,
               "card_ms": card, "median_card_ms": med(card),
               "host_ms": host, "median_host_ms": med(host), "equal_plain": True}
        if kind == "pass":
            batch, snap = inputs
            row.update(padded_nodes=int(batch.free.shape[0]), slots=int(batch.perm.shape[2]),
                       levels=int(batch.perm.shape[0]), pods=int(batch.pods_req.shape[0]),
                       static_nodes=int(snap.cluster.node_valid.shape[0]),
                       selector_rows=int(snap.selectors.term_valid.shape[0]))
        elif kind == "victims":
            row.update(shape_ckr=list(inputs[1].shape))
        else:
            row.update(padded_nodes=int(inputs.cluster.node_valid.shape[0]),
                       selector_rows=int(inputs.selectors.term_valid.shape[0]))
        rows.append(row)
        print(json.dumps(row), flush=True)
    for row in rows:
        row["ptxas"] = {"change": change_reports, "other": other_reports}
    return rows


# ---- the residents: partials_eval and mirror_rows, each tree's whole step ----


def resident_trees(other_dir: Path, out_dir: Path):
    """{"other": (ops.partials, ops.device, bindings), "change": ...}: the
    other tree's package loaded as `kt_other` with its two resident
    libraries built by build_library, this tree's with its own; the
    kernels that make the inputs built as the package builds them.
    Returns (trees, ptxas reports)."""
    import importlib

    from kubernetes_tpu_torch.kernels import bindings, build
    from kubernetes_tpu_torch.ops import device as dv
    from kubernetes_tpu_torch.ops import partials as pops

    names = ["partials_eval", "mirror_rows"]
    change_reports = {}
    for name in names:
        build._libs[name], change_reports[name] = build_library(name, build.CSRC_DIR, out_dir)
    other, other_reports = load_other_bindings(other_dir, out_dir, names)
    build.build_all([k for k in build.KERNELS if k not in names])
    trees = {"other": (importlib.import_module("kt_other.ops.partials"),
                       importlib.import_module("kt_other.ops.device"), other),
             "change": (pops, dv, bindings)}
    return trees, {"change": change_reports, "other": other_reports}


def resident_case(shape: str, torch) -> dict:
    """The inputs of a residents shape on the card, made with this tree's
    package and chip_smoke.py's builders."""
    from kubernetes_tpu_torch.models.batch_scheduler import TorchBatchScheduler
    from kubernetes_tpu_torch.testing import wrappers

    T = chip_smoke.recording(TorchBatchScheduler)
    if shape in ("R", "R500", "U500", "S64"):
        sched, _snap, _meta = chip_smoke.affinity_snapshot(wrappers, T)
        return chip_smoke.affinity_cases(sched, torch)[shape]
    if shape in ("VR", "VM"):
        sched, cache, ev, pods = chip_smoke.preemption_basic(wrappers, T, chip_smoke.PREEMPT)
        verify = chip_smoke.hook_first_pass(sched, ev)
        chip_smoke.preemption_cycle(sched, cache, ev, pods[: chip_smoke.PREEMPT_PASS])
        cases = chip_smoke.verify_cases(verify)
        return dict(cases["VR"], mirror=cases["VM"]) if shape == "VR" else cases["VM"]
    if shape in ("RI", "SP"):
        return chip_smoke.crossing_cases(wrappers, T, torch)[shape]
    raise ValueError(f"no residents shape {shape}")


def partials_step(pops, case: dict, torch):
    """A tree's partials work for the case: a tree with ops.partials.
    update_store makes one call (a fresh store, one launch); an earlier
    tree runs the reference's order — the column grow and its refresh,
    the insert of the missed slots, the dirty refresh — each
    clone-then-launch.  Returns the step (no arguments -> the store)."""
    miss, cols, grown, dirty = chip_smoke.partials_indices(case, torch)
    st, specs, cl = case["store"], case["specs"], case["cluster"]
    if case["full"]:
        return lambda: tuple(pops.eval_store(cl, specs))
    if hasattr(pops, "update_store"):
        slots = miss if miss.numel() else None
        return lambda: tuple(pops.update_store(st, specs, cl, slots, cols if cols.numel()
                                               else None))
    old_n, n = case["old_n"], case["n"]

    def step():
        out = st
        if n > old_n:
            out = pops.refresh_rows(pops.grow_store_cols(out, n - old_n), specs, cl, grown)
        elif n < old_n:
            out = pops.shrink_store_cols(out, n)
        if miss.numel():
            out = pops.insert_slots(out, specs, cl, miss)
        if dirty.numel():
            out = pops.refresh_rows(out, specs, cl, dirty)
        return tuple(out)

    return step


def mirror_step(dv, bindings, case: dict, torch):
    """(reset, step) of a tree's mirror delta: reset packs the rows
    (outside the timing); the step of a tree whose RowTarget names the
    resident leaf (`src`) is its one binding call (the fresh leaves made by
    the launch); an earlier tree's is a copy of each leaf, then its launch
    into the copies."""
    leaves = case["leaves"]
    stage = dv.PinnedStage()
    dev = torch.device("cuda")
    box = {}
    if "src" in dv.RowTarget._fields:
        targets = [dv.RowTarget(src, ax, idx, vals) for _f, src, ax, idx, vals in leaves]

        def reset():
            box["pack"] = dv.pack_rows(targets, stage, dev)

        return reset, lambda: tuple(bindings.mirror_rows(box["pack"]))
    copies = [torch.empty_like(src) for _f, src, _a, _i, _v in leaves]
    targets = [dv.RowTarget(c, ax, idx, vals)
               for c, (_f, _s, ax, idx, vals) in zip(copies, leaves)]

    def reset():
        box["pack"] = dv.pack_rows(targets, stage, dev)

    def step():
        for c, (_f, src, _a, _i, _v) in zip(copies, leaves):
            c.copy_(src)
        buf, _lay, units = box["pack"]
        bindings.mirror_rows(buf, len(targets), units)
        return tuple(copies)

    return reset, step


def resident_row(shape: str, other_dir: Path, out_dir: Path, torch) -> dict:
    """One residents shape in this process: each tree's whole step on the
    same inputs, other, change, change, other; each result equal to the
    plain one (the reference's order / clone + index_copy_ on CPU copies)
    and the resident inputs byte-unchanged after it; the card's time of
    the step alone behind a spin and its host clock (chip_smoke.launch_ms)."""
    import numpy as np

    trees, reports = resident_trees(other_dir, out_dir)
    case = resident_case(shape, torch)
    torch.cuda.synchronize()
    iters, workload = SHAPES["residents"][shape]
    kind = case["kind"]
    if kind == "partials":
        want = chip_smoke.partials_want(case, torch)
        inputs = tuple(case["store"])
        calls = {w: (lambda: None, partials_step(pops, case, torch))
                 for w, (pops, _dv, _b) in trees.items()}
        cols = chip_smoke.partials_indices(case, torch)[1]
        d_all = case["n"] if case["full"] else int(cols.numel())
        need = chip_smoke.partials_update_need(
            case["cluster"], case["specs"], 0 if case["full"] else case["old_n"], case["n"],
            d_all, int(case["miss"].shape[0]), torch)
    else:
        want = chip_smoke.mirror_want(case, torch)
        inputs = tuple(src for _f, src, _a, _i, _v in case["leaves"])
        calls = {w: mirror_step(dv, b, case, torch) for w, (_p, dv, b) in trees.items()}
        need = chip_smoke.mirror_rows_need(case["leaves"])
    before = [t.cpu().clone() for t in inputs]
    card = {"other": [], "change": []}
    host = {"other": [], "change": []}
    for which in ("other", "change", "change", "other"):
        reset, step = calls[which]
        reset()
        chip_smoke.check_equal(f"residents {shape} ({which})", step(), want, torch)
        ms, host_ms = chip_smoke.launch_ms(step, reset, iters, torch)
        card[which].append(ms)
        host[which].append(host_ms)
    for t, b in zip(inputs, before):
        if not torch.equal(t.cpu(), b):
            raise AssertionError(f"residents {shape}: a resident input changed")
    row = {"kernel": "residents", "shape": shape, "workload": workload,
           "other_source": str(other_dir), "launches_a_timing": iters,
           "card_ms": card, "median_card_ms": {k: statistics.median(v) for k, v in card.items()},
           "host_ms": host, "median_host_ms": {k: statistics.median(v) for k, v in host.items()},
           "bound_ms": chip_smoke.bound(*need), "equal_plain": True, "inputs_unchanged": True,
           **{k: case[k] for k in ("seen",) if k in case}}
    if kind == "partials":
        row.update(slots=int(case["specs"].valid.shape[0]), old_n=case["old_n"], n=case["n"],
                   missed=int(case["miss"].shape[0]), dirty=int(case["dirty"].shape[0]))
    else:
        row.update(leaves=len(case["leaves"]), rows=int(case["leaves"][0][3].shape[0]),
                   packed_bytes=int(sum(np.asarray(v).nbytes
                                        for *_r, v in case["leaves"])))
    if shape == "VR":
        # one warm delta sync's device operations at VR + VM, each tree
        ops = {}
        for which, (pops, dv, b) in trees.items():
            reset, mstep = mirror_step(dv, b, case["mirror"], torch)
            pstep = partials_step(pops, case, torch)
            reset()
            ops[which] = chip_smoke.device_ops(lambda: (mstep(), pstep()), torch)
        row["device_ops_vr_vm"] = ops
    row["ptxas"] = reports
    return row


def residents_ab(shapes, other_dir: Path, out_dir: Path, torch) -> list:
    """Each residents shape in a fresh process of this script (its own
    inputs, the build cached on disk), one JSON row each."""
    rows = []
    for shape in shapes:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "residents-one",
                               str(other_dir), shape], capture_output=True, text=True)
        if proc.returncode:
            sys.stderr.write(proc.stderr[-6000:])
            raise RuntimeError(f"residents {shape}: exit {proc.returncode}")
        rows.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps({k: v for k, v in rows[-1].items() if k != "ptxas"}), flush=True)
    return rows


# ---- the inter-pod stage and the family preps, each tree's own calls ---------


def tree_pair(names, other_dir: Path, out_dir: Path, change_dir=None):
    """({"other": bindings, "change": bindings}, ptxas reports): the other
    tree's package loaded as `kt_other`; the change side this tree's, or
    with change_dir another tree's package loaded as `kt_change` (step 0:
    the parent on both sides); each side's libraries of `names` built by
    build_library, the inputs' kernels as the package builds them."""
    from kubernetes_tpu_torch.kernels import bindings, build

    other, other_reports = load_other_bindings(other_dir, out_dir, names)
    if change_dir is not None:
        change, change_reports = load_other_bindings(change_dir, out_dir, names, "kt_change")
    else:
        change, change_reports = bindings, {}
        for name in names:
            build._libs[name], change_reports[name] = build_library(name, build.CSRC_DIR,
                                                                    out_dir)
    build.build_all([k for k in build.KERNELS if k not in names])
    return {"other": other, "change": change}, {"other": other_reports, "change": change_reports}


def interpod_case(shape: str, torch) -> dict:
    """Round 0's inputs of the inter-pod repair at a shape
    (chip_smoke.auction_round_inputs along the plain trajectory)."""
    from kubernetes_tpu_torch.kernels import bindings
    from kubernetes_tpu_torch.models.batch_scheduler import TorchBatchScheduler
    from kubernetes_tpu_torch.ops import auction, device as dv, schema
    from kubernetes_tpu_torch.ops.scores import DEFAULT_SCORE_CONFIG
    from kubernetes_tpu_torch.testing import cases, wrappers

    if shape == "A":
        sched, snap, meta = chip_smoke.measured_snapshot(
            wrappers, TorchBatchScheduler, "pod_anti_affinity_objects", chip_smoke.ANTI)
        cfg, tie_k = sched.score_config, meta.tie_k
    else:
        nodes, pods, bound = cases.many_anti_terms_objects(wrappers, 5000, 20, 50, 8)
        snap = dv.to_device(schema.SnapshotBuilder().build(nodes, pods, bound_pods=bound)[0],
                            "cuda")
        cfg, tie_k = DEFAULT_SCORE_CONFIG, None
    return chip_smoke.auction_round_inputs(snap, cfg, tie_k, auction, bindings, torch)


def interpod_calls(trees: dict, inp: dict) -> dict:
    """{side: (launch, reset, result)} of each tree's auction_interpod stage
    alone on round 0's inputs: its AuctionRun made once, the state, the
    accepted set and the term bits reset before each launch."""
    from kubernetes_tpu_torch.kernels import bindings

    calls = {}
    for which, b in trees.items():
        st = inp["st"] if b is bindings else other_statics(inp["st"], b.__name__.split(".")[0])
        run = b.AuctionRun(inp["cluster"], inp["pods"], st, inp["tie_k"], inp["cfg"], 64)
        run.load(0, inp["req"], inp["nz"], inp["assigned"], inp["bid_scores"], inp["counts"],
                 inp["bits_before"])
        run.bufs["bid"].copy_(inp["bid"])
        run.bufs["val"].copy_(inp["val"])
        go = run.state.clone()

        def reset(run=run, go=go):
            run.state.copy_(go)
            run.bufs["accept"].copy_(inp["accept_before"])
            for t, t0 in zip(run.bits, inp["bits_before"]):
                t.copy_(t0)

        calls[which] = (run.interpod, reset,
                        lambda run=run: (run.bufs["accept"].bool(), *run.bits))
    return calls


def interpod_row(shape: str, trees: dict, torch) -> dict:
    """The auction_interpod stage alone at a shape: each tree's launch on
    the same round-0 inputs, other, change, change, other, each result
    equal to interpod_repair_plain's; the card alone behind a spin and the
    host clock (chip_smoke.launch_ms)."""
    from kubernetes_tpu_torch.kernels import bindings
    from kubernetes_tpu_torch.ops import auction

    inp = interpod_case(shape, torch)
    iters, workload = SHAPES["interpod"][shape]
    st, cluster = inp["st"], inp["cluster"]
    kept, bits = auction.interpod_repair_plain(inp["accept_before"], inp["bid"], st,
                                               cluster.topo_ids, inp["bits_before"])
    calls = interpod_calls(trees, inp)
    card = {"other": [], "change": []}
    host = {"other": [], "change": []}
    for which in ("other", "change", "change", "other"):
        launch, reset, result = calls[which]
        reset()
        launch()
        chip_smoke.check_equal(f"interpod {shape} ({which})", result(), (kept, *bits), torch)
        ms, host_ms = chip_smoke.launch_ms(launch, reset, iters, torch)
        card[which].append(ms)
        host[which].append(host_ms)
    table = st.tm.table
    accepted = inp["accept_before"]
    return {"kernel": "interpod", "shape": shape, "workload": workload,
            "launches_a_timing": iters, "card_ms": card,
            "median_card_ms": {k: statistics.median(v) for k, v in card.items()},
            "host_ms": host, "median_host_ms": {k: statistics.median(v) for k, v in host.items()},
            "bound_ms": chip_smoke.bound(*chip_smoke.auction_interpod_need(
                st, accepted, inp["bid"], inp["bits_before"], cluster, torch)),
            "terms": int(table.valid.shape[0]), "valid_terms": int(table.valid.sum()),
            "words": (int(table.valid.shape[0]) + 31) // 32, "accepted": int(accepted.sum()),
            "kept": int(kept.sum()), "padded_nodes": int(cluster.topo_ids.shape[0]),
            "padded_pods": int(accepted.shape[0]), "z_terms": int(st.tm.z),
            "cluster_blocks_threads": list(bindings.scan_shape(cluster.topo_ids.shape[0])),
            "equal_plain": True}


def family_case(shape: str, torch):
    """(snapshot, meta) of a family shape on the card."""
    from kubernetes_tpu_torch.models.batch_scheduler import TorchBatchScheduler
    from kubernetes_tpu_torch.testing import wrappers

    if shape == "T":
        return chip_smoke.spread_snapshot(wrappers, TorchBatchScheduler)[1:]
    if shape in ("A", "P"):
        objects, dims = (("pod_anti_affinity_objects", chip_smoke.ANTI) if shape == "A"
                         else ("preferred_affinity_objects", chip_smoke.PREFERRED))
        return chip_smoke.measured_snapshot(wrappers, TorchBatchScheduler, objects, dims)[1:]
    sched = TorchBatchScheduler()
    for node in chip_smoke.make_cluster(wrappers, chip_smoke.NORTH[0]):
        sched.add_node(node)
    return chip_smoke.wide_family_snapshot(wrappers, sched)


def family_tree_calls(b, snap, meta, sel_mask) -> dict:
    """{entry: call} of a tree's family_prep bindings on a snapshot, with
    the wrappers' arguments (ops/topology.py prep_spread,
    ops/interpod.py prep_terms / prep_pref_pod)."""
    from kubernetes_tpu_torch.ops import interpod

    f, (z_spread, z_terms) = meta.features, meta.topo_split
    cl = snap.cluster
    calls = {}
    if f.spread:
        calls["spread"] = lambda: tuple(b.family_prep_spread(cl, sel_mask, snap.spread, z_spread,
                                                             f.bound_spread))
    if f.interpod:
        slots = interpod.used_slots(f.term_slots, cl.topo_ids.shape[1])
        calls["terms"] = lambda: tuple(b.family_prep_terms(cl, snap.terms, z_terms, slots,
                                                           f.bound_terms))
    if f.interpod_pref:
        calls["pref"] = lambda: tuple(b.family_prep_pref(cl, snap.prefpod, z_terms,
                                                         f.bound_pref))
    return calls


def family_row(shape: str, trees: dict, torch) -> dict:
    """Every family_prep entry a shape's batch uses: each tree's binding
    call on the same inputs, other, change, change, other, each result
    equal to the plain twin's; the card alone behind a spin and the host
    clock (chip_smoke.launch_ms); each call's device operations
    (torch.profiler, one call each after the timing)."""
    from kubernetes_tpu_torch.ops import filters

    snap, meta = family_case(shape, torch)
    iters, workload = SHAPES["family"][shape]
    sel_mask = filters.selector_match(snap.cluster, snap.selectors)
    plain = chip_smoke.family_calls(snap, meta.features, meta.topo_split, filters, True)
    states = {e: fn() for e, fn in plain.items()}
    want = {e: tuple(st) for e, st in states.items()}
    calls = {w: family_tree_calls(b, snap, meta, sel_mask) for w, b in trees.items()}
    card = {w: {e: [] for e in calls[w]} for w in calls}
    host = {w: {e: [] for e in calls[w]} for w in calls}
    for which in ("other", "change", "change", "other"):
        for entry, call in calls[which].items():
            chip_smoke.check_equal(f"family {shape} {entry} ({which})", call(), want[entry],
                                   torch)
            ms, host_ms = chip_smoke.launch_ms(call, lambda: None, iters, torch)
            card[which][entry].append(ms)
            host[which][entry].append(host_ms)
    ops = {w: {e: chip_smoke.device_ops(c, torch) for e, c in calls[w].items()} for w in calls}
    need = {"spread": lambda: chip_smoke.prep_spread_need(snap, sel_mask, states["spread"],
                                                          torch),
            "terms": lambda: chip_smoke.prep_terms_need(snap, meta.features, states["terms"],
                                                        torch),
            "pref": lambda: chip_smoke.prep_pref_pod_need(snap, states["pref"], torch)}
    med = lambda d: {w: {e: statistics.median(v) for e, v in d[w].items()} for w in d}
    return {"kernel": "family", "shape": shape, "workload": workload,
            "launches_a_timing": iters, "card_ms": card, "median_card_ms": med(card),
            "host_ms": host, "median_host_ms": med(host),
            "bound_ms": {e: chip_smoke.bound(*need[e]()) for e in want},
            "device_ops": {w: {e: (o["kernels"] + o["dtod"] + o["htod"] + o["memset"]
                                   if o else None) for e, o in d.items()}
                           for w, d in ops.items()},
            "device_op_names": {w: {e: (o["names"] if o else None) for e, o in d.items()}
                                for w, d in ops.items()},
            "padded_nodes": int(snap.cluster.allocatable.shape[0]),
            "z": list(meta.topo_split), "equal_plain": True}


def tail_snapshot(name: str, torch) -> tuple:
    """(snapshot, meta, score config) of a tail shape's batch on the card."""
    from kubernetes_tpu_torch.models.batch_scheduler import TorchBatchScheduler
    from kubernetes_tpu_torch.ops.scores import DEFAULT_SCORE_CONFIG
    from kubernetes_tpu_torch.testing import wrappers

    if name == "PG":
        return (*chip_smoke.fractional_gang_snapshot(wrappers, torch), DEFAULT_SCORE_CONFIG)
    sched, snap, meta = AUCTION_BUILDS[name](wrappers, TorchBatchScheduler)
    if meta.route != "auction":
        raise AssertionError(f"tail shape {name} took route {meta.route}")
    return snap, meta, sched.score_config


_TAIL_SNAP = {}   # the last tail snapshot built (G serves reasons/G and gang/G0)


def tail_row(shape: str, trees: dict, torch) -> dict:
    """A tail stage alone at a shape: each tree's launch on the same state,
    other, change, change, other, each result equal to the plain twin's on
    CPU copies; the card alone behind a spin and the host clock
    (chip_smoke.launch_ms)."""
    from kubernetes_tpu_torch.kernels import bindings
    from kubernetes_tpu_torch.ops import auction

    stage, key = shape.split("/")
    name = {"G": "GD", "G0": "G", "E0": "G"}.get(key, key) if stage == "gang" else key
    if name not in _TAIL_SNAP:
        _TAIL_SNAP.clear()
        _TAIL_SNAP[name] = tail_snapshot(name, torch)
    snap, meta, cfg = _TAIL_SNAP[name]
    if key == "E0":
        meta = SimpleNamespace(features=meta.features, topo_split=meta.topo_split,
                               tie_k=meta.tie_k, n_groups=0)
    iters, workload = SHAPES["tail"][shape]
    row = {"kernel": "tail", "shape": shape, "workload": workload, "launches_a_timing": iters}

    def statics_of(b):   # st as tree b's statics
        return (lambda st: st) if b is bindings else (
            lambda st: other_statics(st, b.__name__.split(".")[0]))

    # the state the stage starts from: the change side's loop launch
    change = trees["change"]
    if stage == "reasons":
        cluster, pods, st, final, want = chip_smoke.final_state(
            snap, meta, cfg, auction, change, torch, statics_of(change))
        want = (want,)
        need = chip_smoke.reasons_need(cluster, pods, st, *final, torch=torch)

        def call(b, st_b):
            return chip_smoke.reasons_stage_call(b, cluster, pods, st_b, final)
    else:
        cluster, pods, st, before = chip_smoke.gang_inputs(snap, meta, cfg, auction, change,
                                                           statics_of(change))
        c_args = chip_smoke.cpu_args((pods, *before[:2], before[4], *before[2:4]), torch)
        want = auction.gang_post_pass_plain(*c_args, meta.n_groups)
        d, nodes = chip_smoke.dropped_on(before[0], want[3], torch)
        need = chip_smoke.gang_need(pods, d, nodes)
        row["dropped"] = d

        def call(b, st_b):
            return chip_smoke.gang_stage_call(b, cluster, pods, st_b, meta.tie_k, cfg,
                                              meta.n_groups, before)
    calls = {which: call(b, statics_of(b)(st)) for which, b in trees.items()}
    card = {"other": [], "change": []}
    host = {"other": [], "change": []}
    for which in ("other", "change", "change", "other"):
        launch, reset, result = calls[which]
        reset()
        launch()
        chip_smoke.check_equal(f"tail {shape} ({which})", result(), want, torch)
        ms, host_ms = chip_smoke.launch_ms(launch, reset, iters, torch)
        chip_smoke.check_equal(f"tail {shape} ({which}, timed)", result(), want, torch)
        card[which].append(ms)
        host[which].append(host_ms)
    n = int(cluster.allocatable.shape[0])
    row.update({
        "card_ms": card, "median_card_ms": {k: statistics.median(v) for k, v in card.items()},
        "host_ms": host, "median_host_ms": {k: statistics.median(v) for k, v in host.items()},
        "bound_ms": chip_smoke.bound(*need), "padded_nodes": n,
        "padded_pods": int(pods.req.shape[0]), "gangs": int(meta.n_groups),
        "classes": {"joint": int(st.jspec.shape[0]), "spec": int(st.s_reps.shape[0]),
                    "constraint": int(st.k_reps.shape[0])},
        "cluster_blocks_threads": list(bindings.scan_shape(n)), "equal_plain": True})
    return row


def extras_case(shape: str, torch) -> tuple:
    """(class_extras' arguments, its bound) at an extras shape on the card."""
    from kubernetes_tpu_torch.kernels import bindings
    from kubernetes_tpu_torch.models.batch_scheduler import TorchBatchScheduler
    from kubernetes_tpu_torch.ops import assign, auction
    from kubernetes_tpu_torch.testing import wrappers

    if shape == "E+":
        snap, features = chip_smoke.single_snapshot(wrappers, TorchBatchScheduler, True)
        cfg = assign.DEFAULT_SCORE_CONFIG
        reps, feas = chip_smoke.single_pair(snap, features, assign, bindings, torch)
    else:
        sched, snap, meta = (chip_smoke.image_snapshot(wrappers, TorchBatchScheduler)
                             if shape == "I" else AUCTION_BUILDS["P"](wrappers,
                                                                      TorchBatchScheduler))
        if meta.route != "auction":
            raise AssertionError(f"extras shape {shape} took route {meta.route}")
        cfg, features = sched.score_config, meta.features
        reps, feas = chip_smoke.auction_pairs(snap, meta, cfg, auction)
    args = chip_smoke.class_extras_args(snap, features, cfg, reps, feas, assign)
    return args, chip_smoke.bound(*chip_smoke.class_extras_need(snap, features, reps, feas,
                                                                torch))


def slices_case(shape: str, torch) -> tuple:
    """(slice_stats' arguments, its bound) at a slices shape on the card:
    the batch's scan, then its post-release state."""
    from kubernetes_tpu_torch.kernels import bindings
    from kubernetes_tpu_torch.models.batch_scheduler import TorchBatchScheduler
    from kubernetes_tpu_torch.ops import assign
    from kubernetes_tpu_torch.testing import wrappers

    snap, meta = chip_smoke.c10_timed_snapshot(wrappers, TorchBatchScheduler, torch,
                                               gangs=shape == "C")
    if meta.route != "greedy" or not meta.features.slices:
        raise AssertionError(f"slices shape {shape}: route {meta.route}, "
                             f"slices {meta.features.slices}")
    args = chip_smoke.slice_stats_args(snap, meta.features, meta.n_groups,
                                       assign.DEFAULT_SCORE_CONFIG, assign, bindings)
    return args, chip_smoke.bound(*chip_smoke.slice_stats_need(*args[:2], args[3], args[4],
                                                               torch))


def binding_row(kernel: str, shape: str, trees: dict, torch) -> dict:
    """`extras` or `slices` at a shape: each tree's binding call (its
    class_extras or slice_stats) on the same inputs, other, change,
    change, other, each result equal to the plain version's on CPU
    copies; the card alone behind a spin and the host clock
    (chip_smoke.launch_ms)."""
    from kubernetes_tpu_torch.ops import assign
    from kubernetes_tpu_torch.ops import slices as slices_ops

    if kernel == "extras":
        args, (b_ms, by) = extras_case(shape, torch)
        fn, plain = "class_extras", assign.class_extras_plain
        want = (plain(*chip_smoke.cpu_args(args, torch)),)
        wrap = lambda out: (out,)
        size = {"pairs": int(args[5].shape[0]), "features": {
            "interpod_pref": bool(args[3].interpod_pref), "images": bool(args[3].images)},
            "change_blocks_clusters": list(trees["change"].class_extras_shape(*args[:4], args[5]))
            if hasattr(trees["change"], "class_extras_shape") else None}
    else:
        args, (b_ms, by) = slices_case(shape, torch)
        fn, plain = "slice_stats", slices_ops.carve_stats_plain
        want = plain(*args)
        wrap = lambda out: out
        size = {"gangs": int(args[5]), "slices": int(args[4].slice_z),
                "slice_dim": int(args[4].slice_dim), "padded_pods": int(args[1].req.shape[0])}
    iters, workload = SHAPES[kernel][shape]
    calls = {w: (lambda b=b: getattr(b, fn)(*args)) for w, b in trees.items()}
    card = {"other": [], "change": []}
    host = {"other": [], "change": []}
    for which in ("other", "change", "change", "other"):
        call = calls[which]
        chip_smoke.check_equal(f"{kernel} {shape} ({which})", wrap(call()), want, torch)
        ms, host_ms = chip_smoke.launch_ms(call, lambda: None, iters, torch)
        chip_smoke.check_equal(f"{kernel} {shape} ({which}, timed)", wrap(call()), want, torch)
        card[which].append(ms)
        host[which].append(host_ms)
    return {"kernel": kernel, "shape": shape, "workload": workload, "launches_a_timing": iters,
            "card_ms": card, "median_card_ms": {k: statistics.median(v) for k, v in card.items()},
            "host_ms": host, "median_host_ms": {k: statistics.median(v) for k, v in host.items()},
            "bound_ms": b_ms, "bound_by": by,
            "padded_nodes": int(args[0].allocatable.shape[0]), **size, "equal_plain": True}


def pair_ab(kernel: str, shapes, other_dir: Path, out_dir: Path, torch, change_dir=None) -> list:
    """`interpod` or `tail` (auction_loop's library on each side), `family`
    (family_prep's), `extras` (class_extras') or `slices` (slice_stats') at
    each shape, one JSON row a shape."""
    names = {"family": ["family_prep"], "extras": ["class_extras"],
             "slices": ["slice_stats"]}.get(kernel, ["auction_loop"])
    trees, reports = tree_pair(names, other_dir, out_dir, change_dir)
    row_of = {"interpod": interpod_row, "family": family_row, "tail": tail_row,
              "extras": lambda shape, t, torch: binding_row("extras", shape, t, torch),
              "slices": lambda shape, t, torch: binding_row("slices", shape, t, torch)}[kernel]
    rows = []
    for shape in shapes:
        row = row_of(shape, trees, torch)
        row.update(other_source=str(other_dir),
                   change_source=str(change_dir) if change_dir else "this tree")
        rows.append(row)
        print(json.dumps(row), flush=True)
    for row in rows:
        row["ptxas"] = reports
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

    if len(sys.argv) == 4 and sys.argv[1] == "residents-one":
        # one residents shape, in the process residents_ab started
        from kubernetes_tpu_torch.kernels import build

        out_dir = build.BUILD_DIR / "ab"
        out_dir.mkdir(parents=True, exist_ok=True)
        row = resident_row(sys.argv[3], Path(sys.argv[2]).resolve(), out_dir, torch)
        print(json.dumps(row), flush=True)
        return 0
    change_dir = None
    if "--change" in sys.argv:
        k = sys.argv.index("--change")
        change_dir = Path(sys.argv[k + 1]).resolve()
        del sys.argv[k : k + 2]
    pairs = ("interpod", "family", "tail", "extras", "slices")
    many = len(sys.argv) > 1 and sys.argv[1] in ("statics", "preempt", "residents", *pairs)
    if len(sys.argv) < 3 or sys.argv[1] not in SHAPES or (len(sys.argv) > 4 and not many):
        print(__doc__, file=sys.stderr)
        return 2
    kernel, other_dir = sys.argv[1], Path(sys.argv[2]).resolve()
    shapes = sys.argv[3:] or ([*SHAPES[kernel]] if kernel in ("residents", *pairs)
                               else [next(iter(SHAPES[kernel]))])
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
    if many:
        if kernel in pairs:
            rows = pair_ab(kernel, shapes, other_dir, out_dir, torch, change_dir)
        else:
            run = {"statics": statics_ab, "preempt": preempt_ab, "residents": residents_ab}[kernel]
            rows = run(shapes, other_dir, out_dir, torch)
        print(chip_smoke.card_line(), flush=True)
        print(json.dumps({"kernel": kernel, "shapes": shapes,
                          "ptxas": rows[0].get("ptxas") if rows else None}), flush=True)
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
