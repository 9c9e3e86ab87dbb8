"""Drive the torch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py [--log PATH]

Every TorchBatchScheduler below runs the reference's default
configuration: the resident cluster mirror and the warm partials on
(use_mirror=False is the cold path).  Phases (one JSON line each on
stdout; with --log also appended to PATH):

  build      build the thirteen CUDA sources of kubernetes_tpu_torch/csrc
             (one nvcc each, started together)
  parity     each kernel against its plain torch version, exact (on the
             card, or on CPU copies of the inputs where the plain version
             adds in pod index order: the scan, the wavefront and the
             auction's commit), on mixed small batches (selectors, taints, ports, gangs, all
             three fit strategies), PodTopologySpread batches (zone and
             hostname keys, maxSkew 1-5, hard and soft, minDomains, matching
             bound pods, gangs) and inter-pod, preferred inter-pod and
             ImageLocality batches (default weights and weights that are not
             powers of two): the greedy scan; the wavefront with the
             planner's waves and with random partitions (coupled waves and
             fit flips); the auction program's stages (auction_bids,
             auction_accept, auction_spread, auction_interpod: each launched
             alone) round by round and the whole loop in one launch
             (auction_loop), on batches without in-batch ports or
             affinity-direction terms (some also against the plain loop on
             the CPU, among them a gang released past float32's exact
             range: the gang stage inside the one auction_loop launch, and
             the stage alone timed with its bound, PG);
             class_extras on the scan's and the auction's pairs;
             class_statics (the cold statics prep in one launch) with and
             without the selector mask against match_rows_plain +
             class_statics_plain, and match_terms (the masks-only entry)
             on both tables, on every batch
  overlay    the reservations overlay on the card against the CPU: twelve
             nominated pods with requests that are not whole MiB on a node
             already past float32's exact range, two on another; the
             overlaid usage and the batch equal
  resident_parity
             partials_eval and mirror_rows against their plain versions on
             the mixed and family batches (a warm scheduler's store, column
             refreshes, one sync's fresh store with missed slots, 0-33
             dirty columns, a grow and a shrink, the old store unchanged,
             a delta sync against the state) and on random leaves of every
             dtype into fresh leaves (16-, 4- and 1-byte units, the old
             leaves unchanged)
  main       SchedulingBasic/5000Nodes through TorchBatchScheduler() on its
             default route: 5,000 nodes, 1,000 init pods scheduled and
             assumed, then a measured 1,000-pod batch; both pad to 1,024
             pods and take the auction (cold statics, the mirror's delta)
  greedy     the same measured batch through TorchBatchScheduler(
             mode="greedy", use_wavefront=False): the classic scan, warm
  wavefront  SchedulingNodeAffinity/5000Nodes: 5,000 nodes, 1,000 init and
             1,000 measured pods with a required zone affinity, in batches
             of 500 (padded to 512: the wavefront route, warm)
  spread     TopologySpreading/5000Nodes: 5,000 nodes, 5,000 init pods
             (padded to 8,192: the auction) scheduled and assumed, then the
             2,000 measured pods of maxSkew 5 on the zone (padded to 2,048:
             the auction with its spread repair) through
             TorchBatchScheduler(); the same measured batch on the scan
             (mode="greedy", use_wavefront=False), in 500-pod batches (the
             wavefront), and with whenUnsatisfiable: ScheduleAnyway (the
             auction, scored by the soft spread score); every result equal
             to the plain path's on the CPU for the same snapshot, and each
             kernel of the spread path timed at these shapes; family_prep
             (entry spread) against its plain twin on the card and on the
             CPU for every batch of the phase (T timed; S the wavefront's);
             the auction's reasons stage, launched alone on the measured
             batch's final state, equal to the loop's own run of it and to
             the plain twin on the CPU
  interpod   SchedulingPodAntiAffinity/5000Nodes (1,000 init pods in
             sched-0, 1,000 measured in sched-1, both padded to 1,024: the
             auction with auction_interpod; the measured batch also on the
             scan; no two color=green pods on a node) and
             SchedulingPodAffinity/5000Nodes (init and measured on the
             wavefront, one-pod waves; the measured batch also on the scan;
             every measured pod in a zone of a color=blue pod), every batch
             equal to the plain path on the CPU; auction_interpod and
             family_prep (entry terms: A timed, every other batch of the
             phase, F among them, checked against its plain twin on the
             card and on the CPU) timed at these shapes; then the repair's
             edges (interpod_edges: 40 terms in two words on the hostname
             and zone slots, value capacities 32 and 5), stage by stage and
             the whole loop against the plain versions.  Every family_prep
             call of every phase leaves its scratch all zero; at T, A, P,
             the 65,536-node batch and the extender's variants one more
             call, captured into a CUDA graph, is exactly one kernel node
  extras     the preferred-affinity variant (upstream's
             SchedulingPreferredPodAffinity shape: 5,000 nodes, 1,000 init
             and 1,000 measured pods; the auction with class_extras, and the
             scan) and a synthetic ImageLocality batch (5,000 nodes, 1,000
             pods; the auction and the scan), every batch equal to the plain
             path on the CPU; class_extras timed at the preferred batch's
             auction pairs (P) and the image batch's (I), family_prep
             (entry pref: P timed, the phase's other batches checked)
  slices     the randomized slice cases (seeds 0-5) and a multi-core
             coordinate case under both policies, greedy_scan's carve-out
             stage, slice_stats and evaluate_single against their plain
             versions; then bench.py's c10 at full width (4,096 nodes as 64
             slices of 4x4x4, six rounds of 208 pods in 26 gangs, half the
             live gangs leaving between rounds) through
             TorchBatchScheduler(carveout_policy=...) under "prefer" and
             "require", each round equal to the same scheduler on the CPU
             field for field (placements, scores, reasons, usage and the
             four carve-out counters), on the scan; the contiguous rate and
             the final fragmentation beside bench.py's gates; greedy_scan
             and slice_stats timed at the c10 shape
  extender   SchedulingBasic/5000Nodes behind the HTTP extender on
             127.0.0.1: 200 filter + 200 prioritize requests in
             nodeCacheCapable mode, every response equal to a CPU backend's;
             variant pods (spread, soft spread, anti-affinity, preferred
             affinity, image) and a shaped pod on a c10 slice cluster under
             both policies; requests/s; evaluate_single timed at 8,192
             padded nodes; the basic window's launches exactly one
             class_statics and one evaluate_single a request, no
             match_terms
  proto      one SolveRequest of 1,000 pods onto 5,000 nodes over the
             socket to the card's proto service (the auction, cold), the
             response equal to the CPU backend's
  preemption_parity (after resident_parity)
             preempt_dry_run (both entries) and pod_filters (both modes,
             its selector rows evaluated in the launch) against their plain
             versions on the card, exact: victim axes of 4 to 300 slots and
             256, 257, 513 and 4,096 (PARITY_K) of not-whole-MiB memory,
             bounds 0, 1, K - 1, K, +inf free and junk, PDB reorders, three
             levels, two pod groups, masks that are not prefixes, rows of 4,
             8, 16 and 32 lanes (PARITY_NARROW); the mixed parity
             snapshots; the pass's one binding call (preemption_pass);
             whether torch.cumsum would have summed as the reference does
  scan_edges (after preemption_parity)
             greedy_scan, one thread-block cluster of 2 to 16 blocks (the
             blocks and their threads at 4,096 / 8,192 / 16,384 / 65,536
             padded nodes printed), at its cluster's edges, each against
             its plain version, exact: scan batches of 1 and 16 pods at
             50,000 nodes (65,536 padded, 16 blocks; the 16-pod batch
             timed with its bound); 8,192 nodes whose only feasible nodes
             are the last block's; 8,192 identical nodes (every node ties:
             node 0 first); and ties that start at node 1,500, inside a
             block's chunk (node 1,500 first); then a
             spread auction of 1,500 pods on 2,000 nodes with
             hostname-keyed hard rows (and zone rows), a value space past
             auction_spread's shared counter table, round by round and
             whole against the plain path
  preemption PreemptionBasic/5000Nodes through TorchBatchScheduler() and
             PreemptionEvaluator as the reference's loop drives them: 5,000
             node-default nodes, 20,000 pod-low-priority victims (four a
             node), measured pod-high-priority pods in cycles of 16 (solve,
             one PostFilter pass, the nominees solve onto their nominated
             nodes), 256 of them (the reference's candidate cap, PREEMPT);
             every preemptor evicts exactly three victims, a pass is one
             binding call: one preempt_dry_run and one pod_filters launch,
             no match_terms; no pass falls back; the first 64 preemptors
             equal through use_mirror=False; PreemptionBasic/500Nodes card
             against the CPU; the first pass's kernels timed (Q)
  c9         bench.py's c9 planning trace (20,000 nodes, 16 preemptors, 3
             levels, a zero-budget PDB on every fourth victim): the batched
             pass's plans equal the classic per-pod walk's, both timed
             (match_terms launched by neither); preempt_dry_run, pod_filters
             and the pass's binding call timed at this shape (K), the walk's
             one-pod static row (K1)
  resident   the same batches through TorchBatchScheduler() (warm) and
             TorchBatchScheduler(use_mirror=False) (cold), every batch equal
             field for field: SchedulingNodeAffinity/5000Nodes in 500-pod
             batches (the first a full upload and a full partials_eval, each
             later one a delta sync of exactly the rows the state dirtied;
             after the second, node-default nodes until the bucket moves
             past 8,192: an in-place grow, no full upload, no partials
             reseed) and SchedulingWithMixedChurn/5000Nodes (400 measured
             and the 100 recreated churn pods a batch, each refused with the
             fit reason; on the wavefront and on the scan); per batch the
             step split, both residents' counters and the host->card bytes
  kernels    each kernel against its plain version at the shapes of the
             phase that launches it, exact, timed with CUDA events, with
             the bound of its work on this run's data (partials_eval at R:
             every column, R500: 500 columns, VR: a PreemptionBasic verify
             solve's sync captured in the preemption phase, RI: the
             crossing with 4 new classes; mirror_rows at U500, S64, VM:
             the verify's delta, SP: RI's spec rows, beside clone +
             index_copy_ a leaf as its library call; each a fresh store or
             fresh leaves, equal to the reference's order on CPU copies,
             the old ones byte-unchanged; one warm sync's device
             operations at VR + VM; the plain-torch gather, the
             mirror's grow and the packed copy;
             class_statics, the one-launch cold prep, at B and match_terms,
             the masks-only entry, at B and W, each the card's time behind
             a spin with the host clock of the call beside it; class_extras
             (P, I, and E+ from the extender phase), partials_eval and
             slice_stats also so, as card_ms and host_ms;
             preempt_dry_run at Q, K, V and pod_filters at Q, K, K1 so)
  small      SchedulingBasic/500Nodes on the card against the plain path on
             the CPU, default route: identical placements and scores
  north      one 10,000-pod batch onto 50,000 nodes (the auction: one
             auction_loop launch), its snapshot's program (65,536 padded
             nodes, 16,384 padded pods) against the plain loop on CPU copies
             stage by stage and whole, every field, the scheduler's
             placements equal to the plain loop's, the loop and its stages
             timed (N); then a second 10,000-pod batch after the first
             one's assumes: a delta sync of the assumed rows, warm against
             cold
  gang       (after wide_edges) bench.py's c5 at full width: 50,000 of its
             32-CPU nodes, a warm-up and three timed batches of 10,000 pods
             in 100 gangs under fresh names (nothing assumed) through
             TorchBatchScheduler(mode="auto"): each batch the auction, one
             auction_loop launch (the gang stage inside), no stage alone,
             no plain twin; gangs all or nothing; usage within capacity;
             the last batch == auction_assign on CPU copies, every field
             (the reasons stage alone timed there, G, and the gang stage
             with no drop, G0); three gangs with an unplaceable member
             (released in the launch, == the CPU bit for bit; the gang
             stage alone timed there, G); 200 nodes (scarcity: the
             admission retry's solves on the auction route, names == the
             port on the CPU; both stages alone timed on the full solve,
             S200); each stage alone equal to its plain twin on CPU copies
  wide_edges the wavefront (a 256-pod SchedulingBasic batch, the planner's
             waves) and evaluate_single (E: the fused launch; E+: a
             preferred term, two stages) at 16,384 padded nodes (10,000
             nodes) and 65,536 (the north scheduler after its batches),
             where launch_shape takes 1,024-thread blocks, each against its
             plain version on CPU copies, exact; then family_prep's three
             entries at 65,536 padded nodes (2,000 bound color=red pods
             with preferred terms, a batch with hostname and zone spread
             rows, a zone anti-affinity term and the preferred term)
             against their plain twins on the card and on CPU copies; the
             wavefront batches' cold statics prep (class_statics, with and
             without the selector mask) at both widths against its plain
             twin on CPU copies
  encode     (after gang; host only, no kernel launched) the columnar
             encode, SnapshotBuilder's default, against the per-object one
             on two builders fed identically: c5 (its 50,000 nodes, a
             warm-up and 3 batches of 10,000 pods in 100 gangs under fresh
             names) and the north star's second 10,000-pod batch after the
             first one's placements; every leaf of both Snapshots and the
             stable selector and preferred ids byte-equal; build_s both ways
             (median, min) and one warm build's split into the pod tables,
             the constraint tables, the image table and the class
             refinement, each a separate timed call from here
  profiles   the scheduler's front half: SchedulerConfiguration from a dict
             (two profiles with different score weights, the default
             gates), FrameworkRegistry on the card (two TorchBatchSchedulers,
             one ClusterState, one DispatchArbiter), SchedulingBasic/
             5000Nodes with 1,000 pod-default pods dealt between the
             profiles, 10 pod-large-cpu pods, 10 pods whose selector no node
             matches and 10 naming an unknown scheduler (never queued);
             SchedulingQueue -> pop_batch(profiles={name}) -> encode ->
             solve, placements assumed, failures parked with the card's
             reason; 10 assumed pods deleted, AssignedPodDelete wakes the
             fit failures only; 64 16-CPU nodes added, NodeAdd wakes every
             parked pod, the large pods place on them and the selector pods
             fail again with the same reason; every cycle equal to the same
             sequence through FrameworkRegistry(device="cpu"); the arbiter
             took one slot a dispatch, forced none and holds none
  loop       the scheduler loop, Scheduler(store) on the card in the
             default configuration (one profile, the default gates,
             speculative_solve and the adaptive window on): Store.create ->
             Store.watch -> the informers -> the queue -> schedule_batch ->
             TorchBatchScheduler -> assume + Permit -> a bind wave on the
             binder thread -> Store.update_wave -> the informers' echo.
             Step A: SchedulingBasic/5000Nodes (5,000 node-default nodes,
             1,000 init pods cycled and flushed, then 1,000 measured pods
             once all are queued): both batches on the auction, every pod
             bound in the store, no node over capacity, no assume left,
             the breaker closed with 0 fallbacks, the placements equal to
             a TorchBatchScheduler() driven directly with the same two
             batches; each cycle's wall and trace split, last_timings, the
             binder's commit seconds, the seconds from the measured pods'
             creation to the last echo and the measured batch's pods/s from
             its pop to its flushed wave.  Step B: PreemptionBasic/500Nodes
             (500 nodes, 2,000 victims created bound, 16 preemptors) cycled
             until every preemptor is bound (at most 20 cycles): the scan,
             the PostFilter pass's preempt_dry_run and pod_filters launched;
             every preemptor's node and the evicted victims equal to the
             same sequence through Scheduler(..., device="cpu").  Both
             stop their schedulers and close their stores
  breakers   once, after every phase above (none arms a fault; the
             counters only count up): every scheduler built so far has its
             circuit breaker closed, no trip, no host fallback and no
             failed partials sync (assert_healthy).  On the card a kernel
             that fails to build or launch, or a CUDA error, re-raises
             instead of reaching the fallback; this holds the corrupt
             results the breaker does absorb there to zero
  faults     degraded mode on SchedulingBasic/5000Nodes (5,000 nodes,
             1,000 bound pods; batches the host fallback solves cut to
             FAULT_BATCH = 64 pods), each step against a healthy twin:
             nan_parity (the scan, the wavefront, the auction's kernels and
             evaluate_single on +inf allocatable against their plain
             versions, NaN for NaN; pod_filters' full mode timed, S64);
             batch.solve failing forever (the retry, the trip, the host
             fallback's pods/s); the breaker pinned open (no kernel
             launches) and its half-open probe (the route's kernels, the
             breaker closed); batch.solve CORRUPT once (SolveUnhealthy, the
             retry heals); solve.partials CORRUPT on a warm scan batch (the
             poisoned solve equal to its plain version, SolveUnhealthy, a
             full recompute, == cold, a further warm batch) and on a 500-pod
             SchedulingNodeAffinity wavefront batch (nothing placed and no
             trip, as the reference; a scan batch of the class heals it);
             solve.partials failing once (that batch cold, the next warm);
             mirror.grow failing and CORRUPT at the 8,192 -> 16,384
             crossing; solve.carveout failing once on a c10 round (== the
             CPU); batch.preemption failing twice on PreemptionBasic/500Nodes
             (the per-pod path: preempt_dry_run's dry_run_victims entry
             launched — the fault fires before the batched entry's launch —
             and timed at the next preemptor's per-pod inputs (V), no
             match_terms, the breaker tripped, == the batched pass on a
             healthy twin)

In every part of main, greedy, wavefront, spread, interpod, extras,
slices, extender, proto, resident, north, gang, encode, profiles and loop the
launch counters are reset
just before the part and
read just after; the kernels expected are derived from the batches the
part's schedulers encoded (route_kernels): the route's own — a cold batch
launches class_statics (its whole statics prep, the spread family's
selector mask included) and no match_terms; warm statics drop
class_statics and launch match_terms for the spread family's selector
mask —, the families' (family_prep once a family a batch,
class_extras with preferred inter-pod terms or images, slice_stats after
a slice batch's scan) and the residents' (partials_eval, mirror_rows,
each launched exactly as often as the residents recorded, and no batch's
sync more than one partials_eval and two mirror_rows: the cluster's
delta and the spec rows); every
auction batch launches auction_loop exactly once — its reasons pass and
its gang post-pass inside — and no stage entry point; every dispatch
with a cold statics prep (every auction batch, a scan or wavefront batch
without warm statics) launches class_statics exactly once (check_cold_preps;
not in the windows that arm a fault); and no card path
calls a plain twin of a ported prep, of the reasons pass, of the gang
post-pass or of the repair's dense tables (install_plain_counters:
"plain:<name>" counters held to 0 by the same check); the extender's windows expect
class_statics (exactly one a request, no match_terms) and evaluate_single (one fused launch a request of the
basic pod), with class_extras for the variants, and the proto request the
cold auction's.
Each part fails unless every expected kernel was launched and no other.
The faults phase runs last, with its own launch checks.  Then the card's
name and power limit, the `kernels` summary object, and as the last line
{"ok": true, "device": {...}}.  Any failed check raises
and the script exits non-zero; with no CUDA device it exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
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
# TopologySpreading/5000Nodes (performance-config.yaml:115-139,
# pod-with-topology-spreading.yaml: maxSkew 5 on the zone, DoNotSchedule),
# the measured batch also in batches of 500 for the wavefront
SPREAD = (5000, 5000, 2000)
SPREAD_BATCH = 500
SPREAD_MAX_SKEW = 5
# SchedulingPodAntiAffinity/5000Nodes and SchedulingPodAffinity/5000Nodes
# (performance-config.yaml:30-58, :60-88): init pods in sched-0, measured in
# sched-1; the preferred-affinity variant (upstream's
# SchedulingPreferredPodAffinity shape) at the same counts; the synthetic
# image batch: (nodes, pods)
ANTI = (5000, 1000, 1000)
AFFINITY_POD = (5000, 1000, 1000)
PREFERRED = (5000, 1000, 1000)
IMAGES = (5000, 1000)
# SchedulingWithMixedChurn/5000Nodes (performance-config.yaml:163-188):
# (nodes, measured pod-default pods); each batch holds 400 measured pods and
# the 100 recreated pod-large-cpu.yaml churn pods (500 -> pad 512: the
# wavefront; the same batches also on the scan)
CHURN = (5000, 2000)
CHURN_MEASURED_BATCH, CHURN_PODS = 400, 100
# bench.py's c10 slice packing (config10, bench.py:1273-1400): 64 slices of
# 4x4x4 (4,096 nodes), rounds of 208 pods in 26 gangs, half the live gangs
# leaving between rounds (seed 10); its quality gates (bench.py:1268-1269)
C10_ROUNDS = 6
C10_CONTIG_MIN, C10_FRAG_MAX = 0.9, 0.5
# SchedulingBasic/5000Nodes behind the extender: (nodes, bound pods,
# filter + prioritize request pairs); the proto service's one request:
# (nodes, pods)
EXTENDER = (5000, 1000, 200)
PROTO = (5000, 1000)
# PreemptionBasic (performance-config.yaml:141-161, pod-low-priority.yaml,
# pod-high-priority.yaml) at upstream's 5000Nodes cluster: (nodes, init
# pods, measured pods).  measurePods is cut from upstream's 5,000 to 256:
# the reference's evaluator lists at most MAX_CANDIDATES = 256 candidate
# nodes BEFORE its fit test, so once the first 256 nodes each hold a
# nominee no later preemptor of this cluster finds a candidate; one more
# pass of PREEMPT_PASS pods shows that.  PostFilter passes hold at most 16
# pods (max_preemptions_per_cycle, scheduler/config.py:81); warm == cold
# over the first PREEMPT_COLD preemptors; the repo's own /500Nodes size,
# card against CPU; bench.py's c9 planning trace: (nodes, preemptors)
PREEMPT_MEASURED, PREEMPT_PASS, PREEMPT_COLD = 256, 16, 64
PREEMPT = (5000, 20000, PREEMPT_MEASURED + PREEMPT_PASS)
PREEMPT_SMALL = (500, 2000, 100)
C9 = (20000, 16)
# bench.py's c5 gang burst (config5, bench.py:297-318): (nodes of _mk_nodes —
# 32 CPU / 64Gi / 110 pods, C5_ZONES zones —, pods from default_rng(5), gangs);
# _Runner's steps: a warm-up batch, then C5_TIMED batches under fresh names,
# nothing assumed.  The scarcity step's cluster: C5_SCARCE nodes (6,400 CPU
# for ~7,700 CPU of requests: the full solve completes no gang, found with
# the port on the CPU); the drops step's gangs with one unplaceable member
C5 = (50000, 10000, 100)
C5_ZONES, C5_TIMED, C5_SCARCE = 10, 3, 200
C5_DROP_GANGS = (3, 41, 97)
# the encode phase's timed builds a side at the north star's second batch
ENCODE_NORTH_BUILDS = 3
# the profiles phase (the scheduler's front half): SchedulingBasic/5000Nodes
# (nodes, pod-default pods split between the two profiles); PROFILES_ODD
# pods each of MixedChurn's pod-large-cpu (cpu 9, 500Mi, priority 10), of a
# node selector no node matches and of an unknown schedulerName; the
# assumed pods deleted before the AssignedPodDelete event; the 16-CPU
# nodes added before the NodeAdd event
PROFILES = (5000, 1000)
PROFILES_ODD, PROFILES_DELETE, PROFILES_NEW_NODES = 10, 10, 64
# two profiles with different score weights, the default feature gates
# (KubeSchedulerConfiguration as a dict: no YAML parser needed)
# the loop phase (the scheduler loop, Scheduler over the port's Store):
# SchedulingBasic/5000Nodes (nodes, init pods, measured pods; both batches
# pad to 1,024 -> the auction) and PreemptionBasic/500Nodes (nodes,
# victims created bound, preemptors), cycled at most LOOP_PREEMPT_CYCLES
# times; every wait of the phase bounded by LOOP_WAIT_S
LOOP = (5000, 1000, 1000)
LOOP_PREEMPT = (500, 2000, 16)
LOOP_PREEMPT_CYCLES = 20
LOOP_WAIT_S = 120.0
# the informers Scheduler.start() runs
LOOP_INFORMERS = ("Node", "Pod", "PersistentVolume", "PersistentVolumeClaim",
                  "StorageClass", "ResourceClaim", "DeviceClass")
PROFILES_CONFIG = {
    "apiVersion": "kubescheduler.config.k8s.io/v1",
    "kind": "KubeSchedulerConfiguration",
    "profiles": [
        {"schedulerName": "default-scheduler"},
        {"schedulerName": "packing-scheduler",
         "plugins": {"score": {"enabled": [
             {"name": "NodeResourcesFit", "weight": 5},
             {"name": "NodeResourcesBalancedAllocation", "weight": 3}]}},
         "pluginConfig": [{"name": "NodeResourcesFit", "args": {
             "scoringStrategy": {"type": "MostAllocated"}}}]},
    ],
}

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
    "auction_loop": ("kubernetes_tpu_torch/csrc/auction_loop.cu",
                     "kubernetes_tpu/ops/auction.py:762"),
    # the program's stages: auction_loop.cu's kernel launched for one stage
    "auction_bids": ("kubernetes_tpu_torch/csrc/auction_common.cuh",
                     "kubernetes_tpu/ops/auction.py:355"),
    "auction_accept": ("kubernetes_tpu_torch/csrc/auction_common.cuh",
                       "kubernetes_tpu/ops/auction.py:680"),
    "auction_spread": ("kubernetes_tpu_torch/csrc/auction_common.cuh",
                       "kubernetes_tpu/ops/auction.py:507"),
    "auction_interpod": ("kubernetes_tpu_torch/csrc/auction_common.cuh",
                         "kubernetes_tpu/ops/auction.py:587"),
    "class_extras": ("kubernetes_tpu_torch/csrc/class_extras.cu",
                     "kubernetes_tpu/ops/scores.py:337"),
    "partials_eval": ("kubernetes_tpu_torch/csrc/partials_eval.cu",
                      "kubernetes_tpu/ops/partials.py:203"),
    "mirror_rows": ("kubernetes_tpu_torch/csrc/mirror_rows.cu",
                    "kubernetes_tpu/models/mirror.py:81"),
    "slice_stats": ("kubernetes_tpu_torch/csrc/slice_stats.cu",
                    "kubernetes_tpu/ops/slices.py:269"),
    "evaluate_single": ("kubernetes_tpu_torch/csrc/evaluate_single.cu",
                        "kubernetes_tpu/ops/assign.py:1665"),
    "preempt_dry_run": ("kubernetes_tpu_torch/csrc/preempt_dry_run.cu",
                        "kubernetes_tpu/ops/preemption.py:129"),
    "pod_filters": ("kubernetes_tpu_torch/csrc/pod_filters.cu",
                    "kubernetes_tpu/ops/preemption.py:194"),
    # the reasons pass: a stage of the program, run by every loop launch
    "auction_reasons": ("kubernetes_tpu_torch/csrc/auction_common.cuh",
                        "kubernetes_tpu/ops/auction.py:765"),
    # the gang post-pass: a stage of the program, run by every loop launch
    # of a batch with gangs
    "auction_gang": ("kubernetes_tpu_torch/csrc/auction_common.cuh",
                     "kubernetes_tpu/ops/auction.py:825"),
    # three entries of one source; each row names its entry's function
    "family_prep": ("kubernetes_tpu_torch/csrc/family_prep.cu",
                    "kubernetes_tpu/ops/topology.py:50"),
}
# the JAX function each entry of family_prep replaces
FAMILY_REPLACES = {"spread": "kubernetes_tpu/ops/topology.py:50",
                   "terms": "kubernetes_tpu/ops/interpod.py:86",
                   "pref": "kubernetes_tpu/ops/interpod.py:220"}
# the plain versions no card path may run (install_plain_counters: a call
# with tensors on the card counts under "plain:<name>" in bindings.LAUNCHES,
# so every launch check also holds them to 0)
PLAIN_TWINS = (("topology", "prep_spread_plain"), ("interpod", "prep_terms_plain"),
               ("interpod", "prep_pref_pod_plain"), ("auction", "failure_reasons_plain"),
               ("auction", "repair_tables"), ("auction", "gang_post_pass_plain"),
               ("assign", "class_statics_plain"), ("filters", "match_rows_plain"))

def install_plain_counters(bindings, torch) -> None:
    """Wrap each plain twin of PLAIN_TWINS in its module so that a call
    whose first tensor lies on the card adds one to
    bindings.LAUNCHES["plain:<name>"] (reset with the kernels' counters).
    Comparisons call the plain twins outside the launch windows; inside
    one, a count above 0 fails the window's check (check_launches)."""
    import importlib

    def first_tensor(x):
        if isinstance(x, torch.Tensor):
            return x
        if isinstance(x, tuple):
            for v in x:
                t = first_tensor(v)
                if t is not None:
                    return t
        return None

    for mod_name, name in PLAIN_TWINS:
        mod = importlib.import_module(f"kubernetes_tpu_torch.ops.{mod_name}")
        fn = getattr(mod, name)
        key = f"plain:{name}"
        bindings.LAUNCHES[key] = 0

        def counted(*args, _fn=fn, _key=key, **kw):
            t = first_tensor(args)
            if t is not None and t.is_cuda:
                bindings.LAUNCHES[_key] += 1
            return _fn(*args, **kw)

        setattr(mod, name, counted)


# the kernels each route launches with cold statics (class_statics: the
# whole cold prep, its rows and the spread family's selector mask, in one
# launch); route_kernels derives a batch's kernels from its meta: warm
# statics (the partials) drop class_statics (match_terms makes the spread
# family's selector mask then), the families add theirs, and
# the residents' recorded launches add partials_eval and mirror_rows.  The
# auction is one launch of auction_loop a batch, its repairs inside; its
# stage entry points (bindings.AUCTION_STAGES: auction_bids,
# auction_accept's acceptance and commit, auction_spread, auction_interpod;
# run_auction's round-by-round check launches them alone) run on no path
_AUCTION = ("class_statics", "auction_loop")
ROUTE_KERNELS = {
    "greedy": ("class_statics", "greedy_scan"),
    "wavefront": ("class_statics", "wavefront"),
    "auction": _AUCTION,
}
# kernels the residents launch while a batch is encoded
RESIDENT_KERNELS = ("partials_eval", "mirror_rows")


# `--log PATH`: every emitted line is also appended there (the phases'
# lines can outgrow the end of the output a caller keeps)
LOG = None


def emit(obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    if LOG is not None:
        with open(LOG, "a") as f:
            f.write(line + "\n")


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


def c5_nodes(wrappers, n_nodes: int):
    """bench.py _mk_nodes: 32 CPU / 64Gi / 110 pods, C5_ZONES zones."""
    return [
        wrappers.make_node(f"node-{i}")
        .capacity(cpu_milli=32000, mem=64 * wrappers.GI, pods=110)
        .zone(f"zone-{i % C5_ZONES}")
        .obj()
        for i in range(n_nodes)
    ]


def c5_pods(wrappers, tag: str, drop_gangs=()):
    """bench.py config5's batch under the names c5-<tag>-<i>: C5[1] pods
    from default_rng(5), cpu in {100, 250, 500, 1000, 2000} m, memory in
    {128 ... 2048} Mi, pod i in gang-<i % C5[2]>; the first member of each
    gang in drop_gangs also asks a node label no node has."""
    import numpy as np

    rng = np.random.default_rng(5)
    pods = []
    for i in range(C5[1]):
        w = (wrappers.make_pod(f"c5-{tag}-{i}")
             .req(cpu_milli=int(rng.choice([100, 250, 500, 1000, 2000])),
                  mem=int(rng.choice([128, 256, 512, 1024, 2048])) * wrappers.MI)
             .group(f"gang-{i % C5[2]}"))
        if i in drop_gangs:
            w = w.node_selector_kv("c5-drop", "nowhere")
        pods.append(w.obj())
    return pods


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


def cuda_host_ms(fn, iters: int, torch) -> tuple:
    """(CUDA-event ms, host-clock ms) a call of fn(), over the same `iters`
    calls after one warm-up: the host clock around the calls without a
    sync (what enqueueing them costs the caller), the events around them
    on the card."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = time.perf_counter() - t0
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters, host * 1e3 / iters


def graph_ms(fn, calls: int, replays: int, torch) -> float:
    """Mean milliseconds of one fn() on the card alone: `calls` calls
    captured in one CUDA graph, replayed `replays` times between CUDA
    events (no host work between the launches)."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / (calls * replays)


def _pairs(a, b):
    """Matching outputs of two result tuples, as CPU tensors (a kernel's
    output on the card, a plain version's on either side); an output both
    leave out (None: a family the batch does not use) is skipped."""
    if len(a) != len(b):
        raise AssertionError(f"results of {len(a)} and {len(b)} outputs")
    for x, y in zip(a, b):
        if x is None and y is None:
            continue
        if x is None or y is None:
            raise AssertionError("one result has an output the other lacks")
        yield x.cpu(), y.cpu()


def max_abs_err(a, b, torch) -> float:
    """Largest |a - b| over matching outputs (0.0 when equal; inf when
    infinities or non-finite entries differ).  A NaN equals a NaN at the
    same position (a poisoned solve's scores) and nothing else."""
    worst = 0.0
    for x, y in _pairs(a, b):
        if x.dtype == torch.bool:
            x, y = x.to(torch.int32), y.to(torch.int32)
        x, y = x.double(), y.double()
        if not torch.equal(torch.isnan(x), torch.isnan(y)):
            return float("inf")
        keep = ~torch.isnan(x)
        x, y = x[keep], y[keep]
        fin = torch.isfinite(x) & torch.isfinite(y)
        if not torch.equal(torch.isfinite(x), torch.isfinite(y)) or not torch.equal(x[~fin], y[~fin]):
            return float("inf")
        if fin.any():
            worst = max(worst, float((x[fin] - y[fin]).abs().max()))
    return worst


def same_values(x, y, torch) -> bool:
    """torch.equal, with a NaN equal to a NaN at the same position."""
    if x.is_floating_point() and y.is_floating_point():
        nx, ny = torch.isnan(x), torch.isnan(y)
        return torch.equal(nx, ny) and torch.equal(x[~nx], y[~ny])
    return torch.equal(x, y)


def check_equal(name: str, got, want, torch) -> float:
    err = max_abs_err(got, want, torch)
    same = all(same_values(x, y, torch) for x, y in _pairs(got, want))
    if not same or err != 0.0:
        raise AssertionError(f"kernel {name} differs from its plain version: max_abs_err {err}")
    return err


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _live_ids(expr_ids, expr_op, expr_slot, term_valid, torch) -> tuple:
    """(label word indices, topology slots, expanded ids) that the valid
    expressions of a table test."""
    live = term_valid[:, :, None] & ((expr_op == 1) | (expr_op == 2))
    ids = expr_ids[live]                      # [M, K]
    slots = expr_slot[live]                   # [M]
    label = ids[(slots < 0)[:, None].expand_as(ids) & (ids >= 0)]
    return label >> 5, slots[slots >= 0], int((ids != -1).sum())


def match_terms_need(n: int, expr_ids, expr_op, expr_slot, term_valid, torch) -> tuple:
    """(bytes, operations) one match_terms launch needs on this data: the
    table, the output, and per node the label words and topology ids that
    the valid expressions test (two integer operations per tested id)."""
    words, topo, ids = _live_ids(expr_ids, expr_op, expr_slot, term_valid, torch)
    need = (nbytes(expr_ids, expr_op, expr_slot, term_valid)
            + n * 4 * (int(torch.unique(words).numel()) + int(torch.unique(topo).numel()))
            + term_valid.shape[0] * n)
    return need, n * ids * 2


def cold_statics_need(cluster, pods, sel, pref, reps, want_sel_mask: bool, torch) -> tuple:
    """(bytes, operations) one class_statics launch (the cold prep) needs
    on this data: the table rows it evaluates (those the classes name, and
    every selector row with the mask asked for) and, per node, the label
    words and topology ids their valid expressions test, read once for
    both tables; class_statics_need's class side; the selector mask
    written when asked for."""
    n = cluster.node_valid.shape[0]
    r = reps.long()
    s_rows = sel.term_valid.shape[0]
    f_rows = pref.valid.shape[0]
    si = pods.sel_idx[r]
    si = torch.clamp(si[si >= 0], max=s_rows - 1)
    sel_used = torch.arange(s_rows, device=si.device) if want_sel_mask else torch.unique(si)
    pi = pods.pref_idx[r]
    pref_used = torch.unique(torch.clamp(pi[pi >= 0], max=f_rows - 1))
    tabs = [(sel.expr_ids[sel_used], sel.expr_op[sel_used], sel.expr_slot[sel_used],
             sel.term_valid[sel_used]),
            (pref.expr_ids[pref_used][:, None], pref.expr_op[pref_used][:, None],
             pref.expr_slot[pref_used][:, None], pref.valid[pref_used][:, None])]
    words, topo, ids = [], [], 0
    for t in tabs:
        w, tp, k = _live_ids(*t, torch)
        words.append(w)
        topo.append(tp)
        ids += k
    node_words = (int(torch.unique(torch.cat(words)).numel())
                  + int(torch.unique(torch.cat(topo)).numel()))
    class_bytes, class_ops = class_statics_need(cluster, pods, reps, torch)
    need = (sum(nbytes(*t) for t in tabs) + n * 4 * node_words + class_bytes
            + (s_rows * n if want_sel_mask else 0))
    return need, n * ids * 2 + class_ops


def class_statics_need(cluster, pods, reps, torch) -> tuple:
    """(bytes, operations) of the class side of the statics on this data:
    the representatives' pod fields; per node the valid byte, the name id
    only where a class pins a node, the taint words of each effect that
    some class does not tolerate wholesale, the port words that some class
    claims (a zero claim word conflicts with nothing); the three [C, N]
    outputs.  Two integer operations a tested word or live term."""
    n = cluster.node_valid.shape[0]
    c = reps.shape[0]
    r = reps.long()
    tw = cluster.taint_bits.shape[2]
    pod_bytes = nbytes(reps, pods.valid[r], pods.name_id[r], pods.sel_idx[r],
                       pods.tol_bits[:, r], pods.tol_all[:, r], pods.port_bits[r],
                       pods.pref_idx[r], pods.pref_weight[r])
    effects = int((~pods.tol_all[:, r]).any(dim=1).sum())
    port_words = int((pods.port_bits[r] != 0).any(dim=0).sum())
    live_pref = pods.pref_idx[r] >= 0
    names = n * 4 if bool((pods.name_id[r] != -1).any()) else 0
    node_bytes = n * (1 + 4 * effects * tw + 4 * port_words) + names
    need = pod_bytes + node_bytes + c * n * 9
    per_class = (2 * tw * int((~pods.tol_all[:, r]).sum())
                 + 2 * port_words * c + 2 * int(live_pref.sum()) + 8 * c)
    return need, n * per_class


def live_spread_rows(table, torch):
    """The spread rows some pod's constraints reference (each referenced
    row is valid): the only rows a spread computation needs to read; the
    padded rows of the [C, N] tables are left out of every bound."""
    return torch.unique(table.pod_idx[table.pod_idx >= 0]).long()


def spread_rows_bytes(table, state, live, counts_passes: int = 2, pod_rows=None) -> int:
    """Bytes of the live spread rows: the row indices and the match flags
    on those rows of the pods that are read (pod_rows; None: all), each
    row's parameters, eligibility, values and size, and its counts
    `counts_passes` times (in and out)."""
    pod_idx, pod_matches = table.pod_idx, table.pod_matches[:, live]
    if pod_rows is not None:
        pod_idx, pod_matches = pod_idx[pod_rows], pod_matches[pod_rows]
    return (nbytes(pod_idx, pod_matches, table.max_skew[live], table.min_domains[live],
                   table.hard[live], state.eligible[live], state.v[live], state.sizes[live])
            + counts_passes * nbytes(state.counts_node[live]))


def spread_need(sp_args, pods, feas_counts, torch) -> tuple:
    """(bytes, operations) the spread family adds to a greedy solve on this
    data: the live rows' tables once and their counts in and out; per pod,
    one pass over the N nodes for each hard row's minimum and for each
    live row it matches (the count update), and on each feasible node 4
    flops a hard row (the skew test) and 3 a soft row (the multiply-add
    and the sum)."""
    if sp_args is None:
        return 0, 0.0
    table, st = sp_args.table, sp_args.state
    n = st.v.shape[1]
    live_rows = live_spread_rows(table, torch)
    need = spread_rows_bytes(table, st, live_rows)
    rows = torch.clamp(table.pod_idx, 0, st.v.shape[0] - 1).long()
    live = table.pod_idx >= 0
    hard = (live & table.hard[rows]).sum(dim=1).double()
    soft = (live & ~table.hard[rows]).sum(dim=1).double()
    matched = table.pod_matches[:, live_rows].sum(dim=1).double()
    feas = feas_counts.double()
    ops = float(((hard + matched) * n + (4 * hard + 3 * soft) * feas).sum())
    return need, ops


def auction_spread_need(st, accepted, bid, counts, torch) -> tuple:
    """(bytes, operations) one round of the spread repair needs on this
    data: the accepted set, bids and solve order, the live rows' tables,
    eligibility, values and counts in; their counts and the kept set out.
    Operations per admit pass, over the L live rows: the row minima (L N),
    a sort of the A accepted pods by value (A log2 A), the segmented count
    (A L), the admit tests (6 a row a pod), the commit (L N); then the
    final commit."""
    import math

    table, sps = st.sp.table, st.sp.state
    n = counts.shape[1]
    p = bid.shape[0]
    live = live_spread_rows(table, torch)
    c_live = int(live.numel())
    need = (nbytes(accepted, bid, st.order) + p
            + spread_rows_bytes(table, sps._replace(counts_node=counts), live))
    a = max(int(accepted.sum()), 1)
    mc = table.pod_idx.shape[1]
    per_pass = (c_live * n + a * max(1, math.ceil(math.log2(max(a, 2)))) + a * c_live
                + 6 * a * mc + c_live * n)
    return need, float(3 * per_pass + c_live * n)


def interpod_need(tm_args, extra, pods, feas_counts, assignment, torch) -> tuple:
    """(bytes, operations) the inter-pod family and the extra rows add to
    a greedy solve on this data: the present, blocked and key words and
    the used slots' values in, present and blocked out, each pod's term
    words; the extra rows in.  Operations: on each feasible node 4 word
    tests a term word (the three checks); per placed pod one compare a
    node and used slot (the update); one add a feasible node for the
    extra row."""
    need, ops = 0, 0.0
    feas = float(feas_counts.double().sum())
    if tm_args is not None:
        st = tm_args.state
        w = st.present_bits.shape[1]
        n = st.slot_v.shape[1]
        need += (nbytes(st.present_bits, st.blocked_bits, st.key_bits, st.slot_v,
                        st.global_any, st.mi_slot_bits, st.anti_slot_bits, st.aff_bits,
                        st.anti_bits) + nbytes(st.present_bits, st.blocked_bits))
        ops += 4 * w * feas + float(int((assignment >= 0).sum()) * n * st.slot_v.shape[0])
    if extra is not None:
        need += nbytes(extra)
        ops += feas
    return need, ops


def greedy_scan_need(cluster, pods, sfeas, feas_counts, features, torch,
                     sp_args=None, tm_args=None, extra=None, assignment=None) -> tuple:
    """Bytes: inputs once, outputs once.  Operations: per step, the
    fit test on every static-feasible node (2 flops a resource the pod
    requests; a resource it does not request is not tested) and the
    ~60 flops of the scores on every feasible node (LeastAllocated and
    BalancedAllocation over cpu+memory, two normalisations, the sum),
    plus the spread family's work (spread_need) and the inter-pod
    family's and the extra rows' (interpod_need)."""
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
    sp_bytes, sp_ops = spread_need(sp_args, pods, feas_counts, torch)
    tm_bytes, tm_ops = interpod_need(tm_args, extra, pods, feas_counts, assignment, torch)
    return ins + outs + sp_bytes + tm_bytes, ops + sp_ops + tm_ops


def auction_bids_need(cluster, pods, st, requested, tie_k, torch, assigned=None) -> tuple:
    """(bytes, operations) one bidding round needs on this data: the
    resource rows, the spec classes' static, affinity and taint rows, the
    pods' class, validity, assignment and solve order, the bids out and the
    tie lists out.  Operations: per class the fit test on its static-feasible
    nodes (2 flops a requested resource), ~60 flops of scores on each
    feasible node, 4 integer operations of hash on each tie node; per pod
    4 (a counting pass for its position in its class).  Given the round's
    `assigned`, only the classes with an active pod (unplaced and valid)
    count, the only ones a round evaluates; else every class."""
    n, r = cluster.allocatable.shape
    p = pods.req.shape[0]
    c_all = st.jspec.shape[0]
    live = torch.ones(c_all, dtype=torch.bool, device=st.jspec.device)
    if assigned is not None:
        active = (assigned < 0) & pods.valid
        live = torch.zeros_like(live)
        live[torch.clamp(pods.class_id[active].long(), 0, c_all - 1)] = True
    c = int(live.sum())
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
        per_joint = int(((st.jspec == s) & live).sum())
        ops += per_joint * (n_static * 2 * tested + n_feas * 60 + n_feas * 4)
    if st.sp is not None:
        # each joint class's spread rows: the live rows' tables and counts
        # once, the constraint classes' row indices and match flags; the
        # eligible counts once (the minima), the skew test (4 flops) and
        # the soft score (3) a row on each feasible node
        table, sps = st.sp.table, st.sp.state
        ins += spread_rows_bytes(table, sps, live_spread_rows(table, torch), 1,
                                 pod_rows=st.k_reps.long())
        for rep in st.reps[live].tolist():
            used = table.pod_idx[rep] >= 0
            rows = torch.clamp(table.pod_idx[rep], 0, sps.v.shape[0] - 1)
            hard = int((used & table.hard[rows]).sum())
            soft = int((used & ~table.hard[rows]).sum())
            ops += hard * n + (4 * hard + 3 * soft) * n
    if st.tm is not None:
        # the round's term words in, the constraint classes' term words; the
        # three checks (4 word tests a term word) on each node a joint class
        tms = st.tm.state
        ins += nbytes(tms.present_bits, tms.blocked_bits, tms.key_bits, tms.global_any)
        k = st.k_reps.long()
        ins += nbytes(tms.mi_slot_bits[:, k], tms.aff_bits[k], tms.anti_bits[k])
        ops += 4 * tms.present_bits.shape[1] * n * c
    if st.extra is not None:
        ins += nbytes(st.extra)
        ops += n * c
    return ins + outs, ops + p * 4


def reasons_need(cluster, pods, st, assigned, requested, nonzero, sp_counts,
                 term_bits=None, torch=None) -> tuple:
    """(bytes, operations) the auction's reasons pass needs on this data:
    allocatable and the final usage once, the spec classes' static rows
    and requests, the pods' class and assignment in and reasons out, with
    the spread family the live rows' tables and final counts, with the
    inter-pod family the final present / blocked / key words and the
    constraint classes' pod words; the fit test (2 flops a node and
    requested resource a spec class), the stage ands (3 a node a joint
    class), the spread skew test (4 flops a node a constraint class's hard
    row) and the inter-pod word tests (5 a node, word and constraint
    class)."""
    n, r = cluster.allocatable.shape
    reps = st.s_reps.long()
    tested = int((pods.req[reps] > 0).sum())
    need = (nbytes(cluster.allocatable, requested, st.sfeas_s, pods.req[reps], st.jspec,
                   pods.class_id, assigned) + assigned.shape[0] * 4)
    ops = 2 * n * tested + 3 * n * st.jspec.shape[0]
    if st.features.spread:
        table, sps = st.sp.table, st.sp.state
        live = live_spread_rows(table, torch)
        need += spread_rows_bytes(table, sps._replace(counts_node=sp_counts), live, 1,
                                  pod_rows=st.k_reps.long()) + nbytes(st.jcons)
        rows = table.pod_idx[st.k_reps.long()]
        hard = int(((rows >= 0) & table.hard[torch.clamp(rows, 0, None).long()]).sum())
        ops += 4 * n * hard
    if st.features.interpod and term_bits is not None:
        tm, k = st.tm.state, st.k_reps.long()
        need += nbytes(*term_bits, tm.key_bits, tm.aff_bits[k], tm.anti_bits[k],
                       tm.mi_slot_bits[:, k], st.tm.table.self_match_all[k])
        ops += 5 * n * tm.key_bits.shape[1] * k.shape[0]
    return need, float(ops)


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


def live_term_rows(terms, torch):
    """The valid terms (rows of the term table) and their slots: the only
    rows an inter-pod computation needs to read."""
    live = torch.nonzero(terms.valid).flatten()
    return live, torch.unique(terms.slot[live]).long()


def auction_interpod_need(st, accepted, bid, bits, cluster, torch) -> tuple:
    """(bytes, operations) one round of the anti-affinity repair and term
    commit needs on this data: the accepted set, bids and solve positions;
    the accepted pods' rows of the dense term tables over the live terms
    and their bid nodes' values in the live slots; every node's values in
    those slots (to map the committed groups back); the present and
    blocked words in and out, the global word, the kept set out.
    Operations: three passes over the accepted pods' live (pod, term)
    pairs (minima, releases, commit) and one over the nodes' live terms,
    about 4 integer operations a pair."""
    table = st.tm.table
    live, slots = live_term_rows(table, torch)
    t_live, u = int(live.numel()), int(slots.numel())
    n, p = cluster.topo_ids.shape[0], bid.shape[0]
    a = int(accepted.sum())
    need = (p + p * 4 * 2 + a * t_live * 2 + a * u * 4 + n * u * 4 + t_live * 4
            + 2 * 2 * nbytes(bits[0]) + 2 * nbytes(bits[2]) + p)
    return need, float(4 * (3 * a * t_live + n * t_live))


def class_extras_need(snap, features, reps, feas, torch) -> tuple:
    """(bytes, operations) one class_extras launch needs on this data: per
    pair, its output row, and with preferred terms its feasible row and the
    preferred rows its representative reads (its own live rows of
    counts_dom, the rows it matches of ownerw_dom); with images the image
    words of its images, node validity and sizes.  Operations per pair and
    node: 2 per preferred row read and ~6 for the min / max normalisation;
    2 per image and ~6 for the clamp and scale."""
    n = snap.cluster.allocatable.shape[0]
    c = reps.shape[0]
    r = reps.long()
    need = c * n * 4 + nbytes(reps)
    ops = 0
    if features.interpod_pref:
        pp = snap.prefpod
        own = int((pp.pod_idx[r] >= 0).sum())
        theirs = int(pp.matches_incoming[r].sum())
        need += c * n + (own + theirs) * n * 4 + nbytes(pp.pod_idx[r], pp.pod_weight[r],
                                                        pp.matches_incoming[r])
        ops += n * (2 * (own + theirs) + 6 * c)
    if features.images:
        ids = snap.images.pod_ids[r]
        active = int((ids >= 0).sum())
        words = int(torch.unique(ids[ids >= 0] >> 5).numel())
        need += n * (4 * words + 1) + nbytes(ids, snap.images.n_containers[r]) + active * 4
        ops += n * (2 * active + 6 * c)
    return need, float(ops)


def class_extras_args(snap, features, cfg, reps, feas, assign) -> tuple:
    """bindings.class_extras' arguments for the (reps, feas) pairs of a
    snapshot: its tables and, with preferred terms, prep_pref_pod's state."""
    pp = None
    if features.interpod_pref:
        pp = assign.prep_pref_pod(snap.cluster, snap.prefpod, assign.required_topo_z_split(snap)[1],
                                  has_bound=features.bound_pref)
    return (snap.cluster, snap.prefpod, snap.images, features, cfg, reps, feas, pp)


def auction_pairs(snap, meta, cfg, auction) -> tuple:
    """(reps, feas) of an auction batch's class_extras pairs: each joint
    class's constraint representative and spec static row."""
    _cl, _pods, st = auction.auction_prep(snap, meta.features, meta.topo_split, cfg)
    return st.k_reps[st.jcons.long()], st.sfeas_s[st.jspec.long()]


def single_pair(snap, features, assign, bindings, torch) -> tuple:
    """(reps, feas) of evaluate_single's extra row: pod 0 over the feasible
    row of its filter stage (the plain stage on the card's statics)."""
    topo_z = assign.required_topo_z(snap) if assign.needs_topo(features) else 1
    cluster, pods, sel, pref = snap[:4]
    reps = torch.zeros(1, dtype=torch.int32, device=cluster.allocatable.device)
    sfeas, _aff, _taint, sel_mask = bindings.class_statics(cluster, pods, sel, pref, reps,
                                                           want_sel_mask=features.spread)
    feas = assign.single_filter_plain(cluster, pods, sfeas[0], features,
                                      assign.spread_prep(snap, sel_mask, features, topo_z),
                                      assign.terms_prep(snap, features, topo_z))[0]
    return reps, feas[None]


def run_class_extras(snap, features, cfg, reps, feas, assign, bindings, torch,
                     timed: bool = False) -> dict:
    """Kernel class_extras against its plain version on CPU copies of the
    same inputs, exact.  Returns {"out": the kernel's rows} and, timed, the
    kernel's summary row (the card alone behind a spin and the host clock
    of the call, the pairs and padded nodes)."""
    args = class_extras_args(snap, features, cfg, reps, feas, assign)

    def kern():
        return bindings.class_extras(*args)

    out = kern()
    cpu_in = cpu_args(args, torch)
    t0 = time.perf_counter()
    want = assign.class_extras_plain(*cpu_in)
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = check_equal("class_extras", (out,), (want,), torch)
    res = {"out": out}
    if timed:
        bms, by = bound(*class_extras_need(snap, features, reps, feas, torch))
        card_ms, host_ms = launch_ms(kern, lambda: None, 20, torch)
        res["row"] = {"name": "class_extras", "max_abs_err": err, "ms": cuda_ms(kern, 20, torch),
                      "card_ms": card_ms, "host_ms": host_ms,
                      "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                      "pairs": int(reps.shape[0]),
                      "padded_nodes": int(snap.cluster.allocatable.shape[0]),
                      "blocks_clusters": list(bindings.class_extras_shape(*args[:4], reps))}
    return res


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


def drive_phase(name, fn, bindings, scheds, extra=(), armed=False):
    """Run fn() with every launch counter at 0 and check the counters just
    after against the batches `scheds` (recording schedulers; one that fn()
    builds and appends to the list counts from its first batch) encoded
    meanwhile: every kernel their routes, families and residents launch
    (route_kernels), and the kernels of `extra`, was launched and no other,
    and each resident kernel exactly as many times as the residents
    recorded; unless a fault is `armed`, class_statics exactly once a
    dispatch with a cold statics prep (its whole prep in one launch)."""
    import torch

    # a scheduler that fn() builds and appends to `scheds` starts from 0
    marks = {id(s): len(s.metas) for s in scheds}
    solves = {id(s): s.auction_solves for s in scheds}
    preps = {id(s): s.cold_preps for s in scheds}
    torch.cuda.synchronize()
    bindings.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    launches = dict(bindings.LAUNCHES)
    metas = [m for s in scheds for m in s.metas[marks.get(id(s), 0):]]
    check_launches(name, launches,
                   set().union(*(route_kernels(m) for m in metas)) | set(extra))
    for m in metas:
        # one store update a sync; the cluster's delta and the spec rows
        rl = m.resident_launches or {}
        if rl.get("partials_eval", 0) > 1 or rl.get("mirror_rows", 0) > 2:
            raise AssertionError(f"phase {name}: a batch's residents launched {rl}")
    for k in RESIDENT_KERNELS:
        want = sum((m.resident_launches or {}).get(k, 0) for m in metas)
        if launches[k] != want:
            raise AssertionError(f"phase {name}: kernel {k} launched {launches[k]} times, "
                                 f"the residents recorded {want}")
    check_auction_launches(name, launches,
                           sum(s.auction_solves - solves.get(id(s), 0) for s in scheds))
    if not armed:
        check_cold_preps(name, launches,
                         sum(s.cold_preps - preps.get(id(s), 0) for s in scheds))
    return out, launches


def check_cold_preps(name, launches, preps: int) -> None:
    """One class_statics launch a cold statics prep (a request's, or a
    dispatched batch's: every auction batch, a scan or wavefront batch
    without warm statics)."""
    if launches["class_statics"] != preps:
        raise AssertionError(f"phase {name}: class_statics launched "
                             f"{launches['class_statics']} times for {preps} cold statics preps")


def check_auction_launches(name, launches, batches: int) -> None:
    """One auction_loop launch an auction batch dispatched to the card, and
    no launch of a stage entry point."""
    from kubernetes_tpu_torch.kernels import bindings

    if launches["auction_loop"] != batches:
        raise AssertionError(f"phase {name}: auction_loop launched {launches['auction_loop']} "
                             f"times for {batches} auction batches")
    for k in bindings.AUCTION_STAGES:
        if launches[k]:
            raise AssertionError(f"phase {name}: auction stage {k} launched {launches[k]} "
                                 "times on a path")


def stage_launches(name, launches) -> int:
    """A row's launches on its phase's path: the kernel's counter; for the
    reasons stage, which every auction_loop launch runs after its rounds,
    and the gang stage, which every loop launch of a batch with gangs runs
    last, the loop's (their own counters, auction_reasons and auction_gang,
    count only the stage launched alone, 0 on every path)."""
    return launches["auction_loop" if name in ("auction_reasons", "auction_gang") else name]


def check_launches(name, launches, want) -> None:
    """Every kernel of `want` was launched, and no other."""
    for k, count in launches.items():
        if (k in want) != (count > 0):
            raise AssertionError(f"phase {name}: kernel {k} launched {count} times, "
                                 f"expected {'some' if k in want else 'none'}")


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
    global LOG
    if "--log" in sys.argv:
        LOG = sys.argv[sys.argv.index("--log") + 1]
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
        from kubernetes_tpu_torch.ops import partials as pops
        from kubernetes_tpu_torch.testing import wrappers
    except ImportError as exc:
        print(f"chip_smoke: the kubernetes_tpu_torch package is missing ({exc})",
              file=sys.stderr)
        return 4

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    TorchBatchScheduler = recording(TorchBatchScheduler)
    install_plain_counters(bindings, torch)

    # ---- build --------------------------------------------------------
    t0 = time.perf_counter()
    secs = build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_kernel_s": secs, "card": card})

    # ---- parity on small batches ------------------------------------------
    gang_parity_row = parity_phase(wrappers, assign, auction, dv, filters, bindings, torch)
    overlay_parity(wrappers, TorchBatchScheduler, torch)
    resident_parity(wrappers, TorchBatchScheduler, dv, pops, bindings, torch)
    preemption_parity(wrappers, filters, bindings, torch)
    scan_edges_phase(wrappers, TorchBatchScheduler, assign, auction, bindings, torch)
    wave_edges_phase(wrappers, assign, dv, bindings, torch)

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

    (init_names, names), main_launches = drive_phase("main", run_main, bindings, [sched])
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

    gnames, greedy_launches = drive_phase("greedy", run_greedy, bindings, [gsched])
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

    _, wave_launches = drive_phase("wavefront", run_wavefront_phase, bindings, [wsched])
    check_capacity(wsched.state)
    meas = [b for b in wave["batches"] if b["batch"] == "measured"]
    meas_s = sum(b["s"] for b in meas)
    emit({"phase": "wavefront", "workload": "SchedulingNodeAffinity/5000Nodes",
          "route": "wavefront", "batch_size": AFFINITY_BATCH, "batches": wave["batches"],
          "measured_s": meas_s, "pods_per_s": AFFINITY[2] / meas_s,
          "launches": wave_launches, "card": card})

    # ---- spread: TopologySpreading/5000Nodes, every route ------------------
    spread_rows, spread_launches, warm_masks = spread_phase(
        wrappers, TorchBatchScheduler, assign, auction, filters, bindings, torch, card)
    spread_wave_launches = next(r for r in spread_rows if r["name"] == "wavefront")["launches"]

    # ---- inter-pod: SchedulingPodAntiAffinity and SchedulingPodAffinity ----
    interpod_rows, interpod_launches, terms_row = interpod_phase(
        wrappers, TorchBatchScheduler, assign, auction, filters, bindings, torch, card)
    interpod_wave_launches = next(r for r in interpod_rows if r["name"] == "wavefront")["launches"]

    # ---- extras: preferred inter-pod affinity and ImageLocality -----------
    extras_rows, pref_row = extras_phase(
        wrappers, TorchBatchScheduler, assign, auction, filters, bindings, torch, card)

    # ---- slices: bench.py's c10 on the scan, card against CPU -------------
    slice_rows, slice_launches = slices_phase(
        wrappers, TorchBatchScheduler, assign, filters, dv, bindings, torch, card)

    # ---- the extender and the proto service ----------------------------
    eval_rows = extender_phase(wrappers, TorchBatchScheduler, assign, dv, bindings, torch, card)
    proto_phase(wrappers, torch, bindings, card)

    # ---- preemption: PreemptionBasic and c9's planning trace ----------------
    preempt = preemption_phase(wrappers, TorchBatchScheduler, filters, bindings, torch, card)

    # ---- the residents: warm against cold at full width ---------------------
    resident_launches, churn_wave_launches = resident_phase(
        wrappers, TorchBatchScheduler, bindings, torch, card)

    # ---- each kernel against its plain version at its phase's shapes -------
    resident_rows, resident_extra = time_resident_kernels(
        wsched, preempt["verify"], dv, wrappers, TorchBatchScheduler, pops, bindings, torch)
    summary = run_kernels(
        snap_k, meta_k.features, meta_k.n_groups, sched.score_config,
        assign, filters, bindings, torch, timed=True,
    )
    snap_w, meta_w = wave["snap"]
    # the masks-only entry and the cold prep at W (a 32-row selector table,
    # one valid row)
    err_w, _sm, _pm = check_match_terms("match_terms (W)", snap_w.cluster, snap_w.selectors,
                                        filters, bindings, torch, snap_w.preferred)
    summary.append(dict(masks_row(snap_w.cluster, snap_w.selectors, err_w, filters, bindings,
                                  torch), shape="W"))
    check_statics("class_statics (W)", snap_w,
                  torch.clamp(snap_w.pods.class_rep, 0, snap_w.pods.req.shape[0] - 1), assign,
                  bindings, torch)
    summary.append(dict(run_wavefront(
        snap_w, meta_w.features, meta_w.n_groups, wsched.score_config,
        meta_w.wave_plan.members, assign, bindings, torch, timed=True,
    ), shape="W"))
    summary.extend(dict(r, shape="B") if r["name"] in ("auction_loop", "auction_reasons") else r
                   for r in run_auction(snap_k, sched.score_config, meta_k.tie_k, auction,
                                        bindings, torch, timed=True))
    # match_terms runs on no auction batch and no preemption pass: its rows
    # take the spread phase's warm scan and wavefront batches' launches
    if not warm_masks:
        raise AssertionError("match_terms: no warm spread batch launched it")
    launches_of = {"greedy_scan": greedy_launches, "wavefront": wave_launches,
                   "match_terms": {"match_terms": warm_masks}}
    for row in summary:
        row["launches"] = stage_launches(row["name"], launches_of.get(row["name"], main_launches))
    # the auction program and its reasons stage on the spread (T) and
    # anti-affinity (A) phases' measured batches, with their phases'
    # launches; family_prep's entries at T, A and P
    summary.extend(dict(r, shape=shape) for rows, shape in ((spread_rows, "T"),
                                                            (interpod_rows, "A"))
                   for r in rows if r["name"] in ("auction_loop", "auction_reasons"))
    summary.extend([next(r for r in spread_rows if r["name"] == "family_prep"), terms_row,
                    pref_row])
    # the wavefront on the other phases' default routes: S (the spread
    # phase's first 500-pod batch), F (SchedulingPodAffinity's measured
    # batch); its launches over every default-route phase that runs it
    summary.extend(dict(r, shape=shape) for rows, shape in ((spread_rows, "S"), (interpod_rows, "F"))
                   for r in rows if r["name"] == "wavefront")
    wave_all = (wave_launches["wavefront"] + spread_wave_launches + interpod_wave_launches
                + resident_launches["wavefront"] + churn_wave_launches)
    row = next(r for r in spread_rows if r["name"] == "auction_spread")
    summary.append(dict(row, launches=spread_launches["auction_spread"]))
    summary.append(next(r for r in interpod_rows if r["name"] == "auction_interpod"))
    summary.extend(extras_rows)
    summary.append(gang_parity_row)
    # the residents' kernels at the resident phase's shapes (R, U500) with
    # its launches, and at a verify solve's (VR, VM) with the preemption
    # phase's
    for name, shape, launches_of_phase in (
            ("partials_eval", "R:", resident_launches), ("mirror_rows", "U500:", resident_launches),
            ("partials_eval", "VR:", preempt["launches"]),
            ("mirror_rows", "VM:", preempt["launches"])):
        row = next(r for r in resident_rows if r["name"] == name and r["shape"].startswith(shape))
        summary.append(dict(row, launches=launches_of_phase[name]))
    row = next(r for r in slice_rows if r["name"] == "slice_stats")
    summary.append(dict(row, launches=slice_launches["slice_stats"]))
    summary.extend(eval_rows)
    summary.extend(preempt["rows"])
    order_ms = cuda_ms(lambda: assign.solve_order(snap_k.pods), 50, torch)
    order_bound = bound(*solve_order_need(snap_k.pods))
    emit({"phase": "kernels", "card": card,
          "greedy_scan_blocks_threads": {
              shape: bindings.scan_shape(n)
              for shape, n in (("B", snap_k.cluster.allocatable.shape[0]), ("C", 64 * 64))},
          "shapes": {"class_statics": "B: SchedulingBasic/5000Nodes measured batch, the "
                                      "cold statics prep in one launch (no mask), the "
                                      "card's time behind a spin and the host clock of the "
                                      "call; launches: the main phase's (one an auction "
                                      "batch)",
                     "match_terms": "the masks-only entry on the selector table, B: "
                                    "SchedulingBasic/5000Nodes measured batch (one pad "
                                    "row), W: SchedulingNodeAffinity/5000Nodes first "
                                    "measured batch (32 rows, one valid); launches: the "
                                    "spread phase's warm scan and wavefront batches (no "
                                    "auction batch and no preemption pass runs it)",
                     "auction_bids, auction_accept":
                     "SchedulingBasic/5000Nodes measured batch (the auction's stages: one "
                     "round at round 0, each launched alone; no path launches them)",
                     "auction_loop": "B: SchedulingBasic/5000Nodes measured batch; T: "
                                     "TopologySpreading/5000Nodes measured batch; A: "
                                     "SchedulingPodAntiAffinity/5000Nodes measured batch; N: "
                                     "the north star's first batch (50,000 nodes, 10,000 "
                                     "pods); the whole loop's launch alone, bound = each "
                                     "round's stage bounds on that round's data, summed",
                     "auction_gang": "the stage alone (events behind a spin) on the state "
                                     "before the post-pass; PG: the parity phase's "
                                     "fractional gang batch (launches: its auction_assign "
                                     "on the card); G: bench.py c5 with three gangs given "
                                     "an unplaceable member (launches: the drops step's); "
                                     "G0: the last c5 batch, no pod dropped (launches: the "
                                     "c5 batches'); S200: the scarcity step's full solve on "
                                     "200 nodes, no gang complete (launches: the step's "
                                     "solves)",
                     "greedy_scan": "the same batch, mode=greedy",
                     "wavefront": "W: SchedulingNodeAffinity/5000Nodes first measured batch; "
                                  "S: TopologySpreading/5000Nodes first 500-pod measured batch "
                                  "(one-pod waves); F: SchedulingPodAffinity/5000Nodes measured "
                                  "batch (one-pod waves)",
                     "auction_spread": "TopologySpreading/5000Nodes measured batch",
                     "auction_reasons": "B, T, A, N as auction_loop: the stage alone on the "
                                        "loop's final state; launches: the loop's (it runs "
                                        "once in each); G: the gang phase's last c5 batch "
                                        "(launches: the c5 batches' and the drops step's); "
                                        "S200: the scarcity step's full solve (launches: "
                                        "the step's solves)",
                     "family_prep": "T (entry spread): TopologySpreading/5000Nodes measured "
                                    "batch; A (terms): SchedulingPodAntiAffinity/5000Nodes "
                                    "measured batch; P (pref): the preferred-affinity "
                                    "variant's measured batch; launches: one an entry a "
                                    "batch over that phase's default-route run",
                     "auction_interpod": "SchedulingPodAntiAffinity/5000Nodes measured batch",
                     "class_extras": "the card alone behind a spin (card_ms) and the "
                                     "host clock of the call (host_ms); P: the "
                                     "preferred-affinity variant's measured batch (the "
                                     "auction's class pairs; launches: the preferred "
                                     "auction batches'); I: the synthetic image batch's "
                                     "auction pairs (launches: the image batch's auction "
                                     "and scan); E+: the extender's one pod with a "
                                     "preferred term, between evaluate_single's stages "
                                     "(launches: the extender's variant window)",
                     "partials_eval, mirror_rows": "R (every entry), U500 (a 500-row usage "
                                                   "delta): the wavefront phase's warm "
                                                   "SchedulingNodeAffinity/5000Nodes scheduler "
                                                   "(8,192 padded nodes, 32 slots; launches: the "
                                                   "resident phase's); VR, VM: the last verify "
                                                   "solve of PreemptionBasic/5000Nodes' first "
                                                   "pass (launches: the preemption phase's); "
                                                   "resident_kernels holds every shape: R, "
                                                   "R500, VR, RI, U500, S64, VM, SP",
                     "slice_stats": "C: c10 (4,096 nodes, 256 padded pods, 26 gangs) after "
                                    "the scan, one launch (greedy_scan at this shape: the "
                                    "slices line); card_ms, host_ms as class_extras",
                     "evaluate_single": "E: one pod-default pod against "
                                        "SchedulingBasic/5000Nodes (8,192 padded nodes; the "
                                        "fused launch); E+: the same with a preferred "
                                        "inter-pod term (two stages); launches: the extender's "
                                        "basic and variant windows",
                     "preempt_dry_run, pod_filters":
                     "the card's time of the call alone (events behind a spin) and its host "
                     "clock; Q: PreemptionBasic/5000Nodes' first pass (8,192 padded nodes, "
                     "K 4, 16 preemptors; launches: the preemption phase's, one a pass); K: "
                     "c9's batched pass (20,000 nodes, 32,768 padded, 16 preemptors, 3 "
                     "levels; launches: one pass); K1 (pod_filters): one preemptor's static "
                     "row on c9's snapshot (launches: the classic walk's, one a preemptor); "
                     "V (preempt_dry_run, entry dry_run_victims): faults step 8's per-pod "
                     "dry run (launches: the faulted pass's per-pod path)"},
          "kernels": [dict({k: row[k] for k in ("name", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms")},
                           shape=row.get("shape"), equal=True) for row in summary],
          "wavefront_launches_all_phases": wave_all,
          "resident_kernels": resident_rows, "resident_torch": resident_extra,
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

    got, north_launches = drive_phase("north", run_north, bindings, [big])
    if any(n is None for n in got):
        raise AssertionError("north star: a pod was not placed")
    north_rounds = int(big.last_result.rounds)
    north_assignment = big.last_result.assignment.cpu()[: len(pods)]
    # the batch's snapshot again, before the assumes change the state
    snap_n, meta_n = big.encode_pending(pods)
    for pod, name in zip(pods, got):
        big.assume(pod, name)
    check_capacity(big.state)
    north = {"phase": "north", "nodes": NORTH[0], "pods": NORTH[2], "route": "auction",
             "add_nodes_s": t_nodes, "batch_s": timing["north_s"],
             "pods_per_s": len(pods) / timing["north_s"], "rounds": north_rounds,
             "solve_s": big.last_timings["solve_s"], "last_timings": big.last_timings,
             "transfer_bytes": big.metas[-1].transfer_bytes, "launches": north_launches,
             "card": card}
    # the first batch's snapshot: the program (65,536 padded nodes, 16,384
    # padded pods) against the plain loop on CPU copies, every field, stage
    # by stage and whole; its placements equal the scheduler's; the loop
    # and the stages timed (N)
    t0 = time.perf_counter()
    north_rows = run_auction(snap_n, big.score_config, meta_n.tie_k, auction, bindings, torch,
                             timed=True)
    plain_n = auction._rounds_plain(*auction.auction_prep(cpu_copy(snap_n),
                                                           cfg=big.score_config),
                                    meta_n.tie_k, big.score_config, 64)
    if not torch.equal(north_assignment, plain_n[0][: len(pods)]):
        raise AssertionError("north star: the scheduler's placements differ from the plain loop")
    north["plain_check_s"] = time.perf_counter() - t0
    north["kernels"] = north_rows
    summary.append(dict(next(r for r in north_rows if r["name"] == "auction_loop"), shape="N",
                        launches=north_launches["auction_loop"]))
    summary.append(dict(next(r for r in north_rows if r["name"] == "auction_reasons"),
                        shape="N", launches=stage_launches("auction_reasons", north_launches)))

    # the second batch: the first one's placements assumed, another 10,000
    # pods, warm (a delta sync of the rows the assumes dirtied) against cold
    bigc = TorchBatchScheduler(use_mirror=False)
    for node in make_cluster(wrappers, NORTH[0]):
        bigc.add_node(node)
    for pod, name in zip(pods, got):
        bigc.assume(pod, name)
    pods2 = make_pods(wrappers, NORTH[2], "burst2")
    before = big._mirror.stats()
    want_rows = len(set(got))

    def run_north2():
        return solve_pair("north/second", big, bigc, pods2, torch)

    (names2, rw, rc, meta2), north2_launches = drive_phase("north/second", run_north2,
                                                           bindings, [big, bigc])
    after = big._mirror.stats()
    if (meta2.route != "auction" or after["resync_total"] != before["resync_total"]
            or after["delta_syncs"] != before["delta_syncs"] + 1
            or after["delta_rows_total"] - before["delta_rows_total"] != want_rows):
        raise AssertionError(f"north/second: not a delta sync of {want_rows} rows "
                             f"({before} -> {after}, route {meta2.route})")
    if any(n is None for n in names2):
        raise AssertionError("north star: a second-batch pod was not placed")
    for pod, name in zip(pods2, names2):
        big.assume(pod, name)
    check_capacity(big.state)
    north["second"] = {"delta_rows": want_rows, "padded_nodes": big.state.node_axis_bucket,
                       "warm": rw, "cold": rc, "launches": north2_launches}
    emit(north)
    wide_edges_phase(wrappers, TorchBatchScheduler, big, assign, dv, filters, bindings, torch)
    # ---- bench.py's c5: the gang burst, 10,000 pods in 100 gangs ---------
    summary.extend(gang_phase(wrappers, TorchBatchScheduler, assign, auction, bindings, torch,
                              card))
    # ---- the scheduler's front half: the columnar encode, the profiles ----
    encode, encode_launches = drive_phase(
        "encode", lambda: encode_phase(wrappers, pods, got, card), bindings, [])
    emit(dict(encode, launches=encode_launches))
    emit(profiles_phase(wrappers, TorchBatchScheduler, bindings, torch, card))
    # ---- the scheduler loop: Store -> informers -> Scheduler -> bind waves ----
    emit(loop_phase(wrappers, TorchBatchScheduler, bindings, torch, card))
    # every phase so far arms no fault: breakers, fallbacks and cold
    # partials syncs only ever count up, so one check covers them all
    emit({"phase": "breakers", "schedulers_checked": assert_healthy(), "state": "closed",
          "trips": 0, "fallbacks": 0, "partials_sync_failures": 0})

    # ---- degraded mode: the fault points, the breaker, the host fallback ----
    fault_out = faults_phase(wrappers, TorchBatchScheduler, assign, auction, filters, dv,
                             bindings, torch, card)
    summary.append(fault_out["batch_preemption"]["dry_run_victims"])

    print(card, flush=True)
    kernels = []
    for row in summary:
        src, replaces = SOURCES[row["name"]]
        kernels.append({
            "name": row["name"], "route": "cuda", "source": src,
            "replaces": row.get("replaces", replaces), "launches": row["launches"],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row.get("library_ms"),
            **{k: row[k] for k in ("shape", "card_ms", "host_ms", "device_ms", "rounds",
                                   "stage_of", "entry") if k in row},
        })
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


def parity_phase(wrappers, assign, auction, dv, filters, bindings, torch) -> dict:
    """Every kernel against its plain version on small batches (see the
    module docstring), exact.  Returns the gang stage's summary row at the
    fractional gang batch (PG)."""
    import numpy as np
    from kubernetes_tpu_torch.ops import schema, scores
    from kubernetes_tpu_torch.testing.cases import (
        capacity_edge_objects, contended_objects, fractional_gang_objects,
        fractional_mix_objects, gang_objects, mixed_objects, spread_objects,
        topology_spreading_objects,
    )

    cfgs = (
        scores.ScoreConfig(),
        scores.ScoreConfig(fit_strategy="MostAllocated"),
        scores.ScoreConfig(
            fit_strategy="RequestedToCapacityRatio",
            rtcr_shape=((0.0, 0.0), (50.0, 7.0), (100.0, 10.0)),
        ),
    )
    checked = {"greedy": 0, "wavefront": 0, "auction": 0, "rounds": 0, "spread_batches": 0}
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
        checked["rounds"] += run_auction(dv.to_device(snap, "cuda"), cfg, None, auction, bindings,
                                         torch)
        checked["auction"] += 1
    for (nodes, pending, _b), tie_k, on_cpu in (
            (contended_objects(wrappers, 32, 256, 16), None, False),
            (contended_objects(wrappers, 10, 300, 20), None, False),
            (contended_objects(wrappers, 24, 96, 110), 8, False),
            (gang_objects(wrappers), None, False),
            # requests that are not whole MiB, sums past float32's exact
            # range: the prefix's and the commit's order of additions show
            (capacity_edge_objects(wrappers, 64, 1000, 10), None, True),
            (fractional_mix_objects(wrappers, 0), None, True),
            # an incomplete gang released by the post-pass on such nodes
            (fractional_gang_objects(wrappers, 1), None, True)):
        snap, _meta = schema.SnapshotBuilder().build(nodes, pending)
        checked["rounds"] += run_auction(dv.to_device(snap, "cuda"), cfgs[0], tie_k, auction,
                                         bindings, torch,
                                         cpu_snap=dv.to_device(snap, "cpu") if on_cpu else None)
        checked["auction"] += 1
    # the gang post-pass itself, card against CPU, past the exact range:
    # one auction_loop launch (the gang stage inside), no stage alone, no
    # plain twin on the card
    nodes, pending, _b = fractional_gang_objects(wrappers, 1)
    snap, _meta = schema.SnapshotBuilder().build(nodes, pending)
    torch.cuda.synchronize()
    bindings.reset_launches()
    gang_card = auction.auction_assign(dv.to_device(snap, "cuda"), n_groups=schema.num_groups(snap))
    torch.cuda.synchronize()
    gang_launches = dict(bindings.LAUNCHES)
    check_launches("parity/gang", gang_launches, {"class_statics", "auction_loop"})
    check_auction_launches("parity/gang", gang_launches, 1)
    check_cold_preps("parity/gang", gang_launches, 1)
    gang_cpu = auction.auction_assign(dv.to_device(snap, "cpu"), n_groups=schema.num_groups(snap))
    if not bool(gang_cpu.gang_dropped.any()):
        raise AssertionError("parity: the fractional gang case released no gang")
    snap_gang = snap
    check_equal("auction gang post-pass (card against CPU)",
                result_fields(gang_card, True), result_fields(gang_cpu, False), torch)
    # the scan's and the wavefront's gang release on such nodes
    nodes, pending, _b = fractional_gang_objects(wrappers, 2, 8, 300)
    snap, _meta = schema.SnapshotBuilder().build(nodes, pending)
    ts, cs_ = dv.to_device(snap, "cuda"), dv.to_device(snap, "cpu")
    features = assign.features_of(snap)
    members = assign.plan_waves(snap, features, 32).members
    for label, solve in (("greedy", lambda x: assign.greedy_assign(x)),
                         ("wavefront", lambda x: assign.wavefront_assign(x, members))):
        card_res, cpu_res = solve(ts), solve(cs_)
        if not bool((cpu_res.reasons == assign.REASON_GANG).any()):
            raise AssertionError(f"parity: the fractional gang case released no gang ({label})")
        check_equal(f"{label} gang release (card against CPU)",
                    result_fields(card_res, True), result_fields(cpu_res, False), torch)
    checked["gang_release"] = 3
    # PodTopologySpread batches through the three solves
    spread_cases = [spread_objects(wrappers, seed) for seed in range(4)]
    spread_cases.append(spread_objects(wrappers, 4, 40, 200, soft_share=0.7))
    tsn, _ti, tsm = topology_spreading_objects(wrappers, 64, 0, 300)
    spread_cases.append((tsn, tsm, []))
    for k, (nodes, pending, bound_pods) in enumerate(spread_cases):
        snap, _meta = schema.SnapshotBuilder().build(nodes, pending, bound_pods=bound_pods)
        cfg = (cfgs + (scores.ScoreConfig(spread_weight=1.7),))[k % 4]
        ts = dv.to_device(snap, "cuda")
        features = assign.features_of(snap)
        n_groups = schema.num_groups(snap)
        run_kernels(ts, features, n_groups, cfg, assign, filters, bindings, torch)
        rng = np.random.default_rng(100 + k)
        for members in (assign.plan_waves(snap, features, 8).members,
                        random_partition(snap, rng, 8, np),
                        random_partition(snap, rng, 32, np)):
            fallbacks += run_wavefront(ts, features, n_groups, cfg, members, assign, bindings, torch)
        checked["rounds"] += run_auction(ts, cfg, None, auction, bindings, torch,
                                         cpu_snap=dv.to_device(snap, "cpu"))
        checked["spread_batches"] += 1
    checked["family_batches"] = 0
    fallbacks += family_parity(wrappers, assign, auction, dv, filters, bindings, torch, checked)
    torch.cuda.synchronize()
    if not fallbacks:
        raise AssertionError("parity: no wavefront fallback was exercised")
    emit({"phase": "parity", "cases": checked, "wavefront_fallbacks": fallbacks, "exact": True})
    meta_gang = _meta_of(snap_gang, assign, auction, schema)
    return dict(gang_row(dv.to_device(snap_gang, "cuda"), meta_gang, scores.ScoreConfig(), "PG",
                         auction, bindings, torch),
                shape="PG", launches=stage_launches("auction_gang", gang_launches))


def resident_parity(wrappers, TorchBatchScheduler, dv, pops, bindings, torch) -> None:
    """partials_eval and mirror_rows against their plain versions on the
    parity batches (mixed seeds 0-5 and the family batches), exact: each
    batch encoded by a warm TorchBatchScheduler(mode="greedy") on the card;
    its resident store equals the plain evaluation of every slot over every
    column, and kernel refreshes of random column subsets equal the plain
    ones; one sync's fresh store (update_store: missed slots, 0-33 dirty
    columns and the last, a grow and a shrink of the old width) equals its
    plain version, the old store byte-unchanged; after a few assumes a
    delta sync (mirror_rows) leaves the resident cluster equal to the
    state's tensors and the store equal to a full recompute; then
    mirror_rows on random leaves of every dtype and both row axes into
    fresh leaves (16-, 4- and 1-byte units, a dense delta, the last row),
    the old leaves byte-unchanged."""
    import numpy as np
    from kubernetes_tpu_torch.ops import schema
    from kubernetes_tpu_torch.testing.cases import mixed_objects

    cases = [mixed_objects(wrappers, seed) for seed in range(6)]
    cases += [c for _label, c in family_cases(wrappers)]
    checked = {"stores": 0, "refreshes": 0, "updates": 0, "deltas": 0, "leaves": 0,
               "units": []}
    for k, (nodes, pending, bound_pods) in enumerate(cases):
        sched = TorchBatchScheduler(mode="greedy")
        for node in nodes:
            sched.add_node(node)
        for pod in bound_pods:
            sched.assume(pod, pod.spec.node_name)
        snap, meta = sched.encode_pending(pending)
        if meta.statics is None:
            raise AssertionError(f"resident parity {k}: the batch ran cold")
        cl, specs, store = sched._mirror.sync(), sched._partials._specs, sched._partials._store
        g = specs.valid.shape[0]
        slots = torch.arange(g, dtype=torch.int32, device="cuda")
        check_equal(f"partials_eval (parity {k}, full)", tuple(store),
                    pops.eval_cols_plain(cl, specs, slots, None), torch)
        checked["stores"] += 1
        rng = np.random.default_rng(300 + k)
        n = cl.allocatable.shape[0]
        for size in (1, max(1, n // 3), n):
            cols = torch.from_numpy(rng.choice(n, size, replace=False).astype(np.int32)).cuda()
            fresh = pops.refresh_rows(pops.PartialsStore(*(torch.zeros_like(t) for t in store)),
                                      specs, cl, cols)
            check_equal(f"partials_eval (parity {k}, {size} columns)",
                        tuple(t[:, cols.long()] for t in fresh),
                        pops.eval_cols_plain(cl, specs, slots, cols), torch)
            checked["refreshes"] += 1
        # one sync's update against its plain version on the same tensors:
        # missed slots and dirty columns (0, 1, 31, 32, 33 and the last),
        # a grow (the old store narrower) and a shrink (wider); the old
        # store byte-unchanged
        for size in (0, 1, 31, 32, 33):
            pick = np.sort(rng.choice(n, min(size, n), replace=False))
            if size == 1:
                pick = np.array([n - 1])
            for miss_n, width in ((0, n), (2, n), (2, max(n - 40, 1)), (0, n + 24)):
                miss = np.sort(rng.choice(g, miss_n, replace=False)).astype(np.int32)
                old = pops.PartialsStore(*(
                    t[:, :width].contiguous() if width <= n else
                    torch.cat([t, t[:, :1].expand(-1, width - n)], dim=1) for t in store))
                before = [t.clone() for t in old]
                up = lambda a: (torch.from_numpy(a.astype(np.int32)).cuda() if a.shape[0]
                                else None)
                args = (specs, cl, up(miss), up(pick.astype(np.int32)))
                check_equal(f"partials_eval (parity {k}, {miss_n} missed, {size} columns, "
                            f"old width {width})", tuple(pops.update_store(old, *args)),
                            tuple(pops.update_store_plain(old, *args)), torch)
                if not all(torch.equal(a, b) for a, b in zip(old, before)):
                    raise AssertionError(f"resident parity {k}: an update changed the old store")
                checked["updates"] += 1
        names = sched.solve_encoded(snap, meta)
        placed = [(pod, name) for pod, name in zip(pending, names) if name is not None][:3]
        for pod, name in placed:
            sched.assume(pod, name)
        sched.encode_pending([wrappers.make_pod("resident-probe")
                              .req(cpu_milli=100, mem=wrappers.MI).obj()])
        if placed and sched._mirror.last_sync != "delta":
            raise AssertionError(f"resident parity {k}: {sched._mirror.last_sync}, not a delta")
        dev = sched._mirror.sync()
        for f, want in zip(schema.ClusterTensors._fields, sched.state.tensors()):
            got = getattr(dev, f).cpu().numpy()
            if not np.array_equal(got, dv._canon(want)):
                raise AssertionError(f"resident parity {k}: leaf {f} differs from the state")
        if not sched._partials.verify(dev):
            raise AssertionError(f"resident parity {k}: the store differs from a full recompute")
        checked["deltas"] += bool(placed)
    # random leaves, every dtype, node axis 0 and 1, into fresh leaves;
    # some at addresses that allow only 4- or 1-byte units (views of a
    # larger buffer), dense deltas and a one-row delta at the last row;
    # the old leaves byte-unchanged
    rng = np.random.default_rng(7)
    stage = dv.PinnedStage()
    for n in (8, 37, 8192):
        targets = []
        for shape, dtype, ax, shift in (((n, 4), np.float32, 0, 0), ((n,), np.bool_, 0, 0),
                                        ((n, 3), np.int32, 0, 4), ((n, 128), np.uint32, 0, 0),
                                        ((3, n, 8), np.uint32, 1, 0), ((3, n), np.bool_, 1, 1),
                                        ((n, 2), np.float32, 0, 8), ((n,), np.bool_, 0, 3)):
            d = int(rng.integers(1, min(n, 600)))
            if len(targets) == 6:
                d = n   # every row
            idx = np.sort(rng.choice(n, d, replace=False)).astype(np.int32)
            if len(targets) == 7:
                idx = np.array([n - 1], dtype=np.int32)
            vshape = list(shape)
            vshape[ax] = idx.shape[0]
            if dtype == np.bool_:
                base, vals = rng.random(shape) < 0.5, rng.random(vshape) < 0.5
            elif dtype == np.float32:
                base = rng.standard_normal(shape).astype(np.float32)
                vals = rng.standard_normal(vshape).astype(np.float32)
            else:
                base = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(dtype)
                vals = rng.integers(0, 2**32, vshape, dtype=np.uint64).astype(dtype)
            host = torch.from_numpy(dv._canon(base).copy())
            raw = torch.zeros(host.numel() * host.element_size() + shift, dtype=torch.uint8,
                              device="cuda")
            src = raw[shift:].view(host.dtype).view(host.shape)
            src.copy_(host)
            targets.append(dv.RowTarget(src, ax, idx, vals))
        before = [t.src.clone() for t in targets]
        got = dv.set_rows(targets, stage, torch.device("cuda"))
        pack = dv.pack_rows(targets, stage, torch.device("cuda"))
        check_equal(f"mirror_rows (random leaves, {n} rows)", tuple(got),
                    tuple(dv.set_rows_plain(pack, targets)), torch)
        if not all(torch.equal(t.src, b) for t, b in zip(targets, before)):
            raise AssertionError(f"mirror_rows (random leaves, {n} rows): an old leaf changed")
        checked["leaves"] += len(targets)
        checked["units"] = sorted({lay.unit for lay in pack.layouts} | set(checked["units"]))
    torch.cuda.synchronize()
    emit({"phase": "resident_parity", "cases": checked, "exact": True})


def family_cases(wrappers):
    """(label, (nodes, pending, bound)) of the inter-pod, preferred
    inter-pod and ImageLocality parity batches (testing/cases.py), and one
    with both extras families."""
    from kubernetes_tpu_torch.testing import cases

    out = []
    for seed in range(2):
        out.append((f"interpod{seed}", cases.interpod_objects(wrappers, seed)))
        out.append((f"anti{seed}", cases.interpod_objects(wrappers, seed, anti_only=True)))
        out.append((f"prefpod{seed}", cases.prefpod_objects(wrappers, seed)))
        out.append((f"image{seed}", cases.image_objects(wrappers, seed)))
    # both extras families in one batch: a preferred-term batch on nodes
    # that hold images, its pods with images
    nodes, pods, bound = cases.prefpod_objects(wrappers, 5)
    inodes, ipods, _b = cases.image_objects(wrappers, 5, n_nodes=len(nodes), n_pods=len(pods))
    for node, inode in zip(nodes, inodes):
        node.status.images = inode.status.images
    for pod, ipod in zip(pods, ipods):
        pod.spec.containers[0].image = ipod.spec.containers[0].image
    out.append(("both5", (nodes, pods, bound)))
    return out


def family_parity(wrappers, assign, auction, dv, filters, bindings, torch, checked) -> int:
    """The family batches through the three solves, every kernel against
    its plain version (the auction where its families allow it, also
    against the plain loop on the CPU), under the default weights and
    under weights that are not powers of two; returns the wavefront
    fallbacks taken."""
    import numpy as np
    from kubernetes_tpu_torch.ops import schema, scores

    cfgs = (scores.ScoreConfig(), scores.ScoreConfig(interpod_weight=1.3, image_weight=0.7))
    fallbacks = 0
    for k, (label, (nodes, pending, bound_pods)) in enumerate(family_cases(wrappers)):
        snap, _meta = schema.SnapshotBuilder().build(nodes, pending, bound_pods=bound_pods)
        cfg = cfgs[k % 2]
        ts = dv.to_device(snap, "cuda")
        features = assign.features_of(snap)
        n_groups = schema.num_groups(snap)
        run_kernels(ts, features, n_groups, cfg, assign, filters, bindings, torch)
        rng = np.random.default_rng(200 + k)
        for members in (assign.plan_waves(snap, features, 8).members,
                        random_partition(snap, rng, 8, np)):
            fallbacks += run_wavefront(ts, features, n_groups, cfg, members, assign, bindings,
                                       torch)
        if auction.auction_features_ok(features):
            checked["rounds"] += run_auction(ts, cfg, None, auction, bindings, torch,
                                             cpu_snap=dv.to_device(snap, "cpu"))
            checked["auction"] += 1
        checked["family_batches"] += 1
    return fallbacks


def cpu_copy(snap):
    """The snapshot's tensors copied to the CPU (the plain path's input)."""
    return type(snap)(*(type(t)(*(x.cpu() for x in t)) for t in snap))


def result_fields(res, to_cpu: bool) -> tuple:
    """The compared fields of a solve result, as CPU tensors: assignment,
    scores, reasons and the post-solve usage; then the route's own —
    feasible counts (scan, wavefront), wave counters (wavefront), rounds,
    gang_dropped and the final spread counts and term bits (auction)."""
    names = ("assignment", "scores", "reasons", "feasible_counts", "wave_count",
             "wave_fallbacks", "rounds", "gang_dropped", "debug_sp_counts")
    out = [getattr(res, f, None) for f in names]
    out += list(getattr(res, "debug_term_bits", None) or (None,) * 3)
    out += [res.cluster.requested, res.cluster.nonzero_requested]
    return tuple(None if t is None else (t.cpu() if to_cpu else t) for t in out)


def host_syncs(fn, torch) -> list:
    """file:line of every host sync fn() makes with the card (torch's
    sync debug mode, one warning a sync)."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return [f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}" for w in caught]


def zone_skew(names, zone_of) -> int:
    """max - min of the placed pods' counts over the zones."""
    counts = {z: 0 for z in set(zone_of.values())}
    for name in names:
        if name is not None:
            counts[zone_of[name]] += 1
    return max(counts.values()) - min(counts.values())


def spread_phase(wrappers, TorchBatchScheduler, assign, auction, filters, bindings, torch,
                 card):
    """TopologySpreading/5000Nodes through TorchBatchScheduler on every
    route, each result held against the plain path on the CPU for the
    same snapshot; returns the spread path's kernel rows (timed at these
    shapes) and the launch counts of the default-route run."""
    from kubernetes_tpu_torch.testing.cases import topology_spreading_objects

    nodes, init, measured = topology_spreading_objects(wrappers, *SPREAD)
    zone_of = {nd.meta.name: f"zone-{i % ZONES}" for i, nd in enumerate(nodes)}
    timing = {}

    def new_sched(**kw):
        s = TorchBatchScheduler(**kw)
        for node in nodes:
            s.add_node(node)
        return s

    cfg = assign.DEFAULT_SCORE_CONFIG

    def check_cpu(what, snap, meta, res):
        check_plain(f"spread/{what}", {"snap": snap, "meta": meta, "result": res}, assign,
                    auction, cfg, torch, timing)

    # the default route: init batch (auction, no spread), measured (auction + repair)
    sched = new_sched()

    def run_default():
        t = time.perf_counter()
        init_names = sched.schedule_pending(init)
        timing["init_s"] = time.perf_counter() - t
        timing["init_rounds"] = int(sched.last_result.rounds)
        for pod, name in zip(init, init_names):
            if name is None:
                raise AssertionError(f"spread: init pod {pod.meta.name} was not placed")
            sched.assume(pod, name)
        snap, meta = sched.encode_pending(measured)
        if meta.route != "auction" or not meta.features.spread:
            raise AssertionError(f"spread: measured batch took route {meta.route}")
        timing["snap"] = (snap, meta)
        torch.cuda.synchronize()
        t = time.perf_counter()
        names = sched.schedule_pending(measured)
        timing["measured_s"] = time.perf_counter() - t
        return init_names, names

    (init_names, names), launches = drive_phase("spread", run_default, bindings, [sched])
    snap, meta = timing["snap"]
    res = sched.last_result
    rounds = int(res.rounds)
    check_cpu("auction", snap, meta, res)
    skew = zone_skew(names, zone_of)
    if skew > SPREAD_MAX_SKEW:
        raise AssertionError(f"spread: measured pods' zone skew {skew} > {SPREAD_MAX_SKEW}")
    placed = sum(n is not None for n in names)
    for pod, name in zip(measured, names):
        if name is not None:
            sched.assume(pod, name)
    check_capacity(sched.state)
    syncs = host_syncs(lambda: solve_route("auction", snap, meta, assign, auction, cfg), torch)
    out = {"phase": "spread", "workload": "TopologySpreading/5000Nodes", "route": "auction",
           "auction_host_syncs": syncs,
           "init_s": timing["init_s"], "init_rounds": timing["init_rounds"],
           "measured_s": timing["measured_s"], "pods_per_s": len(measured) / timing["measured_s"],
           "placed": placed, "rounds": rounds, "zone_skew": skew, "tie_k": meta.tie_k,
           "last_timings": sched.last_timings, "launches": launches}

    # the scan: the same measured batch, same state
    gsched = new_sched(mode="greedy", use_wavefront=False)
    for pod, name in zip(init, init_names):
        gsched.assume(pod, name)

    def run_scan():
        s, m = gsched.encode_pending(measured)
        if m.route != "greedy":
            raise AssertionError(f"spread/greedy: route {m.route}")
        timing["gsnap"] = (s, m)
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = gsched.schedule_pending(measured)
        timing["greedy_s"] = time.perf_counter() - t
        return got

    gnames, glaunches = drive_phase("spread/greedy", run_scan, bindings, [gsched])
    gsnap, gmeta = timing["gsnap"]
    check_cpu("greedy", gsnap, gmeta, gsched.last_result)
    out["greedy"] = {"measured_s": timing["greedy_s"],
                     "pods_per_s": len(measured) / timing["greedy_s"],
                     "placed": sum(n is not None for n in gnames),
                     "zone_skew": zone_skew(gnames, zone_of),
                     "last_timings": gsched.last_timings, "launches": glaunches}

    # the wavefront: the measured batch in batches of 500 (pad 512)
    wsched = new_sched()
    for pod, name in zip(init, init_names):
        wsched.assume(pod, name)
    wave = {"batches": []}

    def run_waves():
        for lo in range(0, len(measured), SPREAD_BATCH):
            batch = measured[lo : lo + SPREAD_BATCH]
            s, m = wsched.encode_pending(batch)
            if m.route != "wavefront":
                raise AssertionError(f"spread/wavefront: a batch took route {m.route}")
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = wsched.schedule_pending(batch)
            dt = time.perf_counter() - t
            wave["batches"].append({
                "pods": len(batch), "s": dt, "wave_count": wsched.last_solve.wave_count,
                "wave_fallbacks": wsched.last_solve.wave_fallbacks,
                "solve_s": wsched.last_timings["solve_s"],
                "encode_s": wsched.last_timings["encode_s"],
            })
            wave.setdefault("solves", []).append((s, m, wsched.last_result))
            for pod, name in zip(batch, got):
                if name is not None:
                    wsched.assume(pod, name)

    _, wlaunches = drive_phase("spread/wavefront", run_waves, bindings, [wsched])
    for k, (s, m, r) in enumerate(wave["solves"]):
        check_cpu(f"wavefront{k}", s, m, r)
    wsec = sum(b["s"] for b in wave["batches"])
    out["wavefront"] = {"batch_size": SPREAD_BATCH, "batches": wave["batches"],
                        "measured_s": wsec, "pods_per_s": len(measured) / wsec,
                        "launches": wlaunches}

    # ScheduleAnyway (PreferredTopologySpreading's shape): the soft score;
    # the measured template with that one field changed (the case builder
    # is held to the YAML templates by tests/test_torch_spread_solves.py)
    _n, _i, soft = topology_spreading_objects(wrappers, *SPREAD, when="ScheduleAnyway")
    ssched = new_sched()
    for pod, name in zip(init, init_names):
        ssched.assume(pod, name)

    def run_soft():
        s, m = ssched.encode_pending(soft)
        if m.route != "auction" or not m.features.soft_spread:
            raise AssertionError(f"spread/soft: route {m.route}")
        timing["ssnap"] = (s, m)
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = ssched.schedule_pending(soft)
        timing["soft_s"] = time.perf_counter() - t
        return got

    snames, slaunches = drive_phase("spread/soft", run_soft, bindings, [ssched])
    ssnap, smeta = timing["ssnap"]
    check_cpu("soft", ssnap, smeta, ssched.last_result)
    out["soft"] = {"template": "pod-with-topology-spreading.yaml with whenUnsatisfiable: "
                               "ScheduleAnyway", "measured_s": timing["soft_s"],
                   "pods_per_s": len(soft) / timing["soft_s"],
                   "placed": sum(n is not None for n in snames),
                   "rounds": int(ssched.last_result.rounds),
                   "zone_skew": zone_skew(snames, zone_of),
                   "last_timings": ssched.last_timings, "launches": slaunches}
    out["cpu_check_s"] = {k: v for k, v in timing.items() if k.endswith("_cpu_s")}

    # kernel family_prep (the spread entry) against its plain twin on the
    # card and on the CPU, exact, timed at the auction batch's shapes (T);
    # the scan's and the wavefront's batches (S: the first) checked too
    fam = check_family("T", snap, meta.features, meta.topo_split, filters, bindings, torch,
                       timed=True)["spread"]
    fam.update(shape="T", launches=launches["family_prep"],
               rows=int(snap.spread.valid.shape[0]), z=int(meta.topo_split[0]))
    check_family("spread/greedy", gsnap, gmeta.features, gmeta.topo_split, filters, bindings,
                 torch)
    for k, (s_w, m_w, _r) in enumerate(wave["solves"]):
        check_family(f"S{k}", s_w, m_w.features, m_w.topo_split, filters, bindings, torch)
    out["family_prep"] = fam

    # the reasons stage of the auction program: the measured batch's final
    # state (before any gang release: this batch has none) through the
    # stage alone, against the scheduler's result (the loop's own run of
    # the stage) and the plain twin on CPU copies; timed in run_auction
    cl_r, pods_r, st_r = auction.auction_prep(snap, meta.features, meta.topo_split)
    reason_args = (cl_r, pods_r, st_r, res.assignment, res.cluster.requested,
                   res.cluster.nonzero_requested, res.debug_sp_counts)
    stage = auction.failure_reasons(*reason_args)
    check_equal("spread/reasons pass", (stage,), (res.reasons,), torch)
    check_equal("spread/reasons pass (card against the CPU)", (stage,),
                (auction.failure_reasons_plain(*cpu_args(reason_args, torch)),), torch)

    # the spread path's kernels at these shapes, timed
    rows = run_kernels(gsnap, gmeta.features, gmeta.n_groups, gsched.score_config,
                       assign, filters, bindings, torch, timed=True)
    rows = [r for r in rows if r["name"] == "greedy_scan"]
    s0, m0, _r0 = wave["solves"][0]
    rows.append(run_wavefront(s0, m0.features, m0.n_groups, wsched.score_config,
                              m0.wave_plan.members, assign, bindings, torch, timed=True))
    rows.extend(run_auction(snap, sched.score_config, meta.tie_k, auction, bindings, torch,
                            timed=True))
    launches_of = {"greedy_scan": glaunches, "wavefront": wlaunches}
    for r in rows:
        r["launches"] = stage_launches(r["name"], launches_of.get(r["name"], launches))
    rows.append(fam)
    out["kernels"] = rows
    out["card"] = card
    emit(out)
    # match_terms' launches: the warm scan and wavefront batches' selector masks
    return rows, launches, glaunches["match_terms"] + wlaunches["match_terms"]


def solve_route(route, snap, meta, assign, auction, cfg, statics=None):
    """The solve TorchBatchScheduler dispatches for `route`, called on
    `snap` (on the card, or a CPU copy for the plain path); `statics` are
    warm class statics for the scan and the wavefront (None: cold)."""
    if route == "auction":
        return auction.auction_assign(snap, cfg, n_groups=meta.n_groups, features=meta.features,
                                      tie_k=meta.tie_k, topo_z=meta.topo_split)
    if route == "wavefront":
        return assign.wavefront_assign(snap, meta.wave_plan.members, cfg, features=meta.features,
                                       n_groups=meta.n_groups, topo_z=meta.topo_split,
                                       statics=statics)
    return assign.greedy_assign(snap, cfg, features=meta.features, n_groups=meta.n_groups,
                                topo_z=meta.topo_split, statics=statics)


def route_kernels(meta) -> set:
    """The kernels a batch launches, from its meta: the route's own (cold:
    class_statics, no match_terms); with warm statics (meta.statics, the
    resident partials) no class_statics, and match_terms when the spread
    family needs the selector mask;
    class_extras with preferred inter-pod terms or images; family_prep with
    the spread, inter-pod or preferred inter-pod family (one launch a
    family); and the kernels the residents launched while encoding it."""
    f = meta.features
    kernels = set(ROUTE_KERNELS[meta.route])
    if f.spread or f.interpod or f.interpod_pref:
        kernels.add("family_prep")
    if meta.statics is not None:
        kernels.discard("class_statics")
        if f.spread:
            kernels.add("match_terms")
    kernels |= {k for k, v in (meta.resident_launches or {}).items() if v}
    if f.interpod_pref or f.images:
        kernels.add("class_extras")
    if meta.route == "greedy" and f.slices:
        kernels.add("slice_stats")
    return kernels


def drive_workload(name, sched, batches, bindings, torch):
    """Solve each (label, pods, route) batch in turn through `sched`
    (encode, check the route, solve, assume every placement), with the
    launch counters reset before the first and read after the last: every
    kernel the batches' routes and families launch (route_kernels) was
    launched, and no other.  Returns the batches' records (label, pods,
    names, snapshot, meta, result, seconds, last_timings) and the launch
    counts."""
    def run():
        out = []
        for label, pods, route in batches:
            snap, meta = sched.encode_pending(pods)
            if meta.route != route:
                raise AssertionError(f"{name}/{label}: route {meta.route}, not {route}")
            torch.cuda.synchronize()
            t = time.perf_counter()
            names = sched.schedule_pending(pods)
            dt = time.perf_counter() - t
            out.append({"label": label, "pods": pods, "names": names, "snap": snap,
                        "meta": meta, "result": sched.last_result, "s": dt,
                        "timings": dict(sched.last_timings)})
            for pod, node in zip(pods, names):
                if node is not None:
                    sched.assume(pod, node)
        return out

    recs, launches = drive_phase(name, run, bindings, [sched])
    check_capacity(sched.state)
    return recs, launches


def check_plain(what, rec, assign, auction, cfg, torch, timing) -> None:
    """A batch's card result against the plain path on the CPU for the same
    snapshot, every compared field."""
    t = time.perf_counter()
    want = solve_route(rec["meta"].route, cpu_copy(rec["snap"]), rec["meta"], assign, auction, cfg)
    timing[f"{what}_cpu_s"] = time.perf_counter() - t
    check_equal(f"{what} (card against the plain path on the CPU)",
                result_fields(rec["result"], True), result_fields(want, False), torch)


def batch_summary(rec) -> dict:
    res = rec["result"]
    out = {"batch": rec["label"], "route": rec["meta"].route, "pods": len(rec["pods"]),
           "placed": sum(n is not None for n in rec["names"]), "s": rec["s"],
           "pods_per_s": len(rec["pods"]) / rec["s"], "last_timings": rec["timings"]}
    if getattr(res, "rounds", None) is not None:
        out["rounds"] = int(res.rounds)
    if getattr(res, "wave_count", None) is not None:
        out["wave_count"] = int(res.wave_count)
        out["wave_fallbacks"] = int(res.wave_fallbacks)
    return out


def prep_terms_need(snap, features, state, torch) -> tuple:
    """(bytes, operations) of prep_terms on this data: the live terms'
    topology columns, node validity and bound-pod rows in; the present,
    blocked and key words out, and the pod-axis word tables; about 8
    operations a live (term, node) pair (the value-space scatter, the
    gather back, the packing)."""
    terms = snap.terms
    live, slots = live_term_rows(terms, torch)
    n = snap.cluster.node_valid.shape[0]
    need = (nbytes(snap.cluster.topo_ids[:, slots], snap.cluster.node_valid,
                   terms.node_matches[live], terms.node_owners[live], terms.matches_incoming,
                   terms.aff_idx, terms.anti_idx)
            + nbytes(*state))
    return need, 8.0 * int(live.numel()) * n


def prep_pref_pod_need(snap, state, torch) -> tuple:
    """(bytes, operations) of prep_pref_pod on this data: the live rows'
    topology columns, node validity and bound-pod counts and weights in,
    their domain sums out; about 8 operations a live (row, node) pair."""
    table = snap.prefpod
    live = torch.nonzero(table.valid).flatten()
    slots = torch.unique(table.slot[live]).long()
    n = snap.cluster.node_valid.shape[0]
    need = (nbytes(snap.cluster.topo_ids[:, slots], snap.cluster.node_valid,
                   table.node_counts[live], table.owner_weight[live])
            + nbytes(state.counts_dom[live], state.ownerw_dom[live]))
    return need, 8.0 * int(live.numel()) * n


def prep_spread_need(snap, sel_mask, state, torch) -> tuple:
    """(bytes, operations) of prep_spread on this data: the live rows'
    owners' selector rows, the topology columns they read, their tables in
    and state out; about 8 operations a live (row, node) pair."""
    sps, live = snap.spread, live_spread_rows(snap.spread, torch)
    n = snap.cluster.node_valid.shape[0]
    sel_rows = torch.unique(sps.owner_sel_idx[live][sps.owner_sel_idx[live] >= 0]).long()
    slots = torch.unique(sps.slot[live]).long()
    need = (nbytes(snap.cluster.topo_ids[:, slots], snap.cluster.node_valid,
                   sel_mask[sel_rows], sps.node_matches[live], sps.owner_keys[live],
                   sps.slot[live], sps.valid[live], sps.owner_sel_idx[live])
            + nbytes(*(t[live] for t in state)))
    return need, 8.0 * int(live.numel()) * n


def family_calls(snap, features, topo_split, filters, plain: bool) -> dict:
    """{entry: a call of its prep} for each family the batch uses, on the
    device the snapshot lies on: the wrappers (kernel family_prep on the
    card), or with plain=True the plain twins."""
    from kubernetes_tpu_torch.ops import interpod, topology

    z_spread, z_terms = topo_split
    calls = {}
    if features.spread:
        sel = filters.selector_match(snap.cluster, snap.selectors)
        fn = topology.prep_spread_plain if plain else topology.prep_spread
        calls["spread"] = lambda fn=fn: fn(snap.cluster, sel, snap.spread, z_spread,
                                           features.bound_spread)
    if features.interpod:
        fn = interpod.prep_terms_plain if plain else interpod.prep_terms
        calls["terms"] = lambda fn=fn: fn(snap.cluster, snap.terms, z_terms, features.term_slots,
                                          features.bound_terms)
    if features.interpod_pref:
        fn = interpod.prep_pref_pod_plain if plain else interpod.prep_pref_pod
        calls["pref"] = lambda fn=fn: fn(snap.cluster, snap.prefpod, z_terms,
                                         features.bound_pref)
    return calls


def check_family(tag, snap, features, topo_split, filters, bindings, torch,
                 timed: bool = False, count_ops: bool = False) -> dict:
    """Kernel family_prep on a snapshot on the card against its plain twins
    on the card and on a CPU copy, exact, each family the batch uses: one
    launch an entry.  With timed=True each entry's row: the card's time of
    a call behind a spin (launch_ms over 20 calls; the outputs are fresh
    each call, so no reset) with the host clock of the call beside it, the
    plain twin on the card (CUDA events over 20 calls, as cuda_ms), the
    bound of its work on this data.  After every call its scratch must be
    all zero; with timed or count_ops, one more call of each entry must be
    exactly one device operation, its kernel (family_one_op).  Returns
    {entry: row or max_abs_err}."""
    kern = family_calls(snap, features, topo_split, filters, False)
    plain = family_calls(snap, features, topo_split, filters, True)
    cpu = family_calls(cpu_copy(snap), features, topo_split, filters, True)
    if not kern:
        raise AssertionError(f"family_prep ({tag}): the batch uses no family")
    out = {}
    dev = snap.cluster.node_valid.device
    for entry, fn in kern.items():
        before = bindings.LAUNCHES["family_prep"]
        got = fn()
        if bindings.LAUNCHES["family_prep"] != before + 1:
            raise AssertionError(f"family_prep ({tag}, {entry}): not one launch")
        err = check_equal(f"family_prep {entry} ({tag})", got, plain[entry](), torch)
        check_equal(f"family_prep {entry} ({tag}, card against the CPU)", got, cpu[entry](),
                    torch)
        family_scratch_zero(f"{tag}, {entry}", dev, bindings)
        if timed or count_ops:
            family_one_op(f"{tag}, {entry}", fn, dev, bindings, torch)
        if not timed:
            out[entry] = err
            continue
        ms, host_ms = launch_ms(fn, lambda: None, 20, torch)
        plain_ms = cuda_ms(plain[entry], 20, torch)
        if entry == "spread":
            need = prep_spread_need(snap, filters.selector_match(snap.cluster, snap.selectors),
                                    got, torch)
        elif entry == "terms":
            need = prep_terms_need(snap, features, got, torch)
        else:
            need = prep_pref_pod_need(snap, got, torch)
        b = bound(*need)
        out[entry] = {"name": "family_prep", "entry": entry, "replaces": FAMILY_REPLACES[entry],
                      "max_abs_err": err, "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
                      "bound_ms": b[0], "bound_by": b[1], "library_ms": None,
                      "device_ops": 1}
    return out


def family_scratch_zero(what, dev, bindings) -> None:
    """family_prep's scratch on dev's stream is all zero (every launch
    leaves it so)."""
    scratch = bindings.family_scratch(dev)
    if scratch is not None and bool(scratch.any()):
        raise AssertionError(f"family_prep ({what}): its scratch is not zero after the call")


def family_one_op(what, call, dev, bindings, torch) -> None:
    """One more call of a family_prep entry captured into a CUDA graph on a
    side stream (its zero scratch made there first): the graph holds
    exactly one node, a kernel — no memset, no copy —; replayed once, it
    gives the call's outputs and leaves the scratch zero.  (torch.profiler
    has returned no device activity at all for such a launch late in this
    script, after another session, so the count reads the graph.)"""
    want = call()
    if dev not in _SIDE_STREAMS:
        _SIDE_STREAMS[dev] = torch.cuda.Stream(dev)
    stream = _SIDE_STREAMS[dev]
    grown = bindings.family_scratch(dev)
    bindings.family_scratch(dev, grown.numel() if grown is not None else 0, stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream):
        got = call()
    types = graph_node_types(graph)
    if types != [CU_GRAPH_NODE_TYPE_KERNEL]:
        raise AssertionError(f"family_prep ({what}): graph node types {types}, not one kernel")
    graph.instantiate()
    graph.replay()
    torch.cuda.synchronize()
    check_equal(f"family_prep ({what}, one call in a graph)", tuple(got), tuple(want), torch)
    scratch = bindings.family_scratch(dev, stream=stream)
    if scratch is not None and bool(scratch.any()):
        raise AssertionError(f"family_prep ({what}): its scratch is not zero after the replay")
    family_scratch_zero(what, dev, bindings)


CU_GRAPH_NODE_TYPE_KERNEL = 0   # cuda.h CUgraphNodeType
_SIDE_STREAMS = {}              # family_one_op's capture stream, one a device


def graph_node_types(graph) -> list:
    """The node types (cuda.h CUgraphNodeType) of a captured
    torch.cuda.CUDAGraph(keep_graph=True), from the driver API."""
    import ctypes

    cuda = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(handle, None, ctypes.byref(count)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    if count.value and cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(count)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    types = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        types.append(kind.value)
    return types


def interpod_phase(wrappers, TorchBatchScheduler, assign, auction, filters, bindings, torch,
                   card):
    """SchedulingPodAntiAffinity/5000Nodes and SchedulingPodAffinity/5000Nodes
    through TorchBatchScheduler on their default routes (anti-affinity: the
    auction with auction_interpod; affinity: the wavefront, one-pod waves)
    and on the scan, every batch against the plain path on the CPU; the
    hard constraints checked; auction_interpod and prep_terms timed at the
    anti-affinity measured batch's shapes.  Returns (the kernel rows, the
    launch counts of the anti-affinity default-route run, prep_terms'
    timing row)."""
    from kubernetes_tpu_torch.testing.cases import pod_affinity_objects, pod_anti_affinity_objects

    timing = {}
    out = {"phase": "interpod"}
    def new_sched(nodes, **kw):
        s = TorchBatchScheduler(**kw)
        for node in nodes:
            s.add_node(node)
        return s

    # SchedulingPodAntiAffinity: init and measured on the auction
    nodes, init, measured = pod_anti_affinity_objects(wrappers, *ANTI)
    sched = new_sched(nodes)
    cfg = sched.score_config
    recs, launches = drive_workload(
        "interpod/anti", sched, [("init", init, "auction"), ("measured", measured, "auction")],
        bindings, torch)
    for rec in recs:
        if None in rec["names"]:
            raise AssertionError(f"interpod/anti: a {rec['label']} pod was not placed")
        check_plain(f"anti/{rec['label']}", rec, assign, auction, cfg, torch, timing)
    green = [n for rec in recs for n in rec["names"]]
    if len(set(green)) != len(green):
        raise AssertionError("interpod/anti: two color=green pods share a node")
    meas = recs[1]
    syncs = host_syncs(lambda: solve_route("auction", meas["snap"], meas["meta"], assign,
                                           auction, cfg), torch)
    # the same measured batch on the scan
    gsched = new_sched(nodes, mode="greedy", use_wavefront=False)
    for pod, node in zip(init, recs[0]["names"]):
        gsched.assume(pod, node)
    grecs, glaunches = drive_workload("interpod/anti/greedy", gsched,
                                      [("measured", measured, "greedy")], bindings, torch)
    check_plain("anti/greedy", grecs[0], assign, auction, cfg, torch, timing)
    gnames = grecs[0]["names"]
    if None in gnames or len(set(gnames) | set(recs[0]["names"])) != len(gnames) + len(init):
        raise AssertionError("interpod/anti/greedy: a pod unplaced, or two green pods on a node")
    out["anti"] = {"workload": "SchedulingPodAntiAffinity/5000Nodes",
                   "batches": [batch_summary(r) for r in recs], "auction_host_syncs": syncs,
                   "launches": launches, "greedy": dict(batch_summary(grecs[0]),
                                                        launches=glaunches)}

    # SchedulingPodAffinity: init and measured on the wavefront
    nodes_a, init_a, measured_a = pod_affinity_objects(wrappers, *AFFINITY_POD)
    zone_of = {nd.meta.name: f"zone-{i % ZONES}" for i, nd in enumerate(nodes_a)}
    asched = new_sched(nodes_a)
    arecs, alaunches = drive_workload(
        "interpod/affinity", asched,
        [("init", init_a, "wavefront"), ("measured", measured_a, "wavefront")], bindings, torch)
    for rec in arecs:
        check_plain(f"affinity/{rec['label']}", rec, assign, auction, cfg, torch, timing)
    blue_zones = {zone_of[n] for n in arecs[0]["names"] if n is not None}
    if None in arecs[1]["names"] or any(zone_of[n] not in blue_zones for n in arecs[1]["names"]):
        raise AssertionError("interpod/affinity: a measured pod outside the zones of the "
                             "color=blue pods")
    gsched = new_sched(nodes_a, mode="greedy", use_wavefront=False)
    for pod, node in zip(init_a, arecs[0]["names"]):
        if node is not None:
            gsched.assume(pod, node)
    agrecs, aglaunches = drive_workload("interpod/affinity/greedy", gsched,
                                        [("measured", measured_a, "greedy")], bindings, torch)
    check_plain("affinity/greedy", agrecs[0], assign, auction, cfg, torch, timing)
    if any(n is None or zone_of[n] not in blue_zones for n in agrecs[0]["names"]):
        raise AssertionError("interpod/affinity/greedy: a measured pod outside the blue zones")
    out["affinity"] = {"workload": "SchedulingPodAffinity/5000Nodes",
                       "batches": [batch_summary(r) for r in arecs],
                       "zones": sorted(blue_zones), "launches": alaunches,
                       "greedy": dict(batch_summary(agrecs[0]), launches=aglaunches)}

    # the inter-pod path's kernels at the anti-affinity measured batch's
    # shapes, timed (the scan's, the wavefront's at the affinity batch's)
    snap, meta = meas["snap"], meas["meta"]
    rows = run_auction(snap, cfg, meta.tie_k, auction, bindings, torch, timed=True)
    g0 = grecs[0]
    rows += [r for r in run_kernels(g0["snap"], g0["meta"].features, g0["meta"].n_groups, cfg,
                                    assign, filters, bindings, torch, timed=True)
             if r["name"] == "greedy_scan"]
    a0 = arecs[1]
    rows.append(run_wavefront(a0["snap"], a0["meta"].features, a0["meta"].n_groups, cfg,
                              a0["meta"].wave_plan.members, assign, bindings, torch, timed=True))
    launch_of = {"greedy_scan": glaunches, "wavefront": alaunches}
    for r in rows:
        r["launches"] = stage_launches(r["name"], launch_of.get(r["name"], launches))
    # kernel family_prep (the terms entry) against its plain twin on the
    # card and on the CPU, exact, timed at the anti-affinity measured
    # batch (A); the other batches of the phase checked (the affinity
    # batches' F, the scans')
    fam = check_family("A", snap, meta.features, meta.topo_split, filters, bindings, torch,
                       timed=True)["terms"]
    fam.update(shape="A", launches=launches["family_prep"],
               terms=int(snap.terms.valid.shape[0]), z=int(meta.topo_split[1]))
    for tag, rec in (("anti/init", recs[0]), ("anti/greedy", grecs[0]),
                     ("F/init", arecs[0]), ("F", arecs[1]), ("affinity/greedy", agrecs[0])):
        check_family(tag, rec["snap"], rec["meta"].features, rec["meta"].topo_split, filters,
                     bindings, torch)
    out["family_prep"] = fam
    # the anti-affinity repair's dense tables: the plain loop's twin, on no
    # card path since the launch writes them itself; timed at A
    # on the card (what an auction batch's host no longer enqueues)
    order = assign.solve_order(snap.pods)
    dense = auction.repair_tables(snap.terms, order)
    dense_ms = cuda_ms(lambda: auction.repair_tables(snap.terms, order), 20, torch)
    db = bound(nbytes(snap.terms.matches_incoming, snap.terms.anti_idx, snap.terms.valid, order,
                      *dense), 4.0 * dense[0].numel())
    out["repair_tables"] = {"ms": dense_ms, "bound_ms": db[0], "bound_by": db[1],
                            "route": "plain torch", "shape": "A"}
    out["edges"] = interpod_edges(wrappers, assign, auction, filters, bindings, torch)
    out["kernels"] = rows
    out["cpu_check_s"] = timing
    out["card"] = card
    emit(out)
    return rows, launches, fam


def interpod_edges(wrappers, assign, auction, filters, bindings, torch) -> dict:
    """The inter-pod repair's edges on the card: cases.many_anti_terms_objects
    (40 distinct anti-affinity terms, so two term words and padding terms
    that are not valid, on the hostname and zone slots), with the batch's
    own term value capacity and with 5 (hostname values past it clipped
    onto its last bin); run_auction's stage-by-stage checks (the stage
    alone over the cluster round by round) and the whole loop against the
    plain loop on the card and on the CPU, exact; family_prep's terms entry
    at both capacities."""
    from kubernetes_tpu_torch.ops import device as dv, schema
    from kubernetes_tpu_torch.testing.cases import many_anti_terms_objects

    nodes, pods, bound = many_anti_terms_objects(wrappers)
    snap, _ = schema.SnapshotBuilder().build(nodes, pods, bound_pods=bound)
    features = assign.features_of(snap)
    z_spread, z_terms = assign.required_topo_z_split(snap)
    valid = snap.terms.valid
    slots = sorted(set(snap.terms.slot[valid].tolist()))
    if not (features.interpod and int(valid.sum()) > 32 and len(slots) == 2
            and not valid.all() and z_terms > 5):
        raise AssertionError("interpod/edges: the batch misses an edge")
    card, cpu = dv.to_device(snap, "cuda"), dv.to_device(snap, "cpu")
    cases_run = []
    for z in (z_terms, 5):
        rounds = run_auction(card, assign.DEFAULT_SCORE_CONFIG, None, auction, bindings, torch,
                             cpu_snap=cpu, topo_z=(z_spread, z))
        check_family(f"edges z={z}", card, features, (z_spread, z), filters, bindings, torch)
        cases_run.append({"z_terms": z, "rounds": rounds})
    return {"workload": "cases.many_anti_terms_objects", "terms": int(valid.shape[0]),
            "valid_terms": int(valid.sum()), "words": (int(valid.shape[0]) + 31) // 32,
            "slots": slots, "cases": cases_run, "equal_plain": True}


def extras_phase(wrappers, TorchBatchScheduler, assign, auction, filters, bindings, torch,
                 card):
    """The preferred-affinity variant (upstream's SchedulingPreferredPodAffinity
    shape) at 5,000 nodes / 1,000 / 1,000 and a synthetic image batch at
    5,000 nodes through TorchBatchScheduler on their default route (the
    auction, with class_extras) and on the scan, every batch against the
    plain path on the CPU; class_extras timed at the preferred measured
    batch's auction pairs (P) and the image batch's (I), prep_pref_pod at
    P.  Returns (the class_extras rows, prep_pref_pod's timing row)."""
    from kubernetes_tpu_torch.testing.cases import image_objects, preferred_affinity_objects

    timing = {}
    out = {"phase": "extras"}

    def new_sched(nodes, **kw):
        s = TorchBatchScheduler(**kw)
        for node in nodes:
            s.add_node(node)
        return s

    nodes, init, measured = preferred_affinity_objects(wrappers, *PREFERRED)
    sched = new_sched(nodes)
    cfg = sched.score_config
    recs, launches = drive_workload(
        "extras/preferred", sched, [("init", init, "auction"), ("measured", measured, "auction")],
        bindings, torch)
    for rec in recs:
        check_plain(f"preferred/{rec['label']}", rec, assign, auction, cfg, torch, timing)
    gsched = new_sched(nodes, mode="greedy", use_wavefront=False)
    for pod, node in zip(init, recs[0]["names"]):
        if node is not None:
            gsched.assume(pod, node)
    grecs, glaunches = drive_workload("extras/preferred/greedy", gsched,
                                      [("measured", measured, "greedy")], bindings, torch)
    check_plain("preferred/greedy", grecs[0], assign, auction, cfg, torch, timing)
    out["preferred"] = {
        "workload": "SchedulingPreferredPodAffinity shape, 5000 nodes / 1000 / 1000",
        "batches": [batch_summary(r) for r in recs], "launches": launches,
        "greedy": dict(batch_summary(grecs[0]), launches=glaunches)}

    inodes, ipods, _b = image_objects(wrappers, 0, *IMAGES)
    isched = new_sched(inodes)
    irecs, ilaunches = drive_workload("extras/images", isched, [("batch", ipods, "auction")],
                                      bindings, torch)
    check_plain("images/auction", irecs[0], assign, auction, cfg, torch, timing)
    igsched = new_sched(inodes, mode="greedy", use_wavefront=False)
    igrecs, iglaunches = drive_workload("extras/images/greedy", igsched,
                                        [("batch", ipods, "greedy")], bindings, torch)
    check_plain("images/greedy", igrecs[0], assign, auction, cfg, torch, timing)
    out["images"] = {"workload": "synthetic ImageLocality batch, 5000 nodes / 1000 pods",
                     "batches": [batch_summary(irecs[0]), batch_summary(igrecs[0])],
                     "launches": [ilaunches, iglaunches]}

    # class_extras (the auction's pairs) and prep_pref_pod at the preferred
    # measured batch's shapes, timed
    snap, meta = recs[1]["snap"], recs[1]["meta"]
    _cl, _pods, st = auction.auction_prep(snap, meta.features, meta.topo_split, cfg)
    # the auction's cold statics prep (P) against the plain prep
    check_statics("class_statics (P)", snap, st.s_reps, assign, bindings, torch)
    ext = run_class_extras(snap, meta.features, cfg, *auction_pairs(snap, meta, cfg, auction),
                           assign, bindings, torch, timed=True)
    rows = [dict(ext["row"], shape="P", launches=launches["class_extras"])]
    # and at the image batch's auction pairs (I), with the image batch's
    # launches (its auction and its scan)
    isnap, imeta = irecs[0]["snap"], irecs[0]["meta"]
    ext = run_class_extras(isnap, imeta.features, cfg, *auction_pairs(isnap, imeta, cfg, auction),
                           assign, bindings, torch, timed=True)
    rows.append(dict(ext["row"], shape="I",
                     launches=ilaunches["class_extras"] + iglaunches["class_extras"]))
    # kernel family_prep (the pref entry) against its plain twin on the
    # card and on the CPU, exact, timed at the preferred measured batch (P);
    # its init batch and its scan batch checked too
    fam = check_family("P", snap, meta.features, meta.topo_split, filters, bindings, torch,
                       timed=True)["pref"]
    fam.update(shape="P", launches=launches["family_prep"],
               rows=int(snap.prefpod.valid.shape[0]), z=int(meta.topo_split[1]))
    for tag, rec in (("P/init", recs[0]), ("preferred/greedy", grecs[0])):
        check_family(tag, rec["snap"], rec["meta"].features, rec["meta"].topo_split, filters,
                     bindings, torch)
    out["family_prep"] = fam
    out["class_extras"] = rows
    out["cpu_check_s"] = timing
    out["card"] = card
    emit(out)
    return rows, fam


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


def cpu_args(x, torch):
    """x (a tensor, or tuples and NamedTuples of them, nested) with every
    tensor copied to the CPU: the input of a plain version that adds in
    pod index order (ops/assign.py add_rows), which runs there only."""
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, tuple):
        vals = [cpu_args(v, torch) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return x


def time_plain(fn, torch) -> float:
    """Milliseconds of one host-timed run of a plain version (on the card
    or on the CPU, as its inputs lie)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def run_wavefront(snap, features, n_groups, cfg, members, assign, bindings, torch,
                  timed: bool = False):
    """Kernel wavefront against its plain version (and the plain scan) on
    CPU copies of the same inputs, exact.  Returns the fallbacks taken, or
    with timed=True the kernel's summary row."""
    kern, plain, prep = wavefront_case(snap, features, n_groups, cfg, members, assign,
                                       bindings, torch)
    cluster, pods, sfeas, aff, taint, sp_args, tm_args, extra = prep
    out = kern()
    want = plain()
    err = check_equal("wavefront", out, want, torch)
    if not timed:
        c_cl, c_pods, c_sf, c_aff, c_taint = cpu_args((cluster, pods, sfeas, aff, taint), torch)
        scan = assign.greedy_assign_plain(c_cl, c_pods, c_sf, c_aff, c_taint,
                                          assign.solve_order(c_pods), features, n_groups, cfg,
                                          *cpu_args((sp_args, tm_args, extra), torch))
        check_equal("wavefront (against the scan)", out[:7] + out[9:], scan, torch)
        return int(out[8])
    ms = cuda_ms(kern, 10, torch)
    plain_ms = time_plain(plain, torch)
    bms, by = bound(*greedy_scan_need(cluster, pods, sfeas, out[2], features, torch, sp_args,
                                      tm_args, extra, out[0]))
    return {"name": "wavefront", "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by}


def wavefront_case(snap, features, n_groups, cfg, members, assign, bindings, torch):
    """(kern, plain, prep) of the wavefront on a snapshot on the card: the
    kernel on the solver prep's inputs with the planner's waves
    `members`, its plain version on CPU copies of the same inputs, and the
    prep (_solver_prep's tuple)."""
    prep = assign._solver_prep(snap, features, cfg=cfg)
    cluster, pods, sfeas, aff, taint, sp_args, tm_args, extra = prep
    m = torch.as_tensor(members, dtype=torch.int32, device=cluster.allocatable.device)
    cpu_in = cpu_args((cluster, pods, sfeas, aff, taint, m, features), torch)
    cpu_fam = cpu_args((sp_args, tm_args, extra), torch)

    def kern():
        return bindings.wavefront(cluster, pods, sfeas, aff, taint, m, features, n_groups, cfg,
                                  sp_args, tm_args, extra)

    def plain():
        return assign.wavefront_assign_plain(*cpu_in, n_groups, cfg, *cpu_fam)

    return kern, plain, prep


def scan_case(snap, features, n_groups, cfg, assign, bindings, torch):
    """(kern, plain, prep) of greedy_scan on a snapshot on the card: the
    kernel on the solver prep's inputs, its plain version on CPU copies of
    the same inputs (the gang release adds in pod index order there), and
    the prep (_solver_prep's tuple)."""
    prep = assign._solver_prep(snap, features, cfg=cfg)
    cluster, pods, sfeas, aff, taint, sp_args, tm_args, extra = prep
    order = assign.solve_order(pods)
    cpu_in = cpu_args((cluster, pods, sfeas, aff, taint, order, features), torch)
    cpu_fam = cpu_args((sp_args, tm_args, extra), torch)

    def kern():
        return bindings.greedy_scan(cluster, pods, sfeas, aff, taint, order, features,
                                    n_groups, cfg, sp_args, tm_args, extra)

    def plain():
        return assign.greedy_assign_plain(*cpu_in, n_groups, cfg, *cpu_fam)

    return kern, plain, prep


def run_auction(snap, cfg, tie_k, auction, bindings, torch, timed: bool = False,
                cpu_snap=None, topo_z=None):
    """The auction program against its plain versions, exact: each stage
    launched alone (bindings.AuctionRun's stage methods: the bids, the
    acceptance, the spread and inter-pod repairs, the commit) round by
    round along the plain trajectory — the bids' and the repairs' plain
    versions on the card, the commit's on CPU copies (it adds in pod index
    order) —, then the whole loop in one launch (kernel auction_loop)
    against the plain loop on CPU copies (given cpu_snap, the same
    snapshot on the CPU, also against the plain loop prepared there).
    topo_z: the value capacities (z_spread, z_terms), None for the
    snapshot's own.  Returns the rounds, or with timed=True the summary
    rows: auction_loop
    (loop_row: the launch alone, its bound each round's stage bounds on
    that round's data along the trajectory, summed) and one round of each
    stage at round 0."""
    n = snap.cluster.allocatable.shape[0]
    tie_k = min(auction.default_tie_k(snap) if tie_k is None else tie_k, n)
    cluster, pods, st = auction.auction_prep(snap, None, topo_z, cfg)
    use_spread, use_terms = st.features.spread, st.features.interpod
    split = use_spread or use_terms
    if st.extra is not None:
        # the auction's (constraint-class representative, spec-class
        # static row) pairs, against the plain version on the CPU
        from kubernetes_tpu_torch.ops import assign

        pairs = (st.k_reps[st.jcons.long()], st.sfeas_s[st.jspec.long()])
        check_equal("class_extras (auction pairs)", (st.extra,), (assign.extras_prep(
            cpu_copy(snap), st.features, cfg, *cpu_args(pairs, torch)),), torch)
    p = pods.req.shape[0]
    dev = cluster.allocatable.device
    assigned = torch.full((p,), -1, dtype=torch.int32, device=dev)
    bid_scores = torch.full((p,), float("-inf"), device=dev)
    req, nz = cluster.requested, cluster.nonzero_requested
    counts = st.sp.state.counts_node.clone() if use_spread else None
    bits = auction.term_bits_copy(st.tm, st.features)
    max_rounds = 64
    run = bindings.AuctionRun(cluster, pods, st, tie_k, cfg, max_rounds)
    rnd, errs = 0, [0.0, 0.0, 0.0, 0.0]   # bids, accept, spread, interpod; then reasons
    bounds = []   # each round's stage bounds, (ms, bound_by)
    while rnd < max_rounds and bool(((assigned < 0) & pods.valid).any()):
        run.load(rnd, req, nz, assigned, bid_scores, counts, bits)
        run.bids()
        bid, val = auction.auction_bids_plain(cluster, pods, st, req, nz, assigned, rnd, tie_k,
                                              cfg, counts, bits)
        errs[0] = max(errs[0], check_equal(
            "auction_bids", (run.bufs["bid"], run.bufs["val"]), (bid, val), torch))
        accept = auction.auction_decide_plain(cluster.allocatable, pods, st.order, bid, req)
        progress = bool(accept.any())
        if timed:
            bounds.append([bound(*auction_bids_need(cluster, pods, st, req, tie_k, torch,
                                                    assigned)),
                           bound(*auction_accept_need(cluster, pods, bid, torch))])
            if use_spread:
                bounds[-1].append(bound(*auction_spread_need(st, accept, bid, counts, torch)))
        if split:
            run.accept(1)
            errs[1] = max(errs[1], check_equal(
                "auction_accept (acceptance)", (run.bufs["accept"].bool(),), (accept,), torch))
            if int(run.state[2]) != int(progress):
                raise AssertionError("auction_accept: progress differs from its plain version")
        if use_spread:
            run.spread()
            accept, counts = auction.spread_repair_plain(accept, bid, counts, st,
                                                         cluster.topo_ids)
            errs[2] = max(errs[2], check_equal(
                "auction_spread", (run.bufs["accept"].bool(), run.counts), (accept, counts),
                torch))
        if use_terms:
            if timed:
                bounds[-1].append(bound(*auction_interpod_need(st, accept, bid, bits, cluster,
                                                               torch)))
            run.interpod()
            accept, bits = auction.interpod_repair_plain(accept, bid, st, cluster.topo_ids, bits)
            errs[3] = max(errs[3], check_equal(
                "auction_interpod", (run.bufs["accept"].bool(), *run.bits), (accept, *bits),
                torch))
        run.accept(2 if split else 3)
        want = auction.auction_commit_plain(*cpu_args(
            (pods, accept, bid, val, req, nz, assigned, bid_scores), torch))
        errs[1] = max(errs[1], check_equal(
            "auction_accept", (run.assigned, run.bid_scores, run.requested, run.nonzero), want,
            torch))
        if int(run.state[2]) != int(progress) or int(run.state[0]) != rnd + 1:
            raise AssertionError("auction_accept: round state differs from its plain version")
        assigned, bid_scores, req, nz = (t.to(dev) for t in want)
        rnd += 1
        if not progress:
            break
    t0 = time.perf_counter()
    c_args = cpu_args((cluster, pods, st), torch)
    want = auction._rounds_plain(*c_args, tie_k, cfg, max_rounds)
    plain_ms = (time.perf_counter() - t0) * 1e3
    got, loop_reasons, _ = bindings.auction_solve(cluster, pods, st, tie_k, cfg, max_rounds)
    check_equal("auction_loop", got, want, torch)
    if cpu_snap is not None:
        on_cpu = auction._rounds_plain(*auction.auction_prep(cpu_snap, None, topo_z, cfg), tie_k,
                                       cfg, max_rounds)
        check_equal("auction_loop (card against CPU)", got, on_cpu, torch)
    # the reasons stage: in the loop's launch, and alone on the final state,
    # against its plain twin on the plain loop's final state on the CPU
    final = (got[0], got[2], got[3], got[5], tuple(got[6:]) if use_terms else None)
    want_reasons = auction.failure_reasons_plain(
        *c_args, want[0], want[2], want[3], want[5], tuple(want[6:]) if use_terms else None)
    errs.append(check_equal("auction_reasons (in the loop)", (loop_reasons,), (want_reasons,),
                            torch))
    errs[4] = max(errs[4], check_equal(
        "auction_reasons (alone)", (bindings.auction_reasons(cluster, pods, st, *final),),
        (want_reasons,), torch))
    rounds = int(got[4])
    if not timed:
        return rounds
    rows = time_auction_round(auction_round_inputs(snap, cfg, tie_k, auction, bindings, torch),
                              auction, bindings, torch)
    rows.append(reasons_row(cluster, pods, st, final, want_reasons, auction, bindings, torch))
    err_of = {"auction_bids": errs[0], "auction_accept": errs[1], "auction_spread": errs[2],
              "auction_interpod": errs[3], "auction_reasons": errs[4]}
    for row in rows:
        row["max_abs_err"] = err_of[row["name"]]
        row["stage_of"] = "auction_loop"
    if len(bounds) != rounds:
        raise AssertionError(f"auction: the plain trajectory ran {len(bounds)} rounds, the "
                             f"program {rounds}")
    rows.insert(0, loop_row(bindings.AuctionRun(cluster, pods, st, tie_k, cfg, max_rounds),
                            want, bounds, plain_ms, torch))
    return rows


def reasons_stage_call(b, cluster, pods, st, final) -> tuple:
    """(launch, reset, result) of a tree's reasons stage alone (its
    bindings `b`: AuctionRun.reasons_stage, auction_loop's kernel) on a
    final state (assigned, requested, nonzero, spread counts, term bits):
    its AuctionRun made and loaded once (the stage rewrites only its
    outputs, so no reset)."""
    from kubernetes_tpu_torch.ops.scores import DEFAULT_SCORE_CONFIG

    assigned, requested, nonzero = final[0], final[1], final[2]
    run = b.AuctionRun(cluster, pods, st, 1, DEFAULT_SCORE_CONFIG, 0)
    run.load(0, requested, nonzero, assigned, run.bid_scores, final[3], final[4], go=False)
    return run.reasons_stage, lambda: None, lambda: (run.reasons,)


def reasons_row(cluster, pods, st, final, want, auction, bindings, torch) -> dict:
    """The reasons stage's summary row: the stage alone on the loop's final
    state (launch_ms over reasons_stage_call), equal to the plain twin's
    `want` after the timing; the plain twin on the card (CUDA events over
    20 calls, as cuda_ms); the bound of its work on this data."""
    requested, nonzero, assigned = final[1], final[2], final[0]
    launch, reset, result = reasons_stage_call(bindings, cluster, pods, st, final)
    ms, host_ms = launch_ms(launch, reset, 10, torch)
    check_equal("auction_reasons (timed)", result(), (want,), torch)
    plain_ms = cuda_ms(lambda: auction.failure_reasons_plain(
        cluster, pods, st, assigned, requested, nonzero, final[3], final[4]), 20, torch)
    b = bound(*reasons_need(cluster, pods, st, assigned, requested, nonzero, final[3],
                            final[4], torch=torch))
    return {"name": "auction_reasons", "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
            "bound_ms": b[0], "bound_by": b[1], "library_ms": None,
            "classes": [int(st.jspec.shape[0]), int(st.s_reps.shape[0]),
                        int(st.k_reps.shape[0])]}


def final_state(snap, meta, cfg, auction, bindings, torch, convert=None) -> tuple:
    """(cluster, pods, st, final, want) of an auction batch on the card:
    the loop's launch without gangs (the rounds and the reasons; `bindings`
    may be another tree's, `convert` mapping st to its statics), its final
    state (assigned, requested, nonzero, spread counts, term bits) and the
    plain twin's reasons on CPU copies of it; the loop's own reasons equal
    them."""
    cluster, pods, st = auction.auction_prep(snap, meta.features, meta.topo_split, cfg)
    out, reasons, _ = bindings.auction_solve(cluster, pods, convert(st) if convert else st,
                                             meta.tie_k, cfg, 64)
    final = (out[0], out[2], out[3], out[5], tuple(out[6:]) if st.features.interpod else None)
    want = auction.failure_reasons_plain(*cpu_args((cluster, pods, st) + final, torch))
    check_equal("auction_reasons (in the loop)", (reasons,), (want,), torch)
    return cluster, pods, st, final, want


def stage_reasons_row(snap, meta, cfg, shape, auction, bindings, torch) -> dict:
    """The reasons stage alone at a gang batch's shape (G, S200): its final
    state by final_state, then reasons_row."""
    cluster, pods, st, final, want = final_state(snap, meta, cfg, auction, bindings, torch)
    row = reasons_row(cluster, pods, st, final, want, auction, bindings, torch)
    return dict(row, shape=shape, max_abs_err=0.0, stage_of="auction_loop")


# cycles the card spins (torch.cuda._sleep) before a timed launch's start
# event, so the host's enqueue of the launch ends before the card reaches
# the event: about 2 ms on an H100
SPIN_CYCLES = 4_000_000


def launch_ms(launch, reset, iters: int, torch) -> tuple:
    """(CUDA-event ms, host-clock ms) a call of launch(), the mean over
    `iters` calls after one warm-up, reset() before each: the events around
    the launch alone, recorded behind a spin of the card (no host time
    between them), the host clock around the call (what enqueueing it
    costs the caller)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    card, host = 0.0, 0.0
    for k in range(iters + 1):
        reset()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        t0 = time.perf_counter()
        launch()
        t1 = time.perf_counter()
        stop.record()
        stop.synchronize()
        if k:
            card += start.elapsed_time(stop)
            host += (t1 - t0) * 1e3
    return card / iters, host / iters


def loop_row(run, want, bounds, plain_ms, torch, iters: int = 10) -> dict:
    """The whole loop's summary row: the card's time of run.loop() alone
    (launch_ms: its launch arrays and buffers made beforehand, the carries
    reset before each call) and the host clock of the call, equal to the
    plain loop's `want` after the timing; the plain loop's host time on CPU
    copies; and the bound, each round's stage bounds on that round's data
    (`bounds`, from the plain trajectory) summed over the rounds run,
    bound_by the kind with the larger sum."""
    start = [t.clone() for t in (run.requested, run.nonzero, run.assigned, run.bid_scores)]
    counts = run.counts.clone() if run.counts is not None else None
    bits = [t.clone() for t in run.bits] if run.bits else None
    go = bool(run.state[1])
    ms, host_ms = launch_ms(run.loop, lambda: run.load(0, *start, counts, bits, go=go),
                            iters, torch)
    check_equal("auction_loop (timed)", run.result(), want, torch)
    by_kind = {}
    for rnd in bounds:
        for b_ms, by in rnd:
            by_kind[by] = by_kind.get(by, 0.0) + b_ms
    return {"name": "auction_loop", "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
            "bound_ms": sum(by_kind.values()), "bound_by": max(by_kind, key=by_kind.get),
            "rounds": len(bounds), "max_abs_err": 0.0, "library_ms": None}


def auction_round_inputs(snap, cfg, tie_k, auction, bindings, torch) -> dict:
    """Round 0 of the auction on a snapshot on the card, along the plain
    trajectory (the values run_auction reaches at its first round): the
    round's bids and accepted set, the counts and bits it starts from, and
    with the inter-pod family the set the spread repair kept (the
    inter-pod repair's input).  The inputs round_kernels launches on."""
    n = snap.cluster.allocatable.shape[0]
    tie_k = min(auction.default_tie_k(snap) if tie_k is None else tie_k, n)
    cluster, pods, st = auction.auction_prep(snap, cfg=cfg)
    use_spread, use_terms = st.features.spread, st.features.interpod
    p = pods.req.shape[0]
    dev = cluster.allocatable.device
    assigned = torch.full((p,), -1, dtype=torch.int32, device=dev)
    bid_scores = torch.full((p,), float("-inf"), device=dev)
    req, nz = cluster.requested, cluster.nonzero_requested
    counts = st.sp.state.counts_node.clone() if use_spread else None
    bits = auction.term_bits_copy(st.tm, st.features)
    bid, val = auction.auction_bids_plain(cluster, pods, st, req, nz, assigned, 0, tie_k, cfg,
                                          counts, bits)
    accepted = auction.auction_decide_plain(cluster.allocatable, pods, st.order, bid, req)
    kept = accepted
    if use_spread and use_terms:
        kept = auction.spread_repair_plain(accepted, bid, counts, st, cluster.topo_ids)[0]
    return {"cluster": cluster, "pods": pods, "st": st, "req": req, "nz": nz,
            "assigned": assigned, "bid_scores": bid_scores, "bid": bid, "val": val,
            "accepted": accepted, "tie_k": tie_k, "cfg": cfg, "max_rounds": 64,
            "counts": counts, "bits_before": bits if use_terms else None,
            "accept_before": kept if use_terms else None}


def round_kernels(inp: dict, bindings) -> dict:
    """One round of each stage of the auction program on
    auction_round_inputs' values, launched alone on one AuctionRun, as a
    closure by name (the state, and the carries the stage updates, are
    reset before every launch, so each call runs the round): auction_bids;
    auction_accept's stages together; with spread, auction_spread on the
    round's accepted set and counts; with inter-pod, auction_interpod on
    the set the spread repair kept and the round's bits."""
    cluster, pods, st = inp["cluster"], inp["pods"], inp["st"]
    req, nz, assigned, bid_scores = inp["req"], inp["nz"], inp["assigned"], inp["bid_scores"]
    counts, bits_before = inp["counts"], inp["bits_before"]
    run = bindings.AuctionRun(cluster, pods, st, inp["tie_k"], inp["cfg"], inp["max_rounds"])
    run.load(0, req, nz, assigned, bid_scores, inp["counts"], bits_before)
    go = run.state.clone()
    split = counts is not None or bits_before is not None

    def k_bids():
        run.state.copy_(go)
        run.bids()
        return run.bufs["bid"], run.bufs["val"]

    def k_accept():
        run.state.copy_(go)
        run.requested.copy_(req)
        run.nonzero.copy_(nz)
        run.assigned.copy_(assigned)
        run.bid_scores.copy_(bid_scores)
        for stage in ((1, 2) if split else (3,)):
            run.accept(stage)

    out = {"auction_bids": k_bids, "auction_accept": k_accept}
    # the round's bids, as auction_bids leaves them
    run.bufs["bid"].copy_(inp["bid"])
    run.bufs["val"].copy_(inp["val"])
    if counts is not None:

        def k_spread():
            run.state.copy_(go)
            run.bufs["accept"].copy_(inp["accepted"])
            run.counts.copy_(counts)
            run.spread()
            return run.bufs["accept"].bool(), run.counts

        out["auction_spread"] = k_spread
    if bits_before is not None:

        def reset_interpod():
            run.state.copy_(go)
            run.bufs["accept"].copy_(inp["accept_before"])
            for t, t0 in zip(run.bits, bits_before):
                t.copy_(t0)

        out["auction_interpod"] = lambda: (reset_interpod(), run.interpod())
        # the launch and its reset apart, for the card's time alone
        out["auction_interpod_parts"] = (run.interpod, reset_interpod)
    return out


def time_auction_round(inp: dict, auction, bindings, torch) -> list:
    """CUDA-event times of one round of each stage of the auction program
    (round_kernels on auction_round_inputs' values) and host times of
    their plain versions (auction_accept's on CPU copies: its commit adds
    in pod index order), with their bounds."""
    cluster, pods, st = inp["cluster"], inp["pods"], inp["st"]
    req, nz, assigned, bid_scores = inp["req"], inp["nz"], inp["assigned"], inp["bid_scores"]
    bid, val, tie_k, cfg = inp["bid"], inp["val"], inp["tie_k"], inp["cfg"]
    bits_before = inp["bits_before"]
    kern = round_kernels(inp, bindings)
    bids_ms = cuda_ms(kern["auction_bids"], 20, torch)
    accept_ms = cuda_ms(kern["auction_accept"], 20, torch)
    bids_plain = time_plain(lambda: auction.auction_bids_plain(
        cluster, pods, st, req, nz, assigned, 0, tie_k, cfg, inp["counts"], bits_before), torch)
    c_alloc, c_pods, c_order, c_bid, c_val, c_req, c_nz, c_as, c_bs = cpu_args(
        (cluster.allocatable, pods, st.order, bid, val, req, nz, assigned, bid_scores), torch)
    accept_plain = time_plain(lambda: auction.auction_commit_plain(
        c_pods, auction.auction_decide_plain(c_alloc, c_pods, c_order, c_bid, c_req),
        c_bid, c_val, c_req, c_nz, c_as, c_bs), torch)
    b1 = bound(*auction_bids_need(cluster, pods, st, req, tie_k, torch))
    b2 = bound(*auction_accept_need(cluster, pods, bid, torch))
    rows = [
        {"name": "auction_bids", "ms": bids_ms, "plain_ms": bids_plain,
         "bound_ms": b1[0], "bound_by": b1[1]},
        {"name": "auction_accept", "ms": accept_ms, "plain_ms": accept_plain,
         "bound_ms": b2[0], "bound_by": b2[1]},
    ]
    if inp["counts"] is not None:
        accepted = inp["accepted"]
        spread_ms = cuda_ms(kern["auction_spread"], 20, torch)
        spread_plain = time_plain(lambda: auction.spread_repair_plain(
            accepted, bid, inp["counts"], st, cluster.topo_ids), torch)
        b3 = bound(*auction_spread_need(st, accepted, bid, inp["counts"], torch))
        rows.append({"name": "auction_spread", "ms": spread_ms, "plain_ms": spread_plain,
                     "bound_ms": b3[0], "bound_by": b3[1]})
    if bits_before is not None:
        accept_before = inp["accept_before"]
        # the stage alone: the card behind a spin (the reset of its carries
        # outside the events), the launch's host clock beside it
        interpod_ms, interpod_host = launch_ms(*kern["auction_interpod_parts"], 20, torch)
        interpod_plain = time_plain(lambda: auction.interpod_repair_plain(
            accept_before, bid, st, cluster.topo_ids, bits_before), torch)
        b4 = bound(*auction_interpod_need(st, accept_before, bid, bits_before, cluster, torch))
        rows.append({"name": "auction_interpod", "ms": interpod_ms, "host_ms": interpod_host,
                     "plain_ms": interpod_plain, "bound_ms": b4[0], "bound_by": b4[1]})
    return rows


def _meta_of(snap, assign, auction, schema):
    """The routing statics auction_assign takes for a snapshot built
    outside a scheduler (the features, topology split, gangs and tie_k
    the scheduler's _annotate derives)."""
    from types import SimpleNamespace

    return SimpleNamespace(features=assign.features_of(snap),
                           topo_split=assign.required_topo_z_split(snap),
                           n_groups=schema.num_groups(snap),
                           tie_k=auction.default_tie_k(snap))


def run_kernels(snap, features, n_groups, cfg, assign, filters, bindings, torch,
                timed: bool = False):
    """Run the kernels of the greedy route on a snapshot on the card —
    class_statics (the cold prep, with and without the selector mask),
    greedy_scan, and match_terms (the masks-only entry) on both tables —
    and hold each against its plain version on the same inputs.  With
    timed=True also time kernel and plain version and work out each
    kernel's bound (match_terms on the selector table)."""
    cluster, pods, sel, pref = snap[:4]
    rows = []
    err1, sel_mask, _ = check_match_terms("match_terms", cluster, sel, filters, bindings, torch,
                                          pref)
    reps = torch.clamp(pods.class_rep, 0, pods.req.shape[0] - 1)
    err2, statics = check_statics("class_statics", snap, reps, assign, bindings, torch)
    order = assign.solve_order(pods)
    sp_args = assign.spread_prep(snap, sel_mask, features)
    tm_args = assign.terms_prep(snap, features)
    extras = None
    if features.interpod_pref or features.images:
        extras = run_class_extras(snap, features, cfg, reps, statics[0], assign, bindings,
                                  torch, timed)
    extra = extras["out"] if extras else None

    def k3():
        return bindings.greedy_scan(cluster, pods, *statics, order, features, n_groups, cfg,
                                    sp_args, tm_args, extra)

    cpu_in = cpu_args((cluster, pods, *statics, order, features), torch)
    cpu_fam = cpu_args((sp_args, tm_args, extra), torch)

    def p3():  # on CPU copies: its gang release adds in pod index order
        return assign.greedy_assign_plain(*cpu_in, n_groups, cfg, *cpu_fam)

    out = k3()
    t0 = time.perf_counter()
    want = p3()
    plain3_ms = (time.perf_counter() - t0) * 1e3
    err3 = check_equal("greedy_scan", out, want, torch)
    if extras and timed:
        rows.append(extras["row"])
    if not timed:
        return rows
    rows.append(dict(masks_row(cluster, sel, err1, filters, bindings, torch), shape="B"))
    rows.append(dict(statics_row(snap, reps, err2, assign, filters, bindings, torch),
                     shape="B"))
    k3_ms = cuda_ms(k3, 3, torch)
    need3 = greedy_scan_need(cluster, pods, statics[0], out[2], features, torch, sp_args,
                             tm_args, extra, out[0])
    bms, by = bound(*need3)
    rows.append({"name": "greedy_scan", "max_abs_err": err3, "ms": k3_ms, "plain_ms": plain3_ms,
                 "bound_ms": bms, "bound_by": by})
    return rows


def table_rows(table) -> tuple:
    """(expr_ids, expr_op, expr_slot, term_valid) of a selector table
    [S, T, E, K], or of a preferred table [F, E, K] as T = 1."""
    if hasattr(table, "term_valid"):
        return table.expr_ids, table.expr_op, table.expr_slot, table.term_valid
    return (table.expr_ids[:, None], table.expr_op[:, None], table.expr_slot[:, None],
            table.valid[:, None])


def check_match_terms(tag, cluster, sel, filters, bindings, torch, pref=None) -> tuple:
    """Kernel match_terms (the masks-only entry) on the selector table, and
    on the preferred table when given, against match_rows_plain, exact.
    Returns (error, the plain selector mask, the plain preferred mask or
    None)."""
    nodes = (cluster.label_bits, cluster.topo_ids)
    tables = [sel] + ([pref] if pref is not None else [])
    got = tuple(bindings.match_terms(*nodes, *table_rows(t)) for t in tables)
    want = tuple(filters.match_rows_plain(cluster, *table_rows(t)) for t in tables)
    err = check_equal(tag, got, want, torch)
    return err, want[0], (want[1] if pref is not None else None)


def check_statics(tag, snap, reps, assign, bindings, torch, on_cpu=False) -> tuple:
    """Kernel class_statics (the cold statics prep in one launch) on a
    snapshot on the card, with and without the selector mask, against the
    plain prep on the same inputs — match_rows_plain's masks, then
    class_statics_plain — (on CPU copies with on_cpu), every field,
    exact.  Returns (error, the tables without the mask)."""
    from kubernetes_tpu_torch.ops import filters

    cluster, pods, sel, pref = snap[:4]
    got = bindings.class_statics(cluster, pods, sel, pref, reps, want_sel_mask=True)
    bare = bindings.class_statics(cluster, pods, sel, pref, reps)
    if bare[3] is not None:
        raise AssertionError(f"{tag}: a selector mask nobody asked for")
    c, p, s, f, r = cpu_args((cluster, pods, sel, pref, reps), torch) if on_cpu else (
        cluster, pods, sel, pref, reps)
    sm = filters.match_rows_plain(c, *table_rows(s))
    want = (*assign.class_statics_plain(c, p, sm, filters.match_rows_plain(c, *table_rows(f)),
                                        r), sm)
    err = check_equal(f"{tag} (with the selector mask)", got, want, torch)
    return max(err, check_equal(tag, bare[:3], want[:3], torch)), bare[:3]


def masks_row(cluster, table, err, filters, bindings, torch) -> dict:
    """match_terms' summary row on one table: the card's time of the call
    alone and the host clock of the call (launch_ms), the plain version's
    time (events over 10 calls), the bound on this data."""
    rows = table_rows(table)
    ms, host_ms = launch_ms(lambda: bindings.match_terms(cluster.label_bits, cluster.topo_ids,
                                                         *rows), lambda: None, 50, torch)
    b_ms, by = bound(*match_terms_need(cluster.label_bits.shape[0], *rows, torch))
    return {"name": "match_terms", "max_abs_err": err, "ms": ms, "host_ms": host_ms,
            "plain_ms": cuda_ms(lambda: filters.match_rows_plain(cluster, *rows), 10, torch),
            "bound_ms": b_ms, "bound_by": by, "library_ms": None}


def statics_row(snap, reps, err, assign, filters, bindings, torch) -> dict:
    """class_statics' summary row: the cold prep's one launch without the
    mask, the card's time alone and the host clock of the call
    (launch_ms), the plain prep's time (both masks and
    class_statics_plain, events over 10 calls), the bound on this data."""
    cluster, pods, sel, pref = snap[:4]
    ms, host_ms = launch_ms(lambda: bindings.class_statics(cluster, pods, sel, pref, reps),
                            lambda: None, 50, torch)

    def plain():
        return assign.class_statics_plain(
            cluster, pods, filters.match_rows_plain(cluster, *table_rows(sel)),
            filters.match_rows_plain(cluster, *table_rows(pref)), reps)

    b_ms, by = bound(*cold_statics_need(cluster, pods, sel, pref, reps, False, torch))
    return {"name": "class_statics", "max_abs_err": err, "ms": ms, "host_ms": host_ms,
            "plain_ms": cuda_ms(plain, 10, torch), "bound_ms": b_ms, "bound_by": by,
            "library_ms": None}


# ---- the inputs of the timed shapes (kernel_ab.py builds from these too) ----

# scan batches at the north star's width: 50,000 nodes (65,536 padded);
# under WAVEFRONT_MIN_PODS, so the scan is the reference's own route
WIDE = (NORTH[0], 1, 16)
# the cluster-edge clusters: 8,192 nodes, 8,192 padded (8 blocks of 1,024)
EDGE_NODES, EDGE_PODS = 8192, 16


def basic_snapshot(wrappers, TorchBatchScheduler):
    """Shape B: SchedulingBasic/5000Nodes' measured batch after the init
    pods were scheduled (the auction) and assumed — the state and pods of
    the main and greedy phases.  Returns (scheduler, snapshot, meta)."""
    sched = TorchBatchScheduler()
    for node in make_cluster(wrappers, MAIN[0]):
        sched.add_node(node)
    init = make_pods(wrappers, MAIN[1], "init")
    for pod, name in zip(init, sched.schedule_pending(init)):
        sched.assume(pod, name)
    return (sched, *sched.encode_pending(make_pods(wrappers, MAIN[2], "measured")))


def spread_snapshot(wrappers, TorchBatchScheduler):
    """Shape T: TopologySpreading/5000Nodes' measured batch after the 5,000
    init pods (the spread phase's default route).  Returns (scheduler,
    snapshot, meta)."""
    from kubernetes_tpu_torch.testing.cases import topology_spreading_objects

    nodes, init, measured = topology_spreading_objects(wrappers, *SPREAD)
    sched = TorchBatchScheduler()
    for node in nodes:
        sched.add_node(node)
    for pod, name in zip(init, sched.schedule_pending(init)):
        sched.assume(pod, name)
    return (sched, *sched.encode_pending(measured))


def measured_snapshot(wrappers, TorchBatchScheduler, objects: str, dims):
    """A cases.py workload's measured batch after its init pods were
    scheduled and the placed ones assumed: shape A (objects
    "pod_anti_affinity_objects", dims ANTI: the interpod phase's auction
    batch) and P ("preferred_affinity_objects", PREFERRED: the extras
    phase's).  Returns (scheduler, snapshot, meta)."""
    from kubernetes_tpu_torch.testing import cases

    nodes, init, measured = getattr(cases, objects)(wrappers, *dims)
    sched = TorchBatchScheduler()
    for node in nodes:
        sched.add_node(node)
    for pod, name in zip(init, sched.schedule_pending(init)):
        if name is not None:
            sched.assume(pod, name)
    return (sched, *sched.encode_pending(measured))


def image_snapshot(wrappers, TorchBatchScheduler):
    """Shape I: the extras phase's synthetic ImageLocality batch (IMAGES:
    5,000 nodes, 1,000 pods, the auction).  Returns (scheduler, snapshot,
    meta)."""
    from kubernetes_tpu_torch.testing.cases import image_objects

    nodes, pods, _b = image_objects(wrappers, 0, *IMAGES)
    sched = TorchBatchScheduler()
    for node in nodes:
        sched.add_node(node)
    return (sched, *sched.encode_pending(pods))


def north_snapshot(wrappers, TorchBatchScheduler):
    """Shape N: the north star's first batch (10,000 pod-default pods onto
    50,000 node-default nodes; 16,384 and 65,536 padded), as the north
    phase's scheduler encodes it.  Returns (scheduler, snapshot, meta)."""
    sched = TorchBatchScheduler()
    for node in make_cluster(wrappers, NORTH[0]):
        sched.add_node(node)
    return (sched, *sched.encode_pending(make_pods(wrappers, NORTH[2], "burst")))


def affinity_snapshot(wrappers, TorchBatchScheduler):
    """Shape W: SchedulingNodeAffinity/5000Nodes' first measured 500-pod
    batch after the init pods (the wavefront phase's).  Returns
    (scheduler, snapshot, meta)."""
    sched = TorchBatchScheduler()
    for node in make_cluster(wrappers, AFFINITY[0]):
        sched.add_node(node)
    init = affinity_pods(wrappers, AFFINITY[1], "aff-init")
    for lo in range(0, len(init), AFFINITY_BATCH):
        batch = init[lo : lo + AFFINITY_BATCH]
        for pod, name in zip(batch, sched.schedule_pending(batch)):
            sched.assume(pod, name)
    measured = affinity_pods(wrappers, AFFINITY[2], "aff-measured")
    return (sched, *sched.encode_pending(measured[:AFFINITY_BATCH]))


def spread_wave_snapshot(wrappers, TorchBatchScheduler):
    """Shape S: TopologySpreading/5000Nodes' first 500-pod batch of the
    measured pods after the 5,000 init pods (the spread phase's wavefront
    run: one-pod waves).  Returns (scheduler, snapshot, meta)."""
    from kubernetes_tpu_torch.testing.cases import topology_spreading_objects

    nodes, init, measured = topology_spreading_objects(wrappers, *SPREAD)
    sched = TorchBatchScheduler()
    for node in nodes:
        sched.add_node(node)
    for pod, name in zip(init, sched.schedule_pending(init)):
        sched.assume(pod, name)
    return (sched, *sched.encode_pending(measured[:SPREAD_BATCH]))


def pod_affinity_snapshot(wrappers, TorchBatchScheduler):
    """Shape F: SchedulingPodAffinity/5000Nodes' measured batch after the
    init pods (the interpod phase's wavefront run: one-pod waves).  Returns
    (scheduler, snapshot, meta)."""
    from kubernetes_tpu_torch.testing.cases import pod_affinity_objects

    nodes, init, measured = pod_affinity_objects(wrappers, *AFFINITY_POD)
    sched = TorchBatchScheduler()
    for node in nodes:
        sched.add_node(node)
    for pod, name in zip(init, sched.schedule_pending(init)):
        if name is not None:
            sched.assume(pod, name)
    return (sched, *sched.encode_pending(measured))


def single_snapshot(wrappers, TorchBatchScheduler, preferred: bool):
    """Shapes E and E+: one pod against SchedulingBasic/5000Nodes behind
    the extender (5,000 node-default nodes, 1,000 bound pod-default pods,
    the extender phase's layout; 8,192 padded nodes): a pod-default pod
    (E, no extra row), or (E+) the bound pods labelled color=red in
    sched-0 and the pod upstream's SchedulingPreferredPodAffinity template
    (a preferred term, weight 1, on the hostname over color=red in sched-0
    and sched-1: an extra row).
    Returns (the snapshot on the card, its features)."""
    from kubernetes_tpu_torch.ops import assign, device as dv
    from kubernetes_tpu_torch.testing.cases import preferred_affinity_objects

    n_nodes, n_bound, _n_req = EXTENDER
    sched = TorchBatchScheduler(device="cuda")
    for node in make_cluster(wrappers, n_nodes):
        sched.add_node(node)
    for i, pod in enumerate(make_pods(wrappers, n_bound, "ext-bound")):
        if preferred:   # in a namespace the template's term reads
            pod.meta.labels["color"] = "red"
            pod.meta.namespace = "sched-0"
        sched.state.add_pod(pod, f"node-{(i * 7) % n_nodes}")
    pod = (preferred_affinity_objects(wrappers, 1, 0, 1)[2][0] if preferred
           else make_pods(wrappers, 1, "ext-req")[0])
    snap, _meta = sched.builder.build_from_state(sched.state, [pod])
    return dv.to_device(snap, "cuda"), assign.features_of(snap)


def c5_snapshot(wrappers, TorchBatchScheduler):
    """Shape G: bench.py c5's first batch (10,000 pods in 100 gangs onto
    50,000 32-CPU nodes; 16,384 and 65,536 padded) as the gang phase's
    TorchBatchScheduler(mode="auto") encodes it.  Returns (scheduler,
    snapshot, meta)."""
    sched = TorchBatchScheduler(mode="auto")
    for node in c5_nodes(wrappers, C5[0]):
        sched.add_node(node)
    return (sched, *sched.encode_pending(c5_pods(wrappers, "shape-g")))


def c5_drops_snapshot(wrappers, TorchBatchScheduler):
    """Shape G of the gang stage: the c5 batch of the gang phase's drops
    step (one member of each of C5_DROP_GANGS unplaceable) onto 50,000
    nodes.  Returns (scheduler, snapshot, meta)."""
    sched = TorchBatchScheduler(mode="auto")
    for node in c5_nodes(wrappers, C5[0]):
        sched.add_node(node)
    return (sched, *sched.encode_pending(c5_pods(wrappers, "drops", C5_DROP_GANGS)))


def c5_scarce_snapshot(wrappers, TorchBatchScheduler):
    """Shape S200: the gang phase's scarcity step's full solve, the c5
    batch onto C5_SCARCE nodes (256 padded; no gang completes).  Returns
    (scheduler, snapshot, meta)."""
    sched = TorchBatchScheduler(mode="auto")
    for node in c5_nodes(wrappers, C5_SCARCE):
        sched.add_node(node)
    return (sched, *sched.encode_pending(c5_pods(wrappers, "scarce")))


def fractional_gang_snapshot(wrappers, torch):
    """Shape PG: the parity phase's fractional gang batch on the card (an
    incomplete gang on nodes past float32's exact range).  Returns
    (snapshot, meta)."""
    from kubernetes_tpu_torch.ops import assign, auction, device as dv, schema
    from kubernetes_tpu_torch.testing.cases import fractional_gang_objects

    nodes, pending, _b = fractional_gang_objects(wrappers, 1)
    snap, _meta = schema.SnapshotBuilder().build(nodes, pending)
    return dv.to_device(snap, "cuda"), _meta_of(snap, assign, auction, schema)


def wide_snapshot(wrappers, TorchBatchScheduler, n_pods: int):
    """Shape L (16 pods): an n_pods-pod SchedulingBasic batch onto 50,000
    node-default nodes, 65,536 padded.  Returns (scheduler, snapshot, meta)."""
    sched = TorchBatchScheduler()
    for node in make_cluster(wrappers, WIDE[0]):
        sched.add_node(node)
    return (sched, *sched.encode_pending(make_pods(wrappers, n_pods, f"wide{n_pods}")))


def edge_cluster(wrappers, cpu_of):
    """EDGE_NODES node-default nodes, node i with cpu_of(i) millicores."""
    gi = wrappers.GI
    return [
        wrappers.make_node(f"edge-{i}")
        .capacity(cpu_milli=cpu_of(i), mem=NODE_MEM_GI * gi, pods=NODE_PODS)
        .zone(f"zone-{i % ZONES}")
        .obj()
        for i in range(EDGE_NODES)
    ]


def scan_edges_phase(wrappers, TorchBatchScheduler, assign, auction, bindings, torch):
    """greedy_scan at its cluster's edges and auction_spread with its
    global counter table, each against its plain version, exact: scan
    batches of 1 and 16 pods at 50,000 nodes (the widest cluster); a
    cluster whose only feasible nodes are the last block's; a
    uniform cluster where every node ties (the first index wins across
    blocks) and one whose ties start at node 1,500, inside a chunk; a spread
    auction with hostname-keyed hard rows (a value space past the shared
    counter table)."""
    cfg = assign.DEFAULT_SCORE_CONFIG
    blocks = {f"{n} padded nodes": bindings.scan_shape(n) for n in (4096, 8192, 16384, 65536)}
    if min(b for b, _t in blocks.values()) < 2:
        raise AssertionError(f"greedy_scan: a single-block launch {blocks}")
    out = {"phase": "scan_edges", "greedy_scan_blocks_threads": blocks, "cases": []}

    def check_scan(what, snap, meta, first=None, timed=False):
        if meta.route != "greedy":
            raise AssertionError(f"scan_edges/{what}: route {meta.route}")
        kern, plain, prep = scan_case(snap, meta.features, meta.n_groups, cfg, assign, bindings,
                                      torch)
        got = kern()
        t0 = time.perf_counter()
        want = plain()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = check_equal(f"greedy_scan ({what})", got, want, torch)
        n = snap.cluster.allocatable.shape[0]
        picks = got[0].cpu()
        if first is not None and int(picks[0]) != first:
            raise AssertionError(f"scan_edges/{what}: first pick {int(picks[0])} != {first}")
        case = {"case": what, "padded_nodes": n, "padded_pods": int(picks.numel()),
                "blocks": bindings.scan_shape(n)[0], "placed": int((picks >= 0).sum()),
                "first_pick": int(picks[0])}
        if timed:   # shape L: the north star's width on the scan
            cluster, pods, sfeas = prep[:3]
            bms, by = bound(*greedy_scan_need(cluster, pods, sfeas, got[2], meta.features, torch))
            case.update(max_abs_err=err, ms=cuda_ms(kern, 20, torch), plain_ms=plain_ms,
                        bound_ms=bms, bound_by=by)
        out["cases"].append(case)

    for n_pods in WIDE[1:]:
        _s, snap, meta = wide_snapshot(wrappers, TorchBatchScheduler, n_pods)
        check_scan(f"{n_pods} pods at {WIDE[0]} nodes", snap, meta, timed=n_pods == WIDE[2])
    pods = make_pods(wrappers, EDGE_PODS, "edge")
    last = bindings.scan_shape(EDGE_NODES)[0] - 1
    owned = [bindings.scan_node_block(EDGE_NODES, i) == last for i in range(EDGE_NODES)]
    for what, cpu_of, first in (
        ("feasible only in the last block", lambda i: NODE_CPU_MILLI if owned[i] else 50,
         owned.index(True)),
        ("every node ties", lambda i: NODE_CPU_MILLI, 0),
        ("ties from node 1,500 (mid-chunk)", lambda i: NODE_CPU_MILLI if i >= 1500 else 2000,
         1500),
    ):
        sched = TorchBatchScheduler()
        for node in edge_cluster(wrappers, cpu_of):
            sched.add_node(node)
        check_scan(what, *sched.encode_pending(pods), first=first)

    # hostname-keyed hard rows: each node its own domain, so the value space
    # is the node axis and the rank walk counts in the global [C, Z] table
    api = wrappers.api
    host_pods = []
    for i in range(1500):
        w = wrappers.make_pod(f"host-{i}").req(cpu_milli=POD_CPU_MILLI,
                                               mem=POD_MEM_MI * wrappers.MI)
        if i % 5:
            w = w.label("color", "blue")
        w = w.spread(1, api.LABEL_HOSTNAME, "DoNotSchedule", {"color": "blue"})
        if i % 3 == 0:
            w = w.spread(3, api.LABEL_ZONE, "DoNotSchedule", {"color": "blue"})
        host_pods.append(w.obj())
    sched = TorchBatchScheduler()
    for node in make_cluster(wrappers, 2000, "host"):
        sched.add_node(node)
    snap, meta = sched.encode_pending(host_pods)
    z = auction.auction_prep(snap, cfg=cfg)[2].sp.z
    if meta.route != "auction" or not meta.features.spread or z <= bindings.SPREAD_SHARED_Z:
        raise AssertionError(f"scan_edges/hostname spread: route {meta.route}, value space {z}")
    rounds = run_auction(snap, cfg, meta.tie_k, auction, bindings, torch)
    out["hostname_spread"] = {"nodes": 2000, "pods": len(host_pods), "value_space": int(z),
                              "shared_table": bindings.SPREAD_SHARED_Z, "rounds": rounds}
    emit(out)
    return out


# ---- the residents: the mirror and the warm partials ------------------------

# every recording scheduler the script builds (assert_healthy reads them)
SCHEDULERS = []


def wave_edges_phase(wrappers, assign, dv, bindings, torch) -> None:
    """The wavefront's thread-block cluster at its edges, each case on the
    card against its plain version on CPU copies and against the plain scan,
    exact (run_wavefront): a wave whose top lists tie across blocks (every
    37th of 4,000 identical nodes feasible, 4,096 padded: 8 blocks); waves
    of one live member at scattered slots of 32 (5,000 nodes, 8,192
    padded: 16 blocks); fewer padded nodes than kk (20 nodes, waves of
    32); a fit flip late in a wave (28 small pods, then 4 large ones that
    no longer fit where the small ones went); a coupled wave (32 pods on
    one host port: the scan's step member by member); and the gang release
    (two gangs of four where six pods fit)."""
    import numpy as np
    from kubernetes_tpu_torch.ops import schema

    gi, mi = wrappers.GI, wrappers.MI
    cfg = assign.DEFAULT_SCORE_CONFIG

    def node(i, cpu=NODE_CPU_MILLI, label=None):
        w = wrappers.make_node(f"node-{i}").capacity(cpu_milli=cpu, mem=NODE_MEM_GI * gi,
                                                     pods=NODE_PODS).zone(f"zone-{i % ZONES}")
        return (w.label("edge", "yes") if label else w).obj()

    def pod(name, cpu=POD_CPU_MILLI, edge=False, prio=0, port=None, group=None):
        w = wrappers.make_pod(name).req(cpu_milli=cpu, mem=POD_MEM_MI * mi).priority(prio)
        if edge:
            w.node_selector(edge="yes")
        if port:
            w.host_port(port)
        if group:
            w.group(group)
        return w.obj()

    def one_wave(snap, k):
        order = np.argsort(-np.asarray(snap.pods.priority), kind="stable").astype(np.int32)
        members = np.full((max(1, -(-len(order) // k)), k), -1, np.int32)
        for w in range(members.shape[0]):
            part = order[w * k:(w + 1) * k]
            members[w, :len(part)] = part
        return members

    out = []
    cases = [
        ("ties_across_blocks",
         [node(i, label=i % 37 == 0) for i in range(4000)],
         [pod(f"tie-{i}", edge=True) for i in range(64)], lambda snap: one_wave(snap, 32)),
        ("one_member_of_32",
         [node(i) for i in range(MAIN[0])], [pod(f"lone-{i}") for i in range(40)], None),
        ("fewer_nodes_than_kk",
         [node(i) for i in range(20)], [pod(f"few-{i}") for i in range(96)],
         lambda snap: one_wave(snap, 32)),
        ("late_fit_flip",
         [node(i, cpu=2000, label=i % 250 == 0) for i in range(2000)],
         [pod(f"small-{i}", cpu=200, edge=True, prio=10) for i in range(28)]
         + [pod(f"large-{i}", cpu=1900, edge=True) for i in range(4)],
         lambda snap: one_wave(snap, 32)),
        ("coupled_ports",
         [node(i) for i in range(2000)], [pod(f"port-{i}", port=8080) for i in range(32)],
         lambda snap: one_wave(snap, 32)),
        ("gang_release",
         [node(i, cpu=2000, label=i % 500 == 0) for i in range(1500)],
         [pod(f"gang-{i}", cpu=900, edge=True, group=f"g{i // 4}") for i in range(8)],
         lambda snap: one_wave(snap, 32)),
    ]
    for label, nodes, pods, plan in cases:
        snap, _meta = schema.SnapshotBuilder().build(nodes, pods)
        features = assign.features_of(snap)
        n_groups = schema.num_groups(snap)
        n = int(snap.cluster.allocatable.shape[0])
        if plan is None:   # one live member a wave, at slot (7 k) % 32
            order = np.argsort(-np.asarray(snap.pods.priority), kind="stable").astype(np.int32)
            members = np.full((len(order), 32), -1, np.int32)
            for k, i in enumerate(order):
                members[k, (7 * k) % 32] = i
        else:
            members = plan(snap)
        ts = dv.to_device(snap, "cuda")
        fallbacks = run_wavefront(ts, features, n_groups, cfg, members, assign, bindings, torch)
        res = assign.wavefront_assign(ts, members, cfg, features=features, n_groups=n_groups)
        placed = res.assignment.cpu().numpy()[:len(pods)]
        blocks = sorted({bindings.scan_node_block(n, int(a)) for a in placed if a >= 0})
        reasons = res.reasons.cpu().numpy()[:len(pods)]
        row = {"case": label, "padded_nodes": n, "cluster_blocks": bindings.scan_shape(n)[0],
               "placed": int((placed >= 0).sum()), "fallbacks": fallbacks,
               "picked_blocks": len(blocks)}
        if not {
            "ties_across_blocks": len(blocks) >= 2 and row["placed"] == 64,
            "one_member_of_32": row["placed"] == 40 and fallbacks == 0,
            "fewer_nodes_than_kk": n < 33 and fallbacks == 0,
            "late_fit_flip": fallbacks >= 1 and row["placed"] == 28,
            "coupled_ports": fallbacks == 32,
            "gang_release": bool((reasons == assign.REASON_GANG).any()),
        }[label]:
            raise AssertionError(f"wave_edges/{label}: the case did not show: {row}")
        out.append(row)
    torch.cuda.synchronize()
    emit({"phase": "wave_edges", "cases": out, "exact": True})


# launch_shape's 1,024-thread blocks: WIDE_EDGE_NODES nodes pad to 16,384
# (16 blocks); the north star's 50,000 to 65,536 (16 blocks)
WIDE_EDGE_NODES = 10000
WIDE_WAVE_PODS = 256


def wide_edges_phase(wrappers, TorchBatchScheduler, big, assign, dv, filters, bindings,
                     torch) -> None:
    """The wavefront and evaluate_single at 16,384 and 65,536 padded nodes,
    where launch_shape takes 1,024-thread blocks, exact: on a fresh
    WIDE_EDGE_NODES-node cluster and on the north phase's scheduler `big`
    after its two batches (50,000 nodes, 20,000 pods bound), a 256-pod
    SchedulingBasic batch on the wavefront (the planner's waves) against
    its plain version and the plain scan on CPU copies, and one
    pod-default pod (E: the fused launch) and one with a preferred
    inter-pod term (E+: filter, class_extras, score) through
    evaluate_single against its plain versions and the plain path on a CPU
    copy; the wavefront batch's cold statics prep (class_statics, with and
    without the selector mask) against its plain twin on CPU copies.  Then
    on `big` kernel family_prep, every entry, against its plain twins on a
    CPU copy (family_z_check), and class_extras at its edges on seeded
    tables (class_extras_edges)."""
    from kubernetes_tpu_torch.testing.cases import preferred_affinity_objects

    mid = TorchBatchScheduler()
    for node in make_cluster(wrappers, WIDE_EDGE_NODES):
        mid.add_node(node)
    rows = []
    for k, sched in enumerate((mid, big)):
        snap, meta = sched.encode_pending(make_pods(wrappers, WIDE_WAVE_PODS, f"edge-wave{k}"))
        n_pad = snap.cluster.allocatable.shape[0]
        if meta.route != "wavefront":
            raise AssertionError(f"wide_edges: a {WIDE_WAVE_PODS}-pod batch took {meta.route}")
        fallbacks = run_wavefront(snap, meta.features, meta.n_groups, sched.score_config,
                                  meta.wave_plan.members, assign, bindings, torch)
        check_statics(f"class_statics ({n_pad} padded nodes)", snap,
                      torch.clamp(snap.pods.class_rep, 0, snap.pods.req.shape[0] - 1), assign,
                      bindings, torch, on_cpu=True)
        for preferred in (False, True):
            pod = (preferred_affinity_objects(wrappers, 1, 0, 1)[2][0] if preferred
                   else make_pods(wrappers, 1, f"edge-one{k}")[0])
            one_np, _meta = sched.builder.build_from_state(sched.state, [pod])
            run_evaluate_single(dv.to_device(one_np, "cuda"), assign.features_of(one_np),
                                sched.score_config, assign, bindings, torch)
        rows.append({"padded_nodes": n_pad, "blocks_threads": bindings.scan_shape(n_pad),
                     "wave_pods": WIDE_WAVE_PODS, "waves": len(meta.wave_plan.members),
                     "wave_fallbacks": fallbacks, "evaluate_single": ["E", "E+"]})
    fam = family_z_check(wrappers, big, filters, bindings, torch)
    extras = class_extras_edges(bindings, assign, torch)
    emit({"phase": "wide_edges", "cases": rows, "family_prep": fam, "class_extras": extras,
          "equal_plain": True})


def class_extras_edges(bindings, assign, torch) -> list:
    """Kernel class_extras on seeded tables at its edges, against its plain
    version on CPU copies, exact: "wide", 65,536 nodes and 64 pairs with
    preferred terms (negative weights, rows matched by no pod) and images
    (clusters of 8 blocks: 16 nodes a thread, past the kKeep kept in
    registers); "many", 4,096 nodes and 1,024 image pairs over 300 images
    (more named images in a cluster than a presence mask holds)."""
    import numpy as np
    from types import SimpleNamespace as NS

    from kubernetes_tpu_torch.ops import scores

    rows = []
    for label, n, c_dim, i_dim, pref in (("wide", 65536, 64, 40, True),
                                         ("many", 4096, 1024, 300, False)):
        rng = np.random.default_rng(len(label))
        p, u, ma, mi = 96, 16, 4, 8
        iw = (i_dim + 31) // 32
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
        bits = rng.integers(0, 2 ** 32, (n, iw), dtype=np.uint64).astype(np.uint32)
        cluster = NS(allocatable=t(np.zeros((n, 1), np.float32)), image_bits=t(bits.view(np.int32)),
                     node_valid=t(rng.random(n) < 0.95))
        images = NS(sizes=t((rng.integers(1, 1500, i_dim) * 1048576
                             + rng.integers(0, 1048576, i_dim)).astype(np.float32)),
                    pod_ids=t(rng.integers(-1, i_dim, (p, mi)).astype(np.int32)),
                    n_containers=t(rng.integers(0, 8, p).astype(np.float32)))
        prefpod = NS(pod_idx=t(rng.integers(-1, u, (p, ma)).astype(np.int32)),
                     pod_weight=t(rng.integers(-100, 101, (p, ma)).astype(np.float32)),
                     matches_incoming=t(rng.random((p, u)) < 0.3))
        pp = NS(counts_dom=t(rng.integers(0, 30, (u, n)).astype(np.float32)),
                ownerw_dom=t(rng.integers(-300, 300, (u, n)).astype(np.float32)))
        features = NS(interpod_pref=pref, images=True)
        cfg = scores.ScoreConfig(interpod_weight=1.3, image_weight=0.7)
        reps = t(rng.integers(0, p, c_dim).astype(np.int32))
        feas = t(rng.random((c_dim, n)) < 0.6)
        card = lambda ns: NS(**{k: v.cuda() for k, v in vars(ns).items()})
        out = bindings.class_extras(card(cluster), card(prefpod), card(images), features, cfg,
                                    reps.cuda(), feas.cuda(), card(pp) if pref else None)
        want = assign.class_extras_plain(cluster, prefpod, images, features, cfg, reps, feas,
                                         pp if pref else None)
        err = check_equal(f"class_extras ({label})", (out,), (want,), torch)
        rows.append({"case": label, "nodes": n, "pairs": c_dim, "images": i_dim,
                     "preferred": pref, "max_abs_err": err,
                     "blocks_clusters": list(bindings.class_extras_shape(
                         card(cluster), card(prefpod), card(images), features, reps))})
    return rows


def wide_family_snapshot(wrappers, sched) -> tuple:
    """The wide family batch on the north scheduler's width (65,536 padded
    nodes): 2,000 color=red pods of the preferred-affinity template (a
    weight-1 preferred term over color=red on the hostname) assumed onto
    spread-out nodes of `sched` (NORTH[0] nodes), then a batch encoded (not
    solved) whose pods carry every family over them: hard spread rows on
    the hostname (a value space of the padded node count) and the zone, a
    required anti-affinity term on the zone, and the template's preferred
    term.  Returns (snapshot, meta)."""
    from kubernetes_tpu_torch.testing.cases import preferred_affinity_objects

    _nodes, bound_red, pref = preferred_affinity_objects(wrappers, 1, 2000, 8)
    for i, pod in enumerate(bound_red):
        sched.assume(pod, f"node-{(i * 37) % NORTH[0]}")
    api = wrappers.api
    pods = list(pref)
    for i in range(8):
        pods.append(wrappers.make_pod(f"fam-s{i}", "sched-0").label("color", "red")
                    .spread(1, api.LABEL_HOSTNAME, "DoNotSchedule", {"color": "red"})
                    .spread(2, api.LABEL_ZONE, "DoNotSchedule", {"color": "red"}).obj())
        pods.append(wrappers.make_pod(f"fam-a{i}", "sched-0").label("color", "blue")
                    .pod_anti_affinity({"color": "red"}, api.LABEL_ZONE).obj())
    snap, meta = sched.encode_pending(pods)
    f = meta.features
    if not (f.spread and f.interpod and f.interpod_pref and f.bound_spread and f.bound_terms
            and f.bound_pref):
        raise AssertionError(f"wide_edges/family_prep: a family is missing ({f})")
    return snap, meta


def family_z_check(wrappers, sched, filters, bindings, torch) -> dict:
    """Kernel family_prep at the north scheduler's width (65,536 padded
    nodes) on wide_family_snapshot's batch: each entry against its plain
    twins on the card and on a CPU copy, one device operation a call, its
    scratch zero after it."""
    snap, meta = wide_family_snapshot(wrappers, sched)
    errs = check_family("wide", snap, meta.features, meta.topo_split, filters, bindings, torch,
                        count_ops=True)
    return {"padded_nodes": int(snap.cluster.allocatable.shape[0]),
            "z": list(meta.topo_split), "entries": sorted(errs), "max_abs_err": max(errs.values()),
            "device_ops": 1, "scratch_zero": True}


def gang_groups(pods, names) -> tuple:
    """(gangs placed whole, gangs left wholly unplaced) of a batch; raises
    if a gang is split."""
    groups = {}
    for pod, name in zip(pods, names):
        if pod.spec.scheduling_group:
            groups.setdefault(pod.spec.scheduling_group, []).append(name)
    whole = empty = 0
    for g, got in groups.items():
        placed = sum(n is not None for n in got)
        if 0 < placed < len(got):
            raise AssertionError(f"gang {g}: {placed} of {len(got)} members placed")
        whole += placed == len(got)
        empty += placed == 0
    return whole, empty


def check_result_capacity(what, res) -> None:
    """No node's post-solve usage in the result exceeds its allocatable."""
    over = res.cluster.requested > res.cluster.allocatable
    if bool(over.any()):
        raise AssertionError(f"{what}: a node's post-solve usage exceeds its allocatable")


def gang_inputs(snap, meta, cfg, auction, bindings, convert=None) -> tuple:
    """(cluster, pods, st, before) of a gang batch on the card: its state
    before the post-pass (assigned, bid_scores, requested, nonzero,
    reasons) from the loop's launch without gangs (the rounds and the
    reasons; `bindings` and `convert` as in final_state)."""
    cluster, pods, st = auction.auction_prep(snap, meta.features, meta.topo_split, cfg)
    out, reasons, _ = bindings.auction_solve(cluster, pods, convert(st) if convert else st,
                                             meta.tie_k, cfg, 64)
    return cluster, pods, st, (out[0], out[1], out[2], out[3], reasons)


def gang_stage_call(b, cluster, pods, st, tie_k, cfg, n_groups, before) -> tuple:
    """(launch, reset, result) of a tree's gang stage alone (its bindings
    `b`: AuctionRun.gang_stage, auction_loop's kernel) on the state before
    the post-pass: its AuctionRun made once, the carries and the reasons
    reloaded by reset; result as gang_post_pass_plain's tuple."""
    assigned, bid_scores, req, nz, reasons = before
    run = b.AuctionRun(cluster, pods, st, tie_k, cfg, 0, n_groups)

    def reset():
        run.load(0, req, nz, assigned, bid_scores, go=False)
        run.reasons.copy_(reasons)

    return run.gang_stage, reset, lambda: (run.assigned, run.bid_scores, run.reasons,
                                           run.gang_dropped, run.requested, run.nonzero)


def dropped_on(assigned, dropped, torch) -> tuple:
    """(dropped pods, the nodes they were placed on)."""
    dropped = dropped.cpu()
    return int(dropped.sum()), int(torch.unique(assigned.cpu()[dropped]).numel())


def gang_need(pods, d: int, nodes: int) -> tuple:
    """(bytes, operations) of the gang stage with d pods dropped from
    `nodes` nodes: each pod's group, assignment and validity read and its
    flag written, the dropped pods' two request rows read and their
    assignment, score and reason written, their nodes' two usage rows read
    and written, one subtraction a dropped pod, resource and row."""
    p, r = pods.req.shape
    return p * (4 + 4 + 1 + 1) + d * (2 * r * 4 + 12) + nodes * 2 * 2 * r * 4, float(2 * d * r)


def gang_row(snap, meta, cfg, shape, auction, bindings, torch, drops: bool = True) -> dict:
    """The gang stage alone (gang_stage_call, this tree's bindings) on a
    gang batch's state before the post-pass (gang_inputs), against
    gang_post_pass_plain on CPU copies (it adds in pod index order on the
    CPU only), exact; CUDA events behind a spin (launch_ms), the plain twin
    host-timed on the CPU copies, and the bound (gang_need).  `drops`:
    whether the batch must drop some pod (else none may)."""
    cluster, pods, st, before = gang_inputs(snap, meta, cfg, auction, bindings)
    launch, reset, result = gang_stage_call(bindings, cluster, pods, st, meta.tie_k, cfg,
                                            meta.n_groups, before)
    ms, host_ms = launch_ms(launch, reset, 10, torch)
    c_args = cpu_args((pods, *before[:2], before[4], *before[2:4]), torch)
    want = auction.gang_post_pass_plain(*c_args, meta.n_groups)
    err = check_equal(f"auction_gang ({shape})", result(), want, torch)
    dropped = want[3]
    if bool(dropped.any()) != drops:
        raise AssertionError(f"auction_gang ({shape}): {int(dropped.sum())} pods dropped")
    plain_ms = time_plain(lambda: auction.gang_post_pass_plain(*c_args, meta.n_groups), torch)
    p = pods.req.shape[0]
    d, nodes = dropped_on(before[0], dropped, torch)
    b = bound(*gang_need(pods, d, nodes))
    return {"name": "auction_gang", "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
            "bound_ms": b[0], "bound_by": b[1], "max_abs_err": err, "library_ms": None,
            "stage_of": "auction_loop", "dropped": d, "nodes": nodes,
            "shape_detail": f"{cluster.allocatable.shape[0]} padded nodes, {p} padded pods, "
                            f"{meta.n_groups} gangs, {d} dropped pods on {nodes} nodes"}


def gang_phase(wrappers, TorchBatchScheduler, assign, auction, bindings, torch, card) -> list:
    """bench.py's c5 at full width (see C5): TorchBatchScheduler(mode=
    "auto") on 50,000 nodes, a warm-up batch and C5_TIMED batches of
    10,000 pods in 100 gangs under fresh names, nothing assumed; each batch
    its own launch window (the auction route, one auction_loop launch, no
    stage alone, no plain twin), gangs all or nothing, the result's usage
    within capacity; the last batch's snapshot against auction_assign on
    CPU copies, every field.  Then the drops step (the same cluster, one
    member of each of C5_DROP_GANGS unplaceable: those gangs released in
    the launch, card == CPU, the usage bit for bit) and the scarcity step
    (C5_SCARCE nodes: the full solve completes no gang, the admission
    retry's solves on the auction route, names == the port on the CPU).
    Returns the summary rows of the auction's tail stages alone, each with
    the launches of the phase's loops that ran it at its shape: the reasons
    stage at G (the last c5 batch) and S200 (the scarcity step's full
    solve), the gang stage at G0 (the last c5 batch: no drop), G (the drops
    step) and S200."""
    t0 = time.perf_counter()
    sched = TorchBatchScheduler(mode="auto")
    for node in c5_nodes(wrappers, C5[0]):
        sched.add_node(node)
    out = {"phase": "gang", "workload": "bench.py c5 (config5)", "nodes": C5[0],
           "pods": C5[1], "gangs": C5[2], "add_nodes_s": time.perf_counter() - t0,
           "batches": [], "card": card}
    loops = 0
    for k, tag in enumerate(("warmup",) + tuple(f"run{j}" for j in range(C5_TIMED))):
        pods = c5_pods(wrappers, tag)

        def run(pods=pods):
            torch.cuda.synchronize()
            t = time.perf_counter()
            names = sched.schedule_pending(pods)
            return names, time.perf_counter() - t

        (names, wall), launches = drive_phase(f"gang/{tag}", run, bindings, [sched])
        meta = sched.metas[-1]
        if meta.route != "auction" or launches["auction_loop"] != 1:
            raise AssertionError(f"gang/{tag}: route {meta.route}, "
                                 f"{launches['auction_loop']} auction_loop launches")
        loops += launches["auction_loop"]
        whole, empty = gang_groups(pods, names)
        check_result_capacity(f"gang/{tag}", sched.last_result)
        out["batches"].append({
            "batch": tag, "s": wall, "pods_per_s": len(pods) / wall,
            "placed": sum(n is not None for n in names), "complete_gangs": whole,
            "unplaced_gangs": empty, "rounds": int(sched.last_result.rounds),
            **{f: sched.last_timings[f] for f in ("encode_s", "compile_s", "solve_s")},
            "build_s": meta.encode_split.get("build_s") if meta.encode_split else None})
    timed = out["batches"][1:]
    out["batch_s_min"] = min(b["s"] for b in timed)
    for f in ("encode_s", "compile_s", "solve_s"):
        out[f"{f}_min"] = min(b[f] for b in timed)
    # the last batch's snapshot (nothing was assumed: the same state)
    # against the plain path on CPU copies, every field
    t0 = time.perf_counter()
    snap, meta = sched.encode_pending(pods)
    want = solve_route("auction", cpu_copy(snap), meta, assign, auction, sched.score_config)
    check_equal("gang: the last batch (card against the plain path on the CPU)",
                result_fields(sched.last_result, True), result_fields(want, False), torch)
    out["plain_check_s"] = time.perf_counter() - t0
    # the tail's stages alone at this batch's shape: the reasons (G) and
    # the gang stage with no drop (G0); launches: the c5 batches' loops
    # (the drops step's too for the reasons)
    c5_loops = loops
    rows = [stage_reasons_row(snap, meta, sched.score_config, "G", auction, bindings, torch),
            dict(gang_row(snap, meta, sched.score_config, "G0", auction, bindings, torch,
                          drops=False), shape="G0", launches=c5_loops)]

    # drops at width: gangs with an unplaceable member come back incomplete
    # and their placed members are released inside the launch
    dpods = c5_pods(wrappers, "drops", C5_DROP_GANGS)

    def run_drops():
        return sched.schedule_pending(dpods)

    dnames, dlaunches = drive_phase("gang/drops", run_drops, bindings, [sched])
    loops += dlaunches["auction_loop"]
    res = sched.last_result
    if sched.metas[-1].route != "auction" or not bool(res.gang_dropped.any()):
        raise AssertionError("gang/drops: no gang released on the auction route")
    whole, empty = gang_groups(dpods, dnames)
    check_result_capacity("gang/drops", res)
    dsnap, dmeta = sched.encode_pending(dpods)
    # its cold statics prep (G: 65,536 padded nodes, a label selector with
    # the 32-row floor) against the plain prep on the card
    check_statics("class_statics (G)", dsnap,
                  torch.clamp(dsnap.pods.spec_rep, 0, dsnap.pods.req.shape[0] - 1), assign,
                  bindings, torch)
    dwant = solve_route("auction", cpu_copy(dsnap), dmeta, assign, auction, sched.score_config)
    check_equal("gang/drops (card against the plain path on the CPU)",
                result_fields(res, True), result_fields(dwant, False), torch)
    out["drops"] = {"gangs_with_a_misfit": len(C5_DROP_GANGS), "complete_gangs": whole,
                    "unplaced_gangs": empty, "dropped_pods": int(res.gang_dropped.sum()),
                    "launches": dlaunches["auction_loop"], "usage_equal_cpu": True}
    rows[0]["launches"] = c5_loops + dlaunches["auction_loop"]
    rows.append(dict(gang_row(dsnap, dmeta, sched.score_config, "c5 drops", auction, bindings,
                              torch), shape="G", launches=dlaunches["auction_loop"]))

    # scarcity: the full solve completes no gang, so the admission retry
    # re-solves gang prefixes on the auction route
    names_of = {}
    solves = {}
    for dev in ("cuda", "cpu"):
        s = TorchBatchScheduler(mode="auto", device=dev)
        for node in c5_nodes(wrappers, C5_SCARCE):
            s.add_node(node)
        spods = c5_pods(wrappers, "scarce")
        if dev == "cuda":
            before = s.auction_solves
            (names_of[dev], wall), slaunches = drive_phase(
                "gang/scarcity", lambda s=s, spods=spods: (
                    s.schedule_pending(spods), None), bindings, [s])
            solves[dev] = s.auction_solves - before
            loops += slaunches["auction_loop"]
        else:
            names_of[dev] = s.schedule_pending(spods)
        full = s.metas[0]
        if full.route != "auction":
            raise AssertionError(f"gang/scarcity ({dev}): route {full.route}")
        if dev == "cuda":
            # the full solve's snapshot (nothing assumed: the same state):
            # the tail's stages alone at S200, with the step's launches
            ssnap, smeta = s.encode_pending(spods)
            rows.append(dict(stage_reasons_row(ssnap, smeta, s.score_config, "S200", auction,
                                               bindings, torch),
                             launches=slaunches["auction_loop"]))
            rows.append(dict(gang_row(ssnap, smeta, s.score_config, "S200", auction, bindings,
                                      torch), shape="S200", launches=slaunches["auction_loop"]))
    if names_of["cuda"] != names_of["cpu"]:
        raise AssertionError("gang/scarcity: card and CPU names differ")
    whole, empty = gang_groups(spods, names_of["cuda"])
    if solves["cuda"] < 2 or whole == 0:
        raise AssertionError(f"gang/scarcity: {solves['cuda']} solves, {whole} gangs placed")
    out["scarcity"] = {"nodes": C5_SCARCE, "auction_solves": solves["cuda"],
                       "complete_gangs": whole, "placed": sum(n is not None
                                                              for n in names_of["cuda"]),
                       "names_equal_cpu": True}
    out["tail_stages"] = rows
    out["auction_loop_launches"] = loops
    emit(out)
    return rows


def recording(cls):
    """TorchBatchScheduler keeping the meta of every batch it encodes: the
    launch checks derive each phase's kernels from them.  Each one is
    registered in SCHEDULERS for assert_healthy."""
    class Recorded(cls):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.metas = []
            self.auction_solves = 0   # auction batches dispatched to the card
            self.cold_preps = 0       # dispatches with a cold statics prep
            SCHEDULERS.append(self)

        def encode_pending(self, *args, **kw):
            snap, meta = super().encode_pending(*args, **kw)
            self.metas.append(meta)
            return snap, meta

        def _dispatch(self, snap, meta):
            self.auction_solves += meta.route == "auction"
            # on the card; the auction never takes warm statics
            self.cold_preps += self.device.type == "cuda" and (
                meta.route == "auction" or meta.statics is None)
            return super()._dispatch(snap, meta)

    return Recorded


def assert_healthy() -> int:
    """Before the faults phase, the only one that arms a fault: every
    scheduler built so far has its breaker closed, has never tripped, has
    solved no batch on the host and has solved no batch cold after a
    failed partials sync.  On the card a kernel that fails to build or
    launch, or a CUDA error, re-raises; this holds the one fault the
    breaker does absorb there, a corrupt result, to zero.  Returns the
    schedulers checked."""
    for s in SCHEDULERS:
        b = s.breaker
        sync_failures = s._partials.sync_failures if s._partials is not None else 0
        if (b.state != b.CLOSED or b.trips or b.fallback_count() or sync_failures):
            route = s.metas[0].route if s.metas else None
            raise AssertionError(
                f"a scheduler (first route {route}) has its breaker {b.state} with "
                f"{b.trips} trips, {b.fallback_count()} host fallbacks and "
                f"{sync_failures} failed partials syncs before any fault was armed")
    return len(SCHEDULERS)


def residents(sched) -> dict:
    """Both residents' counters."""
    return {"mirror": sched._mirror.stats(),
            "partials": sched._partials.stats() if sched._partials is not None else None}


def batch_record(sched, meta, seconds: float) -> dict:
    """One batch's step split, residents' counters and host->card bytes."""
    t = sched.last_timings
    return {"encode_s": t["encode_s"], "compile_s": t["compile_s"], "solve_s": t["solve_s"],
            "s": seconds, "encode_split": meta.encode_split, "transfer_bytes": meta.transfer_bytes,
            "resident_launches": meta.resident_launches, **residents(sched)}


def solve_pair(what, warm, cold, pods, torch) -> tuple:
    """Encode and solve `pods` through the warm and the cold scheduler;
    every result field and the wave counters equal.  Returns (names, warm
    record, cold record, warm meta)."""
    recs, names, metas = [], [], []
    for s in (warm, cold):
        torch.cuda.synchronize()
        t = time.perf_counter()
        names.append(s.schedule_pending(pods))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        meta = s.last_solve.meta
        metas.append(meta)
        recs.append(batch_record(s, meta, dt))
    if names[0] != names[1]:
        raise AssertionError(f"{what}: warm and cold placements differ")
    if metas[0].route != metas[1].route:
        raise AssertionError(f"{what}: routes {metas[0].route} / {metas[1].route}")
    check_equal(f"{what} (warm against cold)", result_fields(warm.last_result, True),
                result_fields(cold.last_result, True), torch)
    if warm.last_solve.wave_count != cold.last_solve.wave_count:
        raise AssertionError(f"{what}: wave counts differ")
    return names[0], recs[0], recs[1], metas[0]


def dirtied_rows(sched) -> int:
    """Rows the state dirtied since the mirror's last sync (static and
    usage families counted apart, as the counters count them)."""
    st = sched.state
    n = st.node_axis_bucket
    static, usage = st.dirty_rows(sched._mirror._synced_gen, n)
    return int(static.shape[0] + usage.shape[0])


def resident_phase(wrappers, TorchBatchScheduler, bindings, torch, card):
    """The residents at full width, warm (TorchBatchScheduler(): mirror and
    partials on) against cold (use_mirror=False), every batch equal field
    for field: SchedulingNodeAffinity/5000Nodes in 500-pod batches with a
    pad-bucket crossing after the second, and SchedulingWithMixedChurn/
    5000Nodes on the wavefront and on the scan.  Returns the NodeAffinity
    part's launch counts."""
    from kubernetes_tpu_torch.testing.cases import mixed_churn_objects

    out = {"phase": "resident", "card": card}
    pods = affinity_pods(wrappers, AFFINITY[1] + AFFINITY[2], "res")
    batches = [pods[lo : lo + AFFINITY_BATCH] for lo in range(0, len(pods), AFFINITY_BATCH)]
    warm, cold = TorchBatchScheduler(), TorchBatchScheduler(use_mirror=False)
    for s in (warm, cold):
        for node in make_cluster(wrappers, AFFINITY[0]):
            s.add_node(node)
    zone_of = {f"node-{i}": f"zone-{i % ZONES}" for i in range(2 * AFFINITY[0])}
    recs = []

    def run_affinity():
        prev_rows = 0
        for k, batch in enumerate(batches):
            added = 0
            if k == 2:
                # a pad-bucket crossing at width: node-default nodes until
                # the bucket moves past 8,192
                b0 = warm.state.node_axis_bucket
                for node in make_cluster(wrappers, b0 + 1)[AFFINITY[0]:]:
                    for s in (warm, cold):
                        s.add_node(node)
                    added += 1
                warm.state.tensors()  # the bucket follows the rows at the next snapshot
                if warm.state.node_axis_bucket <= b0:
                    raise AssertionError("resident: the node bucket did not move")
            before = residents(warm)
            # the rows dirtied since the last batch: the previous batch's
            # assumed rows (usage), each added node's row (static and usage)
            want_rows = prev_rows + 2 * added
            if k and dirtied_rows(warm) != want_rows:
                raise AssertionError(f"resident/affinity{k}: the state dirtied "
                                     f"{dirtied_rows(warm)} rows, not {want_rows}")
            names, rw, rc, meta = solve_pair(f"resident/affinity{k}", warm, cold, batch, torch)
            after = residents(warm)
            m0, m1 = before["mirror"], after["mirror"]
            p0, p1 = before["partials"], after["partials"]
            if meta.route != "wavefront" or meta.statics is None:
                raise AssertionError(f"resident/affinity{k}: route {meta.route}, warm "
                                     f"{meta.statics is not None}")
            if k == 0:
                if m1["resync_total"] != 1 or p1["full_recomputes"] != 1:
                    raise AssertionError("resident: the first batch is not a full upload + eval")
            else:
                if m1["resync_total"] != m0["resync_total"] or m1["delta_syncs"] != m0["delta_syncs"] + 1:
                    raise AssertionError(f"resident/affinity{k}: not a delta sync ({m0} -> {m1})")
                if m1["delta_rows_total"] - m0["delta_rows_total"] != want_rows:
                    raise AssertionError(f"resident/affinity{k}: delta rows "
                                         f"{m1['delta_rows_total'] - m0['delta_rows_total']}, "
                                         f"the state dirtied {want_rows}")
                if p1["full_recomputes"] != p0["full_recomputes"]:
                    raise AssertionError(f"resident/affinity{k}: the partials recomputed in full")
                if k == 2 and (m1["grow_syncs"] != 1 or p1["grows"] != 1):
                    raise AssertionError(f"resident/affinity{k}: no in-place grow ({m1}, {p1})")
            for pod, name in zip(batch, names):
                if name is None or zone_of[name] not in AFFINITY_ZONES:
                    raise AssertionError(f"resident: {pod.meta.name} placed on {name}")
                for s in (warm, cold):
                    s.assume(pod, name)
            prev_rows = len(set(names))
            recs.append({"batch": k, "pods": len(batch), "nodes": warm.state.num_nodes,
                         "bucket": warm.state.node_axis_bucket, "added_nodes": added,
                         "delta_rows": want_rows if k else None, "warm": rw, "cold": rc})

    _, launches = drive_phase("resident", run_affinity, bindings, [warm, cold])
    if not warm._partials.verify(warm._mirror.sync()):
        raise AssertionError("resident: the partials store differs from a full recompute")
    check_capacity(warm.state)
    out["affinity"] = {"workload": "SchedulingNodeAffinity/5000Nodes", "route": "wavefront",
                       "batch_size": AFFINITY_BATCH, "batches": recs, "launches": launches}

    # SchedulingWithMixedChurn/5000Nodes: 400 measured + the 100 recreated
    # churn pods a batch, on the wavefront and on the scan
    nodes, measured, churn = mixed_churn_objects(wrappers, *CHURN)
    pairs = {"wavefront": (TorchBatchScheduler(), TorchBatchScheduler(use_mirror=False)),
             "greedy": (TorchBatchScheduler(mode="greedy", use_wavefront=False),
                        TorchBatchScheduler(mode="greedy", use_wavefront=False,
                                            use_mirror=False))}
    for pair in pairs.values():
        for s in pair:
            for node in nodes:
                s.add_node(node)
    out["churn"] = {"workload": "SchedulingWithMixedChurn/5000Nodes"}
    for route, (w, c) in pairs.items():
        crecs = []

        def run_churn():
            for k, lo in enumerate(range(0, len(measured), CHURN_MEASURED_BATCH)):
                batch = churn(k, CHURN_PODS) + measured[lo : lo + CHURN_MEASURED_BATCH]
                names, rw, rc, meta = solve_pair(f"resident/churn/{route}{k}", w, c, batch,
                                                 torch)
                if meta.route != route or meta.statics is None:
                    raise AssertionError(f"resident/churn: route {meta.route}")
                reasons = w.last_result.reasons.cpu().tolist()
                for i in range(CHURN_PODS):
                    if names[i] is not None or reasons[i] != 1:  # REASON_RESOURCES
                        raise AssertionError(f"resident/churn: churn pod {i} placed or reason "
                                             f"{reasons[i]}")
                for pod, name in zip(batch[CHURN_PODS:], names[CHURN_PODS:]):
                    if name is None:
                        raise AssertionError(f"resident/churn: {pod.meta.name} unplaced")
                    for s in (w, c):
                        s.assume(pod, name)
                crecs.append({"batch": k, "pods": len(batch),
                              "classes": int(meta.statics.sfeas.shape[0]),
                              "slots": w._partials.stats()["slots"], "warm": rw, "cold": rc})

        _, clog = drive_phase(f"resident/churn/{route}", run_churn, bindings, [w, c])
        if w._partials.stats()["delta_syncs"] < 3:
            raise AssertionError("resident/churn: the partials served no delta syncs")
        check_capacity(w.state)
        out["churn"][route] = {"batches": crecs, "launches": clog}
    emit(out)
    return launches, out["churn"]["wavefront"]["launches"]["wavefront"]


def partials_node_need(cluster, specs, torch) -> tuple:
    """(bytes a column, tested ids, operations a (slot, column) pair) of
    the partials' evaluation on this data: a column's valid byte, its name
    id only where a slot pins a node, the taint words of each effect some
    slot does not tolerate wholesale, the port words some slot claims, the
    label words and topology ids the live selector and preferred
    expressions test; two integer operations a tested word or id, eight a
    pair besides."""
    tw = cluster.taint_bits.shape[2]
    effects = int((~specs.tol_all).any(dim=1).sum())
    port_words = int((specs.port_bits != 0).any(dim=0).sum())
    names = 4 if bool((specs.name_id != -1).any()) else 0
    sel_live = (specs.sel_tv[:, :, None] & ((specs.sel_op == 1) | (specs.sel_op == 2))
                & specs.has_sel[:, None, None])
    pref_live = specs.pref_valid[:, :, None] & ((specs.pref_op == 1) | (specs.pref_op == 2))
    ids = torch.cat([specs.sel_ids[sel_live], specs.pref_ids[pref_live]])
    slots = torch.cat([specs.sel_slot[sel_live], specs.pref_slot[pref_live]])
    label = ids[(slots < 0)[:, None].expand_as(ids) & (ids >= 0)]
    words = int(torch.unique(label >> 5).numel()) if label.numel() else 0
    topo = int(torch.unique(slots[slots >= 0]).numel())
    per_col = 1 + names + 4 * effects * tw + 4 * port_words + 4 * (words + topo)
    return per_col, int((ids != -1).sum()), 8 + 2 * effects * tw + 2 * port_words


def partials_update_need(cluster, specs, old_n: int, n: int, d_all: int, m: int,
                         torch) -> tuple:
    """(bytes, operations) of one partials_eval launch on this data: a
    fresh [G, n] store from an old one of old_n columns (0: none), every
    slot evaluated at the d_all dirty or grown columns, the m missed slots
    at every column, every other entry copied.  Bytes: the specs once, the
    node rows of each evaluated column (partials_node_need), each copied
    entry's 9 bytes read, the whole store's 9 bytes an entry written."""
    g = specs.valid.shape[0]
    per_col, tested, pair_ops = partials_node_need(cluster, specs, torch)
    evaluated = g * d_all + m * (n - d_all)
    copied = (g - m) * (n - d_all) if old_n else 0
    staged = n if m else d_all
    need = nbytes(*specs) + staged * per_col + 9 * copied + 9 * g * n
    return need, float(staged) * 2 * tested + float(evaluated) * pair_ops


def mirror_rows_need(leaves) -> tuple:
    """(bytes, operations) of one mirror_rows launch: each leaf (field,
    resident tensor, axis, rows, values) read once where the delta does not
    overwrite it, its packed rows and indices read, the fresh leaf written
    whole."""
    need = 0
    for _f, src, _ax, idx, vals in leaves:
        whole = src.numel() * src.element_size()
        delta = int(getattr(vals, "nbytes", 0))
        need += (whole - delta) + delta + 4 * int(idx.shape[0]) + whole
    return need, 0.0


def capture_syncs(sched):
    """Hook a scheduler's residents: while on["on"], every partials delta
    sync and mirror delta appends what it started from (the resident
    tensors it read, its index lists, the rows it wrote), and every spec
    insert its rows.  Returns (partials syncs, mirror deltas, spec
    inserts, on).  The tensors are the residents' own, which no later sync
    changes."""
    import numpy as np

    from kubernetes_tpu_torch.models import mirror as mirror_mod
    from kubernetes_tpu_torch.ops import partials as pops_mod

    parts, mirrors, spec_rows, on = [], [], [], {"on": True}
    p, m = sched._partials, sched._mirror
    delta, apply = p._delta, m._apply_deltas
    set_spec_rows = pops_mod.set_spec_rows

    def spec_insert(specs, rows, idx, stage):
        if on["on"]:
            spec_rows.append({"specs": specs, "idx": np.array(idx, dtype=np.int32),
                              "rows": {k: np.array(v) for k, v in rows.items()}})
        return set_spec_rows(specs, rows, idx, stage)

    def hooked_delta(cluster, snap, keys, misses, dirty, n, c_dim):
        rec = {"store": p._store, "old_n": p._n, "n": n, "cluster": cluster,
               "dirty": np.array(dirty, dtype=np.int32), "first_slot": len(p._slots),
               "misses": len(misses)}
        out = delta(cluster, snap, keys, misses, dirty, n, c_dim)
        rec["specs"] = p._specs
        rec["miss"] = np.arange(rec["first_slot"], rec["first_slot"] + rec["misses"],
                                dtype=np.int32)
        if on["on"]:
            parts.append(rec)
        return out

    def hooked_apply(host, static_idx, usage_idx):
        if on["on"]:
            leaves = []
            for fields, idx in ((mirror_mod._STATIC_LEAVES + ("taint_bits",), static_idx),
                                (mirror_mod._USAGE_LEAVES, usage_idx)):
                for f in fields if idx.shape[0] else ():
                    ax = mirror_mod._node_axis(f)
                    leaves.append((f, getattr(m._dev, f), ax, np.array(idx, dtype=np.int32),
                                   np.take(np.asarray(getattr(host, f)), idx, axis=ax)))
            mirrors.append({"leaves": leaves, "static": int(static_idx.shape[0]),
                            "usage": int(usage_idx.shape[0])})
        return apply(host, static_idx, usage_idx)

    p._delta, m._apply_deltas = hooked_delta, hooked_apply
    pops_mod.set_spec_rows = spec_insert
    return parts, mirrors, spec_rows, on


def hook_first_pass(sched, ev) -> dict:
    """Capture the residents' syncs of the verify solves of ev's next
    PostFilter pass, and nothing else.  The returned dict holds, once that
    pass ran, "partials" and "mirror" (the pass's last verify's sync and
    delta) and "seen" (every verify's dirty columns, misses and delta
    rows)."""
    parts, mirrors, _spec, on = capture_syncs(sched)
    on["on"] = False
    out = {}
    preempt_batch = ev.preempt_batch

    def first(failed):
        if "seen" in out:
            return preempt_batch(failed)
        on["on"] = True
        try:
            return preempt_batch(failed)
        finally:
            on["on"] = False
            out["seen"] = {"verify_partials_syncs": len(parts),
                           "verify_dirty_columns": [int(r["dirty"].shape[0]) for r in parts],
                           "verify_misses": [r["misses"] for r in parts],
                           "verify_mirror_deltas": len(mirrors),
                           "verify_delta_rows": [(r["static"], r["usage"]) for r in mirrors]}
            if parts and mirrors:
                out["partials"], out["mirror"] = parts[-1], mirrors[-1]
            parts.clear()
            mirrors.clear()

    ev.preempt_batch = first
    return out


def partials_case(rec: dict, seen=None) -> dict:
    """A partials shape from a captured sync."""
    return {"kind": "partials", "full": False, "store": rec["store"], "specs": rec["specs"],
            "cluster": rec["cluster"], "old_n": rec["old_n"], "n": rec["n"],
            "miss": rec["miss"], "dirty": rec["dirty"], "seen": seen}


def affinity_cases(sched, torch) -> dict:
    """R, R500, U500, S64 on a warm SchedulingNodeAffinity/5000Nodes
    scheduler's residents (8,192 padded nodes, 32 slots): the store's
    full evaluation and a refresh of 500 random columns; a 500-row usage
    and a 64-row static delta of random rows, from the state's values."""
    import numpy as np

    from kubernetes_tpu_torch.models import mirror as mirror_mod

    rng = np.random.default_rng(16)
    cl, specs, store = sched._mirror.sync(), sched._partials._specs, sched._partials._store
    n, high = int(cl.allocatable.shape[0]), sched.state._high
    empty = np.zeros(0, dtype=np.int32)
    base = {"kind": "partials", "store": store, "specs": specs, "cluster": cl, "old_n": n,
            "n": n, "miss": empty, "seen": None}
    cases = {"R": dict(base, full=True, dirty=empty),
             "R500": dict(base, full=False, dirty=np.sort(
                 rng.choice(high, min(500, high), replace=False)).astype(np.int32))}
    host = sched.state.tensors()
    for shape, fields, d in (("U500", mirror_mod._USAGE_LEAVES, 500),
                             ("S64", mirror_mod._STATIC_LEAVES + ("taint_bits",), 64)):
        idx = np.sort(rng.choice(high, min(d, high), replace=False)).astype(np.int32)
        leaves = []
        for f in fields:
            ax = mirror_mod._node_axis(f)
            leaves.append((f, getattr(cl, f), ax, idx,
                           np.take(np.asarray(getattr(host, f)), idx, axis=ax)))
        cases[shape] = {"kind": "mirror", "leaves": leaves, "seen": None}
    return cases


def verify_cases(verify: dict) -> dict:
    """VR and VM from hook_first_pass's capture."""
    if "partials" not in verify:
        raise AssertionError(f"residents: the verify solves made no delta sync ({verify})")
    seen = verify["seen"]
    return {"VR": partials_case(verify["partials"], seen),
            "VM": {"kind": "mirror", "leaves": verify["mirror"]["leaves"], "seen": seen}}


def crossing_cases(wrappers, T, torch) -> dict:
    """RI and SP: the resident phase's crossing — SchedulingNodeAffinity/
    5000Nodes' two 500-pod batches solved and assumed, node-default nodes
    added until the padded bucket moves past 8,192 — then one sync of the
    next 500 affinity pods and 4 pods of classes the store has not seen
    (pod-default, zone-3 and zone-4 required affinity, a zone-5 preferred
    term): a grow, 4 misses and the dirty columns at once (RI), and its
    spec insert of the 4 slots (SP)."""
    sched = T()
    for node in make_cluster(wrappers, AFFINITY[0]):
        sched.add_node(node)
    pods = affinity_pods(wrappers, 3 * AFFINITY_BATCH, "ri")
    for lo in (0, AFFINITY_BATCH):
        batch = pods[lo: lo + AFFINITY_BATCH]
        for pod, name in zip(batch, sched.schedule_pending(batch)):
            sched.assume(pod, name)
    b0 = sched.state.node_axis_bucket
    for node in make_cluster(wrappers, b0 + 1)[AFFINITY[0]:]:
        sched.add_node(node)
    api, mi = wrappers.api, wrappers.MI
    fresh = [wrappers.make_pod("ri-default").req(cpu_milli=POD_CPU_MILLI, mem=POD_MEM_MI * mi)
             .obj()]
    fresh += [wrappers.make_pod(f"ri-zone{z}").req(cpu_milli=POD_CPU_MILLI, mem=POD_MEM_MI * mi)
              .required_affinity(api.LABEL_ZONE, api.OP_IN, [f"zone-{z}"]).obj() for z in (3, 4)]
    fresh.append(wrappers.make_pod("ri-pref").req(cpu_milli=POD_CPU_MILLI, mem=POD_MEM_MI * mi)
                 .preferred_affinity(5, api.LABEL_ZONE, api.OP_IN, ["zone-5"]).obj())
    parts, _mirrors, spec_rows, on = capture_syncs(sched)
    _snap, meta = sched.encode_pending(pods[2 * AFFINITY_BATCH:] + fresh)
    on["on"] = False
    if meta.route != "wavefront" or len(parts) != 1 or len(spec_rows) != 1:
        raise AssertionError(f"residents RI: route {meta.route}, {len(parts)} syncs")
    rec = parts[0]
    seen = {"old_n": rec["old_n"], "n": rec["n"], "misses": rec["misses"],
            "dirty_columns": int(rec["dirty"].shape[0])}
    if rec["n"] <= rec["old_n"] or rec["misses"] != 4:
        raise AssertionError(f"residents RI: not a grow with 4 misses ({seen})")
    from kubernetes_tpu_torch.ops import partials as pops

    sp = spec_rows[0]
    leaves = [(f, getattr(sp["specs"], f), 1 if f in pops.SPEC_AX1 else 0, sp["idx"],
               sp["rows"][f]) for f in pops.ClassSpecs._fields]
    return {"RI": partials_case(rec, seen),
            "SP": {"kind": "mirror", "leaves": leaves, "seen": seen}}


def partials_indices(case: dict, torch):
    """(missed slots, the columns every slot re-evaluates: dirty and grown,
    grown alone, dirty alone) as ascending int32 tensors on the card."""
    import numpy as np

    grown = np.arange(case["old_n"], case["n"], dtype=np.int32)
    cols = np.union1d(case["dirty"], grown).astype(np.int32)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).cuda()
    return up(case["miss"]), up(cols), up(grown), up(case["dirty"])


def partials_want(case: dict, torch) -> tuple:
    """The reference's order on CPU copies (the plain versions): grow,
    refresh the grown columns, insert the missed slots, refresh the dirty
    columns; or every slot over every column."""
    import numpy as np

    from kubernetes_tpu_torch.ops import partials as pops

    cpu = lambda x: type(x)(*(t.cpu() for t in x))
    st, specs, cl = cpu(case["store"]), cpu(case["specs"]), cpu(case["cluster"])
    if case["full"]:
        return tuple(pops.eval_store(cl, specs))
    old_n, n = case["old_n"], case["n"]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))
    if n > old_n:
        st = pops.refresh_rows(pops.grow_store_cols(st, n - old_n), specs, cl,
                               t(np.arange(old_n, n)))
    elif n < old_n:
        st = pops.shrink_store_cols(st, n)
    if case["miss"].shape[0]:
        st = pops.insert_slots(st, specs, cl, t(case["miss"]))
    if case["dirty"].shape[0]:
        st = pops.refresh_rows(st, specs, cl, t(case["dirty"]))
    return tuple(st)


def mirror_want(case: dict, torch) -> tuple:
    """clone + index_copy_ a leaf, on CPU copies."""
    import numpy as np

    out = []
    for _f, src, ax, idx, vals in case["leaves"]:
        v = np.asarray(vals)
        v = v.view(np.int32) if v.dtype == np.uint32 else v
        out.append(src.cpu().clone().index_copy_(ax, torch.from_numpy(idx).long(),
                                                 torch.from_numpy(np.ascontiguousarray(v))))
    return tuple(out)


def device_ops(step, torch) -> dict:
    """The device operations one call of step() enqueues (torch.profiler,
    CUDA activity): kernels, device-to-device copies, host-to-device
    copies, memsets; None where the profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    counts = {"kernels": 0, "dtod": 0, "htod": 0, "memset": 0, "names": []}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name
        key = ("dtod" if "DtoD" in name else "htod" if "HtoD" in name else
               "memset" if "Memset" in name else "kernels")
        counts[key] += 1
        counts["names"].append(name[:60])
    if not counts["names"]:
        return None
    return counts


RESIDENT_SHAPES = ("R", "R500", "VR", "RI", "U500", "S64", "VM", "SP")


def time_resident_kernels(warm, verify, dv, dv_wrappers, TorchBatchScheduler, pops, bindings,
                          torch) -> tuple:
    """partials_eval at R (every entry), R500 (500 columns), VR (a
    PreemptionBasic verify's sync, captured in the preemption phase) and
    RI (the crossing with 4 new classes: grow, misses, dirty columns) and
    mirror_rows at U500, S64, VM (the same verify's delta) and SP (RI's
    spec insert), each launch equal to the plain version exactly (the
    reference's order / clone + index_copy_ on CPU copies) with the old
    store or leaves byte-unchanged after it, and timed: events over
    back-to-back calls, the card alone behind a spin and the host clock
    of the call (launch_ms); mirror_rows beside the library call, clone +
    index_copy_ a leaf.  Then the plain-torch gather, the mirror's grow
    and the packed copy.  Returns (kernel rows, plain-torch rows)."""
    cases = dict(affinity_cases(warm, torch))
    cases.update(verify_cases(verify))
    cases.update(crossing_cases(dv_wrappers, TorchBatchScheduler, torch))
    stage = dv.PinnedStage()
    rows = []
    for shape in RESIDENT_SHAPES:
        case = cases[shape]
        if case["kind"] == "partials":
            miss, cols, _grown, _dirty = partials_indices(case, torch)
            cl, specs = case["cluster"], case["specs"]
            old = None if case["full"] else case["store"]
            slots = miss if miss.numel() else None
            cols = cols if cols.numel() else None
            want = partials_want(case, torch)
            inputs = () if old is None else tuple(old)
            reset = lambda: None
            kern = lambda old=old, cl=cl, specs=specs, slots=slots, cols=cols: tuple(
                pops.update_store(old, specs, cl, slots, cols))
            plain = lambda old=old, cl=cl, specs=specs, slots=slots, cols=cols: tuple(
                pops.update_store_plain(old, specs, cl, slots, cols))
            d_all = case["n"] if case["full"] else (0 if cols is None else int(cols.numel()))
            need = partials_update_need(cl, specs, 0 if case["full"] else case["old_n"],
                                        case["n"], d_all, int(miss.numel()), torch)
            name, lib_ms = "partials_eval", None
            what = (f"{specs.valid.shape[0]} slots, {case['old_n']} -> {case['n']} columns, "
                    f"{int(miss.numel())} missed, {int(case['dirty'].shape[0])} dirty")
        else:
            targets = [dv.RowTarget(src, ax, idx, vals)
                       for _f, src, ax, idx, vals in case["leaves"]]
            want = mirror_want(case, torch)
            inputs = tuple(t.src for t in targets)
            box = {"pack": dv.pack_rows(targets, stage, "cuda")}

            def reset(targets=targets, box=box):
                box["pack"] = dv.pack_rows(targets, stage, "cuda")

            kern = lambda box=box: tuple(bindings.mirror_rows(box["pack"]))
            plain = lambda box=box, targets=targets: tuple(dv.set_rows_plain(box["pack"],
                                                                             targets))
            idx_dev = [torch.from_numpy(t.idx).long().cuda() for t in targets]
            vals_dev = [torch.from_numpy(dv._canon(t.vals).copy()).cuda() for t in targets]

            def library(targets=targets, idx_dev=idx_dev, vals_dev=vals_dev):
                return tuple(t.src.clone().index_copy_(t.axis, i, v)
                             for t, i, v in zip(targets, idx_dev, vals_dev))

            need = mirror_rows_need(case["leaves"])
            name = "mirror_rows"
            lib_ms = cuda_ms(library, 20, torch)
            check_equal(f"clone + index_copy_ ({shape})", library(), want, torch)
            what = (f"{len(targets)} leaves x {int(targets[0].idx.shape[0])} rows, "
                    f"{sum(int(v.nbytes) for *_r, v in case['leaves'])} B packed")
        before = [t.clone() for t in inputs]
        err = check_equal(f"{name} ({shape})", kern(), want, torch)
        check_equal(f"{name} ({shape}, the plain version)", plain(), want, torch)
        ms = cuda_ms(kern, 50, torch)
        card_ms, host_ms = launch_ms(kern, reset, 50, torch)
        if not all(torch.equal(t, b) for t, b in zip(inputs, before)):
            raise AssertionError(f"{name} ({shape}): an old store or leaf changed")
        bms, by = bound(*need)
        rows.append({"name": name, "shape": f"{shape}: {what}", "max_abs_err": err, "ms": ms,
                     "card_ms": card_ms, "host_ms": host_ms,
                     "plain_ms": time_plain(plain, torch), "bound_ms": bms, "bound_by": by,
                     "library_ms": lib_ms, "seen": case.get("seen")})
    # one warm delta sync's device operations at VR + VM: the mirror's
    # launch and the store's (their index lists uploaded beforehand)
    vr, vm = cases["VR"], cases["VM"]
    miss, cols, _g, _d = partials_indices(vr, torch)
    vm_pack = dv.pack_rows([dv.RowTarget(src, ax, idx, vals)
                            for _f, src, ax, idx, vals in vm["leaves"]], stage, "cuda")
    rows.append({"name": "device_ops", "shape": "VR + VM", "ops": device_ops(lambda: (
        bindings.mirror_rows(vm_pack),
        pops.update_store(vr["store"], vr["specs"], vr["cluster"],
                          miss if miss.numel() else None, cols if cols.numel() else None)),
        torch)})
    cl = warm._mirror.sync()
    n = cl.allocatable.shape[0]
    from kubernetes_tpu_torch.models import mirror as mirror_mod
    # plain torch on the card, timed: the gather at the last warm batch's
    # class count, the mirror's in-place grow of the cluster leaves to the
    # next bucket (the store's grow is inside partials_eval's launch), and
    # a batch's fill shortcut plus packed copy
    c_dim = warm.metas[-1].statics.sfeas.shape[0]
    slots = torch.zeros(c_dim, dtype=torch.int32, device="cuda")
    store = warm._partials._store
    extra = {"gather_statics": {"ms": cuda_ms(lambda: pops.gather_statics(store, slots), 50, torch),
                                "classes": c_dim, "bound_ms": bound(2 * c_dim * n * 9, 0.0)[0],
                                "bound_by": "bytes", "route": "plain torch (index_select)",
                                "library_ms": cuda_ms(lambda: store.aff.index_select(
                                    0, slots.long()), 50, torch)}}
    extra["grow_rows"] = {"ms": cuda_ms(lambda: [mirror_mod._grow_rows(
        getattr(cl, f), n, 0, 1 if f == "taint_bits" else 0) for f in cl._fields], 20, torch),
        "bound_ms": bound(3 * nbytes(*cl), 0.0)[0], "bound_by": "bytes",
        "route": "plain torch (cat, 14 leaves)"}
    batch = affinity_pods(dv_wrappers, AFFINITY_BATCH, "put")
    snap, meta = warm.builder.build_from_state(warm.state, batch)
    warm._annotate(snap, meta)
    snap = snap._replace(cluster=cl)

    def put():
        s = dv.device_fill_shortcut(snap, warm._fill_cache, "cuda", features=meta.features)
        return dv.packed_device_put(s, stage, "cuda")

    put_ms = time_plain(put, torch)
    put_ms = min(put_ms, *(time_plain(put, torch) for _ in range(4)))
    extra["fill_shortcut_and_put"] = {"ms": put_ms, "bytes": stage.bytes_sent,
                                      "bound_ms": bound(stage.bytes_sent, 0.0)[0],
                                      "bound_by": "bytes", "route": "one pinned copy (host clock)"}
    return rows, extra


# ---- slice carve-outs, the extender, the proto service -----------------------

def run_slice_kernels(snap, features, n_groups, cfg, assign, filters, bindings, torch,
                      timed: bool = False):
    """The scan route of a slice batch, kernel by kernel against the plain
    versions on the same inputs, exact: match_terms, class_statics and
    greedy_scan with its carve-out stage and carry (run_kernels; the scan's
    plain version on CPU copies), then slice_stats over the scan's
    post-release usage and final carry (its plain version on the card).
    With timed=True returns the summary rows of greedy_scan and
    slice_stats."""
    from kubernetes_tpu_torch.ops import slices as slices_ops

    rows = run_kernels(snap, features, n_groups, cfg, assign, filters, bindings, torch,
                       timed=timed)
    args = slice_stats_args(snap, features, n_groups, cfg, assign, bindings)
    final, pods, _assignment, gang = args[:4]

    def kern():
        return bindings.slice_stats(*args)

    def plain():
        return slices_ops.carve_stats_plain(*args)

    err = check_equal("slice_stats", kern(), plain(), torch)
    if not timed:
        return []
    bms, by = bound(*slice_stats_need(final, pods, gang, features, torch))
    card_ms, host_ms = launch_ms(kern, lambda: None, 50, torch)
    stats_row = {"name": "slice_stats", "max_abs_err": err, "ms": cuda_ms(kern, 50, torch),
                 "card_ms": card_ms, "host_ms": host_ms,
                 "plain_ms": time_plain(plain, torch), "bound_ms": bms, "bound_by": by}
    return [r for r in rows if r["name"] == "greedy_scan"] + [stats_row]


def slice_stats_args(snap, features, n_groups, cfg, assign, bindings) -> tuple:
    """slice_stats' arguments after a slice batch's scan on the card: (the
    post-release cluster, pods, assignment, the final carve-out carry or
    None, features, n_groups)."""
    cluster, pods, sfeas, aff, taint, sp_args, tm_args, extra = assign._solver_prep(
        snap, features, cfg=cfg)
    out = bindings.greedy_scan(cluster, pods, sfeas, aff, taint, assign.solve_order(pods),
                               features, n_groups, cfg, sp_args, tm_args, extra)
    final = cluster._replace(requested=out[4], nonzero_requested=out[5])
    gang = out[11:14] if len(out) > 11 else None
    return final, pods, out[0], gang, features, n_groups


def slice_stats_edges(bindings, torch) -> list:
    """Kernel slice_stats on seeded synthetic tables against its plain
    version on CPU copies, exact: 8,192 nodes over 160 slices of extent up
    to 16 (a block's cells past its shared memory: the grid in global
    memory), random coordinates, usage and validity, 512 pods in 40 gangs
    with random shapes, assignments and carve-out carry; and the same
    without the carry."""
    import numpy as np
    from types import SimpleNamespace as NS

    from kubernetes_tpu_torch.ops import slices as slices_ops
    from kubernetes_tpu_torch.ops.schema import RESOURCE_PODS

    rng = np.random.default_rng(19)
    n, z, d, p, g = 8192, 160, 16, 512, 40
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    sid = rng.integers(-1, z, n).astype(np.int32)
    ext = rng.integers(1, d + 1, (z, 3)).astype(np.int32)
    requested = np.zeros((n, RESOURCE_PODS + 1), np.float32)
    requested[:, RESOURCE_PODS] = rng.random(n) < 0.3
    cluster = NS(node_valid=t(rng.random(n) < 0.95), slice_id=t(sid),
                 torus_coords=t(rng.integers(-1, d, (n, 4)).astype(np.int32)),
                 slice_dims=t(np.where(rng.random((n, 1)) < 0.9, ext[np.maximum(sid, 0)],
                                       rng.integers(0, d + 1, (n, 3))).astype(np.int32)),
                 requested=t(requested))
    pods = NS(valid=t(rng.random(p) < 0.9), group_id=t(rng.integers(-1, g, p).astype(np.int32)),
              pod_shape=t(rng.integers(0, 3, (p, 3)).astype(np.int32)))
    assignment = t(rng.integers(-1, n, p).astype(np.int32))
    gang = (t(rng.integers(-1, z, g).astype(np.int32)), t(rng.integers(0, d, (g, 3)).astype(np.int32)),
            t(rng.random(g) < 0.5))
    features = NS(slice_z=z, slice_dim=d)
    card = lambda ns: NS(**{k: v.cuda() for k, v in vars(ns).items()})
    rows = []
    for label, carry, n_groups in (("carry", gang, g), ("no_carry", None, 0)):
        got = bindings.slice_stats(card(cluster), card(pods), assignment.cuda(),
                                   tuple(x.cuda() for x in carry) if carry else None, features,
                                   n_groups)
        want = slices_ops.carve_stats_plain(cluster, pods, assignment, carry, features, n_groups)
        err = check_equal(f"slice_stats ({label})", got, want, torch)
        rows.append({"case": label, "nodes": n, "slices": z, "slice_dim": d, "gangs": n_groups,
                     "frag_score": float(want[0]), "max_abs_err": err})
    return rows


def slice_stats_need(cluster, pods, gang, features, torch) -> tuple:
    """(bytes, operations) of slice_stats on this data: per node its
    validity, slice id, coordinates, extent and RESOURCE_PODS usage; per
    pod its assignment, validity, group and shape; the gang carry; four
    scalars out.  Operations: the grid (one scatter a node), the integral
    (three prefix passes over S (D+1)^3 cells) and the cube sweep (eight
    gathers and a compare for every corner, edge and slice)."""
    n, p = cluster.allocatable.shape[0], pods.req.shape[0]
    z, d = features.slice_z, features.slice_dim
    need = n * (1 + 4 + 16 + 12 + 4) + p * (4 + 1 + 4 + 12) + 16
    if gang is not None:
        need += nbytes(*gang)
    ops = n + 3 * z * (d + 1) ** 3 + 9 * z * d * d ** 3 + 10 * p
    return need, float(ops)


def run_evaluate_single(snap, features, cfg, assign, bindings, torch, timed: bool = False):
    """Kernel evaluate_single (its filter stage, then its score stage, with
    class_extras between them on the filter's feasible row; for a pod
    without an extra row also the fused launch, against the two stages)
    against its plain versions on the same card inputs, exact; the whole
    entry point evaluate_single on the card against the plain path on a
    CPU copy.  Returns (feas, masked) and, timed, the kernel's summary row:
    the entry point's launches (one fused, or the two stages), with the
    host clock around the same calls beside the CUDA-event time."""
    topo_z = assign.required_topo_z(snap) if assign.needs_topo(features) else 1
    cluster, pods, sel, pref = snap[:4]
    reps = torch.zeros(1, dtype=torch.int32, device=cluster.allocatable.device)
    check_statics("class_statics (one pod)", snap, reps, assign, bindings, torch, on_cpu=True)
    sfeas, aff, taint, sel_mask = bindings.class_statics(cluster, pods, sel, pref, reps,
                                                         want_sel_mask=features.spread)
    sp_args = assign.spread_prep(snap, sel_mask, features, topo_z)
    tm_args = assign.terms_prep(snap, features, topo_z)

    def k_filter():
        return bindings.evaluate_single_filter(cluster, pods, sfeas[0], features, sp_args, tm_args)

    stage1 = k_filter()
    check_equal("evaluate_single (filter)", stage1,
                assign.single_filter_plain(cluster, pods, sfeas[0], features, sp_args, tm_args),
                torch)
    feas, feas_sp, bonus = stage1
    extra = assign.extras_prep(snap, features, cfg, reps, feas[None], topo_z)
    extra = extra[0] if extra is not None else None

    def k_score():
        return bindings.evaluate_single_score(cluster, pods, feas, feas_sp, bonus, aff[0],
                                              taint[0], extra, features, cfg, sp_args)

    def plain_score():
        return assign.single_score_plain(cluster, pods, feas, feas_sp, bonus, aff[0], taint[0],
                                         extra, features, cfg, sp_args)

    masked = k_score()
    err = check_equal("evaluate_single (score)", (masked,), (plain_score(),), torch)
    fused = extra is None

    def k_fused():
        return bindings.evaluate_single_fused(cluster, pods, sfeas[0], aff[0], taint[0],
                                              features, cfg, sp_args, tm_args)

    if fused:
        check_equal("evaluate_single (fused against its two stages)", k_fused(),
                    (feas, feas_sp, bonus, masked), torch)
    whole = assign.evaluate_single(snap, cfg, topo_z, features)
    check_equal("evaluate_single (card against the plain path on the CPU)", whole,
                assign.evaluate_single(cpu_copy(snap), cfg, topo_z, features), torch)
    if not timed:
        return whole, None

    def kern():
        if fused:
            return k_fused()
        k_filter()
        return k_score()

    def plain():
        assign.single_filter_plain(cluster, pods, sfeas[0], features, sp_args, tm_args)
        return plain_score()

    n, r = cluster.allocatable.shape
    need = n * (1 + 3 * r * 4 + 2 * 4 + 1 + 4) + nbytes(pods.req[0], pods.nonzero_req[0])
    if extra is not None:
        need += n * 4
    bms, by = bound(need, float(n * (2 * r + 60)))
    ms, host_ms = cuda_host_ms(kern, 200, torch)
    row = {"name": "evaluate_single", "max_abs_err": err, "ms": ms, "host_ms": host_ms,
           "device_ms": graph_ms(kern, 20, 10, torch), "launches_a_call": 1 if fused else 2,
           "plain_ms": time_plain(plain, torch), "bound_ms": bms, "bound_by": by}
    if extra is not None:   # the extra row's kernel between the stages, timed alone
        row["extras_row"] = run_class_extras(snap, features, cfg, reps, feas[None], assign,
                                             bindings, torch, timed=True)["row"]
    return whole, row


def overlay_parity(wrappers, TorchBatchScheduler, torch) -> None:
    """The reservations overlay on the card against the CPU: several
    nominated pods whose memory requests are not whole MiB on one node
    already past float32's exact range (4.5e9 bytes of 100M requests), two
    on another; the overlaid usage and every result field equal.  Also
    records whether one plain index_add on the card would have matched
    (the order the overlay replaces)."""
    import numpy as np

    got = {}
    for dev in ("cuda", "cpu"):
        sched = TorchBatchScheduler(device=dev, mode="greedy", use_wavefront=False)
        for i in range(4):
            sched.add_node(wrappers.make_node(f"ov-{i}")
                           .capacity(cpu_milli=64000, mem=64 * wrappers.GI, pods=110).obj())
        for k in range(45):
            sched.assume(wrappers.make_pod(f"ov-bound-{k}").req(cpu_milli=10, mem=100_000_000)
                         .obj(), "ov-0")
        nominated = [("ov-0", wrappers.make_pod(f"ov-nom-{k}")
                      .req(cpu_milli=10, mem=100_000_000 + 4099 * k).obj()) for k in range(12)]
        nominated += [("ov-1", wrappers.make_pod(f"ov-nom-x{k}").req(cpu_milli=10, mem=123_456_789)
                       .obj()) for k in range(2)]
        pods = [wrappers.make_pod(f"ov-p-{i}").req(cpu_milli=100, mem=100_000_000).obj()
                for i in range(16)]
        snap, _meta = sched.encode_pending(pods, reservations=nominated)
        names = sched.schedule_pending(pods, reservations=nominated)
        got[dev] = (snap.cluster.requested.cpu(), snap.cluster.nonzero_requested.cpu(), names,
                    result_fields(sched.last_result, True))
        if dev == "cuda":
            rows = [sched.state._rows[n] for n, _p in nominated]
            vals = np.stack([sched.builder.pod_usage(p, sched.state._r)[0] for _n, p in nominated])
            base = snap.cluster.requested.new_tensor(sched.state.tensors().requested)
            naive = base.index_add(0, torch.tensor(rows, device=base.device),
                                   torch.from_numpy(vals).to(base.device)).cpu()
    if got["cuda"][2] != got["cpu"][2]:
        raise AssertionError("overlay: card and CPU placements differ")
    check_equal("reservations overlay (card against CPU)", got["cuda"][:2], got["cpu"][:2], torch)
    check_equal("overlay batch (card against CPU)", got["cuda"][3], got["cpu"][3], torch)
    emit({"phase": "overlay", "reservations": 14, "past_exact_range": True, "equal_cpu": True,
          "naive_index_add_equal_cpu": bool(torch.equal(naive, got["cpu"][0]))})


def slices_phase(wrappers, TorchBatchScheduler, assign, filters, dv, bindings, torch, card):
    """bench.py's c10 at full width through TorchBatchScheduler(
    carveout_policy=...) on the card and on the CPU in lockstep, both
    policies: every round equal field for field, on the scan; the
    kernels at the c10 shape; the randomized slice cases, a multi-core
    coordinate case and slice_stats_edges against the plain versions."""
    from kubernetes_tpu_torch.ops import schema
    from kubernetes_tpu_torch.ops import slices as slices_ops
    from kubernetes_tpu_torch.ops.scores import DEFAULT_SCORE_CONFIG
    from kubernetes_tpu_torch.testing import cases

    checked = 0
    for seed in range(6):
        nodes, pods, bound_pods, _p = cases.random_slice_objects(wrappers, seed)
        snap, _m = schema.SnapshotBuilder().build(nodes, pods, bound_pods=bound_pods)
        for policy in ("prefer", "require"):
            f = assign.features_of(snap, slice_policy=policy)
            ts = dv.to_device(snap, "cuda")
            run_slice_kernels(ts, f, schema.num_groups(snap), DEFAULT_SCORE_CONFIG, assign, filters,
                              bindings, torch)
            one, _m1 = schema.SnapshotBuilder().build(nodes, pods[:1], bound_pods=bound_pods)
            run_evaluate_single(dv.to_device(one, "cuda"),
                                assign.features_of(one, slice_policy=policy), DEFAULT_SCORE_CONFIG,
                                assign, bindings, torch)
            checked += 1
    # several nodes on one coordinate (LABEL_TPU_CORE): a coordinate is
    # free only when every core on it is
    mc_nodes = [cases.slice_node(wrappers, f"mc{s}", x, y, 0, (2, 2, 1), core=c)
                for s in range(2) for y in range(2) for x in range(2) for c in range(2)]
    mc_bound = [wrappers.make_pod("mc-b0").req(cpu_milli=100).node_name("mc0-000c1").obj(),
                wrappers.make_pod("mc-b1").req(cpu_milli=100).node_name("mc1-110").obj()]
    mc_pods = (cases.gang(wrappers, "mc-g0", 2, "2x1x1") + cases.gang(wrappers, "mc-g1", 4, "2x2x1")
               + cases.gang(wrappers, "mc-g2", 2, "1x2x1"))
    snap, _m = schema.SnapshotBuilder().build(mc_nodes, mc_pods, bound_pods=mc_bound)
    for policy in ("prefer", "require"):
        run_slice_kernels(dv.to_device(snap, "cuda"), assign.features_of(snap, slice_policy=policy),
                          schema.num_groups(snap), DEFAULT_SCORE_CONFIG, assign, filters, bindings, torch)
        checked += 1
    edges = slice_stats_edges(bindings, torch)

    out = {"phase": "slices", "workload": "c10 slice packing (bench.py config10)",
           "nodes": 64 * 64, "slices": 64, "slice_dims": "4x4x4", "rounds": C10_ROUNDS,
           "pods_per_round": 208, "gangs_per_round": 26, "parity_cases": checked,
           "slice_stats_edges": edges,
           "gates": {"contiguous_rate_min": C10_CONTIG_MIN, "frag_score_final_max": C10_FRAG_MAX},
           "policies": {}, "card": card}
    launches_all = {}
    timed_snap = None
    for policy in ("prefer", "require"):
        pair = {"cuda": TorchBatchScheduler(carveout_policy=policy),
                "cpu": TorchBatchScheduler(device="cpu", carveout_policy=policy)}
        churn = {d: cases.SliceChurn(wrappers) for d in pair}
        live = {d: [] for d in pair}
        for d, s in pair.items():
            for node in churn[d].nodes():
                s.add_node(node)
        stats = {"completed": 0, "contiguous": 0, "fallbacks": 0, "carveouts": 0,
                 "placed": 0, "arrived": 0}
        frags, round_walls = [], {}

        def run():
            for r in range(C10_ROUNDS):
                names = c10_round(pair, churn, live, r, torch, round_walls)
                card_s, cpu_s = pair["cuda"], pair["cpu"]
                if card_s.metas[-1].route != "greedy":
                    raise AssertionError(f"slices/{policy} round {r}: route "
                                         f"{card_s.metas[-1].route}")
                if names["cuda"] != names["cpu"]:
                    raise AssertionError(f"slices/{policy} round {r}: card and CPU names differ")
                check_equal(f"slices/{policy} round {r} (card against CPU)",
                            result_fields(card_s.last_result, True),
                            result_fields(cpu_s.last_result, False), torch)
                ds, dc = card_s.last_solve, cpu_s.last_solve
                tele = tuple(getattr(ds, f) for f in ("frag_score", "carveouts",
                                                      "contiguous_gangs", "carveout_fallbacks"))
                if tele != tuple(getattr(dc, f) for f in ("frag_score", "carveouts",
                                                          "contiguous_gangs",
                                                          "carveout_fallbacks")):
                    raise AssertionError(f"slices/{policy} round {r}: telemetry differs")
                stats["arrived"] += len(names["cuda"])
                stats["placed"] += sum(n is not None for n in names["cuda"])
                stats["carveouts"] += tele[1]
                stats["contiguous"] += tele[2]
                stats["fallbacks"] += tele[3]
                stats["completed"] += tele[2] + tele[3]
                frags.append(tele[0])

        _, launches = drive_phase(f"slices/{policy}", run, bindings, [pair["cuda"]])
        walls, cpu_walls = round_walls["cuda"], round_walls["cpu"]
        for k, v in launches.items():
            launches_all[k] = launches_all.get(k, 0) + v
        final = slices_ops.fragmentation_report(pair["cuda"].state.tensors())
        if final != slices_ops.fragmentation_report(pair["cpu"].state.tensors()):
            raise AssertionError(f"slices/{policy}: final fragmentation differs")
        rate = stats["contiguous"] / max(stats["completed"], 1)
        out["policies"][policy] = {
            **stats, "contiguous_rate": rate, "frag_score_per_round": frags,
            "frag_score_final": final["score"],
            "meets_gates": rate >= C10_CONTIG_MIN and final["score"] <= C10_FRAG_MAX,
            "round_s": walls, "round_s_min": min(walls), "cpu_round_s": cpu_walls,
            "pods_per_s": 208 / min(walls), "launches": launches, "equal_cpu": True}
        if policy == "prefer":
            timed_snap = pair["cuda"].encode_pending(churn["cuda"].round_pods(C10_ROUNDS))
    snap, meta = timed_snap
    rows = run_slice_kernels(snap, meta.features, meta.n_groups, DEFAULT_SCORE_CONFIG, assign, filters,
                             bindings, torch, timed=True)
    out["kernels_c10"] = rows
    emit(out)
    return rows, launches_all


def c10_round(scheds, churns, lives, r, torch, walls=None) -> dict:
    """Round r of c10 on each scheduler (the three dicts keyed alike, "cuda"
    for the card's): from the second round on, half the live gangs leave
    first (seed 10); then the round's 208 pods are scheduled and every
    placement assumed.  Returns each scheduler's names; with `walls`,
    appends each schedule_pending's seconds under its key."""
    names = {}
    for d, s in scheds.items():
        if r:
            for members in churns[d].depart(lives[d]):
                for pod, _n in members:
                    s.forget(pod)
        pods = churns[d].round_pods(r)
        if d == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        names[d] = s.schedule_pending(pods)
        if walls is not None:
            walls.setdefault(d, []).append(time.perf_counter() - t)
        for pod, n in zip(pods, names[d]):
            if n is not None:
                s.assume(pod, n)
        lives[d].extend(churns[d].placed_gangs(pods, names[d]))
    return names


def c10_timed_snapshot(wrappers, TorchBatchScheduler, torch, policy: str = "prefer",
                       gangs: bool = True):
    """Shape C: c10's pending batch after its six rounds on the card (the
    slices phase's timed batch), as (snapshot, meta); with gangs=False
    (C0) the same pods each alone (no scheduling group: shaped pods, no
    gang, no carve-out carry)."""
    from kubernetes_tpu_torch.testing import cases

    sched = {"cuda": TorchBatchScheduler(carveout_policy=policy)}
    churn = {"cuda": cases.SliceChurn(wrappers)}
    live = {"cuda": []}
    for node in churn["cuda"].nodes():
        sched["cuda"].add_node(node)
    for r in range(C10_ROUNDS):
        c10_round(sched, churn, live, r, torch)
    pods = churn["cuda"].round_pods(C10_ROUNDS)
    if not gangs:
        for pod in pods:
            pod.spec.scheduling_group = None
            pod.spec.scheduling_group_size = None
    return sched["cuda"].encode_pending(pods)


def _pod_json(name, labels=None, image="", spec=None):
    d = {"metadata": {"name": name, "namespace": "default", "labels": labels or {}},
         "spec": {"containers": [{"name": "c", "image": image, "resources": {"requests": {
             "cpu": f"{POD_CPU_MILLI}m", "memory": f"{POD_MEM_MI}Mi"}}}]}}
    d["spec"].update(spec or {})
    return d


def extender_phase(wrappers, TorchBatchScheduler, assign, dv, bindings, torch, card):
    """SchedulingBasic/5000Nodes behind the HTTP extender: 5,000
    node-default nodes and 1,000 bound pod-default pods in a card backend
    (served on 127.0.0.1) and a CPU backend fed alike; EXTENDER[2]
    filter + prioritize pairs in nodeCacheCapable mode over HTTP, every
    response equal to the CPU backend's; then variant pods (spread, soft
    spread, anti-affinity, preferred affinity, image) over HTTP and a
    shaped pod on a c10 slice cluster under both policies.  Each window's
    launch counters are read: match_terms, class_statics and
    evaluate_single (one a request: the fused launch), class_extras for the
    variants."""
    import json
    import urllib.request

    from kubernetes_tpu_torch.extender import ExtenderBackend, ExtenderServer
    from kubernetes_tpu_torch.extender.types import ExtenderArgs
    from kubernetes_tpu_torch.ops import filters
    from kubernetes_tpu_torch.ops.scores import DEFAULT_SCORE_CONFIG
    from kubernetes_tpu_torch.testing import cases

    n_nodes, n_bound, n_req = EXTENDER
    backends = {}
    for dev in ("cuda", "cpu"):
        be = ExtenderBackend(TorchBatchScheduler(device=dev))
        for node in make_cluster(wrappers, n_nodes):
            be.add_node(node)
        for i, pod in enumerate(make_pods(wrappers, n_bound, "ext-bound")):
            be.tpu.state.add_pod(pod, f"node-{(i * 7) % n_nodes}")
        backends[dev] = be
    names = [f"node-{i}" for i in range(n_nodes)]
    srv = ExtenderServer(backends["cuda"]).start()
    url = f"http://127.0.0.1:{srv.port}"

    def post(verb, body):
        req = urllib.request.Request(url + "/" + verb, data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req) as r:
            return json.load(r)

    def exchange(bodies):
        return [(b, post("filter", b), post("prioritize", b)) for b in bodies]

    def check(tag, got):
        for body, f, p in got:
            args = ExtenderArgs.from_dict(body)
            want_f = json.loads(json.dumps(backends["cpu"].filter(args)))
            want_p = json.loads(json.dumps(backends["cpu"].prioritize(args)))
            if f != want_f or p != want_p:
                raise AssertionError(f"extender/{tag}: {body['Pod']['metadata']['name']} differs "
                                     "from the CPU backend")
            if f["Error"]:
                raise AssertionError(f"extender/{tag}: {f['Error']}")
    try:
        bodies = [{"Pod": _pod_json(f"ext-req-{i}"), "Nodes": None, "NodeNames": names}
                  for i in range(n_req)]
        torch.cuda.synchronize()
        bindings.reset_launches()
        t0 = time.perf_counter()
        got = exchange(bodies)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        basic_launches = dict(bindings.LAUNCHES)
        check_launches("extender", basic_launches, {"class_statics", "evaluate_single"})
        # a request's cold statics prep is one class_statics launch, no match_terms
        for k in ("evaluate_single", "class_statics"):
            if basic_launches[k] != 2 * n_req:
                raise AssertionError(f"extender: {k} launched {basic_launches[k]} times for "
                                     f"{2 * n_req} requests")
        check("basic", got)
        placed = sum(len(f["NodeNames"]) for _b, f, _p in got)
        # variant pods over HTTP: the families evaluate_single covers
        for dev, be in backends.items():
            for k in range(8):
                be.add_node(wrappers.make_node(f"img-{k}")
                            .capacity(cpu_milli=NODE_CPU_MILLI, mem=NODE_MEM_GI * wrappers.GI,
                                      pods=NODE_PODS).zone(f"zone-{k % ZONES}")
                            .image("app:v1", 700 * wrappers.MI).obj())
            for i, pod in enumerate(wrappers.make_pod(f"ext-a-{i}").label("app", "a")
                                    .req(cpu_milli=100).obj() for i in range(40)):
                be.tpu.state.add_pod(pod, f"node-{(i * 37) % n_nodes}")
        sel = {"labelSelector": {"matchLabels": {"app": "a"}}}
        variants = {
            "spread": _pod_json("ext-spread", {"app": "a"}, spec={"topologySpreadConstraints": [
                dict(sel, maxSkew=1, topologyKey="topology.kubernetes.io/zone",
                     whenUnsatisfiable="DoNotSchedule")]}),
            "soft_spread": _pod_json("ext-soft", {"app": "a"}, spec={"topologySpreadConstraints": [
                dict(sel, maxSkew=2, topologyKey="topology.kubernetes.io/zone",
                     whenUnsatisfiable="ScheduleAnyway")]}),
            "anti_affinity": _pod_json("ext-anti", {"app": "a"}, spec={"affinity": {
                "podAntiAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [
                    dict(sel, topologyKey="kubernetes.io/hostname")]}}}),
            "preferred_affinity": _pod_json("ext-pref", spec={"affinity": {"podAffinity": {
                "preferredDuringSchedulingIgnoredDuringExecution": [{
                    "weight": 10, "podAffinityTerm": dict(sel, topologyKey=(
                        "topology.kubernetes.io/zone"))}]}}}),
            "image": _pod_json("ext-image", image="app:v1"),
        }
        all_names = names + [f"img-{k}" for k in range(8)]
        bindings.reset_launches()
        got = exchange([{"Pod": v, "Nodes": None, "NodeNames": all_names}
                        for v in variants.values()])
        # a shaped pod on a c10 slice cluster (its shape rides the pod
        # object, not the v1 JSON): the backends' verbs under the default
        # policy, and evaluate_single under both
        churn = cases.SliceChurn(wrappers)
        slice_pair = {}
        for dev in ("cuda", "cpu"):
            be = ExtenderBackend(TorchBatchScheduler(device=dev))
            for node in churn.nodes():
                be.add_node(node)
            for i, pod in enumerate(churn.round_pods(0)[:40]):
                be.tpu.state.add_pod(pod, f"s{i % 64:02d}-{i % 4}{(i // 4) % 4}0")
            slice_pair[dev] = be
        shaped = wrappers.make_pod("ext-shaped").req(cpu_milli=100).obj()
        shaped.spec.tpu_topology = "2x2x2"
        slice_names = [n.meta.name for n in churn.nodes()]
        args = ExtenderArgs(shaped, node_names=slice_names)
        slice_out = {dev: (be.filter(args), be.prioritize(args)) for dev, be in slice_pair.items()}
        if slice_out["cuda"] != slice_out["cpu"] or slice_out["cuda"][0]["Error"]:
            raise AssertionError("extender/shaped: card and CPU verbs differ")
        policies = {}
        for policy in ("prefer", "require"):
            be = slice_pair["cuda"]
            snap, _m = be.tpu.builder.build_from_state(be.tpu.state, [shaped])
            f = assign.features_of(snap, slice_policy=policy)
            (feas, scores), _row = run_evaluate_single(dv.to_device(snap, "cuda"), f,
                                                       DEFAULT_SCORE_CONFIG, assign, bindings, torch)
            policies[policy] = {"feasible": int(feas.sum()),
                                "best": float(scores.max())}
        torch.cuda.synchronize()
        variant_launches = dict(bindings.LAUNCHES)
        check_launches("extender/variants", variant_launches,
                       {"class_statics", "evaluate_single", "class_extras", "family_prep"})
        check("variants", got)
        # family_prep on each variant's snapshot as the card backend builds
        # it: exact, one device operation a call, its scratch zero after it
        variant_family = {}
        be = backends["cuda"]
        for vname, body in variants.items():
            vpod = ExtenderArgs.from_dict({"Pod": body, "Nodes": None,
                                          "NodeNames": all_names}).pod
            vsnap, _m = be.tpu.builder.build_from_state(be.tpu.state, [vpod])
            vf = assign.features_of(vsnap)
            if vf.spread or vf.interpod or vf.interpod_pref:
                variant_family[vname] = sorted(check_family(
                    f"extender/{vname}", dv.to_device(vsnap, "cuda"), vf,
                    assign.required_topo_z_split(vsnap), filters, bindings, torch,
                    count_ops=True))
        if not {"spread", "anti_affinity", "preferred_affinity"} <= set(variant_family):
            raise AssertionError(f"extender/variants: family_prep checked on {variant_family}")
        # the timed kernel at SchedulingBasic/5000Nodes (8,192 padded nodes)
        be = backends["cuda"]
        snap, _m = be.tpu.builder.build_from_state(be.tpu.state,
                                                    [ExtenderArgs.from_dict(bodies[0]).pod])
        _whole, row = run_evaluate_single(dv.to_device(snap, "cuda"), assign.features_of(snap),
                                          DEFAULT_SCORE_CONFIG, assign, bindings, torch, timed=True)
        # E+: the same with a preferred inter-pod term (an extra row: the
        # two stages), timed too
        _whole, row_plus = run_evaluate_single(
            *single_snapshot(wrappers, TorchBatchScheduler, True), DEFAULT_SCORE_CONFIG, assign,
            bindings, torch, timed=True)
    finally:
        srv.stop()
    emit({"phase": "extender", "workload": "SchedulingBasic/5000Nodes behind the extender",
          "nodes": n_nodes, "bound_pods": n_bound, "requests": 2 * n_req,
          "padded_nodes": int(snap.cluster.allocatable.shape[0]), "wall_s": wall,
          "requests_per_s": 2 * n_req / wall, "feasible_per_filter": placed / n_req,
          "variants": sorted(variants), "variant_family_prep": variant_family,
          "shaped": {"nodes": len(slice_names), **policies},
          "equal_cpu": True, "launches": basic_launches, "variant_launches": variant_launches,
          "card": card})
    extras_plus = row_plus.pop("extras_row")
    return (dict(row, shape="E", launches=basic_launches["evaluate_single"]),
            dict(row_plus, shape="E+", launches=variant_launches["evaluate_single"]),
            dict(extras_plus, shape="E+", launches=variant_launches["class_extras"]))


def proto_phase(wrappers, torch, bindings, card):
    """One SolveRequest of PROTO[1] pod-default pods onto PROTO[0]
    node-default nodes (a fifth of them with current usage) over the
    socket to the card's ProtoSchedulerServer; the response equals the CPU
    backend's (but for solve_seconds); the batch pads to 1,024 pods: the
    auction, cold (every request is a fresh scheduler)."""
    from kubernetes_tpu_torch.extender.protoserver import (
        ProtoBackend, ProtoSchedulerServer, solve_over_socket,
    )
    from kubernetes_tpu_torch.proto import snapshot_pb2 as pb

    n_nodes, n_pods = PROTO
    mi, gi = wrappers.MI, wrappers.GI
    req = pb.SolveRequest()
    req.cluster.resources.names.extend(["cpu", "memory", "pods"])
    req.cluster.allocatable.rows, req.cluster.allocatable.cols = n_nodes, 3
    req.cluster.requested.rows, req.cluster.requested.cols = n_nodes, 3
    for i in range(n_nodes):
        req.cluster.node_names.append(f"node-{i}")
        req.cluster.allocatable.data.extend([float(NODE_CPU_MILLI), float(NODE_MEM_GI * gi),
                                             float(NODE_PODS)])
        used = i % 5 == 0
        req.cluster.requested.data.extend([1000.0 if used else 0.0, float(2 * gi) if used else 0.0,
                                           3.0 if used else 0.0])
    req.pods.requests.rows, req.pods.requests.cols = n_pods, 3
    for i in range(n_pods):
        req.pods.pod_names.append(f"proto-{i}")
        req.pods.requests.data.extend([float(POD_CPU_MILLI), float(POD_MEM_MI * mi), 1.0])
        req.pods.priorities.append(i % 3)
    srv = ProtoSchedulerServer(ProtoBackend()).start()
    try:
        solve_over_socket("127.0.0.1", srv.port, req)   # the process's first batch
        torch.cuda.synchronize()
        bindings.reset_launches()
        t0 = time.perf_counter()
        resp = solve_over_socket("127.0.0.1", srv.port, req)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = dict(bindings.LAUNCHES)
    finally:
        srv.stop()
    check_launches("proto", launches, set(ROUTE_KERNELS["auction"]))
    check_cold_preps("proto", launches, 1)
    check_auction_launches("proto", launches, 1)
    want = ProtoBackend(device="cpu").solve(req)
    got = pb.SolveResponse()
    got.CopyFrom(resp)
    got.solve_seconds = want.solve_seconds = 0.0
    if got != want:
        raise AssertionError("proto: the card's response differs from the CPU backend's")
    placed = sum(1 for a in resp.assignments if a.node_name)
    emit({"phase": "proto", "nodes": n_nodes, "pods": n_pods, "placed": placed,
          "round_trip_s": wall, "solve_seconds": resp.solve_seconds,
          "pods_per_s": n_pods / wall, "route": "auction", "equal_cpu": True,
          "launches": launches, "card": card})


# ---- preemption ----------------------------------------------------------------

# a PostFilter pass's kernels: one binding call, these two launches
# (match_terms none: pod_filters evaluates the selector rows itself)
PREEMPT_KERNELS = ("pod_filters", "preempt_dry_run")


def preemption_setup(TorchBatchScheduler, nodes, victims, preemptors, pdbs=(), **kw):
    """A scheduler (TorchBatchScheduler(**kw)), its cache and a
    PreemptionEvaluator with a store behind it: the nodes and the victims
    accounted as bound pods, the preemptors and budgets in the store."""
    from kubernetes_tpu_torch.api.store import Store
    from kubernetes_tpu_torch.scheduler.cache import SchedulerCache
    from kubernetes_tpu_torch.scheduler.metrics import Registry
    from kubernetes_tpu_torch.scheduler.preemption import PreemptionEvaluator

    sched = TorchBatchScheduler(**kw)
    store = Store()
    for node in nodes:
        sched.add_node(node)
        store.create(node)
    for v in victims:
        sched.assume(v, v.spec.node_name)
        store.create(v)
    for obj in list(preemptors) + list(pdbs):
        store.create(obj)
    cache = SchedulerCache(sched.state)
    return sched, cache, PreemptionEvaluator(sched, cache, store, Registry())


def result_key(res):
    if res is None:
        return None
    return (res.nominated_node, sorted(v.meta.name for v in res.victims))


def preemption_cycle(sched, cache, ev, pods):
    """One scheduling cycle of measured pods as the reference's loop drives
    it (kubernetes_tpu/scheduler/scheduler.py:1511-1549): the batch solves
    with the other pods' nominations as reservations; its failed pods,
    highest priority first and at most PREEMPT_PASS, go to one PostFilter
    pass (preempt_batch in a shared pass); the nominees then solve with the
    others' reservations, each must land on its nominated node, and is
    assumed there.  Returns (the pass's results, the pass's record)."""
    from kubernetes_tpu_torch.scheduler.queue import pod_key

    names = sched.schedule_pending(
        pods, reservations=cache.nominations_excluding({pod_key(p) for p in pods}))
    failed = []
    for pod, name in zip(pods, names):
        if name is None:
            failed.append(pod)
        else:
            cache.assume(pod, name)
    failed = sorted(failed, key=lambda p: -p.spec.priority)[:PREEMPT_PASS]
    mark = len(sched.metas)
    t0 = time.perf_counter()
    with ev.shared_pass(failed) as ctx:
        results = ev.preempt_batch(failed)
    pass_s = time.perf_counter() - t0
    split = {}
    for meta in sched.metas[mark:]:
        for k, v in meta.encode_split.items():
            split[k] = split.get(k, 0.0) + v
    rec = {"pods": len(failed), "pass_s": pass_s,
           "verify_solves": len(sched.metas) - mark, "verify_encode_split": split,
           "fallback": ctx.fallback, "empty": ctx.empty, **ctx.timings,
           "nominated": sum(r is not None for r in results)}
    if not (ctx.fallback or ctx.empty):
        # the pass's device inputs and the dry run's need, for the Q rows
        rec["inputs"] = ctx.inputs
        rec["need_dry"] = dry_run_need(ctx, failed)
        rec["live"] = (len(ctx.nodes), len(ctx.index))
    nominees = [(p, r.nominated_node) for p, r in zip(failed, results) if r is not None]
    if nominees:
        keys = {pod_key(p) for p, _ in nominees}
        got = sched.schedule_pending([p for p, _ in nominees],
                                     reservations=cache.nominations_excluding(keys))
        for (pod, node), name in zip(nominees, got):
            if name != node:
                raise AssertionError(f"preemption: nominee {pod.meta.name} landed on {name}, "
                                     f"nominated to {node}")
            cache.assume(pod, name)
    check_capacity(sched.state)
    return results, rec


def preemption_basic(wrappers, TorchBatchScheduler, dims, **kw):
    """PreemptionBasic at `dims` (nodes, victims, measured pods) set up on
    TorchBatchScheduler(**kw).  Returns (scheduler, cache, evaluator,
    measured pods)."""
    from kubernetes_tpu_torch.testing.cases import preemption_basic_objects

    nodes, victims, preemptors = preemption_basic_objects(wrappers, *dims)
    return (*preemption_setup(TorchBatchScheduler, nodes, victims, preemptors, **kw), preemptors)


def preemption_run(sched, cache, ev, preemptors, n_cycles):
    """`n_cycles` cycles of PREEMPT_PASS measured pods.  Returns (result
    keys in preemptor order, the pass records, the surviving accounted
    pods, seconds)."""
    keys, recs = [], []
    t0 = time.perf_counter()
    for c in range(n_cycles):
        batch = preemptors[c * PREEMPT_PASS:(c + 1) * PREEMPT_PASS]
        results, rec = preemption_cycle(sched, cache, ev, batch)
        keys.extend(result_key(r) for r in results)
        recs.append(rec)
    wall = time.perf_counter() - t0
    return keys, recs, sorted(sched.state._pod_node.items()), wall


def pass_inputs(ev, failed):
    """(batch, snap) a shared PostFilter pass over `failed` encoded: the
    dry-run's tables and the static snapshot of the pass's preemptors."""
    with ev.shared_pass(failed) as ctx:
        if ctx.fallback or ctx.empty:
            raise AssertionError("a pass fell back or encoded no victim")
        return ctx.inputs


def preempt_shape(wrappers, TorchBatchScheduler, shape: str) -> tuple:
    """(kind, inputs) of a timed preemption shape on the card:
    Q   ("pass", (batch, snap)): PreemptionBasic/5000Nodes' first pass, 16
        preemptors (8,192 padded candidate nodes, K 4, L 1);
    K   ("pass", (batch, snap)): c9's batched pass (32,768 padded, L 4);
    K1  ("static_row", snap): one preemptor's static snapshot on c9's
        cluster, the classic walk's call (_encode_static);
    V   ("victims", (free, victim_req, victim_valid, pod_req)): the per-pod
        dry-run of `faults` step 8 (PreemptionBasic/500Nodes after one
        pass, the next preemptor);
    S64 ("full", snap): 64 pod-default pods at SchedulingBasic/5000Nodes
        (the Filter chain's full mode, nan_parity's healthy snapshot)."""
    from kubernetes_tpu_torch.scheduler.queue import pod_key
    from kubernetes_tpu_torch.testing.cases import c9_objects

    if shape == "Q":
        sched, cache, ev, pods = preemption_basic(wrappers, TorchBatchScheduler, PREEMPT)
        batch = pods[:PREEMPT_PASS]
        names = sched.schedule_pending(
            batch, reservations=cache.nominations_excluding({pod_key(p) for p in batch}))
        failed = sorted([p for p, n in zip(batch, names) if n is None],
                        key=lambda p: -p.spec.priority)
        return "pass", pass_inputs(ev, failed)
    if shape in ("K", "K1"):
        nodes, victims, failed, pdb = c9_objects(wrappers, *C9)
        _s, cache, ev = preemption_setup(TorchBatchScheduler, nodes, victims, failed, [pdb])
        if shape == "K":
            return "pass", pass_inputs(ev, failed)
        with cache.lock:
            return "static_row", ev._encode_static(failed[0])
    if shape == "V":
        sched, cache, ev, pods = preemption_basic(wrappers, TorchBatchScheduler, PREEMPT_SMALL)
        preemption_cycle(sched, cache, ev, pods[:PREEMPT_PASS])
        got = ev._classic_inputs(pods[PREEMPT_PASS])
        if got is None:
            raise AssertionError("V: no per-pod candidate for the next preemptor")
        return "victims", tuple(ev._victim_tables(*got))
    if shape == "S64":
        cold = fault_cluster(wrappers, TorchBatchScheduler, use_mirror=False)
        snap, _meta = cold.encode_pending(make_pods(wrappers, FAULT_BATCH, "nan"))
        return "full", snap
    raise ValueError(f"no preemption shape {shape}")


def dry_run_need(ctx, pods) -> tuple:
    """(bytes, operations) of one batched dry-run on this pass's data, live
    rows only: each live node's free row, each victim's requests, the live
    levels' orders, flags and bounds and the live pods' requests read once;
    the three [P, N] outputs written once; two operations (mask, add) a
    (level, victim, resource) and two (add, compare) a (pod, node, k,
    resource) that the first-fit walk reached."""
    import numpy as np

    from kubernetes_tpu_torch.scheduler.queue import pod_key

    n, p = len(ctx.nodes), len(ctx.index)
    levels = len(ctx.level_of)
    v = sum(len(vs) for vs in ctx.victims)
    r = ctx.free.shape[1]
    need = 4 * r * n + 4 * r * v + levels * (5 * v + 4 * n) + p * (4 * r + 4) + p * n * 9
    lvl = np.zeros(p, dtype=np.int64)
    for pod in pods:
        i = ctx.index.get(pod_key(pod))
        if i is not None:
            lvl[i] = ctx.level_of[pod.spec.priority]
    bound = np.minimum(ctx.elig_len[lvl, :n], ctx.perm.shape[2])
    walked = np.where(ctx.feasible, ctx.min_k, bound) + 1
    return need, float(2 * levels * v * r + 2 * r * int(walked.sum()))


def pod_filters_need(snap, n: int, p: int, torch, pods=None, full: bool = False) -> tuple:
    """(bytes, operations) of kernel pod_filters on this data, live rows
    only: each live node's validity, name and NoSchedule / NoExecute taint
    words, and the label words and topology ids that the named selector
    rows' valid expressions test, read once; those rows and each pod's
    fields read once, the [P, N] mask written once; about 4 operations a
    taint word and 6 more a (pod, node), two a (row, node, tested id).
    In full mode also each live node's allocatable, requested and port
    words and each pod's requests and ports; 2 operations a (pod, node,
    resource), one a (pod, node, port word)."""
    cl, sel = snap.cluster, snap.selectors
    pods = snap.pods if pods is None else pods
    tw = cl.taint_bits.shape[2]
    si = pods.sel_idx[:p]
    used = torch.unique(torch.clamp(si[si >= 0], max=sel.term_valid.shape[0] - 1))
    tab = (sel.expr_ids[used], sel.expr_op[used], sel.expr_slot[used], sel.term_valid[used])
    words, topo, ids = _live_ids(*tab, torch)
    node_words = int(torch.unique(words).numel()) + int(torch.unique(topo).numel())
    need = (n * (1 + 4 + 2 * 4 * tw) + n * 4 * node_words + nbytes(*tab)
            + p * (1 + 4 + 4 + 2 * 4 * tw + 2) + p * n)
    ops = float(p * n * (4 * 2 * tw + 6) + n * ids * 2)
    if full:
        r = cl.allocatable.shape[1]
        pw = cl.port_bits.shape[1]
        need += n * (2 * 4 * r + 4 * pw) + p * (4 * r + 4 * pw)
        ops += float(p * n * (2 * r + pw))
    return need, ops


def preempt_row(name: str, shape: str, call, want, plain, need, torch, launches=None,
                iters: int = 50) -> dict:
    """A preemption kernel's summary row at one shape: its binding call
    checked against the plain versions' result `want`, the card's time of
    the call alone (launch_ms: events behind a spin) and its host clock,
    the plain versions' host time, the bound of `need` (bytes,
    operations)."""
    got = call()
    err = check_equal(f"{name} ({shape})", got if isinstance(got, tuple) else (got,), want,
                      torch)
    ms, host_ms = launch_ms(call, lambda: None, iters, torch)
    b_ms, b_by = bound(*need)
    row = {"name": name, "shape": shape, "max_abs_err": err, "ms": ms, "host_ms": host_ms,
           "plain_ms": min(time_plain(plain, torch) for _ in range(3)), "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": None, "need_bytes": need[0], "need_ops": need[1]}
    if launches is not None:
        row["launches"] = launches
    return row


# the victim slots the parity batches hold: the scheduler's, then the edges
# of the kernel's blocks of 16, its chunks of 256 and its widest axis
PARITY_K = (4, 20, 64, 128, 300, 256, 257, 513, 4096)
# (K, levels, lanes) of batches with more rows than the card's resident
# warps: nodes doubled from 512 until a row gets at most that many lanes
# (bindings.dry_run_lanes), so rows of 16, 8 and 4 lanes run (K 300: two
# chunks)
PARITY_NARROW = ((4, 3, 4), (20, 3, 8), (64, 1, 16), (300, 2, 8))


def preemption_parity(wrappers, filters, bindings, torch) -> None:
    """preempt_dry_run and pod_filters against their plain versions on the
    card, exact: batched dry-runs with K in PARITY_K victim slots
    (not-whole-MiB memory, elig_len 0, 1, K - 1, K and past the slots, rows
    where nothing fits, PDB reorders, +inf free and +inf junk, L up to 3,
    40 pods — two pod groups — at K 257 and 513), the victims entry on the
    same victims with masks that are not prefixes (bounds 0, 1, K - 1, K),
    the Filter chain in both modes with its selector rows on the mixed
    parity snapshots, and the pass's one binding call.  Also records
    whether torch.cumsum would have summed the victims as the reference
    does."""
    from kubernetes_tpu_torch.ops import device as dv
    from kubernetes_tpu_torch.ops import preemption as pre
    from kubernetes_tpu_torch.ops.schema import SnapshotBuilder
    from kubernetes_tpu_torch.testing.cases import (dry_run_edges, dry_run_inputs,
                                                     mixed_objects, victim_masks)

    dev = torch.device("cuda")
    cases, cumsum_equal, checked = [], [], 0
    batches = []
    shapes = [(k, 128 if k == 4096 else 512, (1, 3, 3, 3, 2, 2, 3, 2, 1)[i])
              for i, k in enumerate(PARITY_K)]
    for k, levels, lanes in PARITY_NARROW:
        n = 512
        while bindings.dry_run_lanes(levels, n, k, 4) > lanes:
            n *= 2
        shapes.append((k, n, levels))
    for seed, (k, n, levels) in enumerate(shapes):
        pods = 40 if k in (257, 513) else 16
        inputs = dry_run_edges(dry_run_inputs(seed, n=n, k=k, r=4, levels=levels, pods=pods,
                                              frac=seed > 0), seed)
        batch = pre.PreemptionBatch(*(torch.from_numpy(a).to(dev) for a in inputs))
        batches.append(batch)
        got = bindings.batched_dry_run(*batch)
        check_equal(f"preempt_dry_run (seed {seed}, K {k})", got,
                    pre.batched_dry_run_plain(batch), torch)
        l, r = batch.perm.shape[0], batch.victim_req.shape[2]
        ordered = torch.gather(batch.victim_req[None].expand(l, n, k, r), 2,
                               batch.perm.long()[..., None].expand(l, n, k, r))
        mask = torch.arange(k, device=dev)[None, None, :] < batch.elig_len[..., None]
        x = torch.nan_to_num(ordered * mask[..., None].to(torch.float32), posinf=0.0, nan=0.0)
        cumsum_equal.append(bool(torch.equal(torch.cumsum(x, 2), pre._cumsum(x, 2))))
        valid = torch.from_numpy(victim_masks(seed, n, k)).to(dev)
        for p in range(0, pods, 5):
            args = (batch.free, batch.victim_req, valid, batch.pods_req[p])
            check_equal(f"preempt_dry_run victims entry (seed {seed}, K {k}, pod {p})",
                        bindings.dry_run_victims(*args), pre.dry_run_victims_plain(*args),
                        torch)
            checked += 1
        cases.append({"seed": seed, "k": k, "levels": levels, "pods": pods, "nodes": n,
                      "row_lanes": bindings.dry_run_lanes(levels, n, k, 4),
                      "victims_row_lanes": bindings.dry_run_lanes(1, n, k, 4),
                      "feasible": int(got[0].sum()), "min_k_max": int(got[1].max())})
        checked += 1
    for seed in range(6):
        nodes, pods, bound = mixed_objects(wrappers, seed)
        snap, _ = SnapshotBuilder().build(nodes, pods, bound_pods=bound)
        snap = dv.to_device(snap, dev)
        sel = snap.selectors
        mask = filters.match_rows_plain(snap.cluster, sel.expr_ids, sel.expr_op, sel.expr_slot,
                                        sel.term_valid)
        for full in (False, True):
            check_equal(f"pod_filters (mixed seed {seed}, full {full})",
                        (bindings.pod_filters(snap.cluster, snap.pods, sel, full),),
                        (filters.filter_rows_plain(snap.cluster, snap.pods, mask, full),), torch)
            checked += 1
        # the pass's one binding call: a dry-run batch beside this snapshot
        batch = batches[seed % len(batches)]
        check_equal(f"preemption_pass (mixed seed {seed})",
                    bindings.preemption_pass(batch, snap.cluster, snap.pods, sel),
                    (*pre.batched_dry_run_plain(batch),
                     filters.filter_rows_plain(snap.cluster, snap.pods, mask, False)), torch)
        checked += 1
    lanes = {c["row_lanes"] for c in cases} | {c["victims_row_lanes"] for c in cases}
    if not {4, 8, 16, 32} <= lanes:
        raise AssertionError(f"preemption_parity: rows of {sorted(lanes)} lanes, not 4-32")
    emit({"phase": "preemption_parity", "checked": checked, "dry_run_cases": cases,
          "equal": True, "torch_cumsum_equal_block_order": cumsum_equal})


def pass_rows(shape: str, batch, snap, need_dry, live, filters, pre, bindings, torch,
              launches: dict) -> tuple:
    """The pass's kernels at one shape against their plain versions, each
    call timed alone (preempt_row): preempt_dry_run's batched entry and
    pod_filters' static mode with its selector rows; and the pass's one
    binding call (bindings.preemption_pass), the card alone and its host
    clock.  Returns (the two rows, the pass's times)."""
    sel = snap.selectors
    mask = filters.match_rows_plain(snap.cluster, sel.expr_ids, sel.expr_op, sel.expr_slot,
                                    sel.term_valid)
    static = lambda: filters.filter_rows_plain(snap.cluster, snap.pods, mask, False)
    dry = lambda: pre.batched_dry_run_plain(batch)
    want_static = (static(),)
    want_dry = tuple(dry())
    n_live, p_live = live
    rows = [
        preempt_row("preempt_dry_run", shape, lambda: bindings.batched_dry_run(*batch),
                    want_dry, dry, need_dry, torch, launches["preempt_dry_run"]),
        preempt_row("pod_filters", shape,
                    lambda: bindings.pod_filters(snap.cluster, snap.pods, sel, False),
                    want_static, static, pod_filters_need(snap, n_live, p_live, torch), torch,
                    launches["pod_filters"]),
    ]
    one = lambda: bindings.preemption_pass(batch, snap.cluster, snap.pods, sel)
    check_equal(f"preemption_pass ({shape})", one(), (*want_dry, *want_static), torch)
    ms, host_ms = launch_ms(one, lambda: None, 50, torch)
    return rows, {"ms": ms, "host_ms": host_ms, "launches_a_call": 2}


def c9_planning(wrappers, TorchBatchScheduler, filters, bindings, torch, card) -> list:
    """bench.py's c9 frozen-trace planning (bench.py:1087-1120) on the card:
    20,000 nodes with one victim each (32,768 padded), the zero-budget PDB
    on every fourth, 16 preemptors over 3 priority levels.  The shared
    batched pass and the classic per-pod walk must plan alike; both are
    timed, with their launches (a pass: pod_filters and preempt_dry_run
    once, match_terms never; the walk: both once a preemptor), and the
    kernels are timed at this shape (K) against their plain versions with
    the bound of their work, pod_filters also on the walk's one-pod static
    row (K1).  Returns the kernels' rows."""
    from kubernetes_tpu_torch.ops import preemption as pre
    from kubernetes_tpu_torch.testing.cases import c9_objects

    nodes, victims, failed, pdb = c9_objects(wrappers, *C9)
    t0 = time.perf_counter()
    sched, cache, ev = preemption_setup(TorchBatchScheduler, nodes, victims, failed, [pdb])
    setup_s = time.perf_counter() - t0

    def plan_key(got):
        if got is None:
            return None
        cands, ranked, min_k = got
        _row, name, vs, _ = cands[ranked[0]]
        return name, [v.meta.name for v in vs[: int(min_k[ranked[0]])]]

    with ev.shared_pass(failed):                    # first use of every shape
        [plan_key(ev._candidates(p)) for p in failed]
    plan_key(ev._candidates_classic(failed[0]))
    torch.cuda.synchronize()
    bindings.reset_launches()
    t0 = time.perf_counter()
    with ev.shared_pass(failed) as ctx:
        batched = [plan_key(ev._candidates(p)) for p in failed]
        torch.cuda.synchronize()
        t_batched = time.perf_counter() - t0
        if ctx.fallback or ctx.empty:
            raise AssertionError("c9: the batched pass fell back or encoded nothing")
        batch, snap = ctx.inputs
        timings = dict(ctx.timings)
        need_dry = dry_run_need(ctx, failed)
        live = (len(ctx.nodes), len(ctx.index))
    launches_b = dict(bindings.LAUNCHES)
    bindings.reset_launches()
    t0 = time.perf_counter()
    classic = [plan_key(ev._candidates_classic(p)) for p in failed]
    torch.cuda.synchronize()
    t_classic = time.perf_counter() - t0
    launches_c = dict(bindings.LAUNCHES)
    if batched != classic or any(k is None for k in batched):
        raise AssertionError("c9: the batched plans differ from the classic per-pod plans")
    for what, launches, want in (("batched", launches_b, 1), ("classic", launches_c, len(failed))):
        check_launches(f"c9/{what}", launches, set(PREEMPT_KERNELS))
        if any(launches[k] != want for k in PREEMPT_KERNELS):
            raise AssertionError(f"c9/{what}: launches {launches}, {want} each expected")
    guarded = sum(1 for _node, vs in batched if int(vs[0].split("-")[1]) % 4 == 0)
    if guarded:
        raise AssertionError(f"c9: {guarded} plans evict a PDB-guarded victim")

    # the kernels at this shape (K), and the walk's one-pod static row (K1)
    rows, pass_k = pass_rows("K", batch, snap, need_dry, live, filters, pre, bindings, torch,
                             launches_b)
    with cache.lock:
        one = ev._encode_static(failed[0])
    pod1 = filters._pod_rows(filters.pod_view(one.pods, 0))
    sel1 = one.selectors
    mask1 = filters.match_rows_plain(one.cluster, sel1.expr_ids, sel1.expr_op, sel1.expr_slot,
                                     sel1.term_valid)
    row1 = lambda: filters.filter_rows_plain(one.cluster, pod1, mask1, False)
    rows.append(preempt_row("pod_filters", "K1",
                            lambda: bindings.pod_filters(one.cluster, pod1, sel1, False),
                            (row1(),), row1, pod_filters_need(one, live[0], 1, torch, pods=pod1),
                            torch, launches_c["pod_filters"]))
    rows[-1].update(entry="the classic walk's static row (_static_row_from_snap)",
                    replaces="kubernetes_tpu/ops/filters.py:166")
    emit({"phase": "c9", "nodes": C9[0], "padded_nodes": int(batch.free.shape[0]),
          "preemptors": C9[1], "levels": int(batch.perm.shape[0]),
          "victim_slots": int(batch.perm.shape[2]),
          "row_lanes": bindings.dry_run_lanes(*batch.perm.shape, int(batch.free.shape[1])),
          "plans_equal": True, "setup_s": setup_s,
          "batched_s": t_batched, "classic_s": t_classic,
          "speedup": t_classic / t_batched, "pass_split": timings, "pass_call": pass_k,
          "launches_batched": {k: launches_b[k] for k in PREEMPT_KERNELS + ("match_terms",)},
          "launches_classic": {k: launches_c[k] for k in PREEMPT_KERNELS + ("match_terms",)},
          "kernels": rows, "card": card})
    return rows


def preemption_phase(wrappers, TorchBatchScheduler, filters, bindings, torch, card) -> dict:
    """PreemptionBasic through TorchBatchScheduler on the card: 5,000 nodes
    (warm; the first PREEMPT_COLD preemptors also through use_mirror=False,
    equal), /500Nodes card against the CPU, then c9's planning trace.
    Returns the launch counts of the 5,000-node run and the kernels' rows
    (Q: the first pass's inputs; c9's K and K1)."""
    from kubernetes_tpu_torch.ops import preemption as pre

    cycles = PREEMPT_MEASURED // PREEMPT_PASS
    t0 = time.perf_counter()
    sched, cache, ev, pods = preemption_basic(wrappers, TorchBatchScheduler, PREEMPT)
    setup_s = time.perf_counter() - t0
    # the first pass's verify solves' resident syncs: time_resident_kernels'
    # VR and VM
    verify = hook_first_pass(sched, ev)
    # the measured cycles, and one more past the reference's candidate cap
    (keys, recs, pod_node, wall), launches = drive_phase(
        "preemption", lambda: preemption_run(sched, cache, ev, pods, cycles + 1), bindings,
        [sched], extra=PREEMPT_KERNELS)
    passes = len(recs)
    if (launches["preempt_dry_run"] != passes or launches["pod_filters"] != passes
            or launches["match_terms"]):
        raise AssertionError(f"preemption: {passes} passes, launches {launches}")
    if any(r["fallback"] or r["empty"] for r in recs):
        raise AssertionError("preemption: a pass fell back or encoded no victim")
    measured = keys[:PREEMPT_MEASURED]
    for i, key in enumerate(measured):
        if key is None or len(key[1]) != 3:
            raise AssertionError(f"preemption: preemptor {i} got {key}, not three victims")
    if len({k[0] for k in measured}) != len(measured):
        raise AssertionError("preemption: two preemptors nominated to one node")
    # the reference's candidate cap (MAX_CANDIDATES nodes are listed before
    # the fit test): once every listed node holds a nominee, no later
    # preemptor of this cluster finds a feasible candidate
    stalled = keys[PREEMPT_MEASURED:]
    if any(k is not None for k in stalled):
        raise AssertionError(f"preemption: past the candidate cap a preemptor got {stalled}")

    # warm against cold over the first PREEMPT_COLD preemptors
    runs = {}
    for label, kw in (("cold", {"use_mirror": False}), ("warm", {})):
        s, c, e, p = preemption_basic(wrappers, TorchBatchScheduler, PREEMPT, **kw)
        runs[label] = preemption_run(s, c, e, p, PREEMPT_COLD // PREEMPT_PASS)
    if (runs["cold"][0] != keys[:PREEMPT_COLD] or runs["warm"][0] != runs["cold"][0]
            or runs["warm"][2] != runs["cold"][2]):
        raise AssertionError("preemption: warm and cold results differ")

    small = {}
    for dev in ("cuda", "cpu"):
        s, c, e, p = preemption_basic(wrappers, TorchBatchScheduler, PREEMPT_SMALL, device=dev)
        small[dev] = preemption_run(s, c, e, p, -(-PREEMPT_SMALL[2] // PREEMPT_PASS))
    if small["cuda"][0] != small["cpu"][0] or small["cuda"][2] != small["cpu"][2]:
        raise AssertionError("PreemptionBasic/500Nodes: card and CPU differ")
    if any(k is None for k in small["cuda"][0]):
        raise AssertionError("PreemptionBasic/500Nodes: a preemptor found no victims")
    done = [r for r in recs if r["nominated"]]

    def mean(key):
        return sum(r[key] for r in done) / len(done)

    # the verify solves' host encode, per preemptor (encode_pending's split)
    verify_split = {k: sum(r["verify_encode_split"].get(k, 0.0) for r in done) / len(measured)
                    for k in done[0]["verify_encode_split"]}

    emit({"phase": "preemption", "workload": "PreemptionBasic/5000Nodes",
          "nodes": PREEMPT[0], "victims": PREEMPT[1], "measured": PREEMPT_MEASURED,
          "setup_s": setup_s, "passes": passes, "preempted": len(measured),
          "stall_pass": {"pods": len(stalled), "pass_s": recs[-1]["pass_s"]},
          "wall_s": wall, "preempted_per_s": len(measured) / wall,
          "pass_s": mean("pass_s"), "encode_s": mean("encode_s"),
          "dispatch_s": mean("dispatch_s"),
          "verify_solves_per_preemptor": sum(r["verify_solves"] for r in done) / len(measured),
          "verify_encode_split_per_preemptor": verify_split,
          "warm_equal_cold_preemptors": PREEMPT_COLD, "launches": launches,
          "small": {"workload": "PreemptionBasic/500Nodes", "equal_cpu": True,
                    "preempted": len(small["cuda"][0]), "card_s": small["cuda"][3],
                    "cpu_s": small["cpu"][3]},
          "card": card})
    q = recs[0]
    q_rows, q_pass = pass_rows("Q", *q["inputs"], q["need_dry"], q["live"], filters, pre,
                               bindings, torch, launches)
    emit({"phase": "preemption_kernels", "workload": "PreemptionBasic/5000Nodes, the first "
          "pass", "padded_nodes": int(q["inputs"][0].free.shape[0]),
          "victim_slots": int(q["inputs"][0].perm.shape[2]),
          "row_lanes": bindings.dry_run_lanes(*q["inputs"][0].perm.shape,
                                              int(q["inputs"][0].free.shape[1])),
          "kernels": q_rows, "pass_call": q_pass, "card": card})
    rows = c9_planning(wrappers, TorchBatchScheduler, filters, bindings, torch, card)
    return {"launches": launches, "rows": q_rows + rows, "verify": verify}


# ---- faults: degraded mode on the card ---------------------------------------

# batches the host fallback solves are cut to FAULT_BATCH pods: the Oracle
# evaluates one pod at a time in Python (~0.09 s a pod at 5,000 nodes)
FAULT_BATCH = 64
# the resident phase's bucket crossing: 5,000 + 3,193 nodes move the padded
# node axis from 8,192 to 16,384 rows
GROW_NODES = 3193


def fault_cluster(wrappers, TorchBatchScheduler, **kw):
    """SchedulingBasic/5000Nodes on TorchBatchScheduler(**kw): 5,000
    node-default nodes and 1,000 pod-default pods accounted as bound."""
    s = TorchBatchScheduler(**kw)
    for node in make_cluster(wrappers, MAIN[0]):
        s.add_node(node)
    for i, pod in enumerate(make_pods(wrappers, MAIN[1], "init")):
        s.assume(pod, f"node-{i % MAIN[0]}")
    return s


def assume_all(scheds, pods, names) -> None:
    for s in scheds:
        for pod, name in zip(pods, names):
            if name is not None:
                s.assume(pod, name)


def breaker_state(s) -> dict:
    b = s.breaker
    return {"state": b.state, "trips": b.trips, "probes": b.probes,
            "fallbacks": b.fallback_count()}


def expect(what: str, cond: bool, detail="") -> None:
    if not cond:
        raise AssertionError(f"faults/{what}: {detail}")


def expect_unhealthy(what: str, ds, unhealthy) -> None:
    """The decode of `ds` raises `unhealthy` (SolveUnhealthy)."""
    try:
        ds.names()
    except unhealthy:
        return
    raise AssertionError(f"faults/{what}: the health check did not trip")


def poisoned_solve(what, sched, pods, reg, faults, assign, auction, torch):
    """Encode and dispatch `pods` with `reg` armed; hold the card solve's
    outputs against the plain path on CPU copies of the same (poisoned)
    inputs, NaN for NaN; check every placed pod's node is a row of the
    snapshot.  Returns (the DeviceSolve, its meta, the NaN count of the
    scores)."""
    with faults.armed(reg):
        snap, meta = sched.encode_pending(pods)
        ds = sched.solve_encoded_async(snap, meta)
    got = result_fields(ds.result, True)
    want = solve_route(meta.route, cpu_copy(snap), meta, assign, auction, sched.score_config,
                       statics=cpu_args(meta.statics, torch))
    check_equal(f"{what} (poisoned solve, card against the plain path on the CPU)", got,
                result_fields(want, False), torch)
    n = snap.cluster.allocatable.shape[0]
    a = got[0][: meta.num_pods]
    expect(what, bool(((a >= -1) & (a < n)).all()), "an assignment outside the node rows")
    return ds, meta, int(torch.isnan(got[1][: meta.num_pods]).sum())


def nan_parity(wrappers, TorchBatchScheduler, assign, auction, filters, dv, bindings, torch):
    """Step 0: the solve kernels against their plain versions on a
    SchedulingBasic/5000Nodes snapshot (64 pods) whose allocatable is +inf
    (mirror.grow CORRUPT's poison: every feasible score NaN), NaN for NaN:
    the scan (with match_terms and class_statics), the wavefront, the
    auction's kernels round by round and their round loop, and
    evaluate_single on one pod.  Also times pod_filters' full mode
    (feasible_batch) on the healthy snapshot."""
    from kubernetes_tpu_torch.ops import schema
    from kubernetes_tpu_torch.ops.scores import DEFAULT_SCORE_CONFIG as cfg

    cold = fault_cluster(wrappers, TorchBatchScheduler, use_mirror=False)
    pods = make_pods(wrappers, FAULT_BATCH, "nan")
    snap, meta = cold.encode_pending(pods)
    expect("nan_parity", meta.route == "wavefront", f"route {meta.route}")
    inf = snap._replace(cluster=snap.cluster._replace(
        allocatable=torch.full_like(snap.cluster.allocatable, float("inf"))))
    run_kernels(inf, meta.features, meta.n_groups, cfg, assign, filters, bindings, torch)
    cluster, tpods, sfeas, aff, taint, sp_args, tm_args, extra = assign._solver_prep(
        inf, meta.features, cfg=cfg)
    m = torch.as_tensor(meta.wave_plan.members, dtype=torch.int32, device="cuda")
    got = bindings.wavefront(cluster, tpods, sfeas, aff, taint, m, meta.features,
                             meta.n_groups, cfg, sp_args, tm_args, extra)
    want = assign.wavefront_assign_plain(
        *cpu_args((cluster, tpods, sfeas, aff, taint, m, meta.features), torch),
        meta.n_groups, cfg, *cpu_args((sp_args, tm_args, extra), torch))
    check_equal("wavefront (+inf allocatable)", got, want, torch)
    scan_nan = int(torch.isnan(bindings.greedy_scan(
        cluster, tpods, sfeas, aff, taint, assign.solve_order(tpods), meta.features,
        meta.n_groups, cfg, sp_args, tm_args, extra)[1]).sum())
    rounds = run_auction(inf, cfg, None, auction, bindings, torch, cpu_snap=cpu_copy(inf))
    one_np, _m = schema.SnapshotBuilder().build(make_cluster(wrappers, MAIN[0]), pods[:1])
    one = dv.to_device(one_np, "cuda")
    one = one._replace(cluster=one.cluster._replace(
        allocatable=torch.full_like(one.cluster.allocatable, float("inf"))))
    run_evaluate_single(one, assign.features_of(one_np), cfg, assign, bindings, torch)

    # pod_filters' full mode (feasible_batch: the Filter chain with fit and
    # ports, its selector rows evaluated in the launch), timed on the
    # healthy snapshot (S64); no path of the scheduler calls it
    sel = snap.selectors
    mask = filters.match_rows_plain(snap.cluster, sel.expr_ids, sel.expr_op, sel.expr_slot,
                                    sel.term_valid)
    full = lambda: filters.filter_rows_plain(snap.cluster, snap.pods, mask, True)
    full_row = preempt_row("pod_filters", "S64",
                           lambda: bindings.pod_filters(snap.cluster, snap.pods, sel, True),
                           (full(),), full,
                           pod_filters_need(snap, MAIN[0], FAULT_BATCH, torch, full=True), torch,
                           0)
    full_row.update(entry="full mode: feasible_for_pod / feasible_batch",
                    workload="SchedulingBasic/5000Nodes, 64 pods (8,192 padded nodes)")
    return {"allocatable_inf": {"scan_nan_scores": scan_nan, "auction_rounds": rounds,
                                "kernels": ["match_terms", "class_statics", "greedy_scan",
                                            "wavefront", "auction_loop", "auction_bids",
                                            "auction_accept", "evaluate_single"]},
            "feasible_batch": full_row}


def dry_run_victims_need(args, out, torch) -> tuple:
    """(bytes, operations) of one per-pod dry-run on this data: each
    candidate's free row, its victims' requests and validity and the pod's
    requests read once, feasible and min_k written once; two operations
    (mask, add) a (candidate, slot, resource) of the prefix and two (add,
    compare) a (candidate, k, resource) the first-fit walk reached."""
    _free, victim_req, valid, _req = args
    c, k, r = victim_req.shape
    need = 4 * c * r + 4 * c * k * r + c * k + 4 * r + c * (1 + 4)
    feasible, min_k = out
    walked = (torch.where(feasible.bool(), min_k.long(), valid.sum(dim=1).long()) + 1).sum()
    return need, float(2 * c * k * r + 2 * r * int(walked))


def faults_phase(wrappers, TorchBatchScheduler, assign, auction, filters, dv, bindings,
                 torch, card) -> dict:
    """Degraded mode on the card: each armed fault ends as the reference's
    run ends (tests/test_torch_faults.py holds the two packages to each
    other on the CPU), each step against a healthy twin."""
    from kubernetes_tpu_torch.models.batch_scheduler import (
        HostSolve, SolveCircuitBreaker, SolveUnhealthy)
    from kubernetes_tpu_torch.models.partials import _poison_aff
    from kubernetes_tpu_torch.ops import preemption as pre
    from kubernetes_tpu_torch.testing import cases, faults

    out = {"phase": "faults", "workload": "SchedulingBasic/5000Nodes",
           "fallback_batch": FAULT_BATCH, "card": card}
    out["nan_parity"] = nan_parity(wrappers, TorchBatchScheduler, assign, auction, filters,
                                   dv, bindings, torch)

    # 1. batch.solve fails forever: the dispatch and its one retry fail, the
    # breaker trips, the batch solves on the host
    s = fault_cluster(wrappers, TorchBatchScheduler)
    twin = fault_cluster(wrappers, TorchBatchScheduler)
    batch = make_pods(wrappers, FAULT_BATCH, "f1")
    reg = faults.FaultRegistry().fail("batch.solve", n=-1)
    with faults.armed(reg):
        t = time.perf_counter()
        got = s.schedule_pending(batch)
        dt = time.perf_counter() - t
    want = twin.schedule_pending(batch)
    br = breaker_state(s)
    expect("batch.solve fail", reg.fired == {"batch.solve": 2}, reg.fired)
    expect("batch.solve fail", br == {"state": "open", "trips": 1, "probes": 0, "fallbacks": 1},
           br)
    expect("batch.solve fail", isinstance(s.last_solve, HostSolve) and got == want,
           "the host fallback placed otherwise than the healthy twin")
    out["batch_solve_fail"] = {"fired": dict(reg.fired), "breaker": br, "fallback_s": dt,
                               "fallback_pods_per_s": len(batch) / dt,
                               "placed": sum(n is not None for n in got)}
    assume_all((s, twin), batch, got)

    # 2. the breaker pinned open: the next batch goes to the host and no
    # kernel launches; past the cooldown the half-open probe runs on the
    # card, launches the route's kernels and closes the breaker
    now = [0.0]
    s.breaker = SolveCircuitBreaker(cooldown=3600.0, clock=lambda: now[0])
    s.breaker.record_failure()
    batch = make_pods(wrappers, FAULT_BATCH, "f2")
    t = time.perf_counter()
    got, pinned_launches = drive_phase("faults/pinned open",
                                       lambda: s.schedule_pending(batch), bindings, [s],
                                       armed=True)
    dt = time.perf_counter() - t
    expect("pinned open", not any(pinned_launches.values()), pinned_launches)
    expect("pinned open", got == twin.schedule_pending(batch), "placements differ")
    assume_all((s, twin), batch, got)
    pinned = {"breaker": breaker_state(s), "fallback_s": dt,
              "fallback_pods_per_s": len(batch) / dt}
    now[0] = 3601.0
    batch = make_pods(wrappers, FAULT_BATCH, "f3")
    got, probe_launches = drive_phase("faults/half-open probe",
                                      lambda: s.schedule_pending(batch), bindings, [s])
    br = breaker_state(s)
    expect("probe", br == {"state": "closed", "trips": 1, "probes": 1, "fallbacks": 1}, br)
    expect("probe", got == twin.schedule_pending(batch), "placements differ")
    assume_all((s, twin), batch, got)
    out["pinned_open"] = dict(pinned, probe={"breaker": br, "route": s.metas[-1].route,
                                             "launches": probe_launches})

    # 3. batch.solve CORRUPT once: NaN scores, SolveUnhealthy at the decode,
    # the retry heals on the card
    batch = make_pods(wrappers, FAULT_BATCH, "f4")
    reg = faults.FaultRegistry().corrupt("batch.solve", n=1)
    with faults.armed(reg):
        ds = s.schedule_pending_async(batch)
    expect_unhealthy("batch.solve corrupt", ds, SolveUnhealthy)
    got = s.finalize_pending(batch, ds)
    br = breaker_state(s)
    expect("batch.solve corrupt", reg.fired == {"batch.solve": 1}, reg.fired)
    expect("batch.solve corrupt", br == {"state": "closed", "trips": 1, "probes": 1,
                                         "fallbacks": 1}, br)
    expect("batch.solve corrupt", got == twin.schedule_pending(batch), "placements differ")
    assume_all((s, twin), batch, got)
    out["batch_solve_corrupt"] = {"fired": dict(reg.fired), "unhealthy": True, "breaker": br}

    # 4. solve.partials CORRUPT on a warm scan batch, then on a warm
    # wavefront batch (SchedulingNodeAffinity/5000Nodes, 500 pods)
    steps = {}
    warm = fault_cluster(wrappers, TorchBatchScheduler, mode="greedy", use_wavefront=False)
    cold = fault_cluster(wrappers, TorchBatchScheduler, mode="greedy", use_wavefront=False,
                         use_mirror=False)
    batch = make_pods(wrappers, FAULT_BATCH, "p0")
    got = warm.schedule_pending(batch)
    expect("partials corrupt (scan)", got == cold.schedule_pending(batch), "warm-up differs")
    assume_all((warm, cold), batch, got)
    full0 = warm._partials.full_recomputes
    batch = make_pods(wrappers, FAULT_BATCH, "p1")
    reg = faults.FaultRegistry(seed=1).corrupt("solve.partials", n=1)
    ds, meta, n_nan = poisoned_solve("partials corrupt (scan)", warm, batch, reg, faults,
                                     assign, auction, torch)
    expect("partials corrupt (scan)", meta.route == "greedy" and n_nan > 0,
           f"route {meta.route}, {n_nan} NaN scores")
    expect_unhealthy("partials corrupt (scan)", ds, SolveUnhealthy)
    got = warm.finalize_pending(batch, ds)
    expect("partials corrupt (scan)", got == cold.schedule_pending(batch), "retry differs from cold")
    expect("partials corrupt (scan)", warm._partials.full_recomputes == full0 + 1,
           f"full_recomputes {full0} -> {warm._partials.full_recomputes}")
    assume_all((warm, cold), batch, got)
    torch.cuda.synchronize()
    batch = make_pods(wrappers, FAULT_BATCH, "p2")
    after = warm.schedule_pending(batch)
    expect("partials corrupt (scan)", after == cold.schedule_pending(batch)
           and warm.last_solve.meta.statics is not None, "the next warm batch differs")
    assume_all((warm, cold), batch, after)
    steps["scan"] = {"fired": dict(reg.fired), "nan_scores": n_nan, "unhealthy": True,
                     "full_recomputes": warm._partials.full_recomputes - full0,
                     "breaker": breaker_state(warm)}
    # _poison_aff, the fault's one device program (a plain torch fill on the
    # card), timed on this store: its bound is one write of the [slots, N]
    # affinity rows (a fill reads nothing)
    store = warm._partials._store
    b_ms, b_by = bound(nbytes(store.aff), 0.0)
    steps["poison_aff"] = {"shape": list(store.aff.shape), "launches": 1,
                           "ms": cuda_ms(lambda: _poison_aff(store), 50, torch),
                           "bound_ms": b_ms, "bound_by": b_by}

    wwarm, wcold = TorchBatchScheduler(), TorchBatchScheduler(use_mirror=False)
    for node in make_cluster(wrappers, AFFINITY[0]):
        wwarm.add_node(node)
        wcold.add_node(node)
    batch = affinity_pods(wrappers, AFFINITY_BATCH, "wf0")
    got = wwarm.schedule_pending(batch)
    expect("partials corrupt (wavefront)", got == wcold.schedule_pending(batch), "warm-up differs")
    assume_all((wwarm, wcold), batch, got)
    batch = affinity_pods(wrappers, AFFINITY_BATCH, "wf1")
    reg = faults.FaultRegistry(seed=1).corrupt("solve.partials", n=1)
    ds, meta, n_nan = poisoned_solve("partials corrupt (wavefront)", wwarm, batch, reg, faults,
                                     assign, auction, torch)
    # the reference's cheap pick drops NaN entries of the top list: every
    # member is unplaced with a -inf score, and nothing trips
    got = wwarm.finalize_pending(batch, ds)
    expect("partials corrupt (wavefront)", meta.route == "wavefront" and n_nan == 0
           and all(n is None for n in got) and isinstance(wwarm.last_solve, type(ds)),
           f"route {meta.route}, {n_nan} NaN scores, {sum(n is not None for n in got)} placed")
    torch.cuda.synchronize()
    # the store stays poisoned (as the reference's): a scan batch trips on
    # it and heals, and the wavefront is warm and right again
    heal = affinity_pods(wrappers, 16, "wf-heal")  # the poisoned slot's class
    full0 = wwarm._partials.full_recomputes
    got = wwarm.schedule_pending(heal)
    expect("partials corrupt (wavefront)", wwarm.last_solve.meta.route == "greedy"
           and got == wcold.schedule_pending(heal)
           and wwarm._partials.full_recomputes == full0 + 1, "the scan batch did not heal")
    assume_all((wwarm, wcold), heal, got)
    batch = affinity_pods(wrappers, AFFINITY_BATCH, "wf2")
    got = wwarm.schedule_pending(batch)
    expect("partials corrupt (wavefront)", got == wcold.schedule_pending(batch)
           and all(n is not None for n in got), "the next wavefront batch differs")
    assume_all((wwarm, wcold), batch, got)
    steps["wavefront"] = {"fired": dict(reg.fired), "nan_scores": n_nan, "placed": 0,
                          "healed_by_scan": True, "breaker": breaker_state(wwarm)}
    out["partials_corrupt"] = steps

    # 5. solve.partials fails once: that batch solves cold (class_statics),
    # the next one warm again
    batch = make_pods(wrappers, FAULT_BATCH, "p3")
    reg = faults.FaultRegistry(seed=2).fail("solve.partials", n=1)
    with faults.armed(reg):
        got, cold_launches = drive_phase("faults/partials fail", lambda: warm.schedule_pending(
            batch), bindings, [warm], armed=True)
    expect("partials fail", warm.last_solve.meta.statics is None
           and cold_launches["class_statics"] > 0 and cold_launches["partials_eval"] == 0
           and got == cold.schedule_pending(batch), cold_launches)
    assume_all((warm, cold), batch, got)
    batch = make_pods(wrappers, FAULT_BATCH, "p4")
    got, warm_launches = drive_phase("faults/partials fail (next)",
                                     lambda: warm.schedule_pending(batch), bindings, [warm])
    expect("partials fail", warm.last_solve.meta.statics is not None
           and warm_launches["class_statics"] == 0 and got == cold.schedule_pending(batch),
           warm_launches)
    assume_all((warm, cold), batch, got)
    out["partials_fail"] = {"fired": dict(reg.fired), "cold_launches": cold_launches,
                            "next_launches": warm_launches, "breaker": breaker_state(warm)}

    # 6. mirror.grow at the bucket crossing (8,192 -> 16,384 padded rows)
    grow = {}
    for kind in ("fail", "corrupt"):
        gw = fault_cluster(wrappers, TorchBatchScheduler, mode="greedy", use_wavefront=False)
        gc = fault_cluster(wrappers, TorchBatchScheduler, mode="greedy", use_wavefront=False,
                           use_mirror=False)
        batch = make_pods(wrappers, FAULT_BATCH, f"g-{kind}0")
        got = gw.schedule_pending(batch)
        assume_all((gw, gc), batch, got)
        bucket0 = gw.state.node_axis_bucket
        for node in make_cluster(wrappers, GROW_NODES, prefix="grow"):
            gw.add_node(node)
            gc.add_node(node)
        before = gw._mirror.stats()
        batch = make_pods(wrappers, FAULT_BATCH, f"g-{kind}1")
        reg = faults.FaultRegistry(seed=3)
        getattr(reg, kind)("mirror.grow", n=1)
        rec = {}
        if kind == "fail":
            with faults.armed(reg):
                got = gw.schedule_pending(batch)
        else:
            ds, meta, n_nan = poisoned_solve("mirror.grow corrupt", gw, batch, reg, faults,
                                             assign, auction, torch)
            expect_unhealthy("mirror.grow corrupt", ds, SolveUnhealthy)
            got = gw.finalize_pending(batch, ds)
            rec["nan_scores"] = n_nan
        want = gc.schedule_pending(batch)
        delta = {k: v - before[k] for k, v in gw._mirror.stats().items()}
        expect(f"mirror.grow {kind}", reg.fired == {"mirror.grow": 1} and got == want
               and gw.state.node_axis_bucket == 2 * bucket0,
               (reg.fired, bucket0, gw.state.node_axis_bucket))
        if kind == "fail":
            expect("mirror.grow fail", delta["resync_total"] == 1 and delta["grow_syncs"] == 0,
                   delta)
        else:
            expect("mirror.grow corrupt", delta["resync_total"] == 1
                   and delta["grow_syncs"] == 1, delta)
        expect(f"mirror.grow {kind}", breaker_state(gw)["state"] == "closed"
               and gw.breaker.fallback_count() == 0, breaker_state(gw))
        grow[kind] = dict(rec, fired=dict(reg.fired), mirror=delta, breaker=breaker_state(gw),
                          padded_nodes=(bucket0, gw.state.node_axis_bucket))
    out["mirror_grow"] = grow

    # 7. solve.carveout fails once on a c10 round: the retry places as the CPU
    pair = {"cuda": TorchBatchScheduler(carveout_policy="prefer"),
            "cpu": TorchBatchScheduler(device="cpu", carveout_policy="prefer")}
    names = {}
    reg = faults.FaultRegistry().fail("solve.carveout", n=1)
    for d, sch in pair.items():
        churn = cases.SliceChurn(wrappers)
        for node in churn.nodes():
            sch.add_node(node)
        pods = churn.round_pods(0)
        if d == "cuda":
            with faults.armed(reg):
                names[d] = sch.schedule_pending(pods)
        else:
            names[d] = sch.schedule_pending(pods)
    expect("solve.carveout", reg.fired == {"solve.carveout": 1} and names["cuda"] == names["cpu"]
           and breaker_state(pair["cuda"])["fallbacks"] == 0, reg.fired)
    out["solve_carveout"] = {"fired": dict(reg.fired), "breaker": breaker_state(pair["cuda"]),
                             "placed": sum(n is not None for n in names["cuda"]),
                             "equal_cpu": True}

    # 8. batch.preemption fails twice on PreemptionBasic/500Nodes: the pass
    # falls back to the per-pod path (dry_run_victims) and trips the
    # breaker; the outcome equals the batched pass on a healthy twin.  The
    # fault fires before the batched entry's launch, so every
    # preempt_dry_run launch of the faulted pass is the victims entry's.
    runs = {}
    for label in ("healthy", "faulted"):
        sch, cache, ev, preemptors = preemption_basic(wrappers, TorchBatchScheduler,
                                                      PREEMPT_SMALL)
        reg = faults.FaultRegistry(seed=1).fail("batch.preemption", n=2)
        with faults.armed(reg) if label == "faulted" else contextlib.nullcontext():
            (results, rec), launches = drive_phase(
                f"faults/batch.preemption {label}",
                lambda: preemption_cycle(sch, cache, ev, preemptors[:PREEMPT_PASS]),
                bindings, [sch], extra=PREEMPT_KERNELS, armed=label == "faulted")
        runs[label] = ([result_key(r) for r in results], sorted(sch.state._pod_node.items()),
                       rec, breaker_state(sch), launches["preempt_dry_run"], dict(reg.fired))
        if label == "faulted":
            launches_f = launches
    keys_h, pods_h, rec_h, br_h, batched_h, _ = runs["healthy"]
    keys_f, pods_f, rec_f, br_f, n_calls, fired = runs["faulted"]
    expect("batch.preemption", not rec_h["fallback"] and batched_h == 1
           and br_h["state"] == "closed", ("the healthy pass", rec_h["fallback"], batched_h))
    expect("batch.preemption", fired == {"batch.preemption": 2} and rec_f["fallback"]
           and n_calls > 0 and br_f["state"] == "open" and br_f["trips"] == 1
           and keys_f == keys_h and pods_f == pods_h, (fired, rec_f["fallback"], n_calls, br_f))
    # the victims entry at the per-pod path's shapes: the inputs of the
    # next preemptor, whose pass the open breaker sends down that path
    got = ev._classic_inputs(preemptors[PREEMPT_PASS])
    expect("batch.preemption", got is not None, "no per-pod candidate for the next preemptor")
    args = ev._victim_tables(*got)
    vout = bindings.dry_run_victims(*args)
    err = check_equal("preempt_dry_run victims entry (faults)", vout,
                      pre.dry_run_victims_plain(*args), torch)
    row = preempt_row("preempt_dry_run", "V", lambda: bindings.dry_run_victims(*args),
                      tuple(pre.dry_run_victims_plain(*args)),
                      lambda: pre.dry_run_victims_plain(*args),
                      dry_run_victims_need(args, vout, torch), torch, n_calls)
    row.update(entry="dry_run_victims", replaces="kubernetes_tpu/ops/preemption.py:70",
               max_abs_err=max(err, row["max_abs_err"]),
               slots=f"{tuple(args[1].shape)} (candidates, slots, resources)",
               row_lanes=bindings.dry_run_lanes(1, *args[1].shape))
    out["batch_preemption"] = {
        "workload": "PreemptionBasic/500Nodes", "preemptors": PREEMPT_PASS,
        "fallback": True, "breaker": br_f, "equal_healthy_batched_pass": True,
        "nominated": sum(k is not None for k in keys_f),
        "launches_faulted": {k: launches_f[k] for k in PREEMPT_KERNELS + ("match_terms",)},
        "dry_run_victims": row}
    emit(out)
    return out


# ---- the scheduler's front half: the columnar encode and the profiles ------

def snapshots_equal(what, a, b, meta_a, meta_b) -> None:
    """Every leaf of two host Snapshots byte-equal (dtype, shape and
    bytes), and the stable selector and preferred ids of their metas."""
    import numpy as np

    for table in type(a)._fields:
        ta, tb = getattr(a, table), getattr(b, table)
        for f in type(ta)._fields:
            x, y = np.asarray(getattr(ta, f)), np.asarray(getattr(tb, f))
            if x.dtype != y.dtype or x.shape != y.shape or x.tobytes() != y.tobytes():
                raise AssertionError(f"{what}: {table}.{f} differs between the columnar "
                                     "and the per-object encode")
    if meta_a.sel_stable != meta_b.sel_stable or meta_a.pref_stable != meta_b.pref_stable:
        raise AssertionError(f"{what}: the stable selector or preferred ids differ")


def build_split(builder, state, pending, schema) -> dict:
    """One build_from_state's steps, each a separate timed call from here:
    the effective-requests pass with the resource intern and the cluster
    views (prep_s), the pod tables (pods_s: _build_pods_columnar or
    _build_pods, by the builder's switch), the constraint tables
    (constraints_s), the image table (images_s) and the class refinement
    (refine_s)."""
    from kubernetes_tpu_torch.utils import vocab

    clock = time.perf_counter
    t0 = clock()
    eff_list = [builder.effective_requests(p) for p in pending]
    for eff in eff_list:
        builder._resource_vector(eff, 0, grow=True)
    state.ensure_resources()
    r = len(builder.resource_names)
    n = state.tensors().allocatable.shape[0]
    p_dim = vocab.pad_dim(len(pending), builder.limits.min_pods)
    t1 = clock()
    if builder.columnar:
        pods, _sel, _pref, sel_index = builder._build_pods_columnar(pending, p_dim, r, eff_list)
    else:
        pods, _sel, _pref, sel_index = builder._build_pods(pending, p_dim, r)
    t2 = clock()
    spread, terms, prefpod = builder._build_constraints(
        pending, state.bound_pods(), sel_index, n, p_dim)
    t3 = clock()
    images = builder.image_table(pending, p_dim)
    t4 = clock()
    schema._refine_classes(pods, spread, terms, prefpod, images)
    t5 = clock()
    return {"prep_s": t1 - t0, "pods_s": t2 - t1, "constraints_s": t3 - t2,
            "images_s": t4 - t3, "refine_s": t5 - t4, "sum_s": t5 - t0}


def encode_phase(wrappers, north_pods, north_names, card) -> dict:
    """The columnar encode (SnapshotBuilder's default) against the
    per-object one, host only: two builders fed identically, each over
    its own ClusterState.  c5 (C5: its 50,000 nodes, a warm-up and
    C5_TIMED batches of 10,000 pods in 100 gangs under fresh names,
    nothing assumed) and the north star's second batch (50,000 nodes, the
    first batch's 10,000 pods accounted where the card placed them, a
    second batch of 10,000: a warm-up and ENCODE_NORTH_BUILDS builds).
    Every batch's Snapshots byte-equal leaf for leaf, the stable ids
    equal; build_from_state's seconds both ways (median, min) and the
    split of one warm build each way."""
    import statistics

    from kubernetes_tpu_torch.ops import schema

    def sides(nodes, bound=()):
        out = []
        for columnar in (True, False):
            b = schema.SnapshotBuilder()
            b.columnar = columnar
            st = schema.ClusterState(b)
            for node in nodes:
                st.add_node(node)
            for pod, name in bound:
                st.add_pod(pod, name)
            out.append((b, st))
        return out

    def build_both(what, both, pods):
        got, secs = [], []
        for b, st in both:
            t = time.perf_counter()
            snap, meta = b.build_from_state(st, pods)
            secs.append(time.perf_counter() - t)
            got.append((snap, meta))
        snapshots_equal(what, got[0][0], got[1][0], got[0][1], got[1][1])
        return secs

    def run(what, both, batches):
        secs = {"columnar": [], "per_object": []}
        for k, pods in enumerate(batches):
            col, obj = build_both(f"{what}/{k}", both, pods)
            if k:  # the first is the warm-up
                secs["columnar"].append(col)
                secs["per_object"].append(obj)
        last = batches[-1]
        return {
            "timed_builds": len(batches) - 1, "equal": True,
            "build_s": {side: {"median": statistics.median(v), "min": min(v), "all": v}
                        for side, v in secs.items()},
            "split": {"columnar": build_split(*both[0], last, schema),
                      "per_object": build_split(*both[1], last, schema)},
        }

    out = {"phase": "encode", "card": card}
    t0 = time.perf_counter()
    c5 = sides(c5_nodes(wrappers, C5[0]))
    out["c5"] = dict(run("encode/c5", c5, [
        c5_pods(wrappers, f"enc-{tag}")
        for tag in ("warmup",) + tuple(f"run{j}" for j in range(C5_TIMED))]),
        workload="bench.py c5 (config5)", nodes=C5[0], pods=C5[1])
    del c5
    north = sides(make_cluster(wrappers, NORTH[0]), list(zip(north_pods, north_names)))
    second = make_pods(wrappers, NORTH[2], "burst2")
    out["north_second"] = dict(
        run("encode/north-second", north, [second] * (1 + ENCODE_NORTH_BUILDS)),
        nodes=NORTH[0], bound=len(north_pods), pods=NORTH[2])
    del north
    out["phase_s"] = time.perf_counter() - t0
    return out


def front_half_sequence(wrappers, assign, registry, SchedulerCache, SchedulingQueue,
                        n_nodes: int, n_pods: int, odd: int = PROFILES_ODD,
                        delete: int = PROFILES_DELETE,
                        new_nodes: int = PROFILES_NEW_NODES) -> dict:
    """The scheduler's front half as the reference's loop drives it up to
    its binding stage, over `registry` (a FrameworkRegistry of two
    profiles; duck-typed, so the reference's registry takes the same
    sequence in the tests): SchedulingBasic's n_nodes node-default nodes
    into a SchedulerCache over the registry's one ClusterState; n_pods
    pod-default pods dealt between the two profiles, `odd` pods each of
    pod-large-cpu (fit no 4-CPU node) and of a node selector no node
    matches, dealt alike, and `odd` naming an unknown scheduler
    (for_pod None: never queued).  A cycle pops each profile's own class
    (pop_batch(profiles={name}), no window), solves it through that
    profile's scheduler under the cache lock, assumes what placed and
    parks what failed with the reason the solve read back.  Then `delete`
    assumed pods leave and AssignedPodDelete wakes the fit failures only;
    a cycle parks them again; `new_nodes` 16-CPU nodes arrive and NodeAdd
    wakes every parked pod; a cycle places the large pods on the new
    nodes and fails the selector pods with the same reason.  The queue's
    clock is a counter stepped past the backoff between cycles.  Returns
    each cycle's {pod: (profile, node, reason)}, the wake counts, the
    dispatches with each one's last_timings, the cycles' walls and the
    queue's final tiers."""
    api = wrappers.api
    cfg = registry.config
    names = [f.scheduler_name for f in registry]
    now = [0.0]
    cache = SchedulerCache(registry.state)
    queue = SchedulingQueue(backoff_base=cfg.pod_initial_backoff_seconds,
                            backoff_max=cfg.pod_max_backoff_seconds,
                            unschedulable_flush_after=cfg.unschedulable_flush_seconds,
                            clock=lambda: now[0])
    for node in make_cluster(wrappers, n_nodes):
        cache.add_node(node)
    mi = wrappers.MI
    basic = make_pods(wrappers, n_pods, "fh")
    large = [wrappers.make_pod(f"fh-large-{i}").req(cpu_milli=9000, mem=500 * mi)
             .priority(10).obj() for i in range(odd)]
    picky = [wrappers.make_pod(f"fh-picky-{i}")
             .req(cpu_milli=POD_CPU_MILLI, mem=POD_MEM_MI * mi)
             .node_selector_kv("front-half", "nowhere").obj() for i in range(odd)]
    strays = make_pods(wrappers, odd, "fh-stray")
    for group in (basic, large, picky):
        for i, pod in enumerate(group):
            pod.spec.scheduler_name = names[i % len(names)]
    for pod in strays:
        pod.spec.scheduler_name = "no-such-scheduler"
    out = {"cycles": [], "walls": [], "timings": [], "dispatches": 0}
    skipped = 0
    for pod in basic + large + picky + strays:
        if registry.for_pod(pod) is None:
            skipped += 1
            continue
        queue.add(pod)
    if skipped != odd:
        raise AssertionError(f"front half: {skipped} pods skipped, {odd} name no profile")

    def cycle():
        t = time.perf_counter()
        rec = {}
        for fwk in registry:
            infos = queue.pop_batch(cfg.batch_size, timeout=0, window=0,
                                    profiles={fwk.scheduler_name})
            if not infos:
                continue
            pods = [info.pod for info in infos]
            placed = fwk.tpu.schedule_pending(pods, lock=cache.lock)
            reasons = fwk.tpu.last_solve.reasons()
            out["dispatches"] += 1
            out["timings"].append(dict(fwk.tpu.last_timings, profile=fwk.scheduler_name,
                                       pods=len(pods)))
            for info, node, reason in zip(infos, placed, reasons):
                if node is None:
                    queue.add_unschedulable(info, reason=reason)
                else:
                    cache.assume(info.pod, node)
                    queue.done(info.pod)
                rec[info.pod.meta.name] = (fwk.scheduler_name, node, int(reason))
        out["walls"].append(time.perf_counter() - t)
        out["cycles"].append(rec)
        return rec

    def expect_failed(what, rec, pods, reason):
        for pod in pods:
            got = rec.get(pod.meta.name)
            if got is None or got[1] is not None or got[2] != reason:
                raise AssertionError(f"front half {what}: {pod.meta.name} -> {got}, "
                                     f"expected unplaced with reason {reason}")

    first = cycle()
    for pod in basic:
        if first.get(pod.meta.name, (None, None))[1] is None:
            raise AssertionError(f"front half: {pod.meta.name} was not placed")
    expect_failed("cycle 1", first, large, assign.REASON_RESOURCES)
    expect_failed("cycle 1", first, picky, assign.REASON_STATIC)
    if any(queue.contains(f"{p.meta.namespace}/{p.meta.name}") for p in strays):
        raise AssertionError("front half: a pod of an unknown scheduler was queued")
    for pod in basic[:delete]:
        cache.remove_pod(pod)
    moved_delete = queue.move_for_event("AssignedPodDelete")
    parked = queue.stats()["unschedulable"]
    if moved_delete != len(large) or parked != len(picky):
        raise AssertionError(f"front half: AssignedPodDelete woke {moved_delete} "
                             f"(parked {parked}); expected {len(large)} ({len(picky)})")
    now[0] += cfg.pod_max_backoff_seconds + 1.0
    second = cycle()
    expect_failed("cycle 2", second, large, assign.REASON_RESOURCES)
    if set(second) != {p.meta.name for p in large}:
        raise AssertionError(f"front half cycle 2 popped {sorted(second)}")
    gi = wrappers.GI
    fresh = [wrappers.make_node(f"fh-big-{i}")
             .capacity(cpu_milli=16000, mem=NODE_MEM_GI * gi, pods=NODE_PODS)
             .zone(f"zone-{i % ZONES}").obj() for i in range(new_nodes)]
    for node in fresh:
        cache.add_node(node)
    moved_add = queue.move_for_event("NodeAdd")
    if moved_add != len(large) + len(picky):
        raise AssertionError(f"front half: NodeAdd woke {moved_add}, expected "
                             f"{len(large) + len(picky)}")
    now[0] += cfg.pod_max_backoff_seconds + 1.0
    third = cycle()
    big = {n.meta.name for n in fresh}
    for pod in large:
        got = third.get(pod.meta.name)
        if got is None or got[1] not in big:
            raise AssertionError(f"front half cycle 3: {pod.meta.name} -> {got}")
    expect_failed("cycle 3", third, picky, assign.REASON_STATIC)
    stats = queue.stats()
    if (stats["unschedulable"] != len(picky) or stats["inflight"] or stats["active"]
            or stats["backoff"]):
        raise AssertionError(f"front half: queue ends {stats}")
    out.update(moved={"AssignedPodDelete": moved_delete, "NodeAdd": moved_add},
               skipped=skipped, queue=stats, assumed=cache.assumed_count())
    return out


def profiles_phase(wrappers, TorchBatchScheduler, bindings, torch, card) -> dict:
    """SchedulerConfiguration from a dict (two profiles with different
    score weights, the default gates) -> FrameworkRegistry on the card
    (two TorchBatchSchedulers, one ClusterState, one DispatchArbiter) ->
    front_half_sequence at SchedulingBasic/5000Nodes, its launch counters
    at 0 before and read after (drive_phase); the same sequence through
    FrameworkRegistry(..., device="cpu"): every cycle's placements and
    reasons equal; the arbiter took one slot a dispatch, forced none and
    holds none at the end."""
    from kubernetes_tpu_torch.ops import assign
    from kubernetes_tpu_torch.scheduler import config, framework
    from kubernetes_tpu_torch.scheduler.cache import SchedulerCache
    from kubernetes_tpu_torch.scheduler.queue import SchedulingQueue

    saved = framework.TorchBatchScheduler
    # the registry builds the recording class, so the launch checks and
    # assert_healthy see its schedulers
    framework.TorchBatchScheduler = TorchBatchScheduler
    try:
        reg = framework.FrameworkRegistry(config.load_config(PROFILES_CONFIG))
        cpu_reg = framework.FrameworkRegistry(config.load_config(PROFILES_CONFIG), device="cpu")
    finally:
        framework.TorchBatchScheduler = saved
    scheds = [f.tpu for f in reg]
    arb = reg.arbiter
    if (len(scheds) != 2 or arb is None or any(s.arbiter is not arb for s in scheds)
            or scheds[0].state is not scheds[1].state
            or any(s.device.type != "cuda" for s in scheds)
            or scheds[0].score_config == scheds[1].score_config):
        raise AssertionError("profiles: not two card schedulers with their own weights over "
                             "one state and one arbiter")
    marks = [len(s.metas) for s in scheds]

    def run():
        return front_half_sequence(wrappers, assign, reg, SchedulerCache, SchedulingQueue,
                                   *PROFILES)

    got, launches = drive_phase("profiles", run, bindings, scheds)
    t0 = time.perf_counter()
    want = front_half_sequence(wrappers, assign, cpu_reg, SchedulerCache, SchedulingQueue,
                               *PROFILES)
    cpu_s = time.perf_counter() - t0
    if got["cycles"] != want["cycles"]:
        raise AssertionError("profiles: the card's placements or reasons differ from the CPU's")
    encodes = sum(len(s.metas) - k for s, k in zip(scheds, marks))
    if arb.acquires != got["dispatches"] or encodes != got["dispatches"]:
        raise AssertionError(f"profiles: {arb.acquires} arbiter acquires, {encodes} encodes, "
                             f"{got['dispatches']} dispatches")
    if arb.forced or arb.inflight():
        raise AssertionError(f"profiles: arbiter forced {arb.forced}, {arb.inflight()} held")
    routes = [[m.route for m in s.metas[k:]] for s, k in zip(scheds, marks)]
    return {"phase": "profiles", "workload": "SchedulingBasic/5000Nodes, two profiles",
            "nodes": PROFILES[0], "pods": PROFILES[1], "odd": PROFILES_ODD,
            "profiles": [f.scheduler_name for f in reg], "routes": routes,
            "placed": [sum(v[1] is not None for v in c.values()) for c in got["cycles"]],
            "popped": [len(c) for c in got["cycles"]], "moved": got["moved"],
            "skipped": got["skipped"], "queue": got["queue"], "assumed": got["assumed"],
            "dispatches": got["dispatches"],
            "arbiter": {"depth": arb.depth, "acquires": arb.acquires, "forced": arb.forced,
                        "inflight": arb.inflight()},
            "encode_rows_per_s": [s.last_encode_rows_per_s for s in scheds],
            "cycle_s": got["walls"], "last_timings": got["timings"],
            "cpu_cycle_s": want["walls"], "cpu_s": cpu_s,
            "equal_cpu": True, "launches": launches, "card": card}



def _wait_for(cond, timeout: float, what: str, step: float = 0.001) -> float:
    """Poll cond() until it holds; the seconds waited.  Raises past the
    timeout."""
    t0 = time.perf_counter()
    deadline = t0 + timeout
    while not cond():
        if time.perf_counter() > deadline:
            raise AssertionError(f"loop: timed out after {timeout} s waiting for {what}")
        time.sleep(step)
    return time.perf_counter() - t0


def _loop_scheduler(Scheduler, store, **kw):
    """Scheduler(store, **kw) with its informers started and synced (the
    scheduling thread is not started: the caller drives schedule_batch),
    each popped batch's pod names recorded in `sched.popped` and each
    finished cycle's trace in `sched.traces` (its steps and total)."""
    sched = Scheduler(store, **kw)
    sched.popped, sched.traces = [], []
    pop, finish = sched.queue.pop_batch, sched._finish_cycle

    def pop_batch(*a, **k):
        batch = pop(*a, **k)
        if batch:
            sched.popped.append([info.pod.meta.name for info in batch])
        return batch

    def finish_cycle(cycle):
        try:
            return finish(cycle)
        finally:
            sched.traces.append({"steps": list(cycle.trace.steps),
                                 "total_s": cycle.trace.total})

    sched.queue.pop_batch, sched._finish_cycle = pop_batch, finish_cycle
    for kind in LOOP_INFORMERS:
        sched.informers.informer(kind).start()
    if not sched.informers.wait_for_sync(LOOP_WAIT_S):
        raise AssertionError("loop: the informers did not sync")
    return sched


def _loop_cycles(sched, n_pods: int, what: str) -> list:
    """schedule_batch cycles until n_pods were staged into bind waves,
    then flush the waves; each cycle's wall, counters, route and
    last_timings."""
    out, staged = [], 0
    deadline = time.perf_counter() + LOOP_WAIT_S
    while staged < n_pods:
        if time.perf_counter() > deadline:
            raise AssertionError(f"loop {what}: {staged} of {n_pods} pods staged")
        t = time.perf_counter()
        stats = sched.schedule_batch(timeout=1.0)
        wall = time.perf_counter() - t
        if not stats["popped"]:
            continue
        if stats["unschedulable"] or stats["bind_errors"]:
            raise AssertionError(f"loop {what}: a cycle failed pods: {stats}")
        staged += stats["scheduled"]
        out.append({"stats": stats, "wall_s": wall, "trace": sched.traces[-1],
                    "route": sched.tpu.last_solve.meta.route,
                    "last_timings": dict(sched.tpu.last_timings)})
    if not sched.flush_binds(LOOP_WAIT_S):
        raise AssertionError(f"loop {what}: the bind waves did not drain")
    return out


def loop_basic_sequence(wrappers, Store, Scheduler, n_nodes: int, n_init: int,
                        n_measured: int, **kw) -> dict:
    """SchedulingBasic through the scheduler loop as a user runs it, over
    any package's Store and Scheduler (duck-typed, so the tests drive the
    reference's the same way): n_nodes node-default nodes and n_init
    pod-default pods created in the store; Scheduler(store, **kw) with
    its informers started and synced; once every init pod is active in
    the queue, schedule_batch cycles until all are staged, then
    flush_binds; then n_measured pods created, the same wait, cycles and
    flush.  Returns every pod's node in the store, the popped batches,
    each cycle's record, the binder's commit seconds, the seconds from the
    measured pods' creation to the last informer echo (every measured pod
    bound in the store and no assume left), the measured batch's seconds
    from its first pop to its flushed wave, and the metrics the loop
    mirrors."""
    store = Store()
    sched = None
    try:
        for node in make_cluster(wrappers, n_nodes):
            store.create(node)
        for pod in make_pods(wrappers, n_init, "init"):
            store.create(pod)
        sched = _loop_scheduler(Scheduler, store, **kw)
        _wait_for(lambda: sched.queue.stats()["active"] == n_init, LOOP_WAIT_S,
                  "the init pods in the queue")
        init = _loop_cycles(sched, n_init, "init")
        t_create = time.perf_counter()
        measured = make_pods(wrappers, n_measured, "measured")
        for pod in measured:
            store.create(pod)
        # both runs pop the same batch: every measured pod is queued first
        _wait_for(lambda: sched.queue.stats()["active"] == n_measured, LOOP_WAIT_S,
                  "the measured pods in the queue")
        t_pop = time.perf_counter()
        meas = _loop_cycles(sched, n_measured, "measured")
        t_flushed = time.perf_counter()

        def echoed():
            if sched.cache.assumed_count():
                return False
            pods, _ = store.list("Pod")
            return all(p.spec.node_name for p in pods)

        _wait_for(echoed, LOOP_WAIT_S, "the informers' echo of the binds")
        t_echo = time.perf_counter()
        pods, _ = store.list("Pod")
        m = sched.metrics
        return {
            "placed": {p.meta.name: p.spec.node_name for p in pods},
            "popped": sched.popped, "init": init, "measured": meas,
            "commit_subwave_s": {"n": m.commit_subwave_duration.n,
                                 "total": m.commit_subwave_duration.total,
                                 "max": m.commit_subwave_duration.max},
            "commit_wave_s": {"n": m.commit_wave_duration.n,
                              "total": m.commit_wave_duration.total,
                              "max": m.commit_wave_duration.max},
            "create_to_echo_s": t_echo - t_create,
            "measured_pop_to_flushed_s": t_flushed - t_pop,
            "measured_pods_per_s": n_measured / (t_flushed - t_pop),
            "assumed": sched.cache.assumed_count(),
            "breaker_state": m.solve_breaker_state.get(),
            "fallback_total": m.solve_fallback_total.get(),
            "retrace_total": m.solve_retrace_total.get(),
            "watch": store.watch_stats(),
            "queue": sched.queue.stats(),
        }
    finally:
        if sched is not None:
            sched.stop()
        store.close()


def loop_preemption_sequence(wrappers, Store, Scheduler, dims, max_cycles: int,
                             **kw) -> dict:
    """PreemptionBasic through the scheduler loop's PostFilter pass: the
    nodes, the victims (created bound, four a node) and the preemptors in
    the store before the informers start; schedule_batch cycles (each
    followed by flush_binds) until every preemptor is bound in the store
    or max_cycles ran.  Returns each preemptor's node, the victims evicted
    (gone from the store), each cycle's counters and the pass metrics."""
    from kubernetes_tpu_torch.testing.cases import preemption_basic_objects

    nodes, victims, preemptors = preemption_basic_objects(wrappers, *dims)
    store = Store()
    sched = None
    try:
        for obj in list(nodes) + list(victims) + list(preemptors):
            store.create(obj)
        sched = _loop_scheduler(Scheduler, store, **kw)
        names = [p.meta.name for p in preemptors]
        cycles = []

        def placed():
            return {n: store.get("Pod", n).spec.node_name for n in names}

        t0 = time.perf_counter()
        for _ in range(max_cycles):
            t = time.perf_counter()
            stats = sched.schedule_batch(timeout=1.5)
            if not sched.flush_binds(LOOP_WAIT_S):
                raise AssertionError("loop preemption: the bind waves did not drain")
            cycles.append({"stats": stats, "wall_s": time.perf_counter() - t})
            if all(placed().values()):
                break
        wall = time.perf_counter() - t0
        _wait_for(lambda: sched.cache.assumed_count() == 0, LOOP_WAIT_S,
                  "the informers' echo of the binds")
        alive = {p.meta.name for p in store.list("Pod")[0]}
        m = sched.metrics
        return {
            "nodes": placed(),
            "evicted": sorted(v.meta.name for v in victims if v.meta.name not in alive),
            "cycles": cycles, "wall_s": wall,
            "preempted": sum(c["stats"].get("preempted", 0) for c in cycles),
            "passes": m.preemption_batch_size.n,
            "pass_s": m.preemption_solve_duration.total,
            "breaker_state": m.solve_breaker_state.get(),
            "fallback_total": m.solve_fallback_total.get(),
        }
    finally:
        if sched is not None:
            sched.stop()
        store.close()


def loop_phase(wrappers, TorchBatchScheduler, bindings, torch, card) -> dict:
    """The scheduler loop on the card: Store.create -> Store.watch ->
    SharedInformer -> Scheduler._on_pod -> SchedulingQueue ->
    schedule_batch -> TorchBatchScheduler (the default configuration: one
    profile, the default gates, speculative_solve and the adaptive window
    on) -> assume + Permit -> a bind wave on the binder thread ->
    Store.update_wave -> the informer's echo.

    Step A, SchedulingBasic/5000Nodes through the loop
    (loop_basic_sequence; its launch counters at 0 before and read after,
    drive_phase): both batches on the auction, every pod bound, no node
    over capacity, no assume left, the breaker closed with 0 fallbacks;
    the placements equal to a TorchBatchScheduler() on the card driven
    directly with the same two batches, the first assumed before the
    second.  Step B, PreemptionBasic/500Nodes through the loop's PostFilter
    pass (loop_preemption_sequence, its own drive_phase: the scan, the
    pass's preempt_dry_run and pod_filters); the same sequence through
    Scheduler(..., device="cpu"): every preemptor's node and the evicted
    victims equal."""
    from kubernetes_tpu_torch.api.store import Store
    from kubernetes_tpu_torch.scheduler import framework
    from kubernetes_tpu_torch.scheduler.scheduler import Scheduler

    out = {"phase": "loop", "card": card}
    t_phase = time.perf_counter()
    saved = framework.TorchBatchScheduler
    # the registry builds the recording class, so the launch checks and
    # assert_healthy see the loop's schedulers
    framework.TorchBatchScheduler = TorchBatchScheduler
    try:
        scheds = []

        def loop_scheduler(store, **kw):
            s = Scheduler(store, **kw)
            if kw.get("device") is None:
                if s.tpu.device.type != "cuda":
                    raise AssertionError("loop: Scheduler(store) is not on the card")
                scheds.append(s.tpu)
            return s

        def run_basic():
            return loop_basic_sequence(wrappers, Store, loop_scheduler, *LOOP)

        got, launches = drive_phase("loop/basic", run_basic, bindings, scheds)
        tpu = scheds[0]
        routes = [c["route"] for c in got["init"] + got["measured"]]
        if routes != ["auction", "auction"] or [len(b) for b in got["popped"]] != list(LOOP[1:]):
            raise AssertionError(f"loop: routes {routes}, batches "
                                 f"{[len(b) for b in got['popped']]}")
        if not all(got["placed"].values()) or len(got["placed"]) != LOOP[1] + LOOP[2]:
            raise AssertionError("loop: a pod is not bound in the store")
        check_capacity(tpu.state)
        if got["assumed"] or got["breaker_state"] or got["fallback_total"]:
            raise AssertionError(f"loop: {got['assumed']} assumes left, breaker "
                                 f"{got['breaker_state']}, {got['fallback_total']} fallbacks")
        # the same two batches through TorchBatchScheduler() directly
        direct = TorchBatchScheduler()
        for node in make_cluster(wrappers, LOOP[0]):
            direct.add_node(node)
        pods = {p.meta.name: p for p in make_pods(wrappers, LOOP[1], "init")
                + make_pods(wrappers, LOOP[2], "measured")}
        want = {}

        def run_direct():
            for batch in got["popped"]:
                names = direct.schedule_pending([pods[n] for n in batch])
                for n, node in zip(batch, names):
                    want[n] = node
                    direct.assume(pods[n], node)

        _, direct_launches = drive_phase("loop/direct", run_direct, bindings, [direct])
        if want != got["placed"]:
            bad = [n for n in want if want[n] != got["placed"].get(n)][:5]
            raise AssertionError(f"loop: placements differ from the direct solver at {bad}")
        out["basic"] = {
            "workload": "SchedulingBasic/5000Nodes", "nodes": LOOP[0], "init": LOOP[1],
            "measured": LOOP[2], "routes": routes,
            "cycles": [{"phase": label, "wall_s": c["wall_s"], "stats": c["stats"],
                        "trace_s": c["trace"]["steps"], "trace_total_s": c["trace"]["total_s"],
                        "last_timings": c["last_timings"]}
                       for label, cs in (("init", got["init"]), ("measured", got["measured"]))
                       for c in cs],
            **{k: got[k] for k in ("commit_subwave_s", "commit_wave_s", "create_to_echo_s",
                                   "measured_pop_to_flushed_s", "measured_pods_per_s",
                                   "retrace_total", "watch", "queue")},
            "equal_direct": True, "launches": launches, "direct_launches": direct_launches,
        }

        # step B: the PostFilter pass through the loop, card against the CPU
        pre_scheds = []

        def pre_scheduler(store, **kw):
            s = Scheduler(store, **kw)
            pre_scheds.append(s.tpu)
            return s

        def run_pre():
            return loop_preemption_sequence(wrappers, Store, pre_scheduler, LOOP_PREEMPT,
                                            LOOP_PREEMPT_CYCLES)

        pre, pre_launches = drive_phase("loop/preemption", run_pre, bindings, pre_scheds,
                                        extra=PREEMPT_KERNELS)
        t0 = time.perf_counter()
        cpu = loop_preemption_sequence(wrappers, Store, Scheduler, LOOP_PREEMPT,
                                       LOOP_PREEMPT_CYCLES, device="cpu")
        cpu_s = time.perf_counter() - t0
        if not all(pre["nodes"].values()):
            raise AssertionError(f"loop preemption: preemptors left unbound: {pre['nodes']}")
        if pre["nodes"] != cpu["nodes"] or pre["evicted"] != cpu["evicted"]:
            raise AssertionError("loop preemption: the card's nodes or evictions differ "
                                 "from the CPU loop's")
        if pre["breaker_state"] or pre["fallback_total"] or not pre["passes"]:
            raise AssertionError(f"loop preemption: breaker {pre['breaker_state']}, "
                                 f"{pre['fallback_total']} fallbacks, {pre['passes']} passes")
        for k in ("greedy_scan",) + PREEMPT_KERNELS:
            if not pre_launches.get(k):
                raise AssertionError(f"loop preemption: kernel {k} was not launched")
        out["preemption"] = {
            "workload": "PreemptionBasic/500Nodes", "nodes": LOOP_PREEMPT[0],
            "victims": LOOP_PREEMPT[1], "preemptors": LOOP_PREEMPT[2],
            "evicted": len(pre["evicted"]), "cycles": len(pre["cycles"]),
            "cycle_s": [c["wall_s"] for c in pre["cycles"]], "wall_s": pre["wall_s"],
            "passes": pre["passes"], "pass_s": pre["pass_s"], "preempted": pre["preempted"],
            "cpu_cycles": len(cpu["cycles"]), "cpu_s": cpu_s, "equal_cpu": True,
            "launches": pre_launches,
        }
    finally:
        framework.TorchBatchScheduler = saved
    out["phase_s"] = time.perf_counter() - t_phase
    return out


if __name__ == "__main__":
    sys.exit(main())
