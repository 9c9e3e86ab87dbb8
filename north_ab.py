"""Time the north-star batches of two trees, in one run on one card.

    python3 north_ab.py OTHER_TREE [--workload NAME] [--log PATH]

OTHER_TREE is another checkout of this repository (for example the parent
commit unpacked with `git archive` into a git-ignored directory).  Each
run is a fresh process in that tree or in this one, every batch through
TorchBatchScheduler(), each batch's placements assumed before the next.
The workloads (the default first):

  north   50,000 node-default nodes, three batches of 10,000 pod-default
          pods; the runs go other, this (warm), this (cold:
          use_mirror=False), this (warm), other, this (cold), so every
          version runs early and late
  basic   SchedulingBasic/5000Nodes: 5,000 nodes, 1,000 init then 1,000
          measured pod-default pods (both the auction)
  spread  TopologySpreading/5000Nodes: 5,000 init pods, then two batches
          of 2,000 measured maxSkew-5 pods (the auction with its spread
          repair)
  anti    SchedulingPodAntiAffinity/5000Nodes: 1,000 init pods, then two
          batches of 1,000 measured pods (the auction with its inter-pod
          repair)
  spread_greedy, anti_greedy
          the same batches through TorchBatchScheduler(mode="greedy",
          use_wavefront=False): the scan
  spread_wave
          TopologySpreading/5000Nodes: 5,000 init pods (the auction), then
          four batches of 500 measured pods (the wavefront)
  affinity
          SchedulingPodAffinity/5000Nodes: 1,000 init and 1,000 measured
          pods in batches of 500 (the wavefront)

The workloads after `north` run other, this, this, other, warm.  The first batch of a
process pays torch's lazy loads and the kernels' build, and the first
batch of a family its ops' lazy loads: read the last batch.  Prints one JSON
object a run: each batch's wall time, encode_s, compile_s, solve_s, the
rounds where the route records them, and, where the tree records them,
the encode's host split and the host->card bytes; with --log also
appends them to PATH.
"""

from __future__ import annotations

import json
import subprocess
import sys

PROG = r'''
import json, time, torch
from kubernetes_tpu_torch.models.batch_scheduler import TorchBatchScheduler
from kubernetes_tpu_torch.testing import cases, wrappers as w
kw, workload = json.loads(%r)


def node(i):
    return (w.make_node(f"node-{i}").capacity(cpu_milli=4000, mem=32 * w.GI, pods=110)
            .zone(f"zone-{i %% 8}").obj())


def pods(prefix, n):
    return [w.make_pod(f"{prefix}-{i}").req(cpu_milli=100, mem=500 * w.MI).obj()
            for i in range(n)]


if workload == "north":
    nodes, batches = [node(i) for i in range(50000)], [pods(f"b{b}", 10000) for b in range(3)]
elif workload == "basic":
    nodes, batches = [node(i) for i in range(5000)], [pods("init", 1000), pods("measured", 1000)]
elif workload in ("spread", "spread_greedy"):
    nodes, init, measured = cases.topology_spreading_objects(w, 5000, 5000, 4000)
    batches = [init, measured[:2000], measured[2000:]]
elif workload == "spread_wave":
    nodes, init, measured = cases.topology_spreading_objects(w, 5000, 5000, 2000)
    batches = [init] + [measured[k:k + 500] for k in range(0, 2000, 500)]
elif workload == "affinity":
    nodes, init, measured = cases.pod_affinity_objects(w, 5000, 1000, 1000)
    batches = [b[k:k + 500] for b in (init, measured) for k in (0, 500)]
else:
    nodes, init, measured = cases.pod_anti_affinity_objects(w, 5000, 1000, 2000)
    batches = [init, measured[:1000], measured[1000:]]
if workload.endswith("_greedy"):
    kw = dict(kw, mode="greedy", use_wavefront=False)
s = TorchBatchScheduler(**kw)
for n in nodes:
    s.add_node(n)
out = {"kw": kw, "workload": workload}
for b, batch in enumerate(batches):
    torch.cuda.synchronize()
    t = time.perf_counter()
    names = s.schedule_pending(batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    meta = s.last_solve.meta
    out[f"batch{b}"] = {"s": dt, "encode_s": s.last_timings["encode_s"],
                        "compile_s": s.last_timings["compile_s"],
                        "solve_s": s.last_timings.get("solve_s"),
                        "route": meta.route, "rounds": int(getattr(s.last_result, "rounds", -1)),
                        "split": getattr(meta, "encode_split", None),
                        "bytes": getattr(meta, "transfer_bytes", None)}
    for p, n in zip(batch, names):
        if n is not None:
            s.assume(p, n)
print("RESULT " + json.dumps(out), flush=True)
'''


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = sys.argv[1]
    log = sys.argv[sys.argv.index("--log") + 1] if "--log" in sys.argv else None
    workload = sys.argv[sys.argv.index("--workload") + 1] if "--workload" in sys.argv else "north"
    if workload not in ("north", "basic", "spread", "anti", "spread_greedy", "anti_greedy",
                        "spread_wave", "affinity"):
        print(__doc__, file=sys.stderr)
        return 2
    if workload == "north":
        runs = [(other, {}), (".", {}), (".", {"use_mirror": False}),
                (".", {}), (other, {}), (".", {"use_mirror": False})]
    else:
        runs = [(other, {}), (".", {}), (".", {}), (other, {})]
    for tree, kw in runs:
        r = subprocess.run([sys.executable, "-c", PROG % json.dumps([kw, workload])], cwd=tree,
                           capture_output=True, text=True, timeout=600)
        line = [x for x in r.stdout.splitlines() if x.startswith("RESULT ")]
        if r.returncode or not line:
            print(f"north_ab: run in {tree} {kw} failed\n{r.stderr[-2000:]}", file=sys.stderr)
            return 1
        out = dict(json.loads(line[0][len("RESULT "):]), tree=tree)
        print(json.dumps(out), flush=True)
        if log is not None:
            with open(log, "a") as f:
                f.write(json.dumps(out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
