"""Time the north-star batches of two trees, in one run on one card.

    python3 north_ab.py OTHER_TREE [--log PATH]

OTHER_TREE is another checkout of this repository (for example the parent
commit unpacked with `git archive` into a git-ignored directory).  Each
run is a fresh process in that tree or in this one: 50,000 node-default
nodes, then three batches of 10,000 pod-default pods through
TorchBatchScheduler(), each batch's placements assumed before the next.
The runs go other, this (warm), this (cold: use_mirror=False), this
(warm), other, this (cold), so every version runs early and late.  The
first batch of a process pays torch's lazy loads and the kernels' build.
Prints one JSON object a run: each batch's wall time, encode_s,
compile_s, and, where the tree records them, the encode's host split and
the host->card bytes; with --log also appends them to PATH.
"""

from __future__ import annotations

import json
import subprocess
import sys

PROG = r'''
import json, time, torch
from kubernetes_tpu_torch.models.batch_scheduler import TorchBatchScheduler
from kubernetes_tpu_torch.testing import wrappers as w
kw = json.loads(%r)
s = TorchBatchScheduler(**kw)
for i in range(50000):
    s.add_node(w.make_node(f"node-{i}").capacity(cpu_milli=4000, mem=32 * w.GI, pods=110)
               .zone(f"zone-{i %% 8}").obj())
out = {"kw": kw}
for b in range(3):
    pods = [w.make_pod(f"b{b}-{i}").req(cpu_milli=100, mem=500 * w.MI).obj()
            for i in range(10000)]
    torch.cuda.synchronize()
    t = time.perf_counter()
    names = s.schedule_pending(pods)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    meta = s.last_solve.meta
    out[f"batch{b}"] = {"s": dt, "encode_s": s.last_timings["encode_s"],
                        "compile_s": s.last_timings["compile_s"],
                        "split": getattr(meta, "encode_split", None),
                        "bytes": getattr(meta, "transfer_bytes", None)}
    for p, n in zip(pods, names):
        s.assume(p, n)
print("RESULT " + json.dumps(out), flush=True)
'''


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = sys.argv[1]
    log = sys.argv[sys.argv.index("--log") + 1] if "--log" in sys.argv else None
    runs = [(other, {}), (".", {}), (".", {"use_mirror": False}),
            (".", {}), (other, {}), (".", {"use_mirror": False})]
    for tree, kw in runs:
        r = subprocess.run([sys.executable, "-c", PROG % json.dumps(kw)], cwd=tree,
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
