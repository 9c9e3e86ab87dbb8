"""Time the greedy_scan kernel built from two sources, in one run on one card.

    python3 kernel_ab.py OTHER_SOURCE.cu

Builds kubernetes_tpu_torch/csrc/greedy_scan.cu ("change") and
OTHER_SOURCE.cu ("other", for example the same file of another commit,
unpacked with `git archive` into a git-ignored directory) with build.py's
flags, each into its own library.  Both must keep greedy_scan's C
interface.  The input is chip_smoke.py's greedy phase: the measured
1,000-pod batch of SchedulingBasic/5000Nodes after its 1,000 init pods.
The two libraries run in the order other, change, change, other, twice;
each time is the mean of CUDA events around 5 launches after a warm-up.
Both outputs must equal the plain scan's.  Prints the card's name and
power limit, then one JSON object with every time.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import chip_smoke


def build_library(src: Path, out_dir: Path) -> ctypes.CDLL:
    from kubernetes_tpu_torch.kernels import build

    digest = hashlib.sha256(
        src.read_bytes()
        + b"".join(h.read_bytes() for h in sorted(src.parent.glob("*.cuh")))
        + " ".join(build.NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    out = out_dir / f"libgreedy_scan-{digest}.so"
    if not out.exists():
        subprocess.run(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(src.parent),
             "-o", str(out), str(src)],
            check=True,
        )
    lib = ctypes.CDLL(str(out))
    lib.greedy_scan_error_string.restype = ctypes.c_char_p
    lib.greedy_scan_error_string.argtypes = [ctypes.c_int]
    return lib


def main() -> int:
    import torch

    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 3
    from kubernetes_tpu_torch.kernels import bindings, build
    from kubernetes_tpu_torch.models.batch_scheduler import TorchBatchScheduler
    from kubernetes_tpu_torch.ops import assign
    from kubernetes_tpu_torch.testing import wrappers

    out_dir = build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {
        "change": build_library(build.CSRC_DIR / "greedy_scan.cu", out_dir),
        "other": build_library(Path(sys.argv[1]).resolve(), out_dir),
    }

    sched = TorchBatchScheduler(mode="greedy", use_wavefront=False)
    for node in chip_smoke.make_cluster(wrappers, chip_smoke.MAIN[0]):
        sched.add_node(node)
    init_pods = chip_smoke.make_pods(wrappers, chip_smoke.MAIN[1], "init")
    for pod, name in zip(init_pods, sched.schedule_pending(init_pods)):
        sched.assume(pod, name)
    snap, meta = sched.encode_pending(
        chip_smoke.make_pods(wrappers, chip_smoke.MAIN[2], "measured"))
    cluster, pods, sfeas, aff, taint = assign._solver_prep(snap, meta.features)[:5]
    order = assign.solve_order(pods)
    args = (cluster, pods, sfeas, aff, taint, order, meta.features, meta.n_groups,
            sched.score_config)
    want = assign.greedy_assign_plain(*args)

    def run(which):
        build._libs["greedy_scan"] = libs[which]
        out = bindings.greedy_scan(*args)
        chip_smoke.check_equal(f"greedy_scan ({which})", out, want, torch)
        return chip_smoke.cuda_ms(lambda: bindings.greedy_scan(*args), 5, torch)

    times = {"other": [], "change": []}
    for which in ("other", "change", "change", "other") * 2:
        times[which].append(run(which))
    print(chip_smoke.card_line(), flush=True)
    print(json.dumps({"kernel": "greedy_scan", "workload":
                      "SchedulingBasic/5000Nodes measured batch, mode=greedy",
                      "other_source": sys.argv[1], "ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
