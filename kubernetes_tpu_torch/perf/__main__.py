"""CLI: python -m kubernetes_tpu_torch.perf [--config F] [--label L]
[--name N] [--out results.json] [--batch-size B] [--no-warmup]
[--device cpu]

The scheduler_perf entry point: runs the selected workloads against the
host scheduler on the CUDA card (raises without one unless --device cpu)
and prints/writes DataItems JSON (the reference's perf-dash format)."""

import argparse
import json

from . import DEFAULT_CONFIG, load_config, run_workloads, select


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default=DEFAULT_CONFIG)
    ap.add_argument("--label", default=None, help="e.g. integration-test, fast")
    ap.add_argument("--name", default=None, help="substring of Case/Workload")
    ap.add_argument("--out", default=None, help="write JSON here")
    ap.add_argument("--batch-size", type=int, default=4096)
    ap.add_argument(
        "--no-warmup", action="store_true",
        help="skip the pre-window kernel warmup (fully cold numbers)",
    )
    ap.add_argument(
        "--device", default=None, choices=("cpu",),
        help="cpu: the plain versions of the kernels (default: the card)",
    )
    args = ap.parse_args()
    wls = select(load_config(args.config), label=args.label, name=args.name)
    if not wls:
        raise SystemExit("no workloads selected")
    print(f"running {len(wls)} workloads: {[w.full_name for w in wls]}")
    result = run_workloads(
        wls, out_path=args.out, batch_size=args.batch_size,
        warmup=not args.no_warmup, device=args.device,
    )
    print(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
