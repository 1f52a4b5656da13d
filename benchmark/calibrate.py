"""Readings behind a cell's correctness limits, many seeds in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control tf32|fp8 --control-seeds 1,2,3] [--fault KIND] [--seconds 2] [--out FILE]

For each seed, one run of the cell through ``core.run_cell`` with a short
window at its own load (``--seconds``): its result, with the check's
readings of the program against the reference and their further detail;
for each control seed also the control's readings (the reference in the
lower precision, in the program's place, against the reference in
float32).  With ``--fault`` the program runs with that fault of
``benchmark/harness/faults.py`` planted.  One JSON line a seed, on
standard output and in ``--out``.  The limits in
``benchmark/workloads/<cell>.json`` are set between the largest program
reading and the smallest control reading (PERF.md).  Needs the card, as
``run.py`` does.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from benchmark.harness import core, faults  # noqa: E402


def readings(cell: str, seed: int, seconds: float, control, device="cuda",
             traffic_overrides=None, mutate=None) -> dict:
    r = core.run_cell(cell, seed, seconds, False, device=device,
                      traffic_overrides=traffic_overrides, mutate=mutate, control=control)
    out = {"cell": cell, "seed": seed, "correct": r["correct"], "attempted": r["attempted"],
           "metrics": {k: m["value"] for k, m in r["metrics"].items()},
           "program": {k: c["value"] for k, c in r["checks"].items()},
           "detail": r.get("detail", {})}
    if control:
        out["control"] = r["control"]
    return out


def main():
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", choices=("tf32", "fp8"))
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--fault", choices=faults.KINDS)
    p.add_argument("--out")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in seeds + sorted(controls - set(seeds)):
        t0 = time.time()
        planted = (faults.mutate(args.fault, core.load_cell(args.workload).limits)
                   if args.fault else None)
        line = readings(args.workload, seed, args.seconds,
                        args.control if seed in controls else None, mutate=planted)
        line["fault"] = args.fault
        line["seconds"] = time.time() - t0
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
