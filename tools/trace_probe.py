#!/usr/bin/env python3
"""Are the kernel records of a ``--profile-steps`` trace complete? On one GPU.

    python3 tools/trace_probe.py [--sessions 0,30,30,30] [--json PATH]

Writes ``chip_smoke.py``'s training corpus (24 + 8 speech-like utterances of
3-4 s) and a one-epoch copy of ``conf/diff.yml``, then traces the first 2
steps of ``--joint --sigma`` training through the entry point:

* once in a process of its own (``python -m prior_diffuse_tpu_torch.cli
  ... --profile-steps 2``), as a user runs it;
* then in this process, once for each entry N of ``--sessions``, after N
  more short ``torch.profiler`` sessions of K1 (the kind ``chip_smoke.py``
  opens by the hundred before its phase 11).

For each trace it prints the kernel records against the kernel launch
calls (a launch call whose kernel has no record is a lost record), the
kernels in each step (``chip_smoke.trace_steps``), K1's records, the
memsets and copies, and how far a kernel's recorded start lies from its
launch call (negative: before it, a clock offset).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K1 = re.compile(r"(^|::|void )stft_kernel\(")


def inspect(trace_dir: str) -> dict:
    """The completeness of the one Chrome trace under ``trace_dir``."""
    import chip_smoke as cs

    (path,) = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    lag = np.array([e["ts"] - launch[e["args"]["correlation"]] for e in events
                    if e.get("cat") == "kernel" and e.get("args", {}).get("correlation") in launch])
    kernels, per_step, calls, copies = cs.trace_steps(trace_dir)
    return {"kernel_records": len(kernels), "launch_calls": calls,
            "lost": calls - len(kernels), "per_step": per_step,
            "k1": sum(bool(K1.search(k)) for k in kernels), "memsets_and_copies": copies,
            "lag_us_min": float(lag.min()), "lag_us_median": float(np.median(lag))}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sessions", default="0,30,30,30",
                    help="profiler sessions before each in-process trace")
    ap.add_argument("--json", help="also write the results to this file")
    a = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from prior_diffuse_tpu_torch import cli
    from prior_diffuse_tpu_torch.ops.cuda import stft as kstft

    if not torch.cuda.is_available():
        sys.exit("trace_probe: no CUDA card")
    card = cs.card_line()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    rows = []
    with tempfile.TemporaryDirectory(prefix="trace_probe_") as root:
        corpus = cs.write_train_corpus(root)
        with open(os.path.join(ROOT, "conf", "diff.yml")) as f:
            text = f.read()
        conf = os.path.join(root, "diff_1_epoch.yml")
        with open(conf, "w") as f:
            f.write(text.replace("n_epochs: 50", "n_epochs: 1"))
        args = ["--config", conf, "--joint", "--sigma", "--data-root", corpus, "--seed", "11",
                "--profile-steps", "2"]
        assets = os.path.join(root, "fresh")
        subprocess.run([sys.executable, "-m", "prior_diffuse_tpu_torch.cli", *args,
                        "--assets", assets], cwd=ROOT, check=True, capture_output=True,
                       env={**os.environ, "PYTHONPATH": ROOT})
        runs = [("a process of its own", assets)]
        x = torch.randn(6, 48000, device="cuda")
        done = 0
        for i, n in enumerate(int(v) for v in a.sessions.split(",")):
            with torch.no_grad():
                for _ in range(n):
                    cs.top_kernels(lambda: kstft.stft(x), calls=2)
            done += n
            assets = os.path.join(root, f"in_process_{i}")
            cli.main(args + ["--assets", assets])
            runs.append((f"in process, after {done} earlier sessions", assets))
        for label, assets in runs:
            row = {"run": label, **inspect(os.path.join(assets, "log", "diff", "trace"))}
            rows.append(row)
            print(json.dumps(row), flush=True)
    print(f"card: {card}", flush=True)
    if a.json:
        with open(a.json, "w") as f:
            json.dump({"card": card, "runs": rows}, f, indent=1)


if __name__ == "__main__":
    main()
