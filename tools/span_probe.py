#!/usr/bin/env python3
"""What the port's spans and counters cost, and what ``spans.json`` holds. On one GPU.

    python3 tools/span_probe.py [--calls 200000] [--json PATH]

* Off (no profiler running): nanoseconds a ``with span(...)`` block and a
  ``count(...)`` call add to an empty loop's iteration.
* On (inside a ``torch.profiler`` capture of the CPU and the card): the
  nanoseconds of a span on the card (its ``record_function`` annotation,
  two CUDA events, the registry record), of a span without a device, of
  an annotation alone, of a recorded pair of CUDA events alone, and of a
  counter; and what reading a span's stream milliseconds in
  ``snapshot()`` costs.
* ``python -m prior_diffuse_tpu_torch.cli --joint --sigma --profile-steps 2``
  on ``chip_smoke.py``'s training corpus and a one-epoch copy of
  ``conf/diff.yml``, in a process of its own: the ``spans.json`` it writes
  beside the Chrome trace, each ``train.*`` span's calls, host and stream
  time, device-busy and idle seconds and launches, and the share of the
  traced steps' device operations launched inside the five phases.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("train.features", "train.forward", "train.backward", "train.norms", "train.optimizer")


def per_call_ns(fn, calls: int) -> float:
    """Nanoseconds a call of ``fn``, best of three loops of ``calls``."""
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter_ns()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter_ns() - t0) / calls)
    return best


def costs(calls: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from prior_diffuse_tpu_torch.utils import profiler

    dev = torch.device("cuda")
    span, count = profiler.span, profiler.count

    def empty():
        pass

    def one_span():
        with span("probe.span", dev):
            pass

    def host_span():
        with span("probe.host"):
            pass

    def one_count():
        count("probe.count", 5)

    def annotation():
        with torch.autograd.profiler.record_function("probe.annotation"):
            pass

    def event_pair():
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        b.record()

    assert not profiler.tracing()
    base = per_call_ns(empty, calls)
    out = {"empty_call_ns": base,
           "off_span_ns": per_call_ns(one_span, calls) - base,
           "off_count_ns": per_call_ns(one_count, calls) - base}
    on_calls = max(calls // 100, 100)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        assert profiler.tracing()
        out["on_span_ns"] = per_call_ns(one_span, on_calls) - base
        out["on_host_span_ns"] = per_call_ns(host_span, on_calls) - base
        out["on_annotation_ns"] = per_call_ns(annotation, on_calls) - base
        out["on_event_pair_ns"] = per_call_ns(event_pair, on_calls) - base
        out["on_count_ns"] = per_call_ns(one_count, on_calls) - base
    n = len(profiler.REGISTRY.spans)
    t0 = time.perf_counter_ns()
    profiler.snapshot()
    out["snapshot_ns_per_span"] = (time.perf_counter_ns() - t0) / n
    profiler.reset()
    return out


def profile_steps() -> dict:
    """``spans.json`` of a ``--profile-steps 2`` run, and the phases' share
    of the traced steps' launches."""
    import chip_smoke as cs

    with tempfile.TemporaryDirectory(prefix="span_probe_") as root:
        corpus = cs.write_train_corpus(root)
        with open(os.path.join(ROOT, "conf", "diff.yml")) as f:
            text = f.read()
        conf = os.path.join(root, "diff_1_epoch.yml")
        with open(conf, "w") as f:
            f.write(text.replace("n_epochs: 50", "n_epochs: 1"))
        assets = os.path.join(root, "assets")
        done = subprocess.run([sys.executable, "-m", "prior_diffuse_tpu_torch.cli", "--config",
                               conf, "--joint", "--sigma", "--data-root", corpus, "--seed", "11",
                               "--profile-steps", "2", "--assets", assets],
                              cwd=ROOT, capture_output=True, text=True,
                              env={**os.environ, "PYTHONPATH": ROOT})
        if done.returncode:
            sys.exit(f"span_probe: the --profile-steps run exited {done.returncode}:\n"
                     f"{done.stderr[-4000:]}")
        with open(os.path.join(assets, "log", "diff", "trace", "spans.json")) as f:
            report = json.load(f)
    spans = report["spans"]
    step = spans["train.step"]["launches"]
    phases = sum(spans[p]["launches"] for p in PHASES if p in spans)
    return {"spans_json": report, "step_launches": step, "phase_launches": phases,
            "phase_share_of_step": phases / step if step else None,
            "phase_share_of_trace": phases / report["device_ops"] if report["device_ops"] else None}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=200000, help="calls a loop off the capture")
    ap.add_argument("--json", help="also write the results to this file")
    a = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        sys.exit("span_probe: no CUDA card")
    card = cs.card_line()
    out = {"card": card, "torch": torch.__version__, "costs": costs(a.calls)}
    print(json.dumps(out["costs"]), flush=True)
    out["profile_steps"] = profile_steps()
    print(json.dumps({k: v for k, v in out["profile_steps"].items() if k != "spans_json"}),
          flush=True)
    print(json.dumps(out["profile_steps"]["spans_json"], indent=1), flush=True)
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    if a.json:
        with open(a.json, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
