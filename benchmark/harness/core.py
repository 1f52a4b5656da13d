"""Find a cell's files by name, run it once, print the result line.

A cell ``<cell>`` is ``benchmark/workloads/<cell>.json``: its
configuration (``benchmark/configs/<config>.json``), the name of its
traffic mix and the mix's parameters (``mix``, whose ``driver`` names
``benchmark/drivers/<driver>.py``), its precision, its end-to-end metrics
and the limits of its correctness check.  Per-layer metrics are
``benchmark/metrics/<metric>.py``, each with ``UNIT``, ``LAYER``,
``MOVES``, ``WORKLOADS`` and ``read(trace)``; a traced run of a cell
reports those whose ``WORKLOADS`` name it.  Adding a cell, a
configuration, a traffic mix or a metric adds files and edits none.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "prior_diffuse_tpu")


def load_json(kind: str, name: str) -> dict:
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    return json.loads(path.read_text())


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict

    @property
    def precision(self) -> str:
        return self.workload["precision"]

    @property
    def limits(self) -> dict:
        return self.workload["limits"]


def load_cell(name: str, traffic_overrides: Optional[dict] = None) -> Cell:
    work = load_json("workloads", name)
    traffic = dict(work["mix"], **(traffic_overrides or {}))
    return Cell(name, work, load_json("configs", work["config"]), traffic)


def _module(path: Path, tag: str):
    """The module in file ``path``, loaded under a name of its own."""
    spec = importlib.util.spec_from_file_location(f"benchmark_{tag}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(name: str):
    path = BENCH / "drivers" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no driver named {name!r} ({path})")
    return _module(path, "driver").Driver


@dataclass
class Metric:
    name: str
    unit: str
    layer: str
    moves: str
    workloads: List[str]
    read: Callable


def metrics() -> Dict[str, Metric]:
    """Every per-layer metric under ``benchmark/metrics``, by name."""
    out = {}
    for path in sorted((BENCH / "metrics").glob("*.py")):
        mod = _module(path, "metric")
        out[path.stem] = Metric(path.stem, mod.UNIT, mod.LAYER, mod.MOVES, list(mod.WORKLOADS),
                                mod.read)
    return out


@dataclass
class Context:
    cell: Cell
    seed: int
    device: object
    phases: Optional[List[list]] = None
    _last: float = 0.0

    def mark(self, name: str) -> None:
        """Book the seconds since the last mark to set-up phase ``name``."""
        now = time.perf_counter()
        if self.phases is not None:
            self.phases.append([name, now - self._last])
        self._last = now


@dataclass
class Reading:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit  # NaN fails


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def device_info(torch, device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}


def run_cell(name: str, seed: int, seconds: float, trace: bool, device=None,
             t_start: Optional[float] = None, traffic_overrides: Optional[dict] = None,
             mutate: Optional[Callable] = None, control: Optional[str] = None) -> dict:
    """Run cell ``name`` once: set-up and warm-up, the measured window,
    then the check against the reference.  Returns the result object
    (``checks`` last).  ``mutate(driver)``, called once the driver has
    built the program and before it drives it, lets a test break the
    program under the harness; ``traffic_overrides`` let a test
    shrink the traffic.  The result holds the check's further readings,
    where the driver keeps some (``detail``), and with ``control`` the
    control's readings: the reference in that precision in the program's
    place (``benchmark/calibrate.py``)."""
    import torch

    from benchmark.harness import trace as tr

    t_start = time.perf_counter() if t_start is None else t_start
    cell = load_cell(name, traffic_overrides)
    device = torch.device(device or "cuda")
    cuda = device.type == "cuda"
    ctx = Context(cell, seed, device, [], t_start)
    ctx.mark("imports")
    driver = load_driver(cell.traffic["driver"])(ctx)
    driver.mutate = mutate
    driver.setup()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    window = min(seconds, cell.traffic.get("trace_seconds", seconds)) if trace else seconds
    spans = tr.Spans(cuda) if trace else None
    with tr.profiled(trace and cuda) as prof:
        t0 = time.perf_counter()
        driver.window(window, spans)
        if cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if hasattr(driver, "after_window"):  # what the check samples past the window's close
        driver.after_window()

    if trace:
        counts = driver.trace_counts()
        summary = (tr.summarize(prof, window_s, spans, counts) if prof is not None
                   else tr.TraceSummary(window_s, 0.0, {}, 0, [], spans, counts))
        values = {}
        for m in metrics().values():
            if name in m.workloads:
                v = m.read(summary)
                if v is not None:
                    values[m.name] = {"value": v, "unit": m.unit}
    else:
        values = {k: {"value": v, "unit": u} for k, (v, u) in driver.end_to_end(window_s).items()}
        values["setup_s"] = {"value": setup_s, "unit": "s"}
    attempted, failed = driver.attempted, driver.failed
    driver.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    readings = driver.check()

    result = {"correct": bool(readings) and all(r.ok for r in readings),
              "attempted": attempted, "failed": failed, "metrics": values,
              "device": dict(device_info(torch, device), memory_peak_bytes=int(peak))}
    if trace:
        result["device"].update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = summary.breakdown()
    result["setup_phases"] = ctx.phases
    if getattr(driver, "detail", None):
        result["detail"] = dict(driver.detail)
    if control is not None:
        result["control"] = dict(driver.control(control), precision=control)
    result["checks"] = {r.name: {"value": r.value, "limit": r.limit} for r in readings}
    return result


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    chips = load_json("workloads", args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the process loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    phases = result.pop("setup_phases")
    print("setup phases (s): " + ", ".join(f"{n} {v:.2f}" for n, v in phases), file=sys.stderr)
    for key, c in result["checks"].items():
        print(f"check {key}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
