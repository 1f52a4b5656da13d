"""The traced run's readings: device intervals, idle gaps, spans, counts.

A traced run profiles its window with ``torch.profiler`` (CPU and CUDA
activities) and reduces the kineto events to a :class:`TraceSummary`:

* ``busy_s``: the union of the device operations' intervals (kernels,
  copies, fills), so that overlapping streams count once;
* ``window_s``: the host clock from the window's first call to its last
  result;
* ``device_ops``: each device operation's summed seconds by name;
* ``idle_gaps``: the longest gaps between device intervals, each named by
  the innermost host span or operator open at its middle;
* ``spans``: CUDA-event milliseconds and host seconds the harness took
  around its own calls into the program (:class:`Spans`);
* ``counts``: what the driver counted in the window (batches, steps,
  model FLOPs, the encoder stages' least time).

Per-layer metric readers (``benchmark/metrics``) take their numbers from
it.
"""

from __future__ import annotations

import contextlib
import functools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


def union_seconds(intervals: List[Tuple[float, float]]) -> float:
    """Total length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The holes between the union of ``intervals``, in time order."""
    out, cur_e = [], None
    for s, e in sorted(intervals):
        if cur_e is not None and s > cur_e:
            out.append((cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    return out


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (linear between order statistics)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


class Spans:
    """Wraps bound methods of the harness's own program objects: each call
    runs inside ``torch.profiler.record_function(name)`` between two CUDA
    events, and, with ``sync``, ends in ``torch.cuda.synchronize()`` so
    its host seconds hold its device work.  Nothing of the program's
    modules is patched: the wrapper is set on the instance."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.events: Dict[str, list] = {}
        self.host: Dict[str, List[float]] = {}

    def wrap(self, obj, attr: str, name: str, sync: bool = False):
        fn = getattr(obj, attr)

        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with self.span(name, sync):
                return fn(*args, **kwargs)

        setattr(obj, attr, inner)

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False):
        with torch.profiler.record_function(name):
            if self.cuda:
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if self.cuda:
                    end.record()
                    self.events.setdefault(name, []).append((start, end))
                    if sync:
                        torch.cuda.synchronize()
                self.host.setdefault(name, []).append(time.perf_counter() - t0)

    def event_ms(self, name: str) -> Optional[float]:
        """Summed CUDA-event milliseconds of span ``name`` (None if absent)."""
        pairs = self.events.get(name)
        if not pairs:
            return None
        torch.cuda.synchronize()
        return float(sum(s.elapsed_time(e) for s, e in pairs))


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_ops: Dict[str, float]
    launches: int
    idle_gaps: List[Tuple[str, float]]
    spans: Spans
    counts: Dict[str, float] = field(default_factory=dict)

    def kernel_seconds(self, name: str) -> float:
        """Device seconds of the operations whose name contains ``name``."""
        return sum(s for k, s in self.device_ops.items() if name in k)

    def breakdown(self) -> dict:
        top = sorted(self.device_ops.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k[:120], v] for k, v in top],
                "idle_gaps": [[k[:120], v] for k, v in self.idle_gaps[:10]]}


def summarize(prof, window_s: float, spans: Spans, counts: dict) -> TraceSummary:
    """Reduce a finished profile of the window to a :class:`TraceSummary`."""
    from torch.autograd import DeviceType

    dev, cpu = [], []
    for e in prof.profiler.kineto_results.events():
        if getattr(e, "is_hidden_event", lambda: False)():
            continue
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
        elif e.device_type() == DeviceType.CPU:
            cpu.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
    intervals = [(s, e) for s, e, _ in dev]
    by_name: Dict[str, float] = {}
    for s, e, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e9
    holes = sorted(gaps(intervals), key=lambda h: h[0] - h[1])[:10]
    named = []
    if cpu and holes:
        starts = np.array([c[0] for c in cpu], np.int64)
        ends = np.array([c[1] for c in cpu], np.int64)
        for a, b in holes:
            mid = (a + b) // 2
            open_ = np.nonzero((starts <= mid) & (ends >= mid))[0]
            if len(open_):
                inner = open_[np.argmin(ends[open_] - starts[open_])]
                label = cpu[inner][2]
            else:
                label = "host: no span open"
            named.append((label, (b - a) / 1e9))
    return TraceSummary(window_s=window_s, busy_s=union_seconds(intervals) / 1e9,
                        device_ops=by_name, launches=len(dev), idle_gaps=named,
                        spans=spans, counts=dict(counts))


@contextlib.contextmanager
def profiled(enabled: bool):
    """``torch.profiler.profile`` over the block when ``enabled`` (else
    yields None)."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof
