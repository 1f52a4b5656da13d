"""Profiling utilities.

The counterpart of ``prior_diffuse_tpu/utils/profiler.py`` on
``torch.profiler``:

* :class:`StepTimer` — rolling step-time / throughput statistics, step to
  step (the trainers' ``step_time_ms`` and ``utt_per_sec``);
* :func:`trace` — context manager around a ``torch.profiler`` capture that
  writes a Chrome trace (view with Perfetto, ``chrome://tracing`` or
  TensorBoard's profiler plugin) and, beside it, ``spans.json``: each
  span's calls, host and stream time, and the device work it launched;
  each request's spans; the counters;
* :func:`span` and :func:`count` — the program's own spans and counters,
  recorded only while a ``torch.profiler`` capture runs (any capture: the
  benchmark's traced window, ``--profile-steps``); :func:`snapshot` reads
  them, :func:`reset` clears them;
* :func:`flops_estimate` — the floating-point operations of one call,
  counted by ``torch.utils.flop_counter`` (the ptflops analog);
* :func:`nan_guard` — autograd's anomaly detection.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler


class StepTimer:
    """Rolling mean of step wall-times with items/sec: each :meth:`tick`
    times from the last one, so a step's time holds everything between two
    steps' readbacks (the loader's wait, the metrics write), and the first
    tick has none."""

    def __init__(self, window: int = 50):
        self._times: Deque[float] = deque(maxlen=window)
        self._last: Optional[float] = None

    def tick(self) -> Optional[float]:
        """Call once per step; returns the last step duration (s)."""
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self._times.append(dt)
        self._last = now
        return dt

    @property
    def mean(self) -> float:
        return sum(self._times) / len(self._times) if self._times else 0.0

    def items_per_sec(self, batch_size: int) -> float:
        return batch_size / self.mean if self.mean else 0.0


# ---- the program's spans and counters ----------------------------------------


def tracing() -> bool:
    """True while a ``torch.profiler`` capture runs, the only time spans and
    counters record."""
    return _autograd_profiler._is_profiler_enabled


class _Record:
    __slots__ = ("name", "start_ns", "end_ns", "parent", "request", "device", "events",
                 "stream_ms")


class Registry:
    """The spans and counters recorded while tracing is on, in memory.  A
    span opened with none open starts a request; its descendants share its
    request id."""

    def __init__(self):
        self.spans: List[_Record] = []
        self.open: List[_Record] = []
        self.counters: Dict[str, int] = {}
        self.requests = 0

    def clear(self) -> None:
        self.spans, self.open, self.counters = [], [], {}


REGISTRY = Registry()


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("rec", "annotation")

    def __init__(self, name: str, device):
        rec = _Record()
        rec.name = name
        rec.device = None if device is None else torch.device(device)
        rec.end_ns = rec.stream_ms = rec.events = None
        self.rec = rec

    def __enter__(self):
        rec, reg = self.rec, REGISTRY
        # kineto stamps its host events in Unix-epoch nanoseconds: the
        # annotation's start inside the call that opens it (the record's
        # start is that call's middle), its end just before the call that
        # closes it returns
        self.annotation = _autograd_profiler.record_function(rec.name)
        before = time.time_ns()
        self.annotation.__enter__()
        rec.start_ns = (before + time.time_ns()) // 2
        rec.parent = reg.open[-1] if reg.open else None
        if rec.parent is None:
            reg.requests += 1
            rec.request = reg.requests
        else:
            rec.request = rec.parent.request
        if (rec.device is not None and rec.device.type == "cuda"
                and not (torch.cuda.is_available()
                         and torch.cuda.is_current_stream_capturing())):
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record()
        reg.spans.append(rec)
        reg.open.append(rec)

    def __exit__(self, *exc):
        rec, reg = self.rec, REGISTRY
        if rec.events is not None:
            rec.events[1].record()
        if reg.open and reg.open[-1] is rec:
            reg.open.pop()
        self.annotation.__exit__(*exc)
        rec.end_ns = time.time_ns()
        return False


def span(name: str, device=None):
    """A span around the enclosed block, while tracing is on (else a flag
    test and nothing more): a ``record_function(name)`` annotation on the
    profiler's timeline and a registry record (name, host start and end on
    the profiler's clock, parent, request id) with, where ``device`` is a
    CUDA device, CUDA events on the current stream (the process's device:
    ranks set theirs) whose elapsed time is the span's stream
    milliseconds; a span of host work passes no device and records no
    events, nor does a span inside a CUDA-graph capture (its work runs at
    the replays).  No synchronisation."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while tracing is on."""
    if _autograd_profiler._is_profiler_enabled:
        REGISTRY.counters[name] = REGISTRY.counters.get(name, 0) + n


def _stream_ms(rec: _Record) -> Optional[float]:
    if rec.stream_ms is None and rec.events is not None and rec.end_ns is not None:
        rec.events[1].synchronize()
        rec.stream_ms = float(rec.events[0].elapsed_time(rec.events[1]))
    return rec.stream_ms


def _records_dict(records: Sequence[_Record]) -> List[dict]:
    index = {id(r): i for i, r in enumerate(records)}
    return [{"name": r.name, "start_ns": r.start_ns, "end_ns": r.end_ns,
             "parent": index.get(id(r.parent), -1), "request": r.request,
             "stream_ms": _stream_ms(r)} for r in records]


def counters() -> Dict[str, int]:
    """The registry's counters, and the kernel wrappers' own launch counts
    (counted whether or not tracing is on) under ``kernel.k1`` (STFT),
    ``kernel.k2`` (ISTFT), ``kernel.k3`` and ``kernel.k3_bf16`` (the
    encoder stage)."""
    from prior_diffuse_tpu_torch.ops.cuda import convblock, stft

    out = dict(REGISTRY.counters)
    out.update({"kernel.k1": stft.stft.launches, "kernel.k2": stft.istft.launches,
                "kernel.k3": convblock.enc_stage.launches,
                "kernel.k3_bf16": convblock.enc_stage_bf16.launches})
    return out


def snapshot() -> dict:
    """The registry as plain data.  ``spans``: one dict a span in the order
    they opened: ``name``, ``start_ns`` and ``end_ns`` (None while open) on
    the profiler's host clock, ``parent`` (its index in the list, -1 for
    none), ``request``, ``stream_ms`` (None without CUDA events; reading it
    waits for the span's device work).  ``counters``: :func:`counters`."""
    return {"spans": _records_dict(REGISTRY.spans), "counters": counters()}


def reset() -> None:
    """Clear the registry's spans and counters."""
    REGISTRY.clear()


def span_totals(spans: Sequence[dict]) -> Dict[str, dict]:
    """Per span name over the closed spans of a :func:`snapshot`'s list:
    ``calls``, ``host_s``, ``self_host_s`` (the host time its child spans
    do not cover) and ``stream_ms`` (None off a CUDA device)."""
    child_ns = [0] * len(spans)
    for s in spans:
        if s["end_ns"] is not None and s["parent"] >= 0:
            child_ns[s["parent"]] += s["end_ns"] - s["start_ns"]
    out: Dict[str, dict] = {}
    for s, inner in zip(spans, child_ns):
        if s["end_ns"] is None:
            continue
        d = out.setdefault(s["name"], {"calls": 0, "host_s": 0.0, "self_host_s": 0.0,
                                       "stream_ms": None})
        dur = s["end_ns"] - s["start_ns"]
        d["calls"] += 1
        d["host_s"] += dur / 1e9
        d["self_host_s"] += (dur - inner) / 1e9
        if s["stream_ms"] is not None:
            d["stream_ms"] = (d["stream_ms"] or 0.0) + s["stream_ms"]
    return out


def _merged(intervals) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def attribute(spans: Sequence[Tuple[str, int, int]],
              device_ops: Sequence[Tuple[int, int, int]],
              launch_ns: Dict[int, int]) -> Dict[str, dict]:
    """The device work under each span name, from host intervals ``spans``
    ``(name, start_ns, end_ns)``, device operations ``(start_ns, end_ns,
    correlation id)`` and the host time of the runtime call that launched
    each correlation id: ``launches``, the device operations launched
    inside the span (a parent's include its children's);
    ``device_busy_s``, the union of their device intervals; and
    ``device_idle_s``, the part of the span's host interval that no device
    operation covers."""
    ops = sorted((launch_ns[c], s, e) for s, e, c in device_ops if c in launch_ns)
    at = [o[0] for o in ops]
    union = _merged((s, e) for s, e, _ in device_ops)
    ends = [e for _, e in union]
    out: Dict[str, dict] = {}
    for name, s, e in spans:
        lo, hi = bisect.bisect_left(at, s), bisect.bisect_right(at, e)
        busy = sum(b - a for a, b in _merged((o[1], o[2]) for o in ops[lo:hi]))
        covered = 0
        for a, b in union[bisect.bisect_right(ends, s):]:
            if a >= e:
                break
            covered += min(b, e) - max(a, s)
        d = out.setdefault(name, {"launches": 0, "device_busy_s": 0.0, "device_idle_s": 0.0})
        d["launches"] += hi - lo
        d["device_busy_s"] += busy / 1e9
        d["device_idle_s"] += (e - s - covered) / 1e9
    return out


def _kineto_events(prof):
    """The capture's user annotations ``(name, start_ns, end_ns)``, device
    operations ``(start_ns, end_ns, correlation id)`` and the start of each
    CUDA runtime or driver call by correlation id."""
    from torch.autograd import DeviceType

    notes, ops, launches = [], [], {}
    for e in prof.profiler.kineto_results.events():
        if getattr(e, "is_hidden_event", lambda: False)():
            continue
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                ops.append((start, end, e.correlation_id()))
        elif e.is_user_annotation():
            notes.append((e.name(), start, end))
        elif _is_launch(e):
            launches[e.correlation_id()] = start
    return notes, ops, launches


def _is_launch(event) -> bool:
    """A CUDA runtime or driver call (by its kineto activity type, else by
    the ``cuda``/``cu`` prefix of those calls' names)."""
    kind = getattr(event, "activity_type", None)
    if kind is not None:
        return kind() in ("cuda_runtime", "cuda_driver")
    return event.name().startswith("cu")


def requests(spans: Sequence[dict]) -> List[dict]:
    """Per request (one ``enhance_files`` or ``enhance_long`` call, one
    train step) of a :func:`snapshot`'s closed spans: ``request``, its
    outermost span's ``name`` and ``host_s``, and ``spans``, the host
    seconds of each span name inside it: which call or step was slow, and
    where."""
    out: Dict[int, dict] = {}
    for s in spans:
        if s["end_ns"] is None:
            continue
        host_s = (s["end_ns"] - s["start_ns"]) / 1e9
        if s["parent"] < 0:
            out[s["request"]] = {"request": s["request"], "name": s["name"], "host_s": host_s,
                                 "spans": {}}
        elif s["request"] in out:
            inner = out[s["request"]]["spans"]
            inner[s["name"]] = inner.get(s["name"], 0.0) + host_s
    return list(out.values())


def spans_report(prof, records: Sequence[_Record], counted: Dict[str, int]) -> dict:
    """``spans.json``: per span name of ``records`` its :func:`span_totals`
    and, from the finished capture ``prof``, its :func:`attribute` (over
    the profiler's own annotations of that name); ``requests``
    (:func:`requests`); ``counters``, the capture's ``counted`` counters
    (``enh.repacks``: a repack inside a capture is a fault of the serving
    cache; the front end's samples; the kernels' launches);
    ``device_ops``, the capture's device operations, and ``launched``,
    those whose launching call the capture holds."""
    spans = _records_dict(records)
    totals = span_totals(spans)
    notes, ops, launches = _kineto_events(prof)
    work = attribute([n for n in notes if n[0] in totals], ops, launches)
    for name, d in totals.items():
        d.update(work.get(name, {"launches": 0, "device_busy_s": 0.0, "device_idle_s": 0.0}))
    return {"device_ops": len(ops), "launched": sum(c in launches for _, _, c in ops),
            "counters": counted, "spans": totals, "requests": requests(spans)}


@contextlib.contextmanager
def trace(log_dir: str, device: Optional[torch.device] = None):
    """Capture a ``torch.profiler`` trace of the enclosed block into
    ``log_dir/<host>_<pid>.<time>.pt.trace.json``: host activity, and the
    card's kernels (CUPTI; the ctypes-launched kernels of ``csrc/``
    included) when ``device`` is a CUDA device; then write
    ``log_dir/spans.json`` (:func:`spans_report`) for the spans and
    counters recorded during the capture.  Around a serving call
    (``enhance_files``, ``enhance_long``) it gives the same for the front
    end's and the enhancer's spans."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    begin, before = time.time_ns(), counters()
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield
    records = [r for r in REGISTRY.spans if r.start_ns >= begin]
    counted = {k: v - before.get(k, 0) for k, v in counters().items()}
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump(spans_report(prof, records, counted), f, indent=1)


def flops_estimate(fn, *args) -> float:
    """Floating-point operations of ``fn(*args)``, counted while it runs.

    Unlike XLA's ahead-of-time cost analysis (the JAX package's), this
    **executes** ``fn`` once, under ``torch.utils.flop_counter.
    FlopCounterMode``.  It counts the aten operators that have a FLOP
    formula (products, convolutions, attention); the hand-written kernels
    of ``csrc/`` count 0, as XLA's analysis does not count a Pallas
    kernel's body either.  An error of ``fn`` propagates, as a tracing
    error does in JAX; the JAX function's other ``None`` (no analysis
    available) has no counterpart: the counter always has a total."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())


def nan_guard(enable: bool = True) -> None:
    """Turn autograd's anomaly detection on or off: a backward that
    produces NaN raises at the forward operation that caused it (the JAX
    package's ``jax_debug_nans``)."""
    torch.autograd.set_detect_anomaly(enable)
