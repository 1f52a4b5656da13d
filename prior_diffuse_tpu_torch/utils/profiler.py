"""Profiling utilities.

The counterpart of ``prior_diffuse_tpu/utils/profiler.py`` on
``torch.profiler``:

* :class:`StepTimer` — rolling step-time / throughput statistics, step to
  step (the trainers' ``step_time_ms`` and ``utt_per_sec``);
* :func:`trace` — context manager around a ``torch.profiler`` capture that
  writes a Chrome trace (view with Perfetto, ``chrome://tracing`` or
  TensorBoard's profiler plugin);
* :func:`flops_estimate` — the floating-point operations of one call,
  counted by ``torch.utils.flop_counter`` (the ptflops analog);
* :func:`nan_guard` — autograd's anomaly detection.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from typing import Deque, Optional

import torch


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


@contextlib.contextmanager
def trace(log_dir: str, device: Optional[torch.device] = None):
    """Capture a ``torch.profiler`` trace of the enclosed block into
    ``log_dir/<host>_<pid>.<time>.pt.trace.json``: host activity, and the
    card's kernels (CUPTI; the ctypes-launched kernels of ``csrc/``
    included) when ``device`` is a CUDA device."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


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
