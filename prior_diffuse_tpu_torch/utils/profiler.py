"""Profiling utilities.

The counterpart of ``prior_diffuse_tpu/utils/profiler.py`` on
``torch.profiler``:

* :func:`trace` — context manager around a ``torch.profiler`` capture that
  writes a Chrome trace (view with Perfetto, ``chrome://tracing`` or
  TensorBoard's profiler plugin);
* :func:`flops_estimate` — the floating-point operations of one call,
  counted by ``torch.utils.flop_counter`` (the ptflops analog);
* :func:`nan_guard` — autograd's anomaly detection.

The JAX module's ``StepTimer`` is not ported: the trainers time each step
alone (``step_time_ms``), not step to step as JAX's timer does.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch


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
