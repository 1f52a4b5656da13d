"""Shared checks and arguments for the ctypes kernel launches.

Pointers and the stream go to the C entry points as Python ints (their
``argtypes`` are ``c_void_p``).  The launch path is kept thin: a kernel
call should cost the host no more than the PyTorch call it replaces.
"""

from __future__ import annotations

import contextlib

import torch


def on_cuda(x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; other devices raise."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel or plain version for device {x.device}")
    return x.device.type == "cuda"


def check_operand(name: str, t: torch.Tensor, device: torch.device,
                  shape=None, dtype: torch.dtype = torch.float32) -> None:
    """The kernels take contiguous tensors of ``dtype`` on the launch device."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def on_device(device: torch.device):
    """Make ``device`` current for a launch; no context switch when it is."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def stream(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as an int, from torch's raw
    getter (a few microseconds cheaper a launch than building a
    ``torch.cuda.Stream``)."""
    return torch._C._cuda_getCurrentRawStream(device.index)
