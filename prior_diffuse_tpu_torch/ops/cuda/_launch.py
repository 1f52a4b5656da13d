"""Shared checks and arguments for the ctypes kernel launches."""

from __future__ import annotations

import ctypes

import torch


def on_cuda(x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; other devices raise."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel or plain version for device {x.device}")
    return x.device.type == "cuda"


def check_operand(name: str, t: torch.Tensor, device: torch.device,
                  shape=None) -> None:
    """The kernels take contiguous float32 tensors on the launch device."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
