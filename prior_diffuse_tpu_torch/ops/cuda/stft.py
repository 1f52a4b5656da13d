"""K1 (STFT) and K2 (ISTFT) wrappers for the 320/160 framing.

Kernels: ``csrc/stft.cu``.  Plain versions: :func:`stft_plain` and
:func:`istft_plain` (``signal/stft.py``).  Each wrapper counts its kernel
launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from prior_diffuse_tpu_torch.ops import build
from prior_diffuse_tpu_torch.ops.cuda._launch import (check_operand, on_cuda,
                                                      on_device, stream)
from prior_diffuse_tpu_torch.signal.stft import (_envelope_np, frame_count, hann_window,
                                                 istft_plain, stft_plain)

__all__ = ["stft", "istft", "stft_plain", "istft_plain"]

HOP, WIN = 160, 320
FREQ = WIN // 2 + 1
# K2's output rows per block, one of the kernel's instantiations
# ``ISTFT_TILES``: the fastest at the serving shape [8, 301] and the eval
# shape [6, 401] (``tools/kernel_probe.py k2``, PERF.md)
ISTFT_TILES = (4, 8, 16)
ISTFT_ROWS = 4


def _unit(n: int, count: int, sign: float) -> np.ndarray:
    """``e^{sign 2 pi i m / n}`` for ``m < count``, (re, im) interleaved, f64."""
    ang = sign * 2.0 * np.pi * np.arange(count) / n
    return np.stack([np.cos(ang), np.sin(ang)], axis=-1).reshape(-1)


def fft_table_np() -> np.ndarray:
    """K1's ``[962]`` float32 table: the Hann window (as the plain version
    applies it), then ``e^{-2 pi i m / 160}`` for ``m < 160`` and
    ``e^{-2 pi i k / 320}`` for ``k <= 160``, (re, im) interleaved, built in
    float64 and cast to float32."""
    return np.concatenate([hann_window(WIN).astype(np.float64), _unit(HOP, HOP, -1),
                           _unit(WIN, FREQ, -1)]).astype(np.float32)


def istft_table_np() -> np.ndarray:
    """K2's ``[1280]`` float32 table: the Hann window / 320 (synthesis
    window and inverse scale in one factor), then ``e^{+2 pi i m / 160}``
    for ``m < 160`` and ``e^{+2 pi i k / 320}`` for ``k < 160``, (re, im)
    interleaved, then the floored window-square envelope of rows 1..T-1
    and of row T (``[2, 160]``), built in float64 and cast to float32."""
    env = _envelope_np(3, WIN, HOP)  # rows 0..3 of a 3-frame signal
    return np.concatenate([hann_window(WIN).astype(np.float64) / WIN, _unit(HOP, HOP, 1),
                           _unit(WIN, HOP, 1), env[HOP:2 * HOP], env[3 * HOP:]]
                          ).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _device_operands(device: torch.device):
    """K1's and K2's tables on ``device``."""
    put = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return put(fft_table_np()), put(istft_table_np())


def check_no_grad(x: torch.Tensor) -> None:
    """K1 has no backward (nor had the TPU kernel): it is fed data, never
    parameters.  An input that needs a gradient would silently lose it,
    so it is refused, on every device alike."""
    if x.requires_grad and torch.is_grad_enabled():
        raise ValueError("the STFT kernel has no backward: pass an input that "
                         "does not require grad, or run under torch.no_grad()")


def stft(x: torch.Tensor) -> torch.Tensor:
    """Centred STFT ``[B, L] -> [B, L // 160 + 1, 161, 2]`` (K1 on CUDA)."""
    check_no_grad(x)
    if not on_cuda(x):
        return stft_plain(x)
    if x.ndim != 2:
        raise ValueError(f"stft kernel takes [B, L], got {tuple(x.shape)}")
    check_operand("x", x, x.device)
    b, length = x.shape
    if length <= WIN // 2:
        raise ValueError(f"signal length {length} must exceed {WIN // 2} "
                         "for a centred (reflect-padded) STFT")
    t = frame_count(length)
    out = torch.empty((b, t, FREQ, 2), dtype=torch.float32, device=x.device)
    tab, _ = _device_operands(x.device)
    if b:
        with on_device(x.device):
            err = build.library().pdt_stft_f32(
                x.data_ptr(), tab.data_ptr(), out.data_ptr(), b, length, t,
                stream(x.device))
        build.check(err, "stft kernel")
        stft.launches += 1
    return out


def istft(spec: torch.Tensor, length: int) -> torch.Tensor:
    """Inverse STFT ``[B, T, 161, 2] -> [B, length]`` (K2 on CUDA)."""
    if not on_cuda(spec):
        return istft_plain(spec, length=length)
    if spec.ndim != 4 or spec.shape[2:] != (FREQ, 2):
        raise ValueError(f"istft kernel takes [B, T, 161, 2], got {tuple(spec.shape)}")
    check_operand("spec", spec, spec.device)
    if spec.data_ptr() % 8:
        raise ValueError("spec must start on an 8-byte boundary (the kernel "
                         "loads its bins as float2)")
    b, t = spec.shape[:2]
    if length < 0 or t < 1:
        raise ValueError(f"need length >= 0 and T >= 1 (got {length}, {t})")
    out = torch.empty((b, length), dtype=torch.float32, device=spec.device)
    _, tab = _device_operands(spec.device)
    if b and length:
        with on_device(spec.device):
            err = build.library().pdt_istft_f32(
                spec.data_ptr(), tab.data_ptr(), out.data_ptr(), b, t, length,
                ISTFT_ROWS, stream(spec.device))
        build.check(err, "istft kernel")
        istft.launches += 1
    return out


stft.launches = 0
istft.launches = 0
