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
from prior_diffuse_tpu_torch.signal.stft import (_envelope_np, dft_matrices_np,
                                                 frame_count, hann_window,
                                                 istft_plain, stft_plain)

__all__ = ["stft", "istft", "stft_plain", "istft_plain"]

HOP, WIN = 160, 320
FREQ = WIN // 2 + 1


def _interleave_cols(m: np.ndarray) -> np.ndarray:
    """``[.., re_0..re_160, im_0..im_160]`` -> ``[.., re_0, im_0, re_1, ..]``."""
    return np.stack([m[..., :FREQ], m[..., FREQ:]], axis=-1).reshape(*m.shape[:-1], -1)


def fft_table_np() -> np.ndarray:
    """K1's ``[962]`` float32 table: the Hann window (as the plain version
    applies it), then ``e^{-2 pi i m / 160}`` for ``m < 160`` and
    ``e^{-2 pi i k / 320}`` for ``k <= 160``, (re, im) interleaved, built in
    float64 and cast to float32."""
    def unit(n, count):
        ang = -2.0 * np.pi * np.arange(count) / n
        return np.stack([np.cos(ang), np.sin(ang)], axis=-1).reshape(-1)

    return np.concatenate([hann_window(WIN).astype(np.float64), unit(HOP, HOP),
                           unit(WIN, FREQ)]).astype(np.float32)


def istft_operands_np():
    """K2's operands: the ``[644, 160]`` inverse (window folded in, in
    float32 as ``istft_pallas`` folds it; rows interleaved like the
    spectrum; first-half columns stacked over second-half columns) and the
    ``[2, 160]`` envelope of rows 1..T-1 and of row T."""
    _, inv = dft_matrices_np(WIN)
    inv_win = inv.astype(np.float32) * hann_window(WIN)[None, :]  # [322, 320]
    inv_win = _interleave_cols(inv_win.T).T  # rows 2f + c
    stacked = np.concatenate([inv_win[:, :HOP], inv_win[:, HOP:]], axis=0)
    env = _envelope_np(3, WIN, HOP)  # rows 0..3 of a 3-frame signal
    return (np.ascontiguousarray(stacked),
            np.stack([env[HOP:2 * HOP], env[3 * HOP:]]).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _device_operands(device: torch.device):
    inv, env = istft_operands_np()
    put = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return put(fft_table_np()), put(inv), put(env)


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
    tab, _, _ = _device_operands(x.device)
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
    b, t = spec.shape[:2]
    if length < 0 or t < 1:
        raise ValueError(f"need length >= 0 and T >= 1 (got {length}, {t})")
    out = torch.empty((b, length), dtype=torch.float32, device=spec.device)
    _, inv, env = _device_operands(spec.device)
    if b and length:
        with on_device(spec.device):
            err = build.library().pdt_istft_f32(
                spec.data_ptr(), inv.data_ptr(), env.data_ptr(), out.data_ptr(), b, t,
                length, stream(spec.device))
        build.check(err, "istft kernel")
        istft.launches += 1
    return out


stft.launches = 0
istft.launches = 0
