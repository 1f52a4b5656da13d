"""STFT / ISTFT as framed matrix products (plain PyTorch).

The counterpart of ``prior_diffuse_tpu/signal/stft.py`` (``stft_xla``,
``istft_xla``): centred STFT with reflect padding, periodic Hann window,
``fft = win = 2 * hop`` (320/160), spectra real-packed channels-last
``[..., T, F, 2]``.  These are the plain versions of the K1/K2 kernels
(``ops/cuda/stft.py``); the serving path calls the kernels' wrappers.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_size: int = 320, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window, identical to ``torch.hann_window``."""
    n = np.arange(win_size)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_size))).astype(dtype)


def frame_count(wav_len: int, win_size: int = 320, fft_num: int = 320,
                win_shift: int = 160) -> int:
    """Frames of a centred STFT: ``len // hop + 1`` for ``win == fft``."""
    return (wav_len - win_size + fft_num) // win_shift + 1


@functools.lru_cache(maxsize=8)
def dft_matrices_np(fft_num: int = 320):
    """``(fwd [fft, 2F], inv [2F, fft])`` in float64: ``frames @ fwd``
    packs ``[re_0..re_{F-1}, im_0..im_{F-1}]`` of the one-sided DFT and
    ``packed @ inv`` is its exact inverse (Hermitian weights 1, 2, .., 2, 1)."""
    freq = fft_num // 2 + 1
    n = np.arange(fft_num)[:, None]
    k = np.arange(freq)[None, :]
    ang = 2.0 * np.pi * n * k / fft_num
    fwd = np.concatenate([np.cos(ang), -np.sin(ang)], axis=1)
    w = np.full((freq,), 2.0)
    w[0] = 1.0
    w[-1] = 1.0
    inv_re = (w[:, None] * np.cos(ang.T)) / fft_num
    inv_im = (-w[:, None] * np.sin(ang.T)) / fft_num
    inv = np.concatenate([inv_re, inv_im], axis=0)
    return fwd, inv


def _check_geometry(fft_num: int, win_size: int, win_shift: int):
    if not fft_num == win_size == 2 * win_shift:
        raise ValueError("framed STFT needs fft_num == win_size == 2 * win_shift")


def stft_plain(x: torch.Tensor, fft_num: int = 320, win_size: int = 320,
               win_shift: int = 160) -> torch.Tensor:
    """Centred STFT of ``x [..., L]`` -> ``[..., T, F, 2]``, ``T = L//hop + 1``."""
    _check_geometry(fft_num, win_size, win_shift)
    length = x.shape[-1]
    if length <= win_size // 2:
        raise ValueError(f"signal length {length} must exceed half-window "
                         f"{win_size // 2} for centred (reflect-padded) STFT")
    hop = win_shift
    num_frames = length // hop + 1
    lead = x.shape[:-1]
    pad = win_size // 2
    xp = F.pad(x.reshape(-1, 1, length), (pad, pad), mode="reflect")
    halves = xp[..., : (num_frames + 1) * hop].reshape(*lead, num_frames + 1, hop)
    frames = torch.cat([halves[..., :-1, :], halves[..., 1:, :]], dim=-1)
    window = torch.as_tensor(hann_window(win_size), device=x.device)
    fwd = torch.as_tensor(dft_matrices_np(fft_num)[0], dtype=x.dtype,
                          device=x.device)
    spec = torch.matmul(frames * window, fwd)  # [..., T, 2F]
    freq = fft_num // 2 + 1
    return torch.stack([spec[..., :freq], spec[..., freq:]], dim=-1)


def istft_plain(spec: torch.Tensor, length: Optional[int] = None,
                fft_num: int = 320, win_size: int = 320,
                win_shift: int = 160) -> torch.Tensor:
    """Inverse of :func:`stft_plain` (``torch.istft(center=True)``
    semantics): overlap-add, divide by the window-square envelope (left
    as 1 where it is <= 1e-11), drop the centre pad, then trim or
    zero-pad to ``length`` (default ``(T - 1) * hop``)."""
    _check_geometry(fft_num, win_size, win_shift)
    *lead, num_frames, _, _ = spec.shape
    hop = win_shift
    packed = torch.cat([spec[..., 0], spec[..., 1]], dim=-1)  # [.., T, 2F]
    inv = torch.as_tensor(dft_matrices_np(fft_num)[1], dtype=spec.dtype,
                          device=spec.device)
    window = torch.as_tensor(hann_window(win_size), device=spec.device)
    frames = torch.matmul(packed, inv) * window  # [.., T, win]
    zeros = frames.new_zeros((*lead, 1, hop))
    acc = (torch.cat([frames[..., :hop], zeros], dim=-2)
           + torch.cat([zeros, frames[..., hop:]], dim=-2))  # [.., T+1, hop]
    y = acc.reshape(*lead, (num_frames + 1) * hop)
    y = y / torch.as_tensor(_envelope_np(num_frames, win_size, hop),
                            dtype=y.dtype, device=y.device)
    out_len = (num_frames - 1) * hop if length is None else length
    y = y[..., win_size // 2:]
    if out_len <= y.shape[-1]:
        return y[..., :out_len]
    return F.pad(y, (0, out_len - y.shape[-1]))


def _envelope_np(num_frames: int, win_size: int, hop: int) -> np.ndarray:
    """Overlap-added squared window over ``(T + 1) * hop`` samples, f64,
    with entries <= 1e-11 replaced by 1."""
    wsq = np.asarray(hann_window(win_size), np.float64) ** 2
    env = np.zeros(((num_frames + 1) * hop,))
    env[: num_frames * hop] += np.tile(wsq[:hop], num_frames)
    env[hop:] += np.tile(wsq[hop:], num_frames)
    return np.where(np.abs(env) > 1e-11, env, 1.0)
