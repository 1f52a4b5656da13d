"""Plain signal path of the reference: STFT and ISTFT as framed products,
magnitude compression, RMS scaling, and the reverse-sampling schedule.

320-sample periodic Hann window, hop 160, centred with reflect padding,
spectra real-packed ``[..., T, 161, 2]`` (``torch.stft(center=True)``
conventions).  Imports nothing of the program.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

WIN, HOP = 320, 160
FREQ = WIN // 2 + 1


def hann(device) -> torch.Tensor:
    n = np.arange(WIN)
    return torch.as_tensor((0.5 * (1.0 - np.cos(2.0 * np.pi * n / WIN))).astype(np.float32),
                           device=device)


@functools.lru_cache(maxsize=None)
def _dft_np():
    """One-sided DFT ``[320, 322]`` (re then im columns) and its exact
    inverse ``[322, 320]``, float64."""
    n = np.arange(WIN)[:, None]
    k = np.arange(FREQ)[None, :]
    ang = 2.0 * np.pi * n * k / WIN
    fwd = np.concatenate([np.cos(ang), -np.sin(ang)], axis=1)
    w = np.full((FREQ,), 2.0)
    w[0] = w[-1] = 1.0
    inv = np.concatenate([w[:, None] * np.cos(ang.T), -w[:, None] * np.sin(ang.T)], 0) / WIN
    return fwd, inv


def stft(x: torch.Tensor) -> torch.Tensor:
    """``[B, L]`` -> ``[B, L // 160 + 1, 161, 2]``."""
    b, length = x.shape
    frames_n = length // HOP + 1
    xp = F.pad(x[:, None], (WIN // 2, WIN // 2), mode="reflect")[:, 0]
    idx = torch.arange(frames_n, device=x.device)[:, None] * HOP + torch.arange(
        WIN, device=x.device)[None]
    frames = xp[:, idx] * hann(x.device)
    spec = frames @ torch.as_tensor(_dft_np()[0], dtype=x.dtype, device=x.device)
    return torch.stack([spec[..., :FREQ], spec[..., FREQ:]], dim=-1)


def istft(spec: torch.Tensor, length: int) -> torch.Tensor:
    """Overlap-add inverse of :func:`stft`, divided by the squared-window
    envelope (1 where it vanishes), the centre pad dropped, cut or
    zero-padded to ``length``."""
    b, t = spec.shape[:2]
    packed = torch.cat([spec[..., 0], spec[..., 1]], dim=-1)
    inv = torch.as_tensor(_dft_np()[1], dtype=spec.dtype, device=spec.device)
    win = hann(spec.device)
    frames = (packed @ inv) * win  # [B, T, 320]
    total = (t - 1) * HOP + WIN
    y = F.fold(frames.transpose(1, 2), (1, total), (1, WIN), stride=(1, HOP))[:, 0, 0]
    env = F.fold((win * win).expand(1, t, WIN).transpose(1, 2), (1, total), (1, WIN),
                 stride=(1, HOP))[0, 0, 0]
    y = y / torch.where(env > 1e-11, env, torch.ones_like(env))
    y = y[:, WIN // 2:]
    return y[:, :length] if length <= y.shape[1] else F.pad(y, (0, length - y.shape[1]))


def mag_phase(spec):
    re, im = spec[..., 0], spec[..., 1]
    return torch.sqrt(re * re + im * im), torch.atan2(im, re)


def polar(mag, phase):
    return torch.stack([mag * torch.cos(phase), mag * torch.sin(phase)], dim=-1)


def compress(spec):
    """The ``sqrt`` feature: magnitude to the power 1/2, phase kept."""
    mag, phase = mag_phase(spec)
    return polar(torch.sqrt(mag), phase)


def decompress(spec):
    mag, phase = mag_phase(spec)
    return polar(mag ** 2, phase)


def rms_factor(wav: np.ndarray) -> float:
    """``c`` with ``wav / c`` of unit RMS (float64 sums), at least 1e-12."""
    energy = float(np.sum(np.asarray(wav, np.float64) ** 2))
    return max(float(np.sqrt(energy / len(wav))), 1e-12)


def sigma_mask(x_init):
    """PriorGrad's per-bin scale ``|x| / max_{T,F} |x| / 2 + 0.5``."""
    a = torch.abs(x_init)
    return a / torch.clamp(torch.amax(a, dim=(1, 2), keepdim=True), min=1e-12) / 2.0 + 0.5


@dataclass(frozen=True)
class Schedule:
    """Reverse-chain constants of the fast schedule, indexed by position
    ``n``; the chain runs n = N-1 .. 0."""

    t: np.ndarray    # the training-grid time of each position (float32)
    c1: np.ndarray   # 1 / sqrt(alpha)
    c2: np.ndarray   # beta / sqrt(1 - alpha_cum)
    sigma: np.ndarray  # the step-noise scale (0 on these schedules)


def schedule(train_betas, fast_betas) -> Schedule:
    """DiffWave's fast-sampling alignment of ``fast_betas`` onto the
    training grid of ``train_betas``."""
    tcum = np.cumprod(1.0 - np.asarray(train_betas, np.float64))
    beta = np.asarray(fast_betas, np.float64)
    alpha = 1.0 - beta
    acum = np.cumprod(alpha)
    times = []
    for s in range(len(beta)):
        for t in range(len(tcum) - 1):
            if tcum[t + 1] <= acum[s] <= tcum[t]:
                times.append(t + (tcum[t] ** 0.5 - acum[s] ** 0.5)
                             / (tcum[t] ** 0.5 - tcum[t + 1] ** 0.5))
                break
    sig = np.zeros_like(alpha)
    for n in range(len(alpha)):
        sig[n] = ((1.0 - acum[n - 1]) / (1.0 - acum[n]) * beta[n]) ** 0.5
    gamma = sig.copy()
    gamma[0] = 0.2
    c1 = 1.0 / np.sqrt(alpha)
    return Schedule(np.asarray(times, np.float32), c1, beta / np.sqrt(1.0 - acum),
                    np.maximum(0.0, gamma - c1 * gamma))


def f32(values) -> list:
    """Host constants rounded to float32, as python floats."""
    return np.asarray(values, np.float64).astype(np.float32).tolist()
