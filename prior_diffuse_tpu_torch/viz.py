"""Plotting helpers.

The counterpart of ``prior_diffuse_tpu/viz.py`` (working replacements for
the reference's ``scripts/draw_spectrum.py`` and ``draw.py`` figure code —
the original ``plot_stft`` crashes on an undefined name, SURVEY 2.9).  The
spectrograms come from this package's STFT (``ops/cuda/stft.py``: K1 on a
CUDA device, the plain version on the CPU).

All matplotlib imports are lazy so headless/serving environments never
pay for them; a figure without matplotlib raises its ``ImportError``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_wav(wav: np.ndarray, sr: int = 16000, title: str = "waveform",
             path: Optional[str] = None):
    plt = _plt()
    fig, ax = plt.subplots(figsize=(10, 3))
    t = np.arange(len(wav)) / sr
    ax.plot(t, wav, linewidth=0.5)
    ax.set_xlabel("time (s)")
    ax.set_title(title)
    if path:
        fig.savefig(path, dpi=150, bbox_inches="tight")
        plt.close(fig)
    return fig


def spec_db(wav: np.ndarray, n_fft: int = 320, hop: int = 160, device="cuda") -> np.ndarray:
    """log-magnitude spectrogram [F, T] in dB via the package STFT on
    ``device`` (K1 on a CUDA device, the card by default).  The STFT
    implements the 320/160 framing only, so other values raise (the JAX
    function ignores both arguments and frames 320/160)."""
    from prior_diffuse_tpu_torch.ops.cuda import stft as kstft

    if (n_fft, hop) != (320, 160):
        raise ValueError(f"the STFT implements the 320/160 framing only, got {n_fft}/{hop}")
    x = torch.as_tensor(np.asarray(wav, np.float32)[None], device=device)
    spec = kstft.stft(x)[0].cpu().numpy()
    mag = np.hypot(spec[..., 0], spec[..., 1]).T  # [F, T]
    return 20.0 * np.log10(mag + 1e-8)


def plot_specgram(wav: np.ndarray, sr: int = 16000, title: str = "spectrogram",
                  path: Optional[str] = None, device="cuda"):
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 4))
    d = spec_db(wav, device=device)
    im = ax.imshow(d, origin="lower", aspect="auto", cmap="magma",
                   extent=[0, len(wav) / sr, 0, sr / 2 / 1000])
    ax.set_xlabel("time (s)")
    ax.set_ylabel("kHz")
    ax.set_title(title)
    fig.colorbar(im, ax=ax, shrink=0.8)
    if path:
        fig.savefig(path, dpi=150, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_stft(spec_btfc: np.ndarray, title: str = "stft",
              path: Optional[str] = None):
    """Plot a real-packed [T, F, 2] (or [B, T, F, 2] first item)
    spectrogram's magnitude in dB."""
    plt = _plt()
    s = np.asarray(spec_btfc)
    if s.ndim == 4:
        s = s[0]
    mag = np.hypot(s[..., 0], s[..., 1]).T
    fig, ax = plt.subplots(figsize=(8, 4))
    im = ax.imshow(20 * np.log10(mag + 1e-8), origin="lower", aspect="auto",
                   cmap="magma")
    ax.set_xlabel("frames")
    ax.set_ylabel("bins")
    ax.set_title(title)
    fig.colorbar(im, ax=ax, shrink=0.8)
    if path:
        fig.savefig(path, dpi=150, bbox_inches="tight")
        plt.close(fig)
    return fig


def draw_comparison(wavs: Sequence[np.ndarray], titles: Sequence[str],
                    sr: int = 16000, path: Optional[str] = None, device="cuda"):
    """N-panel spectrogram comparison (the reference's paper figure
    layout, ``draw.py:64-117`` — noisy/clean/CDiffuSE/PriorDiffuse)."""
    plt = _plt()
    n = len(wavs)
    fig, axes = plt.subplots(1, n, figsize=(4 * n, 4), constrained_layout=True)
    if n == 1:
        axes = [axes]
    for ax, w, title in zip(axes, wavs, titles):
        im = ax.imshow(spec_db(w, device=device), origin="lower", aspect="auto",
                       cmap="magma", extent=[0, len(w) / sr, 0, sr / 2 / 1000])
        ax.set_title(title)
        ax.set_xlabel("time (s)")
    axes[0].set_ylabel("kHz")
    fig.colorbar(im, ax=axes[-1], shrink=0.8)
    if path:
        fig.savefig(path, dpi=200, bbox_inches="tight")
        plt.close(fig)
    return fig
