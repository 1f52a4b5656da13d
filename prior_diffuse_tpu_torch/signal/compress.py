"""Magnitude compression / decompression of real-packed spectra ``[..., 2]``.

The counterpart of ``prior_diffuse_tpu/signal/compress.py``:

  normal: mag          (phase re-projection only)
  sqrt:   mag ** 0.5   <->  mag ** 2
  cubic:  mag ** 0.3   <->  mag ** (10/3)
  log_1x: log(1+mag)   <->  exp(mag) - 1
  other:  identity
"""

from __future__ import annotations

from typing import Tuple

import torch

FEAT_TYPES = ("normal", "sqrt", "cubic", "log_1x")


def mag_phase(spec: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    re, im = spec[..., 0], spec[..., 1]
    return torch.sqrt(re * re + im * im), torch.atan2(im, re)


def from_mag_phase(mag: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
    return torch.stack([mag * torch.cos(phase), mag * torch.sin(phase)], dim=-1)


def _compress_mag(mag, feat_type):
    if feat_type == "normal":
        return mag
    if feat_type == "sqrt":
        return torch.sqrt(mag)
    if feat_type == "cubic":
        return mag ** 0.3
    return torch.log1p(mag)  # log_1x


def _decompress_mag(mag, feat_type):
    if feat_type == "normal":
        return mag
    if feat_type == "sqrt":
        return mag ** 2
    if feat_type == "cubic":
        return mag ** (10.0 / 3.0)
    return torch.exp(mag) - 1.0  # log_1x


def compress_spec(spec: torch.Tensor, feat_type: str = "sqrt") -> torch.Tensor:
    """Compress the magnitude, keep the phase (identity for unknown types)."""
    if feat_type not in FEAT_TYPES:
        return spec
    mag, phase = mag_phase(spec)
    return from_mag_phase(_compress_mag(mag, feat_type), phase)


def decompress_spec(spec: torch.Tensor, feat_type: str = "sqrt") -> torch.Tensor:
    """Inverse of :func:`compress_spec`."""
    if feat_type not in FEAT_TYPES:
        return spec
    mag, phase = mag_phase(spec)
    return from_mag_phase(_decompress_mag(mag, feat_type), phase)
