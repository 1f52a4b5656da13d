"""Waveform RMS normalisation (``prior_diffuse_tpu/signal/normalize.py``)."""

from __future__ import annotations

import numpy as np


def rms_scale(x: np.ndarray, eps: float = 0.0) -> np.ndarray:
    """``c`` such that ``x * c`` has unit RMS: ``sqrt(len / sum(x^2))``,
    summed in float64 over the last axis."""
    denom = np.sum(np.asarray(x, np.float64) ** 2, axis=-1)
    return np.sqrt(x.shape[-1] / (denom + eps))
