"""The six-metric cells of the drivers' reports.

CSIG, CBAK and COVL are regressions on PESQ and clip at the Loizou floor
of 1.0 (``metrics/composite.py``); a cell within ``FLOOR_EPS`` of it
carries no comparative information and is flagged ``(floor)``, as the
JAX package's ``scripts/train_demo.py`` and ``eval_schedules.py`` flag it.
"""

from __future__ import annotations

import numpy as np

FLOOR_EPS = 5e-4  # composite regression floor detector
NAMES = ("CSIG", "CBAK", "COVL", "PESQ", "SSNR", "STOI")
CLIPPABLE = {"CSIG", "CBAK", "COVL"}


def at_floor(name: str, value: float) -> bool:
    """True where ``name`` (any case) clips and ``value`` sits at its floor."""
    return name.upper() in CLIPPABLE and value <= 1.0 + FLOOR_EPS


def cell(name: str, value: float) -> str:
    """``value`` to 3 decimals, flagged ``(floor)`` at the regression floor."""
    return f"{value:.3f}{' (floor)' if at_floor(name, value) else ''}"


def mean_scores(clean_dir: str, deg_dir: str) -> np.ndarray:
    """The six metrics of ``deg_dir``'s wavs against ``clean_dir``'s (paired
    by sorted name), averaged over the files: ``[6]`` in :data:`NAMES` order."""
    from prior_diffuse_tpu_torch.metrics.compare import compare

    return np.mean(np.asarray(compare(clean_dir, deg_dir)), axis=0)


def rounded(values) -> dict:
    """``{name: value rounded to 3 decimals}`` in :data:`NAMES` order."""
    return dict(zip(NAMES, [round(float(v), 3) for v in values]))
