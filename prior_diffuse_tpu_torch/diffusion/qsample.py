"""The PriorGrad sigma mask (``prior_diffuse_tpu/diffusion/qsample.py``)."""

from __future__ import annotations

import torch


def sigma_mask(x_init: torch.Tensor) -> torch.Tensor:
    """Per-bin noise scale in ``[0.5, 1]``: ``|x| / max_{T,F}|x| / 2 + 0.5``
    with the max per (batch, channel) of ``[B, T, F, 2]``, floored at
    1e-12 so an all-zero (padded) row gives 0.5, not 0/0."""
    a = torch.abs(x_init)
    m = torch.clamp(torch.amax(a, dim=(1, 2), keepdim=True), min=1e-12)
    return a / m / 2.0 + 0.5
