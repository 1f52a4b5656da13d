"""Adam with the reference's L2 decay, and learning-rate access.

``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=l2)``:
the decay is added to the *gradient* before the moments (not AdamW).
That is exactly what ``prior_diffuse_tpu/training/optim.py::torch_adam``
emulates in optax (``add_decayed_weights``, ``scale_by_adam``, the
learning rate).  The learning rate lives in the param groups, where the
plateau controller halves it.
"""

from __future__ import annotations

from typing import Iterable

import torch


def torch_adam(params: Iterable[torch.nn.Parameter], lr: float,
               l2: float = 0.0) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=l2)


def get_lr(opt: torch.optim.Optimizer) -> float:
    return float(opt.param_groups[0]["lr"])


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    """Replace the learning rate of every param group, in place."""
    for group in opt.param_groups:
        group["lr"] = lr
