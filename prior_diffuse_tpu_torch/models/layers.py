"""Building blocks of the DiffUNet family that ``torch.nn`` lacks.

The counterparts of ``prior_diffuse_tpu/models/layers.py``.  Its PReLU,
conv1d/conv2d and ConvTranspose2d are ``nn.PReLU``, ``nn.Conv1d/2d`` and
``nn.ConvTranspose2d`` here (``convert.py`` maps the parameters); its
BatchNorm is :class:`BatchNorm1d` / :class:`BatchNorm2d`, which keep
flax's train-mode statistics.  Inside the models tensors are NCHW
``[B, C, T, F]``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def time_embedding_table(max_steps: int) -> np.ndarray:
    """``[max_steps, 128]`` sin/cos table of ``t * 10^(d * 4 / 63)``.

    At phases of ~5e5 rad one f32 ulp moves sin() by up to ~0.06, so the
    table is built exactly as the JAX package builds it: exponent in f32,
    pow in f64 rounded to f32, phase product in f32, sin/cos in f64 of the
    f32 phase, rounded to f32."""
    steps = np.arange(max_steps, dtype=np.float32)[:, None]
    dims = np.arange(64, dtype=np.float32)[None, :]
    exp = dims * np.float32(4.0) / np.float32(63.0)
    pow_ = np.power(10.0, exp.astype(np.float64)).astype(np.float32)
    phase = (steps * pow_).astype(np.float64)
    return np.concatenate([np.sin(phase), np.cos(phase)], axis=1).astype(np.float32)


class TimeEmbedding(nn.Module):
    """DiffWave timestep embedding: table lookup with linear interpolation
    for fractional ``t``, then two Linear -> SiLU layers to 512."""

    def __init__(self, max_steps: int):
        super().__init__()
        self.register_buffer(
            "table", torch.from_numpy(time_embedding_table(max_steps)),
            persistent=False)
        self.proj1 = nn.Linear(128, 512)
        self.proj2 = nn.Linear(512, 512)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        """``t [B]`` float (fractional allowed) or integer -> ``[B, 512]``
        float32.  A bfloat16 ``t`` (the bf16 chain's) is taken as it is, as
        flax takes it: ``floor``/``ceil`` of the bf16 value, ``frac = t -
        low`` in bf16 (exact), the table and both projections in f32."""
        if t.is_floating_point():
            low = torch.floor(t).long()
            high = torch.ceil(t).long()
            frac = (t - low.to(t.dtype)).float()[:, None]
            x = self.table[low] + (self.table[high] - self.table[low]) * frac
        else:
            x = self.table[t]
        return F.silu(self.proj2(F.silu(self.proj1(x))))


class _FlaxBatchStats:
    """Train mode as ``flax.linen.BatchNorm`` computes it (``momentum=0.9``,
    eps 1e-5; ``models/layers.py::BatchNorm`` of the JAX package): the
    batch variance is the *biased* one, ``E[x^2] - E[x]^2`` clipped at 0,
    and it is that variance that enters ``running_var`` (torch's own
    BatchNorm stores the unbiased one).  The running statistics move by
    ``0.1`` of the batch statistics; ``num_batches_tracked`` counts the
    updates, which also marks the module as changed for whoever caches
    operands folded from it (``Enhancer.packs``).  Eval mode is
    torch's (running statistics); with the statistics cast to another
    dtype (a cast copy of the net, as the JAX package casts its variables)
    it is flax's inference arithmetic, op by op in that dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            if self.running_var.dtype == torch.float32:
                return super().forward(x)
            shape = (1, -1) + (1,) * (x.ndim - 2)
            mul = torch.rsqrt(self.running_var + self.eps) * self.weight
            return (x - self.running_mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        self._check_input_dim(x)
        dims = [0, *range(2, x.ndim)]
        mean = x.mean(dims)
        var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(m * mean)
            self.running_var.mul_(1.0 - m).add_(m * var)
            self.num_batches_tracked.add_(1)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        scale = self.weight * torch.rsqrt(var + self.eps)
        return (x - mean.view(shape)) * scale.view(shape) + self.bias.view(shape)


class BatchNorm1d(_FlaxBatchStats, nn.BatchNorm1d):
    """``nn.BatchNorm1d`` with flax's train-mode statistics."""


class BatchNorm2d(_FlaxBatchStats, nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's train-mode statistics."""


def pad_time_causal(x: torch.Tensor, amount: int = 1) -> torch.Tensor:
    """Zero-pad ``amount`` frames at the start of the time axis of NCHW."""
    return F.pad(x, (0, 0, amount, 0))


def chomp_time_end(x: torch.Tensor, amount: int = 1) -> torch.Tensor:
    """Drop ``amount`` frames from the end of the time axis of NCHW."""
    return x[:, :, :-amount] if amount else x
