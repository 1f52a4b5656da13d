"""DiffWave: the waveform-domain diffusion denoiser of the reference.

The counterpart of ``prior_diffuse_tpu/models/diffwave.py``, with its
module names (``res3/dilated_conv/kernel`` is ``res3.dilated_conv.weight``;
``convert.py``): a 1x1 input projection, *shared* by the noisy audio and
the conditioner ``audio_init``, the sinusoidal timestep embedding, and
``residual_layers`` gated residual blocks dilated ``2 ** (i %
dilation_cycle_length)``, each conditioned on ``audio_init`` by its own
dilated conv; their skip outputs summed, divided by ``sqrt(residual_layers)``
and projected to one channel.  No trainer of the JAX package uses it: this
is the model and its weight bridge.  ``[B, L] -> [B, L]``; inside, ``[B, C,
L]``.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from prior_diffuse_tpu_torch.models import layers as tl


class ResidualBlock(nn.Module):
    """``y = dilated_conv(x + diffusion_projection(t)) +
    conditioner_projection(cond)``, ``sigmoid(gate) * tanh(filter)`` of its
    halves, a 1x1 conv to the residual and skip halves; returns ``((x +
    residual) / sqrt(2), skip)``."""

    def __init__(self, residual_channels: int = 64, dilation: int = 1):
        super().__init__()
        c = residual_channels
        self.diffusion_projection = nn.Linear(512, c)
        self.conditioner_projection = nn.Conv1d(c, 2 * c, 3, dilation=dilation,
                                                padding=dilation)
        self.dilated_conv = nn.Conv1d(c, 2 * c, 3, dilation=dilation, padding=dilation)
        self.output_projection = nn.Conv1d(c, 2 * c, 1)

    def forward(self, x, conditioner, t):
        y = x + self.diffusion_projection(t)[:, :, None]
        y = self.dilated_conv(y) + self.conditioner_projection(conditioner)
        gate, filt = y.chunk(2, dim=1)
        y = self.output_projection(torch.sigmoid(gate) * torch.tanh(filt))
        residual, skip = y.chunk(2, dim=1)
        return (x + residual) / math.sqrt(2.0), skip


class DiffWave(nn.Module):
    """``forward(audio, audio_init, t)``: waveforms ``[B, L]`` and steps
    ``t [B]`` (integer, or float with fractional steps) -> ``[B, L]``."""

    def __init__(self, residual_channels: int = 64, residual_layers: int = 30,
                 dilation_cycle_length: int = 10, num_steps: int = 50):
        super().__init__()
        c = residual_channels
        self.residual_layers = residual_layers
        self.input_projection = nn.Conv1d(1, c, 1)
        self.diffusion_embedding = tl.TimeEmbedding(num_steps)
        for i in range(residual_layers):
            setattr(self, f"res{i}", ResidualBlock(c, 2 ** (i % dilation_cycle_length)))
        self.skip_projection = nn.Conv1d(c, c, 1)
        self.output_projection = nn.Conv1d(c, 1, 1)

    def forward(self, audio, audio_init, t):
        x = F.relu(self.input_projection(audio[:, None]))
        cond = F.relu(self.input_projection(audio_init[:, None]))
        temb = self.diffusion_embedding(t)
        skips = []
        for i in range(self.residual_layers):
            x, skip = getattr(self, f"res{i}")(x, cond, temb)
            skips.append(skip)
        x = sum(skips) / math.sqrt(len(skips))
        x = F.relu(self.skip_projection(x))
        return self.output_projection(x)[:, 0]
