"""DiffUNet family: the discriminative prior and the residual DDPM denoiser.

The counterparts of ``prior_diffuse_tpu/models/diffunet.py`` (``DiffUNet``,
``DiffUNet1``, ``Nocon``), with the same module names, so a flax parameter path
``core/en/conv1/l/kernel`` is the ``state_dict`` key
``core.en.conv1.l.weight`` (``convert.py``).  Public forwards take and
return channels-last ``[B, T, 161, 2]``; inside, tensors are NCHW.

These forwards run conv by conv and train; their sigmoid is
``layers.sigmoid`` (XLA's rounding below float32).  The serving forward,
with the encoder's stages on K3, is ``models/fused_forward.py``; the
bf16-compute forward of bf16 training is these modules through
``models/precision.py::compute_view``, whose ``COMPUTE_F32_PARTS`` (the
time embedding) stay float32 as in JAX.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from prior_diffuse_tpu_torch.models import layers as tl
from prior_diffuse_tpu_torch.ops.cuda.convblock import ENC_KERNELS

FREQ = 161
_ENC_CIN = (2, 64, 64, 64, 64)


class BiConvGLU(nn.Module):
    """Bidirectional cross-gated conv GLU."""

    def __init__(self, cin: int, features: int, kernel):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, 32, 1)
        self.l = nn.Conv2d(32, 32, kernel, stride=(1, 2))
        self.r = nn.Conv2d(32, 32, kernel, stride=(1, 2))
        self.l_conv = nn.Conv2d(32, 32, 1)
        self.r_conv = nn.Conv2d(32, 32, 1)
        self.conv2 = nn.Conv2d(32, features, 1)

    def forward(self, x):
        x = self.conv1(x)
        left, right = self.l(x), self.r(x)
        lmask = tl.sigmoid(self.l_conv(left))
        rmask = tl.sigmoid(self.r_conv(right))
        return self.conv2(left * rmask + right * lmask)


class BiConvTransGLU(nn.Module):
    """Transposed variant, optionally time-conditioned (``tp``)."""

    def __init__(self, cin: int, features: int, kernel, time_cond: bool):
        super().__init__()
        self.tp = nn.Linear(512, cin) if time_cond else None
        self.conv1 = nn.ConvTranspose2d(cin, 32, 1)
        self.l = nn.ConvTranspose2d(32, 32, kernel, stride=(1, 2))
        self.r = nn.ConvTranspose2d(32, 32, kernel, stride=(1, 2))
        self.l_conv = nn.ConvTranspose2d(32, 32, 1)
        self.r_conv = nn.ConvTranspose2d(32, 32, 1)
        self.conv2 = nn.ConvTranspose2d(32, features, 1)

    def forward(self, x, temb):
        if self.tp is not None:
            x = x + self.tp(temb)[:, :, None, None]
        x = self.conv1(x)
        left, right = self.l(x), self.r(x)
        lmask = tl.sigmoid(self.l_conv(left))
        rmask = tl.sigmoid(self.r_conv(right))
        return self.conv2(left * rmask + right * lmask)


class Residual(nn.Module):
    """Gated dilated conv1d residual block on ``[B, 256, T]``."""

    def __init__(self, dilation: int):
        super().__init__()
        pad = 2 * dilation
        self.conv1 = nn.Conv1d(256, 64, 1)
        self.main_prelu = nn.PReLU()
        self.main_bn = tl.BatchNorm1d(64)
        self.main_conv = nn.Conv1d(64, 64, 5, dilation=dilation, padding=pad)
        self.mask_prelu = nn.PReLU()
        self.mask_bn = tl.BatchNorm1d(64)
        self.mask_conv = nn.Conv1d(64, 64, 5, dilation=dilation, padding=pad)
        self.out_prelu = nn.PReLU()
        self.out_bn = tl.BatchNorm1d(64)
        self.out_conv = nn.Conv1d(64, 256, 1)

    def forward(self, x):
        skip = x
        x = self.conv1(x)
        main = self.main_conv(self.main_bn(self.main_prelu(x)))
        mask = tl.sigmoid(self.mask_conv(self.mask_bn(self.mask_prelu(x))))
        x = self.out_conv(self.out_bn(self.out_prelu(main * mask)))
        return x + skip


class TCM(nn.Module):
    """Six dilated residual blocks, dilations 1..32."""

    def __init__(self):
        super().__init__()
        for i, d in enumerate([1, 2, 4, 8, 16, 32]):
            setattr(self, f"residual{i + 1}", Residual(d))

    def forward(self, x):
        for i in range(6):
            x = getattr(self, f"residual{i + 1}")(x)
        return x


class Encoder(nn.Module):
    """5-stage causal encoder; freq 161 -> 79 -> 39 -> 19 -> 9 -> 4.  With
    ``time_cond`` each stage adds ``tp{i}(temb)`` to its padded input."""

    def __init__(self, time_cond: bool):
        super().__init__()
        for i, (cin, kf) in enumerate(zip(_ENC_CIN, ENC_KERNELS), start=1):
            if time_cond:
                setattr(self, f"tp{i}", nn.Linear(512, cin))
            setattr(self, f"conv{i}", BiConvGLU(cin, 64, (2, kf)))
            setattr(self, f"bn{i}", tl.BatchNorm2d(64))
            setattr(self, f"prelu{i}", nn.PReLU())

    def forward(self, x, temb=None):
        """``x [B, C, T, F]`` -> ``(x, skips)``, NCHW."""
        skips = []
        for i in range(1, 6):
            x = tl.pad_time_causal(x, 1)
            tp = getattr(self, f"tp{i}", None)
            if tp is not None:
                x = x + tp(temb)[:, :, None, None]
            x = getattr(self, f"conv{i}")(x)
            x = getattr(self, f"prelu{i}")(getattr(self, f"bn{i}")(x))
            skips.append(x)
        return x, skips


class Decoder(nn.Module):
    """Real-or-imag decoder branch with skip concats and time chomp."""

    def __init__(self, time_cond: bool):
        super().__init__()
        for i in range(5, 0, -1):
            last = i == 1
            setattr(self, f"de{i}", BiConvTransGLU(
                128, 1 if last else 64, (2, 5) if last else (2, 3), time_cond))
            if not last:
                setattr(self, f"bn{i}", tl.BatchNorm2d(64))
                setattr(self, f"prelu{i}", nn.PReLU())

    def forward(self, x, skips, temb):
        for i, skip in zip(range(5, 0, -1), reversed(skips)):
            x = torch.cat([x, skip], dim=1)
            x = tl.chomp_time_end(getattr(self, f"de{i}")(x, temb), 1)
            if i > 1:
                x = getattr(self, f"prelu{i}")(getattr(self, f"bn{i}")(x))
        return x


class UNetCore(nn.Module):
    """Encoder, three TCMs over the c-major flattened bottleneck, and the
    real/imag decoders."""

    def __init__(self, time_cond: bool):
        super().__init__()
        self.en = Encoder(time_cond)
        self.tcm1, self.tcm2, self.tcm3 = TCM(), TCM(), TCM()
        self.de_real = Decoder(time_cond)
        self.de_imag = Decoder(time_cond)

    def forward(self, x, temb=None):
        """``x [B, C, T, 161]`` -> ``[B, 2, T, 161]``."""
        if x.shape[-1] != FREQ:
            # the transposed convs rebuild 161 bins with no output padding
            # (4 -> 9 -> 19 -> 39 -> 79 -> 161); other widths do not invert
            raise ValueError(f"DiffUNet needs {FREQ} frequency bins, got {x.shape[-1]}")
        x, skips = self.en(x, temb)
        x = self.bottleneck(x, (self.tcm1, self.tcm2, self.tcm3))
        return self.decode(x, skips, temb, (self.de_real, self.de_imag))

    @staticmethod
    def bottleneck(x, tcms):
        """The TCMs over the encoder's output ``x [B, 64, T, 4]`` (NCHW),
        flattened c-major as the reference does: ``[B, C*F, T]``."""
        b, c, t, f = x.shape
        flat = x.permute(0, 1, 3, 2).reshape(b, c * f, t)
        for tcm in tcms:
            flat = tcm(flat)
        return flat.reshape(b, c, f, t).permute(0, 1, 3, 2)

    @staticmethod
    def decode(x, skips, temb, decoders):
        """The real and imaginary ``Decoder`` branches side by side:
        ``[B, 2, T, 161]``."""
        return torch.cat([d(x, skips, temb) for d in decoders], dim=1)


class DiffUNet(nn.Module):
    """Discriminative prior; ``[B, T, 161, 2] -> [B, T, 161, 2]``."""

    def __init__(self):
        super().__init__()
        self.core = UNetCore(time_cond=False)

    def forward(self, x):
        return self.core(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class DiffUNet1(nn.Module):
    """Residual DDPM denoiser eps_theta(x_t, x_init, t).

    ``x_t [B, T, 161, 2]``, ``x_init [B, T, 161, cond_channels]``
    (2, or 4 for the ``cond_noisy`` conditioner), ``t [B]``."""

    # the time embedding has no dtype field in JAX: float32 in bf16 compute
    COMPUTE_F32_PARTS = ("time_embedding",)

    def __init__(self, num_steps: int = 50, cond_channels: int = 2):
        super().__init__()
        self.preprocess = nn.Conv2d(2 + cond_channels, 2, 1)
        self.time_embedding = tl.TimeEmbedding(num_steps)
        self.core = UNetCore(time_cond=True)

    def forward(self, x, x_init, t):
        x = self.preprocess(torch.cat([x, x_init], dim=-1).permute(0, 3, 1, 2))
        temb = self.time_embedding(t)
        return self.core(x, temb).permute(0, 2, 3, 1)


class Nocon(nn.Module):
    """Unconditional denoiser eps_theta(x_t, t) of the deltamu mode
    (JAX ``models/diffunet.py:264-277``): ``DiffUNet1`` without the
    preprocess, ``x_t [B, T, 161, 2]``, ``t [B]``."""

    COMPUTE_F32_PARTS = ("time_embedding",)

    def __init__(self, num_steps: int = 50):
        super().__init__()
        self.time_embedding = tl.TimeEmbedding(num_steps)
        self.core = UNetCore(time_cond=True)

    def forward(self, x, t):
        temb = self.time_embedding(t)
        return self.core(x.permute(0, 3, 1, 2), temb).permute(0, 2, 3, 1)
