"""Plain PyTorch reference of the benchmark's nets, float32, no kernels.

The published Prior-DiffuSE nets as the port's modules name their
parameters, so one ``state_dict`` loads into both: ``DiffUNet`` (the prior
of ``conf/diff.yml``), ``DiffUNet1`` (its residual DDPM denoiser) and
``AiaComplexTransRI`` (DB-AIAT's RI branch, ``conf/dbaiat.yml``).  Every
layer is a stock ``torch.nn`` layer or a few tensor ops: convolutions,
``nn.BatchNorm`` (torch's statistics), ``nn.LayerNorm`` over the frequency
axis, ``nn.GroupNorm(1, C)``, ``nn.GRU``, attention as two products and a
softmax.  Public forwards take and return channels-last ``[B, T, 161, 2]``.

Departures from the port, none of which enters a compared number: a
train-mode BatchNorm here moves ``running_var`` by the unbiased variance
(torch's rule; the port keeps flax's biased one), and its variance is the
two-pass one.  The benchmark compares losses, gradients and parameter
changes of train steps and the outputs of eval-mode forwards, never the
running statistics a train step leaves.

This module imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

FREQ = 161
ENC_KERNELS = (5, 3, 3, 3, 3)
ENC_CIN = (2, 64, 64, 64, 64)


# ---------------------------------------------------------------- DiffUNet family
def time_embedding_table(max_steps: int) -> np.ndarray:
    """DiffWave's ``[max_steps, 128]`` table ``sin, cos(t 10^(4 d / 63))``:
    the exponent and the product in float32, the sines in float64 of the
    float32 phase (phases reach ~5e5 rad, where one float32 ulp moves a
    sine visibly)."""
    steps = np.arange(max_steps, dtype=np.float32)[:, None]
    dims = np.arange(64, dtype=np.float32)[None, :]
    exp = dims * np.float32(4.0) / np.float32(63.0)
    pow_ = np.power(10.0, exp.astype(np.float64)).astype(np.float32)
    phase = (steps * pow_).astype(np.float64)
    return np.concatenate([np.sin(phase), np.cos(phase)], axis=1).astype(np.float32)


class TimeEmbedding(nn.Module):
    """Table lookup, linear between the two neighbouring steps for a
    fractional ``t``, then two Linear + SiLU layers to 512."""

    def __init__(self, max_steps: int):
        super().__init__()
        self.register_buffer("table", torch.from_numpy(time_embedding_table(max_steps)),
                             persistent=False)
        self.proj1 = nn.Linear(128, 512)
        self.proj2 = nn.Linear(512, 512)

    def forward(self, t):
        if t.is_floating_point():
            low, high = torch.floor(t).long(), torch.ceil(t).long()
            frac = (t - low.to(t.dtype)).float()[:, None]
            x = self.table[low] + (self.table[high] - self.table[low]) * frac
        else:
            x = self.table[t]
        return F.silu(self.proj2(F.silu(self.proj1(x))))


class BiConvGLU(nn.Module):
    def __init__(self, cin, features, kernel):
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
        return self.conv2(left * torch.sigmoid(self.r_conv(right))
                          + right * torch.sigmoid(self.l_conv(left)))


class BiConvTransGLU(nn.Module):
    def __init__(self, cin, features, kernel, time_cond):
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
        return self.conv2(left * torch.sigmoid(self.r_conv(right))
                          + right * torch.sigmoid(self.l_conv(left)))


class Residual(nn.Module):
    def __init__(self, dilation):
        super().__init__()
        pad = 2 * dilation
        self.conv1 = nn.Conv1d(256, 64, 1)
        self.main_prelu = nn.PReLU()
        self.main_bn = nn.BatchNorm1d(64)
        self.main_conv = nn.Conv1d(64, 64, 5, dilation=dilation, padding=pad)
        self.mask_prelu = nn.PReLU()
        self.mask_bn = nn.BatchNorm1d(64)
        self.mask_conv = nn.Conv1d(64, 64, 5, dilation=dilation, padding=pad)
        self.out_prelu = nn.PReLU()
        self.out_bn = nn.BatchNorm1d(64)
        self.out_conv = nn.Conv1d(64, 256, 1)

    def forward(self, x):
        h = self.conv1(x)
        main = self.main_conv(self.main_bn(self.main_prelu(h)))
        mask = torch.sigmoid(self.mask_conv(self.mask_bn(self.mask_prelu(h))))
        return self.out_conv(self.out_bn(self.out_prelu(main * mask))) + x


class TCM(nn.Module):
    def __init__(self):
        super().__init__()
        for i, d in enumerate([1, 2, 4, 8, 16, 32]):
            setattr(self, f"residual{i + 1}", Residual(d))

    def forward(self, x):
        for i in range(6):
            x = getattr(self, f"residual{i + 1}")(x)
        return x


class Encoder(nn.Module):
    def __init__(self, time_cond):
        super().__init__()
        for i, (cin, kf) in enumerate(zip(ENC_CIN, ENC_KERNELS), start=1):
            if time_cond:
                setattr(self, f"tp{i}", nn.Linear(512, cin))
            setattr(self, f"conv{i}", BiConvGLU(cin, 64, (2, kf)))
            setattr(self, f"bn{i}", nn.BatchNorm2d(64))
            setattr(self, f"prelu{i}", nn.PReLU())

    def stage(self, i, x, temb=None):
        """Stage ``i`` (1-5): causal pad of one frame, the time projection,
        the gated conv, BatchNorm, PReLU."""
        x = F.pad(x, (0, 0, 1, 0))
        tp = getattr(self, f"tp{i}", None)
        if tp is not None:
            x = x + tp(temb)[:, :, None, None]
        x = getattr(self, f"conv{i}")(x)
        return getattr(self, f"prelu{i}")(getattr(self, f"bn{i}")(x))

    def forward(self, x, temb=None):
        skips = []
        for i in range(1, 6):
            x = self.stage(i, x, temb)
            skips.append(x)
        return x, skips


class Decoder(nn.Module):
    def __init__(self, time_cond):
        super().__init__()
        for i in range(5, 0, -1):
            last = i == 1
            setattr(self, f"de{i}", BiConvTransGLU(
                128, 1 if last else 64, (2, 5) if last else (2, 3), time_cond))
            if not last:
                setattr(self, f"bn{i}", nn.BatchNorm2d(64))
                setattr(self, f"prelu{i}", nn.PReLU())

    def forward(self, x, skips, temb):
        for i, skip in zip(range(5, 0, -1), reversed(skips)):
            x = getattr(self, f"de{i}")(torch.cat([x, skip], dim=1), temb)[:, :, :-1]
            if i > 1:
                x = getattr(self, f"prelu{i}")(getattr(self, f"bn{i}")(x))
        return x


class UNetCore(nn.Module):
    def __init__(self, time_cond):
        super().__init__()
        self.en = Encoder(time_cond)
        self.tcm1, self.tcm2, self.tcm3 = TCM(), TCM(), TCM()
        self.de_real = Decoder(time_cond)
        self.de_imag = Decoder(time_cond)

    def forward(self, x, temb=None):
        """``[B, C, T, 161]`` -> ``[B, 2, T, 161]``; the TCMs run over the
        encoder's output flattened channel-major, ``[B, 64 x 4, T]``."""
        x, skips = self.en(x, temb)
        b, c, t, f = x.shape
        flat = x.permute(0, 1, 3, 2).reshape(b, c * f, t)
        flat = self.tcm3(self.tcm2(self.tcm1(flat)))
        x = flat.reshape(b, c, f, t).permute(0, 1, 3, 2)
        return torch.cat([self.de_real(x, skips, temb), self.de_imag(x, skips, temb)], dim=1)


class DiffUNet(nn.Module):
    """The prior: ``[B, T, 161, 2] -> [B, T, 161, 2]``."""

    def __init__(self):
        super().__init__()
        self.core = UNetCore(time_cond=False)

    def forward(self, x):
        return self.core(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class DiffUNet1(nn.Module):
    """The denoiser eps(x_t, x_init, t)."""

    def __init__(self, num_steps: int = 50, cond_channels: int = 2):
        super().__init__()
        self.preprocess = nn.Conv2d(2 + cond_channels, 2, 1)
        self.time_embedding = TimeEmbedding(num_steps)
        self.core = UNetCore(time_cond=True)

    def forward(self, x, x_init, t):
        x = self.preprocess(torch.cat([x, x_init], dim=-1).permute(0, 3, 1, 2))
        return self.core(x, self.time_embedding(t)).permute(0, 2, 3, 1)


# ---------------------------------------------------------------- DB-AIAT, RI branch
WIDTH = 64


class MultiHeadAttention(nn.Module):
    """Packed q, k, v projection, ``softmax(q k^T / sqrt(d / heads)) v``,
    the output projection; ``[N, L, d] -> [N, L, d]``."""

    def __init__(self, d, heads):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj_weight = nn.Parameter(torch.empty(d, d))
        self.out_proj_bias = nn.Parameter(torch.zeros(d))
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.uniform_(self.out_proj_weight, -d ** -0.5, d ** -0.5)

    def forward(self, x):
        n, length, d = x.shape
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).view(
            n, length, 3, self.heads, d // self.heads).permute(2, 0, 3, 1, 4)
        attn = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d // self.heads), dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(n, length, d)
        return F.linear(out, self.out_proj_weight, self.out_proj_bias)


class TransformerEncoderLayer(nn.Module):
    """Pre-normed attention, then a bidirectional GRU of width ``2 d`` and a
    linear layer back to ``d``."""

    def __init__(self, d, heads=4):
        super().__init__()
        self.norm3 = nn.LayerNorm(d)
        self.self_attn = MultiHeadAttention(d, heads)
        self.norm1 = nn.LayerNorm(d)
        self.gru = nn.GRU(d, 2 * d, batch_first=True, bidirectional=True)
        self.linear2 = nn.Linear(4 * d, d)
        self.norm2 = nn.LayerNorm(d)

    def forward(self, src):
        src = self.norm1(src + self.self_attn(self.norm3(src)))
        return self.norm2(src + self.linear2(F.relu(self.gru(src)[0])))


class DualPathLayer(nn.Module):
    """Attention along frequency (rows of ``[B T, F, C]``), then along time
    (columns of ``[B F, T, C]``), each with a one-group GroupNorm."""

    def __init__(self, d):
        super().__init__()
        self.row_trans = TransformerEncoderLayer(d)
        self.row_norm = nn.GroupNorm(1, d, eps=1e-8)
        self.col_trans = TransformerEncoderLayer(d)
        self.col_norm = nn.GroupNorm(1, d, eps=1e-8)

    def forward(self, x):
        b, c, t, f = x.shape
        row = self.row_trans(x.permute(0, 2, 3, 1).reshape(b * t, f, c))
        row = self.row_norm(row.view(b, t, f, c).permute(0, 3, 1, 2))
        col = self.col_trans(x.permute(0, 3, 2, 1).reshape(b * f, t, c))
        col = self.col_norm(col.view(b, f, t, c).permute(0, 3, 2, 1))
        return row, col


class InProj(nn.Module):
    def __init__(self, cin, features):
        super().__init__()
        self.conv = nn.Conv2d(cin, features, 1)
        self.prelu = nn.PReLU()

    def forward(self, x):
        return self.prelu(self.conv(x))


class OutProj(nn.Module):
    def __init__(self, cin, features):
        super().__init__()
        self.prelu = nn.PReLU()
        self.conv = nn.Conv2d(cin, features, 1)

    def forward(self, x):
        return self.conv(self.prelu(x))


class AIATransformer(nn.Module):
    def __init__(self, input_size=64, output_size=64, num_layers=4):
        super().__init__()
        d = input_size // 2
        self.k1 = nn.Parameter(torch.ones(1))
        self.k2 = nn.Parameter(torch.ones(1))
        self.input = InProj(input_size, d)
        self.output = OutProj(d, output_size)
        self.num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"layer{i}", DualPathLayer(d))

    def forward(self, x):
        h = self.input(x)
        outs = []
        for i in range(self.num_layers):
            row, col = getattr(self, f"layer{i}")(h)
            h = h + self.k1 * row + self.k2 * col
            outs.append(self.output(h))
        return outs


class AHAM(nn.Module):
    """Softmax over the layers of a 1x1 conv of each layer's mean; the
    weighted sum plus the last layer (``k3`` is never read)."""

    def __init__(self, channels=WIDTH):
        super().__init__()
        self.k3 = nn.Parameter(torch.zeros(1))
        self.conv1 = nn.Conv2d(channels, 1, 1)

    def forward(self, outs):
        scores = torch.stack([self.conv1(x.mean(dim=(2, 3), keepdim=True))[:, 0, 0, 0]
                              for x in outs], dim=-1)
        w = torch.softmax(scores, dim=-1)
        return outs[-1] + sum(w[:, g, None, None, None] * x for g, x in enumerate(outs))


class DenseBlock(nn.Module):
    def __init__(self, freq, depth=4, width=WIDTH):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            setattr(self, f"conv{i + 1}", nn.Conv2d(width * (i + 1), width, (2, 3),
                                                    dilation=(2 ** i, 1)))
            setattr(self, f"norm{i + 1}", nn.LayerNorm(freq))
            setattr(self, f"prelu{i + 1}", nn.PReLU(width))

    def forward(self, x):
        skip = out = x
        for i in range(1, self.depth + 1):
            h = getattr(self, f"conv{i}")(F.pad(skip, (1, 1, 2 ** (i - 1), 0)))
            out = getattr(self, f"prelu{i}")(getattr(self, f"norm{i}")(h))
            skip = torch.cat([out, skip], dim=1)
        return out


class DenseEncoder(nn.Module):
    def __init__(self, cin, width=WIDTH):
        super().__init__()
        self.inp_conv = nn.Conv2d(cin, width, 1)
        self.inp_norm = nn.LayerNorm(161)
        self.inp_prelu = nn.PReLU(width)
        self.enc_dense1 = DenseBlock(161, 4, width)
        self.enc_conv1 = nn.Conv2d(width, width, (1, 3), stride=(1, 2))
        self.enc_norm1 = nn.LayerNorm(80)
        self.enc_prelu1 = nn.PReLU(width)

    def forward(self, x):
        h = self.inp_prelu(self.inp_norm(self.inp_conv(x)))
        return self.enc_prelu1(self.enc_norm1(self.enc_conv1(self.enc_dense1(h))))


class SPConvTranspose2d(nn.Module):
    """Sub-pixel upsampling of frequency by ``r``."""

    def __init__(self, cin, features, r=2):
        super().__init__()
        self.r = r
        self.conv = nn.Conv2d(cin, features * r, (1, 3))

    def forward(self, x):
        h = self.conv(x)
        b, rc, t, f = h.shape
        h = h.view(b, self.r, rc // self.r, t, f).permute(0, 2, 3, 4, 1)
        return h.reshape(b, rc // self.r, t, f * self.r)


class DenseDecoder(nn.Module):
    def __init__(self, width=WIDTH):
        super().__init__()
        self.dec_dense1 = DenseBlock(80, 4, width)
        self.dec_conv1 = SPConvTranspose2d(width, width, 2)
        self.dec_norm1 = nn.LayerNorm(161)
        self.dec_prelu1 = nn.PReLU(width)
        self.out_conv = nn.Conv2d(width, 1, 1)

    def forward(self, x):
        h = F.pad(self.dec_dense1(x), (1, 1))
        h = F.pad(self.dec_conv1(h), (1, 0))
        return self.out_conv(self.dec_prelu1(self.dec_norm1(h)))


class AiaComplexTransRI(nn.Module):
    """DB-AIAT's RI branch: ``[B, T, 161, 2] -> [B, T, 161, 2]``."""

    def __init__(self):
        super().__init__()
        self.en_ri = DenseEncoder(2)
        self.dual_trans = AIATransformer(64, 64, 4)
        self.aham = AHAM()
        self.de1 = DenseDecoder()
        self.de2 = DenseDecoder()

    def forward(self, x):
        h = self.aham(self.dual_trans(self.en_ri(x.permute(0, 3, 1, 2))))
        return torch.stack([self.de1(h)[:, 0], self.de2(h)[:, 0]], dim=-1)


PRIORS = {"DiffUNet": DiffUNet, "aia_complex_trans_ri": AiaComplexTransRI}
