"""GCRN: the conv-GLU recurrent encoder-decoder prior of ``conf/gcrn.yml``.

The counterpart of ``prior_diffuse_tpu/models/gcrn.py``, with its module
names (``conv1/conv1/kernel`` is ``conv1.conv1.weight``,
``glstm/lstm1_0/w_ih`` is ``glstm.lstm1_0.weight_ih_l0``; ``convert.py``):
five gated conv stages (2 -> 16 -> 32 -> 64 -> 128 -> 256 channels, stride
2 in frequency: 161 -> 80 -> 39 -> 19 -> 9 -> 4), a grouped two-layer LSTM
over the c-major flattened bottleneck, and real and imaginary decoders of
gated transposed convs with skip concats, each ending in a Linear(161)
over frequency.  ``[B, T, 161, 2] -> [B, T, 161, 2]``; inside, NCHW.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from prior_diffuse_tpu_torch.models import layers as tl

_ENC = (2, 16, 32, 64, 128, 256)


class GluConv2d(nn.Module):
    """Two (1, 3) convs of one input, stride (1, 2); the second gates the
    first through a sigmoid."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, features, (1, 3), stride=(1, 2))
        self.conv2 = nn.Conv2d(cin, features, (1, 3), stride=(1, 2))

    def forward(self, x):
        return self.conv1(x) * tl.sigmoid(self.conv2(x))


class GluConvTranspose2d(nn.Module):
    """The transposed counterpart: ``F_out = 2 (F - 1) + 3 + output_padding``."""

    def __init__(self, cin: int, features: int, output_padding=(0, 0)):
        super().__init__()
        kw = dict(stride=(1, 2), output_padding=output_padding)
        self.conv1 = nn.ConvTranspose2d(cin, features, (1, 3), **kw)
        self.conv2 = nn.ConvTranspose2d(cin, features, (1, 3), **kw)

    def forward(self, x):
        return self.conv1(x) * tl.sigmoid(self.conv2(x))


class GLSTM(nn.Module):
    """Grouped two-layer LSTM over ``[B, C, T, F]``: (C, F) flattened
    c-major to ``hidden`` features, ``groups`` LSTMs of ``hidden / groups``
    on consecutive slices, their outputs interleaved feature by feature
    (the reference's ``stack(-1)`` and flatten) before ``ln1``, the second
    layer's concatenated before ``ln2``, then the (C, F) grid again.
    Always float32, as the JAX package keeps it: a bf16 serving copy holds
    its weights rounded to bf16 in float32 (``F32_PARTS`` of
    :class:`GCRN`)."""

    def __init__(self, hidden: int = 1024, groups: int = 2):
        super().__init__()
        self.groups = groups
        gh = hidden // groups
        for i in range(groups):
            setattr(self, f"lstm1_{i}", tl.LSTM(gh, gh))
            setattr(self, f"lstm2_{i}", tl.LSTM(gh, gh))
        self.ln1 = nn.LayerNorm(hidden)
        self.ln2 = nn.LayerNorm(hidden)

    def forward(self, x):
        b, c, t, f = x.shape
        out = x.float().permute(0, 2, 1, 3).reshape(b, t, c * f)
        chunks = out.chunk(self.groups, dim=-1)
        outs = [getattr(self, f"lstm1_{i}")(chunks[i]) for i in range(self.groups)]
        out = self.ln1(torch.stack(outs, dim=-1).reshape(b, t, c * f))
        chunks = out.chunk(self.groups, dim=-1)
        outs = [getattr(self, f"lstm2_{i}")(chunks[i]) for i in range(self.groups)]
        out = self.ln2(torch.cat(outs, dim=-1))
        return out.reshape(b, t, c, f).permute(0, 2, 1, 3)


class _Decoder(nn.Module):
    """One real-or-imaginary branch: ``elu(cat(bn(convT(x)), skip))`` per
    stage (the ELU after the concat, so on the skip too), then a Linear
    over the 161 bins of the last stage's single channel."""

    def __init__(self):
        super().__init__()
        self.conv5_t = GluConvTranspose2d(512, 128)
        self.conv4_t = GluConvTranspose2d(256, 64)
        self.conv3_t = GluConvTranspose2d(128, 32)
        self.conv2_t = GluConvTranspose2d(64, 16, output_padding=(0, 1))
        self.conv1_t = GluConvTranspose2d(32, 1)
        for i, c in zip(range(5, 0, -1), (128, 64, 32, 16, 1)):
            setattr(self, f"bn{i}_t", tl.BatchNorm2d(c))
        self.fc = nn.Linear(161, 161)

    def forward(self, x, skips):
        d = x
        for i, skip in zip(range(5, 1, -1), reversed(skips)):
            d = getattr(self, f"bn{i}_t")(getattr(self, f"conv{i}_t")(d))
            d = F.elu(torch.cat([d, skip], dim=1))
        d = F.elu(self.bn1_t(self.conv1_t(d)))
        return self.fc(d[:, 0])  # [B, T, 161]


class GCRN(nn.Module):
    """Complex-spectrum prior; ``[B, T, 161, 2] -> [B, T, 161, 2]``.  In a
    bf16 serving copy (``serving/enhancer.py::serving_copy``) the grouped
    LSTM runs in float32 on the bf16 bottleneck cast up, and its output is
    cast back to the bottleneck's dtype, as JAX's forward does."""

    F32_PARTS = ("glstm",)
    # and in a bf16-compute forward (``models/precision.py``) on its
    # unrounded float32 weights: JAX's GLSTM has no dtype field
    COMPUTE_F32_PARTS = ("glstm",)

    def __init__(self):
        super().__init__()
        for i in range(1, 6):
            setattr(self, f"conv{i}", GluConv2d(_ENC[i - 1], _ENC[i]))
            setattr(self, f"bn{i}", tl.BatchNorm2d(_ENC[i]))
        self.glstm = GLSTM()
        self.dec_real = _Decoder()
        self.dec_imag = _Decoder()

    def forward(self, x):
        e = x.permute(0, 3, 1, 2)
        skips = []
        for i in range(1, 6):
            e = F.elu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(e)))
            skips.append(e)
        out = torch.cat([self.glstm(e).to(e.dtype), e], dim=1)
        skips = skips[:4]
        return torch.stack([self.dec_real(out, skips), self.dec_imag(out, skips)], dim=-1)
