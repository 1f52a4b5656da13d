"""GRN: the gated residual magnitude prior of ``conf/grn.yml``.

The counterpart of ``prior_diffuse_tpu/models/grn.py``, with its module
names (``glu_0_3/left_conv/kernel`` is ``glu_0_3.left_conv.weight``;
``convert.py``): four 5x5 convs over (T, F) dilated 1, 1, 2, 4 along
frequency, the (C, F) grid flattened c-major to 32 x 161 = 5,152 channels,
a 1x1 conv to 256, 18 gated residual blocks (three groups of dilations
1 .. 32, kernel 7) whose outputs are all added back to the trunk, and a
1x1 conv head to a sigmoid mask on the input magnitude.
``[B, T, 161] -> [B, T, 161]``; inside, the 2-D front end is NCHW
``[B, C, T, F]`` and the 1-D trunk ``[B, C, T]``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from prior_diffuse_tpu_torch.models import layers as tl

WIDTH = 256


class GLU(nn.Module):
    """One gated residual block on ``[B, 256, T]``: a 1x1 conv to 64, BN,
    ELU, then two kernel-7 convs dilated ``dilation`` (zero-padded by
    ``3 dilation`` frames on each side, more than T for short inputs), the
    left one BN'd, the right one BN'd into a sigmoid gate, their product
    through a 1x1 conv back to 256 and BN.  Returns ``(elu(block + x),
    block)``."""

    def __init__(self, dilation: int):
        super().__init__()
        self.in_conv = nn.Conv1d(WIDTH, 64, 1)
        self.in_bn = tl.BatchNorm1d(64)
        pad = 3 * dilation
        self.left_conv = nn.Conv1d(64, 64, 7, dilation=dilation, padding=pad)
        self.right_conv = nn.Conv1d(64, 64, 7, dilation=dilation, padding=pad)
        self.left_bn = tl.BatchNorm1d(64)
        self.right_bn = tl.BatchNorm1d(64)
        self.out_conv = nn.Conv1d(64, WIDTH, 1)
        self.out_bn = tl.BatchNorm1d(WIDTH)

    def forward(self, x):
        a = F.elu(self.in_bn(self.in_conv(x)))
        h = self.left_bn(self.left_conv(a)) * tl.sigmoid(self.right_bn(self.right_conv(a)))
        out = self.out_bn(self.out_conv(h))
        return F.elu(out + x), out


class GRN(nn.Module):
    """Magnitude prior; ``[B, T, 161] -> [B, T, 161]`` (the input times a
    sigmoid mask)."""

    def __init__(self):
        super().__init__()
        self.dila1 = nn.Conv2d(1, 16, 5, padding=2)
        self.dila2 = nn.Conv2d(16, 16, 5, padding=2)
        self.dila3 = nn.Conv2d(16, 32, 5, dilation=(1, 2), padding=(2, 4))
        self.dila4 = nn.Conv2d(32, 32, 5, dilation=(1, 4), padding=(2, 8))
        self.conv1d_in = nn.Conv1d(32 * 161, WIDTH, 1)
        self.bn_in = tl.BatchNorm1d(WIDTH)
        for g in range(3):
            for i in range(6):
                setattr(self, f"glu_{g}_{i}", GLU(2 ** i))
        self.conv1d_3 = nn.Conv1d(WIDTH, WIDTH, 1)
        self.bn3 = tl.BatchNorm1d(WIDTH)
        self.conv1d_4 = nn.Conv1d(WIDTH, 128, 1)
        self.bn4 = tl.BatchNorm1d(128)
        self.conv1d_5 = nn.Conv1d(128, 161, 1)
        self.bn5 = tl.BatchNorm1d(161)

    def forward(self, x):
        h = x[:, None]  # [B, 1, T, F]
        for conv in (self.dila1, self.dila2, self.dila3, self.dila4):
            h = F.elu(conv(h))
        b, c, t, f = h.shape
        # (C, F) c-major, as the reference's permute and reshape: [B, C F, T]
        h = h.permute(0, 1, 3, 2).reshape(b, c * f, t)
        h = F.relu(self.bn_in(self.conv1d_in(h)))
        outs = []
        for g in range(3):
            for i in range(6):
                h, out = getattr(self, f"glu_{g}_{i}")(h)
                outs.append(out)
        for out in outs:
            h = h + out
        h = F.elu(self.bn3(self.conv1d_3(h)))
        h = self.bn4(self.conv1d_4(h))
        mask = tl.sigmoid(self.bn5(self.conv1d_5(h)))  # [B, 161, T]
        return x * mask.transpose(1, 2)
