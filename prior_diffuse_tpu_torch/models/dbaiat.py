"""DB-AIAT: the dual-branch attention-in-attention transformer priors.

The counterparts of ``prior_diffuse_tpu/models/dbaiat.py``, with its
module names (``convert.py`` maps ``dual_trans/layer0/row_trans/self_attn/
w_in`` to ``dual_trans.layer0.row_trans.self_attn.in_proj_weight``): dense
dilated conv encoders (the complex RI branch and the magnitude branch,
161 -> 80 bins), a dual-path transformer that attends along frequency and
along time with learnable mix weights ``k1``, ``k2``, the AHAM merge of its
per-layer outputs, and dense decoders (80 -> 161 bins; the magnitude
branch's ends in a sigmoid-tanh mask).  The four variants are
``aia_complex_trans_ri`` (``conf/dbaiat.yml``), ``aia_complex_trans_mag``,
``dual_aia_complex_trans`` and ``dual_aia_trans_merge_crm``.

``[B, T, 161, 2] -> [B, T, 161, 2]``.  Inside, NCHW ``[B, C, T, F]``; the
transformer layers take ``[N, L, d]`` sequences of rows (along F) and of
columns (along T).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from prior_diffuse_tpu_torch.models import layers as tl

WIDTH = 64


def _norm_f32(x, dims, eps, weight, bias):
    """``(x - mean) / sqrt(var + eps) * weight + bias`` over ``dims``
    (two-pass statistics), in float32 whatever ``x``'s dtype, the result
    cast back to it: the JAX modules cast their input up (a bf16 serving
    copy's weights are promoted with it)."""
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=dims, keepdim=True, correction=0)
    return ((xf - mean) * torch.rsqrt(var + eps) * weight + bias).to(x.dtype)


class LayerNormOverF(nn.Module):
    """LayerNorm over the frequency axis of ``[B, C, T, F]`` with a per-bin
    affine of size ``F`` (the reference's ``nn.LayerNorm(F)``); two-pass
    statistics in float32, as the JAX module computes them."""

    def __init__(self, freq: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(freq))
        self.bias = nn.Parameter(torch.zeros(freq))

    def forward(self, x):
        return _norm_f32(x, -1, self.eps, self.weight, self.bias)


class GroupNorm1(nn.Module):
    """``nn.GroupNorm(1, C, eps=1e-8)`` on ``[B, T, F, C]``: statistics per
    sample over (T, F, C) (two-pass, float32), affine per channel."""

    def __init__(self, channels: int, eps: float = 1e-8):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return _norm_f32(x, (1, 2, 3), self.eps, self.weight, self.bias)


class TransformerEncoderLayer(nn.Module):
    """Pre-normed self-attention (4 heads), then a bidirectional GRU of
    width ``2 d`` and ``linear2`` back to ``d`` as the feed-forward;
    ``[N, L, d] -> [N, L, d]``.  The GRU and ``linear2`` run in float32
    on the input cast up, their result cast back to it, as in JAX (a bf16
    serving copy holds their weights rounded to bf16 in float32)."""

    F32_PARTS = ("gru", "linear2")
    # a bf16-compute forward (bf16 training, ``models/precision.py``) keeps
    # only the GRU float32: JAX's ``linear2`` is ``nn.Dense(dtype=...)``,
    # so it computes in bf16 there, and the LayerNorms (no dtype field)
    # return float32
    COMPUTE_F32_PARTS = ("gru",)

    def __init__(self, d_model: int, nhead: int = 4):
        super().__init__()
        self.norm3 = nn.LayerNorm(d_model)
        self.self_attn = tl.MultiHeadAttention(d_model, nhead)
        self.norm1 = nn.LayerNorm(d_model)
        self.gru = tl.GRU(d_model, 2 * d_model, bidirectional=True)
        self.linear2 = nn.Linear(4 * d_model, d_model)
        self.norm2 = nn.LayerNorm(d_model)

    def forward(self, src):
        src = self.norm1(src + self.self_attn(self.norm3(src)))
        out = self.linear2(F.relu(self.gru(src.float())))
        return self.norm2(src + out.to(src.dtype))


class _DualPathLayer(nn.Module):
    """One attention pass along frequency (rows: ``[B T, F, C]``) and one
    along time (columns: ``[B F, T, C]``) of ``x [B, C, T, F]``; returns
    both, NCHW."""

    def __init__(self, d_model: int):
        super().__init__()
        self.row_trans = TransformerEncoderLayer(d_model)
        self.row_norm = GroupNorm1(d_model)
        self.col_trans = TransformerEncoderLayer(d_model)
        self.col_norm = GroupNorm1(d_model)

    def forward(self, x):
        b, c, t, f = x.shape
        rows = x.permute(0, 2, 3, 1)  # [B, T, F, C]
        row = self.row_trans(rows.reshape(b * t, f, c)).view(b, t, f, c)
        row = self.row_norm(row)
        cols = x.permute(0, 3, 2, 1).reshape(b * f, t, c)  # [B F, T, C]
        col = self.col_trans(cols).view(b, f, t, c).transpose(1, 2)
        col = self.col_norm(col)
        return row.permute(0, 3, 1, 2), col.permute(0, 3, 1, 2)


class _InProj(nn.Module):
    """1x1 conv, then a PReLU of one slope."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, features, 1)
        self.prelu = nn.PReLU()

    def forward(self, x):
        return self.prelu(self.conv(x))


class _OutProj(nn.Module):
    """A PReLU of one slope, then a 1x1 conv."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.prelu = nn.PReLU()
        self.conv = nn.Conv2d(cin, features, 1)

    def forward(self, x):
        return self.conv(self.prelu(x))


class AIATransformer(nn.Module):
    """The adaptive time-frequency attention transformer: ``h += k1 row +
    k2 col`` per layer; returns ``(last output, [per-layer outputs])``,
    each through the shared output projection."""

    def __init__(self, input_size: int = 64, output_size: int = 64, num_layers: int = 4):
        super().__init__()
        d = input_size // 2
        self.k1 = nn.Parameter(torch.ones(1))
        self.k2 = nn.Parameter(torch.ones(1))
        self.input = _InProj(input_size, d)
        self.output = _OutProj(d, output_size)
        self.num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"layer{i}", _DualPathLayer(d))

    def forward(self, x):
        h = self.input(x)
        outputs = []
        for i in range(self.num_layers):
            row, col = getattr(self, f"layer{i}")(h)
            h = h + (self.k1 * row + self.k2 * col).to(h.dtype)
            outputs.append(self.output(h))
        return outputs[-1], outputs


class AIATransformerMerge(nn.Module):
    """The interactive variant: one input projection of the concatenated
    branches and shared per-layer transformers over an interleaved
    magnitude / RI update chain."""

    def __init__(self, input_size: int = 128, output_size: int = 64, num_layers: int = 4):
        super().__init__()
        d = input_size // 2
        self.k1 = nn.Parameter(torch.ones(1))
        self.k2 = nn.Parameter(torch.ones(1))
        self.input = _InProj(input_size, d)
        self.output = _OutProj(d, output_size)
        self.num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"layer{i}", _DualPathLayer(d))

    def forward(self, x_mag, x_ri):
        merged = torch.cat([x_mag, x_ri], dim=1)
        input_mag = input_ri = self.input(merged)
        outs_mag, outs_ri = [], []
        for i in range(self.num_layers):
            layer = getattr(self, f"layer{i}")
            h_mag = input_mag if i == 0 else outs_mag[-1] + outs_ri[-1]
            row, col = layer(h_mag)
            outs_mag.append(self.output(
                input_mag + (self.k1 * row + self.k2 * col).to(input_mag.dtype)))
            h_ri = input_ri if i == 0 else outs_ri[-1] + outs_mag[-2]
            row, col = layer(h_ri)
            outs_ri.append(self.output(
                input_ri + (self.k1 * row + self.k2 * col).to(input_ri.dtype)))
        return outs_mag[-1], outs_mag, outs_ri[-1], outs_ri


class AHAM(nn.Module):
    """Attention-weighted merge of the per-layer outputs: one 1x1 conv,
    shared across the layers, scores each layer's mean over (T, F); a
    softmax over the layers weighs them; the last layer's output is added.
    ``k3`` is the reference's parameter that its forward never reads,
    kept for the parameter count."""

    # JAX's AHAM conv has no dtype field: float32 in a bf16-compute forward
    COMPUTE_F32_PARTS = ("conv1",)

    def __init__(self, input_channel: int = WIDTH):
        super().__init__()
        self.k3 = nn.Parameter(torch.zeros(1))
        self.conv1 = nn.Conv2d(input_channel, 1, 1)

    def forward(self, inputs: List[torch.Tensor]):
        ys = [self.conv1(x.mean(dim=(2, 3), keepdim=True))[:, 0, 0, 0] for x in inputs]
        w = tl.softmax(torch.stack(ys, dim=-1), dim=-1)  # [B, layers]
        merged = sum(w[:, g, None, None, None] * inputs[g] for g in range(len(inputs)))
        return inputs[-1] + merged


class DenseBlock(nn.Module):
    """``depth`` causal (2, 3) convs dilated 1, 2, 4, 8 in time (the input
    padded by ``dil`` frames before and one bin each side), each followed
    by LayerNorm over F and a PReLU per channel, every one fed the concat
    of all earlier outputs and the input."""

    def __init__(self, freq: int, depth: int = 4, width: int = WIDTH):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            setattr(self, f"conv{i + 1}", nn.Conv2d(width * (i + 1), width, (2, 3),
                                                    dilation=(2 ** i, 1)))
            setattr(self, f"norm{i + 1}", LayerNormOverF(freq))
            setattr(self, f"prelu{i + 1}", nn.PReLU(width))

    def forward(self, x):
        skip = out = x
        for i in range(1, self.depth + 1):
            h = getattr(self, f"conv{i}")(F.pad(skip, (1, 1, 2 ** (i - 1), 0)))
            out = getattr(self, f"prelu{i}")(getattr(self, f"norm{i}")(h))
            skip = torch.cat([out, skip], dim=1)
        return out


class DenseEncoder(nn.Module):
    """1x1 conv to 64 channels, a dense block at 161 bins, then a (1, 3)
    conv of stride 2 to 80 bins; ``in_channels`` 2 (RI) or 1 (magnitude)."""

    def __init__(self, in_channels: int, width: int = WIDTH):
        super().__init__()
        self.inp_conv = nn.Conv2d(in_channels, width, 1)
        self.inp_norm = LayerNormOverF(161)
        self.inp_prelu = nn.PReLU(width)
        self.enc_dense1 = DenseBlock(161, 4, width)
        self.enc_conv1 = nn.Conv2d(width, width, (1, 3), stride=(1, 2))
        self.enc_norm1 = LayerNormOverF(80)
        self.enc_prelu1 = nn.PReLU(width)

    def forward(self, x):
        h = self.inp_prelu(self.inp_norm(self.inp_conv(x)))
        h = self.enc_conv1(self.enc_dense1(h))
        return self.enc_prelu1(self.enc_norm1(h))


class SPConvTranspose2d(nn.Module):
    """Sub-pixel upsampling of frequency by ``r``: a (1, 3) conv to ``r C``
    channels, then output channel ``j C + c`` at bin ``f`` becomes channel
    ``c`` at bin ``f r + j`` (JAX's channels-last ``[F, r, C]`` split, the
    reference's ``view(b, r, C, T, F)`` and permute)."""

    def __init__(self, cin: int, features: int, r: int = 2):
        super().__init__()
        self.r = r
        self.conv = nn.Conv2d(cin, features * r, (1, 3))

    def forward(self, x):
        h = self.conv(x)
        b, rc, t, f = h.shape
        h = h.view(b, self.r, rc // self.r, t, f).permute(0, 2, 3, 4, 1)
        return h.reshape(b, rc // self.r, t, f * self.r)


class DenseDecoder(nn.Module):
    """A dense block at 80 bins, sub-pixel upsampling to 160 and one zero
    bin in front (161), LayerNorm over F and PReLU, a 1x1 conv to one
    channel; with ``masking`` a sigmoid-tanh gate and a sigmoid mask.
    ``[B, 64, T, 80] -> [B, 1, T, 161]``."""

    def __init__(self, width: int = WIDTH, masking: bool = False):
        super().__init__()
        self.masking = masking
        self.dec_dense1 = DenseBlock(80, 4, width)
        self.dec_conv1 = SPConvTranspose2d(width, width, 2)
        self.dec_norm1 = LayerNormOverF(161)
        self.dec_prelu1 = nn.PReLU(width)
        self.out_conv = nn.Conv2d(width, 1, 1)
        if masking:
            self.mask1 = nn.Conv2d(1, 1, 1)
            self.mask2 = nn.Conv2d(1, 1, 1)
            self.maskconv = nn.Conv2d(1, 1, 1)

    def forward(self, x):
        h = F.pad(self.dec_dense1(x), (1, 1))
        h = F.pad(self.dec_conv1(h), (1, 0))
        h = self.out_conv(self.dec_prelu1(self.dec_norm1(h)))
        if self.masking:
            h = tl.sigmoid(self.mask1(h)) * torch.tanh(self.mask2(h))
            h = tl.sigmoid(self.maskconv(h))
        return h


def _mag_phase(x):
    """``[B, T, F, 2]`` -> magnitude and phase ``[B, T, F]``.  At a bin of
    exactly 0 the magnitude's gradient is 0 here and NaN in JAX
    (``jnp.linalg.norm``)."""
    return torch.linalg.vector_norm(x, dim=-1), torch.atan2(x[..., 1], x[..., 0])


def _nchw(x):
    return x.permute(0, 3, 1, 2)


class AiaComplexTransRI(nn.Module):
    """The RI branch only (``conf/dbaiat.yml``)."""

    def __init__(self):
        super().__init__()
        self.en_ri = DenseEncoder(2)
        self.dual_trans = AIATransformer(64, 64, 4)
        self.aham = AHAM()
        self.de1 = DenseDecoder()
        self.de2 = DenseDecoder()

    def forward(self, x):
        _, outs = self.dual_trans(self.en_ri(_nchw(x)))
        h = self.aham(outs)
        return torch.stack([self.de1(h)[:, 0], self.de2(h)[:, 0]], dim=-1)


class AiaComplexTransMag(nn.Module):
    """The magnitude mask only, on the noisy phase."""

    def __init__(self):
        super().__init__()
        self.en_mag = DenseEncoder(1)
        self.dual_trans_mag = AIATransformer(64, 64, 4)
        self.aham_mag = AHAM()
        self.de_mag_mask = DenseDecoder(masking=True)

    def forward(self, x):
        mag, phase = _mag_phase(x)
        _, outs = self.dual_trans_mag(self.en_mag(mag[:, None]))
        out_mag = self.de_mag_mask(self.aham_mag(outs))[:, 0] * mag
        return torch.stack([out_mag * torch.cos(phase), out_mag * torch.sin(phase)], dim=-1)


class DualAiaComplexTrans(nn.Module):
    """Both branches, independent; the magnitudes averaged on the RI
    branch's phase."""

    def __init__(self):
        super().__init__()
        self.en_ri = DenseEncoder(2)
        self.dual_trans = AIATransformer(64, 64, 4)
        self.aham = AHAM()
        self.en_mag = DenseEncoder(1)
        self.dual_trans_mag = AIATransformer(64, 64, 4)
        self.aham_mag = AHAM()
        self.de_mag_mask = DenseDecoder(masking=True)
        self.de1 = DenseDecoder()
        self.de2 = DenseDecoder()

    def forward(self, x):
        mag, _ = _mag_phase(x)
        _, outs_ri = self.dual_trans(self.en_ri(_nchw(x)))
        h_ri = self.aham(outs_ri)
        _, outs_mag = self.dual_trans_mag(self.en_mag(mag[:, None]))
        masked_mag = self.de_mag_mask(self.aham_mag(outs_mag))[:, 0] * mag
        com = torch.stack([self.de1(h_ri)[:, 0], self.de2(h_ri)[:, 0]], dim=-1).to(mag.dtype)
        pre_mag, pre_phase = _mag_phase(com)
        out_mag = (masked_mag + pre_mag) / 2.0
        return torch.stack([out_mag * torch.cos(pre_phase), out_mag * torch.sin(pre_phase)],
                           dim=-1)


class DualAiaTransMergeCRM(nn.Module):
    """Both branches through the interactive merge transformer; the masked
    noisy magnitude on the noisy phase plus the RI branch's estimate."""

    def __init__(self):
        super().__init__()
        self.en_ri = DenseEncoder(2)
        self.en_mag = DenseEncoder(1)
        self.aia_trans_merge = AIATransformerMerge(128, 64, 4)
        self.aham = AHAM()
        self.aham_mag = AHAM()
        self.de_mag_mask = DenseDecoder(masking=True)
        self.de1 = DenseDecoder()
        self.de2 = DenseDecoder()

    def forward(self, x):
        mag, phase = _mag_phase(x)
        h_ri, h_mag = self.en_ri(_nchw(x)), self.en_mag(mag[:, None])
        _, outs_mag, _, outs_ri = self.aia_trans_merge(h_mag, h_ri)
        h_ri, h_mag = self.aham(outs_ri), self.aham_mag(outs_mag)
        out_mag = self.de_mag_mask(h_mag)[:, 0] * mag
        real, imag = self.de1(h_ri)[:, 0], self.de2(h_ri)[:, 0]
        return torch.stack([out_mag * torch.cos(phase) + real,
                            out_mag * torch.sin(phase) + imag], dim=-1)
