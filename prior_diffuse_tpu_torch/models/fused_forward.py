"""Inference forward of the DiffUNet family in float32 or bfloat16: the
encoder on K3, the TCMs, and the decoders either as the two ``Decoder``
modules or as one block-diagonal dual chain.

The counterpart of ``prior_diffuse_tpu/models/fused_forward.py``
(``_dual_dec_stage``, ``pack_dual_decoder``, ``dual_decoder_forward`` with
``fold_bn=True``, ``pack_unet``, ``fused_unet_forward``), packed from the
port's own modules (``models/diffunet.py``).  The dual decoder merges the
``de_real`` / ``de_imag`` branches of each stage into one op chain at twice
the width, channels ``[real | imag]``: its 1x1 products are block-diagonal
matrices and its paired transposed conv a ``groups=2`` convolution (the
zeros of a block-diagonal product add exact zeros, so both compute the
numbers of the two branches).  Inference BatchNorm and PReLU fold into
each stage's operands in float32.

Precision follows the JAX package's bf16 serving forward: operands are
packed in float32 and cast last; the 1x1 products take bf16 operands and
add their f32 bias to the f32 sums before one rounding; the folded time
projection is an f32 product of the bf16 embedding; TCMs and ``Decoder``
modules run as flax's ``dtype=bfloat16`` modules do (inputs, kernels and
biases in bf16, inference BatchNorm computed in f32 from the f32
statistics, PReLU with its slope in bf16), here as copies of the modules
with their convolution, linear and PReLU parameters cast (BatchNorm stays
f32).
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from prior_diffuse_tpu_torch.models import layers as tl
from prior_diffuse_tpu_torch.models.diffunet import UNetCore
from prior_diffuse_tpu_torch.ops.cuda.convblock import encoder_fused, pack_encoder

G = 32  # BiConvTransGLU gate width
_CAST = (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d, nn.Linear, nn.PReLU)


def _wt(conv) -> torch.Tensor:
    """1x1 ``ConvTranspose2d`` weight ``[in, out, 1, 1]`` -> ``[in, out]``."""
    return conv.weight[:, :, 0, 0]


def _mm(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ w + b`` in ``a``'s dtype, ``b`` float32 (``[N]`` or
    broadcasting over ``a``'s rows): JAX's ``_mm``, the product summed in
    f32, the f32 bias added, one rounding.  In bfloat16 on the card the
    product leaves cuBLAS in f32 and the bias add writes the bf16 result
    (two launches); the CPU has no bf16 product with an f32 output, so
    there it takes the bf16 operands in f32, which are the same sums."""
    if a.dtype == torch.float32:
        return torch.matmul(a, w) + b
    a2 = a.reshape(-1, a.shape[-1])
    y = (torch.mm(a2, w, out_dtype=torch.float32) if a.is_cuda
         else torch.mm(a2.float(), w.float()))
    y = y.view(*a.shape[:-1], w.shape[-1])
    return torch.add(y, b, out=torch.empty(y.shape, dtype=a.dtype, device=a.device))


def _dual_stage(dr, di, bn, prelu, last: bool) -> dict:
    """One decoder stage's ``BiConvTransGLU`` pair (``dr``, ``di``) as
    float32 dual-branch operands (``_dual_dec_stage``), with its
    ``BatchNorm2d`` and ``PReLU`` pairs folded in unless ``last`` or unless
    ``bn`` is None (training: BN runs on batch statistics and cannot fold;
    ``fold_bn=False``).  Differentiable: the blocks are
    ``torch.block_diag`` and concatenations of the branch weights."""
    w1r, w1i = _wt(dr.conv1), _wt(di.conv1)  # [128, 32]: branch x, then skip
    half = w1r.shape[0] // 2
    # rows: z_real, z_imag, then the skip shared by both branches
    w1 = torch.cat([torch.block_diag(w1r[:half], w1i[:half]),
                    torch.cat([w1r[half:], w1i[half:]], dim=1)])
    st = {"w1": w1}
    b1 = torch.cat([dr.conv1.bias, di.conv1.bias])
    if dr.tp is not None:  # fold the per-branch time projection through conv1
        st["tp2b"] = torch.cat([dr.tp.weight.t() @ w1r, di.tp.weight.t() @ w1i], dim=1)
        b1 = b1 + torch.cat([dr.tp.bias @ w1r, di.tp.bias @ w1i])
    st["b1"] = b1
    # the l/r transposed convs of each branch as one group: [64, 64, kh, kw]
    st["wp"] = torch.cat([torch.cat([dr.l.weight, dr.r.weight], dim=1),
                          torch.cat([di.l.weight, di.r.weight], dim=1)])
    st["bp"] = torch.cat([dr.l.bias, dr.r.bias, di.l.bias, di.r.bias])
    st["wg"] = torch.block_diag(*(_wt(c) for c in (dr.l_conv, dr.r_conv, di.l_conv, di.r_conv)))
    st["bg"] = torch.cat([dr.l_conv.bias, dr.r_conv.bias, di.l_conv.bias, di.r_conv.bias])
    cout = dr.conv2.weight.shape[1]
    w2 = torch.block_diag(_wt(dr.conv2), _wt(di.conv2))
    b2 = torch.cat([dr.conv2.bias, di.conv2.bias])
    if not last and bn is not None:  # fold inference BN (it commutes with the time chomp)
        cat = lambda name: torch.cat([getattr(bn[0], name), getattr(bn[1], name)])
        scale = cat("weight") / torch.sqrt(cat("running_var") + bn[0].eps)
        w2 = w2 * scale[None, :]
        b2 = b2 * scale + cat("bias") - cat("running_mean") * scale
        st["alpha"] = torch.cat([prelu[0].weight.expand(cout), prelu[1].weight.expand(cout)])
    st["w2"], st["b2"] = w2, b2
    return st


@torch.no_grad()
def pack_dual_decoder(core, dtype: torch.dtype = torch.float32) -> list:
    """The ``de_real`` / ``de_imag`` ``Decoder`` pair of a ``UNetCore`` as
    five dual-branch stages (de5 .. de1), folded in float32, then the
    product weights, ``bp`` and ``alpha`` cast to ``dtype`` (``tp2b``
    rounded to it and kept f32 for the f32 product with the embedding);
    ``b1``, ``bg`` and ``b2`` stay float32."""
    stages = []
    for idx in (5, 4, 3, 2, 1):
        last = idx == 1
        pair = lambda name: (None if last else
                             (getattr(core.de_real, f"{name}{idx}"),
                              getattr(core.de_imag, f"{name}{idx}")))
        st = _dual_stage(getattr(core.de_real, f"de{idx}"), getattr(core.de_imag, f"de{idx}"),
                         pair("bn"), pair("prelu"), last)
        for name in ("w1", "wp", "bp", "wg", "w2", "alpha"):
            if name in st:
                st[name] = st[name].to(dtype).contiguous()
        if "tp2b" in st:
            st["tp2b"] = st["tp2b"].to(dtype).float()
        stages.append(st)
    return stages


def dual_decoder_forward(stages, x: torch.Tensor, skips, temb: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Both decoder branches as one op chain (inference, BN folded).
    ``x [B, T, 4, 64]`` is the bottleneck and ``skips`` the encoder outputs,
    channels-last, in the stages' dtype; ``temb [B, 512]`` for a
    time-conditioned net.  Returns ``[B, T, 161, 2]``, channels ``[real |
    imag]`` (the two ``Decoder`` outputs side by side)."""
    dt = x.dtype
    z = torch.cat([x, x], dim=-1)
    for st, skip in zip(stages, reversed(skips)):
        b1 = st["b1"]
        if temb is not None and "tp2b" in st:
            b1 = (b1 + torch.matmul(temb.float(), st["tp2b"]))[:, None, None, :]
        h = _mm(torch.cat([z, skip.to(dt)], dim=-1), st["w1"], b1)
        y = F.conv_transpose2d(h.permute(0, 3, 1, 2), st["wp"], st["bp"], stride=(1, 2),
                               groups=2).permute(0, 2, 3, 1)
        gate = torch.sigmoid(_mm(y, st["wg"], st["bg"]))
        comb = torch.cat([y[..., :G] * gate[..., G:2 * G] + y[..., G:2 * G] * gate[..., :G],
                          y[..., 2 * G:3 * G] * gate[..., 3 * G:]
                          + y[..., 3 * G:] * gate[..., 2 * G:3 * G]], dim=-1)
        out = _mm(comb, st["w2"], st["b2"])[:, :-1]  # time chomp
        if "alpha" in st:
            out = torch.where(out >= 0, out, st["alpha"] * out)
        z = out
    return z


def _mm_train(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dtype: torch.dtype
              ) -> torch.Tensor:
    """JAX's ``_mm`` under autograd: ``a @ w`` over ``dtype`` operands
    summed in float32 (the product of the upcast operands: the same sums),
    the f32 bias added, one rounding to ``a``'s dtype.  (``_mm``'s
    ``out_dtype`` product and ``out=`` add do not differentiate.)"""
    return (torch.matmul(a.to(dtype).float(), w.to(dtype).float()) + b).to(a.dtype)


def dual_decoder_train_forward(core, x: torch.Tensor, skips, temb: Optional[torch.Tensor],
                               dtype: torch.dtype) -> torch.Tensor:
    """Train-mode dual decoder (JAX ``dual_decoder_train_forward``,
    ``fused_forward.py:232-282``): the block-diagonal chain of
    :func:`dual_decoder_forward` packed *inside* the forward from the
    canonical ``de_real`` / ``de_imag`` modules of ``core`` (BN unfolded),
    so gradients reach their parameters; each stage's BatchNorm is one
    128-channel train-mode BatchNorm over ``[real | imag]`` (per-channel
    statistics: exactly the two branch BatchNorms), whose statistics move
    the two branches' running statistics, and the PReLU slopes are
    broadcast per branch.  Products in ``dtype`` with f32 sums and an f32
    bias, the paired transposed conv rounded before its bias, XLA's sigmoid,
    BatchNorm in f32.  ``x [B, T, 4, 64]`` and ``skips`` channels-last."""
    z = torch.cat([x, x], dim=-1)
    for idx, skip in zip((5, 4, 3, 2, 1), reversed(skips)):
        dr, di = getattr(core.de_real, f"de{idx}"), getattr(core.de_imag, f"de{idx}")
        st = _dual_stage(dr, di, None, None, idx == 1)
        b1 = st["b1"]
        if temb is not None and "tp2b" in st:
            b1 = (b1 + torch.matmul(temb.to(dtype).float(),
                                    st["tp2b"].to(dtype).float()))[:, None, None, :]
        h = _mm_train(torch.cat([z, skip.to(z.dtype)], dim=-1), st["w1"], b1, dtype)
        y = F.conv_transpose2d(h.permute(0, 3, 1, 2).to(dtype), st["wp"].to(dtype), None,
                               stride=(1, 2), groups=2)
        y = (y + st["bp"].to(dtype)[:, None, None]).permute(0, 2, 3, 1).to(z.dtype)
        gate = tl.sigmoid(_mm_train(y, st["wg"], st["bg"], dtype))
        comb = torch.cat([y[..., :G] * gate[..., G:2 * G] + y[..., G:2 * G] * gate[..., :G],
                          y[..., 2 * G:3 * G] * gate[..., 3 * G:]
                          + y[..., 3 * G:] * gate[..., 2 * G:3 * G]], dim=-1)
        out = _mm_train(comb, st["w2"], st["b2"], dtype)[:, :-1]  # time chomp
        if idx != 1:
            bns = (getattr(core.de_real, f"bn{idx}"), getattr(core.de_imag, f"bn{idx}"))
            out, mean, var = tl.batch_norm_train(
                out, torch.cat([bn.weight for bn in bns]), torch.cat([bn.bias for bn in bns]),
                bns[0].eps, channel_dim=-1)
            c = out.shape[-1] // 2
            bns[0].update_stats(mean[:c], var[:c])
            bns[1].update_stats(mean[c:], var[c:])
            pr, pi = getattr(core.de_real, f"prelu{idx}"), getattr(core.de_imag, f"prelu{idx}")
            alpha = torch.cat([pr.weight.expand(c), pi.weight.expand(c)]).to(out.dtype)
            out = torch.where(out >= 0, out, alpha * out)
        z = out
    return z


def dual_train_forward(view, x: torch.Tensor, x_init: Optional[torch.Tensor] = None,
                       t: Optional[torch.Tensor] = None,
                       dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The DiffUNet family's bf16 train forward (JAX ``dual_train_forward``,
    ``fused_forward.py:285-337``, the JAX DDPM trainer's default in bf16):
    ``DiffUNet1(x, x_init, t)``, ``Nocon(x, t)`` (``x_init`` None) or
    ``DiffUNet(x)`` (both None) in train mode, with the two decoders as
    :func:`dual_decoder_train_forward`.  ``view`` is the net's
    ``models/precision.py::compute_view`` in ``dtype``, in train mode: the
    preprocess, the encoder and the TCMs run as its modules (train-mode
    BatchNorm moving the net's statistics), the time embedding in float32
    cast to ``dtype``.  ``x``, ``x_init [B, T, 161, C]`` channels-last;
    returns ``[B, T, 161, 2]`` in ``dtype``."""
    if not view.training:
        raise ValueError("the dual train forward runs in train mode")
    if (x_init is None) == hasattr(view, "preprocess"):
        raise ValueError("DiffUNet1 takes a conditioner x_init; Nocon and DiffUNet take "
                         "none (x_init=None)")
    if x_init is not None:
        x = view.preprocess(torch.cat([x, x_init.to(x.dtype)], dim=-1).permute(0, 3, 1, 2))
    else:
        x = x.permute(0, 3, 1, 2)
    temb = None if t is None else view.time_embedding(t).to(dtype)
    core = view.core
    xe, skips = core.en(x, temb)
    xb = UNetCore.bottleneck(xe, (core.tcm1, core.tcm2, core.tcm3))
    return dual_decoder_train_forward(core, xb.permute(0, 2, 3, 1),
                                      [s.permute(0, 2, 3, 1) for s in skips], temb, dtype)


def _cast_copy(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """An inference copy of ``module`` whose convolution, linear and PReLU
    parameters are in ``dtype``; its BatchNorm parameters and statistics
    stay float32 (torch's batch norm takes a bf16 input with f32
    statistics and computes in f32, as flax's does)."""
    out = copy.deepcopy(module).eval()
    for m in out.modules():
        if isinstance(m, _CAST):
            m.to(dtype)
    return out


@torch.no_grad()
def pack_unet(net, dtype: torch.dtype = torch.float32, dual_decoder: bool = False) -> dict:
    """Operands of a ``DiffUNet`` / ``DiffUNet1`` / ``Nocon`` for
    :func:`fused_unet_forward` in ``dtype`` (float32 or bfloat16): K3's
    encoder stages, the TCMs, the decoders (dual stages, or the two
    ``Decoder`` modules), the preprocess 1x1 and the time embedding.  In
    float32 the TCMs and ``Decoder``s are the net's own modules; in
    bfloat16 cast copies.  Repack after a weight change."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the fused forward runs in float32 or bfloat16, not {dtype}")
    core = net.core
    cast = (lambda m: m) if dtype == torch.float32 else (lambda m: _cast_copy(m, dtype))
    packed = {"dtype": dtype,
              "enc": pack_encoder(core.en, dtype),
              "tcm": [cast(core.tcm1), cast(core.tcm2), cast(core.tcm3)],
              "dual": pack_dual_decoder(core, dtype) if dual_decoder else None,
              "dec": None if dual_decoder else (cast(core.de_real), cast(core.de_imag)),
              "pre": None,
              "temb": getattr(net, "time_embedding", None)}
    if hasattr(net, "preprocess"):
        w = net.preprocess.weight[:, :, 0, 0].t()  # [2 + cond, 2]
        packed["pre"] = (w if dtype == torch.float32 else w.to(dtype), net.preprocess.bias)
    return packed


def fused_unet_forward(packed: dict, x: torch.Tensor, x_init: Optional[torch.Tensor] = None,
                       t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inference forward in the pack's dtype and decoder route
    (:func:`pack_unet`): ``DiffUNet1(x, x_init, t)``, ``Nocon(x, t)``
    (``x_init`` None) or ``DiffUNet(x)`` (``x_init`` and ``t`` None).
    ``x``, ``x_init [B, T, 161, C]`` channels-last (cast to the pack's
    dtype), ``t [B]``; returns ``[B, T, 161, 2]`` in the pack's dtype.  As
    the JAX forward: the preprocess 1x1 as a product, the time embedding
    in f32 cast to the dtype, the encoder through K3, the three TCMs, then
    the decoders.  A conditioner is taken exactly when the net has a
    preprocess (``DiffUNet1``)."""
    if packed["tcm"][0].training:
        raise ValueError("the fused forward folds the running BN statistics: inference only")
    if (x_init is None) != (packed["pre"] is None):
        raise ValueError("DiffUNet1 takes a conditioner x_init; Nocon and DiffUNet take "
                         "none (x_init=None)")
    dt = packed["dtype"]
    x = x.to(dt)
    if x_init is not None:
        w, b = packed["pre"]
        x = _mm(torch.cat([x, x_init.to(dt)], dim=-1), w, b)
    temb = None if t is None else packed["temb"](t).to(dt)
    x, skips = encoder_fused(x.contiguous(), packed["enc"], temb)
    x = UNetCore.bottleneck(x.permute(0, 3, 1, 2), packed["tcm"])  # NCHW
    if packed["dual"] is not None:
        return dual_decoder_forward(packed["dual"], x.permute(0, 2, 3, 1), skips, temb)
    skips = [s.permute(0, 3, 1, 2) for s in skips]
    return UNetCore.decode(x, skips, temb, packed["dec"]).permute(0, 2, 3, 1)
