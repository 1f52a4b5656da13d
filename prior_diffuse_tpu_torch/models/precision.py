"""The bf16-compute forward of bf16 training: a model computed in bfloat16
on its own float32 parameters.

The JAX trainers train with ``train.compute_dtype: bfloat16`` by building
each model with ``dtype=bfloat16`` and keeping its parameters float32
(``training/ddpm_trainer.py:122-161``, ``complex_trainer.py:36-45``,
``mag_trainer.py:41-50``): flax casts a weight inside the op of every
module that has a ``dtype`` field, so its gradient comes back to the f32
leaf, and promotes the rest.  :func:`compute_view` gives a module the same
policy, as ``python3 tools/bf16_trace.py --train`` traces it (PERF.md §6):

* a conv or linear layer casts its input, weight and bias to the dtype and
  rounds its product before adding the bias, as flax's do;
* a PReLU takes its slope in its input's dtype (JAX's ``a.astype(x.dtype)``);
* ``nn.LayerNorm`` (flax's, which has no dtype field) normalises in float32
  and returns float32, the promotion of its input and its f32 parameters;
* the multi-head attention casts its input and parameters to the dtype;
* BatchNorm needs nothing: ``layers.BatchNorm1d/2d`` take a bf16 input
  with their f32 parameters and statistics (statistics and normalisation
  in f32, the result rounded to bf16, running statistics f32);
* the parts a model lists in ``COMPUTE_F32_PARTS`` (GCRN's grouped LSTM,
  DB-AIAT's GRUs and AHAM conv, the DiffUNet family's time embedding: no
  dtype field in JAX) compute in float32 on the unrounded weights, their
  conv and linear layers casting their input up.

This is not the bf16 *serving* copy (``serving/enhancer.py::serving_copy``),
which casts every variable of a copy to bf16 and so runs, for example,
GCRN's LSTM on bf16-rounded weights and DB-AIAT's ``linear2`` in f32.  The
view shares the module's parameters and buffers, so there is one set of
f32 parameters, the optimizer's, and train-mode BatchNorm moves the
module's own running statistics.  No ``torch.autocast``: its op lists are
torch's policy, not JAX's (it fuses the bias into the product and keeps
softmax and layer norms in f32).
"""

from __future__ import annotations

import copy

import torch
import torch.nn as nn
import torch.nn.functional as F

from prior_diffuse_tpu_torch.models import layers as tl

_PRODUCTS = (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d, nn.Linear)


def compute_dtype(name: str) -> torch.dtype:
    """``train.compute_dtype`` of a config as a torch dtype: ``"bfloat16"``
    or ``"bf16"`` train in bf16 compute, any other value in float32 (the
    JAX trainers' ``cdt``, ``ddpm_trainer.py:122-123``)."""
    return torch.bfloat16 if name in ("bfloat16", "bf16") else torch.float32


class _Product(nn.Module):
    """A conv or linear layer computed in ``dtype``: input, weight and bias
    cast to it, the product rounded before the bias is added (flax's
    ``Conv`` / ``Dense`` with ``dtype``)."""

    def __init__(self, layer: nn.Module, dtype: torch.dtype):
        super().__init__()
        self.layer = layer
        self.dtype = dtype

    @property
    def weight(self):
        return self.layer.weight

    @property
    def bias(self):
        return self.layer.bias

    def forward(self, x):
        m, dt = self.layer, self.dtype
        if dt == torch.float32:  # a float32 part: the input promoted, the layer as it is
            return m(x.float())
        x, w = x.to(dt), m.weight.to(dt)
        if isinstance(m, nn.Linear):
            y = F.linear(x, w)
        elif isinstance(m, nn.ConvTranspose2d):
            y = F.conv_transpose2d(x, w, None, m.stride, m.padding, m.output_padding,
                                   m.groups, m.dilation)
        else:
            y = m._conv_forward(x, w, None)
        if m.bias is None:
            return y
        b = m.bias.to(dt)
        return y + (b if isinstance(m, nn.Linear) else b.view(-1, *(1,) * (y.ndim - 2)))


class _PReLU(nn.Module):
    """``nn.PReLU`` with its slope cast to the input's dtype."""

    def __init__(self, layer: nn.PReLU):
        super().__init__()
        self.layer = layer

    @property
    def weight(self):
        return self.layer.weight

    def forward(self, x):
        return F.prelu(x, self.layer.weight.to(x.dtype))


class _LayerNorm(nn.Module):
    """``nn.LayerNorm`` in float32 on its f32 parameters, returning float32
    whatever the input's dtype (flax's ``LayerNorm`` without a dtype)."""

    def __init__(self, layer: nn.LayerNorm):
        super().__init__()
        self.layer = layer

    def forward(self, x):
        m = self.layer
        return F.layer_norm(x.float(), m.normalized_shape, m.weight, m.bias, m.eps)


class _Attention(nn.Module):
    """``layers.MultiHeadAttention`` with its input and parameters cast to
    ``dtype`` (the JAX module's ``dtype``)."""

    def __init__(self, layer: tl.MultiHeadAttention, dtype: torch.dtype):
        super().__init__()
        self.layer = layer
        self.dtype = dtype

    def forward(self, x):
        m, dt = self.layer, self.dtype
        return tl.attention(x.to(dt), m.in_proj_weight.to(dt), m.in_proj_bias.to(dt),
                            m.out_proj_weight.to(dt), m.out_proj_bias.to(dt), m.num_heads)


def _wrapped(module: nn.Module, dtype: torch.dtype):
    if isinstance(module, _PRODUCTS):
        return _Product(module, dtype)
    if isinstance(module, nn.PReLU):
        return _PReLU(module)
    if isinstance(module, nn.LayerNorm):
        return _LayerNorm(module)
    if isinstance(module, tl.MultiHeadAttention):
        return _Attention(module, dtype)
    return None


def _wrap_children(module: nn.Module, dtype: torch.dtype) -> None:
    f32 = getattr(module, "COMPUTE_F32_PARTS", ())
    for name, child in list(module.named_children()):
        dt = torch.float32 if name in f32 else dtype
        wrapped = _wrapped(child, dt)
        if wrapped is None:
            _wrap_children(child, dt)
        else:
            setattr(module, name, wrapped)


def compute_view(net: nn.Module, dtype: torch.dtype) -> nn.Module:
    """``net`` computed in ``dtype`` on its own float32 parameters, as the
    JAX package computes a model of ``dtype=bfloat16`` (module docstring):
    the net itself in float32, else a structural copy that *shares* every
    parameter and buffer of ``net`` (gradients reach ``net``'s parameters,
    train-mode BatchNorm moves ``net``'s statistics) with its layers
    wrapped (a wrapped layer still shows its ``weight`` and ``bias``).
    Build it once per net; set its mode with its own ``train()`` /
    ``eval()``."""
    if dtype == torch.float32:
        return net
    if dtype != torch.bfloat16:
        raise ValueError(f"the port computes in float32 or bfloat16, not {dtype}")
    shared = {id(t): t for t in [*net.parameters(), *net.buffers()]}
    view = copy.deepcopy(net, shared)
    _wrap_children(view, dtype)
    return view
