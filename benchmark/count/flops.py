"""Model FLOPs of a PyTorch function, counted under a dispatch mode.

The per-op arithmetic of the port's static roofline, frozen here so that
later changes to the program cannot move the yardstick: a product
``[.., M, K] @ [.., K, N]`` is ``M K N`` multiply-adds (times its batch), a
convolution ``taps x Cin / groups`` for each output element and output
channel, its backward the forward's count for each gradient its
``output_mask`` asks for, and a recurrence its input projection plus one
hidden-state product a time step.  Everything else counts no FLOPs.

The benchmark runs the reference (``benchmark/reference``), not the
program, under this mode, on the ``meta`` device: the count is the work of
the published computation at the cell's shapes, whichever kernels the
program uses for it, and no device memory is touched.
"""

from __future__ import annotations

import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# NVIDIA's data sheet for the H100 SXM (dense rates, 700 W): the bf16 peak
# that ``mfu`` divides by, the TF32 peak (float32 products at 3xTF32 run at
# a third of it), the HBM rate.
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_3XTF32 = PEAK_TF32 / 3.0
HBM_BYTES_PER_S = 3.35e12


def _dot(a, b) -> float:
    bsz = a.shape[0] if a.ndim == 3 else 1
    return float(bsz * a.shape[-2] * a.shape[-1] * b.shape[-1])


def _conv(x, w, y, transposed: bool, groups: int) -> float:
    taps = math.prod(w.shape[2:])
    if transposed:  # w [Cin, Cout / g, *taps]: each input pixel scatters
        return float(x.shape[0] * math.prod(x.shape[2:]) * w.shape[0] * taps * w.shape[1])
    return float(y.shape[0] * math.prod(y.shape[2:]) * w.shape[0] * taps * w.shape[1])


def _conv_backward(a) -> float:
    fwd = _conv(a["input"], a["weight"], a["grad_output"], a["transposed"], a["groups"])
    return fwd * (int(a["output_mask"][0]) + int(a["output_mask"][1]))


def _rnn(x, pairs, batch_first: bool, backward: bool = False, dgrad_in: bool = False,
         wgrad: bool = False) -> float:
    t, n = (x.shape[1], x.shape[0]) if batch_first else (x.shape[0], x.shape[1])
    macs = 0.0
    for w_ih, w_hh in pairs:
        gh, i = w_ih.shape
        h = w_hh.shape[1]
        if not backward:
            macs += t * n * gh * i + t * n * gh * h
        else:
            macs += t * n * h * gh + (t * n * i * gh if dgrad_in else 0) + (
                gh * (i + h) * t * n if wgrad else 0)
    return float(macs)


def _pairs(flat, step):
    return [(flat[i], flat[i + 1]) for i in range(0, len(flat), step)]


_aten = torch.ops.aten
_MACS = {
    _aten.mm: lambda a: _dot(a["self"], a["mat2"]),
    _aten.bmm: lambda a: _dot(a["self"], a["mat2"]),
    _aten.addmm: lambda a: _dot(a["mat1"], a["mat2"]),
    _aten.baddbmm: lambda a: _dot(a["batch1"], a["batch2"]),
    _aten.convolution: lambda a: _conv(a["input"], a["weight"], a["_out"], a["transposed"],
                                       a["groups"]),
    _aten.convolution_backward: _conv_backward,
    _aten._cudnn_rnn: lambda a: _rnn(a["input"], _pairs(a["weight"], a["weight_stride0"]),
                                     a["batch_first"]),
    _aten._cudnn_rnn_backward: lambda a: _rnn(
        a["input"], _pairs(a["weight"], a["weight_stride0"]), a["batch_first"], True,
        a["output_mask"][0], a["output_mask"][3]),
    _aten.mkldnn_rnn_layer: lambda a: _rnn(a["input"], [(a["weight0"], a["weight1"])],
                                           a["batch_first"]),
    _aten.mkldnn_rnn_layer_backward: lambda a: _rnn(
        a["input"], [(a["weight1"], a["weight2"])], a["batch_first"], True, True, True),
}


class FlopCount(TorchDispatchMode):
    """``with FlopCount() as c: fn()``; then ``c.flops`` (2 x MACs)."""

    def __init__(self):
        super().__init__()
        self.macs = 0.0

    @property
    def flops(self) -> float:
        return 2.0 * self.macs

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        rule = _MACS.get(func.overloadpacket)
        if rule is not None:
            named = {s.name: v for s, v in zip(func._schema.arguments, args)}
            self.macs += rule({**named, **kwargs, "_out": out})
        return out


def flops_of(fn, *args, **kwargs) -> float:
    """The model FLOPs of one call of ``fn``."""
    with FlopCount() as count:
        fn(*args, **kwargs)
    return count.flops
