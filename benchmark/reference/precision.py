"""The reference's precisions: float32 as stated, and the controls below it.

``float32`` turns TF32 off for cuBLAS and cuDNN: float32 means float32.
The controls are the reference computed one precision below what a
configuration states, the step a later change to the program might take:

* ``tf32`` (below float32 with TF32 off): TF32 on for every product and
  convolution;
* ``fp8`` (below bfloat16): computed in float8 e4m3 with per-tensor
  scales (largest magnitude to 448): every convolution's and linear
  layer's input and weight, every layer's output and the reverse chain's
  state rounded to e4m3, the products accumulated in float32.
"""

from __future__ import annotations

import contextlib
import copy

import torch
import torch.nn as nn

E4M3_MAX = 448.0
_PRODUCTS = (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d, nn.Linear)


@contextlib.contextmanager
def tf32(on: bool):
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def to_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with a per-tensor scale, back in its dtype."""
    scale = torch.clamp(x.detach().abs().amax().float(), min=1e-30) / E4M3_MAX
    return ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)


def _round_input(module, args):
    return (to_e4m3(args[0]), *args[1:])


def _round_output(module, args, out):
    return to_e4m3(out) if isinstance(out, torch.Tensor) and out.is_floating_point() else out


def fp8_copy(net: nn.Module) -> nn.Module:
    """A copy of ``net`` computed in e4m3: its products' inputs and
    weights and every leaf layer's output rounded."""
    out = copy.deepcopy(net)
    with torch.no_grad():
        for m in out.modules():
            if isinstance(m, _PRODUCTS):
                m.weight.copy_(to_e4m3(m.weight))
                m.register_forward_pre_hook(_round_input)
            if not list(m.children()):
                m.register_forward_hook(_round_output)
    return out


def state_rounding(precision: str):
    """How the reverse chain's state is kept: as it is, or (``fp8``)
    rounded to e4m3 after every step."""
    return to_e4m3 if precision == "fp8" else (lambda x: x)


@contextlib.contextmanager
def computed_in(precision: str):
    """The context a reference forward runs in: ``float32`` or ``tf32``
    (``fp8`` acts on the nets, :func:`fp8_copy`, under float32)."""
    if precision not in ("float32", "tf32", "fp8"):
        raise ValueError(f"unknown reference precision {precision!r}")
    with tf32(precision == "tf32"):
        yield
