"""K3: the fused inference encoder stage of the DiffUNet family.

Kernel: ``csrc/enc_chain.cu``.  Plain version: :func:`enc_stage_plain`.
The wrapper :func:`enc_stage` counts its launches in ``enc_stage.launches``.

Packing (:func:`pack_stage`, :func:`pack_encoder`) turns one ``Encoder``
stage of the port's own modules (``models/diffunet.py``) into the
operands of the matmul-chain formulation of
``prior_diffuse_tpu/ops/pallas/convblock_kernel.py::encoder_stage_params``:

* stage 1 (Cin = 2 < 32): the 1x1 ``conv1`` is composed into the window
  weight (K = 2*5*2 = 20) and the time projection folds into the
  per-batch bias through ``wcsum``;
* stages 2-5 (Cin = 64): ``conv1`` stays a separate product
  (:func:`stage_inputs`), applied to the causally padded input, so its
  pad row is the per-batch bias row; K = 2*3*32 = 192;
* the two 1x1 gate convs form one block-diagonal ``[64, 64]`` weight;
* inference BatchNorm (eps 1e-5) folds into ``conv2``; PReLU's single
  slope is ``alpha``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from prior_diffuse_tpu_torch.ops import build
from prior_diffuse_tpu_torch.ops.cuda._launch import (check_operand, on_cuda,
                                                      on_device, stream)

G = 32      # BiConvGLU gate width
COUT = 64   # encoder stage output channels
ENC_KERNELS = (5, 3, 3, 3, 3)  # frequency taps per stage


def _w2d(conv) -> torch.Tensor:
    """1x1 Conv2d weight ``[out, in, 1, 1]`` -> matrix ``[in, out]``."""
    return conv.weight[:, :, 0, 0].t()


@torch.no_grad()
def pack_stage(glu, bn, prelu, kernel_f: int) -> dict:
    """Operands of one stage from its ``BiConvGLU``, ``BatchNorm2d`` and
    ``PReLU`` modules (float32, on their device)."""
    w1, b1 = _w2d(glu.conv1), glu.conv1.bias
    cin = w1.shape[0]
    # l/r window weights [out, in, 2, k] -> [2, k, in, 64] (taps, then channel)
    wp = torch.cat([glu.l.weight, glu.r.weight], dim=0).permute(2, 3, 1, 0)
    bp = torch.cat([glu.l.bias, glu.r.bias])
    ops = {"kernel_f": kernel_f}
    if cin < G:
        wc = torch.einsum("cg,tkgo->tkco", w1, wp)
        ops["pre"] = None
        ops["wmain"] = wc.reshape(2 * kernel_f * cin, 2 * G).contiguous()
        ops["bmain"] = bp + torch.einsum("g,tkgo->o", b1, wp)
        ops["wcsum"] = wc.sum(dim=(0, 1))
    else:
        ops["pre"] = (w1.contiguous(), b1.clone())
        ops["wmain"] = wp.reshape(2 * kernel_f * G, 2 * G).contiguous()
        ops["bmain"] = bp
        ops["wcsum"] = None
    wg = w1.new_zeros((2 * G, 2 * G))
    wg[:G, :G] = _w2d(glu.l_conv)
    wg[G:, G:] = _w2d(glu.r_conv)
    ops["wg"] = wg
    ops["bg"] = torch.cat([glu.l_conv.bias, glu.r_conv.bias])
    scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    ops["w2"] = (_w2d(glu.conv2) * scale[None, :]).contiguous()
    ops["b2"] = glu.conv2.bias * scale + bn.bias - bn.running_mean * scale
    ops["alpha"] = prelu.weight.reshape(1).clone()
    _check_weights(ops, min(cin, G))
    return ops


_WEIGHTS = ("wmain", "wg", "bg", "w2", "b2", "alpha")


def _check_weights(ops: dict, c: int) -> None:
    """K3 takes the weight operands float32, contiguous, of their shapes, on
    one device, and wmain, wg and w2 16-byte aligned; checked where they
    are packed, so a launch only checks their device."""
    shapes = ((2 * ops["kernel_f"] * c, COUT), (COUT, COUT), (COUT,), (G, COUT),
              (COUT,), (1,))
    for name, shape in zip(_WEIGHTS, shapes):
        check_operand(name, ops[name], ops["wmain"].device, shape)
    if any(ops[n].data_ptr() % 16 for n in ("wmain", "wg", "w2")):
        raise ValueError("enc_stage kernel takes wmain, wg and w2 16-byte aligned")


def pack_encoder(encoder) -> List[Tuple[dict, Optional[torch.nn.Linear]]]:
    """``[(stage operands, time projection Linear or None)]`` for the five
    stages of an ``Encoder`` module."""
    return [(pack_stage(getattr(encoder, f"conv{i}"), getattr(encoder, f"bn{i}"),
                        getattr(encoder, f"prelu{i}"), kf),
             getattr(encoder, f"tp{i}", None))
            for i, kf in enumerate(ENC_KERNELS, start=1)]


def _out_shape(x: torch.Tensor, kernel_f: int, pad: int):
    b, tin, f, _ = x.shape
    return b, tin - 1 + pad, (f - kernel_f) // 2 + 1


def enc_stage_plain(x: torch.Tensor, ops: dict, bias_b: torch.Tensor,
                    pad: int) -> torch.Tensor:
    """Explicit im2col and the product chain (the math of ``encoder_xla``).

    ``x [B, Tin, F, C]``: the stage input, with ``pad = 1`` one zero frame
    is prepended (causal pad), with ``pad = 0`` it already holds the pad
    frame.  ``bias_b [B, 64]``.  Returns ``[B, Tin - 1 + pad, Fo, 64]``."""
    k = ops["kernel_f"]
    b, t, fo = _out_shape(x, k, pad)
    xp = F.pad(x, (0, 0, 0, 0, pad, 0))
    cols = [xp[:, kt:kt + t, kf:kf + 2 * (fo - 1) + 1:2, :]
            for kt in range(2) for kf in range(k)]
    col = torch.cat(cols, dim=-1)  # [B, T, Fo, K], (kt, kf, c) order
    y = torch.matmul(col, ops["wmain"]) + bias_b[:, None, None, :]
    m = torch.matmul(y, ops["wg"]) + ops["bg"]
    comb = (y[..., :G] * torch.sigmoid(m[..., G:])
            + y[..., G:] * torch.sigmoid(m[..., :G]))
    y2 = torch.matmul(comb, ops["w2"]) + ops["b2"]
    return torch.where(y2 >= 0, y2, ops["alpha"] * y2)


WARPS = 16           # K3's warps per block
TILE_ROWS = 16 * WARPS  # rows of a tile at most: one 16-row m-tile a warp
SMEM_MAX = 232_448   # dynamic shared memory a block may use (227 KB)
GEOMETRIES = ((2, 5), (32, 3))  # (input channels, frequency taps) K3 takes


def smem_bytes(c: int, kf: int, f: int, tt: int) -> int:
    """K3's dynamic shared memory for a tile of ``tt`` output frames: the
    weights split into hi and lo in fragment order (window, two gate blocks,
    W2; 16 bytes a lane's fragment), the k-offset table, and the ``tt + 1``
    input frames ``[F, CS]`` (channel stride ``CS`` = 4 for C = 2, C + 4
    else)."""
    k8 = _ceil(2 * kf * c, 8)
    cs = 4 if c == 2 else c + 4
    return 16 * 32 * (8 * k8 + 2 * 4 * 4 + 4 * 8) + 4 * 4 * k8 + 4 * (tt + 1) * f * cs


@dataclass(frozen=True)
class TilePlan:
    """How K3 cuts a stage: ``tt`` output frames per tile, ``tiles`` tiles
    (``tiles // b`` per utterance, the last one partial when ``tt`` does not
    divide T), ``grid`` persistent blocks walking them, ``smem`` bytes each."""
    tt: int
    tiles: int
    grid: int
    smem: int


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def tile_plan(b: int, t: int, f: int, c: int, kf: int, n_sm: int) -> TilePlan:
    """The tile for ``b`` utterances of ``t`` output frames: a tile of at
    most ``TILE_ROWS`` rows costs every warp at most one m-tile,
    so the makespan is the ``ceil(tiles / blocks)`` tiles each of the
    ``min(tiles, n_sm)`` blocks walks; the smallest tile of least makespan
    is taken (less to copy in a tile, more blocks at work)."""
    fo = (f - kf) // 2 + 1
    best = None
    for tt in range(1, min(t, TILE_ROWS // fo) + 1):
        smem = smem_bytes(c, kf, f, tt)
        if smem > SMEM_MAX:
            break
        tiles = b * _ceil(t, tt)
        grid = min(tiles, n_sm)
        span = _ceil(tiles, grid)
        if best is None or span < best[0]:
            best = (span, TilePlan(tt, tiles, grid, smem))
    if best is None:
        raise ValueError(f"no K3 tile fits at F = {f}, C = {c}, kernel_f = {kf}")
    return best[1]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def enc_stage(x: torch.Tensor, ops: dict, bias_b: torch.Tensor,
              pad: int) -> torch.Tensor:
    """One fused encoder stage (K3 on CUDA); contract of :func:`enc_stage_plain`."""
    if not on_cuda(x):
        return enc_stage_plain(x, ops, bias_b, pad)
    if x.ndim != 4 or pad not in (0, 1):
        raise ValueError(f"enc_stage takes [B, Tin, F, C] and pad 0/1, got "
                         f"{tuple(x.shape)}, pad={pad}")
    k = ops["kernel_f"]
    b, t, fo = _out_shape(x, k, pad)
    cin = x.shape[-1]
    if (cin, k) not in GEOMETRIES:
        raise ValueError(f"enc_stage kernel takes (C, kernel_f) in {GEOMETRIES}, "
                         f"got {(cin, k)}")
    dev = x.device
    check_operand("x", x, dev)
    check_operand("bias_b", bias_b, dev, (b, COUT))
    if t < 1 or fo < 1:
        raise ValueError(f"stage input {tuple(x.shape)} gives no output rows")
    if x.data_ptr() % 16:
        raise ValueError("enc_stage kernel takes x 16-byte aligned")
    if ops["wmain"].device != dev or ops["wmain"].shape[0] != 2 * k * cin:
        raise ValueError(f"stage operands on {ops['wmain'].device} with K = "
                         f"{ops['wmain'].shape[0]} for an input on {dev} with C = {cin}")
    out = torch.empty((b, t, fo, COUT), dtype=torch.float32, device=dev)
    if b:
        plan = tile_plan(b, t, x.shape[2], cin, k, _sm_count(dev.index))
        with on_device(dev):
            err = build.library().pdt_enc_stage_f32(
                x.data_ptr(), bias_b.data_ptr(), *(ops[n].data_ptr() for n in _WEIGHTS),
                out.data_ptr(), b,
                x.shape[1], x.shape[2], cin, k, pad, plan.tt, plan.grid, plan.smem,
                stream(dev))
        build.check(err, "encoder stage kernel")
        enc_stage.launches += 1
    return out


enc_stage.launches = 0


def stage_inputs(x: torch.Tensor, ops: dict, tp, temb: Optional[torch.Tensor]):
    """``(xin, bias_b, pad)`` for :func:`enc_stage` from a stage input
    ``x [B, T, F, Cin]``: the time projection folds into the per-batch
    bias (through ``wcsum``, or through ``conv1``), and for stages 2..5 the
    separate ``conv1`` runs on the causally padded input."""
    b = x.shape[0]
    tproj = F.linear(temb, tp.weight, tp.bias) if (
        tp is not None and temb is not None) else None
    bias_b = ops["bmain"].expand(b, COUT)
    if ops["pre"] is None:
        if tproj is not None:
            bias_b = bias_b + tproj @ ops["wcsum"]
        return x.contiguous(), bias_b.contiguous(), 1
    w1, b1 = ops["pre"]
    bias1 = b1.expand(b, G) if tproj is None else b1 + tproj @ w1
    _, t, f, _ = x.shape
    xin = x.new_empty((b, t + 1, f, G))
    xin[:, 0] = bias1[:, None, :]  # conv1 of the zero pad frame
    xin[:, 1:] = torch.matmul(x, w1) + bias1[:, None, None, :]
    return xin, bias_b.contiguous(), 0


def encoder_fused(x: torch.Tensor, packed, temb: Optional[torch.Tensor] = None):
    """Five encoder stages on ``x [B, T, 161, Cin]`` (channels-last) ->
    ``(x [B, T, 4, 64], skips)``; ``temb [B, 512]`` for time-conditioned
    encoders.  The stage-2..5 ``conv1`` and the time projections are plain
    products; each stage's window chain is :func:`enc_stage`."""
    skips = []
    for ops, tp in packed:
        xin, bias_b, pad = stage_inputs(x, ops, tp, temb)
        x = enc_stage(xin, ops, bias_b, pad)
        skips.append(x)
    return x, skips
