"""K3: the fused inference encoder stage of the DiffUNet family.

Kernels: ``csrc/enc_chain.cu`` (float32) and ``csrc/enc_chain_bf16.cu``
(bfloat16).  Plain version of both: :func:`enc_stage_plain`.  The wrappers
:func:`enc_stage` and :func:`enc_stage_bf16` count their launches in
``enc_stage.launches`` and ``enc_stage_bf16.launches``.

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

A chain in bfloat16 (``pack_encoder(..., dtype=torch.bfloat16)``) is
packed in float32 and cast last, as the JAX package packs from its f32
state and casts at use: ``wmain``, ``wg``, ``w2``, the stage-2..5
``conv1`` weight, ``wcsum`` and the time projection's weight become
bfloat16; the biases and ``alpha`` stay float32.  Its rounding points are
``_chain_kernel``'s at ``dtype=bfloat16``: bf16 operands, f32 sums, ``y``
kept in f32 for the cross gate, a bf16 output.
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
_PRODUCT_WEIGHTS = ("wmain", "wg", "w2")  # in the chain's dtype; the rest f32


def _check_weights(ops: dict, c: int) -> None:
    """K3 takes the weight operands contiguous, of their shapes, on one
    device, wmain, wg and w2 in the chain's dtype and 16-byte aligned, the
    biases and alpha float32; checked where they are packed, so a launch
    only checks their device."""
    shapes = ((2 * ops["kernel_f"] * c, COUT), (COUT, COUT), (COUT,), (G, COUT),
              (COUT,), (1,))
    dt = ops["wmain"].dtype
    for name, shape in zip(_WEIGHTS, shapes):
        check_operand(name, ops[name], ops["wmain"].device, shape,
                      dt if name in _PRODUCT_WEIGHTS else torch.float32)
    if any(ops[n].data_ptr() % 16 for n in _PRODUCT_WEIGHTS):
        raise ValueError("enc_stage kernel takes wmain, wg and w2 16-byte aligned")


@torch.no_grad()
def cast_stage(ops: dict, dtype: torch.dtype) -> dict:
    """The operands of a float32-packed stage for a chain in ``dtype``: the
    product weights (``wmain``, ``wg``, ``w2``, ``conv1``'s weight,
    ``wcsum``) cast, the biases and ``alpha`` left float32."""
    if dtype == torch.float32:
        return ops
    out = dict(ops)
    for name in _PRODUCT_WEIGHTS:
        out[name] = ops[name].to(dtype).contiguous()
    if ops["pre"] is not None:
        out["pre"] = (ops["pre"][0].to(dtype), ops["pre"][1])
    if ops["wcsum"] is not None:
        out["wcsum"] = ops["wcsum"].to(dtype)
    _check_weights(out, ops["wmain"].shape[0] // (2 * ops["kernel_f"]))
    return out


def pack_encoder(encoder, dtype: torch.dtype = torch.float32
                 ) -> List[Tuple[dict, Optional[Tuple[torch.Tensor, torch.Tensor]]]]:
    """``[(stage operands, time projection (weight [Cin, 512], bias) or
    None)]`` for the five stages of an ``Encoder`` module, for a chain in
    ``dtype`` (float32 or bfloat16; the projection's weight in ``dtype``)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"K3 runs in float32 or bfloat16, not {dtype}")
    packed = []
    for i, kf in enumerate(ENC_KERNELS, start=1):
        ops = cast_stage(pack_stage(getattr(encoder, f"conv{i}"), getattr(encoder, f"bn{i}"),
                                    getattr(encoder, f"prelu{i}"), kf), dtype)
        tp = getattr(encoder, f"tp{i}", None)
        if tp is not None:
            with torch.no_grad():
                tp = (tp.weight if dtype == torch.float32 else tp.weight.to(dtype), tp.bias)
        packed.append((ops, tp))
    return packed


def _out_shape(x: torch.Tensor, kernel_f: int, pad: int):
    b, tin, f, _ = x.shape
    return b, tin - 1 + pad, (f - kernel_f) // 2 + 1


def enc_stage_plain(x: torch.Tensor, ops: dict, bias_b: torch.Tensor,
                    pad: int) -> torch.Tensor:
    """Explicit im2col and the product chain (the math of ``encoder_xla``).

    ``x [B, Tin, F, C]``: the stage input, with ``pad = 1`` one zero frame
    is prepended (causal pad), with ``pad = 0`` it already holds the pad
    frame.  ``bias_b [B, 64]`` float32.  Returns ``[B, Tin - 1 + pad, Fo,
    64]`` in ``x``'s dtype.  In bfloat16 the chain is ``_chain_kernel``'s:
    each product takes bf16 operands and sums in f32 (here: the bf16
    values widened, then an f32 product), ``y`` stays f32 for the cross
    gate and only the gate product's operand is rounded, PReLU in f32, the
    output rounded once."""
    k = ops["kernel_f"]
    dt = x.dtype
    b, t, fo = _out_shape(x, k, pad)
    xp = F.pad(x, (0, 0, 0, 0, pad, 0))
    cols = [xp[:, kt:kt + t, kf:kf + 2 * (fo - 1) + 1:2, :]
            for kt in range(2) for kf in range(k)]
    col = torch.cat(cols, dim=-1)  # [B, T, Fo, K], (kt, kf, c) order
    y = torch.matmul(col.float(), ops["wmain"].float()) + bias_b[:, None, None, :]
    m = torch.matmul(y.to(dt).float(), ops["wg"].float()) + ops["bg"]
    comb = (y[..., :G] * torch.sigmoid(m[..., G:])
            + y[..., G:] * torch.sigmoid(m[..., :G]))
    y2 = torch.matmul(comb.to(dt).float(), ops["w2"].float()) + ops["b2"]
    return torch.where(y2 >= 0, y2, ops["alpha"] * y2).to(dt)


WARPS = 16           # K3's warps per block
TILE_ROWS = 16 * WARPS  # rows of a tile at most: one 16-row m-tile a warp
SMEM_MAX = 232_448   # dynamic shared memory a block may use (227 KB)
GEOMETRIES = ((2, 5), (32, 3))  # (input channels, frequency taps) K3 takes


def channel_stride(c: int, elem: int) -> int:
    """Elements a pixel takes in K3's staged input tile: float32 pads C = 2
    to 4 (one float2 a k pair) and C = 32 to 36; bfloat16 keeps C = 2 (one
    32-bit word) and pads C = 32 to 40 (80-byte pixels: the 8 rows of an
    A fragment fall on 8 distinct 4-bank groups)."""
    if elem == 4:
        return 4 if c == 2 else c + 4
    return 2 if c == 2 else c + 8


def smem_bytes(c: int, kf: int, f: int, tt: int, elem: int = 4) -> int:
    """K3's dynamic shared memory for a tile of ``tt`` output frames, for
    ``elem``-byte operands (4: float32, 2: bfloat16): the weights in
    fragment order (window, two gate blocks, W2), the k-offset table, and
    the ``tt + 1`` input frames ``[F, CS]`` (:func:`channel_stride`).
    float32: m16n8k8 steps, each lane's fragment split into hi and lo (16
    bytes); bfloat16: m16n8k16 steps, 8 bytes a lane's fragment."""
    cs = channel_stride(c, elem)
    if elem == 4:
        k8 = _ceil(2 * kf * c, 8)
        return 16 * 32 * (8 * k8 + 2 * 4 * 4 + 4 * 8) + 4 * 4 * k8 + 4 * (tt + 1) * f * cs
    k16 = _ceil(2 * kf * c, 16)
    return 8 * 32 * (8 * k16 + 2 * 2 * 4 + 2 * 8) + 4 * 8 * k16 + 2 * (tt + 1) * f * cs


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
def tile_plan(b: int, t: int, f: int, c: int, kf: int, n_sm: int,
              elem: int = 4) -> TilePlan:
    """The tile for ``b`` utterances of ``t`` output frames (``elem``-byte
    operands): a tile of at most ``TILE_ROWS`` rows costs every warp at
    most one m-tile, so the makespan is the ``ceil(tiles / blocks)`` tiles
    each of the ``min(tiles, n_sm)`` blocks walks; the smallest tile of
    least makespan is taken (less to copy in a tile, more blocks at work)."""
    fo = (f - kf) // 2 + 1
    best = None
    for tt in range(1, min(t, TILE_ROWS // fo) + 1):
        smem = smem_bytes(c, kf, f, tt, elem)
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


def _launch(entry: str, x: torch.Tensor, ops: dict, bias_b: torch.Tensor,
            pad: int) -> torch.Tensor:
    """Check a stage for K3 in ``x``'s dtype and launch it through the C
    entry point ``entry``."""
    dt = x.dtype
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
    check_operand("x", x, dev, dtype=dt)
    check_operand("bias_b", bias_b, dev, (b, COUT))
    if t < 1 or fo < 1:
        raise ValueError(f"stage input {tuple(x.shape)} gives no output rows")
    if x.data_ptr() % 16:
        raise ValueError("enc_stage kernel takes x 16-byte aligned")
    if (ops["wmain"].device != dev or ops["wmain"].dtype != dt
            or ops["wmain"].shape[0] != 2 * k * cin):
        raise ValueError(f"stage operands {ops['wmain'].dtype} on {ops['wmain'].device} "
                         f"with K = {ops['wmain'].shape[0]} for a {dt} input on {dev} "
                         f"with C = {cin}")
    out = torch.empty((b, t, fo, COUT), dtype=dt, device=dev)
    if b:
        plan = tile_plan(b, t, x.shape[2], cin, k, _sm_count(dev.index), x.element_size())
        with on_device(dev):
            err = getattr(build.library(), entry)(
                x.data_ptr(), bias_b.data_ptr(), *(ops[n].data_ptr() for n in _WEIGHTS),
                out.data_ptr(), b,
                x.shape[1], x.shape[2], cin, k, pad, plan.tt, plan.grid, plan.smem,
                stream(dev))
        build.check(err, "encoder stage kernel")
    return out


def enc_stage(x: torch.Tensor, ops: dict, bias_b: torch.Tensor,
              pad: int) -> torch.Tensor:
    """One fused encoder stage in float32 (K3 on CUDA); contract of
    :func:`enc_stage_plain`."""
    if not on_cuda(x):
        return enc_stage_plain(x, ops, bias_b, pad)
    if x.dtype != torch.float32:
        raise ValueError(f"enc_stage takes float32, got {x.dtype}")
    out = _launch("pdt_enc_stage_f32", x, ops, bias_b, pad)
    if x.shape[0]:
        enc_stage.launches += 1
    return out


def enc_stage_bf16(x: torch.Tensor, ops: dict, bias_b: torch.Tensor,
                   pad: int) -> torch.Tensor:
    """One fused encoder stage in bfloat16 (K3-bf16 on CUDA); contract of
    :func:`enc_stage_plain`."""
    if not on_cuda(x):
        return enc_stage_plain(x, ops, bias_b, pad)
    if x.dtype != torch.bfloat16:
        raise ValueError(f"enc_stage_bf16 takes bfloat16, got {x.dtype}")
    out = _launch("pdt_enc_stage_bf16", x, ops, bias_b, pad)
    if x.shape[0]:
        enc_stage_bf16.launches += 1
    return out


enc_stage.launches = 0
enc_stage_bf16.launches = 0


def _product_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` as float32: in float32 the product; in bfloat16 (both
    operands) the product rounded to bfloat16, then widened (JAX's einsum
    without a preferred type)."""
    return torch.matmul(a, w).float()


def stage_inputs(x: torch.Tensor, ops: dict, tp, temb: Optional[torch.Tensor]):
    """``(xin, bias_b, pad)`` for the stage kernel from a stage input
    ``x [B, T, F, Cin]`` (float32 or bfloat16, as the stage's operands):
    the time projection folds into the per-batch bias (through ``wcsum``,
    or through ``conv1``), and for stages 2..5 the separate ``conv1`` runs
    on the causally padded input.  In bfloat16 the rounding points are
    ``encoder_pallas`` / ``fused_enc_stage``'s: ``tproj`` = bf16(temb @ W)
    + b, cast to bf16; the projection's bias term bf16(tproj @ W) widened
    and added to the f32 bias; ``conv1`` = bf16(bf16(x @ W1) + bias1)."""
    b = x.shape[0]
    dt = x.dtype
    tproj = None
    if tp is not None and temb is not None:
        w, bias = tp
        tproj = (_product_f32(temb.to(dt), w.t()) + bias).to(dt)
    bias_b = ops["bmain"].expand(b, COUT)
    if ops["pre"] is None:
        if tproj is not None:
            bias_b = bias_b + _product_f32(tproj, ops["wcsum"])
        return x.contiguous(), bias_b.contiguous(), 1
    w1, b1 = ops["pre"]
    bias1 = b1.expand(b, G) if tproj is None else b1 + _product_f32(tproj, w1)
    _, t, f, _ = x.shape
    xin = x.new_empty((b, t + 1, f, G))
    xin[:, 0] = bias1[:, None, :]  # conv1 of the zero pad frame
    xin[:, 1:] = _product_f32(x, w1) + bias1[:, None, None, :]
    return xin, bias_b.contiguous(), 0


def encoder_fused(x: torch.Tensor, packed, temb: Optional[torch.Tensor] = None):
    """Five encoder stages on ``x [B, T, 161, Cin]`` (channels-last) ->
    ``(x [B, T, 4, 64], skips)`` in the packed operands' dtype; ``temb [B,
    512]`` for time-conditioned encoders.  The stage-2..5 ``conv1`` and the
    time projections are plain products; each stage's window chain is
    :func:`enc_stage` (float32) or :func:`enc_stage_bf16`."""
    skips = []
    for ops, tp in packed:
        stage = enc_stage if ops["wmain"].dtype == torch.float32 else enc_stage_bf16
        xin, bias_b, pad = stage_inputs(x, ops, tp, temb)
        x = stage(xin, ops, bias_b, pad)
        skips.append(x)
    return x, skips
