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
``fused_enc_stage``'s at ``dtype=bfloat16``: bf16 operands, f32 sums,
``conv1`` = bf16(bf16(x @ W1) + bias1), ``y`` kept in f32 for the cross
gate, a bf16 output.  K3-bf16 (:func:`enc_stage_bf16`) takes a stage's
input as it is, ``conv1`` included (its plain version:
:func:`enc_stage_bf16_plain`); its product weights go to the kernel as
one buffer, ``ops["wpack"]``, in the shared-memory layout of its ``wgmma``
B operands (:func:`pack_wgmma`).
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
    ``wcsum``) cast, the biases and ``alpha`` left float32; in bfloat16
    also K3-bf16's packed weights (:func:`pack_wgmma`)."""
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
    return pack_wgmma(out) if dtype == torch.bfloat16 else out


def wgmma_image(w: torch.Tensor) -> torch.Tensor:
    """``w [K, N]`` as a ``wgmma`` B operand in shared memory: K-major (each
    column's K values contiguous) in 128-byte swizzle atoms ``[ceil(K /
    64), N, 64]`` (zeros past K), the 16-byte chunk ``c`` of row ``n``
    stored at chunk ``c ^ (n % 8)``.  Flat, ``w``'s dtype."""
    k, n = w.shape
    atoms = _ceil(k, 64)
    img = w.new_zeros((atoms * 64, n))
    img[:k] = w
    img = img.reshape(atoms, 8, 8, n).permute(0, 3, 1, 2)  # [atom, n, chunk, 8]
    chunk = torch.arange(8, device=w.device)[None, :] ^ (torch.arange(n, device=w.device)[:, None] % 8)
    out = torch.empty_like(img)
    out.scatter_(2, chunk[None, :, :, None].expand_as(img), img)
    return out.reshape(-1)


def pack_wgmma(ops: dict) -> dict:
    """``ops`` with ``"wpack"``: K3-bf16's weights as one contiguous bf16
    buffer in the layout of its shared memory, :func:`wgmma_image` of
    ``wmain``, ``wg`` (the block-diagonal gate as one 64 x 64 operand),
    ``w2`` and, for stages 2-5, ``conv1``'s ``W1 [64, 32]``; each image is
    a multiple of 1024 bytes, so every one starts on a swizzle atom."""
    mats = [ops["wmain"], ops["wg"], ops["w2"]]
    if ops["pre"] is not None:
        mats.append(ops["pre"][0])
    if any(m.dtype != torch.bfloat16 for m in mats):
        raise ValueError("pack_wgmma packs bfloat16 operands")
    return {**ops, "wpack": torch.cat([wgmma_image(m) for m in mats]).contiguous()}


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


def channel_stride(c: int) -> int:
    """Elements a pixel takes in K3's staged input tile: C = 2 padded to 4
    (one float2 a k pair), C = 32 to 36."""
    return 4 if c == 2 else c + 4


def smem_bytes(c: int, kf: int, f: int, tt: int) -> int:
    """K3's dynamic shared memory for a tile of ``tt`` output frames: the
    weights in fragment order (window, two gate blocks, W2; m16n8k8 steps,
    each lane's fragment split into hi and lo, 16 bytes), the k-offset
    table, and the ``tt + 1`` input frames ``[F, CS]``
    (:func:`channel_stride`)."""
    k8 = _ceil(2 * kf * c, 8)
    return (16 * 32 * (8 * k8 + 2 * 4 * 4 + 4 * 8) + 4 * 4 * k8
            + 4 * (tt + 1) * f * channel_stride(c))


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
    """The f32 tile for ``b`` utterances of ``t`` output frames: a tile of
    at most ``TILE_ROWS`` rows costs every warp at most one m-tile, so the
    makespan is the ``ceil(tiles / blocks)`` tiles each of the ``min(tiles,
    n_sm)`` blocks walks; the smallest tile of least makespan is taken
    (less to copy in a tile, more blocks at work)."""
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


# K3-bf16 (csrc/enc_chain_bf16.cu): two consumer warpgroups of 64-row
# m-tiles and one producer warp a block, a ring of two input slots
BF16_WARPGROUPS = 2
BF16_RING = 2
BF16_GEOMETRIES = ((2, 5), (64, 3))  # (input channels, frequency taps) K3-bf16 takes
BF16_MAX_FRAMES = 255  # a TMA box holds at most 256 frames


def bf16_smem_bytes(c: int, kf: int, f: int, tt: int) -> int:
    """K3-bf16's dynamic shared memory for a tile of ``tt`` output frames
    (``csrc/enc_chain_bf16.cu::layout``): the packed weights (8 KB a
    64-wide K atom of ``wmain``, the 64 x 64 gate and W2 8 KB each, W1 4 KB
    at stages 2-5), two input slots (stages 2-5: the ``(tt + 1) F`` pixels
    of 128 bytes, in whole 64-row m-tiles; stage 1: 4 bytes a pixel, to 1
    KB), two 32-channel ``conv1`` tiles (stages 2-5, two pixels a 128-byte
    line, to 1 KB), a 64 x 128-byte output stage per warpgroup, the
    mbarriers, and 1 KB to align the base."""
    tma = c == 64
    k = 2 * kf * (32 if tma else c)
    w = _ceil(k, 64) * 8192 + 2 * 8192 + (4096 if tma else 0)
    pixels = (tt + 1) * f
    slot = _ceil(pixels, 64) * 64 * 128 if tma else _ceil(4 * pixels, 1024) * 1024
    xs1 = _ceil(_ceil(pixels, 2) * 128, 1024) * 1024 if tma else 0
    return (w + BF16_RING * slot + 2 * xs1 + BF16_WARPGROUPS * 64 * 128
            + 2 * BF16_RING * 8 + 1024)


@functools.lru_cache(maxsize=None)
def bf16_plan(b: int, t: int, f: int, c: int, kf: int, n_sm: int) -> TilePlan:
    """K3-bf16's tile for ``b`` utterances of ``t`` frames: a tile of ``tt``
    frames is ``ceil(tt Fo / 64)`` m-tiles shared by the block's two
    warpgroups, plus about one m-tile's time of its own (its conv1 halo
    frame, barriers, the copy not hidden), and the ``min(tiles, n_sm)``
    blocks walk ``ceil(tiles / blocks)`` tiles each, so the makespan is
    their product in m-tiles a warpgroup; the smallest tile of least
    makespan that fits is taken (at the serving shapes stages 3-5 then
    give every SM a tile and both its warpgroups an m-tile)."""
    fo = (f - kf) // 2 + 1
    best = None
    for tt in range(1, min(t, BF16_MAX_FRAMES) + 1):
        smem = bf16_smem_bytes(c, kf, f, tt)
        if smem > SMEM_MAX:
            break
        tiles = b * _ceil(t, tt)
        grid = min(tiles, n_sm)
        span = _ceil(tiles, grid) * (_ceil(_ceil(tt * fo, 64), BF16_WARPGROUPS) + 1)
        if best is None or span < best[0]:
            best = (span, TilePlan(tt, tiles, grid, smem))
    if best is None:
        raise ValueError(f"no K3-bf16 tile fits at F = {f}, C = {c}, kernel_f = {kf}")
    return best[1]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_stage(x: torch.Tensor, ops: dict, cin: int, geometries) -> tuple:
    """The checks both K3 wrappers make; returns ``(b, t, fo)``."""
    k = ops["kernel_f"]
    if (cin, k) not in geometries:
        raise ValueError(f"enc_stage kernel takes (C, kernel_f) in {geometries}, "
                         f"got {(cin, k)}")
    dev = x.device
    check_operand("x", x, dev, dtype=x.dtype)
    if x.data_ptr() % 16:
        raise ValueError("enc_stage kernel takes x 16-byte aligned")
    return _out_shape(x, k, 1)


def _launch(x: torch.Tensor, ops: dict, bias_b: torch.Tensor, pad: int) -> torch.Tensor:
    """Check a float32 stage for K3 and launch it."""
    if x.ndim != 4 or pad not in (0, 1):
        raise ValueError(f"enc_stage takes [B, Tin, F, C] and pad 0/1, got "
                         f"{tuple(x.shape)}, pad={pad}")
    k = ops["kernel_f"]
    b, t, fo = _out_shape(x, k, pad)
    cin = x.shape[-1]
    _check_stage(x, ops, cin, GEOMETRIES)
    dev = x.device
    check_operand("bias_b", bias_b, dev, (b, COUT))
    if t < 1 or fo < 1:
        raise ValueError(f"stage input {tuple(x.shape)} gives no output rows")
    if (ops["wmain"].device != dev or ops["wmain"].dtype != x.dtype
            or ops["wmain"].shape[0] != 2 * k * cin):
        raise ValueError(f"stage operands {ops['wmain'].dtype} on {ops['wmain'].device} "
                         f"with K = {ops['wmain'].shape[0]} for a {x.dtype} input on {dev} "
                         f"with C = {cin}")
    out = torch.empty((b, t, fo, COUT), dtype=x.dtype, device=dev)
    if b:
        plan = tile_plan(b, t, x.shape[2], cin, k, _sm_count(dev.index))
        with on_device(dev):
            err = build.library().pdt_enc_stage_f32(
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
    out = _launch(x, ops, bias_b, pad)
    if x.shape[0]:
        enc_stage.launches += 1
    return out


def conv1_input(x: torch.Tensor, w1: torch.Tensor, bias1: torch.Tensor) -> torch.Tensor:
    """Stage 2-5's ``conv1`` on the causally padded input: ``[B, T + 1, F,
    32]`` in ``x``'s dtype, frame 0 ``conv1`` of a zero frame (``bias1``),
    then ``bf16(f32(x @ W1) + bias1)`` in bfloat16 (JAX's rounding points)."""
    b, t, f, _ = x.shape
    xin = x.new_empty((b, t + 1, f, G))
    xin[:, 0] = bias1[:, None, :]  # conv1 of the zero pad frame
    xin[:, 1:] = _product_f32(x, w1) + bias1[:, None, None, :]
    return xin


def enc_stage_bf16_plain(x: torch.Tensor, ops: dict, bias_b: torch.Tensor,
                         bias1: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3-bf16's function in plain PyTorch: one whole encoder stage on its
    input ``x [B, T, F, C]`` (stage 1: C = 2, ``bias1`` None; stages 2-5: C
    = 64 and ``bias1 [B, 32]`` float32, the ``conv1`` bias with the time
    projection's term) -> ``[B, T, Fo, 64]``; :func:`conv1_input`, then
    :func:`enc_stage_plain` on the padded result."""
    if ops["pre"] is None:
        return enc_stage_plain(x, ops, bias_b, 1)
    return enc_stage_plain(conv1_input(x, ops["pre"][0], bias1), ops, bias_b, 0)


def _batch_stride(name: str, t: torch.Tensor, device: torch.device, b: int, n: int) -> int:
    """K3-bf16 takes a per-batch bias ``[b, n]`` float32 with contiguous
    rows, one a batch or one row broadcast (batch stride 0); returns the
    batch stride."""
    if (t.device != device or t.dtype != torch.float32 or tuple(t.shape) != (b, n)
            or t.stride(1) != 1 or t.stride(0) not in (0, n)):
        raise ValueError(f"{name} must be float32 [{b}, {n}] on {device} with rows of stride "
                         f"{n} or 0, got {t.dtype} {tuple(t.shape)} {t.stride()} on {t.device}")
    return t.stride(0)


def enc_stage_bf16(x: torch.Tensor, ops: dict, bias_b: torch.Tensor,
                   bias1: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One whole encoder stage in bfloat16 (K3-bf16 on CUDA, ``conv1``
    included); contract of :func:`enc_stage_bf16_plain` (the biases may be
    one row broadcast over the batch)."""
    if not on_cuda(x):
        return enc_stage_bf16_plain(x, ops, bias_b, bias1)
    if x.dtype != torch.bfloat16 or x.ndim != 4:
        raise ValueError(f"enc_stage_bf16 takes [B, T, F, C] bfloat16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    cin, k = x.shape[-1], ops["kernel_f"]
    b, t, fo = _check_stage(x, ops, cin, BF16_GEOMETRIES)
    dev = x.device
    if (ops["pre"] is None) != (cin == 2) or (bias1 is None) != (cin == 2):
        raise ValueError("enc_stage_bf16 takes conv1 (ops['pre'] and bias1) at C = 64 "
                         "and neither at C = 2")
    strides = (_batch_stride("bias_b", bias_b, dev, b, COUT),
               0 if bias1 is None else _batch_stride("bias1", bias1, dev, b, G))
    wpack = ops.get("wpack")
    if wpack is None or wpack.device != dev or wpack.dtype != torch.bfloat16:
        raise ValueError("enc_stage_bf16 takes ops packed by pack_wgmma on the input's device")
    if t < 1 or fo < 1:
        raise ValueError(f"stage input {tuple(x.shape)} gives no output rows")
    out = torch.empty((b, t, fo, COUT), dtype=x.dtype, device=dev)
    if b:
        plan = bf16_plan(b, t, x.shape[2], cin, k, _sm_count(dev.index))
        with on_device(dev):
            err = build.library().pdt_enc_stage_bf16(
                x.data_ptr(), bias_b.data_ptr(), None if bias1 is None else bias1.data_ptr(),
                wpack.data_ptr(), ops["bg"].data_ptr(), ops["b2"].data_ptr(),
                ops["alpha"].data_ptr(), out.data_ptr(), b, t, x.shape[2], cin, k, *strides,
                plan.tt, plan.grid, plan.smem, stream(dev))
        build.check(err, "bf16 encoder stage kernel")
        enc_stage_bf16.launches += 1
    return out


enc_stage.launches = 0
enc_stage_bf16.launches = 0


def _product_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` as float32: in float32 the product; in bfloat16 (both
    operands) the product rounded to bfloat16, then widened (JAX's einsum
    without a preferred type)."""
    return torch.matmul(a, w).float()


def stage_biases(x: torch.Tensor, ops: dict, tp, temb: Optional[torch.Tensor]):
    """``(bias_b [B, 64], bias1 [B, 32] or None)`` of a stage on ``x [B, T,
    F, Cin]`` (without a time projection, one row broadcast over the batch:
    no copy): the time projection folds into the per-batch bias (through
    ``wcsum``, stage 1) or into ``conv1``'s bias (stages 2-5).  In bfloat16
    the rounding points are ``fused_enc_stage``'s: ``tproj`` = bf16(temb @
    W) + b, cast to bf16; the projection's bias term bf16(tproj @ W)
    widened and added to the f32 bias."""
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
        return bias_b, None
    w1, b1 = ops["pre"]
    bias1 = b1.expand(b, G) if tproj is None else b1 + _product_f32(tproj, w1)
    return bias_b, bias1


def stage_inputs(x: torch.Tensor, ops: dict, tp, temb: Optional[torch.Tensor]):
    """``(xin, bias_b, pad)`` for the float32 stage kernel from a stage
    input ``x [B, T, F, Cin]``: :func:`stage_biases`, and for stages 2..5
    the separate ``conv1`` on the causally padded input
    (:func:`conv1_input`)."""
    bias_b, bias1 = stage_biases(x, ops, tp, temb)
    if ops["pre"] is None:
        return x.contiguous(), bias_b.contiguous(), 1
    return conv1_input(x, ops["pre"][0], bias1), bias_b.contiguous(), 0


def encoder_fused(x: torch.Tensor, packed, temb: Optional[torch.Tensor] = None):
    """Five encoder stages on ``x [B, T, 161, Cin]`` (channels-last) ->
    ``(x [B, T, 4, 64], skips)`` in the packed operands' dtype; ``temb [B,
    512]`` for time-conditioned encoders.  float32: the stage-2..5
    ``conv1`` and the time projections are plain products, each stage's
    window chain :func:`enc_stage`; bfloat16: each stage is one
    :func:`enc_stage_bf16` on the last one's output, ``conv1`` included."""
    skips = []
    for ops, tp in packed:
        if ops["wmain"].dtype == torch.float32:
            xin, bias_b, pad = stage_inputs(x, ops, tp, temb)
            x = enc_stage(xin, ops, bias_b, pad)
        else:
            x = enc_stage_bf16(x.contiguous(), ops, *stage_biases(x, ops, tp, temb))
        skips.append(x)
    return x, skips
