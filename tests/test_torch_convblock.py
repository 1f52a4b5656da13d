"""Port K3 packing and plain stage math against the JAX fused encoder (CPU),
and K3's tile plan, index arithmetic and 3xTF32 products emulated in torch;
K3-bf16's staging, descriptors and plan likewise.

The port packs each encoder stage from its own converted modules
(``ops/cuda/convblock.py``) and runs the plain version of K3
(``enc_stage_plain``); the reference is the JAX ``fused_enc_stage`` on
JAX's own packing, with ``use_pallas=False`` for all five stages and
``interpret=True`` for one stage at T = 4.  Same stage inputs on both
sides.  Bound: 1e-5 * max|ref| (float32 products of length <= 192 summed
in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prior_diffuse_tpu.models.diffunet import Encoder as JEncoder
from prior_diffuse_tpu.ops.pallas import convblock_kernel as jcb
from prior_diffuse_tpu_torch.convert import flax_to_state_dict
from prior_diffuse_tpu_torch.models.diffunet import Encoder
from prior_diffuse_tpu_torch.ops.cuda import convblock as cb


def _close_rel(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err, bound = np.abs(got - want).max(), rel * np.abs(want).max()
    assert err <= bound, f"max|diff| {err:.3g} > {bound:.3g}"


def _randomize_bn(stats, rng):
    for bn in stats.values():
        bn = bn["BatchNorm_0"]
        bn["mean"] = (rng.standard_normal(bn["mean"].shape) * 0.1).astype(np.float32)
        bn["var"] = (0.5 + rng.random(bn["var"].shape)).astype(np.float32)


def _encoders(time_cond, t_frames, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, t_frames, 161, 2)).astype(np.float32)
    temb = rng.standard_normal((2, 512)).astype(np.float32) if time_cond else None
    jenc = JEncoder(time_cond=time_cond)
    variables = jenc.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                          None if temb is None else jnp.asarray(temb), False)
    params = jax.tree.map(np.array, variables["params"])
    stats = jax.tree.map(np.array, variables["batch_stats"])
    _randomize_bn(stats, rng)
    enc = Encoder(time_cond).eval()
    enc.load_state_dict(flax_to_state_dict(
        enc, {"params": params, "batch_stats": stats}))
    return x, temb, params, stats, enc


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "tproj"])
def encoders(request):
    return (request.param, *_encoders(request.param, 9, 5 + request.param))


@pytest.mark.parametrize("stage", range(5))
def test_stage_matches_jax(encoders, stage):
    time_cond, x, temb, params, stats, enc = encoders
    jpacked = jcb.pack_encoder(params, stats)
    ports = cb.pack_encoder(enc)
    # stage input: the JAX chain's output of the stages before
    xin = jnp.asarray(x)
    jtemb = None if temb is None else jnp.asarray(temb)
    for (ops, tp), kf in list(zip(jpacked, jcb._ENC_KERNELS))[:stage]:
        tproj = None if tp is None else jtemb @ tp[0] + tp[1]
        xin = jcb.fused_enc_stage(xin, ops, tproj, kernel_f=kf,
                                  dtype=jnp.float32, use_pallas=False)
    ops, tp = jpacked[stage]
    tproj = None if tp is None else jtemb @ tp[0] + tp[1]
    want = jcb.fused_enc_stage(xin, ops, tproj, kernel_f=jcb._ENC_KERNELS[stage],
                               dtype=jnp.float32, use_pallas=False)
    with torch.no_grad():
        got, _ = cb.encoder_fused(
            torch.from_numpy(np.array(xin)), [ports[stage]],
            None if temb is None else torch.from_numpy(temb))
    _close_rel(got.numpy(), want)


def test_packing_matches_jax(encoders):
    _, _, _, params, stats, enc = encoders
    for (jops, _), (ops, _) in zip(jcb.pack_encoder(params, stats),
                                   cb.pack_encoder(enc)):
        for key in ("wmain", "bmain", "wg", "bg", "w2", "b2"):
            _close_rel(ops[key].detach().numpy(), jops[key], 1e-6)
        np.testing.assert_array_equal(ops["alpha"].numpy().reshape(()),
                                      np.asarray(jops["alpha"]))
        assert (ops["pre"] is None) == (jops["pre"] is None)


def test_fused_encoder_matches_module_form(encoders):
    """The packed path and the conv-by-conv modules give the same skips."""
    _, x, temb, _, _, enc = encoders
    t = None if temb is None else torch.from_numpy(temb)
    with torch.no_grad():
        _, want = enc(torch.from_numpy(x).permute(0, 3, 1, 2), t)
        _, got = cb.encoder_fused(torch.from_numpy(x), cb.pack_encoder(enc), t)
    for a, b in zip(got, want):
        _close_rel(a.numpy(), b.permute(0, 2, 3, 1).numpy(), 1e-5)


def test_stage_matches_pallas_interpret():
    """Stage 1 of a time-conditioned encoder at T = 4, against the Pallas
    kernel in interpret mode."""
    x, temb, params, stats, enc = _encoders(True, 4, 11)
    ops, tp = jcb.pack_encoder(params, stats)[0]
    tproj = jnp.asarray(temb) @ tp[0] + tp[1]
    want = jcb.fused_enc_stage(jnp.asarray(x), ops, tproj, kernel_f=5,
                               dtype=jnp.float32, tile_r=64, interpret=True)
    with torch.no_grad():
        got, _ = cb.encoder_fused(torch.from_numpy(x), cb.pack_encoder(enc)[:1],
                                  torch.from_numpy(temb))
    _close_rel(got.numpy(), want)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero, on the bits, as ``cvt.rna.tf32.f32`` does for finite values."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as K3's 3xTF32 products: a_lo b_hi + a_hi b_lo + a_hi b_hi."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _k3_emulate(x, ops, bias_b, pad, n_sm=132):
    """K3 (``csrc/enc_chain.cu``) emulated tile by tile from its plan: each
    tile's tt + 1 input frames staged as ``[tt + 1, F, CS]`` (zeros outside
    the input), the A operand read at row offset + k offset, the window,
    gate and W2 products in 3xTF32.  Returns the output and how many times
    each output row was written."""
    b, tin, f, c = x.shape
    kf = ops["kernel_f"]
    t, fo = tin - 1 + pad, (f - kf) // 2 + 1
    plan = cb.tile_plan(b, t, f, c, kf, n_sm)
    assert plan.smem == cb.smem_bytes(c, kf, f, plan.tt) <= cb.SMEM_MAX
    assert plan.tt * fo <= cb.TILE_ROWS and plan.grid <= n_sm
    cs = 4 if c == 2 else c + 4
    k_dim = 2 * kf * c
    k8 = -(-k_dim // 8) * 8
    koff = torch.zeros(k8, dtype=torch.long)
    for k in range(k_dim):
        kt, r = divmod(k, kf * c)
        koff[k] = (kt * f + r // c) * cs + r % c
    w = torch.zeros(k8, 64)
    w[:k_dim] = ops["wmain"]
    per_utt = -(-t // plan.tt)
    assert plan.tiles == b * per_utt
    out = torch.full((b, t * fo, 64), float("nan"))
    writes = torch.zeros(b, t * fo, dtype=torch.long)
    for tile in range(plan.tiles):
        bi, t0 = tile // per_utt, (tile % per_utt) * plan.tt
        buf = torch.zeros(plan.tt + 1, f, cs)
        for j in range(plan.tt + 1):
            if 0 <= t0 - pad + j < tin:
                buf[j, :, :c] = x[bi, t0 - pad + j]
        buf = buf.reshape(-1)
        rows = min(plan.tt, t - t0) * fo
        r = torch.arange(-(-rows // 16) * 16)
        r = torch.where(r < rows, r, 0)  # rows past the tile read row 0
        off = ((r // fo) * f + 2 * (r % fo)) * cs
        a = buf[off[:, None] + koff[None, :]]  # padded k: offset 0, zero weights
        y = _mm3(a, w) + bias_b[bi]
        m = _mm3(y, ops["wg"]) + ops["bg"]
        comb = y[:, :32] * torch.sigmoid(m[:, 32:]) + y[:, 32:] * torch.sigmoid(m[:, :32])
        o = _mm3(comb, ops["w2"]) + ops["b2"]
        o = torch.where(o >= 0, o, ops["alpha"] * o)
        out[bi, t0 * fo:t0 * fo + rows] = o[:rows]
        writes[bi, t0 * fo:t0 * fo + rows] += 1
    return out.reshape(b, t, fo, 64), writes


def _stage_operands(c, kf, seed):
    g = torch.Generator().manual_seed(seed)
    ops = {"kernel_f": kf, "wmain": torch.randn(2 * kf * c, 64, generator=g) * 0.2,
           "wg": torch.zeros(64, 64), "bg": torch.randn(64, generator=g),
           "w2": torch.randn(32, 64, generator=g) * 0.2,
           "b2": torch.randn(64, generator=g), "alpha": torch.tensor([0.2])}
    ops["wg"][:32, :32] = torch.randn(32, 32, generator=g) * 0.2
    ops["wg"][32:, 32:] = torch.randn(32, 32, generator=g) * 0.2
    return ops, g


# (input frequencies, channels, kernel_f, pad) of the five encoder stages
STAGES = [(161, 2, 5, 1), (79, 32, 3, 0), (39, 32, 3, 0), (19, 32, 3, 0), (9, 32, 3, 0)]


@pytest.mark.parametrize("pad", [0, 1])
def test_kernel_index_math_matches_plain(pad):
    """K3's staging and index arithmetic, emulated tile by tile (input
    frames t0 - pad + j into a ``[tt + 1, F, CS]`` buffer, frames outside
    the input zero; A = buffer[row offset + k offset]), with its two
    diagonal gate blocks and 3xTF32 products, equals ``enc_stage_plain``."""
    f, c, kf = (161, 2, 5) if pad else (19, 32, 3)
    ops, g = _stage_operands(c, kf, pad)
    b, tin = 2, 3
    x = torch.randn(b, tin, f, c, generator=g)
    bias_b = torch.randn(b, 64, generator=g)
    want = cb.enc_stage_plain(x, ops, bias_b, pad)
    assert want.shape == (b, tin - 1 + pad, (f - kf) // 2 + 1, 64)
    got, writes = _k3_emulate(x, ops, bias_b, pad)
    assert bool((writes == 1).all())
    _close_rel(got.numpy(), want.numpy())


@pytest.mark.parametrize("stage", range(5), ids=[f"stage{i + 1}" for i in range(5)])
@pytest.mark.parametrize("t_frames", [8, 13])
def test_3xtf32_chain_matches_plain(stage, t_frames):
    """K3's 3xTF32 products (each operand split into TF32 hi and lo, three
    products) through the whole chain keep f32-level error: within 1e-5 x
    max|ref| of ``enc_stage_plain`` at every stage geometry, with a tile
    plan that leaves a partial last tile (n_sm = 2 forces several tiles)."""
    f, c, kf, pad = STAGES[stage]
    ops, g = _stage_operands(c, kf, 10 + stage)
    b = 2
    x = torch.randn(b, t_frames + 1 - pad, f, c, generator=g)
    bias_b = torch.randn(b, 64, generator=g)
    want = cb.enc_stage_plain(x, ops, bias_b, pad)
    got, writes = _k3_emulate(x, ops, bias_b, pad, n_sm=2)
    assert bool((writes == 1).all())
    _close_rel(got.numpy(), want.numpy())


def test_tf32_rounding_is_rna():
    """The emulation's TF32 rounding: to nearest, ties away from zero, 13
    low mantissa bits cleared; hi + lo keeps ~22 bits of the value."""
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, 3.0])
    np.testing.assert_array_equal(_tf32(x).numpy(), [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10),
                                                     1.0, 3.0])
    v = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    hi = _tf32(v)
    assert float(((hi + _tf32(v - hi) - v).abs() / v.abs()).max()) < 2.0 ** -21


# (batch, output frames) of the serving path, training evaluation and the
# edge shapes chip_smoke.py checks on the card
PLAN_SHAPES = [(8, 301), (6, 401), (1, 1), (3, 2), (1, 3), (3, 37), (1, 150)]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=[f"{b}x{t}" for b, t in PLAN_SHAPES])
@pytest.mark.parametrize("stage", range(5), ids=[f"stage{i + 1}" for i in range(5)])
def test_tile_plan_covers_rows_and_fits(shape, stage):
    """The tile plan writes every output row of every utterance exactly
    once, keeps a tile within the block's rows, and fits the 227 KB of
    shared memory a block may use."""
    b, t = shape
    f, c, kf, _ = STAGES[stage]
    fo = (f - kf) // 2 + 1
    plan = cb.tile_plan(b, t, f, c, kf, 132)
    assert plan.smem == cb.smem_bytes(c, kf, f, plan.tt) <= cb.SMEM_MAX == 232_448
    assert 1 <= plan.tt * fo <= cb.TILE_ROWS
    per_utt = -(-t // plan.tt)
    assert plan.tiles == b * per_utt and plan.grid == min(plan.tiles, 132)
    writes = np.zeros((b, t * fo), np.int64)
    for tile in range(plan.tiles):
        bi, t0 = divmod(tile, per_utt)
        t0 *= plan.tt
        rows = min(plan.tt, t - t0) * fo
        writes[bi, t0 * fo:t0 * fo + rows] += 1
    assert (writes == 1).all()


def test_wrapper_takes_plain_path_on_cpu(encoders):
    _, x, temb, _, _, enc = encoders
    ops, _ = cb.pack_encoder(enc)[0]
    xt = torch.from_numpy(x)
    bias_b = ops["bmain"].expand(2, 64).contiguous()
    before = cb.enc_stage.launches
    with torch.no_grad():
        got = cb.enc_stage(xt, ops, bias_b, 1)
        want = cb.enc_stage_plain(xt, ops, bias_b, 1)
    assert torch.equal(got, want)
    assert cb.enc_stage.launches == before


# ----------------------------------------------------------------- K3 in bf16
# csrc/enc_chain_bf16.cu at the level of its shared-memory bytes: the TMA
# box with the 128-byte swizzle (stages 2-5) or the cp.async pixels (stage
# 1), the wgmma operands read through their descriptors (K-major, 128-byte
# swizzle: the hardware XORs address bits 4-6 with bits 7-9), conv1 into
# the pair-swizzled 32-channel tile, the ldmatrix row addresses of the
# im2col, and the output tile staged and stored as 16-byte chunks.

def _bf(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _sw128(addr: torch.Tensor) -> torch.Tensor:
    """Physical byte address of a logical one in a 128-byte-swizzled region
    (1024-byte aligned)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _desc_operand(mem: torch.Tensor, start: int, rows: int) -> torch.Tensor:
    """The ``[rows, 16]`` operand a K-major SW128 descriptor at byte
    ``start`` gives one wgmma k16 step (rows 128 bytes apart, 8-row groups
    1024 bytes apart); ``mem`` holds bf16 values as floats, one per 2 bytes."""
    m = torch.arange(rows)[:, None]
    k = torch.arange(16)[None, :]
    logical = start + (m // 8) * 1024 + (m % 8) * 128 + 2 * k
    return mem[_sw128(logical) // 2]


def _xs1_offset(p, c):
    line, chunk = p >> 1, ((p & 1) << 2) | (c >> 3)
    return line * 128 + ((chunk ^ (line & 7)) << 4) + (c & 7) * 2


def _k3_bf16_emulate(x, ops, bias_b, bias1, n_sm=132):
    """K3-bf16 from its plan, tile by tile and m-tile by m-tile through its
    shared memory; returns the output and each output row's count of
    16-byte stores."""
    b, t, f, c = x.shape
    kf = ops["kernel_f"]
    tma = c == 64
    fo = (f - kf) // 2 + 1
    plan = cb.bf16_plan(b, t, f, c, kf, n_sm)
    assert plan.smem == cb.bf16_smem_bytes(c, kf, f, plan.tt) <= cb.SMEM_MAX
    k_dim = 2 * kf * (32 if tma else c)
    ks_n = -(-k_dim // 16)
    wmem = ops["wpack"].float()
    w_gate = -(-k_dim // 64) * 8192
    w_2, w_1 = w_gate + 8192, w_gate + 16384
    assert wmem.numel() * 2 == w_1 + (4096 if tma else 0)
    per_utt = -(-t // plan.tt)
    assert plan.tiles == b * per_utt and plan.grid == min(plan.tiles, n_sm)
    out = torch.full((b, t * fo, 64), float("nan"))
    writes = torch.zeros(b, t * fo, dtype=torch.long)
    xf = x.float()
    for tile in range(plan.tiles):
        bi, t0 = tile // per_utt, (tile % per_utt) * plan.tt
        rows = min(plan.tt, t - t0) * fo
        pixels = (plan.tt + 1) * f
        # the box / staged frames t0 - 1 .. t0 + tt - 1, zeros outside [0, T)
        frames = torch.zeros(plan.tt + 1, f, c)
        for j in range(plan.tt + 1):
            if 0 <= t0 - 1 + j < t:
                frames[j] = xf[bi, t0 - 1 + j]
        if tma:
            slot = torch.full((-(-pixels // 64) * 64 * 64,), float("nan"))  # unwritten rows
            p = torch.arange(pixels)[:, None]
            k = torch.arange(64)[None, :]
            slot[(p * 128 + (((k // 8) ^ (p % 8)) << 4) + (k % 8) * 2) // 2] = frames.reshape(-1, 64)
            xs1 = torch.full((-(-pixels // 2) * 64,), float("nan"))
            for i in range(-(-pixels // 64)):  # conv1, 64 pixels a wgmma m-tile
                d = sum(_desc_operand(slot, i * 8192 + ks * 32, 64)
                        @ _desc_operand(wmem, w_1 + ks * 32, 32).t() for ks in range(4))
                px = torch.arange(i * 64, i * 64 + 64)
                keep = px < pixels
                ch = torch.arange(32)[None, :]
                xs1[_xs1_offset(px[keep][:, None], ch) // 2] = _bf(_bf(d[keep]) + bias1[bi])
            mem = xs1
        else:
            mem = frames.reshape(-1)  # 4 bytes a pixel: elements 2e, 2e + 1
        for mt in range(-(-rows // 64)):
            a = torch.zeros(64, ks_n * 16)
            for wl in range(4):
                if tma:  # ldmatrix x4: lane 8q + rr gives row rr of matrix q
                    for lane in range(32):
                        r = mt * 64 + wl * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)
                        r = r if r < rows else 0
                        base = (r // fo) * f + 2 * (r % fo)
                        for st in range(ks_n):
                            kt, kfi = divmod(st >> 1, kf)
                            addr = _xs1_offset(base + kt * f + kfi, 16 * (st & 1) + 8 * (lane >> 4))
                            row = wl * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)
                            col = 16 * st + 8 * (lane >> 4)
                            a[row, col:col + 8] = mem[addr // 2:addr // 2 + 8]
                else:  # 32-bit loads: k pair q is tap q, pairs past K read the origin
                    for rr in range(16):
                        r = mt * 64 + wl * 16 + rr
                        r = r if r < rows else 0
                        off = ((r // fo) * f + 2 * (r % fo)) * 4
                        for q in range(ks_n * 8):
                            toff = ((q // kf) * f + q % kf) * 4 if q < 2 * kf else 0
                            a[wl * 16 + rr, 2 * q:2 * q + 2] = mem[(off + toff) // 2:(off + toff) // 2 + 2]
            y = sum(a[:, 16 * st:16 * st + 16]
                    @ _desc_operand(wmem, (st >> 2) * 8192 + (st & 3) * 32, 64).t()
                    for st in range(ks_n)) + bias_b[bi]
            m = sum(_bf(y[:, 16 * st:16 * st + 16])
                    @ _desc_operand(wmem, w_gate + st * 32, 64).t() for st in range(4)) + ops["bg"]
            comb = y[:, :32] * torch.sigmoid(m[:, 32:]) + y[:, 32:] * torch.sigmoid(m[:, :32])
            o = sum(_bf(comb[:, 16 * st:16 * st + 16])
                    @ _desc_operand(wmem, w_2 + st * 32, 64).t() for st in range(2)) + ops["b2"]
            o = _bf(torch.where(o >= 0, o, ops["alpha"] * o))
            # stage: 16-byte chunk j of row rr at chunk j ^ (rr % 8); then 16-byte stores
            stage = torch.empty(64 * 64)
            rr = torch.arange(64)[:, None]
            col = torch.arange(64)[None, :]
            stage[rr * 64 + (((col // 8) ^ (rr % 8)) * 8) + col % 8] = o
            for q in range(512):
                r8, ch = q >> 3, q & 7
                if r8 < min(64, rows - mt * 64):
                    row = t0 * fo + mt * 64 + r8
                    out[bi, row, ch * 8:ch * 8 + 8] = stage[r8 * 64 + (ch ^ (r8 % 8)) * 8:][:8]
                    writes[bi, row] += 1
    return out.reshape(b, t, fo, 64), writes


def _bf16_stage_operands(stage, seed):
    """bf16 operands of stage ``stage`` (0-4) from a seed, packed for the
    kernel, with a random conv1 (stages 2-5)."""
    f, c, kf, _ = STAGES[stage]
    ops, g = _stage_operands(c, kf, seed)
    ops = {**ops, "wmain": ops["wmain"].bfloat16(), "wg": ops["wg"].bfloat16(),
           "w2": ops["w2"].bfloat16(), "pre": None}
    cin = 2 if stage == 0 else 64
    if stage:
        ops["pre"] = ((torch.randn(64, 32, generator=g) * 0.2).bfloat16(),
                      torch.randn(32, generator=g))
    return f, cin, cb.pack_wgmma(ops), g


@pytest.mark.parametrize("stage", range(5), ids=[f"stage{i + 1}" for i in range(5)])
@pytest.mark.parametrize("t_frames", [3, 7])
def test_k3_bf16_staging_matches_plain(stage, t_frames):
    """K3-bf16's staging and addressing, emulated with several tiles and a
    partial last one (n_sm = 2): the TMA box from frame t0 - 1 (zero-filled
    before frame 0, so conv1 gives the pad frame bf16(bias1)), conv1 and
    every product through their wgmma descriptors, the ldmatrix im2col
    addresses and the staged output; equals ``enc_stage_bf16_plain`` up to
    summation order (an occasional bf16 step of the output), and every
    output row is stored once."""
    f, cin, ops, g = _bf16_stage_operands(stage, 20 + stage)
    b = 2
    x = torch.randn(b, t_frames, f, cin, generator=g).bfloat16()
    bias_b = torch.randn(b, 64, generator=g)
    bias1 = torch.randn(b, 32, generator=g) if stage else None
    want = cb.enc_stage_bf16_plain(x, ops, bias_b, bias1)
    got, writes = _k3_bf16_emulate(x, ops, bias_b, bias1, n_sm=2)
    assert bool((writes == 8).all())  # eight 16-byte chunks a row
    _close_rel(got.numpy(), want.float().numpy(), 2.0 ** -7)


# (K, N) of the operands K3-bf16 packs: stage 1's window, stage 2-5's window,
# the block-diagonal gate, W2, conv1's W1
PACK_SHAPES = [(20, 64), (192, 64), (64, 64), (32, 64), (64, 32)]


@pytest.mark.parametrize("shape", PACK_SHAPES, ids=[f"{k}x{n}" for k, n in PACK_SHAPES])
def test_wgmma_image_inverts(shape):
    """The host packing into the swizzled wgmma B layout, read back through
    the descriptors the kernel builds (one per k16 step: atom s // 4, byte
    32 (s % 4)), gives W (zeros past K); its bytes are whole 1024-byte
    swizzle atoms."""
    k, n = shape
    w = torch.randn(k, n, generator=torch.Generator().manual_seed(k + n)).bfloat16()
    img = cb.wgmma_image(w)
    assert img.dtype == torch.bfloat16 and (img.numel() * 2) % 1024 == 0
    assert img.numel() == -(-k // 64) * 64 * n
    mem = img.float()
    steps = -(-k // 16)
    back = torch.cat([_desc_operand(mem, (s // 4) * n * 128 + (s % 4) * 32, n).t()
                      for s in range(steps)])
    want = torch.zeros(steps * 16, n)
    want[:k] = w.float()
    assert torch.equal(back, want)


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=[f"{b}x{t}" for b, t in PLAN_SHAPES])
@pytest.mark.parametrize("stage", range(5), ids=[f"stage{i + 1}" for i in range(5)])
def test_bf16_plan_covers_rows_and_fits(shape, stage):
    """K3-bf16's plan: every output row of every utterance in exactly one
    64-row m-tile of one tile, a TMA box of at most 256 frames, shared
    memory within 227 KB and equal to the kernel's layout; at the serving
    shape every stage keeps at least 128 of the 132 SMs busy and, from
    stage 2 on, both warpgroups of a block have an m-tile."""
    b, t = shape
    f, c, kf, _ = STAGES[stage]
    cin = 2 if stage == 0 else 64
    fo = (f - kf) // 2 + 1
    plan = cb.bf16_plan(b, t, f, cin, kf, 132)
    assert plan.smem == cb.bf16_smem_bytes(cin, kf, f, plan.tt) <= cb.SMEM_MAX == 232_448
    assert 1 <= plan.tt <= min(t, cb.BF16_MAX_FRAMES)
    per_utt = -(-t // plan.tt)
    assert plan.tiles == b * per_utt and plan.grid == min(plan.tiles, 132)
    writes = np.zeros((b, t * fo), np.int64)
    for tile in range(plan.tiles):
        bi, t0 = divmod(tile, per_utt)
        t0 *= plan.tt
        rows = min(plan.tt, t - t0) * fo
        for mt in range(-(-rows // 64)):
            lo = t0 * fo + mt * 64
            writes[bi, lo:lo + min(64, rows - mt * 64)] += 1
    assert (writes == 1).all()
    if shape == (8, 301):
        assert plan.grid >= 128
        if stage:
            assert -(-plan.tt * fo // 64) >= cb.BF16_WARPGROUPS


def test_bf16_bias_batch_stride():
    """K3-bf16 takes a per-batch bias with one row a batch or one row
    broadcast (no copy), and refuses any other layout or type."""
    row = torch.randn(64)
    assert cb._batch_stride("bias_b", row.expand(3, 64), row.device, 3, 64) == 0
    assert cb._batch_stride("bias_b", torch.randn(3, 64), row.device, 3, 64) == 64
    for bad in (torch.randn(64, 3).t(), torch.randn(3, 64).double(), torch.randn(3, 128)[:, ::2],
                torch.randn(2, 64)):
        with pytest.raises(ValueError):
            cb._batch_stride("bias_b", bad, row.device, 3, 64)
