"""Port K3 packing and plain stage math against the JAX fused encoder (CPU),
and K3's tile plan, index arithmetic and 3xTF32 products emulated in torch.

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
# csrc/enc_chain_bf16.cu at the level of each lane's registers: the
# m16n8k16 fragment layouts of PTX (lane = 4g + t), the weights in
# stage_frag's order, the A operand loaded as k pairs from the staged tile,
# and the f32 accumulators packed in pairs into the next product's A.

_G4 = torch.arange(32) >> 2
_T4 = torch.arange(32) & 3


def _bf(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _a_matrix(r: torch.Tensor) -> torch.Tensor:
    """A [16, 16] from each lane's four registers of two values ``r [32, 4,
    2]``: rows g, g + 8 at k 2t, 2t + 1, then at k 2t + 8, 2t + 9."""
    a = torch.zeros(16, 16)
    for i, (dr, dk) in enumerate([(0, 0), (8, 0), (0, 8), (8, 8)]):
        for h in range(2):
            a[_G4 + dr, 2 * _T4 + dk + h] = r[:, i, h]
    return a


def _b_matrix(f: torch.Tensor) -> torch.Tensor:
    """B [16, 8] from each lane's fragment ``f [32, 4]``: k 2t, 2t + 1,
    2t + 8, 2t + 9 of column g."""
    b = torch.zeros(16, 8)
    for i, dk in enumerate((0, 1, 8, 9)):
        b[2 * _T4 + dk, _G4] = f[:, i]
    return b


def _c_regs(d: torch.Tensor) -> torch.Tensor:
    """A [16, 8] accumulator as each lane's c0..c3 (rows g, g + 8; cols 2t, 2t + 1)."""
    return torch.stack([d[_G4, 2 * _T4], d[_G4, 2 * _T4 + 1],
                        d[_G4 + 8, 2 * _T4], d[_G4 + 8, 2 * _T4 + 1]], dim=1)


def _acc_to_a(c0: torch.Tensor, c1: torch.Tensor) -> torch.Tensor:
    """acc_to_a: n-tiles j, j + 1 (lane registers) -> A registers, in bf16."""
    return _bf(torch.stack([c0[:, 0:2], c0[:, 2:4], c1[:, 0:2], c1[:, 2:4]], dim=1))


def _stage_frag(w: torch.Tensor, krows: int, ks: int, nj: int) -> torch.Tensor:
    """stage_frag: ``[ks * nj * 32, 4]`` fragments of ``w`` (row stride 64)."""
    e = torch.arange(ks * nj * 32)
    lane, sj = e & 31, e >> 5
    k = 16 * (sj // nj) + 2 * (lane & 3)
    c = 8 * (sj % nj) + (lane >> 2)
    at = lambda kk: torch.where(kk < krows, w[kk.clamp(max=krows - 1), c], 0.0)
    return torch.stack([at(k), at(k + 1), at(k + 8), at(k + 9)], dim=1)


def _mma(d: torch.Tensor, a_regs: torch.Tensor, frag: torch.Tensor) -> torch.Tensor:
    """d (lane registers) += A B on one tile, f32 sums of bf16 products."""
    return d + _c_regs(_a_matrix(a_regs) @ _b_matrix(frag))


def _k3_bf16_emulate(x, ops, bias_b, pad, n_sm=132):
    """K3-bf16 warp by warp from its tile plan: the tile staged as ``[tt +
    1, F, CS]`` bf16 (zeros outside the input), each warp's 16 rows read
    as k pairs through the row and pair offsets, the three products on the
    lanes' fragments.  Returns the output and each row's write count."""
    b, tin, f, c = x.shape
    kf = ops["kernel_f"]
    t, fo = tin - 1 + pad, (f - kf) // 2 + 1
    plan = cb.tile_plan(b, t, f, c, kf, n_sm, 2)
    assert plan.smem == cb.smem_bytes(c, kf, f, plan.tt, 2) <= cb.SMEM_MAX
    assert plan.tt * fo <= cb.TILE_ROWS
    cs = cb.channel_stride(c, 2)
    k_dim = 2 * kf * c
    ks = -(-k_dim // 16)
    koff = torch.zeros(8 * ks, dtype=torch.long)
    for q in range(k_dim // 2):
        kt, r = divmod(2 * q, kf * c)
        koff[q] = (kt * f + r // c) * cs + r % c
    w = lambda name: ops[name].float()
    wf = _stage_frag(w("wmain"), k_dim, ks, 8)
    glf = _stage_frag(w("wg"), 32, 2, 4)
    grf = _stage_frag(w("wg")[32:, 32:], 32, 2, 4)
    w2f = _stage_frag(w("w2"), 32, 2, 8)
    frag = lambda fr, s, nj, j: fr[(s * nj + j) * 32:(s * nj + j + 1) * 32]
    # init_acc: lane registers c0..c3 of n-tile j hold v[8j + 2t], v[8j + 2t + 1] twice
    init = lambda v, n: [torch.stack([v[8 * j + 2 * _T4], v[8 * j + 2 * _T4 + 1]] * 2, dim=1)
                         for j in range(n)]
    per_utt = -(-t // plan.tt)
    out = torch.full((b, t * fo, 64), float("nan"))
    writes = torch.zeros(b, t * fo, dtype=torch.long)
    for tile in range(plan.tiles):
        bi, t0 = tile // per_utt, (tile % per_utt) * plan.tt
        buf = torch.zeros(plan.tt + 1, f, cs)
        for j in range(plan.tt + 1):
            if 0 <= t0 - pad + j < tin:
                buf[j, :, :c] = x[bi, t0 - pad + j].float()
        buf = buf.reshape(-1)
        rows = min(plan.tt, t - t0) * fo
        for warp in range(cb.WARPS):
            if warp * 16 >= rows:
                continue
            r = warp * 16 + torch.stack([_G4, _G4 + 8])  # [2, 32]: rows g, g + 8
            r = torch.where(r < rows, r, 0)
            off = ((r // fo) * f + 2 * (r % fo)) * cs
            y = init(bias_b[bi], 8)
            for s in range(ks):
                k0, k1 = koff[8 * s + _T4], koff[8 * s + 4 + _T4]
                pairs = [off[h] + kk for kk in (k0, k1) for h in (0, 1)]
                a = torch.stack([torch.stack([buf[p], buf[p + 1]], dim=1) for p in pairs], dim=1)
                y = [_mma(y[j], a, frag(wf, s, 8, j)) for j in range(8)]
            ml, mr = init(ops["bg"], 4), init(ops["bg"][32:], 4)
            for s in range(2):
                a = _acc_to_a(y[2 * s], y[2 * s + 1])
                ml = [_mma(ml[j], a, frag(glf, s, 4, j)) for j in range(4)]
                a = _acc_to_a(y[4 + 2 * s], y[5 + 2 * s])
                mr = [_mma(mr[j], a, frag(grf, s, 4, j)) for j in range(4)]
            comb = [y[j] * torch.sigmoid(mr[j]) + y[j + 4] * torch.sigmoid(ml[j])
                    for j in range(4)]
            o = init(ops["b2"], 8)
            for s in range(2):
                a = _acc_to_a(comb[2 * s], comb[2 * s + 1])
                o = [_mma(o[j], a, frag(w2f, s, 8, j)) for j in range(8)]
            for h in range(2):
                row = warp * 16 + _G4 + 8 * h
                keep = row < rows
                for j in range(8):
                    for e in range(2):
                        v = o[j][:, 2 * h + e]
                        v = _bf(torch.where(v >= 0, v, ops["alpha"] * v))
                        out[bi, t0 * fo + row[keep], 8 * j + 2 * _T4[keep] + e] = v[keep]
                writes[bi, t0 * fo + row[keep]] += 1
    return out.reshape(b, t, fo, 64), writes


@pytest.mark.parametrize("stage", range(5), ids=[f"stage{i + 1}" for i in range(5)])
@pytest.mark.parametrize("t_frames", [3, 7])
def test_k3_bf16_lanes_match_plain(stage, t_frames):
    """K3-bf16's fragment layouts, offsets and tiling, emulated lane by
    lane with several tiles and a partial last one (n_sm = 2), equal
    ``enc_stage_plain`` in bf16 up to summation order (an occasional bf16
    step of the output), and every output row is written once (8 writes
    a row: one per n-tile pair of columns, counted once per lane row)."""
    f, c, kf, pad = STAGES[stage]
    ops, g = _stage_operands(c, kf, 20 + stage)
    ops = {**ops, "wmain": ops["wmain"].bfloat16(), "wg": ops["wg"].bfloat16(),
           "w2": ops["w2"].bfloat16()}
    b = 2
    x = torch.randn(b, t_frames + 1 - pad, f, c, generator=g).bfloat16()
    bias_b = torch.randn(b, 64, generator=g)
    want = cb.enc_stage_plain(x, ops, bias_b, pad)
    got, writes = _k3_bf16_emulate(x, ops, bias_b, pad, n_sm=2)
    assert bool((writes == 1).all())
    _close_rel(got.numpy(), want.float().numpy(), 2.0 ** -7)


def test_k3_bf16_lane_layouts_invert():
    """The emulation's fragment maps are one-to-one: B from stage_frag is
    W's k16 x n8 tile, and A registers packed from two accumulator tiles
    are the accumulators' columns in natural k order."""
    w = torch.randn(40, 64, generator=torch.Generator().manual_seed(0))
    fr = _stage_frag(w, 40, 3, 8)
    for s in range(3):
        for j in range(8):
            tile = torch.zeros(16, 8)
            rows = w[16 * s:min(16 * s + 16, 40), 8 * j:8 * j + 8]
            tile[:rows.shape[0]] = rows
            assert torch.equal(_b_matrix(fr[(s * 8 + j) * 32:(s * 8 + j + 1) * 32]), tile)
    d = _bf(torch.randn(16, 16, generator=torch.Generator().manual_seed(1)))
    a = _acc_to_a(_c_regs(d[:, :8]), _c_regs(d[:, 8:]))
    assert torch.equal(_a_matrix(a), d)


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=[f"{b}x{t}" for b, t in PLAN_SHAPES])
@pytest.mark.parametrize("stage", range(5), ids=[f"stage{i + 1}" for i in range(5)])
def test_bf16_tile_plan_covers_rows_and_fits(shape, stage):
    """K3-bf16's plan (``elem=2``): every row once, a tile within the
    block's rows, shared memory within 227 KB, and its bytes are the bf16
    layout's (8-byte fragments, k16 steps, the padded channel stride)."""
    b, t = shape
    f, c, kf, _ = STAGES[stage]
    fo = (f - kf) // 2 + 1
    plan = cb.tile_plan(b, t, f, c, kf, 132, 2)
    k16 = -(-2 * kf * c // 16)
    cs = 2 if c == 2 else 40
    assert plan.smem == 256 * (8 * k16 + 32) + 32 * k16 + 2 * (plan.tt + 1) * f * cs
    assert plan.smem <= cb.SMEM_MAX and 1 <= plan.tt * fo <= cb.TILE_ROWS
    per_utt = -(-t // plan.tt)
    assert plan.tiles == b * per_utt and plan.grid == min(plan.tiles, 132)
